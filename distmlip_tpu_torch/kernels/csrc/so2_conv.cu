// SO(2) convolution of eSCN on per-|m| coefficient blocks, float32, sm_90a.
//
// Replaces distmlip_tpu/kernels/so3.py::so2_conv_pallas (body _so2_kernel).
// Per edge, with f the (nl * C)-flattened coefficient block of one |m|:
//   m = 0:  y0 = f0 W0
//   m > 0:  y+ = f+ Wr - f- Wi,   y- = f+ Wi + f- Wr
// In the packed per-m row order ([m=0 | m=1 plus | m=1 minus | ...]) the
// plus and minus blocks of one |m| are adjacent, so each m > 0 is ONE
// product of contraction 2d: [f+ | f-] B with B = [[Wr, Wi], [-Wi, Wr]].
// The whole convolution is the (E, S*C) rows times a block-diagonal matrix
// of one square block per |m| (widths d0, 2d1, 2d2, ...).
//
// The TPU kernel keeps every weight matrix resident in VMEM and runs one
// MXU matmul per block per 256-edge step. On Hopper the weights (5.57 MB
// per layer at l_max 4, C 128) are ~25x a block's shared memory, so this
// is a tiled GEMM that streams weight tiles instead: blockIdx.x walks
// (segment, 128-column output tile), blockIdx.y 128-edge row tiles. Each
// block stages 8-deep slices of its A rows (transposed) and of B in shared
// memory, double-buffered through registers, and accumulates a 128 x 128
// output tile in registers, 8 x 8 per thread (two 4 x 4 quadrants 64 apart
// so the shared-memory reads are float4 and conflict-free). B is never
// built: a tile element (k, j) is read from Wr or Wi by quadrant, with the
// sign of the lower-left -Wi applied while loading.
//
// What bounds it on an H100: operations. Per edge row the products cost
// 2 sum_m width_m^2 FLOP (4,751,360 at l_max 4, C 128) against 2 x 12.8 KB
// of row traffic, ~190 FLOP per byte, far above the float32 ridge (67e12 /
// 3.35e12 = 20). The tiling is what keeps it there: each staged element
// feeds 128 FMAs, the A rows of one row tile are read from HBM once and
// served from L2 to the segment's other column tiles (x is the fast grid
// axis, so they run together), and the weights (<= 5.6 MB) stay in the
// 50 MB L2. No tensor cores: float32 FMA in CUDA cores, fp32 accumulation,
// no TF32 rounding.
//
// Layout: h and out are (E, S, C) with row stride S*C; `rows` maps each
// packed row to its row in h and out, so the caller's coefficient order
// (e3nn's) is read and written in place, with no permuted copy. Rows past
// E and columns past a segment's width are masked inside the kernel; every
// output element is written exactly once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // edge rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 8;         // contraction slice staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kMaxSeg = 7;     // |m| = 0..6
constexpr int kMaxRows = 49;   // S = (l_max + 1)^2 at l_max = 6

struct Segment {
  const float* wr;  // W0 (m = 0) or Wr (m > 0), (d, d) row-major
  const float* wi;  // Wi (m > 0); W0 again for m = 0, never read
  int d;            // nl * C, the size of one weight matrix
  int width;        // contraction length = output width: d or 2d
  int row0;         // first packed row of the segment
  int tile0;        // first column tile of the segment along blockIdx.x
};

struct Params {
  const float* h;
  float* out;
  int64_t e;  // edge rows
  int s;      // coefficient rows per edge
  int c;      // channels
  int n_seg;
  Segment seg[kMaxSeg];
  int rows[kMaxRows];  // packed row -> row of h and out
};

// Four consecutive contraction entries k..k+3 of one A row (zeros past the
// segment's width). VEC4 needs C % 4 == 0, so the four share one row of h.
template <bool VEC4>
__device__ __forceinline__ void load_a(const float* __restrict__ base, bool live,
                                       const int* s_rows, int row0, int c, int width,
                                       int k, float (&v)[4]) {
  if constexpr (VEC4) {
    if (live && k < width) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(
          base + static_cast<int64_t>(s_rows[row0 + k / c]) * c + k % c));
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k + i;
      v[i] = (live && kk < width)
                 ? __ldg(base + static_cast<int64_t>(s_rows[row0 + kk / c]) * c + kk % c)
                 : 0.0f;
    }
  }
}

// Entries (k, j..j+3) of the segment's virtual (width x width) matrix:
// W0 for m = 0, [[Wr, Wi], [-Wi, Wr]] for m > 0 (zeros past the width).
// VEC4 needs d % 4 == 0, so the four share one quadrant.
template <bool VEC4>
__device__ __forceinline__ void load_b(const Segment& sg, int k, int j, float (&v)[4]) {
  const int d = sg.d;
  if constexpr (VEC4) {
    if (k < sg.width && j < sg.width) {
      const bool kq = k >= d;
      const bool jq = j >= d;
      const float* src = kq == jq ? sg.wr : sg.wi;
      const float4 t = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(kq ? k - d : k) * d + (jq ? j - d : j)));
      const float sign = (kq && !jq) ? -1.0f : 1.0f;
      v[0] = sign * t.x;
      v[1] = sign * t.y;
      v[2] = sign * t.z;
      v[3] = sign * t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jj = j + i;
      if (k < sg.width && jj < sg.width) {
        const bool kq = k >= d;
        const bool jq = jj >= d;
        const float* src = kq == jq ? sg.wr : sg.wi;
        const float t = __ldg(src + static_cast<int64_t>(kq ? k - d : k) * d +
                              (jq ? jj - d : jj));
        v[i] = (kq && !jq) ? -t : t;
      } else {
        v[i] = 0.0f;
      }
    }
  }
}

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
so2_conv_kernel(const Params p) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  __shared__ int s_rows[kMaxRows];

  const int tid = threadIdx.x;
  if (tid < p.s) s_rows[tid] = p.rows[tid];

  int si = 0;
  while (si + 1 < p.n_seg && static_cast<int>(blockIdx.x) >= p.seg[si + 1].tile0) ++si;
  const Segment sg = p.seg[si];
  const int c = p.c;
  const int width = sg.width;
  const int n0 = (static_cast<int>(blockIdx.x) - sg.tile0) * kBN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t ld = static_cast<int64_t>(p.s) * c;  // floats per edge row

  // loader coordinates: A as 128 rows x 2 float4, B as 8 rows x 32 float4
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int b_k = tid >> 5;
  const int b_j = (tid & 31) * 4;
  const bool a_live = m0 + a_row < p.e;
  const float* __restrict__ a_base = p.h + (a_live ? m0 + a_row : 0) * ld;

  // compute coordinates: rows ty*4 + {0..3, 64..67}, columns tx*4 + {...}
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  __syncthreads();  // s_rows is ready
  const int nk = (width + kBK - 1) / kBK;
  float ra[4], rb[4];
  load_a<VEC4>(a_base, a_live, s_rows, sg.row0, c, width, a_k, ra);
  load_b<VEC4>(sg, b_k, n0 + b_j, rb);
#pragma unroll
  for (int i = 0; i < 4; ++i) As[0][a_k + i][a_row] = ra[i];
  *reinterpret_cast<float4*>(&Bs[0][b_k][b_j]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {  // the next slice's loads are in flight during this one's FMAs
      const int k0 = (kt + 1) * kBK;
      load_a<VEC4>(a_base, a_live, s_rows, sg.row0, c, width, k0 + a_k, ra);
      load_b<VEC4>(sg, k0 + b_k, n0 + b_j, rb);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (more) {
      // the other buffer: every thread finished reading it before the
      // barrier that closed the previous step
#pragma unroll
      for (int i = 0; i < 4; ++i) As[cur ^ 1][a_k + i][a_row] = ra[i];
      *reinterpret_cast<float4*>(&Bs[cur ^ 1][b_k][b_j]) =
          make_float4(rb[0], rb[1], rb[2], rb[3]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t edge = m0 + ty * 4 + (i & 3) + (i >> 2) * 64;
    if (edge >= p.e) continue;
    float* __restrict__ out_row = p.out + edge * ld;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int n = n0 + tx * 4 + jh * 64;
      if constexpr (VEC4) {
        if (n < width) {
          float* dst = out_row + static_cast<int64_t>(s_rows[sg.row0 + n / c]) * c + n % c;
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][jh * 4], acc[i][jh * 4 + 1], acc[i][jh * 4 + 2],
                          acc[i][jh * 4 + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nn = n + j;
          if (nn < width) {
            out_row[static_cast<int64_t>(s_rows[sg.row0 + nn / c]) * c + nn % c] =
                acc[i][jh * 4 + j];
          }
        }
      }
    }
  }
}

}  // namespace

// h, out: (e, s, c) float32 contiguous on the current device. Segments in
// packed order: seg_m[i] = |m|, seg_row0[i] its first packed row, seg_nl[i]
// its l count (m > 0 segments span 2 nl rows). weights: device pointers
// [W0, W1r, W1i, ...], each (nl c, nl c) float32 row-major. rows: the
// packed row -> row of h/out map (host array of s ints). vec == 4 requires
// c % 4 == 0 and 16-byte aligned h, out and weights. Launches on `stream`
// and returns the launch's cudaError_t (0 = success); it does not
// synchronise.
extern "C" int distmlip_so2_conv_f32(const float* h, float* out, int64_t e, int s, int c,
                                     int n_seg, const int* seg_m, const int* seg_row0,
                                     const int* seg_nl, const float* const* weights,
                                     const int* rows, int vec, void* stream) {
  if (e <= 0) return 0;
  if (n_seg < 1 || n_seg > kMaxSeg || s < 1 || s > kMaxRows || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  p.h = h;
  p.out = out;
  p.e = e;
  p.s = s;
  p.c = c;
  p.n_seg = n_seg;
  int wi = 0;
  int tiles = 0;
  for (int i = 0; i < n_seg; ++i) {
    Segment& sg = p.seg[i];
    sg.d = seg_nl[i] * c;
    sg.width = seg_m[i] == 0 ? sg.d : 2 * sg.d;
    sg.row0 = seg_row0[i];
    sg.wr = weights[wi];
    sg.wi = seg_m[i] == 0 ? weights[wi] : weights[wi + 1];
    wi += seg_m[i] == 0 ? 1 : 2;
    sg.tile0 = tiles;
    tiles += (sg.width + kBN - 1) / kBN;
  }
  for (int i = 0; i < s; ++i) p.rows[i] = rows[i];
  const int64_t row_tiles = (e + kBM - 1) / kBM;
  if (row_tiles > 65535 || tiles < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(row_tiles));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    so2_conv_kernel<true><<<grid, kThreads, 0, st>>>(p);
  } else {
    so2_conv_kernel<false><<<grid, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
