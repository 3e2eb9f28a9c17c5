// CHGNet's two fused edge aggregations: a gated MLP per edge, summed onto
// dst-sorted rows, float32, sm_90a.
//
// Replaces distmlip_tpu/kernels/segment.py::pallas_edge_aggregate (body
// _edge_aggregate_kernel, in-kernel gather _gather_rows) at CHGNet's two
// call sites: the atom conv (distmlip_tpu/models/chgnet.py:339 through
// parallel/halo.py:366-372) and the line-graph (bond-node) conv
// (chgnet.py:360-365). The TPU kernel traces the model's edge_fn, with the
// gated MLP's weights hoisted as kernel consts, owns a tile of dst rows per
// grid step and scatters a VMEM message block with a one-hot MXU matmul.
// Here each message has its own kernel, and the scatter becomes a ragged
// reduction over CSR row offsets (row_ptr, as in segment_sum.cu):
//
//   atom conv: out[n] = sum_e GatedMLP([v_src[src_e] | v_dst[dst_e] | e_e]) * abw_e
//   line conv: out[n] = sum_l GatedMLP([b[src_l] | b[dst_l] | a_l | v[ctr_l]])
//
// over the valid edges (lines) of dst row n, where
//   GatedMLP(x) = silu(silu(x W1c + b1c) W2c + b2c) * sigmoid(silu(x W1g + b1g) W2g + b2g)
// with W in the JAX layout (in, out). Every segment of the concat row is C
// wide; the hidden width H and C are runtime ints.
//
// Design. One persistent block of 256 threads per SM stages the weights
// once in shared memory: [W1c | W1g] as one (K1, 2H) matrix, W2c and W2g
// side by side as (H, 2C) (216 KB at C = H = 64 with the line conv's 4C
// inputs, so one block per SM, set by the dynamic shared-memory attribute).
// It then walks chunks of consecutive dst rows (~1024 candidate edges
// each, round robin over the blocks); a chunk is one contiguous edge
// range, and its rows are written by this block alone: deterministic, no
// atomics. The block screens a chunk 256 candidates at a time, compacts
// the valid edges (warp ballots and a block prefix) into a queue, and runs
// the queue in tiles of TE edges (64, or 32 when 64 does not fit the
// shared memory):
//   1. each warp gathers its edges' concat rows into shared memory: all
//      row ids, then all loads of a 32-channel slab, then the stores, so
//      EPW * NSEG coalesced 128-byte loads are in flight per warp;
//   2. layer 1 as a register-tiled product: a warp owns EPW edges, a lane 4
//      hidden columns, so each step is one broadcast float4 of the inputs
//      and one float4 of the weights per lane for 4 EPW fused multiply-adds;
//   3. layer 2 the same way, core and gate columns side by side, with silu
//      and sigmoid applied in registers and the core half scaled by abw;
//   4. C threads walk the tile in edge order and add core * gate into the
//      running sum of the current dst row, writing each row out when the
//      walk passes it (empty rows as zeros).
// Masked edges and lines are never gathered or computed: ~30% of the atom
// graph's rows at the smoke size are skin-shell or padding rows.
//
// What bounds it on an H100: float32 operations. At C = H = 64 a valid edge
// costs 65,536 FLOP (atom conv) or 81,920 (line conv) against ~0.5-1 KB of
// bytes, far above the card's ~20 FLOP per byte in float32; no tensor
// cores, because TF32 would break the float32 parity bar of this port.
//
// Semantics (those of the plain versions in kernels/edge_aggregate.py):
//   - masked edges are never read and never added, so non-finite padding
//     cannot leak into a sum;
//   - every output row is written, empty rows as zeros;
//   - offsets are 64-bit, edge ids 32-bit; gathered row ids of valid edges
//     must lie in range.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCand = kThreads;          // candidate edges screened per pass
constexpr int kSmemLimit = 232448;       // bytes a block can use on sm_90
constexpr int kEdgesPerChunk = 1024;     // target candidate edges per row chunk

struct Segment {
  const float* base;    // (rows, C)
  const int32_t* idx;   // (E) row ids, or null: the edge's own row
};

struct Args {
  Segment seg[4];
  const float* scale;   // (E, C) per-edge multiplier, or null
  const float* w1c;     // (K1, H)
  const float* b1c;     // (H)
  const float* w2c;     // (H, C)
  const float* b2c;     // (C)
  const float* w1g;
  const float* b1g;
  const float* w2g;
  const float* b2g;
  const int64_t* row_ptr;  // (n_rows + 1)
  const int32_t* seg_ids;  // (E) dst row of each edge
  const uint8_t* mask;     // (E) or null
  float* out;              // (n_rows, C)
  int64_t n_rows;
  int rows_per_block;      // rows of one chunk
  int channels;
  int hidden;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// shared-memory layout, in floats (every region starts 16-byte aligned)
struct Layout {
  int k1, k1p, hp, cp, w1s, w2s, xs, te;
  int o_b1, o_w2, o_b2, o_x, o_h, o_q;
  __host__ __device__ Layout(int n_seg, int c, int h, int epw) {
    k1 = n_seg * c;
    k1p = round4(k1);
    hp = round4(h);
    cp = round4(c);
    w1s = 2 * hp;             // row stride of [W1c | W1g] and of the hidden tile
    w2s = 2 * cp;             // row stride of [W2c | W2g] and of the output tile
    xs = k1p > w2s ? k1p : w2s;  // row stride of the input tile (outputs alias it)
    te = kWarps * epw;
    o_b1 = k1p * w1s;
    o_w2 = o_b1 + w1s;
    o_b2 = o_w2 + hp * w2s;
    o_x = o_b2 + w2s;
    o_h = o_x + te * xs;
    o_q = o_h + te * w1s;
  }
  __host__ __device__ int bytes() const {
    return o_q * 4 + 2 * (te + kCand) * 4 + kWarps * 4;
  }
};

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }
__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// acc[i][0..3] += x_i[k..k+3] . W[k..k+3][col..col+3]
template <int EPW>
__device__ __forceinline__ void fma_step(float (&acc)[EPW][4],
                                         const float* __restrict__ xrow0, int xstride,
                                         const float* __restrict__ wk, int wstride) {
  const float4 w0 = *reinterpret_cast<const float4*>(wk);
  const float4 w1 = *reinterpret_cast<const float4*>(wk + wstride);
  const float4 w2 = *reinterpret_cast<const float4*>(wk + 2 * wstride);
  const float4 w3 = *reinterpret_cast<const float4*>(wk + 3 * wstride);
#pragma unroll
  for (int i = 0; i < EPW; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(xrow0 + i * xstride);
    acc[i][0] = fmaf(x.x, w0.x, acc[i][0]);
    acc[i][1] = fmaf(x.x, w0.y, acc[i][1]);
    acc[i][2] = fmaf(x.x, w0.z, acc[i][2]);
    acc[i][3] = fmaf(x.x, w0.w, acc[i][3]);
    acc[i][0] = fmaf(x.y, w1.x, acc[i][0]);
    acc[i][1] = fmaf(x.y, w1.y, acc[i][1]);
    acc[i][2] = fmaf(x.y, w1.z, acc[i][2]);
    acc[i][3] = fmaf(x.y, w1.w, acc[i][3]);
    acc[i][0] = fmaf(x.z, w2.x, acc[i][0]);
    acc[i][1] = fmaf(x.z, w2.y, acc[i][1]);
    acc[i][2] = fmaf(x.z, w2.z, acc[i][2]);
    acc[i][3] = fmaf(x.z, w2.w, acc[i][3]);
    acc[i][0] = fmaf(x.w, w3.x, acc[i][0]);
    acc[i][1] = fmaf(x.w, w3.y, acc[i][1]);
    acc[i][2] = fmaf(x.w, w3.z, acc[i][2]);
    acc[i][3] = fmaf(x.w, w3.w, acc[i][3]);
  }
}

// stage [W1c | W1g], the biases and [W2c | W2g] in shared memory, zero-padded
__device__ __forceinline__ void stage_weights(const Args& a, const Layout& L, float* smem) {
  const int C = a.channels, H = a.hidden;
  const int tid = threadIdx.x;
  float* W1s = smem;
  for (int i = tid; i < L.k1p * L.w1s; i += kThreads) {
    const int k = i / L.w1s, j = i % L.w1s;
    float v = 0.0f;
    if (k < L.k1) {
      if (j < H) v = __ldg(a.w1c + static_cast<int64_t>(k) * H + j);
      else if (j >= L.hp && j < L.hp + H) v = __ldg(a.w1g + static_cast<int64_t>(k) * H + j - L.hp);
    }
    W1s[i] = v;
  }
  float* b1s = smem + L.o_b1;
  for (int j = tid; j < L.w1s; j += kThreads) {
    b1s[j] = j < H ? __ldg(a.b1c + j)
                   : (j >= L.hp && j < L.hp + H ? __ldg(a.b1g + j - L.hp) : 0.0f);
  }
  float* W2s = smem + L.o_w2;
  for (int i = tid; i < L.hp * L.w2s; i += kThreads) {
    const int j = i / L.w2s, c = i % L.w2s;
    float v = 0.0f;
    if (j < H) {
      if (c < C) v = __ldg(a.w2c + static_cast<int64_t>(j) * C + c);
      else if (c >= L.cp && c < L.cp + C) v = __ldg(a.w2g + static_cast<int64_t>(j) * C + c - L.cp);
    }
    W2s[i] = v;
  }
  float* b2s = smem + L.o_b2;
  for (int c = tid; c < L.w2s; c += kThreads) {
    b2s[c] = c < C ? __ldg(a.b2c + c)
                   : (c >= L.cp && c < L.cp + C ? __ldg(a.b2g + c - L.cp) : 0.0f);
  }
}

// one tile of n <= TE queued edges: gather, two layers, and the ordered
// walk that adds (core [* scale]) * gate into the current row's sum
template <int NSEG, int EPW>
__device__ __forceinline__ void run_tile(const Args& a, const Layout& L, float* smem,
                         const int* q_e, const int* q_row, int n,
                         int64_t& cur, float& acc_row) {
  const int C = a.channels;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Xs = smem + L.o_x;
  float* Hs = smem + L.o_h;

  // 1. gather the concat rows: every row id first, then every value of a
  //    32-channel slab, then the stores, so a warp keeps EPW * NSEG loads in
  //    flight instead of waiting on each one
  int rid[EPW][NSEG];
#pragma unroll
  for (int i = 0; i < EPW; ++i) {
    const int t = warp * EPW + i;
    const int e = t < n ? q_e[t] : 0;
#pragma unroll
    for (int s = 0; s < NSEG; ++s)
      rid[i][s] = t < n && a.seg[s].idx != nullptr ? __ldg(a.seg[s].idx + e) : e;
  }
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float v[EPW][NSEG];
#pragma unroll
    for (int i = 0; i < EPW; ++i) {
#pragma unroll
      for (int s = 0; s < NSEG; ++s) {
        v[i][s] = warp * EPW + i < n && c < C
                      ? __ldg(a.seg[s].base + static_cast<int64_t>(rid[i][s]) * C + c)
                      : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < EPW; ++i) {
      const int t = warp * EPW + i;
      if (t < n && c < C) {
#pragma unroll
        for (int s = 0; s < NSEG; ++s) Xs[t * L.xs + s * C + c] = v[i][s];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < EPW; ++i) {
    const int t = warp * EPW + i;
    if (t < n) {
      for (int k = L.k1 + lane; k < L.k1p; k += 32) Xs[t * L.xs + k] = 0.0f;
    }
  }
  __syncthreads();

  // 2. hidden = silu(x [W1c | W1g] + [b1c | b1g])
  {
    const float* W1s = smem;
    const float* b1s = smem + L.o_b1;
    const float* xrow0 = Xs + warp * EPW * L.xs;
    for (int cb = 0; cb < L.w1s; cb += 128) {
      const int col = cb + lane * 4;
      if (col < L.w1s) {
        float acc[EPW][4];
        const float4 b = *reinterpret_cast<const float4*>(b1s + col);
#pragma unroll
        for (int i = 0; i < EPW; ++i) {
          acc[i][0] = b.x; acc[i][1] = b.y; acc[i][2] = b.z; acc[i][3] = b.w;
        }
        for (int k = 0; k < L.k1p; k += 4)
          fma_step<EPW>(acc, xrow0 + k, L.xs, W1s + k * L.w1s + col, L.w1s);
#pragma unroll
        for (int i = 0; i < EPW; ++i) {
          float4 h;
          h.x = silu(acc[i][0]); h.y = silu(acc[i][1]);
          h.z = silu(acc[i][2]); h.w = silu(acc[i][3]);
          *reinterpret_cast<float4*>(Hs + (warp * EPW + i) * L.w1s + col) = h;
        }
      }
    }
  }
  __syncthreads();

  // 3. [core * scale | gate] = [silu | sigmoid](hidden_{c|g} [W2c | W2g]
  //    + [b2c | b2g]), written over the input tile
  {
    const float* W2s = smem + L.o_w2;
    const float* b2s = smem + L.o_b2;
    for (int cb = 0; cb < L.w2s; cb += 128) {
      const int col = cb + lane * 4;
      if (col < L.w2s) {
        const bool gate = col >= L.cp;
        const float* hrow0 = Hs + warp * EPW * L.w1s + (gate ? L.hp : 0);
        float acc[EPW][4];
        const float4 b = *reinterpret_cast<const float4*>(b2s + col);
#pragma unroll
        for (int i = 0; i < EPW; ++i) {
          acc[i][0] = b.x; acc[i][1] = b.y; acc[i][2] = b.z; acc[i][3] = b.w;
        }
        for (int j = 0; j < L.hp; j += 4)
          fma_step<EPW>(acc, hrow0 + j, L.w1s, W2s + j * L.w2s + col, L.w2s);
        // the per-edge scale (abw) multiplies the core half here, loaded
        // for all EPW edges at once
        float sc[EPW][4];
#pragma unroll
        for (int i = 0; i < EPW; ++i) {
          const int t = warp * EPW + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = a.scale != nullptr && !gate && t < n && col + j < C
                           ? __ldg(a.scale + static_cast<int64_t>(q_e[t]) * C + col + j)
                           : 1.0f;
          }
        }
#pragma unroll
        for (int i = 0; i < EPW; ++i) {
          float4 o;
          if (gate) {
            o.x = sigmoid(acc[i][0]); o.y = sigmoid(acc[i][1]);
            o.z = sigmoid(acc[i][2]); o.w = sigmoid(acc[i][3]);
          } else {
            o.x = silu(acc[i][0]) * sc[i][0]; o.y = silu(acc[i][1]) * sc[i][1];
            o.z = silu(acc[i][2]) * sc[i][2]; o.w = silu(acc[i][3]) * sc[i][3];
          }
          // the input tile is dead once every warp has passed layer 1
          *reinterpret_cast<float4*>(Xs + (warp * EPW + i) * L.xs + col) = o;
        }
      }
    }
  }
  __syncthreads();

  // 4. ordered walk: thread c adds edge t's message into its row's sum
  if (tid < C) {
    for (int t = 0; t < n; ++t) {
      const int64_t r = q_row[t];
      while (cur < r) {
        a.out[cur * C + tid] = acc_row;
        acc_row = 0.0f;
        ++cur;
      }
      acc_row += Xs[t * L.xs + tid] * Xs[t * L.xs + L.cp + tid];
    }
  }
  __syncthreads();
}

template <int NSEG, int EPW>
__device__ __forceinline__ void gated_aggregate(const Args& a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(NSEG, a.channels, a.hidden, EPW);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* q_e = reinterpret_cast<int*>(smem + L.o_q);
  int* q_row = q_e + L.te + kCand;
  int* wcount = q_row + L.te + kCand;
  stage_weights(a, L, smem);
  __syncthreads();

  // persistent: the block stages the weights once and walks the row chunks
  // blockIdx.x, blockIdx.x + gridDim.x, ...
  const int64_t n_chunks = (a.n_rows + a.rows_per_block - 1) / a.rows_per_block;
  for (int64_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int64_t r0 = chunk * a.rows_per_block;
    const int64_t r1 = r0 + a.rows_per_block < a.n_rows ? r0 + a.rows_per_block : a.n_rows;
    const int64_t e0 = a.row_ptr[r0], e1 = a.row_ptr[r1];
    int64_t cur = r0;       // the row the walk is in (threads < C)
    float acc_row = 0.0f;   // its running sum of channel tid
    int qn = 0;             // queued valid edges (the same in every thread)
    for (int64_t base = e0; base < e1; base += kCand) {
      const int64_t e = base + tid;
      const bool valid = e < e1 && (a.mask == nullptr || a.mask[e] != 0);
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) wcount[warp] = __popc(ballot);
      __syncthreads();
      int off = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = wcount[w];
        off += w < warp ? c : 0;
        total += c;
      }
      if (valid) {
        const int pos = qn + off + __popc(ballot & ((1u << lane) - 1u));
        q_e[pos] = static_cast<int>(e);
        q_row[pos] = a.seg_ids[e];
      }
      qn += total;
      __syncthreads();
      while (qn >= L.te) {
        run_tile<NSEG, EPW>(a, L, smem, q_e, q_row, L.te, cur, acc_row);
        const int rest = qn - L.te;  // < kCand
        int qe = 0, qr = 0;
        if (tid < rest) {
          qe = q_e[L.te + tid];
          qr = q_row[L.te + tid];
        }
        __syncthreads();
        if (tid < rest) {
          q_e[tid] = qe;
          q_row[tid] = qr;
        }
        __syncthreads();
        qn = rest;
      }
    }
    if (qn > 0) run_tile<NSEG, EPW>(a, L, smem, q_e, q_row, qn, cur, acc_row);
    if (tid < a.channels) {
      while (cur < r1) {
        a.out[cur * a.channels + tid] = acc_row;
        acc_row = 0.0f;
        ++cur;
      }
    }
  }
}

template <int EPW>
__global__ void __launch_bounds__(kThreads, 1) chgnet_atom_conv_kernel(const Args a) {
  gated_aggregate<3, EPW>(a);
}

template <int EPW>
__global__ void __launch_bounds__(kThreads, 1) chgnet_line_conv_kernel(const Args a) {
  gated_aggregate<4, EPW>(a);
}

// edges per warp of the tile: 8 when the shared memory holds it, else 4;
// 0 when neither fits
int pick_epw(int n_seg, int channels, int hidden) {
  if (Layout(n_seg, channels, hidden, 8).bytes() <= kSmemLimit) return 8;
  if (Layout(n_seg, channels, hidden, 4).bytes() <= kSmemLimit) return 4;
  return 0;
}

template <int NSEG>
int launch(Args a, int64_t n_edges, void* stream) {
  if (a.n_rows <= 0 || a.channels <= 0) return 0;
  if (a.channels > kThreads || a.hidden <= 0 || n_edges >= 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int epw = pick_epw(NSEG, a.channels, a.hidden);
  if (epw == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t avg = n_edges / a.n_rows > 0 ? n_edges / a.n_rows : 1;
  int64_t rpb = (kEdgesPerChunk + avg - 1) / avg;
  if (rpb > a.n_rows) rpb = a.n_rows;
  a.rows_per_block = static_cast<int>(rpb);
  const int64_t chunks = (a.n_rows + rpb - 1) / rpb;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = chunks < sms ? chunks : sms;  // one resident block per SM
  const int bytes = Layout(NSEG, a.channels, a.hidden, epw).bytes();
  auto kernel = NSEG == 3 ? (epw == 8 ? chgnet_atom_conv_kernel<8> : chgnet_atom_conv_kernel<4>)
                          : (epw == 8 ? chgnet_line_conv_kernel<8> : chgnet_line_conv_kernel<4>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

void set_weights(Args& a, const float* const* w) {
  a.w1c = w[0]; a.b1c = w[1]; a.w2c = w[2]; a.b2c = w[3];
  a.w1g = w[4]; a.b1g = w[5]; a.w2g = w[6]; a.b2g = w[7];
}

}  // namespace

// Shared memory a launch takes (bytes), for n_seg segments of `channels`
// floats and `hidden` hidden units; -1 when the weights do not fit a block.
extern "C" int distmlip_chgnet_aggregate_smem_bytes(int n_seg, int channels, int hidden) {
  const int epw = pick_epw(n_seg, channels, hidden);
  return epw == 0 ? -1 : Layout(n_seg, channels, hidden, epw).bytes();
}

// Atom conv. node_src (N, C) gathered at src (E) int32; node_dst (N, C) at
// dst (E) int32; edge (E, C); abw (E, C) or null; weights = w1c (3C, H),
// b1c (H), w2c (H, C), b2c (C), w1g, b1g, w2g, b2g; row_ptr (n_rows + 1)
// int64; seg_ids (E) int32; mask (E) bytes or null; out (n_rows, C).
// float32, contiguous, on the current device. Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t (0 = success).
extern "C" int distmlip_chgnet_atom_conv_f32(
    const float* node_src, const int32_t* src, const float* node_dst,
    const int32_t* dst, const float* edge, const float* abw,
    const float* const* weights, const int64_t* row_ptr, const int32_t* seg_ids,
    const uint8_t* mask, float* out, int64_t n_rows, int64_t n_edges,
    int channels, int hidden, void* stream) {
  Args a{};
  a.seg[0] = {node_src, src};
  a.seg[1] = {node_dst, dst};
  a.seg[2] = {edge, nullptr};
  a.scale = abw;
  set_weights(a, weights);
  a.row_ptr = row_ptr; a.seg_ids = seg_ids; a.mask = mask; a.out = out;
  a.n_rows = n_rows; a.channels = channels; a.hidden = hidden;
  return launch<3>(a, n_edges, stream);
}

// Line conv. bond_src (B, C) gathered at line_src (L) int32; bond_dst (B, C)
// at line_dst (L) int32; angle (L, C); node (N, C) at center (L) int32;
// weights = w1c (4C, H), b1c, w2c (H, C), b2c, w1g, b1g, w2g, b2g; row_ptr
// (n_rows + 1) int64; seg_ids (L) int32; mask (L) bytes or null; out
// (n_rows, C). float32, contiguous, on the current device. Launches on
// `stream`, does not synchronise, and returns the launch's cudaError_t.
extern "C" int distmlip_chgnet_line_conv_f32(
    const float* bond_src, const int32_t* line_src, const float* bond_dst,
    const int32_t* line_dst, const float* angle, const float* node,
    const int32_t* center, const float* const* weights, const int64_t* row_ptr,
    const int32_t* seg_ids, const uint8_t* mask, float* out, int64_t n_rows,
    int64_t n_edges, int channels, int hidden, void* stream) {
  Args a{};
  a.seg[0] = {bond_src, line_src};
  a.seg[1] = {bond_dst, line_dst};
  a.seg[2] = {angle, nullptr};
  a.seg[3] = {node, center};
  a.scale = nullptr;
  set_weights(a, weights);
  a.row_ptr = row_ptr; a.seg_ids = seg_ids; a.mask = mask; a.out = out;
  a.n_rows = n_rows; a.channels = channels; a.hidden = hidden;
  return launch<4>(a, n_edges, stream);
}
