// Masked segment sum of dst-sorted rows, (E, W) -> (N, W), float32 or
// bfloat16 in and out, float32 accumulation, sm_90a.
//
// Replaces distmlip_tpu/kernels/segment.py::pallas_segment_sum (body
// _segment_sum_kernel). The TPU kernel owns a tile of 128 dst rows per grid
// step and scatters each 256-edge block through a one-hot MXU matmul, the
// TPU's way to scatter. Here the scatter is a plain ragged reduction, one
// launch a call: each warp finds its dst row's contiguous edge range
// [lower_bound(ids, r), lower_bound(ids, r + 1)) itself, by a 32-ary search
// of the sorted ids across the warp (~log32(E) dependent loads: 4 at 115k
// edges, 5 at 1.5M), so the wrapper computes no offsets and allocates only
// the output.
//
// What bounds it on an H100: HBM bytes. Each data element is read once and
// added once (1 FLOP per 4 bytes), so the least time is
// (valid rows * W * 4 + N * W * 4 + ids + mask) / 3.35 TB/s. The mapping is
// fitted to the row width W (in float4 columns when W % 4 == 0 and the
// pointers are 16-byte aligned, else in floats):
//   - narrow rows (at most 16 columns; the ZBL and pair sums are W = 1): one
//     warp per dst row, the lanes split into (edge, column) groups, so a
//     warp step reads 32 / LPE consecutive edges, coalesced; each lane sums
//     its edges, then a fixed-order __shfl_xor_sync tree combines the lanes
//     of one column;
//   - wider rows: one warp per (dst row, chunk of 64 columns, two a lane
//     32 apart), eight warps a block, so no warp runs mostly idle (the last
//     chunk of a row is the only partial one: none at MACE's 2048 / 5120
//     floats, a half at eSCN's 3200), and each valid edge's row is read as
//     two coalesced 512-byte loads a warp, four edges in flight. Two
//     columns a lane halve the warps' fixed cost (the search, the mask)
//     against one and beat four (measured on an H100: PERF.md).
// The mask is read 16 bytes a lane, 512 edges a warp load and 4096 or 8192
// a step, and a 512-edge stretch with no valid edge is skipped without a
// data load:
// the repeated-tail padding (thousands of masked edges on the last real dst
// row) costs a few wide mask loads, not a walk. No block-wide barrier.
//
// Semantics (those of the plain version, ops/segment.py masked_segment_sum):
//   - masked rows are never read, and screened by select, not by multiply,
//     so non-finite padding cannot leak into a sum;
//   - accumulation is fp32 in registers with no atomics, in a fixed order:
//     results are deterministic run to run;
//   - every output row is written, empty rows as zeros;
//   - ids outside [0, N) fall outside every row's range and are dropped.
// Offsets into data and out are 64-bit: E * W passes 2^31 once edge chunks
// are large or off.
//
// bfloat16 (the models' compute_dtype="bfloat16"): the same two kernels,
// templated on the element type. Rows load as __nv_bfloat162 pairs (one
// pair a lane, or two pairs 32 apart on the wider path: a warp load is 128
// contiguous bytes, a chunk 128 columns) or single __nv_bfloat16 values
// where the width is odd, converted by the intrinsics; the accumulator is
// float32 in registers in the same fixed order, and each output element is
// rounded to bfloat16 once (__float2bfloat16_rn), as the TPU kernel keeps an
// fp32 accumulator and stores in data.dtype
// (distmlip_tpu/kernels/segment.py:183, :217). The bound halves on the data
// and output terms: 2 bytes an element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kGranulesRows = 16;  // 16-byte mask loads a lane per step, narrow rows: 8192 edges
constexpr int kGranulesCols = 8;   // the same, wider rows (more warps a row): 4096 edges
constexpr int kInFlight = 4;       // edge rows loaded before they are added (wider rows)
constexpr int kColsPerLane = 2;    // loads (1, 2 or 4 elements) a lane, wider rows
constexpr unsigned kFull = 0xffffffffu;

// [lower_bound(ids, row), lower_bound(ids, row + 1)) over ids[0, n), both
// searches at once: each step probes 32 evenly spaced ids of each range and
// keeps the stretch between the last probe below the key and the first at or
// above it. Every lane ends with the same bounds.
template <typename Id>
__device__ __forceinline__ void row_bounds(const Id* __restrict__ ids, int64_t n, int64_t row,
                                           int lane, int64_t& e0, int64_t& e1) {
  int64_t lo[2] = {0, 0}, hi[2] = {n, n};
  const int64_t key[2] = {row, row + 1};
  while (lo[0] != hi[0] || lo[1] != hi[1]) {
    int64_t step[2];
    bool less[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int64_t d = hi[s] - lo[s];
      step[s] = d > 32 ? (d + 31) >> 5 : 1;
      const int64_t p = lo[s] + (lane + 1) * step[s] - 1;
      less[s] = p < hi[s] && static_cast<int64_t>(__ldg(ids + p)) < key[s];
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int c = __popc(__ballot_sync(kFull, less[s]));
      const int64_t top = lo[s] + (c + 1) * step[s] - 1;
      lo[s] += c * step[s];
      hi[s] = top < hi[s] ? top : hi[s];
    }
  }
  e0 = lo[0];
  e1 = lo[1];
}

// bit i set where byte i of x is not 0
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

// Valid-edge bits of the 16 edges from g (mask + g is 16-byte aligned),
// within [e0, e1); 0 with no load when the granule holds none of the range.
// An aligned 16-byte load that holds a byte of the range stays inside the
// allocation's granule, so it never faults.
__device__ __forceinline__ unsigned granule_bits(const uint8_t* __restrict__ mask, int64_t g,
                                                 int64_t e0, int64_t e1) {
  const int64_t lo = e0 - g, hi = e1 - g;
  if (hi <= 0 || lo >= 16) return 0u;
  unsigned range = 0xffffu;
  if (lo > 0) range &= 0xffffu << lo;
  if (hi < 16) range &= (1u << hi) - 1u;
  if (mask == nullptr) return range;
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(mask + g));
  return range & (nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 | nonzero_bytes(v.z) << 8 |
                  nonzero_bytes(v.w) << 12);
}

// Calls body(base, bits) for each 32-edge group [base, base + 32) of
// [e0, e1) that holds a valid edge, in edge order; bit i of bits is edge
// base + i (bits and base are the same on every lane). A step loads G mask
// granules a lane (512 G edges a warp, all loads in flight) before any is
// tested.
template <int G, class Body>
__device__ __forceinline__ void for_valid_groups(const uint8_t* __restrict__ mask, int64_t e0,
                                                 int64_t e1, int lane, Body& body) {
  const int64_t align = static_cast<int64_t>(reinterpret_cast<uintptr_t>(mask) & 15u);
  for (int64_t ws = ((e0 + align) & ~int64_t{15}) - align; ws < e1; ws += 512 * G) {
    unsigned bits[G];
#pragma unroll
    for (int j = 0; j < G; ++j) bits[j] = granule_bits(mask, ws + 512 * j + 16 * lane, e0, e1);
    unsigned windows = 0u;  // bit j: window j (512 edges) holds a valid edge
#pragma unroll
    for (int j = 0; j < G; ++j) windows |= (__ballot_sync(kFull, bits[j] != 0u) != 0u ? 1u : 0u) << j;
    while (windows != 0u) {  // masked windows: no data load
      const int j = __ffs(windows) - 1;
      windows &= windows - 1u;
      unsigned mine = 0u;
#pragma unroll
      for (int jj = 0; jj < G; ++jj) mine = jj == j ? bits[jj] : mine;
#pragma unroll 4
      for (int s = 0; s < 16; ++s) {  // (a full unroll multiplies the build time)
        const unsigned b = __shfl_sync(kFull, mine, 2 * s) |
                           __shfl_sync(kFull, mine, 2 * s + 1) << 16;
        if (b != 0u) body(ws + 512 * j + 32 * s, b);
      }
    }
  }
}

// Adds VEC consecutive elements at p (VEC-aligned) into acc, in float32.
template <typename T, int VEC>
__device__ __forceinline__ void add_row(const T* __restrict__ p, float (&acc)[VEC]) {
  if constexpr (std::is_same_v<T, float> && VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    acc[0] += t.x;
    acc[1] += t.y;
    acc[2] += t.z;
    acc[3] += t.w;
  } else if constexpr (std::is_same_v<T, float>) {
    acc[0] += __ldg(p);
  } else if constexpr (VEC == 2) {
    const float2 t = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
    acc[0] += t.x;
    acc[1] += t.y;
  } else {
    acc[0] += __bfloat162float(__ldg(p));
  }
}

// Stores acc at p, rounded once to T (round to nearest even).
template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* __restrict__ p, const float (&acc)[VEC]) {
  if constexpr (std::is_same_v<T, float> && VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else if constexpr (std::is_same_v<T, float>) {
    p[0] = acc[0];
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(acc[0], acc[1]);
  } else {
    p[0] = __float2bfloat16_rn(acc[0]);
  }
}

// Narrow rows: one warp per dst row; LPE lanes per edge (a power of two,
// at least the row's columns), 32 / LPE edges a warp step.
template <typename T, typename Id, int VEC, int LPE>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel_rows(const T* __restrict__ data, const Id* __restrict__ ids,
                        const uint8_t* __restrict__ mask, T* __restrict__ out,
                        int64_t n_edges, int64_t n_rows, int64_t width) {
  constexpr int kEdges = 32 / LPE;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps
  const int slot = lane / LPE;
  const int64_t col = static_cast<int64_t>(lane % LPE) * VEC;
  const bool active = col < width;
  int64_t e0, e1;
  row_bounds(ids, n_edges, row, lane, e0, e1);

  float acc[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;
  auto body = [&](int64_t base, unsigned bits) {
#pragma unroll 4
    for (int t = 0; t < LPE; ++t) {
      const int o = t * kEdges + slot;
      if (active && (bits >> o & 1u)) add_row<T, VEC>(data + (base + o) * width + col, acc);
    }
  };
  for_valid_groups<kGranulesRows>(mask, e0, e1, lane, body);
#pragma unroll
  for (int off = 16; off >= LPE; off >>= 1) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[c] += __shfl_xor_sync(kFull, acc[c], off);
  }
  if (slot == 0 && active) store_row<T, VEC>(out + row * width + col, acc);
}

// Wider rows: one warp per (dst row, chunk of 32 CPL columns), the chunks
// of a row in consecutive warps; lane l takes columns l, l + 32, ...
template <typename T, typename Id, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel_cols(const T* __restrict__ data, const Id* __restrict__ ids,
                        const uint8_t* __restrict__ mask, T* __restrict__ out,
                        int64_t n_edges, int64_t n_rows, int64_t width, int64_t chunks) {
  constexpr int CPL = kColsPerLane;
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t row = warp / chunks;
  if (row >= n_rows) return;  // whole warps
  const int64_t col = ((warp - row * chunks) * 32 * CPL + lane) * VEC;
  int64_t e0, e1;
  row_bounds(ids, n_edges, row, lane, e0, e1);

  float acc[CPL][VEC];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[j][c] = 0.0f;
  }
  const T* __restrict__ base_col = data + col;
  auto body = [&](int64_t base, unsigned bits) {
    while (bits != 0u) {
      int64_t e[kInFlight];
      int n = 0;
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        e[q] = bits != 0u ? base + __ffs(bits) - 1 : 0;
        n += bits != 0u;
        bits &= bits - 1u;
      }
      float v[kInFlight][CPL][VEC];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
#pragma unroll
          for (int c = 0; c < VEC; ++c) v[q][j][c] = 0.0f;
          if (q < n && col + 32 * VEC * j < width) {
            add_row<T, VEC>(base_col + e[q] * width + 32 * VEC * j, v[q][j]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        if (q < n) {
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
#pragma unroll
            for (int c = 0; c < VEC; ++c) acc[j][c] += v[q][j][c];
          }
        }
      }
    }
  };
  for_valid_groups<kGranulesCols>(mask, e0, e1, lane, body);
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (col + 32 * VEC * j < width) store_row<T, VEC>(out + row * width + col + 32 * VEC * j, acc[j]);
  }
}

template <typename T, typename Id, int VEC>
cudaError_t launch(const T* data, const Id* ids, const uint8_t* mask, T* out,
                   int64_t n_edges, int64_t n_rows, int64_t width, cudaStream_t s) {
  const int64_t cols = width / VEC;
  if (cols <= 16) {
    const int64_t blocks = (n_rows + kWarps - 1) / kWarps;
    if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
    const unsigned g = static_cast<unsigned>(blocks);
    if (cols == 1) {
      segment_sum_kernel_rows<T, Id, VEC, 1><<<g, kThreads, 0, s>>>(data, ids, mask, out, n_edges, n_rows, width);
    } else if (cols == 2) {
      segment_sum_kernel_rows<T, Id, VEC, 2><<<g, kThreads, 0, s>>>(data, ids, mask, out, n_edges, n_rows, width);
    } else if (cols <= 4) {
      segment_sum_kernel_rows<T, Id, VEC, 4><<<g, kThreads, 0, s>>>(data, ids, mask, out, n_edges, n_rows, width);
    } else if (cols <= 8) {
      segment_sum_kernel_rows<T, Id, VEC, 8><<<g, kThreads, 0, s>>>(data, ids, mask, out, n_edges, n_rows, width);
    } else {
      segment_sum_kernel_rows<T, Id, VEC, 16><<<g, kThreads, 0, s>>>(data, ids, mask, out, n_edges, n_rows, width);
    }
  } else {
    const int64_t chunks = (cols + 32 * kColsPerLane - 1) / (32 * kColsPerLane);
    const int64_t blocks = (n_rows * chunks + kWarps - 1) / kWarps;
    if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
    segment_sum_kernel_cols<T, Id, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        data, ids, mask, out, n_edges, n_rows, width, chunks);
  }
  return cudaGetLastError();
}

// Elements a load: float4 (float32) or a bfloat162 pair where the width
// allows it and both pointers are aligned to the vector, else one.
template <typename T, typename Id>
cudaError_t launch_ids(const T* data, const Id* ids, const uint8_t* mask, T* out,
                       int64_t n_edges, int64_t n_rows, int64_t width, cudaStream_t s) {
  constexpr int kVec = std::is_same_v<T, float> ? 4 : 2;
  constexpr uintptr_t kAlign = kVec * sizeof(T);
  const bool vec = width % kVec == 0 && reinterpret_cast<uintptr_t>(data) % kAlign == 0 &&
                   reinterpret_cast<uintptr_t>(out) % kAlign == 0;
  return vec ? launch<T, Id, kVec>(data, ids, mask, out, n_edges, n_rows, width, s)
             : launch<T, Id, 1>(data, ids, mask, out, n_edges, n_rows, width, s);
}

template <typename T>
int segment_sum(const T* data, const void* ids, int id_bytes, const uint8_t* mask, T* out,
                int64_t n_edges, int64_t n_rows, int64_t width, void* stream) {
  if (n_rows <= 0 || width <= 0) return 0;
  if (n_edges < 0 || (id_bytes != 4 && id_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      id_bytes == 4
          ? launch_ids(data, static_cast<const int32_t*>(ids), mask, out, n_edges, n_rows, width, s)
          : launch_ids(data, static_cast<const long long*>(ids), mask, out, n_edges, n_rows, width, s);
  return static_cast<int>(err);
}

}  // namespace

// data (n_edges, width) float32; ids (n_edges) nondecreasing int32
// (id_bytes 4) or int64 (8, read as long long); mask (n_edges) bytes or null; out (n_rows,
// width) float32; all contiguous on the current device. Every row of out is
// written. Launches one kernel on `stream` and returns the launch's
// cudaError_t (0 = success); it does not synchronise.
extern "C" int distmlip_segment_sum_f32(const float* data, const void* ids, int id_bytes,
                                        const uint8_t* mask, float* out, int64_t n_edges,
                                        int64_t n_rows, int64_t width, void* stream) {
  return segment_sum(data, ids, id_bytes, mask, out, n_edges, n_rows, width, stream);
}

// The same with data and out bfloat16 (accumulated in float32, each output
// element rounded once).
extern "C" int distmlip_segment_sum_bf16(const __nv_bfloat16* data, const void* ids,
                                         int id_bytes, const uint8_t* mask, __nv_bfloat16* out,
                                         int64_t n_edges, int64_t n_rows, int64_t width,
                                         void* stream) {
  return segment_sum(data, ids, id_bytes, mask, out, n_edges, n_rows, width, stream);
}
