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
// bfloat16 (the models' compute_dtype="bfloat16"): each output element is
// its column's valid edges added in edge order into one float32 accumulator
// and rounded to bfloat16 once (round to nearest even), as the TPU kernel
// keeps an fp32 accumulator and stores in data.dtype
// (distmlip_tpu/kernels/segment.py:183, :217). The bound halves on the data
// and output terms: 2 bytes an element. Two routes, by the row:
//   - rows wider than 32 columns, the width a multiple of 8, data and out
//     16-byte aligned (MACE's 2048 and 5120, eSCN's 3200):
//     segment_sum_bf16_row_kernel, one block per dst row. Warp 0 finds the
//     row's edge range (row_bounds) and walks the mask once, staging the
//     valid edges' offsets in edge order in shared memory (up to 1024 a
//     round; a 512-edge window with no valid edge costs one 16-byte mask
//     load a lane, so the repeated-tail padding stays a few wide loads);
//     then every warp of the block adds them into its own columns. A lane
//     reads 8 bf16 (one uint4) twice, 256 columns apart: a warp owns 512
//     columns (1 KB of an edge row, as the float32 kernel's two float4s),
//     so 3200 columns take 7 warps, 5120 take 10 and 2048 take 4, and each
//     row pays one search and one mask walk where the shared template paid
//     one per warp (25 / 40 / 16 warps a row on bf16 pairs);
//   - everything else takes the shared template above on bf16 pairs (one a
//     lane, or two 32 apart on the wider path) or single values, as before:
//     at 32 columns or fewer the narrow kernel splits a warp into edge slots
//     and adds the slots by a shuffle tree whose shape follows the lanes an
//     edge takes, so 16-byte lanes there would either leave three lanes in
//     four idle or change the tree's order; a misaligned view or a width
//     that is not a multiple of 8 cannot take 16-byte loads.
// Both routes add each column's edges in the same order as the shared
// template on pairs did, so the output is bit for bit that kernel's
// (tools/kernel_ab.py prints a digest of each output to show it).
// Measured (tools/kernel_ab.py, kernel alone by the profiler, NVIDIA H100
// 80GB HBM3 at 700 W; 32768 edge rows, ~47 edges a non-empty dst row, 2560
// dst rows; PERF.md section 6): 0.0867 / 0.1231 / 0.0541 ms at 3200 / 5120
// / 2048 columns, 71% / 80% / 73% of the bytes bound, where the shared
// template on pairs took 0.1361 / 0.2056 / 0.0924. Other choices, measured
// in the same run: one uint4 a lane (twice the warps a row) 0.0847 /
// 0.1408 / 0.0574; two a lane with eight edge rows in flight (125
// registers against 86) 0.0842 / 0.1306 / 0.0575; one a lane, eight in
// flight 0.0927 / 0.1685 / 0.0555. Two a lane and four in flight is the
// fastest at 5120 and 2048 and within 3% at 3200, so they are the
// constants kBf16ColsPerLane and kBf16InFlight.

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

// ---- bfloat16 rows of 16-byte lanes: one block per dst row ---------------

constexpr int kBf16MaxWarps = 16;     // warps a block (a row's column chunks; more take grid.y)
constexpr int kBf16ListCap = 1024;    // valid edges staged in shared memory a round
constexpr int kBf16Windows = 8;       // 512-edge mask windows loaded a producer step
constexpr int kBf16ColsPerLane = 2;   // uint4 loads a lane, 256 columns apart
constexpr int kBf16InFlight = 4;      // edge rows loaded before they are added

// 8 bf16 (one uint4) added into acc in float32: a bf16 is the top half of
// its float, so the conversion is exact.
__device__ __forceinline__ void add8(float (&acc)[8], const uint4& v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] += __uint_as_float(w[k] << 16);
    acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Warp-wide: stages the valid edges of [ws, e1) into list as offsets from
// e0, in edge order, until the list could overflow; G mask windows of 512
// edges a step, all loads in flight before any is tested, and a window with
// no valid edge costs no store. Returns the count; ws moves to the first
// window not staged, and done tells whether it reached e1. Every lane ends
// with the same values.
template <int G>
__device__ __forceinline__ int stage_valid_edges(const uint8_t* __restrict__ mask, int64_t& ws,
                                                 int64_t e0, int64_t e1, int lane,
                                                 uint32_t* __restrict__ list, bool& done) {
  int n = 0;
  while (ws < e1) {
    unsigned bits[G];
#pragma unroll
    for (int j = 0; j < G; ++j) bits[j] = granule_bits(mask, ws + 512 * j + 16 * lane, e0, e1);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (__ballot_sync(kFull, bits[j] != 0u) == 0u) continue;
      const int c = __popc(bits[j]);
      int incl = c;  // inclusive scan of the lanes' counts: lane order is edge order
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += t;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      if (n + total > kBf16ListCap) {  // resume at this window next round
        ws += 512 * j;
        done = false;
        return n;
      }
      // e - e0 modulo 2^32: the window may start before e0, where no bit is set
      const uint32_t first = static_cast<uint32_t>(ws + 512 * j + 16 * lane - e0);
      int pos = n + incl - c;
      for (unsigned m = bits[j]; m != 0u; m &= m - 1u) list[pos++] = first + (__ffs(m) - 1);
      n += total;
    }
    ws += 512 * G;
  }
  done = true;
  return n;
}

// One block per dst row (blockIdx.x), its warps over chunks of 32 CPL
// vectors of the row (CPL = kBf16ColsPerLane; chunk blockIdx.y * warps +
// warp); lane l takes vectors chunk * 32 CPL + 32 j + l, j < CPL. Warp 0
// searches and stages; after a barrier every warp adds the staged edges
// into its columns, kBf16InFlight edge rows loaded before any is added;
// rows of more than kBf16ListCap valid edges take more rounds, the
// accumulators staying in registers.
template <typename Id>
__global__ void __launch_bounds__(32 * kBf16MaxWarps)
segment_sum_bf16_row_kernel(const __nv_bfloat16* __restrict__ data, const Id* __restrict__ ids,
                            const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                            int64_t n_edges, int64_t width) {
  __shared__ uint32_t list[kBf16ListCap];
  __shared__ int64_t s_e0;
  __shared__ int s_n, s_done;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x;
  const int64_t chunk = static_cast<int64_t>(blockIdx.y) * (blockDim.x >> 5) + warp;
  const int64_t col = (chunk * 32 * kBf16ColsPerLane + lane) * 8;  // the lane's first column
  bool on[kBf16ColsPerLane];
#pragma unroll
  for (int j = 0; j < kBf16ColsPerLane; ++j) on[j] = col + 256 * j < width;

  int64_t e0 = 0, e1 = 0, ws = 0;
  if (warp == 0) {
    row_bounds(ids, n_edges, row, lane, e0, e1);
    const int64_t align = static_cast<int64_t>(reinterpret_cast<uintptr_t>(mask) & 15u);
    ws = ((e0 + align) & ~int64_t{15}) - align;
  }
  float acc[kBf16ColsPerLane][8];
#pragma unroll
  for (int j = 0; j < kBf16ColsPerLane; ++j) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.0f;
  }
  const __nv_bfloat16* __restrict__ base_col = data + col;
  for (;;) {
    if (warp == 0) {
      bool done;
      const int n = stage_valid_edges<kBf16Windows>(mask, ws, e0, e1, lane, list, done);
      if (lane == 0) {
        s_e0 = e0;
        s_n = n;
        s_done = done;
      }
    }
    __syncthreads();
    const int n = s_n;
    const bool done = s_done != 0;
    const __nv_bfloat16* __restrict__ rows = base_col + s_e0 * width;
    for (int i = 0; i < n; i += kBf16InFlight) {
      uint4 v[kBf16InFlight][kBf16ColsPerLane];
#pragma unroll
      for (int q = 0; q < kBf16InFlight; ++q) {
        if (i + q < n) {
          const __nv_bfloat16* __restrict__ p = rows + static_cast<int64_t>(list[i + q]) * width;
#pragma unroll
          for (int j = 0; j < kBf16ColsPerLane; ++j) {
            if (on[j]) v[q][j] = __ldg(reinterpret_cast<const uint4*>(p + 256 * j));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kBf16InFlight; ++q) {
        if (i + q < n) {
#pragma unroll
          for (int j = 0; j < kBf16ColsPerLane; ++j) {
            if (on[j]) add8(acc[j], v[q][j]);
          }
        }
      }
    }
    if (done) break;
    __syncthreads();  // every warp is past the list before warp 0 restages it
  }
#pragma unroll
  for (int j = 0; j < kBf16ColsPerLane; ++j) {
    if (on[j]) {
      const float* a = acc[j];
      *reinterpret_cast<uint4*>(out + row * width + col + 256 * j) =
          make_uint4(pack_bf16x2(a[0], a[1]), pack_bf16x2(a[2], a[3]),
                     pack_bf16x2(a[4], a[5]), pack_bf16x2(a[6], a[7]));
    }
  }
}

// How a call runs, worked out once from its arguments: the instantiation,
// its grid and the figures of its plan. The launch takes it and
// distmlip_segment_sum_bf16_plan reports it, so the two cannot differ.
struct Route {
  const void* kernel;
  dim3 grid;
  unsigned threads;
  int path;               // 0 bf16 rows of 16-byte lanes; the shared template:
                          // 1 narrow on vectors, 2 narrow on single values,
                          // 3 wide on vectors, 4 wide on single values
  int vec;                // elements a load
  int64_t cols_a_warp;
  int64_t warps_a_row;
  int64_t in_flight;      // edge rows loaded a warp before any is added
                          // (narrow: edges a warp step)
  int64_t searches_a_row;
  int64_t chunks;         // the wide kernel's column chunks a row
};

// The shared template's route on VEC-element loads: narrow rows (up to 16
// vectors) a warp a row, LPE lanes an edge; wider rows a warp a chunk of
// 32 kColsPerLane vectors.
template <typename T, typename Id, int VEC>
cudaError_t route_vec(int64_t n_rows, int64_t width, Route& r) {
  const int64_t cols = width / VEC;
  r.threads = kThreads;
  r.vec = VEC;
  int64_t blocks;
  if (cols <= 16) {
    const int lpe = cols <= 1 ? 1 : cols <= 2 ? 2 : cols <= 4 ? 4 : cols <= 8 ? 8 : 16;
    const void* by_lpe[] = {reinterpret_cast<const void*>(segment_sum_kernel_rows<T, Id, VEC, 1>),
                            reinterpret_cast<const void*>(segment_sum_kernel_rows<T, Id, VEC, 2>),
                            reinterpret_cast<const void*>(segment_sum_kernel_rows<T, Id, VEC, 4>),
                            reinterpret_cast<const void*>(segment_sum_kernel_rows<T, Id, VEC, 8>),
                            reinterpret_cast<const void*>(segment_sum_kernel_rows<T, Id, VEC, 16>)};
    r.kernel = by_lpe[__builtin_ctz(lpe)];
    blocks = (n_rows + kWarps - 1) / kWarps;
    r.path = VEC > 1 ? 1 : 2;
    r.cols_a_warp = width;
    r.warps_a_row = 1;
    r.in_flight = 32 / lpe;
    r.searches_a_row = 1;
    r.chunks = 0;
  } else {
    r.kernel = reinterpret_cast<const void*>(segment_sum_kernel_cols<T, Id, VEC>);
    r.chunks = (cols + 32 * kColsPerLane - 1) / (32 * kColsPerLane);
    blocks = (n_rows * r.chunks + kWarps - 1) / kWarps;
    r.path = VEC > 1 ? 3 : 4;
    r.cols_a_warp = 32 * kColsPerLane * VEC;
    r.warps_a_row = r.chunks;
    r.in_flight = kInFlight;
    r.searches_a_row = r.chunks;
  }
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  r.grid = dim3(static_cast<unsigned>(blocks));
  return cudaSuccess;
}

// bf16 rows wider than 32 columns, the width a multiple of 8, data and out
// 16-byte aligned take segment_sum_bf16_row_kernel: a warp a chunk of 256
// kBf16ColsPerLane columns, up to kBf16MaxWarps a block, more chunks on
// grid.y. Everything else takes the shared template on float4 (float32)
// or bfloat162 pairs where the width and both pointers allow, else single
// values.
template <typename T, typename Id>
cudaError_t route(const T* data, const T* out, int64_t n_rows, int64_t width, Route& r) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(data), o = reinterpret_cast<uintptr_t>(out);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (width > 32 && width % 8 == 0 && d % 16 == 0 && o % 16 == 0) {
      const int64_t chunks = (width / 8 + 32 * kBf16ColsPerLane - 1) / (32 * kBf16ColsPerLane);
      const int64_t warps = chunks < kBf16MaxWarps ? chunks : kBf16MaxWarps;
      const int64_t slabs = (chunks + warps - 1) / warps;
      if (n_rows > 2147483647LL || slabs > 65535) return cudaErrorInvalidConfiguration;
      r.kernel = reinterpret_cast<const void*>(segment_sum_bf16_row_kernel<Id>);
      r.grid = dim3(static_cast<unsigned>(n_rows), static_cast<unsigned>(slabs));
      r.threads = static_cast<unsigned>(32 * warps);
      r.path = 0;
      r.vec = 8;
      r.cols_a_warp = 256 * kBf16ColsPerLane;
      r.warps_a_row = warps * slabs;
      r.in_flight = kBf16InFlight;
      r.searches_a_row = slabs;
      r.chunks = chunks;
      return cudaSuccess;
    }
  }
  constexpr int kVec = std::is_same_v<T, float> ? 4 : 2;
  constexpr uintptr_t kAlign = kVec * sizeof(T);
  const bool vec = width % kVec == 0 && d % kAlign == 0 && o % kAlign == 0;
  return vec ? route_vec<T, Id, kVec>(n_rows, width, r) : route_vec<T, Id, 1>(n_rows, width, r);
}

template <typename T, typename Id>
cudaError_t launch(const T* data, const Id* ids, const uint8_t* mask, T* out, int64_t n_edges,
                   int64_t n_rows, int64_t width, cudaStream_t s) {
  Route r;
  const cudaError_t err = route<T, Id>(data, out, n_rows, width, r);
  if (err != cudaSuccess) return err;
  // the row kernel takes (data, ids, mask, out, n_edges, width), the shared
  // template (data, ids, mask, out, n_edges, n_rows, width[, chunks])
  void* shared[] = {&data, &ids, &mask, &out, &n_edges, &n_rows, &width, &r.chunks};
  void* rows[] = {&data, &ids, &mask, &out, &n_edges, &width};
  return cudaLaunchKernel(r.kernel, r.grid, dim3(r.threads), r.path == 0 ? rows : shared, 0, s);
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
          ? launch(data, static_cast<const int32_t*>(ids), mask, out, n_edges, n_rows, width, s)
          : launch(data, static_cast<const long long*>(ids), mask, out, n_edges, n_rows, width, s);
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

// The plan distmlip_segment_sum_bf16 takes for bf16 rows of `width` at
// `data` and `out` (null: a fresh allocation, aligned) with ids of
// `id_bytes`: plan[0] the path (Route::path), [1] elements a load, [2]
// columns a warp, [3] warps a dst row, [4] edge rows in flight a warp
// (narrow: edges a warp step), [5] row searches a dst row, [6] registers a
// thread of the kernel. Returns a cudaError_t.
extern "C" int distmlip_segment_sum_bf16_plan(const __nv_bfloat16* data,
                                              const __nv_bfloat16* out, int64_t width,
                                              int id_bytes, int64_t* plan) {
  if (width <= 0 || (id_bytes != 4 && id_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Route r;
  cudaError_t err = id_bytes == 4 ? route<__nv_bfloat16, int32_t>(data, out, 1, width, r)
                                  : route<__nv_bfloat16, long long>(data, out, 1, width, r);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, r.kernel);
  const int64_t p[7] = {r.path,      r.vec,           r.cols_a_warp, r.warps_a_row,
                        r.in_flight, r.searches_a_row, attr.numRegs};
  for (int k = 0; k < 7; ++k) plan[k] = p[k];
  return static_cast<int>(err);
}
