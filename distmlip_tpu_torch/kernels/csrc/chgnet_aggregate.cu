// CHGNet's two fused edge aggregations: a gated MLP per edge, summed onto
// dst-sorted rows, float32 or bfloat16 in and out, fp32 accumulation,
// sm_90a.
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
// wide; C and the hidden width H are runtime ints, at most 64 each.
//
// Layer 1 is linear, so it distributes over the concat: [v[src] | v[dst] |
// e] W1 = (v W1_0)[src] + (v W1_1)[dst] + e W1_2. A gathered segment's
// product belongs to its node or bond row, not to the edge, and is taken
// once per row by a row projection below (chgnet_row_projection_kernel on
// float32 rows, chgnet_row_projection_bf16_kernel on the tensor cores for
// bf16 rows), into float32 tables: the wrapper packs W1's row block of each
// segment as [core | gate], (C, 2hp), and folds the layer-1 bias into the
// first segment's table. The per-edge kernels then do only per-edge work:
// the edge segment's product (C -> 2H), layer 2 of core and gate (H -> C
// each) and the gating, 32,768 FLOP per edge at C = H = 64 against 65,536
// (atom) and 81,920 (line) for the whole concat row. There are two of them
// on one walk of the edges (below):
//   - float32 data (chgnet_{atom,line}_conv_kernel): the products as
//     float32 FMAs on the CUDA cores; TF32 would break the float32 parity
//     bar of this port;
//   - bfloat16 data (chgnet_{atom,line}_conv_bf16_kernel, after the
//     projections): the products on the tensor cores, mma.sync bf16 with
//     fp32 accumulators, the hidden layer kept in registers.
//
// The float32 kernel. What bounds it: float32 operations. Beside the FMAs
// the products keep shared memory busy (12 loads per 128 FMAs), and each
// edge takes 256 activations, each an exact expf and a division.
//
// Its design. One block of up to 12 warps per SM stages W1's edge block
// (cp, 2hp) and [W2c | W2g] (hp, 2cp) once in shared memory (64 KB at C = H
// = 64); everything else is per warp, and no warp waits on another after
// the weights are staged:
//   - each warp owns a contiguous range of dst rows, cut so that every warp
//     gets about the same number of candidate edges plus 4 per row (a
//     32-way search of row_ptr); its rows are written by it alone, in edge
//     order: deterministic, no atomics;
//   - it screens its candidates 32 at a time (their mask, dst row and
//     gather ids loaded one batch ahead, so the loads land while a tile
//     computes), compacts the valid ones with a ballot into a ring of edge
//     ids and takes them in tiles of 8;
//   - while tile t computes, tile t + 1's staged rows (the src segment's
//     partial row, 2hp floats, and the edge or angle row) are in flight
//     into the warp's second shared-memory buffer with cp.async; the
//     row-local partials (the dst row's, and the center atom's for the line
//     conv) are read at the top of the tile (consecutive edges share them,
//     so they come from L1), abw during layer 2;
//   - layer 1 and layer 2 are register-tiled 4 x 8 per lane (4 edges; 4
//     hidden units, core and gate, or 8 output channels), laid out so that
//     every shared-memory load of a step takes two wavefronts (see
//     run_tile): 12 loads for 128 fused multiply-adds. The hidden and the
//     activated outputs go through the warp's own buffer;
//   - the dst sum is a segmented reduction in registers: lane c keeps the
//     running sum of channels c and c + 32 of the current row, adds the
//     tile's messages in edge order and writes a row when the walk passes
//     it (empty rows as zeros).
//
// Semantics of both (those of the plain versions in
// kernels/edge_aggregate.py):
//   - masked edges are never read and never added, so non-finite padding
//     (or a non-finite node row that only masked edges gather) cannot leak
//     into a sum;
//   - every output row is written, empty rows as zeros;
//   - offsets are 64-bit, edge ids 32-bit; gathered row ids of valid edges
//     must lie in range.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kEPW = 8;                 // edges per warp tile
constexpr int kMaxWarps = 12;           // warps per block
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kSmemLimit = 232448;      // bytes a block can use on sm_90
constexpr int kRing = kEPW + 32;        // a tile's leftovers plus one screened batch
constexpr int kMaxWidth = 64;           // C and H: 16 lanes x 4 units or channels
constexpr int kRowCost = 4;             // a row's weight against a candidate edge
                                        // when the rows are shared out

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

template <typename T>
constexpr bool kIsFloat = std::is_same<T, float>::value;

// two consecutive float32 elements (8 bytes)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// rows of per-row layer-1 partial products (2hp floats each) in a table
struct Table {
  const float* base;    // the first row's first column of this segment's block
  const int32_t* idx;   // (E) the row each edge gathers
  int64_t stride;       // floats per table row
};

struct Args {
  Table staged;         // src: staged through shared memory with cp.async
  Table direct[2];      // dst (and the line conv's center): read directly
  const float* edge;    // (E, C) the per-edge segment
  const float* abw;     // (E, C) per-edge multiplier, or null
  const float* w1e;     // (cp, 2hp) W1's edge block, [core | gate]
  const float* w2;      // (hp, 2cp) [W2c | W2g]
  const float* b2;      // (2cp) [b2c | b2g]
  const int64_t* row_ptr;  // (n_rows + 1)
  const int32_t* seg_ids;  // (E) dst row of each edge
  const uint8_t* mask;     // (E) or null
  float* out;              // (n_rows, C)
  int64_t n_rows;
  int channels;
  int hidden;
};

// shared-memory layout, in 4-byte words (every region starts 16-byte aligned)
struct Layout {
  int cp, hp, w1s, w2s, xs, hs, slot, o_w2, o_b2, o_warp, per_warp, warps;
  __host__ __device__ Layout(int c, int h, int nw) {
    cp = round4(c);
    hp = round4(h);
    w1s = 2 * hp;  // row stride of W1's edge block and of a partial row
    w2s = 2 * cp;  // row stride of [W2c | W2g] and of the output tile
    xs = cp + 4;   // row stride of the edge rows in a tile buffer
    hs = w1s + 4;  // row stride of the hidden tile (padded like xs: other banks)
    // one tile buffer: the edge rows (8, xs) and the staged partial rows
    // (8, 2hp); the hidden tile and then the output tile are written over it
    int words = xs + w1s;
    if (hs > words) words = hs;
    if (w2s > words) words = w2s;
    slot = kEPW * words;
    o_w2 = cp * w1s;
    o_b2 = o_w2 + hp * w2s;
    o_warp = round4(o_b2 + w2s);
    // two tile buffers, the ring (edge, row, src, dst, center) and each
    // buffer's tile metadata (edge, row, dst, center)
    per_warp = round4(2 * slot + 5 * kRing + 2 * 4 * kEPW);
    warps = nw;
  }
  __host__ __device__ int bytes() const { return (o_warp + warps * per_warp) * 4; }
};

__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }
__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 4-deep step of a lane's 4 x 8 tile: for its edges t (rows x + t xs),
//   acc[t][0..3] += x_t[k..k+3] . Wa[k..k+3][0..3]
//   acc[t][4..7] += x_t[k..k+3] . Wb[k..k+3][0..3]
// with wa, wb the weights' row k at the lane's two column groups.
__device__ __forceinline__ void fma_step(float (&acc)[4][8], const float* __restrict__ x, int xs,
                                         const float* __restrict__ wa,
                                         const float* __restrict__ wb, int ws) {
  float4 pa[4], pb[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    pa[r] = *reinterpret_cast<const float4*>(wa + r * ws);
    pb[r] = *reinterpret_cast<const float4*>(wb + r * ws);
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float4 v = *reinterpret_cast<const float4*>(x + t * xs);
    const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[t][0] = fmaf(xv[r], pa[r].x, acc[t][0]);
      acc[t][1] = fmaf(xv[r], pa[r].y, acc[t][1]);
      acc[t][2] = fmaf(xv[r], pa[r].z, acc[t][2]);
      acc[t][3] = fmaf(xv[r], pa[r].w, acc[t][3]);
      acc[t][4] = fmaf(xv[r], pb[r].x, acc[t][4]);
      acc[t][5] = fmaf(xv[r], pb[r].y, acc[t][5]);
      acc[t][6] = fmaf(xv[r], pb[r].z, acc[t][6]);
      acc[t][7] = fmaf(xv[r], pb[r].w, acc[t][7]);
    }
  }
}

// The smallest row r in [0, n_rows] with row_ptr[r] + kRowCost r >= t
// (t <= row_ptr[n_rows] + kRowCost n_rows): a 32-way search by one warp.
__device__ int64_t find_row(const int64_t* row_ptr, int64_t n_rows, int64_t t, int lane) {
  int64_t lo = 0, hi = n_rows;
  while (lo < hi) {
    const int64_t p = lo + (hi - lo) * lane / 32;
    const bool ge = row_ptr[p] + kRowCost * p >= t;
    const unsigned b = __ballot_sync(0xffffffffu, ge);
    if (b == 0u) {
      lo = __shfl_sync(0xffffffffu, p, 31) + 1;
    } else {
      const int j = __ffs(b) - 1;
      hi = __shfl_sync(0xffffffffu, p, j);
      if (j > 0) lo = __shfl_sync(0xffffffffu, p, j - 1) + 1;
      else lo = hi;
    }
  }
  return lo;
}

// The padded widths cp and hp: compile-time constants when CP, HP > 0 (the
// matgl widths, so the products unroll with immediate offsets), else the
// launch's.
template <int CP, int HP>
struct Dims {
  int cp_, hp_;
  __device__ explicit Dims(const Layout& L) : cp_(L.cp), hp_(L.hp) {}
  __device__ int cp() const { return CP > 0 ? CP : cp_; }
  __device__ int hp() const { return HP > 0 ? HP : hp_; }
  __device__ int w1s() const { return 2 * hp(); }
  __device__ int w2s() const { return 2 * cp(); }
  __device__ int xs() const { return cp() + 4; }
  __device__ int hs() const { return w1s() + 4; }
};

// A warp's screening state: its candidate range, the ring of screened
// valid edges and the next batch of 32 candidates, loaded one batch ahead.
struct Screen {
  int64_t cand, e_end;   // the next candidate, the end of the warp's range
  int head, count;       // the ring's first entry and its length
  bool ok;               // the batch: this lane's candidate is valid,
  int row, src, d0, d1;  // its dst row and gather ids
};

// Load the next batch's mask, dst rows and gather ids (a: Args or TcArgs).
template <int NDIR, typename A>
__device__ __forceinline__ void prefetch_batch(const A& a, Screen& sc, int lane) {
  const int64_t e = sc.cand + lane;
  const bool in = e < sc.e_end;
  sc.ok = in && (a.mask == nullptr || a.mask[e] != 0);
  if (in) {
    sc.row = a.seg_ids[e];
    sc.src = a.staged.idx[e];
    sc.d0 = a.direct[0].idx[e];
    if (NDIR > 1) sc.d1 = a.direct[1].idx[e];
  }
}

// The warp's own region of shared memory.
struct WarpMem {
  float* buf;   // two tile buffers of L.slot words
  int* ring;    // ring_e, ring_r, ring_s, ring_d0, ring_d1: kRing each
  int* meta;    // per buffer: edge, row, dst, center: kEPW each
  __device__ float* slot(const Layout& L, int s) const { return buf + s * L.slot; }
  __device__ int* tile(int s, int field) const { return meta + (s * 4 + field) * kEPW; }
};

// Fill the ring until it holds a tile (or the range is screened), move the
// next tile into buffer s, start its copies and return its edge count.
template <int NDIR, bool VEC, int CP, int HP>
__device__ int take_tile(const Args& a, const Layout& L, const WarpMem& m, int s, Screen& sc,
                         int lane) {
  const Dims<CP, HP> D(L);
  int* ring_e = m.ring;
  int* ring_r = ring_e + kRing;
  int* ring_s = ring_r + kRing;
  int* ring_d0 = ring_s + kRing;
  int* ring_d1 = ring_d0 + kRing;
  __syncwarp();  // every lane is done with the ring entries of the last tile
  while (sc.count < kEPW && sc.cand < sc.e_end) {
    const unsigned ballot = __ballot_sync(0xffffffffu, sc.ok);
    if (sc.ok) {
      const int pos = (sc.head + sc.count + __popc(ballot & ((1u << lane) - 1u))) % kRing;
      ring_e[pos] = static_cast<int>(sc.cand + lane);
      ring_r[pos] = sc.row;
      ring_s[pos] = sc.src;
      ring_d0[pos] = sc.d0;
      ring_d1[pos] = sc.d1;
    }
    sc.count += __popc(ballot);
    sc.cand += 32;
    prefetch_batch<NDIR>(a, sc, lane);  // lands while the tile computes
  }
  __syncwarp();
  const int n = sc.count < kEPW ? sc.count : kEPW;
  if (lane < n) {
    const int pos = (sc.head + lane) % kRing;
    m.tile(s, 0)[lane] = ring_e[pos];
    m.tile(s, 1)[lane] = ring_r[pos];
    m.tile(s, 2)[lane] = ring_d0[pos];
    m.tile(s, 3)[lane] = ring_d1[pos];
  }
  // the tile's staged rows: the src partial rows (2hp floats, 16-byte
  // chunks) and the edge rows (C floats; 16-byte chunks when C % 4 == 0)
  float* x = m.slot(L, s);
  float* ps = x + kEPW * D.xs();
  const int C = a.channels;
  const int qp = D.w1s() / 4;
  for (int t = lane; t < n * qp; t += 32) {
    const int i = t / qp, q = t - i * qp;
    const int64_t r = ring_s[(sc.head + i) % kRing];
    cp_async16(ps + i * D.w1s() + 4 * q, a.staged.base + r * a.staged.stride + 4 * q);
  }
  if (VEC) {
    const int qx = C / 4;
    for (int t = lane; t < n * qx; t += 32) {
      const int i = t / qx, q = t - i * qx;
      const int64_t e = ring_e[(sc.head + i) % kRing];
      cp_async16(x + i * D.xs() + 4 * q, a.edge + e * C + 4 * q);
    }
  } else {
    for (int t = lane; t < n * D.cp(); t += 32) {
      const int i = t / D.cp(), c = t - i * D.cp();
      const int64_t e = ring_e[(sc.head + i) % kRing];
      if (c < C) cp_async4(x + i * D.xs() + c, a.edge + e * C + c);
      else x[i * D.xs() + c] = 0.0f;  // zero padding up to cp
    }
  }
  cp_async_commit();
  sc.head = (sc.head + n) % kRing;
  sc.count -= n;
  return n;
}

// flush the running sums into row `cur` and move on
__device__ __forceinline__ void flush_row(const Args& a, int64_t& cur, float (&acc_row)[2],
                                          int lane) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int c = lane + 32 * g;
    if (c < a.channels) a.out[cur * a.channels + c] = acc_row[g];
    acc_row[g] = 0.0f;
  }
  ++cur;
}

// One tile of n <= 8 edges whose staged rows are in buffer s: layer 1
// (staged src partial + row-local partials + the edge row's product), silu,
// layer 2, the gating, and the ordered add into the running row sums.
//
// Lane (q, j) = (lane / 8, lane % 8) owns the tile's edges g, g + 2, g + 4,
// g + 6 with g = j % 2, and in layer 1 the hidden units u..u+3, core and
// gate, u = 16 q + 4 (j / 2). A quarter-warp then reads two input rows
// (padded strides put them in different banks) and, for the weights, 64
// contiguous bytes that the neighbouring quarter-warp continues, so every
// shared-memory load of a step is two wavefronts: 12 loads for 128 FMAs.
// In layer 2 quarter-warps 0-1 take the core channels and 2-3 the gate
// channels: c and c + 32 with c = 16 (q % 2) + 4 (j / 2).
template <int NDIR, int CP, int HP>
__device__ void run_tile(const Args& a, const Layout& L, const float* smem, const WarpMem& m,
                         int s, int n, int lane, int64_t& cur, float (&acc_row)[2]) {
  const Dims<CP, HP> D(L);
  const int C = a.channels;
  float* x = m.slot(L, s);
  const float* ps = x + kEPW * D.xs();
  float* hs = x;  // the hidden tile, written over the edge and partial rows
  float* os = x;  // the output tile, written over the hidden tile
  const int* te = m.tile(s, 0);
  const int* tr = m.tile(s, 1);
  const int q = lane >> 3, j = lane & 7;
  const int g = j & 1;
  const int u = 16 * q + 4 * (j >> 1);
  float acc[4][8];

  // 1. hidden = silu(P_src[src] + P_dst[dst] (+ P_ctr[ctr]) + e W1e); the
  //    bias is folded into P_src
  if (u < D.hp()) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float* p = ps + (2 * t + g) * D.w1s() + u;
      const float4 c = *reinterpret_cast<const float4*>(p);
      const float4 h = *reinterpret_cast<const float4*>(p + D.hp());
      acc[t][0] = c.x; acc[t][1] = c.y; acc[t][2] = c.z; acc[t][3] = c.w;
      acc[t][4] = h.x; acc[t][5] = h.y; acc[t][6] = h.z; acc[t][7] = h.w;
    }
#pragma unroll
    for (int d = 0; d < NDIR; ++d) {
      const int* ti = m.tile(s, 2 + d);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (2 * t + g < n) {
          const float* p = a.direct[d].base + static_cast<int64_t>(ti[2 * t + g]) * a.direct[d].stride + u;
          const float4 c = __ldg(reinterpret_cast<const float4*>(p));
          const float4 h = __ldg(reinterpret_cast<const float4*>(p + D.hp()));
          acc[t][0] += c.x; acc[t][1] += c.y; acc[t][2] += c.z; acc[t][3] += c.w;
          acc[t][4] += h.x; acc[t][5] += h.y; acc[t][6] += h.z; acc[t][7] += h.w;
        }
      }
    }
    const float* w1e = smem + u;
#pragma unroll 4
    for (int k = 0; k < D.cp(); k += 4) {
      fma_step(acc, x + g * D.xs() + k, 2 * D.xs(), w1e + k * D.w1s(),
               w1e + k * D.w1s() + D.hp(), D.w1s());
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[t][i] = silu(acc[t][i]);
    }
  }
  __syncwarp();  // every lane is done reading the edge rows
  if (u < D.hp()) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float* h = hs + (2 * t + g) * D.hs() + u;
      *reinterpret_cast<float4*>(h) = make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
      *reinterpret_cast<float4*>(h + D.hp()) =
          make_float4(acc[t][4], acc[t][5], acc[t][6], acc[t][7]);
    }
  }
  __syncwarp();

  // abw of the tile's edges in the reduction's layout (channels lane, lane
  // + 32), in flight during layer 2
  float ab[kEPW][2];
#pragma unroll
  for (int i = 0; i < kEPW; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = lane + 32 * r;
      ab[i][r] = a.abw != nullptr && i < n && c < C
                     ? __ldg(a.abw + static_cast<int64_t>(te[i]) * C + c)
                     : 1.0f;
    }
  }

  // 2. [silu(core) | sigmoid(gate)] = act(hidden_{c|g} [W2c | W2g] + [b2c | b2g])
  const int half = q >> 1;                  // 0: core, 1: gate
  const int c0 = 16 * (q & 1) + 4 * (j >> 1);  // channels c0..c0+3 and c0+32..c0+35
  const int col = half * D.cp() + c0;
  if (c0 < D.cp()) {
    const float4 b0 = *reinterpret_cast<const float4*>(smem + L.o_b2 + col);
    const float4 b1 = c0 + 32 < D.cp()
                          ? *reinterpret_cast<const float4*>(smem + L.o_b2 + col + 32)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      acc[t][0] = b0.x; acc[t][1] = b0.y; acc[t][2] = b0.z; acc[t][3] = b0.w;
      acc[t][4] = b1.x; acc[t][5] = b1.y; acc[t][6] = b1.z; acc[t][7] = b1.w;
    }
    const float* w2 = smem + L.o_w2 + col;
    const float* h0 = hs + g * D.hs() + half * D.hp();
    // past cp (narrow widths) the second group reads other weights and is
    // never written
#pragma unroll 4
    for (int k = 0; k < D.hp(); k += 4)
      fma_step(acc, h0 + k, 2 * D.hs(), w2 + k * D.w2s(), w2 + k * D.w2s() + 32, D.w2s());
  }
  __syncwarp();  // every lane is done reading the hidden tile
  if (c0 < D.cp()) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = half ? sigmoid(acc[t][i]) : silu(acc[t][i]);
      float* out = os + (2 * t + g) * D.w2s() + col;
      *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
      if (c0 + 32 < D.cp()) *reinterpret_cast<float4*>(out + 32) = make_float4(o[4], o[5], o[6], o[7]);
    }
  }
  __syncwarp();

  // 3. segmented sum in edge order: every lane adds channels lane and
  //    lane + 32 of each message to the running sum of its row
#pragma unroll
  for (int i = 0; i < kEPW; ++i) {
    if (i < n) {
      const int64_t r = tr[i];
      while (cur < r) flush_row(a, cur, acc_row, lane);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = lane + 32 * k;
        if (c < C) acc_row[k] += os[i * D.w2s() + c] * os[i * D.w2s() + D.cp() + c] * ab[i][k];
      }
    }
  }
}

template <int NDIR, bool VEC, int CP, int HP>
__device__ __forceinline__ void gated_aggregate(const Args& a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nw = blockDim.x >> 5;
  const Layout L(a.channels, a.hidden, nw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the weights, already packed and padded by the wrapper: straight copies
  for (int i = tid; i < L.cp * L.w1s / 4; i += blockDim.x)
    reinterpret_cast<float4*>(smem)[i] = __ldg(reinterpret_cast<const float4*>(a.w1e) + i);
  for (int i = tid; i < L.hp * L.w2s / 4; i += blockDim.x)
    reinterpret_cast<float4*>(smem + L.o_w2)[i] = __ldg(reinterpret_cast<const float4*>(a.w2) + i);
  for (int i = tid; i < L.w2s; i += blockDim.x) smem[L.o_b2 + i] = __ldg(a.b2 + i);
  __syncthreads();

  WarpMem m;
  m.buf = smem + L.o_warp + warp * L.per_warp;
  m.ring = reinterpret_cast<int*>(m.buf + 2 * L.slot);
  m.meta = m.ring + 5 * kRing;

  // this warp's rows [ra, rb): equal shares of candidate edges + kRowCost per row
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * nw;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * nw + warp;
  const int64_t total = a.row_ptr[a.n_rows] + kRowCost * a.n_rows;
  const int64_t ra = w == 0 ? 0 : find_row(a.row_ptr, a.n_rows, w * total / n_warps, lane);
  const int64_t rb = w + 1 == n_warps ? a.n_rows
                                      : find_row(a.row_ptr, a.n_rows, (w + 1) * total / n_warps, lane);
  if (ra >= rb) return;
  Screen sc{};
  sc.cand = a.row_ptr[ra];
  sc.e_end = a.row_ptr[rb];
  prefetch_batch<NDIR>(a, sc, lane);

  int64_t cur = ra;               // the row the walk is in
  float acc_row[2] = {0.0f, 0.0f};  // its running sums of channels lane, lane + 32
  int s = 0;
  int n = take_tile<NDIR, VEC, CP, HP>(a, L, m, s, sc, lane);
  while (n > 0) {
    // the next tile's rows fly while this one computes
    const int n_next = take_tile<NDIR, VEC, CP, HP>(a, L, m, s ^ 1, sc, lane);
    cp_async_wait<1>();
    __syncwarp();
    run_tile<NDIR, CP, HP>(a, L, smem, m, s, n, lane, cur, acc_row);
    __syncwarp();
    s ^= 1;
    n = n_next;
  }
  cp_async_wait<0>();
  while (cur < rb) flush_row(a, cur, acc_row, lane);
}

// VEC: C % 4 == 0 (16-byte copies of the edge rows). CP, HP: the padded
// widths as constants (64, 64: matgl's), or 0 for any.
template <bool VEC, int CP, int HP>
__global__ void __launch_bounds__(kMaxThreads, 1) chgnet_atom_conv_kernel(const Args a) {
  gated_aggregate<1, VEC, CP, HP>(a);
}

template <bool VEC, int CP, int HP>
__global__ void __launch_bounds__(kMaxThreads, 1) chgnet_line_conv_kernel(const Args a) {
  gated_aggregate<2, VEC, CP, HP>(a);
}

// Warps per block that the shared memory holds at (C, H), at most
// kMaxWarps; 0 when C or H is past kMaxWidth or not even one warp fits.
int pick_warps(int channels, int hidden) {
  if (channels < 1 || hidden < 1 || channels > kMaxWidth || hidden > kMaxWidth) return 0;
  for (int nw = kMaxWarps; nw >= 1; --nw) {
    if (Layout(channels, hidden, nw).bytes() <= kSmemLimit) return nw;
  }
  return 0;
}

template <int NDIR>
int launch(const Args& a, int64_t n_edges, void* stream) {
  if (a.n_rows <= 0 || a.channels <= 0) return 0;
  const int nw = pick_warps(a.channels, a.hidden);
  if (nw == 0 || n_edges >= 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one resident block per SM; fewer for small inputs (~256 candidates a warp)
  const int64_t want = (n_edges + a.n_rows * kRowCost + 256LL * nw - 1) / (256LL * nw);
  const int64_t blocks = want < sms ? (want > 0 ? want : 1) : sms;
  const int bytes = Layout(a.channels, a.hidden, nw).bytes();
  const bool vec = a.channels % 4 == 0;
  const bool matgl = a.channels == 64 && a.hidden == 64;
  auto kernel = NDIR == 1
      ? (matgl ? chgnet_atom_conv_kernel<true, 64, 64>
               : vec ? chgnet_atom_conv_kernel<true, 0, 0> : chgnet_atom_conv_kernel<false, 0, 0>)
      : (matgl ? chgnet_line_conv_kernel<true, 64, 64>
               : vec ? chgnet_line_conv_kernel<true, 0, 0> : chgnet_line_conv_kernel<false, 0, 0>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), 32 * nw, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
// ---------------------------------------------------------------------------
// The row projection: y (rows, m) = x (rows, k) W (k, m) [+ bias (m)], the
// layer-1 products of the gathered segments taken once per node or bond
// row; k is C (at most 64), m a multiple of 4 up to 256 (two segments'
// [core | gate] blocks side by side at H = 64).
//
// What bounds it: float32 FMAs (2 rows k m operations; 0.116 ms for the
// bond table (236,032, 64) @ (64, 256) against 0.090 ms of its bytes) or,
// at the 19,712-row atom tables, a few microseconds of either. No TF32: the
// port's float32 bar. The design is a persistent GEMM with W resident:
//   - about two blocks per SM walk the row tiles (tile t, t + grid, ...);
//     each loads the whole W panel (k4 x MT floats, 64 KB at 64 x 256,
//     zero-padded to MT columns and k4 = k rounded up to 4 rows) into shared
//     memory once, with cp.async, and the bias beside it;
//   - the x tiles (TR rows x k4, the whole depth in one tile: no per-slice
//     barrier) are double-buffered: tile t + grid lands by cp.async while
//     tile t computes;
//   - a warp owns 4 RT rows x 64 columns of the tile, a lane RT rows 4
//     apart x 8 columns (two float4 quads 32 apart): a warp's shared loads
//     read x 2 deep as float2 from 4 rows (4 banks apart, no conflict) and W
//     as float4 from 8 quads, RT + 4 loads for 16 RT FMAs every 2 k;
//   - the tile height TR = 4 RT x (8 warps / (MT / 64)) is chosen at launch
//     from RT in {5, 8} so that the tiles fill the SMs evenly (proj_plan):
//     19,712 rows make 493 tiles of 40 at MT 256 (3.7 a SM, against 308 of
//     64: 2.3, where a third of the SMs would run a third tile alone), while
//     the 236,032-row bond table takes RT 8, whose rows cost less (fewer
//     shared loads a FMA); at 128 registers a thread its k loop runs
//     unrolled 32 deep (64 and 16 measured slower), RT 5's 4 deep;
//   - the epilogue adds the bias and stores float4s.
// x rows need k % 4 == 0 and 16-byte alignment for the 16-byte copies; else
// each float is copied alone (4 bytes). Rows past the end read as zeros and
// are not stored. Every y element of [0, rows) x [0, m) is written.
//
// Its storage type T is float only: bf16 rows take the tensor-core kernel
// below (chgnet_row_projection_bf16_kernel).

constexpr int kPThreads = 256;
constexpr int kPMaxK = 64;
constexpr int kPMaxM = 256;
// the tile heights the plan chooses from, as rows a thread
#define PROJ_ROWS_PER_THREAD 5, 8
constexpr int kPRowsPerThread[] = {PROJ_ROWS_PER_THREAD};

// rows a tile: 4 RT rows a warp, 8 warps over MT / 64 column strips
__host__ __device__ constexpr int proj_tile_rows(int mt, int rt) {
  return 4 * rt * (kPThreads / 32) / (mt / 64);
}

// shared floats of one block: W (k4, MT), the bias (MT), two x tiles (TR, k4 + 4)
__host__ __device__ constexpr int proj_smem_floats(int mt, int tr, int k4) {
  return k4 * mt + mt + 2 * tr * (k4 + 4);
}

template <typename T, int MT, int RT, bool VEC4>
__device__ __forceinline__ void proj_load_tile(float* __restrict__ xs, const T* __restrict__ x,
                                               int64_t rows, int k_dim, int k4, int64_t r0) {
  constexpr int TR = proj_tile_rows(MT, RT);
  const int ks = k4 + 4;
  if constexpr (VEC4) {
    const int q4 = k4 / 4;
    for (int i = threadIdx.x; i < TR * q4; i += kPThreads) {
      const int r = i / q4, c = (i - r * q4) * 4;
      float* dst = xs + r * ks + c;
      if (r0 + r < rows) {
        cp_async16(dst, x + (r0 + r) * k_dim + c);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < TR * k4; i += kPThreads) {
      const int r = i / k4, c = i - r * k4;
      float* dst = xs + r * ks + c;
      if (r0 + r < rows && c < k_dim) {
        cp_async4(dst, x + (r0 + r) * k_dim + c);
      } else {
        *dst = 0.0f;
      }
    }
  }
}

// Two k steps of a lane's RT x 8 outputs: x of its RT rows (4 apart, row
// stride ks) at k and k + 1, W's rows k and k + 1 at its two column quads.
template <typename T, int MT, int RT>
__device__ __forceinline__ void proj_k_step(float (&acc)[RT][8], const T* __restrict__ xt,
                                            const float* __restrict__ wt, int ks, int k) {
  float2 a[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) a[i] = load2(xt + 4 * i * ks + k);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const float4 b0 = *reinterpret_cast<const float4*>(wt + (k + kk) * MT);
    const float4 b1 = *reinterpret_cast<const float4*>(wt + (k + kk) * MT + 32);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float av = kk == 0 ? a[i].x : a[i].y;
      acc[i][0] = fmaf(av, b0.x, acc[i][0]);
      acc[i][1] = fmaf(av, b0.y, acc[i][1]);
      acc[i][2] = fmaf(av, b0.z, acc[i][2]);
      acc[i][3] = fmaf(av, b0.w, acc[i][3]);
      acc[i][4] = fmaf(av, b1.x, acc[i][4]);
      acc[i][5] = fmaf(av, b1.y, acc[i][5]);
      acc[i][6] = fmaf(av, b1.z, acc[i][6]);
      acc[i][7] = fmaf(av, b1.w, acc[i][7]);
    }
  }
}

template <typename T, int MT, int RT, bool VEC4, int KT>
__global__ void __launch_bounds__(kPThreads, 2)
chgnet_row_projection_kernel(const T* __restrict__ x, int64_t rows, int k_dim,
                             const float* __restrict__ w, int m, const float* __restrict__ bias,
                             float* __restrict__ y, int64_t n_tiles) {
  constexpr int WC = MT / 64;            // warps across the columns, 64 columns each
  constexpr int TR = proj_tile_rows(MT, RT);
  extern __shared__ float4 proj_smem4[];
  float* __restrict__ ws = reinterpret_cast<float*>(proj_smem4);
  const int k4 = KT > 0 ? KT : (k_dim + 3) & ~3;
  const int ks = k4 + 4;  // x tile row stride: 16-byte rows, 4 banks apart
  float* __restrict__ bs = ws + k4 * MT;
  float* __restrict__ xs[2] = {bs + MT, bs + MT + TR * ks};
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // a lane's rows: row0 + 4 i (i < RT); its columns: col0 + {0..3} and col0 + 32 + {0..3}.
  // A warp's x reads are 4 rows (one wavefront, 4 banks apart), its W reads 8 float4s.
  const int row0 = (warp / WC) * 4 * RT + (lane >> 3);
  const int col0 = (warp % WC) * 64 + (lane & 7) * 4;

  // W (zero past k_dim rows and m columns) and the bias, with the first tile
  for (int i = tid; i < k4 * (MT / 4); i += kPThreads) {
    const int k = i / (MT / 4), j = (i - k * (MT / 4)) * 4;
    float* dst = ws + k * MT + j;
    if (k < k_dim && j < m) {
      cp_async16(dst, w + static_cast<int64_t>(k) * m + j);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  for (int j = tid; j < MT; j += kPThreads) bs[j] = bias != nullptr && j < m ? __ldg(bias + j) : 0.0f;
  int64_t tile = blockIdx.x;
  proj_load_tile<T, MT, RT, VEC4>(xs[0], x, rows, k_dim, k4, tile * TR);
  cp_async_commit();

  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles)
      proj_load_tile<T, MT, RT, VEC4>(xs[buf ^ 1], x, rows, k_dim, k4, next * TR);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and W) landed; the next may still be in flight
    __syncthreads();

    const int xst = kIsFloat<T> ? ks : k4 + 8;  // the x tile's row stride in values
    const T* __restrict__ xt = reinterpret_cast<const T*>(xs[buf]) + row0 * xst;
    const float* __restrict__ wt = ws + col0;
    float acc[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    if constexpr (KT > 0) {  // K = 64 at 8 rows a thread: 32 deep unrolled
#pragma unroll 16
      for (int k = 0; k < KT; k += 2) proj_k_step<T, MT, RT>(acc, xt, wt, xst, k);
    } else {
#pragma unroll 2
      for (int k = 0; k < k4; k += 2) proj_k_step<T, MT, RT>(acc, xt, wt, xst, k);
    }
    __syncthreads();  // every read of xs[buf] is done before the next prefetch lands there

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = col0 + 32 * h;
      if (n >= m) continue;
      const float4 b = *reinterpret_cast<const float4*>(bs + n);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int64_t r = tile * TR + row0 + 4 * i;
        if (r >= rows) continue;
        *reinterpret_cast<float4*>(y + r * m + n) =
            make_float4(acc[i][4 * h] + b.x, acc[i][4 * h + 1] + b.y, acc[i][4 * h + 2] + b.z,
                        acc[i][4 * h + 3] + b.w);
      }
    }
  }
  cp_async_wait<0>();
}

// The launch's plan: MT (128 or 256), RT, rows a tile, the SMs, tiles, blocks.
struct ProjPlan {
  int mt, rt, tile_rows, sms;
  int64_t tiles, blocks;
};

// Blocks a SM holds on the current device. The shared-memory limit is a
// per-device attribute, so it is set on every call (as the conv launches do).
template <typename T, int MT, int RT, bool VEC4, int KT>
cudaError_t proj_occupancy(int k4, int* per_sm) {
  constexpr int TR = proj_tile_rows(MT, RT);
  auto kernel = chgnet_row_projection_kernel<T, MT, RT, VEC4, KT>;
  const int bytes = proj_smem_floats(MT, TR, k4) * static_cast<int>(sizeof(float));
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kPThreads, bytes);
}

// A row's relative cost at each tile height (kernel time per row at large
// row counts on an H100, PERF.md: tools/kernel_ab.py --variants).
constexpr double proj_row_cost(int rt) { return rt == 5 ? 1.0 : 0.96; }

// The tile height whose busiest SM gets the least work: ceil(tiles / SMs)
// tiles of TR rows, each row at proj_row_cost; SMs of the current device.
cudaError_t proj_plan(int64_t rows, int m, ProjPlan* plan) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  plan->sms = sms;
  plan->mt = m <= 128 ? 128 : 256;
  int rt = 0;
  double best = 0.0;
  for (const int r : kPRowsPerThread) {
    const int tr = proj_tile_rows(plan->mt, r);
    const double c =
        static_cast<double>(((rows + tr - 1) / tr + sms - 1) / sms) * tr * proj_row_cost(r);
    if (rt == 0 || c < best) rt = r, best = c;
  }
  plan->rt = rt;
  plan->tile_rows = proj_tile_rows(plan->mt, rt);
  plan->tiles = (rows + plan->tile_rows - 1) / plan->tile_rows;
  return cudaSuccess;
}

template <typename T>
struct ProjArgs {
  const T* x;
  int64_t rows;
  int k_dim;
  const float* w;
  int m;
  const float* bias;
  float* y;  // null: plan only
  bool vec4;
};

template <typename T, int MT, int RT, bool VEC4, int KT>
cudaError_t proj_run(const ProjArgs<T>& a, ProjPlan* p, cudaStream_t s) {
  constexpr int TR = proj_tile_rows(MT, RT);
  const int k4 = (a.k_dim + 3) & ~3;
  int per_sm = 0;
  const cudaError_t err = proj_occupancy<T, MT, RT, VEC4, KT>(k4, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t slots = static_cast<int64_t>(per_sm) * p->sms;
  p->blocks = p->tiles < slots ? p->tiles : slots;
  if (a.y == nullptr) return cudaSuccess;
  chgnet_row_projection_kernel<T, MT, RT, VEC4, KT>
      <<<static_cast<unsigned>(p->blocks), kPThreads,
         proj_smem_floats(MT, TR, k4) * sizeof(float), s>>>(a.x, a.rows, a.k_dim, a.w, a.m,
                                                           a.bias, a.y, p->tiles);
  return cudaGetLastError();
}

// K = 64 at RT 8 takes the compile-time depth; the rest a runtime loop (for
// RT 5 at K = 64 too: it measured faster at the 19,712 x 256 atom table).
template <typename T, int MT, int RT>
cudaError_t proj_dispatch_k(const ProjArgs<T>& a, ProjPlan* p, cudaStream_t s) {
  if constexpr (RT == 8) {
    if ((a.k_dim + 3) / 4 == kPMaxK / 4) {
      return a.vec4 ? proj_run<T, MT, RT, true, kPMaxK>(a, p, s)
                    : proj_run<T, MT, RT, false, kPMaxK>(a, p, s);
    }
  }
  return a.vec4 ? proj_run<T, MT, RT, true, 0>(a, p, s) : proj_run<T, MT, RT, false, 0>(a, p, s);
}

template <typename T, int MT, int RT, int... MORE>
cudaError_t proj_dispatch_rt(const ProjArgs<T>& a, ProjPlan* p, cudaStream_t s) {
  if (p->rt == RT) return proj_dispatch_k<T, MT, RT>(a, p, s);
  if constexpr (sizeof...(MORE) > 0) {
    return proj_dispatch_rt<T, MT, MORE...>(a, p, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t proj_dispatch(const ProjArgs<T>& a, ProjPlan* p, cudaStream_t s) {
  return p->mt == 128 ? proj_dispatch_rt<T, 128, PROJ_ROWS_PER_THREAD>(a, p, s)
                      : proj_dispatch_rt<T, 256, PROJ_ROWS_PER_THREAD>(a, p, s);
}

cudaError_t proj_check(int64_t rows, int k_dim, int m) {
  if (rows < 0 || k_dim < 1 || k_dim > kPMaxK || m < 4 || m > kPMaxM || m % 4 != 0)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The projection's launch: checks, the plan, the dispatch. vec4: 16-byte
// copies of x rows (k % 4 == 0 for float32, k % 8 == 0 for bf16, and
// 16-byte aligned x).
template <typename T>
int proj_launch(const T* x, int64_t rows, int k_dim, const float* w, int m, const float* bias,
                float* y, void* stream) {
  cudaError_t err = proj_check(rows, k_dim, m);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(w) || misaligned(bias) || misaligned(y))
    return static_cast<int>(cudaErrorMisalignedAddress);
  ProjPlan plan{};
  err = proj_plan(rows, m, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ProjArgs<T> a{x, rows, k_dim, w, m, bias, y,
                      k_dim % (kIsFloat<T> ? 4 : 8) == 0 && !misaligned(x)};
  return static_cast<int>(proj_dispatch(a, &plan, static_cast<cudaStream_t>(stream)));
}

// ---------------------------------------------------------------------------
// The row projection at bf16 rows (the bf16 model's node and bond rows):
// y (rows, m) float32 = x (rows, k) bf16 @ W (k, m) bf16 [+ bias (m)
// float32], the products on the tensor cores (mma.sync m16n8k16, bf16
// products exact in fp32, fp32 accumulators), so the tables the per-edge
// kernels read stay float32. Also a part of segment.py:224's body (layer 1
// of the gathered segments), taken once per row.
//
// What bounds it: bytes. At the bond table (236,032, 64) @ (64, 256) it
// reads 30.2 MB of x and writes 241.7 MB of table, 0.081 ms at 3.35 TB/s,
// against 0.008 ms of bf16 tensor-core work; 89% of the bytes are the
// float32 table it writes. (The float32 kernel above, run on bf16 rows,
// took the products as float32 FMAs on the CUDA cores: 0.116 ms of
// operations alone.) Design:
//   - a persistent grid of one block an SM walks the row tiles (t, t +
//     grid, ...). W is staged once a block into shared memory, transposed
//     (W^T, k contiguous, zero past k and m, k padded to whole k16 steps),
//     and stays there; each warp takes its B fragments from it into
//     registers once: a warp owns a 64-column strip, 8 n8 tiles x
//     ceil(k / 16) k16 steps (64 registers at k = 64), for the whole walk;
//   - the x tiles come through a ring of 4 stages by 16-byte cp.async (k %
//     8 == 0 and 16-byte aligned x; plain loads otherwise), each row padded
//     with zeros to whole k16 steps and by 16 bytes more, so the 8 rows an
//     ldmatrix reads lie in different banks; one block barrier a tile;
//   - a warp takes 2 m16 tiles of its row block, each with one ldmatrix.x4
//     of A and 8 mma a k16 step. One shuffle a value swaps lane pairs'
//     halves, so each lane holds 4 consecutive columns of one row, adds the
//     bias and writes them as one 16-byte store (a warp instruction fills
//     16 whole 32-byte sectors). Nothing waits on the stores: they drain
//     while the warp computes its next m16 tile and the block its next tile.
// A tile is 64 rows at m > 128 (4 column strips x 2 row blocks of 32), 128
// rows otherwise (2 x 4). Rows past the end are computed from stale rows and
// not stored; every y element of [0, rows) x [0, m) is written.

constexpr int kQThreads = 256;
constexpr int kQStages = 4;

// rows a tile at MT columns a block: MT / 64 column strips, 8 warps, 32 rows a warp
__host__ __device__ constexpr int qtile_rows(int mt) { return 32 * (kQThreads / 32) / (mt / 64); }
// bf16 values a shared row at KS k16 steps: 16 bytes of padding, so the rows
// an ldmatrix reads (and a warp's B fragment loads) fall in different banks
__host__ __device__ constexpr int qrow(int ks) { return 16 * ks + 8; }
// shared bytes of a block: W^T (MT rows), the bias (MT floats), the ring
__host__ __device__ constexpr int qsmem_bytes(int mt, int ks) {
  return mt * qrow(ks) * 2 + mt * 4 + kQStages * qtile_rows(mt) * qrow(ks) * 2;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s)
               : "memory");
}

// d (16 x 8 fp32) += A (16 x 16 bf16) B (16 x 8 bf16), the fragments of
// mma.m16n8k16's row and col layouts
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One x tile of TR rows into a ring stage: 16-byte copies of the rows' k
// values (VEC; the padding columns keep the zeros written at the start), or
// plain loads of every column, zeros past k and past the last row.
template <int MT, int KS, bool VEC>
__device__ __forceinline__ void qload_tile(__nv_bfloat16* __restrict__ xs,
                                           const __nv_bfloat16* __restrict__ x, int64_t rows,
                                           int k_dim, int64_t r0) {
  constexpr int TR = qtile_rows(MT), R = qrow(KS), KP = 16 * KS;
  if constexpr (VEC) {
    const int q8 = k_dim / 8;
    for (int i = threadIdx.x; i < TR * q8; i += kQThreads) {
      const int r = i / q8, c = (i - r * q8) * 8;
      if (r0 + r < rows) cp_async16(xs + r * R + c, x + (r0 + r) * k_dim + c);
    }
  } else {
    for (int i = threadIdx.x; i < TR * KP; i += kQThreads) {
      const int r = i / KP, c = i - r * KP;
      xs[r * R + c] = r0 + r < rows && c < k_dim ? x[(r0 + r) * k_dim + c]
                                                 : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int MT, int KS, bool VEC>
__global__ void __launch_bounds__(kQThreads, 1)
chgnet_row_projection_bf16_kernel(const __nv_bfloat16* __restrict__ x, int64_t rows, int k_dim,
                                  const __nv_bfloat16* __restrict__ w, int m,
                                  const float* __restrict__ bias, float* __restrict__ y,
                                  int64_t n_tiles) {
  constexpr int WC = MT / 64, TR = qtile_rows(MT), R = qrow(KS), KP = 16 * KS;
  extern __shared__ float4 q_smem4[];
  __nv_bfloat16* __restrict__ wt = reinterpret_cast<__nv_bfloat16*>(q_smem4);
  float* __restrict__ bs = reinterpret_cast<float*>(wt + MT * R);
  __nv_bfloat16* __restrict__ ring = reinterpret_cast<__nv_bfloat16*>(bs + MT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // W^T and the bias, once; the ring zeroed, so the columns past k_dim that
  // the copies never write read as zeros
  for (int i = tid; i < KP * MT; i += kQThreads) {
    const int k = i / MT, n = i - k * MT;
    wt[n * R + k] = k < k_dim && n < m ? w[static_cast<int64_t>(k) * m + n]
                                       : __float2bfloat16_rn(0.0f);
  }
  for (int j = tid; j < MT; j += kQThreads) bs[j] = bias != nullptr && j < m ? __ldg(bias + j) : 0.0f;
  for (int i = tid; i < kQStages * TR * R / 8; i += kQThreads) {
    reinterpret_cast<float4*>(ring)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  // the warp's B fragments for the whole walk: b[s][j] holds W rows 16 s +
  // 2 q (+1) and + 8 (+9) of column 64 strip + 8 j + g
  const int strip = warp % WC, block = warp / WC;
  const int g = lane >> 2, q = lane & 3;
  uint32_t b[KS][8][2];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* p = wt + (strip * 64 + j * 8 + g) * R + s * 16 + 2 * q;
      b[s][j][0] = *reinterpret_cast<const uint32_t*>(p);
      b[s][j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
    }
  }

  int64_t tile = blockIdx.x;
#pragma unroll
  for (int s = 0; s < kQStages - 1; ++s) {  // the block's first tiles into the ring
    const int64_t t = tile + s * static_cast<int64_t>(gridDim.x);
    if (t < n_tiles) qload_tile<MT, KS, VEC>(ring + s * TR * R, x, rows, k_dim, t * TR);
    cp_async_commit();
  }
  const bool odd = q & 1;  // an odd lane writes row g + 8, an even lane row g
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    cp_async_wait<kQStages - 2>();  // this tile landed
    __syncthreads();                // for every thread; and the stage loaded below is free
    const int64_t ahead = tile + static_cast<int64_t>(kQStages - 1) * gridDim.x;
    if (ahead < n_tiles) {
      qload_tile<MT, KS, VEC>(ring + ((it + kQStages - 1) % kQStages) * TR * R, x, rows, k_dim,
                              ahead * TR);
    }
    cp_async_commit();
    const __nv_bfloat16* xt = ring + (it % kQStages) * TR * R;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int rb = (block * 2 + mt) * 16;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t a[4];
        ldmatrix_x4(a, xt + (rb + (lane & 15)) * R + s * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(acc[j], a, b[s][j]);
      }
      // acc[j]: (row g, columns 2q, 2q + 1), (row g + 8, the same). The pair
      // (2p, 2p + 1) swaps halves: the even lane takes row g, columns 4p..4p+3,
      // the odd lane row g + 8, the same columns.
      const int64_t r = tile * TR + rb + g + (odd ? 8 : 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][0] : acc[j][2], 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][1] : acc[j][3], 1);
        const int n = strip * 64 + j * 8 + 2 * (q & 2);
        if (r < rows && n < m) {
          const float4 bb = *reinterpret_cast<const float4*>(bs + n);
          *reinterpret_cast<float4*>(y + r * m + n) =
              odd ? make_float4(s0 + bb.x, s1 + bb.y, acc[j][2] + bb.z, acc[j][3] + bb.w)
                  : make_float4(acc[j][0] + bb.x, acc[j][1] + bb.y, s0 + bb.z, s1 + bb.w);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The bf16 projection's plan: columns a block (MT), k16 steps, rows a tile,
// the SMs, tiles, blocks.
struct QPlan {
  int mt, ks, tile_rows, sms;
  int64_t tiles, blocks;
};

struct QArgs {
  const __nv_bfloat16* x;
  int64_t rows;
  int k_dim;
  const __nv_bfloat16* w;
  int m;
  const float* bias;
  float* y;  // null: plan only
  bool vec;
};

template <int MT, int KS, bool VEC>
cudaError_t qrun(const QArgs& a, QPlan* p, cudaStream_t s) {
  constexpr int bytes = qsmem_bytes(MT, KS);
  auto kernel = chgnet_row_projection_bf16_kernel<MT, KS, VEC>;
  // a per-device attribute: set on every call
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  p->tile_rows = qtile_rows(MT);
  p->tiles = (a.rows + p->tile_rows - 1) / p->tile_rows;
  p->blocks = p->tiles < p->sms ? p->tiles : p->sms;
  if (a.y == nullptr || p->tiles == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(p->blocks), kQThreads, bytes, s>>>(a.x, a.rows, a.k_dim, a.w,
                                                                    a.m, a.bias, a.y, p->tiles);
  return cudaGetLastError();
}

template <int MT, int KS>
cudaError_t qrun_vec(const QArgs& a, QPlan* p, cudaStream_t s) {
  return a.vec ? qrun<MT, KS, true>(a, p, s) : qrun<MT, KS, false>(a, p, s);
}

template <int MT>
cudaError_t qdispatch_ks(const QArgs& a, QPlan* p, cudaStream_t s) {
  switch (p->ks) {
    case 1: return qrun_vec<MT, 1>(a, p, s);
    case 2: return qrun_vec<MT, 2>(a, p, s);
    case 3: return qrun_vec<MT, 3>(a, p, s);
    default: return qrun_vec<MT, 4>(a, p, s);
  }
}

// Checks, the plan (MT from m, the k16 steps from k, the SMs of the current
// device) and, when a.y is given, the launch.
cudaError_t qlaunch(const QArgs& a, QPlan* p, cudaStream_t s) {
  cudaError_t err = proj_check(a.rows, a.k_dim, a.m);
  if (err != cudaSuccess) return err;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  p->mt = a.m <= 128 ? 128 : 256;
  p->ks = (a.k_dim + 15) / 16;
  return p->mt == 128 ? qdispatch_ks<128>(a, p, s) : qdispatch_ks<256>(a, p, s);
}

// ---------------------------------------------------------------------------
// The per-edge kernels at bf16 data (the bf16 model's edge and angle rows,
// abw and output; float32 tables from the bf16 projection; bf16 packed
// weights): the same function and the same walk as the float32 kernels
// above (each warp a contiguous range of dst rows cut by find_row,
// candidates screened with a ballot into a ring one batch ahead, the src
// partial rows and the bf16 edge rows staged by cp.async into a second
// buffer while a tile computes, the dst and center partial rows read
// directly, each dst row summed in edge order by one warp and written once),
// with the per-edge products on the tensor cores. That is the TPU kernel's
// contract at bf16 data: blocks in the data's dtype, an fp32 accumulator,
// the output in the message's dtype (distmlip_tpu/kernels/segment.py:
// 300-317), and the gated MLP of distmlip_tpu/ops/nn.py:119-122, whose bf16
// linear (:36) hands layer 2 a bf16 hidden.
//
// A tile is 16 edges (one m16) of one warp; a lane (g, q) = (lane / 4,
// lane % 4) holds rows g and g + 8 of each accumulator tile, columns 2q and
// 2q + 1 of its n8 tile (mma.m16n8k16's C fragment):
//   1. layer 1's accumulators (16 edges x 2 x 16 ht hidden units, core and
//      gate) start from the gathered partial rows, read as float2s in the
//      fragment layout: the dst and center rows from global memory, loaded
//      at the end of the tile before (so they land while the walk takes
//      the next tile), then the staged src rows from shared memory (a row
//      stride of 8 mod 32 words puts a fragment's 8 rows in different
//      banks);
//   2. the edge segment's product: A the staged bf16 edge rows (ldmatrix.x4;
//      16 ks1 + 8 values a row, so an ldmatrix's 8 rows fall in different
//      banks), B W1e^T in bf16, resident in shared memory and zero-padded to
//      whole k16 steps, mma.sync.m16n8k16.f32.bf16.bf16.f32;
//   3. silu in fp32 (through tanh.approx, step 4), then one rounding of the
//      hidden to bf16: two adjacent n8 accumulator tiles are, lane for lane,
//      the A fragment of one k16 step, so the hidden becomes layer 2's A
//      operand in registers and never passes through shared memory. This
//      is the only rounding the kernel adds to the float32 kernel's
//      arithmetic, and the reference's bf16 linear makes it too;
//   4. layer 2, core and gate, from b2 (fp32) with B W2^T in bf16, resident;
//      silu and sigmoid in fp32 through tanh.approx.f32 (one MUFU operation
//      each, where the exact expf and division take two and, with their
//      range reduction and Newton steps, held the kernel at about twice its
//      time), the gate product and abw (bf16 pairs read in the fragment
//      layout before layer 1, so they land meanwhile);
//   5. the fp32 message (16 x C) into the warp's buffer, over the partial
//      rows the tile has consumed; then the segmented row sum in edge order
//      as in the float32 kernel, each output element rounded once to bf16
//      when its row is written.
//
// What bounds it on an H100. Not the products: 32,768 FLOP an edge is 0.03
// ms for the atom conv (885,410 valid edges) and 0.07 ms for the line conv
// (2,162,688 valid lines) at 989 TFLOP/s. Two floors remain:
//   - the SFU: 256 activations an edge (128 silu in layer 1, 64 silu and 64
//     sigmoid in layer 2), one MUFU operation each through tanh.approx: at
//     132 SMs x 16 a clock x 1.98 GHz, 0.054 ms (atom conv) and 0.132 ms
//     (line conv); an exact expf and a division would take twice that;
//   - gathered bytes: the line conv gathers the float32 bond table, (236,032,
//     4 x 64) floats at the path's shapes (242 MB, past the 50 MB L2), at
//     both ends; the staged src rows (512 B each) come in no order, up to
//     1.1 GB, 0.33 ms. The atom table (19,712 rows, 20 MB) stays in L2.
// mma.sync and not wgmma: the tensor-core work is far below both floors even
// at mma.sync's rate, and each warp walks its own CSR range; a wgmma 64-row
// tile would tie four warps' ranges together to buy a rate this kernel does
// not need.
//
// Shared memory: W1e^T, W2^T and b2 once a block (37 KB at C = H = 64), and
// per warp two 16-edge buffers of bf16 edge rows and float32 partial rows
// (22 KB) with the ring: 8 warps a block at matgl's widths (225 KB), one
// block an SM.

constexpr int kTcEdges = 16;            // edges a tile: one m16
constexpr int kTcWarps = 8;             // warps a block at most
constexpr int kTcRing = kTcEdges + 32;  // a tile's leftovers plus one screened batch
constexpr int kTcKS1 = kMaxWidth / 16;  // the most k16 steps of layer 1 (C)
constexpr int kTcHT = kMaxWidth / 16;   // the most k16 steps of layer 2 (H)
constexpr int kTcCT = kMaxWidth / 8;    // the most n8 tiles of a layer-2 half (C)

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The bf16 kernels' arguments: Args with bf16 per-edge rows and output, and
// the bf16 transposed weights.
struct TcArgs {
  Table staged;                 // src: staged through shared memory with cp.async
  Table direct[2];              // dst (and the line conv's center): read directly
  const __nv_bfloat16* edge;    // (E, C) the per-edge segment
  const __nv_bfloat16* abw;     // (E, C) per-edge multiplier, or null
  const __nv_bfloat16* w1e;     // (32 ht, 16 ks1) W1e^T: core units, then gate units
  const __nv_bfloat16* w2;      // (16 ct, 16 ht) W2^T: core channels, then gate channels
  const float* b2;              // (2cp) [b2c | b2g]
  const int64_t* row_ptr;       // (n_rows + 1)
  const int32_t* seg_ids;       // (E) dst row of each edge
  const uint8_t* mask;          // (E) or null
  __nv_bfloat16* out;           // (n_rows, C)
  int64_t n_rows;
  int channels;
  int hidden;
};

// The bf16 kernels' widths and shared-memory layout (4-byte words, every
// region 16-byte aligned) at C channels and H hidden units. KS1, HT, CT:
// the k16 steps of C and of H and the n8 tiles of C as constants (4, 4, 8
// at matgl's C = H = 64), or 0 for the launch's.
template <int KS1 = 0, int HT = 0, int CT = 0>
struct TcLayout {
  int ks1_, ht_, ct_, hp_, warps;
  __host__ __device__ TcLayout(int c, int h, int nw)
      : ks1_((c + 15) / 16), ht_((h + 15) / 16), ct_((c + 7) / 8), hp_(round4(h)), warps(nw) {}
  __host__ __device__ int ks1() const { return KS1 > 0 ? KS1 : ks1_; }
  __host__ __device__ int ht() const { return HT > 0 ? HT : ht_; }
  __host__ __device__ int ct() const { return CT > 0 ? CT : ct_; }
  // the tables' half width (H rounded up to 4)
  __host__ __device__ int hp() const { return HT > 0 ? 16 * HT : hp_; }
  // bf16 row strides of the edge rows and W1e^T, and of W2^T: 8 values
  // past whole k16 steps
  __host__ __device__ int xs() const { return 16 * ks1() + 8; }
  __host__ __device__ int w2s() const { return 16 * ht() + 8; }
  // float row strides of the staged src partial rows (2hp used) and of the
  // message tile (8 ct used): 8 mod 32
  __host__ __device__ int ps() const { return round_up(2 * hp(), 32) + 8; }
  __host__ __device__ int ms() const { return round_up(8 * ct(), 32) + 8; }
  __host__ __device__ int o_w2() const { return 16 * ht() * xs(); }         // after W1e^T
  __host__ __device__ int o_b2() const { return o_w2() + 8 * ct() * w2s(); }  // after W2^T
  __host__ __device__ int o_warp() const { return round4(o_b2() + 16 * ct()); }
  // one tile buffer: the edge rows (16 x xs bf16), then the partial rows,
  // over which the message tile is written
  __host__ __device__ int slot() const { return 8 * xs() + kTcEdges * imax(ps(), ms()); }
  // two tile buffers, the ring (edge, row, src, dst, center) and each
  // buffer's tile metadata (edge, row, dst, center)
  __host__ __device__ int per_warp() const {
    return round4(2 * slot() + 5 * kTcRing + 2 * 4 * kTcEdges);
  }
  __host__ __device__ int bytes() const { return 4 * (o_warp() + warps * per_warp()); }
};

// The warp's own region of shared memory.
struct TcWarpMem {
  float* buf;  // two tile buffers of slot() words
  int* ring;   // ring_e, ring_r, ring_s, ring_d0, ring_d1: kTcRing each
  int* meta;   // per buffer: edge, row, dst, center: kTcEdges each
  template <class L>
  __device__ __nv_bfloat16* edges(const L& l, int s) const {
    return reinterpret_cast<__nv_bfloat16*>(buf + s * l.slot());
  }
  template <class L>
  __device__ float* rows(const L& l, int s) const {
    return buf + s * l.slot() + 8 * l.xs();
  }
  __device__ int* tile(int s, int field) const { return meta + (s * 4 + field) * kTcEdges; }
};

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&a)[2], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(a[0]), "=r"(a[1])
               : "r"(s)
               : "memory");
}

// silu and sigmoid through tanh.approx.f32, one MUFU operation each (the
// exact expf and division take two and hold the kernel): sigmoid(z) = 1/2 +
// tanh(z / 2) / 2 and silu(z) = z sigmoid(z) = h + h tanh(h), h = z / 2.
// tanh.approx's absolute error (at most 2^-10.987 by the PTX ISA,
// edge_aggregate.TANH_ERR) enters chgnet_tensor_core_error_bound as a term
// of its own.
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float silu_tc(float z) {
  const float h = 0.5f * z;
  return fmaf(h, tanh_approx(h), h);
}
__device__ __forceinline__ float sigmoid_tc(float z) {
  return fmaf(0.5f, tanh_approx(0.5f * z), 0.5f);
}

// two fp32 values rounded once to bf16, packed as an mma operand register
// (lo at the lower index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fill the ring until it holds a tile (or the range is screened), move the
// next tile into buffer s, start its copies and return its edge count.
template <int NDIR, bool VEC, class L>
__device__ int tc_take_tile(const TcArgs& a, const L& lay, const TcWarpMem& m, int s,
                            Screen& sc, int lane) {
  int* ring_e = m.ring;
  int* ring_r = ring_e + kTcRing;
  int* ring_s = ring_r + kTcRing;
  int* ring_d0 = ring_s + kTcRing;
  int* ring_d1 = ring_d0 + kTcRing;
  __syncwarp();  // every lane is done with the ring entries of the last tile
  while (sc.count < kTcEdges && sc.cand < sc.e_end) {
    const unsigned ballot = __ballot_sync(0xffffffffu, sc.ok);
    if (sc.ok) {
      const int pos = (sc.head + sc.count + __popc(ballot & ((1u << lane) - 1u))) % kTcRing;
      ring_e[pos] = static_cast<int>(sc.cand + lane);
      ring_r[pos] = sc.row;
      ring_s[pos] = sc.src;
      ring_d0[pos] = sc.d0;
      ring_d1[pos] = sc.d1;
    }
    sc.count += __popc(ballot);
    sc.cand += 32;
    prefetch_batch<NDIR>(a, sc, lane);  // lands while the tile computes
  }
  __syncwarp();
  const int n = sc.count < kTcEdges ? sc.count : kTcEdges;
  if (lane < n) {
    const int pos = (sc.head + lane) % kTcRing;
    m.tile(s, 0)[lane] = ring_e[pos];
    m.tile(s, 1)[lane] = ring_r[pos];
    m.tile(s, 2)[lane] = ring_d0[pos];
    m.tile(s, 3)[lane] = ring_d1[pos];
  }
  // the src partial rows (2hp floats, 16-byte chunks)
  float* ps = m.rows(lay, s);
  const int qp = lay.hp() / 2;
  for (int t = lane; t < n * qp; t += 32) {
    const int i = t / qp, q = t - i * qp;
    const int64_t r = ring_s[(sc.head + i) % kTcRing];
    cp_async16(ps + i * lay.ps() + 4 * q, a.staged.base + r * a.staged.stride + 4 * q);
  }
  // the bf16 edge rows; the columns from C to whole k16 steps stay zero
  __nv_bfloat16* x = m.edges(lay, s);
  const int C = a.channels;
  if (VEC) {  // C % 8 == 0 and 16-byte aligned rows: 8 values a copy
    const int qx = C / 8;
    for (int t = lane; t < n * qx; t += 32) {
      const int i = t / qx, q = t - i * qx;
      const int64_t e = ring_e[(sc.head + i) % kTcRing];
      cp_async16(x + i * lay.xs() + 8 * q, a.edge + e * C + 8 * q);
    }
  } else {  // plain loads (a cp.async copies 4 bytes at least)
    for (int t = lane; t < n * C; t += 32) {
      const int i = t / C, c = t - i * C;
      const int64_t e = ring_e[(sc.head + i) % kTcRing];
      x[i * lay.xs() + c] = a.edge[e * C + c];
    }
  }
  cp_async_commit();
  sc.head = (sc.head + n) % kTcRing;
  sc.count -= n;
  return n;
}

// flush the running sums into row `cur` (rounded once to bf16) and move on
__device__ __forceinline__ void tc_flush_row(const TcArgs& a, int64_t& cur, float (&acc_row)[2],
                                             int lane) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int c = lane + 32 * g;
    if (c < a.channels) a.out[cur * a.channels + c] = __float2bfloat16_rn(acc_row[g]);
    acc_row[g] = 0.0f;
  }
  ++cur;
}

// Layer 1's accumulators of the tile in buffer s (n edges) from its
// directly read partial rows, the dst row's (+ the center's): acc[h][j] is
// n8 tile j of the core (h 0) or the gate (h 1), zero past the rows and
// columns. Called a tile ahead, at the end of the one before, so that the
// loads land while the walk takes the next tile.
template <int NDIR, class L>
__device__ __forceinline__ void tc_direct_rows(const TcArgs& a, const L& lay, const TcWarpMem& m,
                                               int s, int n, int lane,
                                               float (&acc)[2][2 * kTcHT][4]) {
  const int g = lane >> 2, q = lane & 3;
  const bool v0 = g < n, v1 = g + 8 < n;
  const int ht = lay.ht(), hp = lay.hp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 2 * kTcHT; ++j) acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.0f;
  }
#pragma unroll
  for (int d = 0; d < NDIR; ++d) {
    const int* ti = m.tile(s, 2 + d);
    const float* r0 = a.direct[d].base + static_cast<int64_t>(v0 ? ti[g] : 0) * a.direct[d].stride;
    const float* r1 =
        a.direct[d].base + static_cast<int64_t>(v1 ? ti[g + 8] : 0) * a.direct[d].stride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 2 * kTcHT; ++j) {
        const int col = h * hp + 8 * j + 2 * q;
        if (j >= 2 * ht || 8 * j + 2 * q >= hp) continue;
        if (v0) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(r0 + col));
          acc[h][j][0] += v.x;
          acc[h][j][1] += v.y;
        }
        if (v1) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(r1 + col));
          acc[h][j][2] += v.x;
          acc[h][j][3] += v.y;
        }
      }
    }
  }
}

// One tile of n <= 16 edges whose staged rows are in buffer s (steps 1-5 of
// the note above), acc holding its direct rows' sums (tc_direct_rows); at
// its end acc takes the next tile's (buffer s ^ 1, n_next edges). w1t, w2t,
// b2s: the block's resident weights.
template <int NDIR, bool VEC, class L>
__device__ __forceinline__ void tc_run_tile(const TcArgs& a, const L& lay, const __nv_bfloat16* w1t,
                            const __nv_bfloat16* w2t, const float* b2s, const TcWarpMem& m, int s,
                            int n, int n_next, int lane, int64_t& cur, float (&acc_row)[2],
                            float (&acc)[2][2 * kTcHT][4]) {
  const int g = lane >> 2, q = lane & 3;
  const bool v0 = g < n, v1 = g + 8 < n;  // the lane's two rows hold edges
  const int C = a.channels;
  const int ht = lay.ht(), ct = lay.ct(), hp = lay.hp();
  const int* te = m.tile(s, 0);
  const int* tr = m.tile(s, 1);
  const __nv_bfloat16* x = m.edges(lay, s);
  float* rows = m.rows(lay, s);

  // abw at the lane's rows and columns, in flight during both layers
  __nv_bfloat162 ab[kTcCT][2];
  const __nv_bfloat16 one = __float2bfloat16_rn(1.0f);
#pragma unroll
  for (int j = 0; j < kTcCT; ++j) {
    ab[j][0] = ab[j][1] = __halves2bfloat162(one, one);
    const int col = 8 * j + 2 * q;
    if (a.abw == nullptr || j >= ct || col >= C) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!(r ? v1 : v0)) continue;
      const __nv_bfloat16* p = a.abw + static_cast<int64_t>(te[g + 8 * r]) * C + col;
      if (VEC) {
        ab[j][r] = __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
      } else {
        ab[j][r] = __halves2bfloat162(__ldg(p), col + 1 < C ? __ldg(p + 1) : one);
      }
    }
  }

  // 1. layer 1's accumulators: the direct rows' sums (loaded a tile ahead)
  //    plus the staged src partial rows, which carry the layer-1 bias
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 2 * kTcHT; ++j) {
      const int col = 8 * j + 2 * q;
      if (j >= 2 * ht || col >= hp) continue;
      const float* p = rows + h * hp + col;
      if (v0) {
        const float2 v = *reinterpret_cast<const float2*>(p + g * lay.ps());
        acc[h][j][0] += v.x;
        acc[h][j][1] += v.y;
      }
      if (v1) {
        const float2 v = *reinterpret_cast<const float2*>(p + (g + 8) * lay.ps());
        acc[h][j][2] += v.x;
        acc[h][j][3] += v.y;
      }
    }
  }

  // 2. + e W1e on the tensor cores
#pragma unroll
  for (int k = 0; k < kTcKS1; ++k) {
    if (k >= lay.ks1()) continue;
    uint32_t af[4];
    ldmatrix_x4(af, x + (lane & 15) * lay.xs() + 16 * k + 8 * (lane >> 4));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 2 * kTcHT; j += 2) {
        if (j >= 2 * ht) continue;
        uint32_t bf[4];
        ldmatrix_x4(bf, w1t + (16 * ht * h + 8 * j + (lane & 7) + 8 * (lane >> 4)) * lay.xs() +
                            16 * k + 8 * ((lane >> 3) & 1));
        const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
        mma_bf16(acc[h][j], af, b0);
        mma_bf16(acc[h][j + 1], af, b1);
      }
    }
  }

  // 3. silu in fp32, one rounding to bf16: layer 2's A fragments
  uint32_t hf[2][kTcHT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int t = 0; t < kTcHT; ++t) {
      hf[h][t][0] = hf[h][t][1] = hf[h][t][2] = hf[h][t][3] = 0u;
      if (t >= ht) continue;
      hf[h][t][0] = pack_bf16(silu_tc(acc[h][2 * t][0]), silu_tc(acc[h][2 * t][1]));
      hf[h][t][1] = pack_bf16(silu_tc(acc[h][2 * t][2]), silu_tc(acc[h][2 * t][3]));
      hf[h][t][2] = pack_bf16(silu_tc(acc[h][2 * t + 1][0]), silu_tc(acc[h][2 * t + 1][1]));
      hf[h][t][3] = pack_bf16(silu_tc(acc[h][2 * t + 1][2]), silu_tc(acc[h][2 * t + 1][3]));
    }
  }

  // 4. layer 2 from b2: o[h][j] is n8 tile j of the core (h 0) or gate (h 1)
  //    output channels
  float o[2][kTcCT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < kTcCT; ++j) {
      const float2 b = j < ct ? *reinterpret_cast<const float2*>(b2s + 8 * ct * h + 8 * j + 2 * q)
                              : make_float2(0.0f, 0.0f);
      o[h][j][0] = o[h][j][2] = b.x;
      o[h][j][1] = o[h][j][3] = b.y;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int t = 0; t < kTcHT; ++t) {
      if (t >= ht) continue;
#pragma unroll
      for (int j = 0; j < kTcCT; j += 2) {
        if (j >= ct) continue;
        const __nv_bfloat16* p = w2t + (8 * ct * h + 8 * j + (lane & 7)) * lay.w2s() + 16 * t +
                                 8 * ((lane >> 3) & 1);
        if (j + 1 < ct) {  // two n8 tiles: rows 8 on at lanes 16-31
          uint32_t bf[4];
          ldmatrix_x4(bf, p + 8 * (lane >> 4) * lay.w2s());
          const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
          mma_bf16(o[h][j], hf[h][t], b0);
          mma_bf16(o[h][j + 1], hf[h][t], b1);
        } else {  // the last of an odd count
          uint32_t b0[2];
          ldmatrix_x2(b0, p);
          mma_bf16(o[h][j], hf[h][t], b0);
        }
      }
    }
  }

  // 5. the message silu(core) sigmoid(gate) abw in fp32, into the tile's
  //    rows (every lane is done reading the partial rows), then the
  //    segmented sum in edge order
  __syncwarp();
  float* msg = rows;
#pragma unroll
  for (int j = 0; j < kTcCT; ++j) {
    if (j >= ct) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 w = __bfloat1622float2(ab[j][r]);
      const float m0 = silu_tc(o[0][j][2 * r]) * sigmoid_tc(o[1][j][2 * r]) * w.x;
      const float m1 = silu_tc(o[0][j][2 * r + 1]) * sigmoid_tc(o[1][j][2 * r + 1]) * w.y;
      *reinterpret_cast<float2*>(msg + (g + 8 * r) * lay.ms() + 8 * j + 2 * q) =
          make_float2(m0, m1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kTcEdges; ++i) {
    if (i < n) {
      const int64_t r = tr[i];
      while (cur < r) tc_flush_row(a, cur, acc_row, lane);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = lane + 32 * k;
        if (c < C) acc_row[k] += msg[i * lay.ms() + c];
      }
    }
  }
  tc_direct_rows<NDIR>(a, lay, m, s ^ 1, n_next, lane, acc);
}

template <int NDIR, bool VEC, int KS1, int HT, int CT>
__device__ __forceinline__ void gated_aggregate_tc(const TcArgs& a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nw = blockDim.x >> 5;
  const TcLayout<KS1, HT, CT> lay(a.channels, a.hidden, nw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __nv_bfloat16* w1t = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w2t = reinterpret_cast<__nv_bfloat16*>(smem + lay.o_w2());
  float* b2s = smem + lay.o_b2();

  // the weights, packed and zero-padded by the wrapper: W1e^T (32 ht rows of
  // 16 ks1 values) and W2^T (16 ct rows of 16 ht) by 16-byte copies into the
  // padded rows; b2 as [core | gate] halves of 8 ct, zeros past C
  const int q1 = 2 * lay.ks1(), q2 = 2 * lay.ht();
  for (int i = tid; i < 32 * lay.ht() * q1; i += blockDim.x) {
    const int r = i / q1, c = i - r * q1;
    *reinterpret_cast<uint4*>(w1t + r * lay.xs() + 8 * c) =
        __ldg(reinterpret_cast<const uint4*>(a.w1e) + i);
  }
  for (int i = tid; i < 16 * lay.ct() * q2; i += blockDim.x) {
    const int r = i / q2, c = i - r * q2;
    *reinterpret_cast<uint4*>(w2t + r * lay.w2s() + 8 * c) =
        __ldg(reinterpret_cast<const uint4*>(a.w2) + i);
  }
  const int cp = round4(a.channels);
  for (int i = tid; i < 16 * lay.ct(); i += blockDim.x) {
    const int h = i / (8 * lay.ct()), c = i - h * 8 * lay.ct();
    b2s[i] = c < a.channels ? __ldg(a.b2 + h * cp + c) : 0.0f;
  }

  TcWarpMem m;
  m.buf = smem + lay.o_warp() + warp * lay.per_warp();
  m.ring = reinterpret_cast<int*>(m.buf + 2 * lay.slot());
  m.meta = m.ring + 5 * kTcRing;
  // both buffers' edge rows zeroed: the columns past C, which no copy
  // writes, read as zeros
  for (int s = 0; s < 2; ++s) {
    uint4* x = reinterpret_cast<uint4*>(m.edges(lay, s));
    for (int i = lane; i < kTcEdges * lay.xs() / 8; i += 32) x[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // this warp's rows [ra, rb): equal shares of candidate edges + kRowCost per row
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * nw;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * nw + warp;
  const int64_t total = a.row_ptr[a.n_rows] + kRowCost * a.n_rows;
  const int64_t ra = w == 0 ? 0 : find_row(a.row_ptr, a.n_rows, w * total / n_warps, lane);
  const int64_t rb = w + 1 == n_warps ? a.n_rows
                                      : find_row(a.row_ptr, a.n_rows, (w + 1) * total / n_warps, lane);
  if (ra >= rb) return;
  Screen sc{};
  sc.cand = a.row_ptr[ra];
  sc.e_end = a.row_ptr[rb];
  prefetch_batch<NDIR>(a, sc, lane);

  int64_t cur = ra;                 // the row the walk is in
  float acc_row[2] = {0.0f, 0.0f};  // its running sums of channels lane, lane + 32
  int s = 0;
  int n = tc_take_tile<NDIR, VEC>(a, lay, m, s, sc, lane);
  float acc[2][2 * kTcHT][4];  // layer 1's accumulators, begun a tile ahead
  __syncwarp();
  tc_direct_rows<NDIR>(a, lay, m, s, n, lane, acc);
  while (n > 0) {
    // the next tile's rows fly while this one computes
    const int n_next = tc_take_tile<NDIR, VEC>(a, lay, m, s ^ 1, sc, lane);
    cp_async_wait<1>();
    __syncwarp();
    tc_run_tile<NDIR, VEC>(a, lay, w1t, w2t, b2s, m, s, n, n_next, lane, cur, acc_row, acc);
    __syncwarp();
    s ^= 1;
    n = n_next;
  }
  cp_async_wait<0>();
  while (cur < rb) tc_flush_row(a, cur, acc_row, lane);
}

// VEC: C % 8 == 0 and 16-byte aligned edge (and abw) rows: 16-byte copies
// and pair loads. KS1, HT, CT: the widths as constants (4, 4, 8: matgl's C
// = H = 64), or 0 for any.
template <bool VEC, int KS1, int HT, int CT>
__global__ void __launch_bounds__(32 * kTcWarps, 1) chgnet_atom_conv_bf16_kernel(const TcArgs a) {
  gated_aggregate_tc<1, VEC, KS1, HT, CT>(a);
}

template <bool VEC, int KS1, int HT, int CT>
__global__ void __launch_bounds__(32 * kTcWarps, 1) chgnet_line_conv_bf16_kernel(const TcArgs a) {
  gated_aggregate_tc<2, VEC, KS1, HT, CT>(a);
}

// The bf16 kernels' launch plan: warps a block (as many as shared memory
// holds, at most kTcWarps), blocks (one an SM, fewer for small inputs: ~256
// candidates a warp) and shared bytes a block.
struct TcPlan {
  int warps, blocks, bytes;
};

cudaError_t tc_plan(int channels, int hidden, int64_t n_rows, int64_t n_edges, TcPlan* p) {
  p->warps = 0;
  if (channels < 1 || hidden < 1 || channels > kMaxWidth || hidden > kMaxWidth ||
      n_edges >= 2147483647LL)
    return cudaErrorInvalidValue;
  for (int nw = kTcWarps; nw >= 1 && p->warps == 0; --nw) {
    if (TcLayout<>(channels, hidden, nw).bytes() <= kSmemLimit) p->warps = nw;
  }
  if (p->warps == 0) return cudaErrorInvalidValue;
  p->bytes = TcLayout<>(channels, hidden, p->warps).bytes();
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t want = (n_edges + n_rows * kRowCost + 256LL * p->warps - 1) / (256LL * p->warps);
  p->blocks = static_cast<int>(want < sms ? (want > 0 ? want : 1) : sms);
  return cudaSuccess;
}

template <int NDIR>
int tc_launch(const TcArgs& a, int64_t n_edges, void* stream) {
  if (a.n_rows <= 0 || a.channels <= 0) return 0;
  TcPlan p{};
  cudaError_t err = tc_plan(a.channels, a.hidden, a.n_rows, n_edges, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  if (!aligned(a.w1e) || !aligned(a.w2)) return static_cast<int>(cudaErrorMisalignedAddress);
  const bool vec = a.channels % 8 == 0 && aligned(a.edge) && (a.abw == nullptr || aligned(a.abw));
  const bool matgl = vec && a.channels == 64 && a.hidden == 64;
  auto kernel = NDIR == 1 ? (matgl ? chgnet_atom_conv_bf16_kernel<true, 4, 4, 8>
                             : vec ? chgnet_atom_conv_bf16_kernel<true, 0, 0, 0>
                                   : chgnet_atom_conv_bf16_kernel<false, 0, 0, 0>)
                          : (matgl ? chgnet_line_conv_bf16_kernel<true, 4, 4, 8>
                             : vec ? chgnet_line_conv_bf16_kernel<true, 0, 0, 0>
                                   : chgnet_line_conv_bf16_kernel<false, 0, 0, 0>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(p.blocks), 32 * p.warps, p.bytes,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The per-edge kernels' arguments: A is Args (float32 data, float32 packed
// weights) or TcArgs (bf16 data, bf16 transposed weights).
template <class A, typename T, typename W>
A conv_args(const float* p_src, int64_t src_stride, const int32_t* src, const float* p_dst,
            int64_t dst_stride, const int32_t* dst, const float* p_ctr, int64_t ctr_stride,
            const int32_t* ctr, const T* edge, const T* abw, const W* w1e, const W* w2,
            const float* b2, const int64_t* row_ptr, const int32_t* seg_ids,
            const uint8_t* mask, T* out, int64_t n_rows, int channels, int hidden) {
  A a{};
  a.staged = {p_src, src, src_stride};
  a.direct[0] = {p_dst, dst, dst_stride};
  a.direct[1] = {p_ctr, ctr, ctr_stride};
  a.edge = edge; a.abw = abw;
  a.w1e = w1e; a.w2 = w2; a.b2 = b2;
  a.row_ptr = row_ptr; a.seg_ids = seg_ids; a.mask = mask; a.out = out;
  a.n_rows = n_rows; a.channels = channels; a.hidden = hidden;
  return a;
}

}  // namespace

// The bf16 per-edge kernels' launch plan at (C, H, n_rows, n_edges) on the
// current device: out[0] warps a block, out[1] blocks, out[2] shared bytes a
// block. Returns a cudaError_t (0 = success).
extern "C" int distmlip_chgnet_aggregate_bf16_plan(int channels, int hidden, int64_t n_rows,
                                                   int64_t n_edges, int64_t* out) {
  TcPlan plan{};
  const cudaError_t err = tc_plan(channels, hidden, n_rows, n_edges, &plan);
  out[0] = plan.warps;
  out[1] = plan.blocks;
  out[2] = plan.bytes;
  return static_cast<int>(err);
}

// Row projection. x (rows, k) float32 contiguous, 1 <= k <= 64; w (k, m)
// with m % 4 == 0 and m <= 256; bias (m) or null; y (rows, m). 16-byte
// aligned w, bias and y; x too when k % 4 == 0 (else the 4-byte copies).
// The launch chooses the tile height (proj_plan). Launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t (0 = success); cudaErrorInvalidValue for a shape it does not
// take.
extern "C" int distmlip_chgnet_row_projection_f32(const float* x, int64_t rows, int k_dim,
                                                  const float* w, int m, const float* bias,
                                                  float* y, void* stream) {
  return proj_launch(x, rows, k_dim, w, m, bias, y, stream);
}

// The same at bf16 rows on the tensor cores: x (rows, k) and w (k, m)
// bfloat16 contiguous, 1 <= k <= 64, m % 4 == 0 and m <= 256; bias (m)
// float32 or null; y (rows, m) float32, 16-byte aligned; x 16-byte aligned
// and k % 8 == 0 take the 16-byte copies, anything else plain loads. As
// distmlip_chgnet_row_projection_f32 otherwise.
extern "C" int distmlip_chgnet_row_projection_bf16(const __nv_bfloat16* x, int64_t rows,
                                                   int k_dim, const __nv_bfloat16* w, int m,
                                                   const float* bias, float* y, void* stream) {
  if (reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  QPlan plan{};
  const QArgs a{x, rows, k_dim, w, m, bias, y,
                k_dim % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0};
  return static_cast<int>(qlaunch(a, &plan, static_cast<cudaStream_t>(stream)));
}

// The bf16 projection's launch plan at (rows, k, m) on the current device:
// out[0] rows a tile, out[1] tiles, out[2] blocks of the persistent grid,
// out[3] k16 steps, out[4] columns a block. Returns a cudaError_t.
extern "C" int distmlip_chgnet_row_projection_bf16_plan(int64_t rows, int k_dim, int m,
                                                        int64_t* out) {
  QPlan plan{};
  const QArgs a{nullptr, rows, k_dim, nullptr, m, nullptr, nullptr, k_dim % 8 == 0};
  const cudaError_t err = qlaunch(a, &plan, nullptr);
  out[0] = plan.tile_rows;
  out[1] = plan.tiles;
  out[2] = plan.blocks;
  out[3] = plan.ks;
  out[4] = plan.mt;
  return static_cast<int>(err);
}

// The row projection's launch plan at (rows, k, m) on the current device:
// out[0] rows a tile, out[1] tiles, out[2] blocks of the persistent grid,
// out[3] rows per thread. Returns a cudaError_t (0 = success).
extern "C" int distmlip_chgnet_row_projection_plan(int64_t rows, int k_dim, int m,
                                                   int64_t* out) {
  cudaError_t err = proj_check(rows, k_dim, m);
  if (err != cudaSuccess) return static_cast<int>(err);
  ProjPlan plan{};
  err = proj_plan(rows, m, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ProjArgs<float> a{nullptr, rows, k_dim, nullptr, m, nullptr, nullptr, k_dim % 4 == 0};
  err = proj_dispatch(a, &plan, nullptr);
  out[0] = plan.tile_rows;
  out[1] = plan.tiles;
  out[2] = plan.blocks;
  out[3] = plan.rt;
  return static_cast<int>(err);
}

// Atom conv. p_src: the src segment's partial rows (row stride src_stride
// floats, 2hp used) gathered at src (E) int32, layer-1 bias folded in;
// p_dst the same for dst; edge (E, C); abw (E, C) or null; w1e (cp, 2hp),
// w2 (hp, 2cp), b2 (2cp) packed as by kernels.edge_aggregate's
// chgnet_pack_weights; row_ptr (n_rows + 1) int64; seg_ids (E) int32; mask
// (E) bytes or null; out (n_rows, C). float32, 16-byte aligned tables and
// packed weights, on the current device. Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t (0 = success).
extern "C" int distmlip_chgnet_atom_conv_f32(
    const float* p_src, int64_t src_stride, const int32_t* src, const float* p_dst,
    int64_t dst_stride, const int32_t* dst, const float* edge, const float* abw,
    const float* w1e, const float* w2, const float* b2, const int64_t* row_ptr,
    const int32_t* seg_ids, const uint8_t* mask, float* out, int64_t n_rows,
    int64_t n_edges, int channels, int hidden, void* stream) {
  return launch<1>(conv_args<Args>(p_src, src_stride, src, p_dst, dst_stride, dst, p_dst,
                                   dst_stride, dst, edge, abw, w1e, w2, b2, row_ptr, seg_ids,
                                   mask, out, n_rows, channels, hidden),
                   n_edges, stream);
}

// The same at bf16 data on the tensor cores: edge, abw and out bfloat16;
// the tables and b2 float32; w1e_t (32 ht, 16 ks1) and w2_t (16 ct, 16 ht)
// bfloat16, W1e^T and W2^T packed by chgnet_pack_weights (ks1, ht: C and H
// in whole k16 steps, ct: C in whole n8 tiles), 16-byte aligned.
extern "C" int distmlip_chgnet_atom_conv_bf16(
    const float* p_src, int64_t src_stride, const int32_t* src, const float* p_dst,
    int64_t dst_stride, const int32_t* dst, const __nv_bfloat16* edge,
    const __nv_bfloat16* abw, const __nv_bfloat16* w1e_t, const __nv_bfloat16* w2_t,
    const float* b2, const int64_t* row_ptr, const int32_t* seg_ids, const uint8_t* mask,
    __nv_bfloat16* out, int64_t n_rows, int64_t n_edges, int channels, int hidden,
    void* stream) {
  return tc_launch<1>(conv_args<TcArgs>(p_src, src_stride, src, p_dst, dst_stride, dst, p_dst,
                                        dst_stride, dst, edge, abw, w1e_t, w2_t, b2, row_ptr,
                                        seg_ids, mask, out, n_rows, channels, hidden),
                      n_edges, stream);
}

// Line conv. p_src, p_dst: the bond segments' partial rows gathered at
// line_src, line_dst (L) int32, layer-1 bias folded into p_src; angle (L,
// C); p_ctr the center atoms' partial rows gathered at center (L); w1e, w2,
// b2 packed; row_ptr (n_rows + 1) int64; seg_ids (L) int32; mask (L) bytes
// or null; out (n_rows, C). As the atom conv otherwise.
extern "C" int distmlip_chgnet_line_conv_f32(
    const float* p_src, int64_t src_stride, const int32_t* line_src, const float* p_dst,
    int64_t dst_stride, const int32_t* line_dst, const float* angle, const float* p_ctr,
    int64_t ctr_stride, const int32_t* center, const float* w1e, const float* w2,
    const float* b2, const int64_t* row_ptr, const int32_t* seg_ids, const uint8_t* mask,
    float* out, int64_t n_rows, int64_t n_edges, int channels, int hidden, void* stream) {
  return launch<2>(conv_args<Args>(p_src, src_stride, line_src, p_dst, dst_stride, line_dst,
                                   p_ctr, ctr_stride, center, angle,
                                   static_cast<const float*>(nullptr), w1e, w2, b2, row_ptr,
                                   seg_ids, mask, out, n_rows, channels, hidden),
                   n_edges, stream);
}

// The same at bf16 data on the tensor cores: angle and out bfloat16, w1e_t
// and w2_t as the bf16 atom conv takes them.
extern "C" int distmlip_chgnet_line_conv_bf16(
    const float* p_src, int64_t src_stride, const int32_t* line_src, const float* p_dst,
    int64_t dst_stride, const int32_t* line_dst, const __nv_bfloat16* angle,
    const float* p_ctr, int64_t ctr_stride, const int32_t* center,
    const __nv_bfloat16* w1e_t, const __nv_bfloat16* w2_t, const float* b2,
    const int64_t* row_ptr, const int32_t* seg_ids, const uint8_t* mask, __nv_bfloat16* out,
    int64_t n_rows, int64_t n_edges, int channels, int hidden, void* stream) {
  return tc_launch<2>(conv_args<TcArgs>(p_src, src_stride, line_src, p_dst, dst_stride,
                                        line_dst, p_ctr, ctr_stride, center, angle,
                                        static_cast<const __nv_bfloat16*>(nullptr), w1e_t, w2_t,
                                        b2, row_ptr, seg_ids, mask, out, n_rows, channels,
                                        hidden),
                      n_edges, stream);
}
