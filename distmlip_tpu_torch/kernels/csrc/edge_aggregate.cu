// TensorNet's two edge aggregations, per-edge message built in registers
// and summed onto dst-sorted rows, and the interaction's backward. float32 or
// bfloat16 in and out, float32 arithmetic, sm_90a.
//
// Replaces distmlip_tpu/kernels/segment.py::pallas_edge_aggregate (body
// _edge_aggregate_kernel, in-kernel gather _gather_rows) at TensorNet's two
// call sites (distmlip_tpu/models/tensornet.py:178 and :232), and, for the
// interaction, the JAX custom VJP's chunked recompute around it
// (distmlip_tpu/kernels/dispatch.py:482 _edge_aggregate_bwd). The TPU kernel
// takes any traced edge_fn, owns a tile of 128 dst rows per grid step,
// builds a (256, width) message block in VMEM and scatters it with a one-hot
// MXU matmul. A CUDA kernel cannot take a Python edge_fn, so each message has
// its own kernel here, and the one-hot scatter becomes a ragged reduction
// over CSR row offsets (row_ptr, from the sorted dst ids, as in
// segment_sum.cu):
//
//   embed:       out[n,i,j,c] = sum_e Z[e,c] * (W1[e,c] d_ij + W2[e,c] A_e[e,i,j]
//                                               + W3[e,c] S_e[e,i,j])
//   interaction: out[n,i,j,c] = sum_e f[e,c,0] I[src_e,i,j,c]
//                               + f[e,c,1] A[src_e,i,j,c] + f[e,c,2] S[src_e,i,j,c]
//
// with the sum over the valid edges e of dst row n. Layouts are the model's:
// channels last, (E, C) per-edge rows, (E, 3, 3) geometric scalars, f in
// torchmd-net's (E, C, 3) order (read at stride 3), out (N, 3, 3, C) with a
// row of 9 C contiguous floats. The interaction's I, A and S come as compact
// rows (see below): the TPU's (8, 128) tile made the full 3x3 free, but here
// every gathered float is L2 traffic.
//
// Design (the float32 kernels; the bf16 ones below). One thread owns one (dst row,
// channel) and the matrix entries of it, accumulated in registers in edge
// order: no atomics, deterministic.
// A block holds 256 / tpr rows of tpr threads (tpr = C rounded up to a warp,
// at most 256; 4 rows of 64 at TensorNet's C = 64); grid.y walks channel
// slabs when C > 256. Every load along the channel axis is coalesced: a warp
// reads 128 contiguous bytes of Z/W or of a gathered node row. The 18
// geometric scalars of an embed edge and the src index of an interaction
// edge are the same address for a whole warp (one broadcast load). The embed
// loads two edges before adding either, the interaction four and its
// backward two (kBwdInFlight), to keep more loads in flight. The
// interaction's node rows are gathered from global memory through L2 at
// every size: there is no staging budget, unlike the TPU's 2 MiB VMEM.
//
// What bounds it on an H100: HBM bytes, and for the gathers L2. Per valid
// edge the embed reads 4 C + 18 floats once; the interaction reads 3 C
// floats of f and gathers 10 C floats of compact rows (27 C with full 3x3
// arrays: 5.28 GB through L2 per call at 16384 atoms, ~9 TB/s at the old
// kernel's time, against 1.96 GB now), which come from L2 when the
// dst-sorted order keeps the src rows of neighbouring dst rows resident.
// The backward reads f and gathers 9 C floats of g per edge, and writes the
// 3 C floats of d f.
//
// Semantics (those of the plain versions in kernels/edge_aggregate.py):
//   - masked edges are screened by a branch (forward) or sorted past the
//     last src row (backward), never read and never added, so non-finite
//     padding cannot leak into a sum; their d f rows are written as zeros;
//   - every output row is written, empty rows as zeros;
//   - offsets are 64-bit; src ids of valid edges must lie in [0, N_node).
//
// bfloat16: each of the three has a kernel of its own (below the float32
// ones): a warp owns one (row, slab of 32 CPT channels), CPT = 2 (a channel
// pair a lane) where C is even and every array the lanes index by channel
// is 4-byte aligned, else 1; the row's edge indices come 32 at a time, loaded
// by the warp and passed by shuffles; several edges' rows are loaded before
// any is used. Every load converts to float32 in registers, the arithmetic
// and its order are the float32 kernels' (embed_add, interaction_add,
// backward_terms), the accumulators are float32, and each output element (a
// dst row's sum, a d f entry, a src row's d i, d a or d s sum over its
// src-sorted edges) is rounded to bfloat16 once (round to nearest even), so
// it equals the float32 kernel's on the upcast inputs rounded once, bit for
// bit. That is the TPU kernel's contract at bf16 data (VMEM blocks in the
// data's dtype, an fp32 accumulator, the output in the message's dtype:
// distmlip_tpu/kernels/segment.py:309-317) and, for the backward, the JAX
// dispatcher's fp32 node-cotangent carry rounded once
// (distmlip_tpu/kernels/dispatch.py:566-584). The byte bound halves on the
// float terms; index and mask bytes stay.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// storage <-> registers of the float32 kernels (templated on the storage
// type; the bf16 kernels below have their own loads)
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// thread -> (dst row, channel); false for the idle threads of the last block
// or of a partial channel slab
__device__ __forceinline__ bool thread_slot(int64_t n_rows, int channels,
                                            int tpr, int64_t& row, int& c) {
  const int rows_per_block = kThreads / tpr;
  row = static_cast<int64_t>(blockIdx.x) * rows_per_block + threadIdx.x / tpr;
  c = static_cast<int>(blockIdx.y) * tpr + static_cast<int>(threadIdx.x) % tpr;
  return row < n_rows && c < channels;
}

__device__ __forceinline__ bool valid_edge(const uint8_t* __restrict__ mask,
                                           int64_t e) {
  return mask == nullptr || mask[e] != 0;
}

template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ out, int64_t row,
                                          int channels, int c,
                                          const float (&acc)[9]) {
  T* __restrict__ dst = out + row * 9 * static_cast<int64_t>(channels) + c;
#pragma unroll
  for (int k = 0; k < 9; ++k) store(dst + static_cast<int64_t>(k) * channels, acc[k]);
}

// ---- embed --------------------------------------------------------------

struct EmbedEdge {
  float z, w1, w2, w3, a[9], s[9];
};

template <typename T>
__device__ __forceinline__ void embed_load(
    EmbedEdge& v, const T* __restrict__ z, const T* __restrict__ w1,
    const T* __restrict__ w2, const T* __restrict__ w3,
    const T* __restrict__ a_e, const T* __restrict__ s_e, int64_t e,
    int channels, int c) {
  const int64_t o = e * channels + c;
  v.z = load(z + o);
  v.w1 = load(w1 + o);
  v.w2 = load(w2 + o);
  v.w3 = load(w3 + o);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    v.a[k] = load(a_e + e * 9 + k);
    v.s[k] = load(s_e + e * 9 + k);
  }
}

__device__ __forceinline__ void embed_add(float (&acc)[9], const EmbedEdge& v) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;  // k = 3 i + j
    acc[k] += v.z * (v.w1 * eye + v.w2 * v.a[k] + v.w3 * v.s[k]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tensornet_embed_kernel(const T* __restrict__ z, const T* __restrict__ w1,
                       const T* __restrict__ w2, const T* __restrict__ w3,
                       const T* __restrict__ a_e, const T* __restrict__ s_e,
                       const int64_t* __restrict__ row_ptr,
                       const uint8_t* __restrict__ mask, T* __restrict__ out,
                       int64_t n_rows, int channels, int tpr) {
  int64_t row;
  int c;
  if (!thread_slot(n_rows, channels, tpr, row, c)) return;
  const int64_t e1 = row_ptr[row + 1];
  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.0f;

  int64_t e = row_ptr[row];
  for (; e + 2 <= e1; e += 2) {
    const bool m0 = valid_edge(mask, e);
    const bool m1 = valid_edge(mask, e + 1);
    EmbedEdge v0, v1;
    if (m0) embed_load(v0, z, w1, w2, w3, a_e, s_e, e, channels, c);
    if (m1) embed_load(v1, z, w1, w2, w3, a_e, s_e, e + 1, channels, c);
    if (m0) embed_add(acc, v0);
    if (m1) embed_add(acc, v1);
  }
  if (e < e1 && valid_edge(mask, e)) {
    EmbedEdge v;
    embed_load(v, z, w1, w2, w3, a_e, s_e, e, channels, c);
    embed_add(acc, v);
  }
  store_row(out, row, channels, c, acc);
}

// ---- interaction, forward ------------------------------------------------
//
// The node arrays come as compact rows (N_node, k, C): I as its trace / 3
// (k = 1), A as its entries (0,1), (0,2), (1,2) (k = 3), S as (0,0), (1,1),
// (2,2), (0,1), (0,2), (1,2) (k = 6): 10 C floats per src row instead of
// the 27 C of the three full 3x3 arrays. The sum is linear, so the thread
// sums the 10 gated components f0 i, f1 a, f2 s over its row's edges and
// assembles the 3x3 once at the end: diagonal i + s_pp, upper a_pq + s_pq,
// lower s_pq - a_pq.

constexpr int kInFlight = 4;  // edges whose loads are issued before any is added

struct InteractionEdge {
  float f[3], x[10];  // x: i, a01, a02, a12, s00, s11, s22, s01, s02, s12
};

template <typename T>
__device__ __forceinline__ void compact_load(float (&x)[10],
                                             const T* __restrict__ node_i,
                                             const T* __restrict__ node_a,
                                             const T* __restrict__ node_s,
                                             int64_t j, int channels, int c) {
  const int64_t ch = channels;
  x[0] = load(node_i + j * ch + c);
#pragma unroll
  for (int k = 0; k < 3; ++k) x[1 + k] = load(node_a + (j * 3 + k) * ch + c);
#pragma unroll
  for (int k = 0; k < 6; ++k) x[4 + k] = load(node_s + (j * 6 + k) * ch + c);
}

template <typename T>
__device__ __forceinline__ void interaction_load(
    InteractionEdge& v, const T* __restrict__ f,
    const T* __restrict__ node_i, const T* __restrict__ node_a,
    const T* __restrict__ node_s, const int32_t* __restrict__ src,
    int64_t e, int channels, int c) {
  const T* __restrict__ fe = f + e * 3 * channels + 3 * c;
  v.f[0] = load(fe);
  v.f[1] = load(fe + 1);
  v.f[2] = load(fe + 2);
  compact_load(v.x, node_i, node_a, node_s, __ldg(src + e), channels, c);
}

__device__ __forceinline__ void interaction_add(float (&acc)[10],
                                                const InteractionEdge& v) {
  acc[0] += v.f[0] * v.x[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) acc[k] += v.f[1] * v.x[k];
#pragma unroll
  for (int k = 4; k < 10; ++k) acc[k] += v.f[2] * v.x[k];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tensornet_interaction_kernel(const T* __restrict__ f,
                             const T* __restrict__ node_i,
                             const T* __restrict__ node_a,
                             const T* __restrict__ node_s,
                             const int32_t* __restrict__ src,
                             const int64_t* __restrict__ row_ptr,
                             const uint8_t* __restrict__ mask,
                             T* __restrict__ out, int64_t n_rows,
                             int channels, int tpr) {
  int64_t row;
  int c;
  if (!thread_slot(n_rows, channels, tpr, row, c)) return;
  const int64_t e1 = row_ptr[row + 1];
  float acc[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = 0.0f;

  int64_t e = row_ptr[row];
  for (; e + kInFlight <= e1; e += kInFlight) {
    bool m[kInFlight];
    InteractionEdge v[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      m[q] = valid_edge(mask, e + q);
      if (m[q]) interaction_load(v[q], f, node_i, node_a, node_s, src, e + q, channels, c);
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      if (m[q]) interaction_add(acc, v[q]);
    }
  }
  for (; e < e1; ++e) {
    if (!valid_edge(mask, e)) continue;
    InteractionEdge v;
    interaction_load(v, f, node_i, node_a, node_s, src, e, channels, c);
    interaction_add(acc, v);
  }
  // k = 3 i + j: diagonal i + s_pp, upper a_pq + s_pq, lower s_pq - a_pq
  const float full[9] = {acc[0] + acc[4], acc[1] + acc[7], acc[2] + acc[8],
                         acc[7] - acc[1], acc[0] + acc[5], acc[3] + acc[9],
                         acc[8] - acc[2], acc[9] - acc[3], acc[0] + acc[6]};
  store_row(out, row, channels, c, full);
}

// ---- interaction, backward ----------------------------------------------
//
// The cotangents of the forward above, from g = d out (n_dst, 3, 3, C):
// over the valid edges e with src_e = j,
//   d i[j]  += f0_e t,  t = g00 + g11 + g22,
//   d a[j]  += f1_e u,  u = (g01 - g10, g02 - g20, g12 - g21),
//   d s[j]  += f2_e v,  v = (g00, g11, g22, g01 + g10, g02 + g20, g12 + g21),
//   d f[e]   = (t i[j], u . a[j], v . s[j]),
// with g taken at dst_e, and d f zero on masked edges. The edges come sorted
// by src (perm, stable, so equal src keep edge order and the sums are
// deterministic; masked edges sorted past the last row), with CSR offsets
// row_ptr over the n_rows src rows. One thread owns one (src row, channel):
// it reads its row's x = (i, a, s) once, and for each edge gathers the 9
// floats of g[dst], projects them in registers, adds to d x and writes the
// edge's d f row; nothing of size (E, 9 C) is written. Blocks past the row
// grid write the zero d f rows of the masked edges.

// The float32 kernel: two edges in flight and at most 64 registers (four
// blocks per SM): the loads perm -> dst -> g depend on each other, so warps
// in flight matter more than edges in flight. On the H100 at the TensorNet
// path's graph this ran faster than four edges at 110 registers (two blocks
// per SM); deeper unrolls or a tighter register cap spilled or lost
// occupancy.
constexpr int kBwdInFlight = 2;
constexpr int kBwdMinBlocks = 4;

struct BackwardEdge {
  int64_t p;  // the edge's row in f and d f
  float f[3], g[9];
};

template <typename T>
__device__ __forceinline__ void backward_load(BackwardEdge& v,
                                              const T* __restrict__ g,
                                              const T* __restrict__ f,
                                              const int64_t* __restrict__ perm,
                                              const int32_t* __restrict__ dst,
                                              int64_t e, int channels, int c) {
  v.p = __ldg(perm + e);
  const T* __restrict__ fe = f + v.p * 3 * channels + 3 * c;
  v.f[0] = load(fe);
  v.f[1] = load(fe + 1);
  v.f[2] = load(fe + 2);
  const T* __restrict__ gd =
      g + static_cast<int64_t>(__ldg(dst + v.p)) * 9 * channels + c;
#pragma unroll
  for (int k = 0; k < 9; ++k) v.g[k] = load(gd + static_cast<int64_t>(k) * channels);
}

template <typename T>
__device__ __forceinline__ void backward_add(float (&acc)[10], const float (&x)[10],
                                             const BackwardEdge& v,
                                             T* __restrict__ d_f, int channels,
                                             int c) {
  const float* g = v.g;  // k = 3 i + j
  const float t = g[0] + g[4] + g[8];
  const float u[3] = {g[1] - g[3], g[2] - g[6], g[5] - g[7]};
  const float w[6] = {g[0], g[4], g[8], g[1] + g[3], g[2] + g[6], g[5] + g[7]};
  acc[0] += v.f[0] * t;
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[1 + k] += v.f[1] * u[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[4 + k] += v.f[2] * w[k];
  float da = u[0] * x[1];
#pragma unroll
  for (int k = 1; k < 3; ++k) da += u[k] * x[1 + k];
  float ds = w[0] * x[4];
#pragma unroll
  for (int k = 1; k < 6; ++k) ds += w[k] * x[4 + k];
  T* __restrict__ out = d_f + v.p * 3 * channels + 3 * c;
  store(out, t * x[0]);
  store(out + 1, da);
  store(out + 2, ds);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
tensornet_interaction_bwd_kernel(const T* __restrict__ g,
                                 const T* __restrict__ f,
                                 const T* __restrict__ node_i,
                                 const T* __restrict__ node_a,
                                 const T* __restrict__ node_s,
                                 const int64_t* __restrict__ perm,
                                 const int32_t* __restrict__ dst,
                                 const int64_t* __restrict__ row_ptr,
                                 T* __restrict__ d_f, T* __restrict__ d_i,
                                 T* __restrict__ d_a, T* __restrict__ d_s,
                                 int64_t n_rows, int64_t n_edges, int channels,
                                 int tpr, int64_t row_blocks) {
  if (static_cast<int64_t>(blockIdx.x) >= row_blocks) {
    // the masked edges, sorted past the last row: zero d f rows
    if (blockIdx.y != 0) return;
    const int64_t start = row_ptr[n_rows];
    const int64_t width = 3 * static_cast<int64_t>(channels);
    const int64_t total = (n_edges - start) * width;
    const int64_t stride = (static_cast<int64_t>(gridDim.x) - row_blocks) * kThreads;
    for (int64_t k = (static_cast<int64_t>(blockIdx.x) - row_blocks) * kThreads + threadIdx.x;
         k < total; k += stride) {
      const int64_t e = start + k / width;
      store(d_f + __ldg(perm + e) * width + k % width, 0.0f);
    }
    return;
  }
  int64_t row;
  int c;
  if (!thread_slot(n_rows, channels, tpr, row, c)) return;
  float x[10], acc[10];
  compact_load(x, node_i, node_a, node_s, row, channels, c);
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = 0.0f;

  const int64_t e1 = row_ptr[row + 1];
  int64_t e = row_ptr[row];
  for (; e + kBwdInFlight <= e1; e += kBwdInFlight) {
    BackwardEdge v[kBwdInFlight];
#pragma unroll
    for (int q = 0; q < kBwdInFlight; ++q) {
      backward_load(v[q], g, f, perm, dst, e + q, channels, c);
    }
#pragma unroll
    for (int q = 0; q < kBwdInFlight; ++q) backward_add(acc, x, v[q], d_f, channels, c);
  }
  for (; e < e1; ++e) {
    BackwardEdge v;
    backward_load(v, g, f, perm, dst, e, channels, c);
    backward_add(acc, x, v, d_f, channels, c);
  }
  const int64_t ch = channels;
  store(d_i + row * ch + c, acc[0]);
#pragma unroll
  for (int k = 0; k < 3; ++k) store(d_a + (row * 3 + k) * ch + c, acc[1 + k]);
#pragma unroll
  for (int k = 0; k < 6; ++k) store(d_s + (row * 6 + k) * ch + c, acc[4 + k]);
}

// ---- interaction, backward, bfloat16 ---------------------------------------
//
// The same cotangents at bf16 data, its own kernel. The float32 kernel's
// bf16 instantiation issued, per edge and thread, the perm -> dst -> g chain
// and 16 memory instructions of 2 bytes each (32 a row at C = 64): the same
// instructions as float32 for half the bytes, with the chain's latency
// exposed. Here a warp owns one (src row, slab of 32 CPT channels): CPT = 2
// (a lane takes a channel pair, 64 channels a warp) where C is even and
// every array is 4-byte aligned, so g's 9 entries are 9 loads of 128
// contiguous bytes a warp and a lane's f and d f entries 6 contiguous bf16
// (3 pair loads, 3 pair stores); CPT = 1 (one channel a lane) otherwise,
// e.g. odd C, where an f row starts at a 2-byte boundary; C past 32 CPT
// takes more slabs on grid.y. The warp loads its row's edge indices 32 at a
// time (perm[e..e+31] coalesced, then dst at those edges) and passes them to
// the lanes by shuffles, so each edge's g row is known without two
// dependent loads an edge; the g and f rows of kBwdBf16InFlight edges are
// loaded before any is used. Each channel's t, u, v, its d x sums in src-sorted edge order and
// the three d f dot products are the float32 kernel's expressions
// (backward_terms, as backward_add), so every output equals the float32
// kernel's on the upcast inputs rounded once, bit for bit, as the bf16
// instantiation's did. Blocks before the row grid write the masked edges'
// zero d f rows (a warp an edge, their perm ids loaded 32 at a time), so
// they overlap the rows' work.
//
// Measured (tools/kernel_ab.py, kernel alone by the profiler, NVIDIA H100
// 80GB HBM3 at 700 W, the TensorNet path's graph: E 917,504, C 64; PERF.md
// section 6): 0.3042-0.3048 ms, 70% of the 0.215 ms bytes bound, where the
// bf16 instantiation took 0.4424. What holds it past the bound: the g
// gathers come from L2, 0.88 GB a call (2.9 TB/s at 0.304 ms) beside the
// 0.72 GB the bound counts. Edges in flight x the register cap (kernel
// alone, one call): four edges at 128 registers (two blocks an SM) 0.304;
// the same without a cap, 147 registers and one block an SM, 0.395; two
// edges (116 registers) 0.331; eight (206) 0.355-0.361, capped at 128
// (spills) 0.520; caps of 80 registers (three blocks, spills) 0.352-0.354
// at two edges and 0.578-0.582 at four; 64 (four blocks) at two edges
// 0.452-0.454.

constexpr int kBwdBf16Warps = 8;     // warps a block: 8 src rows (or slabs) a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBwdBf16InFlight = 4;  // edges whose g and f rows are loaded before any is used
constexpr int kBwdBf16MinBlocks = 2; // blocks an SM the registers must allow: 128 a thread

// the float32 kernel's arithmetic for one channel of one edge (backward_add):
// f0 t, f1 u, f2 v added into acc, d f's three entries returned in df
__device__ __forceinline__ void backward_terms(const float (&g)[9], const float (&fe)[3],
                                               const float (&x)[10], float (&acc)[10],
                                               float (&df)[3]) {
  const float t = g[0] + g[4] + g[8];
  const float u[3] = {g[1] - g[3], g[2] - g[6], g[5] - g[7]};
  const float w[6] = {g[0], g[4], g[8], g[1] + g[3], g[2] + g[6], g[5] + g[7]};
  acc[0] += fe[0] * t;
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[1 + k] += fe[1] * u[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[4 + k] += fe[2] * w[k];
  float da = u[0] * x[1];
#pragma unroll
  for (int k = 1; k < 3; ++k) da += u[k] * x[1 + k];
  float ds = w[0] * x[4];
#pragma unroll
  for (int k = 1; k < 6; ++k) ds += w[k] * x[4 + k];
  df[0] = t * x[0];
  df[1] = da;
  df[2] = ds;
}

// CPT bf16 at p (4-byte aligned for CPT 2) as raw 32-bit words and floats
__device__ __forceinline__ unsigned load_raw2(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}
__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int CPT>
__device__ __forceinline__ void load_channels(const __nv_bfloat16* p, float (&v)[CPT]) {
  if constexpr (CPT == 2) {
    const unsigned w = load_raw2(p);
    v[0] = lo_bf16(w);
    v[1] = hi_bf16(w);
  } else {
    v[0] = __bfloat162float(__ldg(p));
  }
}

template <int CPT>
__device__ __forceinline__ void store_channels(__nv_bfloat16* p, const float (&v)[CPT]) {
  if constexpr (CPT == 2) {
    *reinterpret_cast<unsigned*>(p) = pack_bf16x2(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// one edge's rows for the lane's CPT channels, as raw words: g's 9 entries
// (CPT 2: a pair each) and f's 3 CPT contiguous entries
template <int CPT>
struct BwdRows {
  unsigned g[9];
  unsigned f[CPT == 2 ? 3 : 2];
};

template <int CPT>
__device__ __forceinline__ void bwd_rows_load(BwdRows<CPT>& r, const __nv_bfloat16* __restrict__ gd,
                                              const __nv_bfloat16* __restrict__ fe, int channels) {
  if constexpr (CPT == 2) {
#pragma unroll
    for (int k = 0; k < 9; ++k) r.g[k] = load_raw2(gd + static_cast<int64_t>(k) * channels);
#pragma unroll
    for (int k = 0; k < 3; ++k) r.f[k] = load_raw2(fe + 2 * k);
  } else {
    const unsigned short* gs = reinterpret_cast<const unsigned short*>(gd);
    const unsigned short* fs = reinterpret_cast<const unsigned short*>(fe);
#pragma unroll
    for (int k = 0; k < 9; ++k) r.g[k] = __ldg(gs + static_cast<int64_t>(k) * channels);
    r.f[0] = __ldg(fs) | static_cast<unsigned>(__ldg(fs + 1)) << 16;
    r.f[1] = __ldg(fs + 2);
  }
}

template <int CPT>
__global__ void __launch_bounds__(32 * kBwdBf16Warps, kBwdBf16MinBlocks)
tensornet_interaction_bwd_kernel_bf16(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ f,
    const __nv_bfloat16* __restrict__ node_i, const __nv_bfloat16* __restrict__ node_a,
    const __nv_bfloat16* __restrict__ node_s, const int64_t* __restrict__ perm,
    const int32_t* __restrict__ dst, const int64_t* __restrict__ row_ptr,
    __nv_bfloat16* __restrict__ d_f, __nv_bfloat16* __restrict__ d_i,
    __nv_bfloat16* __restrict__ d_a, __nv_bfloat16* __restrict__ d_s, int64_t n_rows,
    int64_t n_edges, int channels, int64_t tail_blocks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t ch = channels;
  if (static_cast<int64_t>(blockIdx.x) < tail_blocks) {
    // the masked edges, sorted past the last row: zero d f rows, a warp an edge
    if (blockIdx.y != 0) return;
    const int64_t start = row_ptr[n_rows];
    const int64_t warps = tail_blocks * kBwdBf16Warps;
    for (int64_t m0 = (static_cast<int64_t>(blockIdx.x) * kBwdBf16Warps + warp) * 32;
         start + m0 < n_edges; m0 += warps * 32) {
      const int nb = n_edges - start - m0 < 32 ? static_cast<int>(n_edges - start - m0) : 32;
      const int64_t mine = lane < nb ? __ldg(perm + start + m0 + lane) : 0;
      for (int k = 0; k < nb; ++k) {
        const int64_t p = __shfl_sync(kFull, mine, k);
        if constexpr (CPT == 2) {  // 3 C even: the row is 4-byte aligned
          unsigned* row = reinterpret_cast<unsigned*>(d_f + p * 3 * ch);
          for (int64_t w = lane; w < 3 * ch / 2; w += 32) row[w] = 0u;
        } else {
          for (int64_t w = lane; w < 3 * ch; w += 32) d_f[p * 3 * ch + w] = __float2bfloat16_rn(0.0f);
        }
      }
    }
    return;
  }
  const int64_t row = (static_cast<int64_t>(blockIdx.x) - tail_blocks) * kBwdBf16Warps + warp;
  if (row >= n_rows) return;  // whole warps; no block barrier
  const int c = (static_cast<int>(blockIdx.y) * 32 + lane) * CPT;  // the lane's first channel
  const bool on = c < channels;  // CPT 2: C is even, so c + 1 < C too

  float x[CPT][10], acc[CPT][10];
  if (on) {
    float v[CPT];
    load_channels<CPT>(node_i + row * ch + c, v);
#pragma unroll
    for (int q = 0; q < CPT; ++q) x[q][0] = v[q];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      load_channels<CPT>(node_a + (row * 3 + k) * ch + c, v);
#pragma unroll
      for (int q = 0; q < CPT; ++q) x[q][1 + k] = v[q];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      load_channels<CPT>(node_s + (row * 6 + k) * ch + c, v);
#pragma unroll
      for (int q = 0; q < CPT; ++q) x[q][4 + k] = v[q];
    }
  }
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
#pragma unroll
    for (int k = 0; k < 10; ++k) acc[q][k] = 0.0f;
  }

  const int64_t e_end = row_ptr[row + 1];
  for (int64_t eb = row_ptr[row]; eb < e_end; eb += 32) {
    const int nb = e_end - eb < 32 ? static_cast<int>(e_end - eb) : 32;
    const int64_t my_p = lane < nb ? __ldg(perm + eb + lane) : 0;
    const int32_t my_d = lane < nb ? __ldg(dst + my_p) : 0;
    for (int k = 0; k < nb; k += kBwdBf16InFlight) {
      int64_t p[kBwdBf16InFlight];
      BwdRows<CPT> r[kBwdBf16InFlight];
#pragma unroll
      for (int q = 0; q < kBwdBf16InFlight; ++q) {
        p[q] = __shfl_sync(kFull, my_p, k + q);  // lanes past nb: unused
        const int32_t d = __shfl_sync(kFull, my_d, k + q);
        if (on && k + q < nb) {
          bwd_rows_load<CPT>(r[q], g + static_cast<int64_t>(d) * 9 * ch + c,
                             f + (p[q] * ch + c) * 3, channels);
        }
      }
#pragma unroll
      for (int q = 0; q < kBwdBf16InFlight; ++q) {
        if (!(on && k + q < nb)) continue;
        float gq[CPT][9], fq[CPT][3], df[CPT][3];
#pragma unroll
        for (int kk = 0; kk < 9; ++kk) {
          if constexpr (CPT == 2) {
            gq[0][kk] = lo_bf16(r[q].g[kk]);
            gq[1][kk] = hi_bf16(r[q].g[kk]);
          } else {
            gq[0][kk] = lo_bf16(r[q].g[kk]);
          }
        }
        // f's entries (c, 0..2), then (c + 1, 0..2): the words hold them in order
        fq[0][0] = lo_bf16(r[q].f[0]);
        fq[0][1] = hi_bf16(r[q].f[0]);
        fq[0][2] = lo_bf16(r[q].f[1]);
        if constexpr (CPT == 2) {
          fq[1][0] = hi_bf16(r[q].f[1]);
          fq[1][1] = lo_bf16(r[q].f[2]);
          fq[1][2] = hi_bf16(r[q].f[2]);
        }
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) backward_terms(gq[cc], fq[cc], x[cc], acc[cc], df[cc]);
        __nv_bfloat16* out = d_f + (p[q] * ch + c) * 3;
        if constexpr (CPT == 2) {
          unsigned* o = reinterpret_cast<unsigned*>(out);
          o[0] = pack_bf16x2(df[0][0], df[0][1]);
          o[1] = pack_bf16x2(df[0][2], df[1][0]);
          o[2] = pack_bf16x2(df[1][1], df[1][2]);
        } else {
#pragma unroll
          for (int kk = 0; kk < 3; ++kk) out[kk] = __float2bfloat16_rn(df[0][kk]);
        }
      }
    }
  }
  if (!on) return;
  float v[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) v[q] = acc[q][0];
  store_channels<CPT>(d_i + row * ch + c, v);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int q = 0; q < CPT; ++q) v[q] = acc[q][1 + k];
    store_channels<CPT>(d_a + (row * 3 + k) * ch + c, v);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int q = 0; q < CPT; ++q) v[q] = acc[q][4 + k];
    store_channels<CPT>(d_s + (row * 6 + k) * ch + c, v);
  }
}

// ---- embed and interaction, forward, bfloat16 -----------------------------
//
// The two forwards at bf16 data, kernels of their own. The float32 kernels'
// bf16 instantiation took one 2-byte load a lane: the same instructions as
// float32 for half the bytes. Per edge, each thread of the embed issued 22
// loads (Z, W1, W2, W3 and 18 broadcast loads of the same 36 bytes of A_e
// and S_e), gated by a mask byte loaded first; each of the interaction a
// dependent chain mask -> src -> 10 gathered compact words, and 3 loads of f.
// Issue rate and exposed latency held both (the float32 interaction draws
// its gathers through L2 at ~6.6 TB/s, the bf16 one at ~2.8).
//
// Here a warp owns one (dst row, slab of 32 CPT channels), as the bf16
// backward does: CPT = 2 (a channel pair a lane, 64 channels a warp) where C
// is even and every array the lanes index by channel is 4-byte aligned, so
// each row of Z, W, a compact node row or the output is one 4-byte word a
// lane (128 bytes a warp) and an f row 6 contiguous bf16 (3 words); CPT = 1
// (one channel a lane, 2-byte loads) otherwise. Past 32 CPT channels more
// slabs go on grid.y. A turn takes the row's next 32 edges: the warp loads
// their mask bytes (and the interaction their src ids) coalesced, one edge a
// lane, and a ballot gives the valid ones; the src ids reach the lanes by
// shuffles. A few valid edges (kEmbedBf16InFlight, kInteractionBf16InFlight)
// have their rows loaded before any is added. The embed's 18 geometric
// scalars of the turn's 32 edges are two spans of 32 x 9 bf16 at an 18-byte
// row stride (rows not 4-byte aligned):
// the warp reads each with 16-byte loads from its aligned-down base, drops
// the bytes outside the span, and stages the values as float32 in shared
// memory, 20 floats an edge (16-byte rows), from which every lane reads an
// edge's 18 by five broadcast 16-byte loads. A turn with no valid edge loads
// nothing more. Masked edges are never added (nor their Z, W, f or node rows
// read); the staged scalars of a masked edge are never read.
//
// Each channel's sums run over its valid edges in edge order through
// embed_add / interaction_add on the float32 values, the 3x3 is assembled
// as the float32 kernel does, and each output is rounded once (a bf16 pair
// a lane at CPT 2): the float32 kernel's output on the upcast inputs,
// rounded once, bit for bit.
//
// Floors on an H100 at the TensorNet path's graph (E 917,504, ~0.77 M valid
// edges, C = 64): the embed's bytes, 0.133 ms; the interaction's bytes,
// 0.103 ms, and its L2 gather of 10 compact rows an edge (0.99 GB a call),
// ~0.15 ms at the 6.6 TB/s the float32 kernel draws.

// Each kernel's block (warps: dst rows, or slabs, a block), valid edges
// whose rows are loaded before any is added, and blocks an SM the registers
// must allow (the register cap: 65,536 / (32 x warps x min blocks) a
// thread): the embed 4 edges at 80 registers (3 blocks, 24 warps an SM), the
// interaction 2 edges at 64 (4 blocks, 32 warps). Warps an SM, not edges
// in flight, led (kernel alone on the H100: PERF.md section 6, PR 19).
constexpr int kEmbedBf16Warps = 8;
constexpr int kEmbedBf16InFlight = 4;
constexpr int kEmbedBf16MinBlocks = 3;
constexpr int kInteractionBf16Warps = 8;
constexpr int kInteractionBf16InFlight = 2;
constexpr int kInteractionBf16MinBlocks = 4;
constexpr int kGeoStride = 20;  // staged floats an embed edge: A_e's 9, S_e's 9, 2 unused

// CPT bf16 at p as one raw word: a pair (4-byte aligned) or one value in
// the low half
template <int CPT>
__device__ __forceinline__ unsigned load_word(const __nv_bfloat16* p) {
  if constexpr (CPT == 2) {
    return load_raw2(p);
  } else {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// channel cc of a word load_word<CPT> returned, as float32
__device__ __forceinline__ float word_channel(unsigned w, int cc) {
  return cc == 0 ? lo_bf16(w) : hi_bf16(w);
}

// The turn's valid edges among [eb, eb + nb): lane l tests edge eb + l
__device__ __forceinline__ unsigned turn_ballot(const uint8_t* __restrict__ mask, int64_t eb,
                                                int nb, int lane) {
  const bool v = lane < nb && (mask == nullptr || __ldg(mask + eb + lane) != 0);
  return __ballot_sync(kFull, v);
}

// The next valid edge of a turn (its lane, -1 when none is left), taken off
// `valid`; the same for every lane, so edges come in edge order
__device__ __forceinline__ int next_edge(unsigned& valid) {
  const int k = __ffs(static_cast<int>(valid)) - 1;
  valid &= valid - 1;
  return k;
}

// Stage the 9 bf16 scalars of the nb edges from eb of x (rows of 9) into
// geo[k][j0 .. j0 + 8] as float32: 16-byte loads from the span's
// aligned-down base, a lane a vector, the values outside the span dropped.
__device__ __forceinline__ void stage_scalars(float (*geo)[kGeoStride],
                                              const __nv_bfloat16* __restrict__ x, int64_t eb,
                                              int nb, int lane, int j0) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(x + eb * 9);
  const uintptr_t base = start & ~static_cast<uintptr_t>(15);
  const int lead = static_cast<int>(start - base) / 2;  // values before the span, 0..7
  const int n = nb * 9;
  const int vectors = (lead + n + 7) / 8;
  const uint4* __restrict__ p = reinterpret_cast<const uint4*>(base);
  for (int v = lane; v < vectors; v += 32) {
    const uint4 q = __ldg(p + v);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * v + i - lead;
      if (t >= 0 && t < n) geo[t / 9][j0 + t % 9] = word_channel(w[i / 2], i % 2);
    }
  }
}

template <int CPT>
__global__ void __launch_bounds__(32 * kEmbedBf16Warps, kEmbedBf16MinBlocks)
tensornet_embed_kernel_bf16(const __nv_bfloat16* __restrict__ z,
                            const __nv_bfloat16* __restrict__ w1,
                            const __nv_bfloat16* __restrict__ w2,
                            const __nv_bfloat16* __restrict__ w3,
                            const __nv_bfloat16* __restrict__ a_e,
                            const __nv_bfloat16* __restrict__ s_e,
                            const int64_t* __restrict__ row_ptr,
                            const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                            int64_t n_rows, int channels) {
  __shared__ __align__(16) float stage[kEmbedBf16Warps][32][kGeoStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kEmbedBf16Warps + warp;
  if (row >= n_rows) return;  // whole warps; the stage is the warp's own
  const int c = (static_cast<int>(blockIdx.y) * 32 + lane) * CPT;  // the lane's first channel
  const bool on = c < channels;  // CPT 2: C is even, so c + 1 < C too
  const int64_t ch = channels;
  float (*geo)[kGeoStride] = stage[warp];
  const __nv_bfloat16* __restrict__ rows[4] = {z, w1, w2, w3};

  float acc[CPT][9];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[q][k] = 0.0f;
  }
  const int64_t e_end = row_ptr[row + 1];
  for (int64_t eb = row_ptr[row]; eb < e_end; eb += 32) {
    const int nb = e_end - eb < 32 ? static_cast<int>(e_end - eb) : 32;
    unsigned valid = turn_ballot(mask, eb, nb, lane);
    if (valid == 0) continue;
    stage_scalars(geo, a_e, eb, nb, lane, 0);
    stage_scalars(geo, s_e, eb, nb, lane, 9);
    __syncwarp();
    while (valid != 0) {
      int k[kEmbedBf16InFlight];
      unsigned w[kEmbedBf16InFlight][4];
#pragma unroll
      for (int q = 0; q < kEmbedBf16InFlight; ++q) {
        k[q] = next_edge(valid);
        if (on && k[q] >= 0) {
          const int64_t o = (eb + k[q]) * ch + c;
#pragma unroll
          for (int r = 0; r < 4; ++r) w[q][r] = load_word<CPT>(rows[r] + o);
        }
      }
#pragma unroll
      for (int q = 0; q < kEmbedBf16InFlight; ++q) {
        if (!(on && k[q] >= 0)) continue;
        const float4* g = reinterpret_cast<const float4*>(geo[k[q]]);
        float s[kGeoStride];
#pragma unroll
        for (int j = 0; j < kGeoStride / 4; ++j) {
          const float4 v = g[j];
          s[4 * j] = v.x;
          s[4 * j + 1] = v.y;
          s[4 * j + 2] = v.z;
          s[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          EmbedEdge v;
          v.z = word_channel(w[q][0], cc);
          v.w1 = word_channel(w[q][1], cc);
          v.w2 = word_channel(w[q][2], cc);
          v.w3 = word_channel(w[q][3], cc);
#pragma unroll
          for (int j = 0; j < 9; ++j) {
            v.a[j] = s[j];
            v.s[j] = s[9 + j];
          }
          embed_add(acc[cc], v);
        }
      }
    }
    __syncwarp();  // every lane has read the stage before the next turn writes it
  }
  if (!on) return;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float v[CPT];
#pragma unroll
    for (int q = 0; q < CPT; ++q) v[q] = acc[q][k];
    store_channels<CPT>(out + (row * 9 + k) * ch + c, v);
  }
}

// one edge's rows for the lane's CPT channels, as raw words: f's 3 CPT
// contiguous entries (CPT 2: (c, 0..2), (c + 1, 0..2) in 3 words; CPT 1:
// one a word) and the 10 compact words of its src row (i, a, s)
struct FwdRows {
  unsigned f[3], x[10];
};

template <int CPT>
__device__ __forceinline__ void interaction_rows_load(
    FwdRows& r, const __nv_bfloat16* __restrict__ f, const __nv_bfloat16* __restrict__ node_i,
    const __nv_bfloat16* __restrict__ node_a, const __nv_bfloat16* __restrict__ node_s,
    int64_t e, int64_t j, int64_t ch, int c) {
  const __nv_bfloat16* __restrict__ fe = f + (e * ch + c) * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.f[k] = load_word<CPT>(fe + CPT * k);
  r.x[0] = load_word<CPT>(node_i + j * ch + c);
#pragma unroll
  for (int k = 0; k < 3; ++k) r.x[1 + k] = load_word<CPT>(node_a + (j * 3 + k) * ch + c);
#pragma unroll
  for (int k = 0; k < 6; ++k) r.x[4 + k] = load_word<CPT>(node_s + (j * 6 + k) * ch + c);
}

template <int CPT>
__global__ void __launch_bounds__(32 * kInteractionBf16Warps, kInteractionBf16MinBlocks)
tensornet_interaction_kernel_bf16(const __nv_bfloat16* __restrict__ f,
                                  const __nv_bfloat16* __restrict__ node_i,
                                  const __nv_bfloat16* __restrict__ node_a,
                                  const __nv_bfloat16* __restrict__ node_s,
                                  const int32_t* __restrict__ src,
                                  const int64_t* __restrict__ row_ptr,
                                  const uint8_t* __restrict__ mask,
                                  __nv_bfloat16* __restrict__ out, int64_t n_rows,
                                  int channels) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kInteractionBf16Warps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps; no block barrier
  const int c = (static_cast<int>(blockIdx.y) * 32 + lane) * CPT;  // the lane's first channel
  const bool on = c < channels;  // CPT 2: C is even, so c + 1 < C too
  const int64_t ch = channels;

  float acc[CPT][10];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
#pragma unroll
    for (int k = 0; k < 10; ++k) acc[q][k] = 0.0f;
  }
  const int64_t e_end = row_ptr[row + 1];
  for (int64_t eb = row_ptr[row]; eb < e_end; eb += 32) {
    const int nb = e_end - eb < 32 ? static_cast<int>(e_end - eb) : 32;
    const int32_t my_src = lane < nb ? __ldg(src + eb + lane) : 0;
    unsigned valid = turn_ballot(mask, eb, nb, lane);
    while (valid != 0) {
      int k[kInteractionBf16InFlight];
      FwdRows r[kInteractionBf16InFlight];
#pragma unroll
      for (int q = 0; q < kInteractionBf16InFlight; ++q) {
        k[q] = next_edge(valid);
        const int32_t j = __shfl_sync(kFull, my_src, k[q] < 0 ? 0 : k[q]);
        if (on && k[q] >= 0) {
          interaction_rows_load<CPT>(r[q], f, node_i, node_a, node_s, eb + k[q], j, ch, c);
        }
      }
#pragma unroll
      for (int q = 0; q < kInteractionBf16InFlight; ++q) {
        if (!(on && k[q] >= 0)) continue;
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          InteractionEdge v;
#pragma unroll
          for (int kk = 0; kk < 3; ++kk) {
            // CPT 2: entry kk of channel cc is value 3 cc + kk of the 6
            v.f[kk] = CPT == 2 ? word_channel(r[q].f[(3 * cc + kk) / 2], (3 * cc + kk) % 2)
                               : lo_bf16(r[q].f[kk]);
          }
#pragma unroll
          for (int kk = 0; kk < 10; ++kk) v.x[kk] = word_channel(r[q].x[kk], cc);
          interaction_add(acc[cc], v);
        }
      }
    }
  }
  if (!on) return;
  float full[CPT][9];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const float* a = acc[q];
    // k = 3 i + j: diagonal i + s_pp, upper a_pq + s_pq, lower s_pq - a_pq
    const float fq[9] = {a[0] + a[4], a[1] + a[7], a[2] + a[8],
                         a[7] - a[1], a[0] + a[5], a[3] + a[9],
                         a[8] - a[2], a[9] - a[3], a[0] + a[6]};
#pragma unroll
    for (int k = 0; k < 9; ++k) full[q][k] = fq[k];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float v[CPT];
#pragma unroll
    for (int q = 0; q < CPT; ++q) v[q] = full[q][k];
    store_channels<CPT>(out + (row * 9 + k) * ch + c, v);
  }
}

// launch shape: tpr threads per row (channels rounded up to a warp, at most
// kThreads), kThreads / tpr rows per block, channel slabs on grid.y
int launch_shape(int64_t n_rows, int channels, dim3& grid, int& tpr) {
  if (n_rows <= 0 || channels <= 0) return -1;
  const int warps = (channels + 31) / 32;
  tpr = warps * 32 < kThreads ? warps * 32 : kThreads;
  const int64_t rows_per_block = kThreads / tpr;
  const int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  const int64_t slabs = (channels + tpr - 1) / tpr;
  if (blocks > 2147483647LL || slabs > 65535) return 1;
  grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(slabs));
  return 0;
}

template <typename T>
int launch_embed(const T* z, const T* w1, const T* w2, const T* w3, const T* a_e,
                 const T* s_e, const int64_t* row_ptr, const uint8_t* mask, T* out,
                 int64_t n_rows, int channels, void* stream) {
  dim3 grid;
  int tpr;
  const int shape = launch_shape(n_rows, channels, grid, tpr);
  if (shape < 0) return 0;
  if (shape > 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  tensornet_embed_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, w1, w2, w3, a_e, s_e, row_ptr, mask, out, n_rows, channels, tpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_interaction(const T* f, const T* node_i, const T* node_a, const T* node_s,
                       const int32_t* src, const int64_t* row_ptr, const uint8_t* mask,
                       T* out, int64_t n_rows, int channels, void* stream) {
  dim3 grid;
  int tpr;
  const int shape = launch_shape(n_rows, channels, grid, tpr);
  if (shape < 0) return 0;
  if (shape > 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  tensornet_interaction_kernel<T><<<grid, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      f, node_i, node_a, node_s, src, row_ptr, mask, out, n_rows, channels, tpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_interaction_bwd(const T* g, const T* f, const T* node_i, const T* node_a,
                           const T* node_s, const int64_t* perm, const int32_t* dst,
                           const int64_t* row_ptr, T* d_f, T* d_i, T* d_a, T* d_s,
                           int64_t n_rows, int64_t n_edges, int channels, void* stream) {
  dim3 grid;
  int tpr;
  const int shape = launch_shape(n_rows, channels, grid, tpr);
  if (shape < 0) return 0;
  if (shape > 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t row_blocks = grid.x;
  // enough blocks to stream the masked rows' zeros; each loops over its share
  int64_t tail = (n_edges * 3 * static_cast<int64_t>(channels) + kThreads * 8 - 1) /
                 (kThreads * 8);
  tail = tail < 1 ? 1 : (tail > 1056 ? 1056 : tail);
  if (row_blocks + tail > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  grid.x = static_cast<unsigned>(row_blocks + tail);
  tensornet_interaction_bwd_kernel<T><<<grid, kThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      g, f, node_i, node_a, node_s, perm, dst, row_ptr, d_f, d_i, d_a, d_s,
      n_rows, n_edges, channels, tpr, row_blocks);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 backward's launch, worked out once from its arguments: CPT 2
// where C is even and every array (the 5 inputs, the 4 outputs) is 4-byte
// aligned, else 1; blocks [0, tail) write the masked rows, then
// ceil(n_rows / 8) blocks of src rows; grid.y the 32 CPT-channel slabs.
// The launch takes it and distmlip_tensornet_interaction_bwd_bf16_plan
// reports it, so the two cannot differ.
struct BwdBf16Route {
  const void* kernel;
  dim3 grid;
  int cpt;
  int64_t slabs;
  int64_t tail;
};

cudaError_t bwd_bf16_route(const void* const (&arrays)[9], int64_t n_rows, int64_t n_edges,
                           int channels, BwdBf16Route& r) {
  bool pairs = channels % 2 == 0;
  for (const void* a : arrays) pairs = pairs && reinterpret_cast<uintptr_t>(a) % 4 == 0;
  r.cpt = pairs ? 2 : 1;
  r.kernel = pairs ? reinterpret_cast<const void*>(tensornet_interaction_bwd_kernel_bf16<2>)
                   : reinterpret_cast<const void*>(tensornet_interaction_bwd_kernel_bf16<1>);
  const int64_t row_blocks = (n_rows + kBwdBf16Warps - 1) / kBwdBf16Warps;
  r.slabs = (channels + 32 * r.cpt - 1) / (32 * r.cpt);
  // a warp takes 32 masked edges a turn; the tail's blocks loop over the rest
  r.tail = (n_edges + 32 * kBwdBf16Warps - 1) / (32 * kBwdBf16Warps);
  r.tail = r.tail < 1 ? 1 : (r.tail > 1056 ? 1056 : r.tail);
  if (row_blocks + r.tail > 2147483647LL || r.slabs > 65535) return cudaErrorInvalidConfiguration;
  r.grid = dim3(static_cast<unsigned>(row_blocks + r.tail), static_cast<unsigned>(r.slabs));
  return cudaSuccess;
}

int launch_interaction_bwd_bf16(const __nv_bfloat16* g, const __nv_bfloat16* f,
                                const __nv_bfloat16* node_i, const __nv_bfloat16* node_a,
                                const __nv_bfloat16* node_s, const int64_t* perm,
                                const int32_t* dst, const int64_t* row_ptr, __nv_bfloat16* d_f,
                                __nv_bfloat16* d_i, __nv_bfloat16* d_a, __nv_bfloat16* d_s,
                                int64_t n_rows, int64_t n_edges, int channels, void* stream) {
  if (n_rows <= 0 || channels <= 0) return 0;
  const void* const arrays[9] = {g, f, node_i, node_a, node_s, d_f, d_i, d_a, d_s};
  BwdBf16Route r;
  const cudaError_t err = bwd_bf16_route(arrays, n_rows, n_edges, channels, r);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&g,   &f,   &node_i, &node_a, &node_s,  &perm,     &dst,     &row_ptr,
                  &d_f, &d_i, &d_a,    &d_s,    &n_rows,  &n_edges,  &channels, &r.tail};
  return static_cast<int>(cudaLaunchKernel(r.kernel, r.grid, dim3(32 * kBwdBf16Warps), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}

// The bf16 forwards' launch, worked out once from the arrays the lanes
// index by channel (embed: Z, W1, W2, W3 and the output; interaction: f,
// the three compact node arrays and the output; A_e and S_e are read from an
// aligned-down base and do not enter): CPT 2 where C is even and each of
// them is 4-byte aligned, else 1; ceil(n_rows / 8) blocks of dst rows;
// grid.y the 32 CPT-channel slabs. The launch takes it and the *_plan C
// entries report it, so the two cannot differ.
struct FwdBf16Route {
  const void* kernel;
  dim3 grid;
  int cpt;
  int64_t slabs;
  int warps;      // a block
  int in_flight;  // edges a warp
};

template <int N>
cudaError_t fwd_bf16_route(const void* const (&arrays)[N], const void* pairs_kernel,
                           const void* single_kernel, int warps, int in_flight,
                           int64_t n_rows, int channels, FwdBf16Route& r) {
  bool pairs = channels % 2 == 0;
  for (const void* a : arrays) pairs = pairs && reinterpret_cast<uintptr_t>(a) % 4 == 0;
  r.cpt = pairs ? 2 : 1;
  r.kernel = pairs ? pairs_kernel : single_kernel;
  r.warps = warps;
  r.in_flight = in_flight;
  const int64_t blocks = (n_rows + warps - 1) / warps;
  r.slabs = (channels + 32 * r.cpt - 1) / (32 * r.cpt);
  if (blocks > 2147483647LL || r.slabs > 65535) return cudaErrorInvalidConfiguration;
  r.grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(r.slabs));
  return cudaSuccess;
}

cudaError_t embed_bf16_route(const void* z, const void* w1, const void* w2, const void* w3,
                             const void* out, int64_t n_rows, int channels, FwdBf16Route& r) {
  const void* const arrays[5] = {z, w1, w2, w3, out};
  return fwd_bf16_route(arrays, reinterpret_cast<const void*>(tensornet_embed_kernel_bf16<2>),
                        reinterpret_cast<const void*>(tensornet_embed_kernel_bf16<1>),
                        kEmbedBf16Warps, kEmbedBf16InFlight, n_rows, channels, r);
}

cudaError_t interaction_bf16_route(const void* f, const void* node_i, const void* node_a,
                                   const void* node_s, const void* out, int64_t n_rows,
                                   int channels, FwdBf16Route& r) {
  const void* const arrays[5] = {f, node_i, node_a, node_s, out};
  return fwd_bf16_route(arrays,
                        reinterpret_cast<const void*>(tensornet_interaction_kernel_bf16<2>),
                        reinterpret_cast<const void*>(tensornet_interaction_kernel_bf16<1>),
                        kInteractionBf16Warps, kInteractionBf16InFlight, n_rows, channels, r);
}

int launch_embed_bf16(const __nv_bfloat16* z, const __nv_bfloat16* w1, const __nv_bfloat16* w2,
                      const __nv_bfloat16* w3, const __nv_bfloat16* a_e,
                      const __nv_bfloat16* s_e, const int64_t* row_ptr, const uint8_t* mask,
                      __nv_bfloat16* out, int64_t n_rows, int channels, void* stream) {
  if (n_rows <= 0 || channels <= 0) return 0;
  FwdBf16Route r;
  const cudaError_t err = embed_bf16_route(z, w1, w2, w3, out, n_rows, channels, r);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&z, &w1, &w2, &w3, &a_e, &s_e, &row_ptr, &mask, &out, &n_rows, &channels};
  return static_cast<int>(cudaLaunchKernel(r.kernel, r.grid, dim3(32 * r.warps), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}

int launch_interaction_bf16(const __nv_bfloat16* f, const __nv_bfloat16* node_i,
                            const __nv_bfloat16* node_a, const __nv_bfloat16* node_s,
                            const int32_t* src, const int64_t* row_ptr, const uint8_t* mask,
                            __nv_bfloat16* out, int64_t n_rows, int channels, void* stream) {
  if (n_rows <= 0 || channels <= 0) return 0;
  FwdBf16Route r;
  const cudaError_t err = interaction_bf16_route(f, node_i, node_a, node_s, out, n_rows,
                                                 channels, r);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&f, &node_i, &node_a, &node_s, &src, &row_ptr, &mask, &out, &n_rows,
                  &channels};
  return static_cast<int>(cudaLaunchKernel(r.kernel, r.grid, dim3(32 * r.warps), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}

// plan[0] channels a lane (2: pairs, 1: the single-channel path), [1]
// channels a warp, [2] warps a dst row (the slabs), [3] edges in flight a
// warp, [4] edge indices loaded a warp turn, [5] warps a block, [6]
// registers a thread of the kernel, [7] blocks (grid.x), [8] static shared
// bytes a block
cudaError_t fwd_bf16_plan(const FwdBf16Route& r, int64_t* plan) {
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(&attr, r.kernel);
  const int64_t p[9] = {r.cpt, 32 * r.cpt, r.slabs, r.in_flight, 32, r.warps,
                        attr.numRegs, r.grid.x, static_cast<int64_t>(attr.sharedSizeBytes)};
  for (int k = 0; k < 9; ++k) plan[k] = p[k];
  return err;
}

}  // namespace

// The C interface: each function in float32 (_f32) and bfloat16 (_bf16,
// every float tensor of the call bfloat16). Inputs and outputs contiguous on
// the current device. Each launches one kernel on `stream`, does not
// synchronise, and returns the launch's cudaError_t (0 = success).

// z, w1, w2, w3 (E, C); a_e, s_e (E, 9); row_ptr (n_rows + 1) int64; mask
// (E) bytes or null; out (n_rows, 9, C).
extern "C" int distmlip_tensornet_embed_f32(
    const float* z, const float* w1, const float* w2, const float* w3,
    const float* a_e, const float* s_e, const int64_t* row_ptr,
    const uint8_t* mask, float* out, int64_t n_rows, int channels,
    void* stream) {
  return launch_embed(z, w1, w2, w3, a_e, s_e, row_ptr, mask, out, n_rows, channels, stream);
}

extern "C" int distmlip_tensornet_embed_bf16(
    const __nv_bfloat16* z, const __nv_bfloat16* w1, const __nv_bfloat16* w2,
    const __nv_bfloat16* w3, const __nv_bfloat16* a_e, const __nv_bfloat16* s_e,
    const int64_t* row_ptr, const uint8_t* mask, __nv_bfloat16* out, int64_t n_rows,
    int channels, void* stream) {
  return launch_embed_bf16(z, w1, w2, w3, a_e, s_e, row_ptr, mask, out, n_rows, channels,
                           stream);
}

// f (E, C, 3); node_i (N_node, C), node_a (N_node, 3, C), node_s
// (N_node, 6, C); src (E) int32; row_ptr (n_rows + 1) int64; mask (E) bytes
// or null; out (n_rows, 9, C).
extern "C" int distmlip_tensornet_interaction_f32(
    const float* f, const float* node_i, const float* node_a,
    const float* node_s, const int32_t* src, const int64_t* row_ptr,
    const uint8_t* mask, float* out, int64_t n_rows, int channels,
    void* stream) {
  return launch_interaction(f, node_i, node_a, node_s, src, row_ptr, mask, out, n_rows,
                            channels, stream);
}

extern "C" int distmlip_tensornet_interaction_bf16(
    const __nv_bfloat16* f, const __nv_bfloat16* node_i, const __nv_bfloat16* node_a,
    const __nv_bfloat16* node_s, const int32_t* src, const int64_t* row_ptr,
    const uint8_t* mask, __nv_bfloat16* out, int64_t n_rows, int channels,
    void* stream) {
  return launch_interaction_bf16(f, node_i, node_a, node_s, src, row_ptr, mask, out, n_rows,
                                 channels, stream);
}

// g (n_dst, 9, C); f (E, C, 3); node_i, node_a, node_s as above (n_rows
// src rows); perm (E) int64, the edges in src order with the masked ones
// last; dst (E) int32, indexed by edge; row_ptr (n_rows + 1) int64 into
// perm, row_ptr[n_rows] the first masked position; outputs d_f (E, C, 3),
// d_i, d_a, d_s shaped as the node arrays.
extern "C" int distmlip_tensornet_interaction_bwd_f32(
    const float* g, const float* f, const float* node_i, const float* node_a,
    const float* node_s, const int64_t* perm, const int32_t* dst,
    const int64_t* row_ptr, float* d_f, float* d_i, float* d_a, float* d_s,
    int64_t n_rows, int64_t n_edges, int channels, void* stream) {
  return launch_interaction_bwd(g, f, node_i, node_a, node_s, perm, dst, row_ptr, d_f, d_i,
                                d_a, d_s, n_rows, n_edges, channels, stream);
}

extern "C" int distmlip_tensornet_interaction_bwd_bf16(
    const __nv_bfloat16* g, const __nv_bfloat16* f, const __nv_bfloat16* node_i,
    const __nv_bfloat16* node_a, const __nv_bfloat16* node_s, const int64_t* perm,
    const int32_t* dst, const int64_t* row_ptr, __nv_bfloat16* d_f, __nv_bfloat16* d_i,
    __nv_bfloat16* d_a, __nv_bfloat16* d_s, int64_t n_rows, int64_t n_edges, int channels,
    void* stream) {
  return launch_interaction_bwd_bf16(g, f, node_i, node_a, node_s, perm, dst, row_ptr, d_f,
                                     d_i, d_a, d_s, n_rows, n_edges, channels, stream);
}

// The plan distmlip_tensornet_interaction_bwd_bf16 takes for `channels` with
// its arrays at g, f, node_i, node_a, node_s and d_f, d_i, d_a, d_s (an
// output null: a fresh allocation, aligned): plan[0] channels a lane (2:
// pairs, 1: the single-channel path), [1] channels a warp, [2] warps a src
// row (the slabs), [3] edges in flight a warp, [4] edge indices loaded a
// warp turn, [5] warps a block, [6] registers a thread of the kernel.
// Returns a cudaError_t.
extern "C" int distmlip_tensornet_interaction_bwd_bf16_plan(
    const __nv_bfloat16* g, const __nv_bfloat16* f, const __nv_bfloat16* node_i,
    const __nv_bfloat16* node_a, const __nv_bfloat16* node_s, const __nv_bfloat16* d_f,
    const __nv_bfloat16* d_i, const __nv_bfloat16* d_a, const __nv_bfloat16* d_s,
    int channels, int64_t* plan) {
  if (channels <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* const arrays[9] = {g, f, node_i, node_a, node_s, d_f, d_i, d_a, d_s};
  BwdBf16Route r;
  cudaError_t err = bwd_bf16_route(arrays, 1, 1, channels, r);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, r.kernel);
  const int64_t p[7] = {r.cpt, 32 * r.cpt, r.slabs, kBwdBf16InFlight, 32, kBwdBf16Warps,
                        attr.numRegs};
  for (int k = 0; k < 7; ++k) plan[k] = p[k];
  return static_cast<int>(err);
}

// The plans distmlip_tensornet_embed_bf16 and distmlip_tensornet_interaction_bf16
// take for `channels` and n_rows dst rows with their arrays at the given
// addresses (out null: a fresh allocation, aligned), from the launch's own
// route: plan[0] channels a lane (2: pairs, 1: the single-channel path), [1]
// channels a warp, [2] warps a dst row (the slabs), [3] edges in flight a
// warp, [4] edge indices loaded a warp turn, [5] warps a block, [6]
// registers a thread of the kernel, [7] blocks of dst rows, [8] static
// shared bytes a block (the embed's staged scalars). Returns a cudaError_t.
extern "C" int distmlip_tensornet_embed_bf16_plan(
    const __nv_bfloat16* z, const __nv_bfloat16* w1, const __nv_bfloat16* w2,
    const __nv_bfloat16* w3, const __nv_bfloat16* out, int64_t n_rows, int channels,
    int64_t* plan) {
  if (channels <= 0 || n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  FwdBf16Route r;
  const cudaError_t err = embed_bf16_route(z, w1, w2, w3, out, n_rows, channels, r);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fwd_bf16_plan(r, plan));
}

extern "C" int distmlip_tensornet_interaction_bf16_plan(
    const __nv_bfloat16* f, const __nv_bfloat16* node_i, const __nv_bfloat16* node_a,
    const __nv_bfloat16* node_s, const __nv_bfloat16* out, int64_t n_rows, int channels,
    int64_t* plan) {
  if (channels <= 0 || n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  FwdBf16Route r;
  const cudaError_t err = interaction_bf16_route(f, node_i, node_a, node_s, out, n_rows,
                                                 channels, r);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fwd_bf16_plan(r, plan));
}
