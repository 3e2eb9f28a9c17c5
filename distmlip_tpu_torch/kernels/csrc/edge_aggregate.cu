// TensorNet's two edge aggregations: per-edge message built in registers
// and summed onto dst-sorted rows, float32, sm_90a.
//
// Replaces distmlip_tpu/kernels/segment.py::pallas_edge_aggregate (body
// _edge_aggregate_kernel, in-kernel gather _gather_rows) at TensorNet's two
// call sites (distmlip_tpu/models/tensornet.py:178 and :232). The TPU kernel
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
// torchmd-net's (E, C, 3) order (read at stride 3), node arrays and out
// (N, 3, 3, C) with a row of 9 C contiguous floats.
//
// Design. One thread owns one (dst row, channel) and the 9 matrix entries of
// it, accumulated in registers in edge order: no atomics, deterministic.
// A block holds 256 / tpr rows of tpr threads (tpr = C rounded up to a warp,
// at most 256; 4 rows of 64 at TensorNet's C = 64); grid.y walks channel
// slabs when C > 256. Every load along the channel axis is coalesced: a warp
// reads 128 contiguous bytes of Z/W or of a gathered node row (a node row of
// one array is 9 C floats, 2304 bytes at C = 64). The 18 geometric scalars
// of an embed edge and the src index of an interaction edge are the same
// address for a whole warp (one broadcast load). Two edges are loaded before
// either is added, to keep more loads in flight. The interaction's node
// arrays are gathered from global memory through L2 at every size: there is
// no staging budget, unlike the TPU's 2 MiB VMEM.
//
// What bounds it on an H100: HBM bytes. Per valid edge the embed reads
// 4 C + 18 floats once and the interaction 3 C floats of f plus 27 C
// gathered floats, which come from L2 when the dst-sorted order keeps the
// src rows of neighbouring dst rows resident (the node arrays are read from
// HBM about once; 50 MB of L2 against ~113 MB of node arrays at 16384 atoms).
//
// Semantics (those of the plain versions in kernels/edge_aggregate.py):
//   - masked edges are screened by a branch, never read and never added, so
//     non-finite padding cannot leak into a sum;
//   - every output row is written, empty rows as zeros;
//   - offsets are 64-bit; src ids of valid edges must lie in [0, N_node).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ void store_row(float* __restrict__ out, int64_t row,
                                          int channels, int c,
                                          const float (&acc)[9]) {
  float* __restrict__ dst = out + row * 9 * static_cast<int64_t>(channels) + c;
#pragma unroll
  for (int k = 0; k < 9; ++k) dst[static_cast<int64_t>(k) * channels] = acc[k];
}

// ---- embed --------------------------------------------------------------

struct EmbedEdge {
  float z, w1, w2, w3, a[9], s[9];
};

__device__ __forceinline__ void embed_load(
    EmbedEdge& v, const float* __restrict__ z, const float* __restrict__ w1,
    const float* __restrict__ w2, const float* __restrict__ w3,
    const float* __restrict__ a_e, const float* __restrict__ s_e, int64_t e,
    int channels, int c) {
  const int64_t o = e * channels + c;
  v.z = __ldg(z + o);
  v.w1 = __ldg(w1 + o);
  v.w2 = __ldg(w2 + o);
  v.w3 = __ldg(w3 + o);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    v.a[k] = __ldg(a_e + e * 9 + k);
    v.s[k] = __ldg(s_e + e * 9 + k);
  }
}

__device__ __forceinline__ void embed_add(float (&acc)[9], const EmbedEdge& v) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;  // k = 3 i + j
    acc[k] += v.z * (v.w1 * eye + v.w2 * v.a[k] + v.w3 * v.s[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
tensornet_embed_kernel(const float* __restrict__ z, const float* __restrict__ w1,
                       const float* __restrict__ w2, const float* __restrict__ w3,
                       const float* __restrict__ a_e,
                       const float* __restrict__ s_e,
                       const int64_t* __restrict__ row_ptr,
                       const uint8_t* __restrict__ mask, float* __restrict__ out,
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

// ---- interaction --------------------------------------------------------

struct InteractionEdge {
  float f[3], i[9], a[9], s[9];
};

__device__ __forceinline__ void interaction_load(
    InteractionEdge& v, const float* __restrict__ f,
    const float* __restrict__ node_i, const float* __restrict__ node_a,
    const float* __restrict__ node_s, const int32_t* __restrict__ src,
    int64_t e, int channels, int c) {
  const float* __restrict__ fe = f + e * 3 * channels + 3 * c;
  v.f[0] = __ldg(fe);
  v.f[1] = __ldg(fe + 1);
  v.f[2] = __ldg(fe + 2);
  const int64_t base = static_cast<int64_t>(__ldg(src + e)) * 9 * channels + c;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int64_t o = base + static_cast<int64_t>(k) * channels;
    v.i[k] = __ldg(node_i + o);
    v.a[k] = __ldg(node_a + o);
    v.s[k] = __ldg(node_s + o);
  }
}

__device__ __forceinline__ void interaction_add(float (&acc)[9],
                                                const InteractionEdge& v) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    acc[k] += v.f[0] * v.i[k] + v.f[1] * v.a[k] + v.f[2] * v.s[k];
  }
}

__global__ void __launch_bounds__(kThreads)
tensornet_interaction_kernel(const float* __restrict__ f,
                             const float* __restrict__ node_i,
                             const float* __restrict__ node_a,
                             const float* __restrict__ node_s,
                             const int32_t* __restrict__ src,
                             const int64_t* __restrict__ row_ptr,
                             const uint8_t* __restrict__ mask,
                             float* __restrict__ out, int64_t n_rows,
                             int channels, int tpr) {
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
    InteractionEdge v0, v1;
    if (m0) interaction_load(v0, f, node_i, node_a, node_s, src, e, channels, c);
    if (m1) interaction_load(v1, f, node_i, node_a, node_s, src, e + 1, channels, c);
    if (m0) interaction_add(acc, v0);
    if (m1) interaction_add(acc, v1);
  }
  if (e < e1 && valid_edge(mask, e)) {
    InteractionEdge v;
    interaction_load(v, f, node_i, node_a, node_s, src, e, channels, c);
    interaction_add(acc, v);
  }
  store_row(out, row, channels, c, acc);
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

}  // namespace

// z, w1, w2, w3 (E, C); a_e, s_e (E, 9); row_ptr (n_rows + 1) int64; mask
// (E) bytes or null; out (n_rows, 9, C). float32, contiguous, on the current
// device. Launches on `stream`, does not synchronise, and returns the
// launch's cudaError_t (0 = success).
extern "C" int distmlip_tensornet_embed_f32(
    const float* z, const float* w1, const float* w2, const float* w3,
    const float* a_e, const float* s_e, const int64_t* row_ptr,
    const uint8_t* mask, float* out, int64_t n_rows, int channels,
    void* stream) {
  dim3 grid;
  int tpr;
  const int shape = launch_shape(n_rows, channels, grid, tpr);
  if (shape < 0) return 0;
  if (shape > 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  tensornet_embed_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      z, w1, w2, w3, a_e, s_e, row_ptr, mask, out, n_rows, channels, tpr);
  return static_cast<int>(cudaGetLastError());
}

// f (E, C, 3); node_i, node_a, node_s (N_node, 9, C); src (E) int32;
// row_ptr (n_rows + 1) int64; mask (E) bytes or null; out (n_rows, 9, C).
// float32, contiguous, on the current device. Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t (0 = success).
extern "C" int distmlip_tensornet_interaction_f32(
    const float* f, const float* node_i, const float* node_a,
    const float* node_s, const int32_t* src, const int64_t* row_ptr,
    const uint8_t* mask, float* out, int64_t n_rows, int channels,
    void* stream) {
  dim3 grid;
  int tpr;
  const int shape = launch_shape(n_rows, channels, grid, tpr);
  if (shape < 0) return 0;
  if (shape > 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  tensornet_interaction_kernel<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      f, node_i, node_a, node_s, src, row_ptr, mask, out, n_rows, channels, tpr);
  return static_cast<int>(cudaGetLastError());
}
