// SO(2) convolution of eSCN on per-|m| coefficient blocks, float32 in and
// out, on the H100's tensor cores (sm_90a).
//
// Replaces distmlip_tpu/kernels/so3.py:89 so2_conv_pallas (body _so2_kernel).
// Per edge, with f the (nl * C)-flattened coefficient block of one |m|:
//   m = 0:  y0 = f0 W0
//   m > 0:  y+ = f+ Wr - f- Wi,   y- = f+ Wi + f- Wr
// In the packed per-m row order ([m=0 | m=1 plus | m=1 minus | ...]) the
// plus and minus blocks of one |m| are adjacent, so each m > 0 is ONE
// product of contraction 2d: [f+ | f-] B with B = [[Wr, Wi], [-Wi, Wr]].
// The whole convolution is the (E, S*C) rows times a block-diagonal matrix
// of one square block per |m| (widths d0, 2d1, 2d2, ...). The backward's
// input cotangent is the same function on the transposed blocks, so the
// dispatcher launches this kernel for it too, with the other packed buffer.
//
// What bounds it on an H100: operations. Per edge row the products cost
// 2 sum_m width_m^2 FLOP (4,751,360 at l_max 4, C 128) against 2 x 12.8 KB
// of row traffic. float32 FMAs in the CUDA cores top out at 67 TFLOP/s
// (2.324 ms for the 155.7 GFLOP of a (32768, 25, 128) chunk), which is why
// the first version of this kernel could not beat cuBLAS's SGEMM.
//
// The tensor cores run TF32 (10 explicit mantissa bits) at 495 TFLOP/s.
// To stay float32-exact each operand is split, x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi), and each product is taken as
// a_hi b_hi + a_hi b_lo + a_lo b_hi (3xTF32): the dropped a_lo b_lo and the
// lo parts' own rounding stay within ~3 * 2^-22 |ab|, products of TF32
// values are exact in fp32, and the sums accumulate in fp32
// (kernels/so3.py so2_conv_error_bound derives the tolerance). Three
// products per float32 product bound a chunk at 3 x 155.7e9 / 495e12 =
// 0.944 ms; the row traffic (0.84 GB) is 0.252 ms, so operations still
// bound it.
//
// Design (one block of 3 consumer warpgroups + 1 producer warp per SM):
// - wgmma.mma_async m64n128k8 .f32.tf32.tf32, fp32 accumulators in
//   registers: each consumer warpgroup owns 64 edge rows x 128 output
//   columns (64 accumulators a thread), the block 192 x 128. A (the edge
//   rows) enters wgmma from registers, split into hi and lo there
//   (cvt.rna.tf32.f32); B comes from shared memory, where TF32 requires it
//   K-major.
// - B is packed once per layer on the device (so3.py pack_so2_weights):
//   per segment the K-major block B^T split into hi and lo halves, each
//   zero-padded to whole 128 x 32 tiles with its own TMA tensor map.
//   The explicit blocks are 9.5 MB per layer at l_max 4, C 128 (19 MB with
//   hi and lo) and stay in the 50 MB L2.
// - The producer warp keeps a ring of 4 stages (32 contraction entries,
//   56 KB each) full, up to 4 slices ahead: per stage one TMA box of B's hi
//   and of its lo (128-byte swizzle, as the wgmma descriptor reads it) and
//   A's 192 x 32 entries, all completing on the stage's `full` mbarrier.
//   A comes as one TMA box of a 3D map over h's (C, S, E) when C % 32 == 0
//   (the coefficient row from the `rows` table in the coordinate, rows past
//   E zero-filled); for other C the producer copies it with cp.async
//   (16 bytes a copy when C % 4 == 0, else 4, zero-filled past E and past
//   the width) into the same swizzled layout. So any E >= 1 and any C are
//   taken, and the caller's (e3nn) row order is read and written in place
//   with no permuted copy.
// - Consumers wait only on `full`, and each warp arrives on the stage's
//   `empty` mbarrier when its wgmma is done; only the producer waits on
//   `empty`. No block-wide barrier after the set-up, so the three
//   warpgroups drift apart and one's fragment loads, waits and epilogue
//   overlap the others' products. (Loads issued by the consumer threads
//   and a block-wide wait per slice kept an earlier version far from the
//   bound.)
// - Schedule: blockIdx.x walks (segment, 128-column tile), blockIdx.y the
//   192-row edge tiles. x is the fast axis, so the 25 column tiles of one
//   row tile (at l_max 4, C 128) run together: the A rows are read from
//   HBM once and served from L2 to the others.
// - The output is written from the accumulators, two adjacent columns a
//   store, through the row table; rows past E and columns past a segment's
//   width are masked, and every output element is written exactly once.
// - ptxas (-Xptxas -v, CUDA 12.8): 128 registers, no spills; 230,660 bytes
//   of dynamic shared memory.
//
// bfloat16 (so2_conv_bf16_kernel, distmlip_so2_conv_bf16; the models'
// compute_dtype="bfloat16"): h, the weights and the output in bf16, as the
// Pallas body takes its operands in h's dtype with
// preferred_element_type=f32 (so3.py:133-150). bf16 products are exact in
// fp32, so no split: ONE wgmma.mma_async m64n256k16 .f32.bf16.bf16 per 16
// contraction entries, the same plus/minus block products, fp32
// accumulators, and each output rounded to bf16 once. The packed weights
// are one bf16 buffer (no hi/lo, B^T K-major per segment, rows padded to 64
// entries), 4.75 MB a layer at l_max 4, C 128.
//
// What bounds it: operations, 155.7 GFLOP a (32768, 25, 128) chunk at 989
// TFLOP/s, 0.157 ms (its 0.42 GB of rows at 3.35 TB/s: 0.125 ms). Every
// output tile reads its A rows (the edge rows) and its B block (the
// weights) from L2 into shared memory, A once per column tile and B once
// per row tile. A 192 x 128 tile moves 2.03 GB a chunk that way, 77 FLOP
// a byte: at the tensor cores' rate that wants ~13 TB/s out of L2, and
// that, with a wgmma group waited on every stage and short blocks whose
// set-up nothing overlapped, held the first bf16 design at 0.48 ms.
// Design (so3.py so2_bf16_plan and so2_bf16_l2_bytes give the plan and its
// traffic):
// - a 128 x 256 output tile: two consumer warpgroups of 64 edge rows, each
//   ONE m64n256k16 a k step with A and B both from shared memory by
//   descriptor (K-major, 128-byte swizzle), 128 fp32 accumulators a
//   thread. A producer warpgroup (one warp of it loads) gives its
//   registers to the consumers by setmaxnreg, 40 against 232 a thread:
//   ptxas allots whole warpgroups, so a block of 2 warpgroups and a
//   producer warp got 168 registers a thread and spilled.
//   At (32768, 25, 128) the tile moves A 0.63 GB (once per 256-column
//   tile) + B 1.22 GB (once per 128 edge rows) = 1.85 GB, 84 FLOP a byte.
// - a persistent grid, one block per SM, walking (row tile, segment,
//   column tile) with the stage ring running on across tiles, so the
//   producer loads the next tile while the consumers finish this one.
//   Consecutive blocks share a row tile: its A rows come from HBM once and
//   from L2 after.
// - one wgmma group in flight: stage kt - 1 is released to the producer
//   once kt is issued (wait_group 1).
// - a staged epilogue: each warpgroup rounds its 64 x 256 block to bf16
//   into a swizzled 64 x 128 shared tile, twice, and writes it out through
//   the row table as 16-byte stores of 8 channels (C % 8 == 0: a warp
//   writes two 256-byte runs of one coefficient row), one element a store
//   for any other C.
// - m = 0 at l_max 4, C 128 is 640 wide: its third column tile is half
//   zero columns (TMA fills past the block with zeros), 3.3% of a chunk's
//   products.
// What holds it now is not settled: each k step lands 48 KB (A 16 KB,
// B 32 KB) in the block's shared memory, the ring holds 4 such stages
// (what 227 KB holds beside the staging tiles), and the whole call fills
// shared memory from L2 at ~6.7 TB/s (chip_smoke.py prints the rate;
// PERF.md gives the times). Two-block clusters sharing the B box by TMA
// multicast cut what L2 serves (1.24 GB) but not what lands in each SM,
// and measured no faster, so the kernel runs without clusters.
// A reaches shared memory as one TMA box (C % 64 == 0), by 16-byte cp.async
// (C % 8 == 0) or element by element (any other C), in the swizzled layout
// the descriptor reads. Every barrier wait of this kernel traps after ~2^34
// cycles, so a pipeline fault ends the launch with an error instead of
// holding the card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWGs = 3;                      // warpgroups of 64 edge rows each
constexpr int kBM = 64 * kConsumerWGs;               // edge rows per block
constexpr int kBN = 128;                             // output columns per block
constexpr int kBK = 32;                              // contraction entries per stage: 128 bytes
constexpr int kStages = 4;
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 32;            // + one producer warp
constexpr int kMaxSeg = 7;                           // |m| = 0..6
constexpr int kMaxRows = 49;                         // S at l_max = 6
constexpr int kBTileBytes = kBN * kBK * 4;           // one of hi, lo: 16 KB
constexpr int kBStageBytes = 2 * kBTileBytes;
constexpr int kAStageBytes = kBM * kBK * 4;
constexpr int kSmemBytes =
    1024 + kStages * (kBStageBytes + kAStageBytes) + 2 * kStages * 8 + kMaxRows * 4;

// How the edge rows reach shared memory: a TMA box when C % 32 == 0 (the
// 32 entries of a slice then lie in one coefficient row), else cp.async
// from the producer warp, 16 bytes a copy when C % 4 == 0, else 4.
enum AMode { kATma = 0, kACopy16 = 1, kACopy4 = 2 };

struct Segment {
  int width;  // contraction length = output width: d or 2d
  int row0;   // first packed row of the segment
  int tile0;  // first column tile of the segment along blockIdx.x
};

struct Params {
  CUtensorMap maps[2 * kMaxSeg];  // per segment: its packed hi block, then its lo block
  CUtensorMap h_map;              // h as (C, S, E), for kATma
  const float* h;
  float* out;
  int64_t e;  // edge rows
  int s;      // coefficient rows per edge
  int c;      // channels
  int n_seg;
  Segment seg[kMaxSeg];
  int rows[kMaxRows];  // packed row -> row of h and out
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Arrives on `bar` once every cp.async this thread issued so far has landed
// (counted in the barrier's initial count: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One TMA box of the packed weights: x along K, y along the rows.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// One TMA box of h: x the channel, y the coefficient row, z the edge.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// cp.async with zero fill: `live` false copies no bytes and writes zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

// Round to TF32, nearest with ties away from zero (so3.py tf32_round).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Float offset of entry (r, k) of a 128-byte-swizzled tile of 32-float
// rows, as TMA writes it: the 16-byte chunk index XOR the row mod 8.
__device__ __forceinline__ int swz(int r, int k) {
  return r * kBK + ((((k >> 2) ^ (r & 7))) << 2) + (k & 3);
}

// Descriptor of a K-major 128 x 32 float32 tile stored with the 128-byte
// swizzle (as TMA writes it): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 fp32, this warpgroup's) += A (64 x 8 TF32, registers) B (from
// shared memory through `desc`, 8 x 128 K-major TF32).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int AMODE>
__global__ void __launch_bounds__(kThreads, 1)
so2_conv_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* b_ring = smem;  // kStages x [hi | lo]
  float* a_ring = reinterpret_cast<float*>(smem + kStages * kBStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * (kBStageBytes + kAStageBytes));
  uint64_t* empty = full + kStages;
  int* s_rows = reinterpret_cast<int*>(empty + kStages);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid < p.s) s_rows[tid] = p.rows[tid];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 33);                 // the producer's 32 lanes + its TMA bytes
      mbar_init(&empty[i], kConsumers / 32);   // every consumer warp done with the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  int si = 0;
  while (si + 1 < p.n_seg && static_cast<int>(blockIdx.x) >= p.seg[si + 1].tile0) ++si;
  const Segment sg = p.seg[si];
  const int c = p.c;
  const int width = sg.width;
  const int n0 = (static_cast<int>(blockIdx.x) - sg.tile0) * kBN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t ld = static_cast<int64_t>(p.s) * c;  // floats per edge row
  const int nk = (width + kBK - 1) / kBK;
  __syncthreads();  // s_rows and the barriers are ready; the roles part here for good

  if (warp == kConsumers / 32) {
    // ---- producer warp: keeps the ring full, kStages slices ahead ----
    for (int kt = 0; kt < nk; ++kt) {
      const int stage = kt % kStages;
      if (kt >= kStages) mbar_wait(&empty[stage], (kt / kStages - 1) & 1);
      const int k0 = kt * kBK;
      uint64_t* bar = &full[stage];
      float* as = a_ring + stage * (kBM * kBK);
      if (lane == 0) {
        uint8_t* bs = b_ring + stage * kBStageBytes;
        mbar_expect_tx(bar, kBStageBytes + (AMODE == kATma ? kAStageBytes : 0));
        tma_load_2d(bs, &p.maps[2 * si], bar, k0, n0);
        tma_load_2d(bs + kBTileBytes, &p.maps[2 * si + 1], bar, k0, n0);
        if constexpr (AMODE == kATma) {
          tma_load_3d(as, &p.h_map, bar, k0 % c, s_rows[sg.row0 + k0 / c],
                      static_cast<int>(m0));
        }
      }
      if constexpr (AMODE == kACopy16) {
        for (int chunk = lane; chunk < kBM * kBK / 4; chunk += 32) {
          const int r = chunk >> 3;
          const int kc = (chunk & 7) * 4;
          const int k = k0 + kc;
          const bool live = m0 + r < p.e && k < width;
          const float* src = live ? p.h + (m0 + r) * ld +
                                        static_cast<int64_t>(s_rows[sg.row0 + k / c]) * c + k % c
                                  : p.h;
          cp_async16(as + swz(r, kc), src, live);
        }
      } else if constexpr (AMODE == kACopy4) {
        for (int idx = lane; idx < kBM * kBK; idx += 32) {
          const int r = idx >> 5;
          const int kk = idx & 31;
          const int k = k0 + kk;
          const bool live = m0 + r < p.e && k < width;
          const float* src = live ? p.h + (m0 + r) * ld +
                                        static_cast<int64_t>(s_rows[sg.row0 + k / c]) * c + k % c
                                  : p.h;
          cp_async4(as + swz(r, kk), src, live);
        }
      }
      cp_async_arrive(bar);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // ---- consumer warpgroups: 64 edge rows x 128 columns each ----
  // fragment coordinates (wgmma's TF32 A layout, as mma.m16n8k8's per
  // warp): rows fr and fr + 8, columns fc and fc + 4 of each k step
  const int fr = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  const int fc = lane & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt % kStages;
    mbar_wait(&full[stage], (kt / kStages) & 1);
    const float* as = a_ring + stage * (kBM * kBK);
    uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = as[swz(fr + (q & 1) * 8, j * 8 + fc + (q >> 1) * 4)];
        const uint32_t hi = to_tf32(x);
        a_hi[j][q] = hi;
        a_lo[j][q] = to_tf32(x - __uint_as_float(hi));
      }
    }
    const uint8_t* bs = b_ring + stage * kBStageBytes;
    const uint64_t d_hi = sw128_desc(bs);
    const uint64_t d_lo = sw128_desc(bs + kBTileBytes);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // k steps of 8 entries = 32 bytes = 2 descriptor units
      wgmma_tf32(acc, a_hi[j], d_hi + 2 * j);
      wgmma_tf32(acc, a_hi[j], d_lo + 2 * j);
      wgmma_tf32(acc, a_lo[j], d_hi + 2 * j);
    }
    wgmma_commit();
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }
  fence_acc(acc);

  // accumulator j*4 + {0, 1, 2, 3}: (row fr, columns 8j + 2fc, +1) and
  // (row fr + 8, the same columns)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t edge = m0 + fr + half * 8;
    if (edge >= p.e) continue;
    float* __restrict__ out_row = p.out + edge * ld;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + j * 8 + 2 * fc;
      const float v0 = acc[j * 4 + half * 2];
      const float v1 = acc[j * 4 + half * 2 + 1];
      if constexpr (AMODE != kACopy4) {  // C even: columns n, n + 1 share a row
        if (n < width) {
          float* dst = out_row + static_cast<int64_t>(s_rows[sg.row0 + n / c]) * c + n % c;
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        }
      } else {
        if (n < width) out_row[static_cast<int64_t>(s_rows[sg.row0 + n / c]) * c + n % c] = v0;
        if (n + 1 < width) {
          out_row[static_cast<int64_t>(s_rows[sg.row0 + (n + 1) / c]) * c + (n + 1) % c] = v1;
        }
      }
    }
  }
}

// ---- bfloat16: persistent 128 x 256 tiles ----

constexpr int kBM16 = 128;                         // edge rows a tile: two warpgroups of 64
constexpr int kBN16 = 256;                         // output columns a tile: one m64n256k16
constexpr int kBK16 = 64;                          // bf16 entries a stage: 128 bytes
constexpr int kStages16 = 4;
constexpr int kConsumers16 = 256;                  // two consumer warpgroups
constexpr int kThreads16 = kConsumers16 + 128;     // + a producer warpgroup
constexpr int kProducerRegs16 = 40;                // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs16 = 232;               // <= 65,536 registers of the SM
constexpr int kBBox16 = 64;                        // B rows a TMA box: 8 KB
constexpr int kBStageBytes16 = kBN16 * kBK16 * 2;  // 32 KB
constexpr int kAStageBytes16 = kBM16 * kBK16 * 2;  // 16 KB
constexpr int kOutCols16 = 128;                    // columns an epilogue pass stages
constexpr int kOutBytes16 = 64 * kOutCols16 * 2;   // a warpgroup's staging tile: 16 KB
constexpr int kSmemBytes16 = 1024 + kStages16 * (kBStageBytes16 + kAStageBytes16) +
                             2 * kOutBytes16 + 2 * kStages16 * 8 + kMaxRows * 4;

// How the bf16 edge rows reach shared memory: a TMA box when C % 64 == 0,
// 16-byte cp.async when C % 8 == 0, else element by element from the
// producer warp (plain loads and shared stores, released by its arrival).
enum ABf16Mode { kBfTma = 0, kBfCopy16 = 1, kBfCopy2 = 2 };

struct ParamsBf16 {
  CUtensorMap maps[kMaxSeg];  // per segment: its packed bf16 block
  CUtensorMap h_map;          // h as (C, S, E), for kBfTma
  const uint16_t* h;          // bf16 bit patterns
  uint16_t* out;
  int64_t e;
  int64_t tiles;   // (row tile, column tile) pairs the grid walks
  int s;
  int c;
  int n_seg;
  int col_tiles;   // 256-column tiles over all segments
  Segment seg[kMaxSeg];  // tile0 counts 256-column tiles
  int rows[kMaxRows];
};

// Entry offset of (r, k) of a 128-byte-swizzled tile of 64-entry bf16 rows,
// as TMA writes it: the 16-byte chunk index XOR the row mod 8.
__device__ __forceinline__ int swz16(int r, int k) {
  return r * kBK16 + ((((k >> 3) ^ (r & 7))) << 3) + (k & 7);
}

// The 128 threads of consumer warpgroup wg (named barriers 1 and 2).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// Waits for the phase of `bar` with the given parity; traps after ~2^34
// cycles.
__device__ __forceinline__ void mbar_wait_bf16(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// Orders this thread's shared-memory accesses through the generic proxy
// (plain stores, cp.async) with those of the async proxy (wgmma's operand
// reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Hands registers back to (dec) or takes them from (inc) the SM's pool:
// every warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

__device__ __forceinline__ void fence_acc128(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 fp32, this warpgroup's) = A (64 x 16 bf16) B (16 x 256 bf16)
// + (accumulate ? d : 0), A and B from shared memory by descriptor (K-major,
// 128-byte swizzle).
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "
      "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Tile t of the walk: its segment, first column, stage count and first
// edge row.
struct TileBf16 {
  int si;
  int n0;
  int nk;
  int64_t m0;
};

__device__ __forceinline__ TileBf16 tile_bf16(const ParamsBf16& p, int64_t t) {
  const int64_t row_tile = t / p.col_tiles;
  const int ct = static_cast<int>(t - row_tile * p.col_tiles);
  int si = 0;
  while (si + 1 < p.n_seg && ct >= p.seg[si + 1].tile0) ++si;
  TileBf16 tl;
  tl.si = si;
  tl.n0 = (ct - p.seg[si].tile0) * kBN16;
  tl.nk = (p.seg[si].width + kBK16 - 1) / kBK16;
  tl.m0 = row_tile * kBM16;
  return tl;
}

// A consumer warp is done reading a stage: one arrival on its `empty`
// barrier.
__device__ __forceinline__ void release_stage(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <int AMODE>
__global__ void __launch_bounds__(kThreads16, 1)
so2_conv_bf16_kernel(const __grid_constant__ ParamsBf16 p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* b_ring = smem;  // kStages16 x 256 B rows
  uint16_t* a_ring = reinterpret_cast<uint16_t*>(smem + kStages16 * kBStageBytes16);
  uint16_t* out_tiles =
      reinterpret_cast<uint16_t*>(smem + kStages16 * (kBStageBytes16 + kAStageBytes16));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kStages16 * (kBStageBytes16 + kAStageBytes16) + 2 * kOutBytes16);
  uint64_t* empty = full + kStages16;
  int* s_rows = reinterpret_cast<int*>(empty + kStages16);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid < p.s) s_rows[tid] = p.rows[tid];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages16; ++i) {
      mbar_init(&full[i], 33);                       // the producer's 32 lanes + its TMA bytes
      mbar_init(&empty[i], kConsumers16 / 32);      // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // s_rows and the barriers are ready; the roles part here
  const int c = p.c;
  const int64_t ld = static_cast<int64_t>(p.s) * c;  // entries per edge row
  const int64_t first = blockIdx.x;
  const int64_t step = gridDim.x;

  if (warp >= kConsumers16 / 32) {
    setmaxnreg_dec<kProducerRegs16>();
  }
  if (warp == kConsumers16 / 32) {
    // ---- producer warp: keeps the ring full, on across tiles ----
    uint32_t it = 0;
    for (int64_t t = first; t < p.tiles; t += step) {
      const TileBf16 tl = tile_bf16(p, t);
      const Segment sg = p.seg[tl.si];
      for (int kt = 0; kt < tl.nk; ++kt, ++it) {
        const int stage = it % kStages16;
        if (it >= kStages16) mbar_wait_bf16(&empty[stage], (it / kStages16 - 1) & 1);
        const int k0 = kt * kBK16;
        uint64_t* bar = &full[stage];
        uint16_t* as = a_ring + stage * (kBM16 * kBK16);
        if (lane == 0) {
          uint8_t* bs = b_ring + stage * kBStageBytes16;
          mbar_expect_tx(bar, kBStageBytes16 + (AMODE == kBfTma ? kAStageBytes16 : 0));
          for (int part = 0; part < kBN16 / kBBox16; ++part) {  // the B box in 64-row parts
            tma_load_2d(bs + part * (kBBox16 * kBK16 * 2), &p.maps[tl.si], bar, k0,
                        tl.n0 + part * kBBox16);
          }
          if constexpr (AMODE == kBfTma) {
            tma_load_3d(as, &p.h_map, bar, k0 % c, s_rows[sg.row0 + k0 / c],
                        static_cast<int>(tl.m0));
          }
        }
        if constexpr (AMODE == kBfCopy16) {
          for (int chunk = lane; chunk < kBM16 * kBK16 / 8; chunk += 32) {
            const int r = chunk >> 3;
            const int kc = (chunk & 7) * 8;
            const int k = k0 + kc;
            const bool live = tl.m0 + r < p.e && k < sg.width;
            const uint16_t* src = live ? p.h + (tl.m0 + r) * ld +
                                             static_cast<int64_t>(s_rows[sg.row0 + k / c]) * c +
                                             k % c
                                       : p.h;
            cp_async16(reinterpret_cast<float*>(as + swz16(r, kc)),
                       reinterpret_cast<const float*>(src), live);
          }
          cp_async_arrive(bar);
        } else if constexpr (AMODE == kBfCopy2) {
          for (int idx = lane; idx < kBM16 * kBK16; idx += 32) {
            const int r = idx >> 6;
            const int kk = idx & 63;
            const int k = k0 + kk;
            const bool live = tl.m0 + r < p.e && k < sg.width;
            as[swz16(r, kk)] =
                live ? p.h[(tl.m0 + r) * ld +
                           static_cast<int64_t>(s_rows[sg.row0 + k / c]) * c + k % c]
                     : uint16_t{0};
          }
          fence_proxy_async();  // the stores above, for the consumers' wgmma
          mbar_arrive(bar);     // release: the stores above are seen by the consumers' wait
        } else {
          cp_async_arrive(bar);
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else if (warp < kConsumers16 / 32) {
    // ---- consumer warpgroups: 64 edge rows x 256 columns each ----
    setmaxnreg_inc<kConsumerRegs16>();
    // accumulator j*4 + {0, 1}: (row fr, columns 8j + 2fc, +1); j*4 + {2, 3}:
    // (row fr + 8, the same columns), rows of the warpgroup's 64
    const int wg = warp >> 2;
    const int fr = (warp & 3) * 16 + (lane >> 2);
    const int fc = lane & 3;
    const int wtid = tid & 127;
    uint16_t* ot = out_tiles + wg * (64 * kOutCols16);
    float acc[128];
    uint32_t it = 0;
    for (int64_t t = first; t < p.tiles; t += step) {
      const TileBf16 tl = tile_bf16(p, t);
      const Segment sg = p.seg[tl.si];
      int held = -1;  // the stage whose wgmma group may still be in flight
      for (int kt = 0; kt < tl.nk; ++kt, ++it) {
        const int stage = it % kStages16;
        mbar_wait_bf16(&full[stage], (it / kStages16) & 1);
        if constexpr (AMODE != kBfTma) fence_proxy_async();  // A came through the generic proxy
        const uint64_t da = sw128_desc(a_ring + stage * (kBM16 * kBK16) + wg * 64 * kBK16);
        const uint64_t db = sw128_desc(b_ring + stage * kBStageBytes16);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBK16 / 16; ++j) {  // 16 entries = 32 bytes = 2 descriptor units
          wgmma_bf16_ss(acc, da + 2 * j, db + 2 * j, kt > 0 || j > 0);
        }
        wgmma_commit();
        wgmma_wait_one();  // stage kt - 1's products are done
        if (held >= 0) release_stage(&empty[held], lane);
        held = stage;
      }
      wgmma_wait_all();
      release_stage(&empty[held], lane);
      fence_acc128(acc);

      // epilogue: 128 columns at a time through the warpgroup's staging
      // tile (16-byte chunks XOR-swizzled by the row: conflict-free both ways)
      const int64_t e0 = tl.m0 + wg * 64;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int j = 0; j < kOutCols16 / 8; ++j) {
          const int a = (half * (kOutCols16 / 8) + j) * 4;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int r = fr + 8 * rr;
            *reinterpret_cast<uint32_t*>(ot + r * kOutCols16 + ((j ^ (r & 7)) << 3) + 2 * fc) =
                pack_bf16x2(acc[a + 2 * rr], acc[a + 2 * rr + 1]);
          }
        }
        warpgroup_sync(wg);
        const int nb = tl.n0 + half * kOutCols16;
        if constexpr (AMODE != kBfCopy2) {  // C % 8 == 0: 8 channels of one row a chunk
          // a thread's chunk (its 8 columns, their coefficient row and
          // offset) is the same in each of its 8 rows, 8 apart
          const int chunk = wtid & 15;
          const int n = nb + 8 * chunk;
          if (n < sg.width) {
            const int64_t col = static_cast<int64_t>(s_rows[sg.row0 + n / c]) * c + n % c;
            const uint16_t* src = ot + (wtid >> 4) * kOutCols16 + ((chunk ^ ((wtid >> 4) & 7)) << 3);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int r = (wtid >> 4) + 8 * i;
              if (e0 + r < p.e) {
                *reinterpret_cast<uint4*>(p.out + (e0 + r) * ld + col) =
                    *reinterpret_cast<const uint4*>(src + 8 * i * kOutCols16);
              }
            }
          }
        } else {
          for (int i = 0; i < 64 * kOutCols16 / 128; ++i) {
            const int idx = wtid + 128 * i;
            const int r = idx >> 7;
            const int col = idx & 127;
            const int n = nb + col;
            if (e0 + r < p.e && n < sg.width) {
              p.out[(e0 + r) * ld + static_cast<int64_t>(s_rows[sg.row0 + n / c]) * c + n % c] =
                  ot[r * kOutCols16 + (((col >> 3) ^ (r & 7)) << 3) + (col & 7)];
            }
          }
        }
        warpgroup_sync(wg);  // the staging tile is free again
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API: reached through the runtime's
// entry-point query, so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status{};
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// The bf16 launch plan: the A mode, the walk's tiles and the persistent
// grid's blocks (one an SM) on the current device.
struct PlanBf16 {
  int amode;
  int sms;
  int col_tiles;
  int64_t row_tiles;
  int64_t tiles;
  int64_t blocks;
};

int plan_bf16(int64_t e, int c, int n_seg, const int* seg_m, const int* seg_nl, int vec,
              PlanBf16* plan) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&plan->sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  plan->amode = c % 64 == 0 && vec == 8 ? kBfTma : vec == 8 ? kBfCopy16 : kBfCopy2;
  plan->col_tiles = 0;
  for (int i = 0; i < n_seg; ++i) {
    const int width = seg_nl[i] * c * (seg_m[i] == 0 ? 1 : 2);
    plan->col_tiles += (width + kBN16 - 1) / kBN16;
  }
  plan->row_tiles = (e + kBM16 - 1) / kBM16;
  plan->tiles = plan->row_tiles * plan->col_tiles;
  plan->blocks = plan->tiles < plan->sms ? plan->tiles : plan->sms;
  return 0;
}

template <int AMODE>
cudaError_t run_bf16(const ParamsBf16& p, const PlanBf16& plan, cudaStream_t st) {
  auto kernel = so2_conv_bf16_kernel<AMODE>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes16);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(plan.blocks), kThreads16, kSmemBytes16, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// h, out: (e, s, c) float32 contiguous on the current device. Segments in
// packed order: seg_m[i] = |m|, seg_row0[i] its first packed row, seg_nl[i]
// its l count (m > 0 segments span 2 nl rows). packed: the (2, total)
// buffer of so3.py pack_so2_weights, hi then lo; segment i's block at float
// offset block_off[i] of each, (npad, kpad) row-major with npad = width
// rounded up to 128 and kpad = width rounded up to 32, holding B^T
// (K-major) in TF32 parts, zero past the width. rows: the packed row ->
// row of h/out map (host array of s ints). vec == 4 requires c % 4 == 0
// and 16-byte aligned h and out. Launches on `stream` and returns the
// launch's cudaError_t (0 = success), -1 when the driver has no
// cuTensorMapEncodeTiled, -2 when it refuses a tensor map; it does not
// synchronise.
extern "C" int distmlip_so2_conv_f32(const float* h, float* out, int64_t e, int s, int c,
                                     int n_seg, const int* seg_m, const int* seg_row0,
                                     const int* seg_nl, const float* packed, int64_t total,
                                     const int64_t* block_off, const int* rows, int vec,
                                     void* stream) {
  if (e <= 0) return 0;
  if (n_seg < 1 || n_seg > kMaxSeg || s < 1 || s > kMaxRows || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  Params p = {};
  p.h = h;
  p.out = out;
  p.e = e;
  p.s = s;
  p.c = c;
  p.n_seg = n_seg;
  int tiles = 0;
  for (int i = 0; i < n_seg; ++i) {
    Segment& sg = p.seg[i];
    sg.width = seg_nl[i] * c * (seg_m[i] == 0 ? 1 : 2);
    const int npad = (sg.width + kBN - 1) / kBN * kBN;
    const int kpad = (sg.width + kBK - 1) / kBK * kBK;
    sg.row0 = seg_row0[i];
    sg.tile0 = tiles;
    tiles += npad / kBN;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kpad), static_cast<cuuint64_t>(npad)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kpad) * 4};
    const cuuint32_t box[2] = {kBK, kBN};
    const cuuint32_t elem_strides[2] = {1, 1};
    for (int part = 0; part < 2; ++part) {  // hi, lo
      const CUresult r = encode(&p.maps[2 * i + part], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                                const_cast<float*>(packed + part * total + block_off[i]), dims,
                                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) return -2;
    }
  }
  const int amode = c % 32 == 0 && vec == 4 ? kATma : vec == 4 ? kACopy16 : kACopy4;
  if (amode == kATma) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(s),
                                static_cast<cuuint64_t>(e)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(c) * 4,
                                   static_cast<cuuint64_t>(s) * c * 4};
    const cuuint32_t box[3] = {kBK, 1, kBM};
    const cuuint32_t elem_strides[3] = {1, 1, 1};
    const CUresult r = encode(&p.h_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                              const_cast<float*>(h), dims, strides, box, elem_strides,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -2;
  }
  for (int i = 0; i < s; ++i) p.rows[i] = rows[i];
  const int64_t row_tiles = (e + kBM - 1) / kBM;
  if (row_tiles > 65535 || tiles < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(row_tiles));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = amode == kATma      ? so2_conv_kernel<kATma>
                : amode == kACopy16 ? so2_conv_kernel<kACopy16>
                                    : so2_conv_kernel<kACopy4>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, kThreads, kSmemBytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The same convolution in bfloat16: h, out (e, s, c) bf16 contiguous on the
// current device; packed: the (1, total) bf16 buffer of so3.py
// pack_so2_weights(dtype=bfloat16), segment i's block at entry offset
// block_off[i], (npad, kpad) row-major with npad = width rounded up to 128
// and kpad = width rounded up to 64, holding B^T (K-major), zero past the
// width. vec == 8 requires c % 8 == 0 and 16-byte aligned h and out. The
// launch chooses its plan (distmlip_so2_conv_bf16_plan). The other
// arguments and the return codes are distmlip_so2_conv_f32's.
extern "C" int distmlip_so2_conv_bf16(const void* h, void* out, int64_t e, int s, int c,
                                      int n_seg, const int* seg_m, const int* seg_row0,
                                      const int* seg_nl, const void* packed,
                                      const int64_t* block_off, const int* rows, int vec,
                                      void* stream) {
  if (e <= 0) return 0;
  if (n_seg < 1 || n_seg > kMaxSeg || s < 1 || s > kMaxRows || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  PlanBf16 plan = {};
  const int err = plan_bf16(e, c, n_seg, seg_m, seg_nl, vec, &plan);
  if (err != 0) return err;
  if (plan.row_tiles > 2147483647LL / kBM16 - 2) return static_cast<int>(cudaErrorInvalidValue);
  ParamsBf16 p = {};
  p.h = static_cast<const uint16_t*>(h);
  p.out = static_cast<uint16_t*>(out);
  p.e = e;
  p.tiles = plan.tiles;
  p.s = s;
  p.c = c;
  p.n_seg = n_seg;
  p.col_tiles = plan.col_tiles;
  const uint16_t* w = static_cast<const uint16_t*>(packed);
  int tiles = 0;
  for (int i = 0; i < n_seg; ++i) {
    Segment& sg = p.seg[i];
    sg.width = seg_nl[i] * c * (seg_m[i] == 0 ? 1 : 2);
    const int npad = (sg.width + 127) / 128 * 128;
    const int kpad = (sg.width + kBK16 - 1) / kBK16 * kBK16;
    sg.row0 = seg_row0[i];
    sg.tile0 = tiles;
    tiles += (sg.width + kBN16 - 1) / kBN16;
    // boxes of 64 rows: a 256-column tile takes four (rows past npad read as zeros)
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kpad), static_cast<cuuint64_t>(npad)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kpad) * 2};
    const cuuint32_t box[2] = {kBK16, kBBox16};
    const cuuint32_t elem_strides[2] = {1, 1};
    const CUresult r = encode(&p.maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                              const_cast<uint16_t*>(w + block_off[i]), dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -2;
  }
  if (plan.amode == kBfTma) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(s),
                                static_cast<cuuint64_t>(e)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(c) * 2,
                                   static_cast<cuuint64_t>(s) * c * 2};
    const cuuint32_t box[3] = {kBK16, 1, kBM16};
    const cuuint32_t elem_strides[3] = {1, 1, 1};
    const CUresult r = encode(&p.h_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                              const_cast<void*>(h), dims, strides, box, elem_strides,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -2;
  }
  for (int i = 0; i < s; ++i) p.rows[i] = rows[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(plan.amode == kBfTma      ? run_bf16<kBfTma>(p, plan, st)
                          : plan.amode == kBfCopy16 ? run_bf16<kBfCopy16>(p, plan, st)
                                                    : run_bf16<kBfCopy2>(p, plan, st));
}

// The bf16 launch plan at (e, c, segments) on the current device, as
// distmlip_so2_conv_bf16 would launch it: out[0] edge rows a tile, out[1]
// columns a tile, out[2] row tiles, out[3] column tiles, out[4] tiles the
// grid walks, out[5] blocks, out[6] the A mode (0 TMA, 1 16-byte copies, 2
// element copies), out[7] stages. Returns a cudaError_t (0 = success).
extern "C" int distmlip_so2_conv_bf16_plan(int64_t e, int c, int n_seg, const int* seg_m,
                                           const int* seg_nl, int vec, int64_t* out) {
  if (e < 1 || n_seg < 1 || n_seg > kMaxSeg || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PlanBf16 plan = {};
  const int err = plan_bf16(e, c, n_seg, seg_m, seg_nl, vec, &plan);
  const int64_t values[8] = {kBM16,      kBN16,       plan.row_tiles, plan.col_tiles,
                             plan.tiles, plan.blocks, plan.amode,     kStages16};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
  return err;
}
