// One pipelined tensor-core GEMM core for Hopper (sm_90a), shared by the
// bf16 paths of mlp_train_fwd and mlp_train_bwd (mlp_train.cu), of
// mlp_infer and block_epilogue_infer (epilogue_infer.cu) and of the
// projections and tails of crf_rowblock_infer, sam_rowblock_infer
// (rowblock_infer.cu) and sam_block_infer (block_infer.cu), through
// tail_chain.cuh:
//
//   acc[128 x BN] (+)= sum over k of A(m, k) B(n, k)      bf16 in, f32 out
//
// per output tile, then an epilogue functor on the f32 fragment in
// registers. Each operand is stored K-major (element (r, k) at
// p[r * ld + k]) or MN-major (at p[k * ld + r]); both operands of a product
// share one kind, and wgmma reads either natively (its transpose bits), so
// no operand is transposed element by element.
//
// It serves seven TPU kernels: tpudepth/ops/pallas/mlp_train.py::
// _mlp_fwd_pallas (:132) and ::_mlp_bwd_pallas (:163), tpudepth/ops/pallas/
// mlp_infer.py::mlp_infer (:135), tpudepth/ops/pallas/epilogue_infer.py::
// block_epilogue_infer (:92) and, for their projections and tails,
// tpudepth/ops/pallas/rowblock_infer.py::crf_rowblock_infer (:270) and
// ::sam_rowblock_infer (:355) and tpudepth/ops/pallas/block_infer.py::
// sam_block_infer (:201). Their products hold 380..4000 operations per
// bf16 byte moved, above the card's ~295: operations bound them, and on this
// card that means the tensor cores kept fed. The first designs of all four
// (mma.sync fed by synchronous loads: fragments through registers and two
// barriers per k-block, B fragments straight from L2) reached 4-7 % of that
// bound. The FFN forward (mlp_train_fwd, mlp_infer) is a chain of two
// products through a bf16 hidden in device memory (ffn_bf16, at the end);
// block_epilogue_infer's chain runs the same products as its steps 3-4,
// with a residual added in step 4.
//
// Design (the hopper-kernels guide, section 1):
//   * tensor cores through wgmma.mma_async m64nBNk16 (BN 64 or 128), both
//     operands from shared memory in the canonical 128-byte-swizzled
//     layouts; two consumer warpgroups take rows 0-63 and 64-127 of a tile;
//   * a ring of 3-4 k-blocks of 64 (96 KB) in shared memory, filled by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle) from one producer warp and
//     handed over with mbarriers (full: bytes arrived; empty: both consumer
//     warpgroups done); the consumers keep one wgmma group in flight and
//     release a stage when the next group is issued;
//   * persistent blocks, two an SM (at most 112 registers a thread and 96 KB
//     of ring each), walk the tiles in a fixed order, N fastest: while one
//     block runs an epilogue the other's products and the producers' next
//     loads go on, and the blocks that run together share their A rows in
//     L2;
//   * bf16 outputs leave through shared memory: the epilogue keeps the ring
//     slot of the tile's last k-block, writes the tile there in TMA's
//     swizzled layout and stores it with TMA (whole lines, ragged edges
//     clipped), then gives the slot back;
//   * ragged inputs (M, widths of 32 or 96, the last k-block) come in as
//     zeros from TMA's out-of-bounds fill.
// Tensor maps are passed by value as __grid_constant__ kernel parameters (a
// CUDA graph replays them as captured); cuTensorMapEncodeTiled comes from
// the runtime's driver entry point, so the build links nothing new.
//
// What bounds it now (NVIDIA H100 80GB HBM3 at 700 W; the stage script
// scripts/torch_ffn_stage_times.py):
// products with a long K loop run at 350-550 TFLOP/s (the weight gradients
// over 2400 rows); tiles with a short K loop (64-256) and an epilogue that
// evaluates GELU on every element run at 150-350 TFLOP/s, held by that
// epilogue's ALU work and by the L2 traffic of 128-wide tiles, which stage
// each weight tile again for every 128 rows. The FFN chain (ffn_bf16) takes
// 0.05-0.13 ms a product at the SAM stages of a B 8 forward, 0.70 ms for
// the four calls with the wrappers' weight casts: 1.9x cuBLAS.
//
// Sums run in a fixed order that depends on the shape alone: no atomics, a
// rerun is bit-equal.
//
// Everything is in namespace gemm inside an unnamed namespace, as in
// block_tail.cuh.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace gemm {

constexpr int kBM = 128;                  // rows of a tile
constexpr int kBK = 64;                   // depth of a k-block: 128 bytes
constexpr int kConsumers = 256;           // two consumer warpgroups
constexpr int kThreads = kConsumers + 32; // and one producer warp
constexpr int kBox = 64;                  // rows of an MN-major TMA box
constexpr uint32_t kABytes = kBM * kBK * 2;
constexpr size_t kSmemLimit = 232448;     // 227 KB

// How an operand is stored: the contraction index contiguous (kK) or its
// rows contiguous (kMN).
enum Major { kK = 0, kMN = 1 };

__host__ __device__ constexpr uint32_t b_bytes(int bn) { return bn * kBK * 2; }
__host__ __device__ constexpr uint32_t stage_bytes(int bn) {
  return kABytes + b_bytes(bn);
}
// k-blocks in the ring: 96 KB of it, and at most 112 registers a thread,
// so that two blocks share an SM and one block's epilogue overlaps the
// other's products (measured: tiles 256 wide, 128 accumulators a thread
// and one block an SM, made the epilogue-heavy products 20-50 % slower)
__host__ __device__ constexpr int stages(int bn) { return bn == 128 ? 3 : 4; }

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase with the given parity has completed. A
// wait that does not end within ~2^24 tries is a fault (a copy that never
// lands): trap, so that the launch reports an error and the card is freed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries == (1u << 24)) __trap();
  }
}

// The 2-D box at (c0, c1) (innermost coordinate first) of the tensor map
// into shared memory at dst; completion counted in bytes on bar.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The 2-D box at (c0, c1) of the tensor map from shared memory at src;
// out-of-bounds parts are not written. Tracked by the issuing thread's bulk
// groups.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// Commit the thread's bulk stores and wait until their shared-memory
// sources have been read.
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Barrier of the 256 consumer threads only (id 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand tile:
// start address, leading and stride byte offsets (16-byte units), layout 1
// (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Descriptor of k16 step kk of a staged operand tile. K-major: rows of 128
// bytes (64 k), 8-row atoms of 1024 bytes (SBO), k16 steps 32 bytes apart
// inside the swizzled row. MN-major: boxes of 64 rows (MN) x 64 k, each k a
// 128-byte line, 8-k atoms 1024 bytes apart (SBO), boxes 8 KB apart (LBO),
// k16 steps 2048 bytes apart.
template <Major kMajor>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int kk) {
  return kMajor == kK ? desc(tile + kk * 32, 16, 1024)
                      : desc(tile + kk * 2048, kBox * 128, 1024);
}

// wgmma m64nNk16, f32 += bf16 x bf16, both operands from shared memory;
// kT: both operands MN-major (transposed).
template <int kT>
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kT));
}

template <int kT>
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kT));
}

template <int kT>
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
  mma_n64<kT>(d, da, db);
}
template <int kT>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
  mma_n128<kT>(d, da, db);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// What a launch walks: tiles (split z, row tile mt, column tile nt), nt
// fastest; product p sums kblocks[p] k-blocks of 64, of which split z takes
// [z * split_kblocks, (z + 1) * split_kblocks). An epilogue Epi has
//   kProducts (1 or 2), kTiles (the [M, N] bf16 tensors it stores or reads
//   through the staging slot by TMA, maps c[]), kSmemBytes (its own shared
//   memory), Params, and
//   template <int BN> static void apply(const Params&, float (&)[P][BN / 2],
//       const Tile&, unsigned char* smem, const CUtensorMap* c,
//       unsigned char* staging, uint32_t tile_bar)
// where staging is the ring slot of the tile's last k-block, held for the
// epilogue (at least 128 x BN bf16) and given back after it, and tile_bar
// the warpgroup's mbarrier for loads into it (phase: the block's tile
// count, Tile::iter).
template <class Epi>
struct Args {
  CUtensorMap a[Epi::kProducts];
  CUtensorMap b[Epi::kProducts];
  CUtensorMap c[Epi::kTiles > 0 ? Epi::kTiles : 1];  // bf16 [M, N] tiles
  int kblocks[Epi::kProducts];
  int m_tiles, n_tiles, splits, split_kblocks;
  typename Epi::Params p;
};

struct Tile {
  int m0, n0, z, mt;   // first row and column, split, row tile
  int iter;            // tiles the block walked before this one
};

template <int BN>
__device__ __forceinline__ Tile tile_of(int t, int m_tiles, int n_tiles,
                                        int iter) {
  const int rest = t / n_tiles;
  return {(rest % m_tiles) * kBM, (t % n_tiles) * BN, rest / m_tiles,
          rest % m_tiles, iter};
}

// The thread's fragment of the 128 x BN tile (wgmma's accumulator layout,
// warpgroup w = rows 64 w..): accumulator 4 j + 2 h + e holds row
// frag_row() + 8 h, column frag_col() + 8 j + e.
__device__ __forceinline__ int frag_row() {
  const int t = threadIdx.x;
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2);
}
__device__ __forceinline__ int frag_col() { return (threadIdx.x & 3) * 2; }

// Calls f(r, c, v0, v1) for the pairs of columns (c, c + 1) of row r of
// the thread's fragment, c even.
template <int BN, class F>
__device__ __forceinline__ void for_pairs(const float (&acc)[BN / 2], F&& f) {
  const int r0 = frag_row();
  const int c0 = frag_col();
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(r0 + 8 * h, c0 + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// Load one k-block of an operand (R rows of the tile from row r0, k from
// k0) into shared memory at dst.
template <Major kMajor, int R>
__device__ __forceinline__ void load_operand(const CUtensorMap* map,
                                             uint32_t dst, uint32_t bar,
                                             int r0, int k0) {
  if (kMajor == kK) {
    tma_load(map, dst, bar, k0, r0);
  } else {
#pragma unroll
    for (int j = 0; j < R / kBox; ++j)
      tma_load(map, dst + j * kBox * 128, bar, r0 + j * kBox, k0);
  }
}

// The consumers' products over nkb k-blocks into acc; `it` counts k-blocks
// over the block's whole life (ring slot and phase). keep: the last
// k-block's slot is not given back (the epilogue stages its output there).
template <int BN, Major kMajor, int kStages>
__device__ __forceinline__ void consume(float (&acc)[BN / 2], int nkb,
                                        uint32_t& it, uint32_t ring,
                                        uint32_t bars, bool keep) {
  const uint32_t a_off = (threadIdx.x >> 7) * (kABytes / 2);
  for (int kb = 0; kb < nkb; ++kb, ++it) {
    const uint32_t s = it % kStages;
    mbar_wait(bars + 8 * s, (it / kStages) & 1);
    __syncwarp();   // wgmma is .aligned: the warp converged
    const uint32_t a = ring + s * stage_bytes(BN) + a_off;
    const uint32_t b = ring + s * stage_bytes(BN) + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      mma<kMajor>(acc, operand_desc<kMajor>(a, kk),
                  operand_desc<kMajor>(b, kk));
    }
    wgmma_commit();
    wgmma_wait<1>();
    // the previous k-block's products are done: its slot may be refilled
    if (kb > 0) mbar_arrive(bars + 8 * (kStages + (it - 1) % kStages));
  }
  wgmma_wait<0>();
  if (!keep && nkb > 0) mbar_arrive(bars + 8 * (kStages + (it - 1) % kStages));
}

template <class Epi, int BN>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + stages(BN) * (stage_bytes(BN) + 16) + 16 + Epi::kSmemBytes;
}

template <class Epi, int BN, Major kMajor>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(const __grid_constant__ Args<Epi> args) {
  constexpr int P = Epi::kProducts;
  constexpr int kStages = stages(BN);
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles on 1024-byte bounds
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  // full[kStages], empty[kStages], the two warpgroups' tile barriers
  const uint32_t bars = ring + kStages * stage_bytes(BN);
  unsigned char* epi_smem =
      smem + kStages * stage_bytes(BN) + 16 * kStages + 16;
  const int tiles = args.splits * args.m_tiles * args.n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumers);
    }
    mbar_init(bars + 16 * kStages, 1);
    mbar_init(bars + 16 * kStages + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warp: one thread issues every copy
    if (threadIdx.x != kConsumers) return;
    for (int p = 0; p < P; ++p) {
      prefetch_map(&args.a[p]);
      prefetch_map(&args.b[p]);
    }
    uint32_t it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tile = tile_of<BN>(t, args.m_tiles, args.n_tiles, 0);
      for (int p = 0; p < P; ++p) {
        const int kb0 = tile.z * args.split_kblocks;
        const int nkb = min(args.kblocks[p] - kb0, args.split_kblocks);
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          const uint32_t s = it % kStages;
          const uint32_t full = bars + 8 * s;
          mbar_wait(bars + 8 * (kStages + s), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full, stage_bytes(BN));
          const uint32_t dst = ring + s * stage_bytes(BN);
          const int k0 = (kb0 + kb) * kBK;
          load_operand<kMajor, kBM>(&args.a[p], dst, full, tile.m0, k0);
          load_operand<kMajor, BN>(&args.b[p], dst + kABytes, full,
                                   tile.n0, k0);
        }
      }
    }
    return;
  }

  // the consumers: two warpgroups, rows 0-63 and 64-127 of each tile
  float acc[P][BN / 2];
  uint32_t it = 0;
  int iter = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++iter) {
    const Tile tile = tile_of<BN>(t, args.m_tiles, args.n_tiles, iter);
    const int kb0 = tile.z * args.split_kblocks;
    constexpr bool kStaged = Epi::kTiles > 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[p][i] = 0.f;
      consume<BN, kMajor, kStages>(acc[p],
                          min(args.kblocks[p] - kb0, args.split_kblocks), it,
                          ring, bars, kStaged && p == P - 1);
    }
    const uint32_t last = (it - 1) % kStages;
    // the other warpgroup's products may still read the slot's A and B
    if (kStaged) consumers_sync();
    Epi::template apply<BN>(args.p, acc, tile, epi_smem, args.c,
                            smem + last * stage_bytes(BN),
                            bars + 16 * kStages + 8 * (threadIdx.x >> 7));
    if (kStaged) mbar_arrive(bars + 8 * (kStages + last));
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a bf16 matrix of `rows` rows of `cols` elements (row
// stride ld elements, 16-byte aligned), boxes of 64 x box_rows elements
// with the 128-byte swizzle; elements outside the matrix read as zeros.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int cols,
                            int rows, long long ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Map of an operand with R rows (of the product) over contraction depth K:
// K-major [R, K] (row stride ld), one box of the tile's rows_box rows a
// k-block; MN-major [K, R] (row stride ld), boxes of 64 rows x 64 k.
inline cudaError_t operand_map(CUtensorMap* map, Major major, const void* ptr,
                               int R, int K, long long ld, int rows_box) {
  return major == kK ? make_map(map, ptr, K, R, ld, rows_box)
                     : make_map(map, ptr, R, K, ld, kBox);
}

// Launch kFill<<<256, 256>>> (a table of 65536 entries, one a thread) on
// st, once a device: a launch captured into a CUDA graph does not count,
// since it runs only with the graph; later calls outside it launch again.
template <void (*kFill)()>
cudaError_t fill_once(cudaStream_t st) {
  static bool filled[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && filled[dev])) return err;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  err = cudaStreamIsCapturing(st, &capture);
  if (err != cudaSuccess) return err;
  kFill<<<256, 256, 0, st>>>();
  err = cudaGetLastError();
  if (err == cudaSuccess && capture == cudaStreamCaptureStatusNone && dev < 64)
    filled[dev] = true;
  return err;
}

// The bf16 value with the bits of i (0..65535), as f32.
__device__ __forceinline__ float bf16_of_bits(int i) {
  const unsigned short b = static_cast<unsigned short>(i);
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(&b));
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Column tile for an output n columns wide: 128, or 64 for n <= 64. (A
// cost model that took 64 where it gave fewer rounds of tiles over the SMs
// measured the same as 128 on the SAM stages, and 64 everywhere 2-7 %
// slower.)
inline int tile_n(int n) { return n <= 64 ? 64 : 128; }

// One launch: as many blocks as fit on the card at once (or tiles), each
// walking its tiles.
template <class Epi, int BN, Major kMajor>
cudaError_t launch(const Args<Epi>& args, cudaStream_t st) {
  static_assert(smem_bytes<Epi, BN>() <= kSmemLimit, "shared memory");
  static int resident = 0;  // once per kernel, before any graph capture
  auto kern = gemm_kernel<Epi, BN, kMajor>;
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<Epi, BN>()));
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, kThreads, smem_bytes<Epi, BN>());
    if (err != cudaSuccess) return err;
    resident = (per_sm > 0 ? per_sm : 1) * sm_count();
  }
  const int tiles = args.splits * args.m_tiles * args.n_tiles;
  kern<<<tiles < resident ? tiles : resident, kThreads, smem_bytes<Epi, BN>(),
         st>>>(args);
  return cudaGetLastError();
}

// The products of Epi (all operands of one kind) over an output of m rows
// and n columns, in `splits` splits of split_kblocks k-blocks: fills the
// maps (product i: A from a[i] with R = m rows over depth k[i], B from b[i]
// with R = n rows; the epilogue's [m, n] bf16 tensors from tiles[], at row
// strides ldt[] or n) and launches with column tiles of BN.
template <class Epi, Major kMajor, int BN>
cudaError_t run(const typename Epi::Params& p, const void* const* a,
                const long long* lda, const void* const* b,
                const long long* ldb, const int* k, int m, int n, int splits,
                int split_kblocks, cudaStream_t st,
                void* const* tiles = nullptr,
                const long long* ldt = nullptr) {
  Args<Epi> args;
  for (int i = 0; i < Epi::kTiles; ++i) {
    // bf16 [m, n] tensors, in boxes of 64 x 64
    const cudaError_t err = make_map(&args.c[i], tiles[i], n, m,
                                     ldt != nullptr ? ldt[i] : n, kBox);
    if (err != cudaSuccess) return err;
  }
  for (int i = 0; i < Epi::kProducts; ++i) {
    cudaError_t err = operand_map(&args.a[i], kMajor, a[i], m, k[i], lda[i],
                                  kBM);
    if (err == cudaSuccess)
      err = operand_map(&args.b[i], kMajor, b[i], n, k[i], ldb[i], BN);
    if (err != cudaSuccess) return err;
    args.kblocks[i] = cdiv(k[i], kBK);
  }
  args.m_tiles = cdiv(m, kBM);
  args.n_tiles = cdiv(n, BN);
  args.splits = splits;
  args.split_kblocks = split_kblocks;
  args.p = p;
  return launch<Epi, BN, kMajor>(args, st);
}

// run() with column tiles of bn (64 or 128), chosen at run time.
template <class Epi, Major kMajor>
cudaError_t run_bn(int bn, const typename Epi::Params& p,
                   const void* const* a, const long long* lda,
                   const void* const* b, const long long* ldb, const int* k,
                   int m, int n, int splits, int split_kblocks,
                   cudaStream_t st, void* const* tiles = nullptr,
                   const long long* ldt = nullptr) {
  return bn == 64 ? run<Epi, kMajor, 64>(p, a, lda, b, ldb, k, m, n, splits,
                                         split_kblocks, st, tiles, ldt)
                  : run<Epi, kMajor, 128>(p, a, lda, b, ldb, k, m, n, splits,
                                          split_kblocks, st, tiles, ldt);
}

// ---------------------------------------------------------------------------
// Epilogues shared by the users
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// erf as the TPU kernels evaluate it (tpudepth/ops/pallas/mlp_infer.py::
// _erf): z P(2 z^2 / B^2 - 1) with z clamped to [-B, B], B = 3.9375, P of
// degree 16 (max abs error 2.1e-7 in f32): FMAs only, no branch, where
// erff's two branches diverge within a warp of unit-scale activations.
__device__ __forceinline__ float erf_poly(float x) {
  const float z = fminf(fmaxf(x, -3.9375f), 3.9375f);
  const float t = z * z * 0.1289997480473671f - 1.0f;
  float p = 4.1510098659e-04f;
  p = fmaf(p, t, -1.0203042461e-03f);
  p = fmaf(p, t, 6.3636799682e-04f);
  p = fmaf(p, t, -1.0665787938e-03f);
  p = fmaf(p, t, 4.5126567157e-03f);
  p = fmaf(p, t, -8.5512452514e-03f);
  p = fmaf(p, t, 1.2643683187e-02f);
  p = fmaf(p, t, -2.0077809386e-02f);
  p = fmaf(p, t, 3.1153511247e-02f);
  p = fmaf(p, t, -4.4128607978e-02f);
  p = fmaf(p, t, 5.8572264281e-02f);
  p = fmaf(p, t, -7.4167896060e-02f);
  p = fmaf(p, t, 9.0550457025e-02f);
  p = fmaf(p, t, -1.0886771484e-01f);
  p = fmaf(p, t, 1.3355388746e-01f);
  p = fmaf(p, t, -1.7932530043e-01f);
  p = fmaf(p, t, 3.5913577732e-01f);
  return z * p;
}

// The standard normal CDF 0.5 (1 + erf(h / sqrt 2)) with erf_poly.
__device__ __forceinline__ float normal_cdf(float h) {
  return 0.5f * (1.0f + erf_poly(h * 0.70710678118654752f));
}

__device__ __forceinline__ uint32_t pack2(float v0, float v1) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The epilogue's stores go through shared memory and TMA: each warpgroup
// writes its 64 rows of the tile as bf16 into its part of the staging slot,
// in boxes of 64 x 64 laid out as TMA's 128-byte swizzle (16-byte piece
// c / 8 of row r at piece c / 8 ^ r % 8: a warp's 4-byte writes fall in 32
// distinct banks), fences them for the async proxy, and one thread stores
// the boxes with TMA, which writes whole lines and leaves out rows past M
// and columns past N. (Stored from registers as the fragment lies, 4 bytes
// a lane, every 32-byte sector is written in two halves, and a partial
// sector costs L2 a read-modify-write: the first version's epilogues spent
// up to 2/3 of their time there.)

// This warpgroup's part of the staging slot: BN / 64 boxes of 64 x 64.
template <int BN>
__device__ __forceinline__ unsigned char* staged_part(unsigned char* staging) {
  return staging + (threadIdx.x >> 7) * (BN / 64) * 8192;
}

// The word (bf16 pair) at tile row r, even column c in the warpgroup's part.
__device__ __forceinline__ uint32_t* staged(unsigned char* part, int r,
                                           int c) {
  const int rr = r & 63;
  const int cc = c & 63;
  return reinterpret_cast<uint32_t*>(part + (c >> 6) * 8192 + rr * 128 +
                                     (((cc >> 3) ^ (rr & 7)) << 4) +
                                     (cc & 7) * 2);
}

// Load this warpgroup's rows of an [M, N] bf16 tensor (rows m0 + 64 wg..,
// columns n0..; zeros outside) with TMA into its part, in the layout
// staged() addresses, and wait for them on bar.
template <int BN>
__device__ __forceinline__ void load_staged(const CUtensorMap* map,
                                            unsigned char* part, uint32_t bar,
                                            int parity, int m0, int n0) {
  if ((threadIdx.x & 127) == 0) {
    mbar_expect_tx(bar, BN / 64 * 8192);
#pragma unroll
    for (int b = 0; b < BN / 64; ++b)
      tma_load(map, smem_u32(part + b * 8192), bar, n0 + 64 * b,
               m0 + 64 * (threadIdx.x >> 7));
  }
  mbar_wait(bar, parity);
}

// Store this warpgroup's part with TMA at rows m0 + 64 wg.., columns n0..,
// and wait until it has been read.
template <int BN>
__device__ __forceinline__ void flush_staged(const CUtensorMap* map,
                                             unsigned char* part, int m0,
                                             int n0) {
  const int wg = threadIdx.x >> 7;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int b = 0; b < BN / 64; ++b)
      tma_store(map, smem_u32(part + b * 8192), n0 + 64 * b, m0 + 64 * wg);
    tma_store_drain();
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// Store the words f(r, c, v0, v1) (the bf16 pair of columns c, c + 1 of
// tile row r) of the fragment to map at (m0, n0) through the staging slot.
template <int BN, class F>
__device__ __forceinline__ void store_pairs(const float (&acc)[BN / 2],
                                            const CUtensorMap* map,
                                            unsigned char* staging, int m0,
                                            int n0, F&& f) {
  unsigned char* part = staged_part<BN>(staging);
  const int r0 = frag_row();
  const int c0 = frag_col();
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *staged(part, r0 + 8 * h, c0 + 8 * j) =
          f(r0 + 8 * h, c0 + 8 * j, acc[4 * j + 2 * h],
            acc[4 * j + 2 * h + 1]);
  flush_staged<BN>(map, part, m0, n0);
}

// store_pairs with a residual: the warpgroup's rows of res (an [M, N] bf16
// tensor at (m0, n0)) are first loaded into its part, and
// f(c, v0, v1, word) turns the residual pair into the stored one in place.
template <int BN, class F>
__device__ __forceinline__ void store_pairs_res(const float (&acc)[BN / 2],
                                                const CUtensorMap* map,
                                                const CUtensorMap* res,
                                                unsigned char* staging,
                                                uint32_t bar, int parity,
                                                int m0, int n0, F&& f) {
  unsigned char* part = staged_part<BN>(staging);
  load_staged<BN>(res, part, bar, parity, m0, n0);
  const int r0 = frag_row();
  const int c0 = frag_col();
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t* w = staged(part, r0 + 8 * h, c0 + 8 * j);
      *w = f(c0 + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], *w);
    }
  flush_staged<BN>(map, part, m0, n0);
}

// Store words already packed: w[j][h] holds columns frag_col() + 8 j (+1)
// of row frag_row() + 8 h.
template <int BN>
__device__ __forceinline__ void store_words(const uint32_t (&w)[BN / 8][2],
                                            const CUtensorMap* map,
                                            unsigned char* staging, int m0,
                                            int n0) {
  unsigned char* part = staged_part<BN>(staging);
  const int r0 = frag_row();
  const int c0 = frag_col();
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) *staged(part, r0 + 8 * h, c0 + 8 * j) = w[j][h];
  flush_staged<BN>(map, part, m0, n0);
}

// out = round(acc): dx.
struct RoundStore {
  static constexpr int kProducts = 1;
  static constexpr int kTiles = 1;
  static constexpr int kSmemBytes = 0;
  struct Params {};
  template <int BN>
  static __device__ __forceinline__ void apply(const Params&,
                                               float (&acc)[1][BN / 2],
                                               const Tile& t, unsigned char*,
                                               const CUtensorMap* c,
                                               unsigned char* staging,
                                               uint32_t) {
    store_pairs<BN>(acc[0], c, staging, t.m0, t.n0,
                    [](int, int, float v0, float v1) { return pack2(v0, v1); });
  }
};

// out[z, r, c] = acc in f32 for r < M, c < N: split z's partial sum.
struct F32Store {
  static constexpr int kProducts = 1;
  static constexpr int kTiles = 0;
  static constexpr int kSmemBytes = 0;
  struct Params {
    float* out;
    int M, N;
  };
  template <int BN>
  static __device__ __forceinline__ void apply(const Params& p,
                                               float (&acc)[1][BN / 2],
                                               const Tile& t, unsigned char*,
                                               const CUtensorMap*,
                                               unsigned char*, uint32_t) {
    float* o = p.out + static_cast<size_t>(t.z) * p.M * p.N;
    for_pairs<BN>(acc[0], [&](int r, int c, float v0, float v1) {
      const int row = t.m0 + r, col = t.n0 + c;
      if (row >= p.M || col >= p.N) return;
      *reinterpret_cast<float2*>(o + static_cast<size_t>(row) * p.N + col) =
          make_float2(v0, v1);
    });
  }
};

// out = round(acc + bias[c]) for c < N: the FFN's second product.
struct BiasRound {
  static constexpr int kProducts = 1;
  static constexpr int kTiles = 1;
  static constexpr int kSmemBytes = 0;
  struct Params {
    const float* bias;
    int N;
  };
  template <int BN>
  static __device__ __forceinline__ void apply(const Params& p,
                                               float (&acc)[1][BN / 2],
                                               const Tile& t, unsigned char*,
                                               const CUtensorMap* c,
                                               unsigned char* staging,
                                               uint32_t) {
    store_pairs<BN>(acc[0], c, staging, t.m0, t.n0,
                    [&](int, int c, float v0, float v1) {
      const int col = t.n0 + c;
      if (col >= p.N) return 0u;
      return pack2(v0 + p.bias[col], v1 + p.bias[col + 1]);
    });
  }
};

// round(gelu(h)) for every bf16 h, by its bits: h * normal_cdf(h) in f32,
// the arithmetic of the formula, so looking it up gives the same bits.
// Each library that includes this header holds its own table (the unnamed
// namespace), filled once a device (fill_once) before its first product
// that reads it.
__device__ unsigned short gelu_table[65536];

__global__ void gelu_table_kernel() {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float h = bf16_of_bits(i);
  const __nv_bfloat16 g = __float2bfloat16(h * normal_cdf(h));
  gelu_table[i] = *reinterpret_cast<const unsigned short*>(&g);
}

// out = round(gelu(round(acc + bias[c]))), erf as the TPU kernel's
// polynomial. h is a bf16 value, so gelu is looked up by h's bits
// (gelu_table): a load a value in place of ~25 ALU operations, which held
// this epilogue (NVIDIA H100 80GB HBM3, 700 W: 1.15 -> 1.06 ms for the
// block_epilogue_infer calls of a B 8 SAM forward).
struct BiasGelu {
  static constexpr int kProducts = 1;
  static constexpr int kTiles = 1;
  static constexpr int kSmemBytes = 0;
  struct Params {
    const float* bias;
    int N;
  };
  template <int BN>
  static __device__ __forceinline__ void apply(const Params& p,
                                               float (&acc)[1][BN / 2],
                                               const Tile& t, unsigned char*,
                                               const CUtensorMap* c,
                                               unsigned char* staging,
                                               uint32_t) {
    store_pairs<BN>(acc[0], c, staging, t.m0, t.n0,
                    [&](int, int c, float v0, float v1) {
      const int col = t.n0 + c;
      if (col >= p.N) return 0u;
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(v0 + p.bias[col], v1 + p.bias[col + 1]);
      const uint32_t bits = *reinterpret_cast<const uint32_t*>(&h);
      return static_cast<uint32_t>(__ldg(gelu_table + (bits & 0xffffu))) |
             (static_cast<uint32_t>(__ldg(gelu_table + (bits >> 16))) << 16);
    });
  }
};

// ---------------------------------------------------------------------------
// The FFN as a chain of products, shared by its users
// ---------------------------------------------------------------------------

// One product of a chain: out [M, N] (row stride ldo, or N) from rows a
// [M, K] and a weight w [N, K] (torch layout), both K-major; res: an [M, N]
// bf16 residual that the epilogue reads (BiasResidual), or nullptr.
template <class Epi>
cudaError_t product(const typename Epi::Params& e, const void* a,
                    const void* w, void* out, const void* res, int M, int N,
                    int K, cudaStream_t st, long long ldo = 0) {
  const void* A[1] = {a};
  const void* B[1] = {w};
  void* T[2] = {out, const_cast<void*>(res)};
  const long long ld[1] = {K};
  const long long ldt[2] = {ldo > 0 ? ldo : N, N};
  const int k[1] = {K};
  return run_bn<Epi, kK>(tile_n(N), e, A, ld, B, ld, k, M, N, 1, 1 << 30, st,
                         T, ldt);
}

// out = round(round(gelu(round(x W1 + b1))) W2 + b2) in bf16, sums in f32:
// x [M, C], w1 [H, C], w2 [C2, H] (torch layout), b1, b2 f32; g [M, H] bf16
// scratch for the rounded hidden. Three kernels on st: the table (first
// call on a device only), then the two products.
inline cudaError_t ffn_bf16(const void* x, const void* w1, const float* b1,
                            const void* w2, const float* b2, void* g,
                            void* out, int M, int C, int H, int C2,
                            cudaStream_t st) {
  cudaError_t err = fill_once<gelu_table_kernel>(st);
  if (err == cudaSuccess)
    err = product<BiasGelu>({b1, H}, x, w1, g, nullptr, M, H, C, st);
  if (err != cudaSuccess) return err;
  return product<BiasRound>({b2, C2}, g, w2, out, nullptr, M, C2, H, st);
}

}  // namespace gemm
}  // namespace
