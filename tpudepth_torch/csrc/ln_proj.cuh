// Device code of the LayerNorm-and-projection pass in front of a window
// attention, shared by rowblock_infer.cu (rows of the image layout) and
// block_infer.cu (window-major rows):
//
//   out[:, 0:cout] = round((LN(x) valid) W^T + b), the columns below nscale
//   times scale before the rounding,
//
// over flat rows [M, C]. Which rows are real (not pad) is the one thing the
// two callers do differently, so the kernels take a validity functor:
// valid(row) is false for a pad token, whose LN row is then zeros (its
// projection is the bias alone). The arithmetic is block_tail.cuh's: LN in
// f32 with flax's fast variance, rounded to the IO dtype; products on the
// tensor cores for bf16 (mma.sync, weights streamed from L2, the A tile in
// shared memory), on the CUDA cores in f32 (weight tiles staged through
// shared memory).
//
// Everything is in namespace lnproj inside an unnamed namespace, as in the
// other headers.

#pragma once

#include "block_tail.cuh"

namespace {
namespace lnproj {

using tail::kBK;
using tail::kNC;
using tail::kSmemLimit;
using tail::kThreads;
using tail::kWarps;

struct Params {
  const void* x;      // [M, C] rows, IO dtype
  const float* lns;   // LayerNorm scale and bias [C]
  const float* lnb;
  const void* w;      // [cout, C] torch layout [out, in], IO dtype
  const float* b;     // [cout]
  void* out;          // row stride ldo
  int ldo;
  int M, C, cout, nscale;
  float scale;
};

// bf16: MT 16-row tiles a block; the output in passes of 8 warps x NT
// 8-column tiles, the accumulator 64 floats a thread as in the tail.
template <int MT, typename Valid>
__global__ void __launch_bounds__(kThreads, 1)
    ln_proj_mma_kernel(const Params p, const Valid valid) {
  constexpr int NT = 16 / MT;
  constexpr int BM = 16 * MT;
  constexpr int kCols = kWarps * NT * 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int C = p.C;
  const int lda = tail::padded(C);
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][lda]

  // LN(x) valid, rounded; pad tokens and rows past M are zeros
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  for (int r = warp; r < BM; r += kWarps) {
    const int row = row0 + r;
    __nv_bfloat16* ar = a_s + r * lda;
    if (row < p.M && valid(row)) {
      tail::layer_norm_row(x + static_cast<size_t>(row) * C, ar, C, p.lns,
                           p.lnb);
    } else {
      for (int k = lane; k < C; k += 32) ar[k] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  for (int n0 = 0; n0 < p.cout; n0 += kCols) {
    const int ntiles = min(p.cout - n0, kCols) / 8;
    float acc[MT][NT][4];
    tail::zero(acc);
    tail::mma_gemm<MT, NT>(acc, a_s, lda, w + static_cast<size_t>(n0) * C, C,
                           C, ntiles);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NT; ++i)
        if (warp + kWarps * i < ntiles)
#pragma unroll
          for (int c = 0; c < 4; c += 2) {
            const int r = m * 16 + g + (c >> 1) * 8;
            if (row0 + r >= p.M) continue;
            const int n = n0 + (warp + kWarps * i) * 8 + 2 * t;
            float v0 = acc[m][i][c] + p.b[n];
            float v1 = acc[m][i][c + 1] + p.b[n + 1];
            if (n < p.nscale) v0 *= p.scale;
            if (n + 1 < p.nscale) v1 *= p.scale;
            *reinterpret_cast<__nv_bfloat162*>(
                out + static_cast<size_t>(row0 + r) * p.ldo + n) =
                __floats2bfloat162_rn(v0, v1);
          }
  }
}

// f32: BM rows a block, the LN rows in shared memory, the output in
// 128-column chunks on the CUDA cores (block_tail.cuh's f32_gemm, weight
// tiles staged through shared memory).
template <int BM, typename Valid>
__global__ void __launch_bounds__(kThreads)
    ln_proj_f32_kernel(const Params p, const Valid valid) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * BM;
  const int C = p.C;
  float* a_s = smem;           // [BM][C]
  float* ws = a_s + BM * C;    // [kBK][kNC + 1]

  const float* x = static_cast<const float*>(p.x);
  for (int r = warp; r < BM; r += kWarps) {
    const int row = row0 + r;
    float* ar = a_s + r * C;
    if (row < p.M && valid(row)) {
      tail::layer_norm_row(x + static_cast<size_t>(row) * C, ar, C, p.lns,
                           p.lnb);
    } else {
      for (int k = lane; k < C; k += 32) ar[k] = 0.f;
    }
  }
  __syncthreads();

  const float* w = static_cast<const float*>(p.w);
  float* out = static_cast<float*>(p.out);
  for (int n0 = 0; n0 < p.cout; n0 += kNC) {
    const int nc = min(p.cout - n0, kNC);
    float acc[BM / 8][4];
    tail::zero_f32<BM>(acc);
    tail::f32_gemm<BM>(acc, a_s, C, w, C, n0, nc, C, ws);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < nc / 32) {
        const int n = n0 + lane + 32 * c;
#pragma unroll
        for (int r = 0; r < BM / 8; ++r) {
          const int row = row0 + warp + 8 * r;
          if (row >= p.M) continue;
          float v = acc[r][c] + p.b[n];
          if (n < p.nscale) v *= p.scale;
          out[static_cast<size_t>(row) * p.ldo + n] = v;
        }
      }
    }
  }
}

inline size_t smem_bytes(int rows, int C, bool bf16) {
  if (bf16) return 2 * static_cast<size_t>(rows) * tail::padded(C);
  return sizeof(float) * (static_cast<size_t>(rows) * C +
                          static_cast<size_t>(kBK) * (kNC + 1));
}

// Rows a block: the most that fit in shared memory, halved while the grid
// would leave SMs idle. 0 when nothing fits.
inline int pick_rows(int M, int C, bool bf16) {
  const int least = bf16 ? 16 : 8;
  int rows = bf16 ? 128 : 64;
  while (rows > least && smem_bytes(rows, C, bf16) > kSmemLimit) rows /= 2;
  if (smem_bytes(rows, C, bf16) > kSmemLimit) return 0;
  while (rows > least && (M + rows - 1) / rows < 132) rows /= 2;
  return rows;
}

template <int MT, typename Valid>
cudaError_t launch_mma(const Params& p, const Valid& valid, cudaStream_t st) {
  static bool done = false;
  auto kern = ln_proj_mma_kernel<MT, Valid>;
  const cudaError_t err = tail::opt_in(kern, done);
  if (err != cudaSuccess) return err;
  kern<<<(p.M + 16 * MT - 1) / (16 * MT), kThreads,
         smem_bytes(16 * MT, p.C, true), st>>>(p, valid);
  return cudaGetLastError();
}

template <int BM, typename Valid>
cudaError_t launch_f32(const Params& p, const Valid& valid, cudaStream_t st) {
  static bool done = false;
  auto kern = ln_proj_f32_kernel<BM, Valid>;
  const cudaError_t err = tail::opt_in(kern, done);
  if (err != cudaSuccess) return err;
  kern<<<(p.M + BM - 1) / BM, kThreads, smem_bytes(BM, p.C, false), st>>>(
      p, valid);
  return cudaGetLastError();
}

// One launch of the pass on stream st.
template <typename Valid>
cudaError_t run(const Params& p, const Valid& valid, bool bf16,
                cudaStream_t st) {
  if (p.cout % 32 != 0) return cudaErrorInvalidValue;
  const int rows = pick_rows(p.M, p.C, bf16);
  if (bf16) {
    switch (rows) {
      case 16: return launch_mma<1>(p, valid, st);
      case 32: return launch_mma<2>(p, valid, st);
      case 64: return launch_mma<4>(p, valid, st);
      case 128: return launch_mma<8>(p, valid, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (rows) {
    case 8: return launch_f32<8>(p, valid, st);
    case 16: return launch_f32<16>(p, valid, st);
    case 32: return launch_f32<32>(p, valid, st);
    case 64: return launch_f32<64>(p, valid, st);
    default: return cudaErrorInvalidValue;
  }
}

inline Params params(const void* x, const void* lns, const void* lnb,
                     const void* w, const void* b, void* out, int ldo,
                     int cout, int nscale, float scale, int M, int C) {
  Params p = {};
  p.x = x;
  p.lns = static_cast<const float*>(lns);
  p.lnb = static_cast<const float*>(lnb);
  p.w = w;
  p.b = static_cast<const float*>(b);
  p.out = out;
  p.ldo = ldo;
  p.M = M;
  p.C = C;
  p.cout = cout;
  p.nscale = nscale;
  p.scale = scale;
  return p;
}

}  // namespace lnproj
}  // namespace
