// Device code of the f32 LayerNorm-and-projection pass in front of a window
// attention, shared by rowblock_infer.cu (rows of the image layout) and
// block_infer.cu (window-major rows):
//
//   out[:, 0:cout] = (LN(x) valid) W^T + b, the columns below nscale times
//   scale,
//
// over flat rows [M, C]. Which rows are real (not pad) is the one thing the
// two callers do differently, so the kernels take a validity functor:
// valid(row) is false for a pad token, whose LN row is then zeros (its
// projection is the bias alone). The arithmetic is block_tail.cuh's: LN
// with flax's fast variance, the product on the CUDA cores (weight tiles
// staged through shared memory). In bf16 every caller runs
// chain::ln_project of tail_chain.cuh (a LayerNorm pass and a product on
// the wgmma core) instead.
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
  const void* x;      // [M, C] f32 rows
  const float* lns;   // LayerNorm scale and bias [C]
  const float* lnb;
  const void* w;      // [cout, C] f32, torch layout [out, in]
  const float* b;     // [cout]
  void* out;          // row stride ldo
  int ldo;
  int M, C, cout, nscale;
  float scale;
};

// BM rows a block, the LN rows in shared memory, the output in
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

inline size_t smem_bytes(int rows, int C) {
  return sizeof(float) * (static_cast<size_t>(rows) * C +
                          static_cast<size_t>(kBK) * (kNC + 1));
}

// Rows a block: the most that fit in shared memory, halved while the grid
// would leave SMs idle. 0 when nothing fits.
inline int pick_rows(int M, int C) {
  int rows = 64;
  while (rows > 8 && smem_bytes(rows, C) > kSmemLimit) rows /= 2;
  if (smem_bytes(rows, C) > kSmemLimit) return 0;
  while (rows > 8 && (M + rows - 1) / rows < 132) rows /= 2;
  return rows;
}

template <int BM, typename Valid>
cudaError_t launch(const Params& p, const Valid& valid, cudaStream_t st) {
  static bool done = false;
  auto kern = ln_proj_f32_kernel<BM, Valid>;
  const cudaError_t err = tail::opt_in(kern, done);
  if (err != cudaSuccess) return err;
  kern<<<(p.M + BM - 1) / BM, kThreads, smem_bytes(BM, p.C), st>>>(p,
                                                                    valid);
  return cudaGetLastError();
}

// One launch of the pass on stream st (f32 rows and weights).
template <typename Valid>
cudaError_t run(const Params& p, const Valid& valid, cudaStream_t st) {
  if (p.cout % 32 != 0) return cudaErrorInvalidValue;
  switch (pick_rows(p.M, p.C)) {
    case 8: return launch<8>(p, valid, st);
    case 16: return launch<16>(p, valid, st);
    case 32: return launch<32>(p, valid, st);
    case 64: return launch<64>(p, valid, st);
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
