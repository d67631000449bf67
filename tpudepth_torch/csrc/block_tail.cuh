// Device code of the f32 transformer block tail and FFN on the CUDA cores,
// shared by epilogue_infer.cu (the f32 block_epilogue_infer and mlp_infer),
// mlp_train.cu (the f32 mlp_train_fwd), rowblock_infer.cu and
// block_infer.cu (the f32 tails of the row and whole-block kernels), and
// ln_proj.cuh (the f32 LayerNorm-and-projection pass in front of their
// attention). The arithmetic, the design and what bounds it are described
// at the top of epilogue_infer.cu. Every bf16 tail and FFN runs on the
// wgmma core of gemm_sm90.cuh (tail_chain.cuh) instead; the LayerNorm
// helpers and the argument block here are shared with it.
//
// Everything is in namespace tail inside an unnamed namespace: each source
// that includes it gets its own copy with internal linkage, and the names do
// not meet those of window_attn.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace tail {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;     // depth of a k-block
constexpr int kNC = 128;    // widest output (or hidden) chunk
constexpr size_t kSmemLimit = 232448;  // 227 KB: the most a block may have
constexpr float kInvSqrt2 = 0.70710678118654752f;

// What a tail computes from the rows o (and the shortcut x), in f32:
//   kFfn       out = fc2(gelu(fc1(o)))          (mlp_infer, mlp_train_fwd)
//   kEpilogue  y = x + (o Wp + bp), out = y + fc2(gelu(fc1(LN(y))))
//                                   (block_epilogue_infer, the row kernels)
//   kBlock     the same                        (the whole-block kernels)
// kEpilogue and kBlock differ in the rounding of bf16 alone, which the
// chains of tail_chain.cuh keep (tail_bf16, tail_block_bf16).
enum Mode { kFfn, kEpilogue, kBlock };

struct Params {
  const void* o;      // epilogue: attention output [M, C]; mlp: x [M, Cin]
  const void* x;      // epilogue: shortcut [M, C]; mlp: unused
  const void* wp;     // [C, C] torch layout [out, in], IO dtype
  const float* bp;
  const float* lns;   // LayerNorm scale and bias [C]
  const float* lnb;
  const void* w1;     // [H, Cin] torch layout, IO dtype
  const float* b1;
  const void* w2;     // [Cout, H] torch layout, IO dtype
  const float* b2;
  void* out;          // [M, Cout]
  int M, cin, hidden, cout;
};

// The arguments of a block tail (kEpilogue, kBlock, and the chains of
// tail_chain.cuh): o the attention output and x the shortcut, [M, C]; the
// projection, LayerNorm and FFN parameters; out [M, C] (may be o).
inline Params block_params(const void* o, const void* x, const void* wp,
                           const void* bp, const void* lns, const void* lnb,
                           const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, int M, int C,
                           int hidden) {
  Params p = {};
  p.o = o;
  p.x = x;
  p.wp = wp;
  p.bp = static_cast<const float*>(bp);
  p.lns = static_cast<const float*>(lns);
  p.lnb = static_cast<const float*>(lnb);
  p.w1 = w1;
  p.b1 = static_cast<const float*>(b1);
  p.w2 = w2;
  p.b2 = static_cast<const float*>(b2);
  p.out = out;
  p.M = M;
  p.cin = C;
  p.hidden = hidden;
  p.cout = C;
  return p;
}

__host__ __device__ inline int chunk_of(int n) { return n < kNC ? n : kNC; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.0f + erff(h * kInvSqrt2));
}

// LN of one row yr into ar by the calling warp (flax's fast variance, eps
// 1e-5).
__device__ __forceinline__ void layer_norm_row(const float* yr, float* ar,
                                               int C, const float* scale,
                                               const float* bias) {
  const int lane = threadIdx.x & 31;
  const float inv_c = 1.0f / static_cast<float>(C);
  float s = 0.f, s2 = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float v = yr[k];
    s += v;
    s2 += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mean = s * inv_c;
  const float var = fmaxf(s2 * inv_c - mean * mean, 0.f);
  const float rs = rsqrtf(var + 1e-5f);
  for (int k = lane; k < C; k += 32) {
    ar[k] = (yr[k] - mean) * (rs * scale[k]) + bias[k];
  }
}

// LN of the rows of y (row stride ldy) into a (row stride lda), one warp
// per row.
__device__ void layer_norm_rows(const float* y, int ldy, float* a, int lda,
                                int rows, int C, const float* scale,
                                const float* bias) {
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    layer_norm_row(y + r * ldy, a + r * lda, C, scale, bias);
  }
}

// Shared-memory layout in floats: a [BM, cin], y [BM, cin] (epilogue only),
// acc [BM, cout], g [BM, hc], w [kBK, kNC + 1].
__host__ __device__ inline size_t f32_smem_floats(int bm, int cin, int hidden,
                                                  int cout, bool epilogue) {
  return static_cast<size_t>(bm) *
             (cin + (epilogue ? cin : 0) + cout + chunk_of(hidden)) +
         static_cast<size_t>(kBK) * (kNC + 1);
}

// acc[r][c] (r < BM/8, c < nc/32) += A[rows, 0:kdim] . W[n0:n0+nc, 0:kdim]^T
// for the thread's rows ty + 8 r and columns tx + 32 c of the chunk. A lives
// in shared memory with row stride lda; W (torch layout, row stride ldw) is
// staged through ws in tiles of kBK.
template <int BM>
__device__ __forceinline__ void f32_gemm(float (&acc)[BM / 8][4],
                                         const float* a, int lda,
                                         const float* w, int ldw, int n0,
                                         int nc, int kdim, float* ws) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int cpt = nc / 32;
  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    for (int e = tid; e < nc * kBK; e += kThreads) {
      const int n = e / kBK;
      const int k = e - n * kBK;
      ws[k * (kNC + 1) + n] = w[static_cast<size_t>(n0 + n) * ldw + k0 + k];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float av[BM / 8];
#pragma unroll
      for (int r = 0; r < BM / 8; ++r) av[r] = a[(ty + 8 * r) * lda + k0 + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < cpt) {
          const float wv = ws[k * (kNC + 1) + tx + 32 * c];
#pragma unroll
          for (int r = 0; r < BM / 8; ++r) acc[r][c] = fmaf(av[r], wv, acc[r][c]);
        }
      }
    }
    __syncthreads();
  }
}

template <int BM>
__device__ __forceinline__ void zero_f32(float (&acc)[BM / 8][4]) {
#pragma unroll
  for (int r = 0; r < BM / 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

template <int BM, bool kEpilogue>
__global__ void __launch_bounds__(kThreads) tail_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int row0 = blockIdx.x * BM;
  const int C = p.cin;
  const int hc = chunk_of(p.hidden);
  const int ncout = chunk_of(p.cout);
  float* a_s = smem;
  float* y_s = a_s + BM * C;
  float* acc_s = y_s + (kEpilogue ? BM * C : 0);
  float* g_s = acc_s + BM * p.cout;
  float* ws = g_s + BM * hc;

  const float* o = static_cast<const float*>(p.o);
  // rows past M are zeros: computed on, never written
  for (int e = tid; e < BM * C; e += kThreads) {
    const int r = e / C;
    const size_t gi = static_cast<size_t>(row0) * C + e;
    const bool in = row0 + r < p.M;
    a_s[e] = in ? o[gi] : 0.f;
    if (kEpilogue) y_s[e] = in ? static_cast<const float*>(p.x)[gi] : 0.f;
  }
  __syncthreads();

  float acc[BM / 8][4];
  if (kEpilogue) {
    // y = x + (o Wp + bp) over 128-column chunks
    const float* wp = static_cast<const float*>(p.wp);
    for (int n0 = 0; n0 < C; n0 += ncout) {
      zero_f32<BM>(acc);
      f32_gemm<BM>(acc, a_s, C, wp, C, n0, ncout, C, ws);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < ncout / 32) {
          const int n = n0 + tx + 32 * c;
#pragma unroll
          for (int r = 0; r < BM / 8; ++r) {
            y_s[(ty + 8 * r) * C + n] += acc[r][c] + p.bp[n];
          }
        }
      }
    }
    __syncthreads();
    layer_norm_rows(y_s, C, a_s, C, BM, C, p.lns, p.lnb);
    __syncthreads();
  }

  // FFN into acc_s over the hidden chunks
  const float* w1 = static_cast<const float*>(p.w1);
  const float* w2 = static_cast<const float*>(p.w2);
  for (int e = tid; e < BM * p.cout; e += kThreads) acc_s[e] = 0.f;
  for (int j0 = 0; j0 < p.hidden; j0 += hc) {
    zero_f32<BM>(acc);
    f32_gemm<BM>(acc, a_s, C, w1, C, j0, hc, C, ws);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < hc / 32) {
        const int j = tx + 32 * c;
#pragma unroll
        for (int r = 0; r < BM / 8; ++r) {
          g_s[(ty + 8 * r) * hc + j] = gelu(acc[r][c] + p.b1[j0 + j]);
        }
      }
    }
    __syncthreads();
    for (int n0 = 0; n0 < p.cout; n0 += ncout) {
#pragma unroll
      for (int r = 0; r < BM / 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = c < ncout / 32
                          ? acc_s[(ty + 8 * r) * p.cout + n0 + tx + 32 * c]
                          : 0.f;
      f32_gemm<BM>(acc, g_s, hc, w2 + j0, p.hidden, n0, ncout, hc, ws);
#pragma unroll
      for (int r = 0; r < BM / 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < ncout / 32)
            acc_s[(ty + 8 * r) * p.cout + n0 + tx + 32 * c] = acc[r][c];
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(p.out);
  for (int e = tid; e < BM * p.cout; e += kThreads) {
    const int r = e / p.cout;
    if (row0 + r >= p.M) continue;
    const int n = e - r * p.cout;
    float m = acc_s[e] + p.b2[n];
    if (kEpilogue) m = y_s[e] + m;
    out[static_cast<size_t>(row0) * p.cout + e] = m;
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t opt_in(K kern, bool& done) {
  if (done) return cudaSuccess;  // once per kernel, before any graph capture
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemLimit));
  done = err == cudaSuccess;
  return err;
}

template <int BM, bool kEpilogue>
cudaError_t launch_f32(const Params& p, cudaStream_t st) {
  static bool done = false;
  auto kern = tail_f32_kernel<BM, kEpilogue>;
  const cudaError_t err = opt_in(kern, done);
  if (err != cudaSuccess) return err;
  const size_t smem =
      f32_smem_floats(BM, p.cin, p.hidden, p.cout, kEpilogue) * sizeof(float);
  kern<<<(p.M + BM - 1) / BM, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// Widths the kernels (and the chains of tail_chain.cuh) take: a multiple of
// 32, at most 128 or a multiple of 128 (the chunks are 128 wide, or the
// whole width below that); Cout at most 1024.
bool width_ok(int n) { return n >= 32 && n % 32 == 0 && (n <= kNC || n % kNC == 0); }

// Row tile in rows: the largest that fits in shared memory, halved while
// the grid would leave SMs idle. 0 when nothing fits.
int pick_rows(int M, int cin, int hidden, int cout, bool epilogue) {
  int bm = 64;
  while (bm > 8 && f32_smem_floats(bm, cin, hidden, cout, epilogue) *
                           sizeof(float) > kSmemLimit)
    bm /= 2;
  if (f32_smem_floats(bm, cin, hidden, cout, epilogue) * sizeof(float) >
      kSmemLimit)
    return 0;
  while (bm > 8 && (M + bm - 1) / bm < 132) bm /= 2;
  return bm;
}

// The shapes a tail takes: M >= 1, widths width_ok, Cout <= 1024, and
// Cout = Cin outside kFfn.
inline bool shape_ok(const Params& p, Mode mode) {
  return p.M >= 1 && width_ok(p.cin) && width_ok(p.hidden) &&
         width_ok(p.cout) && p.cout <= 1024 &&
         (mode == kFfn || p.cout == p.cin);
}

// One launch of the f32 tail in mode kMode (the bf16 tails are the chains
// of tail_chain.cuh).
template <Mode kMode>
cudaError_t run(const Params& p, void* stream) {
  constexpr bool kEpilogue = kMode != kFfn;
  if (!shape_ok(p, kMode)) return cudaErrorInvalidValue;
  const int rows = pick_rows(p.M, p.cin, p.hidden, p.cout, kEpilogue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 8: return launch_f32<8, kEpilogue>(p, st);
    case 16: return launch_f32<16, kEpilogue>(p, st);
    case 32: return launch_f32<32, kEpilogue>(p, st);
    case 64: return launch_f32<64, kEpilogue>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tail
}  // namespace
