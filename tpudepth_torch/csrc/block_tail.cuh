// Device code of the transformer block tail and FFN on mma.sync and the
// CUDA cores, shared by epilogue_infer.cu (the f32 block_epilogue_infer and
// mlp_infer), mlp_train.cu (the f32 mlp_train_fwd), rowblock_infer.cu and
// block_infer.cu (the f32 tails of the row and whole-block kernels, and
// crf_block_infer's bf16 tail), and ln_proj.cuh (the LayerNorm-and-
// projection pass in front of their attention). The arithmetic, the design
// and what bounds it are described at the top of epilogue_infer.cu; the
// tail of the whole-block kernels (Mode kBlock) keeps y in f32, as the top
// of block_infer.cu describes. Every other bf16 tail and FFN runs on the
// wgmma core of gemm_sm90.cuh (tail_chain.cuh) instead: the bf16 kernel
// here is kBlock's alone, the FFN mode f32 only.
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

// What a tail computes from the rows o (and the shortcut x):
//   kFfn       out = fc2(gelu(fc1(o))), f32 only (mlp_infer, mlp_train_fwd)
//   kEpilogue  y = x + (o Wp + bp), out = y + fc2(gelu(fc1(LN(y)))), f32
//              only (block_epilogue_infer, the row kernels)
//   kBlock     y = x + (o Wp + bp) and m = fc2(...) kept in f32,
//              out = round(y + m)                 (the whole-block kernels)
// LN(y), h and gelu(h) are rounded to the IO dtype in kBlock.
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

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Eight bf16 values (one 16-byte piece) into f32 y.
__device__ __forceinline__ void store8(float* y, uint4 v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(y)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(y)[1] = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.0f + erff(h * kInvSqrt2));
}

// LN of one row yr into ar by the calling warp; Y and A are float or
// __nv_bfloat16 (then rounded).
template <typename Y, typename A>
__device__ __forceinline__ void layer_norm_row(const Y* yr, A* ar, int C,
                                               const float* scale,
                                               const float* bias) {
  const int lane = threadIdx.x & 31;
  const float inv_c = 1.0f / static_cast<float>(C);
  float s = 0.f, s2 = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float v = static_cast<float>(yr[k]);
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
    const float v = (static_cast<float>(yr[k]) - mean) * (rs * scale[k]) +
                    bias[k];
    ar[k] = static_cast<A>(v);
  }
}

// LN of the rows of y (row stride ldy) into a (row stride lda), one warp
// per row.
template <typename Y, typename A>
__device__ void layer_norm_rows(const Y* y, int ldy, A* a, int lda, int rows,
                                int C, const float* scale, const float* bias) {
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    layer_norm_row(y + r * ldy, a + r * lda, C, scale, bias);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[m][i] (8-column tile warp + 8 i of the output, rows 16 m .. 16 m + 15)
// += A[:, 0:kdim] W[tile rows, 0:kdim]^T, for the tiles < ntiles. A is bf16
// in shared memory (row stride lda, a multiple of 8); W is bf16 [n][k] in
// device memory (row stride ldw, a multiple of 8).
template <int MT, int NT>
__device__ __forceinline__ void mma_gemm(float (&acc)[MT][NT][4],
                                         const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* w, int ldw,
                                         int kdim, int ntiles) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    uint4 bf[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int nt = warp + kWarps * i;
      if (nt < ntiles) {
        bf[i] = __ldg(reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(nt * 8 + g) * ldw + k0 + 8 * t));
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint4 r0 = *reinterpret_cast<const uint4*>(
          a + (m * 16 + g) * lda + k0 + 8 * t);
      const uint4 r1 = *reinterpret_cast<const uint4*>(
          a + (m * 16 + g + 8) * lda + k0 + 8 * t);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (warp + kWarps * i < ntiles) {
          mma_bf16(acc[m][i], r0.x, r1.x, r0.y, r1.y, bf[i].x, bf[i].y);
          mma_bf16(acc[m][i], r0.z, r1.z, r0.w, r1.w, bf[i].z, bf[i].w);
        }
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][i][c] = 0.f;
}

// Row padding (in bf16 elements) that makes the row stride 32 mod 64: the
// 16-byte A loads of one quarter warp (two rows, four lanes each) then fall
// in distinct banks.
__host__ __device__ inline int padded(int n) { return n + (96 - n % 64) % 64; }

// a [BM][lda] and g [BM][ldg] in bf16, y [BM][C] in f32.
__host__ __device__ inline size_t mma_smem_bytes(int mt, int cin,
                                                 int hidden) {
  const size_t bm = 16 * static_cast<size_t>(mt);
  return 2 * bm * (padded(cin) + padded(chunk_of(hidden))) + 4 * bm * cin;
}

// The bf16 tail of the whole-block kernels (kBlock; crf_block_infer).
// NT = 16 / MT: the accumulator holds 64 floats per thread, which covers
// Cout <= 1024 at MT = 1 (16 tiles per warp) down to Cout <= 128 at MT = 8.
// With it the f32 y is at most 16 x 1024 floats (64 KB).
template <int MT>
__global__ void __launch_bounds__(kThreads, 1) tail_mma_kernel(const Params p) {
  constexpr int NT = 16 / MT;
  constexpr int BM = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int C = p.cin;
  const int lda = padded(C);
  const int hc = chunk_of(p.hidden);
  const int ldg = padded(hc);
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* y_s = reinterpret_cast<float*>(a_s + BM * lda);    // [BM][C]
  __nv_bfloat16* g_s = reinterpret_cast<__nv_bfloat16*>(y_s + BM * C);
                                                            // [BM][ldg]

  // the row tile, 8 bf16 at a time; rows past M are zeros, never written
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const int c8 = C / 8;
  for (int e = threadIdx.x; e < BM * c8; e += kThreads) {
    const int r = e / c8;
    const int k = (e - r * c8) * 8;
    const bool in = row0 + r < p.M;
    const size_t gi = static_cast<size_t>(row0 + r) * C + k;
    const uint4 zero4 = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(a_s + r * lda + k) =
        in ? *reinterpret_cast<const uint4*>(o + gi) : zero4;
    store8(y_s + r * C + k,
           in ? *reinterpret_cast<const uint4*>(x + gi) : zero4);
  }
  __syncthreads();

  // y = x + z in f32 in place in y_s (each element is owned by one thread)
  float acc[MT][NT][4];
  const int ntiles = p.cout / 8;
  zero(acc);
  mma_gemm<MT, NT>(acc, a_s, lda, static_cast<const __nv_bfloat16*>(p.wp), C,
                   C, ntiles);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NT; ++i)
      if (warp + kWarps * i < ntiles)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = m * 16 + g + (c >> 1) * 8;
          const int n = (warp + kWarps * i) * 8 + 2 * t + (c & 1);
          y_s[r * C + n] += acc[m][i][c] + p.bp[n];
        }
  __syncthreads();
  layer_norm_rows(y_s, C, a_s, lda, BM, C, p.lns, p.lnb);
  __syncthreads();

  // FFN: acc = g W2 over the hidden chunks, g = gelu(round(a W1 + b1))
  zero(acc);
  const __nv_bfloat16* w1 = static_cast<const __nv_bfloat16*>(p.w1);
  const __nv_bfloat16* w2 = static_cast<const __nv_bfloat16*>(p.w2);
  for (int j0 = 0; j0 < p.hidden; j0 += hc) {
    float h[MT][2][4];
    zero(h);
    mma_gemm<MT, 2>(h, a_s, lda, w1 + static_cast<size_t>(j0) * C, C, C,
                    hc / 8);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (warp + kWarps * i < hc / 8)
#pragma unroll
          for (int c = 0; c < 4; c += 2) {
            const int r = m * 16 + g + (c >> 1) * 8;
            const int j = (warp + kWarps * i) * 8 + 2 * t;
            const float h0 = bf16r(h[m][i][c] + p.b1[j0 + j]);
            const float h1 = bf16r(h[m][i][c + 1] + p.b1[j0 + j + 1]);
            *reinterpret_cast<__nv_bfloat162*>(g_s + r * ldg + j) =
                __floats2bfloat162_rn(gelu(h0), gelu(h1));
          }
    __syncthreads();
    mma_gemm<MT, NT>(acc, g_s, ldg, w2 + j0, p.hidden, hc, ntiles);
    __syncthreads();
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NT; ++i)
      if (warp + kWarps * i < ntiles)
#pragma unroll
        for (int c = 0; c < 4; c += 2) {
          const int r = m * 16 + g + (c >> 1) * 8;
          if (row0 + r >= p.M) continue;
          const int n = (warp + kWarps * i) * 8 + 2 * t;
          const float v0 = y_s[r * C + n] + (acc[m][i][c] + p.b2[n]);
          const float v1 =
              y_s[r * C + n + 1] + (acc[m][i][c + 1] + p.b2[n + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(row0 + r) * p.cout + n) =
              __floats2bfloat162_rn(v0, v1);
        }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

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

template <int MT>
cudaError_t launch_mma(const Params& p, cudaStream_t st) {
  static bool done = false;
  auto kern = tail_mma_kernel<MT>;
  const cudaError_t err = opt_in(kern, done);
  if (err != cudaSuccess) return err;
  const int blocks = (p.M + 16 * MT - 1) / (16 * MT);
  kern<<<blocks, kThreads, mma_smem_bytes(MT, p.cin, p.hidden), st>>>(p);
  return cudaGetLastError();
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

// Widths the kernels take: a multiple of 32, at most 128 or a multiple of
// 128 (the chunks are 128 wide, or the whole width below that); Cout at
// most 1024 (the bf16 accumulator).
bool width_ok(int n) { return n >= 32 && n % 32 == 0 && (n <= kNC || n % kNC == 0); }

// Row tile in rows for the bf16 kernel (16 MT) or the f32 kernel: the
// largest that fits (registers, shared memory), halved while the grid would
// leave SMs idle. 0 when nothing fits.
int pick_rows(int M, int cin, int hidden, int cout, Mode mode, bool bf16) {
  const bool epilogue = mode != kFfn;
  if (bf16) {
    const int nt = (cout / 8 + kWarps - 1) / kWarps;   // tiles per warp
    int mt = 8;
    while (mt > 1 && (mt * nt > 16 ||
                      mma_smem_bytes(mt, cin, hidden) > kSmemLimit))
      mt /= 2;
    if (mt * nt > 16 || mma_smem_bytes(mt, cin, hidden) > kSmemLimit)
      return 0;
    while (mt > 1 && (M + 16 * mt - 1) / (16 * mt) < 132) mt /= 2;
    return 16 * mt;
  }
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

// One launch of the tail in mode kMode (bf16: kBlock only). In f32 kBlock
// is kEpilogue: the IO dtype rounds nothing.
template <Mode kMode>
cudaError_t run(const Params& p, int is_bf16, void* stream) {
  constexpr bool kEpilogue = kMode != kFfn;
  if (!shape_ok(p, kMode)) return cudaErrorInvalidValue;
  const int rows = pick_rows(p.M, p.cin, p.hidden, p.cout, kMode, is_bf16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if constexpr (kMode != kBlock) {
      return cudaErrorInvalidValue;
    } else {
      switch (rows) {
        case 16: return launch_mma<1>(p, st);
        case 32: return launch_mma<2>(p, st);
        case 64: return launch_mma<4>(p, st);
        case 128: return launch_mma<8>(p, st);
        default: return cudaErrorInvalidValue;
      }
    }
  }
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
