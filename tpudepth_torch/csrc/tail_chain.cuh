// The bf16 block tails as chains of products on the wgmma core
// (gemm_sm90.cuh), and the LayerNorm-and-projection pass in front of a
// window attention on the same core, shared by epilogue_infer.cu
// (block_epilogue_infer), rowblock_infer.cu (crf_rowblock_infer,
// sam_rowblock_infer) and block_infer.cu (sam_block_infer):
//
//   tail_bf16:   y = round(x + round(o Wp + bp)); yn = round(LN(y));
//                g = round(gelu(round(yn W1 + b1)));
//                out = round(y + round(g W2 + b2))
//   tail_block_bf16 (the whole-block kernels' rounding):
//                y = x + (o Wp + bp) in f32; yn = round(LN(y));
//                g = round(gelu(round(yn W1 + b1)));
//                out = round(y + (g W2 + b2))
//   ln_project:  out[:, 0:N] = round((round(LN(x) valid) W^T + b), the
//                columns below nscale times scale before the rounding)
//
// over rows [M, C] in bf16, sums in f32. Each tensor that a chain spills to
// device memory is one its TPU kernel rounds to bf16 anyway, or (the f32 y
// of tail_block_bf16) one it keeps in f32, spilled in f32, so a chain keeps
// the rounding order exactly; only the order of the f32 sums differs. The
// LayerNorm passes take a validity functor (valid(row) false: a pad token,
// whose LN row is zeros and whose projection is the bias alone), and a
// projection writes its output at a row stride of its own (the q and kv
// columns of one [M, 3C] tensor).
//
// Everything is in namespace chain inside an unnamed namespace, as in the
// other headers.

#pragma once

#include "block_tail.cuh"
#include "gemm_sm90.cuh"

namespace {
namespace chain {

// out[r, c] = round(res[r, c] + round(acc + bias[c])): steps 1 and 4. The
// residual tile comes in by TMA into the staging slot, and the output is
// written over it there (tile maps: out, res).
struct BiasResidual {
  static constexpr int kProducts = 1;
  static constexpr int kTiles = 2;
  static constexpr int kSmemBytes = 0;
  struct Params {
    const float* bias;
    int N;
  };
  template <int BN>
  static __device__ __forceinline__ void apply(const Params& p,
                                               float (&acc)[1][BN / 2],
                                               const gemm::Tile& t,
                                               unsigned char*,
                                               const CUtensorMap* c,
                                               unsigned char* staging,
                                               uint32_t bar) {
    gemm::store_pairs_res<BN>(
        acc[0], &c[0], &c[1], staging, bar, t.iter & 1, t.m0, t.n0,
        [&](int c, float v0, float v1, uint32_t res) {
          const int col = t.n0 + c;
          const float b0 = col < p.N ? p.bias[col] : 0.f;
          const float b1 = col < p.N ? p.bias[col + 1] : 0.f;
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&res));
          return gemm::pack2(r.x + gemm::bf16r(v0 + b0),
                             r.y + gemm::bf16r(v1 + b1));
        });
  }
};

// P values of type T from (to) P sizeof(T)-byte aligned memory, 16 bytes a
// load where P allows.
template <int P, typename T>
__device__ __forceinline__ void copy_piece(const T* src, T* dst) {
  constexpr int kBytes = P * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(src)[i];
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<uint32_t*>(dst) =
        *reinterpret_cast<const uint32_t*>(src);
  } else {
    *dst = *src;
  }
}

// yn = round(LN(y) valid) over rows of C = 32 V: step 2, and the
// LayerNorm in front of a projection (ln_rows). y is bf16, or f32 (the
// whole-block tail's y). One warp a row, read once into registers and
// written once, in pieces of P = 8, 4, 2 or 1 values (the widest that
// divides V): piece j of lane l holds the values (32 j + l) P.., so each
// load instruction covers 32 P contiguous values. layer_norm_row's f32
// arithmetic (flax's fast variance, eps 1e-5), its sums added in another
// order. kVec: scale and bias are 16-byte aligned and read 4 floats at a
// time. valid(row) false (a pad token): a row of zeros.
template <int V, bool kVec, typename T, typename Valid>
__global__ void __launch_bounds__(tail::kThreads)
    layer_norm_kernel(const T* y, __nv_bfloat16* yn, int M,
                      const float* scale, const float* bias,
                      const Valid valid) {
  constexpr int C = 32 * V;
  constexpr int P = V % 8 == 0 ? 8 : V % 4 == 0 ? 4 : V % 2 == 0 ? 2 : 1;
  const int row = blockIdx.x * tail::kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const int lane = threadIdx.x & 31;
  const T* yr = y + static_cast<size_t>(row) * C;
  __nv_bfloat16* ynr = yn + static_cast<size_t>(row) * C;
  __nv_bfloat16 b[V];
  if (!valid(row)) {
#pragma unroll
    for (int i = 0; i < V; ++i) b[i] = __float2bfloat16(0.f);
#pragma unroll
    for (int j = 0; j < V / P; ++j)
      copy_piece<P>(b + j * P, ynr + (32 * j + lane) * P);
    return;
  }
  T in[V];
#pragma unroll
  for (int j = 0; j < V / P; ++j)
    copy_piece<P>(yr + (32 * j + lane) * P, in + j * P);
  float v[V];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] = tail::to_f32(in[i]);
    s += v[i];
    s2 += v[i] * v[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mean = s * (1.0f / C);
  const float var = fmaxf(s2 * (1.0f / C) - mean * mean, 0.f);
  const float rs = rsqrtf(var + 1e-5f);
#pragma unroll
  for (int j = 0; j < V / P; ++j) {
    // the piece's scale and bias, 16 bytes at a time where P allows
    const int k0 = (32 * j + lane) * P;
    float sc[P], bi[P];
#pragma unroll
    for (int i = 0; i < P; i += (kVec && P % 4 == 0 ? 4 : 1)) {
      if constexpr (kVec && P % 4 == 0) {
        *reinterpret_cast<float4*>(sc + i) =
            *reinterpret_cast<const float4*>(scale + k0 + i);
        *reinterpret_cast<float4*>(bi + i) =
            *reinterpret_cast<const float4*>(bias + k0 + i);
      } else {
        sc[i] = scale[k0 + i];
        bi[i] = bias[k0 + i];
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i)
      b[j * P + i] = __float2bfloat16((v[j * P + i] - mean) * (rs * sc[i]) +
                                      bi[i]);
  }
#pragma unroll
  for (int j = 0; j < V / P; ++j)
    copy_piece<P>(b + j * P, ynr + (32 * j + lane) * P);
}

// Every row is a real token (the block tail).
struct AllValid {
  __device__ __forceinline__ bool operator()(int) const { return true; }
};

template <int V, typename T, typename Valid>
cudaError_t layer_norm(const T* y, __nv_bfloat16* yn, int M,
                       const float* scale, const float* bias,
                       const Valid& valid, cudaStream_t st) {
  const int blocks = (M + tail::kWarps - 1) / tail::kWarps;
  if ((reinterpret_cast<uintptr_t>(scale) |
       reinterpret_cast<uintptr_t>(bias)) % 16 == 0) {
    layer_norm_kernel<V, true><<<blocks, tail::kThreads, 0, st>>>(
        y, yn, M, scale, bias, valid);
  } else {
    layer_norm_kernel<V, false><<<blocks, tail::kThreads, 0, st>>>(
        y, yn, M, scale, bias, valid);
  }
  return cudaGetLastError();
}

// yn = round(LN(y) valid) of bf16 or f32 rows y for the widths the kernel
// takes (tail::width_ok, at most 1024).
template <typename T, typename Valid = AllValid>
cudaError_t layer_norm_rows(const T* y, __nv_bfloat16* yn, int M,
                            int C, const float* scale, const float* bias,
                            cudaStream_t st, const Valid& valid = Valid()) {
  switch (C / 32) {
    case 1: return layer_norm<1>(y, yn, M, scale, bias, valid, st);
    case 2: return layer_norm<2>(y, yn, M, scale, bias, valid, st);
    case 3: return layer_norm<3>(y, yn, M, scale, bias, valid, st);
    case 4: return layer_norm<4>(y, yn, M, scale, bias, valid, st);
    case 8: return layer_norm<8>(y, yn, M, scale, bias, valid, st);
    case 12: return layer_norm<12>(y, yn, M, scale, bias, valid, st);
    case 16: return layer_norm<16>(y, yn, M, scale, bias, valid, st);
    case 20: return layer_norm<20>(y, yn, M, scale, bias, valid, st);
    case 24: return layer_norm<24>(y, yn, M, scale, bias, valid, st);
    case 28: return layer_norm<28>(y, yn, M, scale, bias, valid, st);
    case 32: return layer_norm<32>(y, yn, M, scale, bias, valid, st);
    default: return cudaErrorInvalidValue;
  }
}

// The block tail as a chain of four kernels (block_epilogue_infer's steps
// 1-4, epilogue_infer.cu): out = round(y + round(g W2 + b2)) with
// y = round(x + round(o Wp + bp)), yn = round(LN(y)), g =
// round(gelu(round(yn W1 + b1))), through the bf16 scratch y, yn [M, C] and
// g [M, hidden]. p.out may be p.o (in place): o is read by step 1 alone.
cudaError_t tail_bf16(const tail::Params& p, __nv_bfloat16* y,
                      __nv_bfloat16* yn, __nv_bfloat16* g, cudaStream_t st) {
  using gemm::product;
  const int M = p.M, C = p.cin, H = p.hidden;
  cudaError_t err = gemm::fill_once<gemm::gelu_table_kernel>(st);
  if (err == cudaSuccess)
    err = product<BiasResidual>({p.bp, C}, p.o, p.wp, y, p.x, M, C, C, st);
  if (err == cudaSuccess) err = layer_norm_rows(y, yn, M, C, p.lns, p.lnb, st);
  if (err == cudaSuccess)
    err = product<gemm::BiasGelu>({p.b1, H}, yn, p.w1, g, nullptr, M, H, C,
                                  st);
  if (err != cudaSuccess) return err;
  return product<BiasResidual>({p.b2, C}, g, p.w2, p.out, y, M, C, H, st);
}

// y[r, c] = x[r, c] + (acc + bias[c]) in f32, for r < M, c < N: step 1 of
// the whole-block tail. Both x (bf16) and y (f32) are [M, N] rows; each
// lane reads its pairs of x and writes its pairs of y from the fragment, a
// float2 a pair, so a quad of lanes writes one whole 32-byte sector (a
// 128-wide f32 tile would not fit the staging slot). The loads are
// read-only (__ldg), so they may run ahead of the stores.
struct BiasResidualToF32 {
  static constexpr int kProducts = 1;
  static constexpr int kTiles = 0;
  static constexpr int kSmemBytes = 0;
  struct Params {
    const float* bias;
    const __nv_bfloat16* x;
    float* y;
    int M, N;
  };
  template <int BN>
  static __device__ __forceinline__ void apply(const Params& p,
                                               float (&acc)[1][BN / 2],
                                               const gemm::Tile& t,
                                               unsigned char*,
                                               const CUtensorMap*,
                                               unsigned char*, uint32_t) {
    gemm::for_pairs<BN>(acc[0], [&](int r, int c, float v0, float v1) {
      const int row = t.m0 + r, col = t.n0 + c;
      if (row >= p.M || col >= p.N) return;
      const size_t i = static_cast<size_t>(row) * p.N + col;
      const float2 x = __bfloat1622float2(
          __ldg(reinterpret_cast<const __nv_bfloat162*>(p.x + i)));
      *reinterpret_cast<float2*>(p.y + i) =
          make_float2(x.x + (v0 + p.bias[col]), x.y + (v1 + p.bias[col + 1]));
    });
  }
};

// out[r, c] = round(y[r, c] + (acc + bias[c])) with y f32 [M, N], for c < N:
// step 4 of the whole-block tail (m = g W2 + b2 not rounded before the
// add). y is read a float2 a pair (a quad of lanes: one 32-byte sector); the
// output leaves through the staging slot by TMA (tile map: out).
struct BiasResidualF32 {
  static constexpr int kProducts = 1;
  static constexpr int kTiles = 1;
  static constexpr int kSmemBytes = 0;
  struct Params {
    const float* bias;
    const float* y;
    int M, N;
  };
  template <int BN>
  static __device__ __forceinline__ void apply(const Params& p,
                                               float (&acc)[1][BN / 2],
                                               const gemm::Tile& t,
                                               unsigned char*,
                                               const CUtensorMap* c,
                                               unsigned char* staging,
                                               uint32_t) {
    gemm::store_pairs<BN>(acc[0], c, staging, t.m0, t.n0,
                          [&](int r, int c, float v0, float v1) {
      const int row = t.m0 + r, col = t.n0 + c;
      if (row >= p.M || col >= p.N) return 0u;
      const float2 y = __ldg(reinterpret_cast<const float2*>(
          p.y + static_cast<size_t>(row) * p.N + col));
      return gemm::pack2(y.x + (v0 + p.bias[col]),
                         y.y + (v1 + p.bias[col + 1]));
    });
  }
};

// The whole-block tail (block_infer.cu, the TPU kernel's _ffn_residual) as
// a chain of four kernels: out = round(y + (g W2 + b2)) with y = x + (o Wp +
// bp) in f32, yn = round(LN(y)), g = round(gelu(round(yn W1 + b1))), through
// the scratch y f32 [M, C], yn bf16 [M, C] and g bf16 [M, hidden]. p.out may
// be p.o (in place): o is read by step 1 alone.
cudaError_t tail_block_bf16(const tail::Params& p, float* y,
                            __nv_bfloat16* yn, __nv_bfloat16* g,
                            cudaStream_t st) {
  using gemm::product;
  const int M = p.M, C = p.cin, H = p.hidden;
  cudaError_t err = gemm::fill_once<gemm::gelu_table_kernel>(st);
  if (err == cudaSuccess)
    err = product<BiasResidualToF32>(
        {p.bp, static_cast<const __nv_bfloat16*>(p.x), y, M, C}, p.o, p.wp,
        nullptr, nullptr, M, C, C, st);
  if (err == cudaSuccess)
    err = layer_norm_rows(static_cast<const float*>(y), yn, M, C, p.lns,
                          p.lnb, st);
  if (err == cudaSuccess)
    err = product<gemm::BiasGelu>({p.b1, H}, yn, p.w1, g, nullptr, M, H, C,
                                  st);
  if (err != cudaSuccess) return err;
  return product<BiasResidualF32>({p.b2, y, M, C}, g, p.w2, p.out, nullptr, M,
                                  C, H, st);
}

// out[r, c] = round((acc + bias[c]) * scale) for c < nscale, round(acc +
// bias[c]) above, for c < N: the projections in front of an attention (q
// scaled in f32 and rounded once). Stored through the staging slot by TMA
// at the output map's row stride.
struct BiasScaleRound {
  static constexpr int kProducts = 1;
  static constexpr int kTiles = 1;
  static constexpr int kSmemBytes = 0;
  struct Params {
    const float* bias;
    int N, nscale;
    float scale;
  };
  template <int BN>
  static __device__ __forceinline__ void apply(const Params& p,
                                               float (&acc)[1][BN / 2],
                                               const gemm::Tile& t,
                                               unsigned char*,
                                               const CUtensorMap* c,
                                               unsigned char* staging,
                                               uint32_t) {
    gemm::store_pairs<BN>(acc[0], c, staging, t.m0, t.n0,
                          [&](int, int c, float v0, float v1) {
      const int col = t.n0 + c;
      if (col >= p.N) return 0u;
      v0 += p.bias[col];
      v1 += p.bias[col + 1];
      if (col < p.nscale) v0 *= p.scale;
      if (col + 1 < p.nscale) v1 *= p.scale;
      return gemm::pack2(v0, v1);
    });
  }
};

// out[:, 0:N] (row stride ldo) = round((round(LN(x) valid) W^T + b), the
// columns below nscale times scale: x [M, C] bf16, w [N, C] bf16 (torch
// layout), b f32 [N]; xn [M, C] bf16 scratch for the normalized rows. Two
// kernels on st: the LayerNorm, then the product.
template <typename Valid>
cudaError_t ln_project(const void* x, const float* lns, const float* lnb,
                       const void* w, const float* b, float scale, int nscale,
                       void* xn, void* out, long long ldo, int M, int C,
                       int N, const Valid& valid, cudaStream_t st) {
  cudaError_t err = layer_norm_rows(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(xn),
      M, C, lns, lnb, st, valid);
  if (err != cudaSuccess) return err;
  return gemm::product<BiasScaleRound>({b, N, nscale, scale}, xn, w, out,
                                       nullptr, M, N, C, st, ldo);
}

}  // namespace chain
}  // namespace
