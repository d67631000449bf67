// Transformer block tail and FFN for inference, for Hopper (sm_90a):
//
//   block_epilogue_infer:  z = o Wp + bp;  y = x + z;
//                          out = y + fc2(gelu(fc1(LN(y))))
//   mlp_infer:             out = fc2(gelu(fc1(x)))
//
// over rows of [M, C].
//
// Replaces tpudepth/ops/pallas/epilogue_infer.py::block_epilogue_infer
// (body :46-66) and tpudepth/ops/pallas/mlp_infer.py::mlp_infer (body
// :91-108), the Pallas TPU kernels. Same arithmetic, in this order:
//   * weights are rounded to the IO dtype (the JAX wrappers cast them with
//     .astype(dt); here the wrapper casts bf16 weights, f32 stay f32);
//     products of IO-dtype operands accumulate in f32;
//   * z = o Wp + bp in f32, rounded to the IO dtype; y = x + z, rounded;
//   * LN(y) in f32 with flax's fast variance max(mean(y^2) - mean^2, 0),
//     eps 1e-5, (y - mean) * (rsqrt(var + eps) * scale) + bias, rounded;
//   * h = LN(y) W1 + b1 in f32, rounded; g = gelu(h) in f32 with the exact
//     erf, 0.5 h (1 + erf(h / sqrt 2)), rounded;
//   * m = g W2 + b2 in f32, rounded; out = y + m, rounded.
// mlp_infer is the FFN part alone (out = m). The TPU kernel evaluated erf by
// a degree-16 polynomial (Mosaic has no erf); both bf16 paths look gelu(h)
// up by h's bits in a table that polynomial fills (gemm::erf_poly,
// gemm::gelu_table), the f32 paths evaluate the native erff, which differs
// from it by at most 2.1e-7.
//
// What bounds it: 2 M C (C + 8 C) = 18 M C^2 operations against ~3 M C IO
// elements: at C = 128..1024 that is 384..3072 operations per bf16 byte,
// above the card's ~295 operations per byte: the bound is operations.
//
// Design of block_epilogue_infer.
//   * bf16 (the serving path): a chain of four kernels, three of them
//     products on the pipelined wgmma core of gemm_sm90.cuh (TMA ring of
//     64-deep k-blocks in shared memory, two consumer warpgroups, tiles of
//     128 rows, persistent blocks two an SM, outputs stored by TMA), each
//     with its own epilogue:
//       1. y = round(x + round(o Wp + bp))            [M, C] scratch
//       2. yn = round(LN(y)), one warp a row          [M, C] scratch
//       3. g = round(gelu(round(yn W1 + b1)))          [M, 4C] scratch
//       4. out = round(y + round(g W2 + b2))
//     Every spilled tensor is one that the kernel rounds to bf16 anyway, so
//     the chain keeps the rounding order exactly; only the order of the f32
//     sums differs. This trades bytes for operations the other way from the
//     TPU kernel: the 4C hidden costs M 4C 4 bytes of round trip (0.18 ms
//     summed over a batch-8 SAM forward at 3.35 TB/s), but no tile has to
//     hold the [rows, C] output accumulator while it walks the hidden, so
//     a staged weight byte serves 128 rows, not 16-32. The first design
//     (one launch, the hidden in shared memory, the accumulator in
//     registers: 16 rows a block at C 1024, B fragments read from L2 in
//     every k-block) reached 6 % of the bound. Measured on the H100 and
//     dropped: steps 3 and 4 as one kernel with the hidden chunk in shared
//     memory (C <= 128, with or without a software pipeline: no faster than
//     the chain, its GELU not hidden behind the products), and the chain
//     over row slabs that keep g in L2 (slower: more, smaller launches).
//   * f32 (held against the plain version in full f32, as the JAX
//     package's HIGHEST): one launch of the CUDA-core tail of
//     block_tail.cuh, BM in 8..64 rows, the f32 accumulator in shared
//     memory, weight tiles of 32 x 128 staged through shared memory; each
//     thread owns (BM / 8) rows x 4 columns of a 128-column chunk.
//
// Design of mlp_infer.
//   * bf16 (the pair serving path): steps 3-4 of the chain above on the same
//     core, two products through the bf16 scratch g [M, H] that the wrapper
//     allocates (gemm::ffn_bf16): g = round(gelu(round(x W1 + b1))), then
//     out = round(g W2 + b2). The first design (one block of 256 threads
//     per 16-128 rows walking the 4C hidden in chunks of 128 on mma.sync,
//     the [rows, Cout] accumulator in registers, B fragments straight from
//     L2 in every k-block; block_tail.cuh) took 2.511 ms for the calls of a
//     B 8 SAM forward on an NVIDIA H100 80GB HBM3 at 700 W, 6.5 % of the
//     bound and 6.75x the two cuBLAS products; the chain takes 0.692 ms
//     there (chip_smoke.py), 1.9x cuBLAS; 0.08 of crf3's 0.19 ms are the
//     wrapper's transposing weight casts.
//   * f32: the CUDA-core tail of block_tail.cuh in its FFN mode, as above.
//
// The f32 paths' CUDA-core device code lives in block_tail.cuh, which
// mlp_train.cu and the row and whole-block kernels share; the wgmma core,
// its epilogues and the FFN chain live in gemm_sm90.cuh, which mlp_train.cu
// shares.

#include "block_tail.cuh"
#include "gemm_sm90.cuh"

using tail::Params;
using tail::run;

namespace {
namespace epi {

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

// P bf16 values (P = 8, 4, 2 or 1) from (to) 2P-byte aligned memory.
template <int P>
__device__ __forceinline__ void copy_piece(const __nv_bfloat16* src,
                                           __nv_bfloat16* dst) {
  if constexpr (P == 8) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if constexpr (P == 4) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if constexpr (P == 2) {
    *reinterpret_cast<uint32_t*>(dst) =
        *reinterpret_cast<const uint32_t*>(src);
  } else {
    *dst = *src;
  }
}

// yn = round(LN(y)) over rows of C = 32 V: step 2. One warp a row, read
// once into registers and written once, in pieces of P = 8, 4, 2 or 1
// values (the widest that divides V): piece j of lane l holds the values
// (32 j + l) P.., so each load instruction covers 32 P contiguous values.
// layer_norm_row's f32 arithmetic (flax's fast variance, eps 1e-5), its
// sums added in another order. kVec: scale and bias are 16-byte aligned and
// read 4 floats at a time.
template <int V, bool kVec>
__global__ void __launch_bounds__(tail::kThreads)
    layer_norm_kernel(const __nv_bfloat16* y, __nv_bfloat16* yn, int M,
                      const float* scale, const float* bias) {
  constexpr int C = 32 * V;
  constexpr int P = V % 8 == 0 ? 8 : V % 4 == 0 ? 4 : V % 2 == 0 ? 2 : 1;
  const int row = blockIdx.x * tail::kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* yr = y + static_cast<size_t>(row) * C;
  __nv_bfloat16* ynr = yn + static_cast<size_t>(row) * C;
  __nv_bfloat16 b[V];
#pragma unroll
  for (int j = 0; j < V / P; ++j)
    copy_piece<P>(yr + (32 * j + lane) * P, b + j * P);
  float v[V];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] = __bfloat162float(b[i]);
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

template <int V>
cudaError_t layer_norm(const __nv_bfloat16* y, __nv_bfloat16* yn, int M,
                       const float* scale, const float* bias,
                       cudaStream_t st) {
  const int blocks = (M + tail::kWarps - 1) / tail::kWarps;
  if ((reinterpret_cast<uintptr_t>(scale) |
       reinterpret_cast<uintptr_t>(bias)) % 16 == 0) {
    layer_norm_kernel<V, true><<<blocks, tail::kThreads, 0, st>>>(
        y, yn, M, scale, bias);
  } else {
    layer_norm_kernel<V, false><<<blocks, tail::kThreads, 0, st>>>(
        y, yn, M, scale, bias);
  }
  return cudaGetLastError();
}

// yn = round(LN(y)) for the widths the kernel takes (tail::width_ok, at
// most 1024).
cudaError_t layer_norm_rows(const __nv_bfloat16* y, __nv_bfloat16* yn, int M,
                            int C, const float* scale, const float* bias,
                            cudaStream_t st) {
  switch (C / 32) {
    case 1: return layer_norm<1>(y, yn, M, scale, bias, st);
    case 2: return layer_norm<2>(y, yn, M, scale, bias, st);
    case 3: return layer_norm<3>(y, yn, M, scale, bias, st);
    case 4: return layer_norm<4>(y, yn, M, scale, bias, st);
    case 8: return layer_norm<8>(y, yn, M, scale, bias, st);
    case 12: return layer_norm<12>(y, yn, M, scale, bias, st);
    case 16: return layer_norm<16>(y, yn, M, scale, bias, st);
    case 20: return layer_norm<20>(y, yn, M, scale, bias, st);
    case 24: return layer_norm<24>(y, yn, M, scale, bias, st);
    case 28: return layer_norm<28>(y, yn, M, scale, bias, st);
    case 32: return layer_norm<32>(y, yn, M, scale, bias, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t chain_bf16(const Params& p, __nv_bfloat16* y, __nv_bfloat16* yn,
                       __nv_bfloat16* g, cudaStream_t st) {
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

}  // namespace epi
}  // namespace

// out = y + fc2(gelu(fc1(LN(y)))), y = x + (o wp^T + bp). Weights in the IO
// dtype in torch layout [out, in], contiguous; vectors f32; o, x, out
// contiguous [M, C] of the IO dtype, 16-byte aligned. bf16 takes the
// scratch y, yn [M, C] and g [M, hidden] (bf16; unused in f32). Returns a
// cudaError_t.
extern "C" int block_epilogue_infer(const void* o, const void* x,
                                    const void* wp, const void* bp,
                                    const void* lns, const void* lnb,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* out,
                                    void* y, void* yn, void* g, int M, int C,
                                    int hidden, int is_bf16, void* stream) {
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
  if (!is_bf16) return static_cast<int>(run<tail::kEpilogue>(p, 0, stream));
  if (M < 1 || !tail::width_ok(C) || !tail::width_ok(hidden) || C > 1024 ||
      y == nullptr || yn == nullptr || g == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(epi::chain_bf16(
      p, static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(yn),
      static_cast<__nv_bfloat16*>(g), static_cast<cudaStream_t>(stream)));
}

// out = fc2(gelu(fc1(x))): x [M, cin], w1 [hidden, cin], w2 [cout, hidden]
// in the IO dtype (torch layout, contiguous), b1, b2 f32; x and out
// contiguous and 16-byte aligned. bf16 takes the scratch g [M, hidden]
// (bf16; unused in f32). Returns a cudaError_t.
extern "C" int mlp_infer(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out, void* g,
                         int M, int cin, int hidden, int cout, int is_bf16,
                         void* stream) {
  Params p = {};
  p.o = x;
  p.w1 = w1;
  p.b1 = static_cast<const float*>(b1);
  p.w2 = w2;
  p.b2 = static_cast<const float*>(b2);
  p.out = out;
  p.M = M;
  p.cin = cin;
  p.hidden = hidden;
  p.cout = cout;
  if (!is_bf16) return static_cast<int>(run<tail::kFfn>(p, 0, stream));
  if (!tail::shape_ok(p, tail::kFfn) || g == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gemm::ffn_bf16(x, w1, p.b1, w2, p.b2, g, out, M,
                                         cin, hidden, cout,
                                         static_cast<cudaStream_t>(stream)));
}
