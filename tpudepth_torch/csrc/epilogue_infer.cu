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
// shares; block_epilogue_infer's bf16 chain (chain::tail_bf16, its
// BiasResidual epilogue and LayerNorm pass) lives in tail_chain.cuh, which
// rowblock_infer.cu shares.

#include "block_tail.cuh"
#include "gemm_sm90.cuh"
#include "tail_chain.cuh"

using tail::Params;
using tail::run;


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
  return static_cast<int>(chain::tail_bf16(
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
