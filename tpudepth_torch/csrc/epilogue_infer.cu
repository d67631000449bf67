// Transformer block tail and FFN for inference, for Hopper (sm_90a):
//
//   block_epilogue_infer:  z = o Wp + bp;  y = x + z;
//                          out = y + fc2(gelu(fc1(LN(y))))
//   mlp_infer:             out = fc2(gelu(fc1(x)))
//
// over rows of [M, C], with the FFN's 4C hidden activation held on the chip:
// it is never written to device memory.
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
// a degree-16 polynomial (Mosaic has no erf); here it is the native erff,
// which differs from that polynomial by at most 2.1e-7.
//
// What bounds it: 2 M C (C + 8 C) = 18 M C^2 operations against ~3 M C IO
// elements: at C = 128..1024 that is 384..3072 operations per bf16 byte,
// above the card's ~295 operations per byte: the bound is operations.
//
// Design. One block of 256 threads (8 warps) per tile of BM rows; the
// tile's input rows, y and LN(y) stay in shared memory for the whole block,
// and the hidden dimension is walked in chunks of 128: h = LN(y) W1[:, chunk],
// gelu into shared memory, then acc += g W2[chunk, :]. One launch per call.
//   * bf16 (the serving path): the products run on the tensor cores with
//     mma.sync m16n8k16 (bf16 in, f32 accumulate). The f32 accumulator of
//     the [BM, C] output lives in registers for the whole kernel: warp w
//     owns the 8-column tiles w, w + 8, ...; BM = 16 MT rows with MT chosen
//     so that it holds 64 floats per thread. A fragments come from shared
//     memory (rows padded so the 16-byte loads do not conflict), B
//     fragments straight from the bf16 weights in L2, 16 bytes per lane:
//     within a k-block of 32 the lanes take k in the order 8t..8t+7, the
//     same permutation for A and B, so each lane loads whole 16-byte
//     pieces (the sum over k does not depend on its order). No weight tile
//     is staged and no barrier is needed inside a product.
//   * f32 (held against the plain version in full f32, as the JAX
//     package's HIGHEST): the CUDA cores, BM in 8..64 rows, the f32
//     accumulator in shared memory, weight tiles of 32 x 128 staged through
//     shared memory; each thread owns (BM / 8) rows x 4 columns of a
//     128-column chunk.
//
// The device code lives in block_tail.cuh, which rowblock_infer.cu and
// block_infer.cu share.

#include "block_tail.cuh"

using tail::Params;
using tail::run;

// out = y + fc2(gelu(fc1(LN(y)))), y = x + (o wp^T + bp). Weights in the IO
// dtype in torch layout [out, in], contiguous; vectors f32; o, x, out
// contiguous [M, C] of the IO dtype. Returns a cudaError_t.
extern "C" int block_epilogue_infer(const void* o, const void* x,
                                    const void* wp, const void* bp,
                                    const void* lns, const void* lnb,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* out,
                                    int M, int C, int hidden, int is_bf16,
                                    void* stream) {
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
  return static_cast<int>(run<tail::kEpilogue>(p, is_bf16, stream));
}

// out = fc2(gelu(fc1(x))): x [M, cin], w1 [hidden, cin], w2 [cout, hidden]
// in the IO dtype.
extern "C" int mlp_infer(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out, int M,
                         int cin, int hidden, int cout, int is_bf16,
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
  return static_cast<int>(run<tail::kFfn>(p, is_bf16, stream));
}
