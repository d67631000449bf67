// Window-row transformer blocks of NewCRF and SAM for inference, for Hopper
// (sm_90a), over the image layout [B, Hp, Wp, C] (zero-padded to multiples
// of the window, and for a shifted NewCRF block already rolled by
// (-shift, -shift)):
//
//   crf_rowblock_infer:  q, k = LN1(x) valid Wqk + bqk;  values v (raw)
//   sam_rowblock_infer:  q = LN1(x) valid Wq + bq;  k, v = LNv(v) valid Wkv + bkv
//   both:                o = window attention (+ bias, + shift mask)
//                        y = x + o Wp + bp;  out = y + fc2(gelu(fc1(LN2(y))))
//
// with 7 x 7 (ws x ws) windows read straight out of the image layout: no
// partition or reverse copy. valid is 1 on the real pixels and 0 on the pad
// (for a shifted block the valid image is rolled with the map), so the pad
// tokens' queries, keys and values are the projections' biases alone, as
// where the reference pads after its LayerNorm. The output's pad positions
// hold garbage the caller crops.
//
// Replaces tpudepth/ops/pallas/rowblock_infer.py::crf_rowblock_infer (:270,
// body _crf_kernel :153-186) and ::sam_rowblock_infer (:355, body
// _sam_kernel :189-215), the Pallas TPU kernels. Same arithmetic, in this
// order:
//   * LN1(x) (and LNv(v)) in f32 with flax's fast variance, times valid,
//     rounded to the IO dtype; weights rounded to the IO dtype, products
//     summed in f32;
//   * q = (LN1(x) Wq + bq) * scale, scaled in f32 and then rounded once
//     (the unfused module rounds before it scales); k (and SAM's projected
//     values) rounded;
//   * the window attention of window_attn.cuh: f32 scores, f32 softmax,
//     probabilities rounded, p v summed in f32, o rounded;
//   * the block tail of block_tail.cuh: z = o Wp + bp rounded, y = x + z in
//     the IO dtype, LN2(y), h, gelu(h) (native erff; the TPU kernel's erf
//     polynomial was a Mosaic workaround) and m rounded, out = y + m.
//
// What bounds it: per real token 2 C (2C + C + 8C) = 22 C^2 operations for
// NewCRF (24 C^2 for SAM: q, kv, proj, FFN) and 4 49 C for the attention,
// against 3 C IO elements (x, v in, out): 1,500 to 7,500 operations per
// bf16 byte at C 128..1024, far above the card's ~295: the bound is
// operations. Pad tokens need none of it (their keys and values are the
// projections' biases, their rows are cropped), though the kernels run
// every padded token.
//
// Design. The TPU kernel held a whole window row (7 Wp tokens, ~300 KB in
// bf16 at every stage at 480x640) and every weight in VMEM; a Hopper block
// has 227 KB of shared memory, and a single window's x, q and k come to
// ~300 KB at C 1024. So one C entry launches a fixed number of kernels on
// the caller's stream, each reading and writing the image layout (f32;
// bf16 below):
//   1. LayerNorm times valid and the projection on flat rows (ln_proj.cuh,
//      shared with block_infer.cu) on the CUDA cores (f32_gemm); it writes
//      q scale and k (SAM: q; then k and v by a second launch) to a
//      scratch of the image layout;
//   2. the attention (window_attn.cuh; bf16 on the tensor cores, one block
//      per (chunk of windows, head)), each token's row found by
//      wattn::ImageRows (token (r, s) of window (i, j) is image row
//      (i ws + r) Wp + j ws + s), the mask of window i nWw + j added; o is
//      written into the output buffer;
//   3. the block tail over the flat rows of o and x, in place: each tail
//      block reads its row tile of o into shared memory before it writes
//      the same rows of the output, and no block touches another's rows.
// Launches per call in f32: 3 for NewCRF, 4 for SAM. Scratch (allocated by
// the caller): NewCRF 2 M C IO elements (q, k), SAM 3 M C (q, k, v), M =
// B Hp Wp; the output buffer M C doubles as o. A thread-block cluster
// holding a window row in distributed shared memory is a later design.
//
// bf16 runs steps 1 and 3 on the pipelined wgmma core instead
// (tail_chain.cuh, gemm_sm90.cuh): 1 becomes a LayerNorm pass (one warp a
// row, pad rows zero) into the output buffer and a product whose epilogue
// adds the bias, scales the q columns in f32 and rounds once, storing q and
// k side by side into the scratch (NewCRF: one product at row stride 2C;
// SAM: q into the first C columns at row stride 3C, then the same for k and
// v); 3 becomes block_epilogue_infer's chain of four kernels in place, its
// y and yn in the scratch's first 2 M C elements (dead once the attention
// is done), its hidden in a bf16 scratch g [M, 4C]: 7 kernels a NewCRF
// call, 9 a SAM call. The chain spills only tensors the TPU kernel rounds
// to bf16 anyway, so the rounding order is kEpilogue's; its GELU is looked
// up in the table the erf polynomial fills (at most 2.1e-7 from erff
// before rounding). On an NVIDIA H100 80GB HBM3 at 700 W the calls of a
// batch-8 SAM forward take 1.83 ms this way, 0.36 of it the attention on
// the tensor cores (1.54 on the CUDA cores); through the passes above they
// took 6.4, 3.3 of it the tail and 1.3 the two LN projections
// (chip_smoke.py [row kernel time], [row kernel split]; the passes' split
// by scripts/torch_kernel_ab.py on the parent tree). f32 keeps the passes
// above.

#include "block_tail.cuh"
#include "ln_proj.cuh"
#include "tail_chain.cuh"
#include "window_attn.cuh"

namespace {

// Row `row` of the image layout [B, hp, wp] is a real pixel (not pad) of
// the map rolled by (-shift, -shift), whose real extent is vh x vw.
struct ImageValid {
  int hp, wp, vh, vw, shift;
  __device__ __forceinline__ bool operator()(int row) const {
    const int j = row % wp;
    const int i = (row / wp) % hp;
    return (i + shift) % hp < vh && (j + shift) % wp < vw;
  }
};

// The geometry both blocks take: windows of at most 64 tokens tiling the
// map, C a width of the tail (a multiple of 32, at most 128 or a multiple of
// 128, at most 1024), heads of a width that is a multiple of 8 up to 64.
bool geometry_ok(int B, int hp, int wp, int C, int heads, int hidden,
                 int ws) {
  return B >= 1 && ws >= 1 && ws * ws <= wattn::kMaxN && hp >= ws &&
         wp >= ws && hp % ws == 0 && wp % ws == 0 && tail::width_ok(C) &&
         C <= 1024 && tail::width_ok(hidden) &&
         wattn::shape_ok(ws * ws, C, heads) &&
         static_cast<long long>(B) * hp * wp * 3 * C < (1LL << 31);
}

// The attention over the image layout, o written into out [M, C].
cudaError_t attend(const void* q, const void* k, const void* v,
                   long long ldq, long long ldk, long long ldv,
                   const void* bias, const void* mask, void* out, int B,
                   int hp, int wp, int C, int heads, int ws, bool bf16,
                   cudaStream_t st) {
  const int nww = wp / ws;
  const int nw = (hp / ws) * nww;
  wattn::Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ldq = ldq;
  p.ldk = ldk;
  p.ldv = ldv;
  p.ldo = C;
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.out = out;
  p.N = ws * ws;
  p.C = C;
  p.heads = heads;
  p.nW = nw;
  const wattn::ImageRows rows = {ws, hp, wp, nww, nw};
  return bf16 ? wattn::launch<__nv_bfloat16>(p, rows, B * nw, st)
              : wattn::launch<float>(p, rows, B * nw, st);
}

const void* offset(const void* base, int elems, int is_bf16) {
  return static_cast<const char*>(base) +
         static_cast<size_t>(elems) * (is_bf16 ? 2 : 4);
}

}  // namespace

// The NewCRF block. x, v, out: contiguous [B, Hp, Wp, C] of the IO dtype
// (x and out 16-byte aligned); qk: scratch [B, Hp, Wp, 2C] of the IO dtype;
// g: bf16 scratch [B Hp Wp, hidden] (bf16 only; unused in f32). Weights in
// the IO dtype in torch layout [out, in], contiguous; vectors, bias [heads,
// ws^2, ws^2] and mask (null, or [nW, ws^2, ws^2]) f32. (h, w) is the real
// extent of the map before the roll by (-shift, -shift). Returns a
// cudaError_t.
//
// bf16 runs the projection and the tail on the wgmma core (tail_chain.cuh):
//   1. LN1(x) valid (the rolled validity), rounded, into out (free until
//      the attention writes o);
//   2. q = round((. Wq + bq) scale), k = round(. Wk + bk) into qk (one
//      product, the columns below C scaled);
//   3. the attention, o into out;
//   4-7. the tail chain in place on out, its y and yn in qk (dead once the
//        attention is done), its hidden in g.
// f32 keeps the CUDA-core passes (lnproj, tail).
extern "C" int crf_rowblock_infer(
    const void* x, const void* v, const void* ln1s, const void* ln1b,
    const void* wqk, const void* bqk, const void* bias, const void* mask,
    const void* wproj, const void* bproj, const void* ln2s, const void* ln2b,
    const void* w1, const void* b1, const void* w2, const void* b2, void* qk,
    void* g, void* out, int B, int hp, int wp, int C, int heads, int hidden,
    int ws, int h, int w, int shift, float scale, int is_bf16, void* stream) {
  if (!geometry_ok(B, hp, wp, C, heads, hidden, ws) || shift < 0 ||
      (is_bf16 && g == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * hp * wp;
  const ImageValid valid = {hp, wp, h, w, shift};
  cudaError_t err =
      is_bf16 ? chain::ln_project(x, static_cast<const float*>(ln1s),
                                  static_cast<const float*>(ln1b), wqk,
                                  static_cast<const float*>(bqk), scale, C,
                                  out, qk, 2 * C, M, C, 2 * C, valid, st)
              : lnproj::run(lnproj::params(x, ln1s, ln1b, wqk, bqk, qk, 2 * C,
                                           2 * C, C, scale, M, C),
                            valid, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = attend(qk, offset(qk, C, is_bf16), v, 2 * C, 2 * C, C, bias, mask,
               out, B, hp, wp, C, heads, ws, is_bf16, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const tail::Params p = tail::block_params(
      out, x, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2, out, M, C, hidden);
  if (!is_bf16) return static_cast<int>(tail::run<tail::kEpilogue>(p, st));
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(qk);
  return static_cast<int>(chain::tail_bf16(
      p, y, y + static_cast<size_t>(M) * C, static_cast<__nv_bfloat16*>(g),
      st));
}

// The SAM block (never shifted). As crf_rowblock_infer, with LNv and the
// q and kv projections; qkv: scratch [B, Hp, Wp, 3C] of the IO dtype; g:
// bf16 scratch [B Hp Wp, hidden] (bf16 only; unused in f32).
//
// bf16 runs the projections and the tail on the wgmma core (tail_chain.cuh):
//   1. LN1(x) valid, rounded, into out (free until the attention writes o);
//   2. q = round((. Wq + bq) scale) into qkv[:, 0:C] (row stride 3C);
//   3. LNv(v) valid into out; 4. kv = round(. Wkv + bkv) into qkv[:, C:3C];
//   5. the attention, o into out;
//   6-9. the tail chain in place on out, its y and yn in qkv's first 2 M C
//        elements (dead once the attention is done), its hidden in g.
// (The gelu table is filled once a device before the first, as in
// epilogue_infer.cu.) f32 keeps the CUDA-core passes (lnproj, tail).
extern "C" int sam_rowblock_infer(
    const void* x, const void* v, const void* ln1s, const void* ln1b,
    const void* lnvs, const void* lnvb, const void* wq, const void* bq,
    const void* wkv, const void* bkv, const void* bias, const void* wproj,
    const void* bproj, const void* ln2s, const void* ln2b, const void* w1,
    const void* b1, const void* w2, const void* b2, void* qkv, void* g,
    void* out, int B, int hp, int wp, int C, int heads, int hidden, int ws,
    int h, int w, float scale, int is_bf16, void* stream) {
  if (!geometry_ok(B, hp, wp, C, heads, hidden, ws) ||
      (is_bf16 && g == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * hp * wp;
  const ImageValid valid = {hp, wp, h, w, 0};
  void* kv = const_cast<void*>(offset(qkv, C, is_bf16));
  cudaError_t err;
  if (is_bf16) {
    err = chain::ln_project(x, static_cast<const float*>(ln1s),
                            static_cast<const float*>(ln1b), wq,
                            static_cast<const float*>(bq), scale, C, out,
                            qkv, 3 * C, M, C, C, valid, st);
    if (err == cudaSuccess)
      err = chain::ln_project(v, static_cast<const float*>(lnvs),
                              static_cast<const float*>(lnvb), wkv,
                              static_cast<const float*>(bkv), 1.0f, 0, out,
                              kv, 3 * C, M, C, 2 * C, valid, st);
  } else {
    err = lnproj::run(
        lnproj::params(x, ln1s, ln1b, wq, bq, qkv, 3 * C, C, C, scale, M, C),
        valid, st);
    if (err == cudaSuccess)
      err = lnproj::run(lnproj::params(v, lnvs, lnvb, wkv, bkv, kv, 3 * C,
                                       2 * C, 0, 1.0f, M, C),
                        valid, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = attend(qkv, kv, offset(qkv, 2 * C, is_bf16), 3 * C, 3 * C, 3 * C,
               bias, nullptr, out, B, hp, wp, C, heads, ws, is_bf16, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const tail::Params p = tail::block_params(
      out, x, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2, out, M, C, hidden);
  if (!is_bf16) return static_cast<int>(tail::run<tail::kEpilogue>(p, st));
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(qkv);
  return static_cast<int>(chain::tail_bf16(
      p, y, y + static_cast<size_t>(M) * C, static_cast<__nv_bfloat16*>(g),
      st));
}
