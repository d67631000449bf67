// Whole transformer blocks of SAM and NewCRF for inference, for Hopper
// (sm_90a), over raw padded windows [BW, N, C] (window-major: token i of
// window w is row w N + i):
//
//   crf_block_infer:  q, k = LN1(x) valid Wqk + bqk;  values v (raw)
//   sam_block_infer:  q = LN1(x) valid Wq + bq;  k, v = LNv(v) valid Wkv + bkv
//   both:             o = window attention (+ bias, + shift mask)
//                     y = x + o Wp + bp;  out = y + fc2(gelu(fc1(LN2(y))))
//
// The windows are not normalized, zero-padded to multiples of the window
// and, for a shifted NewCRF block, already rolled by (-shift, -shift).
// valid [nW, N] is 1 on the real tokens and 0 on the pad (window w takes
// row w % nW; absent when the map has no pad), so a pad token's query, key
// and value are the projections' biases alone, as where the reference pads
// after its LayerNorm. The output's pad rows hold garbage the caller crops.
//
// Replaces tpudepth/ops/pallas/block_infer.py::sam_block_infer (:201, body
// _sam_kernel :114-138) and ::crf_block_infer (:279, body _crf_kernel
// :141-171), the Pallas TPU kernels. Same arithmetic, in this order:
//   * LN1(x) (and LNv(v)) in f32 with flax's fast variance, times valid,
//     rounded to the IO dtype; weights rounded to the IO dtype, products
//     summed in f32;
//   * q = (LN1(x) Wq + bq) * scale in f32, rounded once; k (and SAM's
//     projected values) rounded; NewCRF's values are the raw v;
//   * the window attention of window_attn.cuh: f32 scores plus bias (plus
//     mask), f32 softmax, probabilities rounded, p v summed in f32, o
//     rounded;
//   * the tail, unlike block_epilogue_infer's and the row kernels': y =
//     x + (o Wp + bp) stays f32 and so does m = g W2 + b2 (the TPU kernel's
//     _ffn_residual); only LN2(y), h = LN2(y) W1 + b1, g = gelu(h) (f32:
//     native erff; bf16: the erf polynomial's table) and out = y + m are
//     rounded.
//
// What bounds it: per real token 2 C (2C + C + 8C) = 22 C^2 operations for
// NewCRF (24 C^2 for SAM: q, kv, proj, FFN) and 4 49 C for the attention,
// against 3 C IO elements (x, v in, out): 1,500 to 7,500 operations per
// bf16 byte at C 128..1024, far above the card's ~295: the bound is
// operations. Pad tokens need none of it, though the kernels run every
// padded token.
//
// Design. The TPU kernel held a tile of windows and every weight in VMEM.
// A Hopper block has 227 KB of shared memory: one window's 49 x 1024 bf16
// rows are 100 KB and SAM's weights 25 MB at C 1024. So the weights are
// streamed from the 50 MB L2, and one entry launches a fixed number of
// kernels on the caller's stream over the flat window-major rows
// [M, C], M = BW N, whose products get full-height tiles.
//
// bf16 runs the projections and the tail on the pipelined wgmma core
// (tail_chain.cuh, gemm_sm90.cuh), as the row kernels do:
//   1. a LayerNorm pass (one warp a row, times the row's valid entry
//      valid[(row / N) % nW][row % N], pad rows zero) into the output
//      buffer, and a product whose epilogue adds the bias, scales the q
//      columns in f32 and rounds once (NewCRF: q and k from one product of
//      width 2C at row stride 2C; SAM: q into the first C columns at row
//      stride 3C, then the same for k and v);
//   2. the attention (window_attn.cuh: on the tensor cores, one block per
//      (chunk of windows, head)) on wattn::WindowMajor rows, the mask of
//      window w % nW added; o into the output buffer;
//   3. the chain tail_block_bf16, in place, which keeps this kernel's
//      rounding: y = x + (o Wp + bp) is spilled in f32 (a float2 a lane
//      from the fragment, x read in the same epilogue), LN2 reads it in
//      f32, and the last product's epilogue adds m = g W2 + b2 to the f32
//      y unrounded and rounds once.
// The f32 y (4 M C bytes) goes into the q, k (and v) scratch, dead once
// the attention is done: NewCRF's 2 M C bf16 elements hold it exactly, and
// its yn (2 M C bytes) goes into the output buffer, dead between the
// chain's first product, which reads o, and its last, which writes out;
// SAM's qkv holds y and yn in its 6 M C bytes. The hidden goes into a bf16
// scratch g [M, 4C]. 7 kernels a NewCRF call, 9 a SAM call. The GELU is
// looked up in the table the erf polynomial fills (at most 2.1e-7 from
// erff before rounding). On an NVIDIA H100 80GB HBM3 at 700 W the eight
// calls of a batch-8 NewCRF forward take 3.68 ms this way, 0.82 of it the
// attention on the tensor cores (2.83 on the CUDA cores); through the
// CUDA-core passes below they took 11.45, 6.68 of it the tail
// (chip_smoke.py [block kernel time], [block kernel split]).
//
// f32 keeps the passes on the CUDA cores: LayerNorm times valid and the
// projection (ln_proj.cuh), the attention, and the tail over the flat rows
// of o and x (block_tail.cuh, Mode kBlock), in place: each tail block reads
// its row tile of o into shared memory before it writes the same rows.
// Launches per f32 call: 3 for NewCRF, 4 for SAM; scratch NewCRF 2 M C
// (q, k), SAM 3 M C (q, k, v); the output buffer M C doubles as o. Fusing
// the projection into the attention would need a window's 49 x C rows and
// their weight tiles in one block: a later design.

#include "block_tail.cuh"
#include "ln_proj.cuh"
#include "tail_chain.cuh"
#include "window_attn.cuh"

namespace {

// Token row `row` of the window-major rows is real (not pad):
// valid[(row / n) % nw][row % n] != 0; every token when there is no table.
struct TableValid {
  const float* tab;
  int n, nw;
  __device__ __forceinline__ bool operator()(int row) const {
    if (tab == nullptr) return true;
    const int win = row / n;
    return tab[(win % nw) * n + (row - win * n)] != 0.f;
  }
};

// The geometry both blocks take: BW windows of n <= 64 tokens, BW a
// multiple of the period nw of the mask and valid tables, C a width of the
// tail (a multiple of 32, at most 128 or a multiple of 128, at most 1024),
// heads of a width that is a multiple of 8 up to 64.
bool geometry_ok(int bw, int n, int C, int heads, int hidden, int nw) {
  return bw >= 1 && n >= 1 && n <= wattn::kMaxN && nw >= 1 && bw % nw == 0 &&
         tail::width_ok(C) && C <= 1024 && tail::width_ok(hidden) &&
         wattn::shape_ok(n, C, heads) &&
         static_cast<long long>(bw) * n * 3 * C < (1LL << 31);
}

// The attention over the window-major rows, o written into out [M, C].
cudaError_t attend(const void* q, const void* k, const void* v,
                   long long ldq, long long ldk, long long ldv,
                   const void* bias, const void* mask, void* out, int bw,
                   int n, int C, int heads, int nw, bool bf16,
                   cudaStream_t st) {
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
  p.N = n;
  p.C = C;
  p.heads = heads;
  p.nW = nw;
  const wattn::WindowMajor rows = {n};
  return bf16 ? wattn::launch<__nv_bfloat16>(p, rows, bw, st)
              : wattn::launch<float>(p, rows, bw, st);
}

const void* offset(const void* base, int elems, int is_bf16) {
  return static_cast<const char*>(base) +
         static_cast<size_t>(elems) * (is_bf16 ? 2 : 4);
}

}  // namespace

// The NewCRF block. x, v, out: contiguous [BW, n, C] of the IO dtype (x and
// out 16-byte aligned); qk: scratch [BW, n, 2C] of the IO dtype; g: bf16
// scratch [BW n, hidden] (bf16 only; unused in f32). Weights in the IO
// dtype in torch layout [out, in], contiguous; vectors, bias [heads, n, n],
// mask (null, or [nw, n, n]) and valid (null, or [nw, n]) f32. nw is the
// period of the mask and valid tables (1 without them). Returns a
// cudaError_t.
//
// bf16 runs the projection and the tail on the wgmma core (tail_chain.cuh):
//   1. LN1(x) valid, rounded, into out (free until the attention writes o);
//   2. q = round((. Wq + bq) scale), k = round(. Wk + bk) into qk (one
//      product, the columns below C scaled);
//   3. the attention, o into out;
//   4-7. the tail chain in place on out, its f32 y in qk's 4 M C bytes,
//        its yn in out (o is read by the chain's first product alone), its
//        hidden in g.
// f32 keeps the CUDA-core passes (lnproj, tail).
extern "C" int crf_block_infer(
    const void* x, const void* v, const void* ln1s, const void* ln1b,
    const void* wqk, const void* bqk, const void* bias, const void* mask,
    const void* wproj, const void* bproj, const void* ln2s, const void* ln2b,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* valid, void* qk, void* g, void* out, int bw, int n, int C,
    int heads, int hidden, int nw, float scale, int is_bf16, void* stream) {
  if (!geometry_ok(bw, n, C, heads, hidden, nw) ||
      (is_bf16 && g == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = bw * n;
  const TableValid tv = {static_cast<const float*>(valid), n, nw};
  cudaError_t err =
      is_bf16 ? chain::ln_project(x, static_cast<const float*>(ln1s),
                                  static_cast<const float*>(ln1b), wqk,
                                  static_cast<const float*>(bqk), scale, C,
                                  out, qk, 2 * C, M, C, 2 * C, tv, st)
              : lnproj::run(lnproj::params(x, ln1s, ln1b, wqk, bqk, qk, 2 * C,
                                           2 * C, C, scale, M, C),
                            tv, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = attend(qk, offset(qk, C, is_bf16), v, 2 * C, 2 * C, C, bias, mask,
               out, bw, n, C, heads, nw, is_bf16, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const tail::Params p = tail::block_params(
      out, x, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2, out, M, C, hidden);
  if (!is_bf16) return static_cast<int>(tail::run<tail::kBlock>(p, st));
  return static_cast<int>(chain::tail_block_bf16(
      p, static_cast<float*>(qk), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(g), st));
}

// The SAM block (never shifted). As crf_block_infer, with LNv and the q and
// kv projections; qkv: scratch [BW, n, 3C] of the IO dtype; g: bf16 scratch
// [BW n, hidden] (bf16 only; unused in f32).
//
// bf16 runs the projections and the tail on the wgmma core (tail_chain.cuh):
//   1. LN1(x) valid, rounded, into out (free until the attention writes o);
//   2. q = round((. Wq + bq) scale) into qkv[:, 0:C] (row stride 3C);
//   3. LNv(v) valid into out; 4. kv = round(. Wkv + bkv) into qkv[:, C:3C];
//   5. the attention, o into out;
//   6-9. the tail chain in place on out, its f32 y in qkv's first 4 M C
//        bytes and yn in the 2 M C after them, its hidden in g.
// (The gelu table is filled once a device before the first.) f32 keeps the
// CUDA-core passes (lnproj, tail).
extern "C" int sam_block_infer(
    const void* x, const void* v, const void* ln1s, const void* ln1b,
    const void* lnvs, const void* lnvb, const void* wq, const void* bq,
    const void* wkv, const void* bkv, const void* bias, const void* wproj,
    const void* bproj, const void* ln2s, const void* ln2b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* valid,
    void* qkv, void* g, void* out, int bw, int n, int C, int heads,
    int hidden, int nw, float scale, int is_bf16, void* stream) {
  if (!geometry_ok(bw, n, C, heads, hidden, nw) ||
      (is_bf16 && g == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = bw * n;
  const TableValid tv = {static_cast<const float*>(valid), n, nw};
  void* kv = const_cast<void*>(offset(qkv, C, is_bf16));
  cudaError_t err;
  if (is_bf16) {
    err = chain::ln_project(x, static_cast<const float*>(ln1s),
                            static_cast<const float*>(ln1b), wq,
                            static_cast<const float*>(bq), scale, C, out,
                            qkv, 3 * C, M, C, C, tv, st);
    if (err == cudaSuccess)
      err = chain::ln_project(v, static_cast<const float*>(lnvs),
                              static_cast<const float*>(lnvb), wkv,
                              static_cast<const float*>(bkv), 1.0f, 0, out,
                              kv, 3 * C, M, C, 2 * C, tv, st);
  } else {
    err = lnproj::run(
        lnproj::params(x, ln1s, ln1b, wq, bq, qkv, 3 * C, C, C, scale, M, C),
        tv, st);
    if (err == cudaSuccess)
      err = lnproj::run(lnproj::params(v, lnvs, lnvb, wkv, bkv, kv, 3 * C,
                                       2 * C, 0, 1.0f, M, C),
                        tv, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = attend(qkv, kv, offset(qkv, 2 * C, is_bf16), 3 * C, 3 * C, 3 * C,
               bias, nullptr, out, bw, n, C, heads, nw, is_bf16, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const tail::Params p = tail::block_params(
      out, x, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2, out, M, C, hidden);
  if (!is_bf16) return static_cast<int>(tail::run<tail::kBlock>(p, st));
  float* y = static_cast<float*>(qkv);
  return static_cast<int>(chain::tail_block_bf16(
      p, y, reinterpret_cast<__nv_bfloat16*>(y + static_cast<size_t>(M) * C),
      static_cast<__nv_bfloat16*>(g), st));
}
