// Channel-packed window attention for inference, for Hopper (sm_90a):
//
//   out[w, :, h*d:(h+1)*d] = softmax(q_h k_h^T + bias[h] [+ mask[w % nW]]) v_h
//
// for every window w of q, k, v [BW, N, C] (C = heads * d, q pre-scaled),
// bias [heads, N, N] f32, and the optional additive mask [nW, N, N] f32 of
// shifted windows (windows are [B, nW]-major, so window w takes
// mask[w % nW]).
//
// Replaces tpudepth/ops/pallas/window_attn_infer.py::window_attention_infer
// (body :42-68), the Pallas TPU kernel. Same arithmetic, in this order: the
// scores are products of IO-dtype values summed in f32, the bias and then
// the mask are added in f32, the row maximum is subtracted, exp, divided by
// the row sum; the probabilities are ROUNDED to the IO dtype before p v_h,
// which sums in f32, and the output is rounded to the IO dtype.
//
// What bounds it: per window and head 4 N^2 d operations against 4 N d IO
// elements, i.e. N = 49 operations per element (25 per bf16 byte), far
// below the card's ~295 per byte: the bound is bytes (q, k, v read once,
// the output written once).
//
// Design (window_attn.cuh). bf16 runs on the tensor cores: one block of 4
// warps per (chunk of consecutive windows, head), q, k, v tiles double
// buffered by cp.async (read through a row stride, so k and v may be views
// of one [BW, N, 2C] projection; rows that are not 16-byte aligned by plain
// loads), S = q k^T and O = P v by mma.sync from ldmatrix fragments, the
// f32 softmax in registers with quad shuffles, the bias read into
// registers once a block and each window's mask staged by cp.async beside
// its tiles; the division by the row sum is the IEEE quotient, from one
// reciprocal a row and two remainder corrections an element (wattn::
// div_rn), where the division's own fast path leaves for a slow path on
// the mask's tiny quotients. The instructions of the f32 softmax, not the
// bytes or the products, bound it: on an NVIDIA H100 80GB HBM3 at 700 W the
// four calls of a batch-8 SAM forward take 0.32 ms this way (chip_smoke.py
// [sam kernel time]), 1.38 on the CUDA cores, and 0.51 with NewCRF's
// shift-3 mask. f32 keeps the CUDA cores (on the tensor cores it
// would be TF32): one block of 128 threads per (window, head), the head's
// N x d slices and the N x N f32 scores in shared memory, products in f32.
// rowblock_infer.cu and block_infer.cu launch the same device code on their
// own row maps.

#include "window_attn.cuh"

// q, k, v: [BW, N, C] with token rows ldq / ldk / ldv elements apart and
// channels contiguous; bias f32 [heads, N, N] and mask (null or f32
// [nW, N, N], BW a multiple of nW) contiguous; out contiguous [BW, N, C].
// Returns a cudaError_t.
extern "C" int window_attn_infer(const void* q, const void* k, const void* v,
                                 long long ldq, long long ldk, long long ldv,
                                 const void* bias, const void* mask, void* out,
                                 int bw, int n, int c, int heads, int nw,
                                 int is_bf16, void* stream) {
  if (bw < 1 || !wattn::shape_ok(n, c, heads) ||
      (mask != nullptr && (nw < 1 || bw % nw != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  wattn::Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ldq = ldq;
  p.ldk = ldk;
  p.ldv = ldv;
  p.ldo = c;
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.out = out;
  p.N = n;
  p.C = c;
  p.heads = heads;
  p.nW = nw;
  const wattn::WindowMajor rows = {n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? wattn::launch<__nv_bfloat16>(p, rows, bw, st)
              : wattn::launch<float>(p, rows, bw, st);
  return static_cast<int>(err);
}
