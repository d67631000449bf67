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
// the caller's stream, each reading and writing the image layout:
//   1. LayerNorm times valid and the projection on flat rows, on the tensor
//      cores for bf16 (mma.sync m16n8k16 with the weights streamed from L2,
//      the A tile in shared memory, block_tail.cuh's mma_gemm) and on the
//      CUDA cores in f32 (f32_gemm); it writes q scale and k (SAM: q; then
//      k and v by a second launch) to an IO-dtype scratch of the image
//      layout;
//   2. the attention, one block per (window, head), each token's row found
//      by wattn::ImageRows (token (r, s) of window (i, j) is image row
//      (i ws + r) Wp + j ws + s), the mask of window i nWw + j added; o is
//      written into the output buffer;
//   3. the block tail over the flat rows of o and x, in place: each tail
//      block reads its row tile of o into shared memory before it writes
//      the same rows of the output, and no block touches another's rows.
// Launches per call: 3 for NewCRF, 4 for SAM. Scratch (allocated by the
// caller): NewCRF 2 M C IO elements (q, k), SAM 3 M C (q, k, v), M = B Hp Wp;
// the output buffer M C doubles as o. A thread-block cluster holding a
// window row in distributed shared memory is a later design.

#include "block_tail.cuh"
#include "window_attn.cuh"

namespace {

using tail::kBK;
using tail::kNC;
using tail::kSmemLimit;
using tail::kThreads;
using tail::kWarps;

// One LayerNorm-and-projection pass: out[:, 0:cout] (row stride ldo) =
// round((LN(x) valid) W^T + b), the columns below nscale times scale first.
struct ProjParams {
  const void* x;      // [M, C] rows of the image layout, IO dtype
  const float* lns;   // LayerNorm scale and bias [C]
  const float* lnb;
  const void* w;      // [cout, C] torch layout [out, in], IO dtype
  const float* b;     // [cout]
  void* out;
  int ldo;
  int M, C, cout, nscale;
  float scale;
  int hp, wp;         // the padded map
  int vh, vw, shift;  // the real extent, and the roll of the map
};

// Row `row` of the image layout is a real pixel (not pad) of the rolled map.
__device__ __forceinline__ bool is_valid(const ProjParams& p, int row) {
  const int j = row % p.wp;
  const int i = (row / p.wp) % p.hp;
  return (i + p.shift) % p.hp < p.vh && (j + p.shift) % p.wp < p.vw;
}

// bf16: MT 16-row tiles a block; the output in passes of 8 warps x NT
// 8-column tiles, the accumulator 64 floats a thread as in the tail.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
    ln_proj_mma_kernel(const ProjParams p) {
  constexpr int NT = 16 / MT;
  constexpr int BM = 16 * MT;
  constexpr int kCols = kWarps * NT * 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int C = p.C;
  const int lda = tail::padded(C);
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][lda]

  // LN(x) valid, rounded; pad tokens and rows past M are zeros
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  for (int r = warp; r < BM; r += kWarps) {
    const int row = row0 + r;
    __nv_bfloat16* ar = a_s + r * lda;
    if (row < p.M && is_valid(p, row)) {
      tail::layer_norm_row(x + static_cast<size_t>(row) * C, ar, C, p.lns,
                           p.lnb);
    } else {
      for (int k = lane; k < C; k += 32) ar[k] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  for (int n0 = 0; n0 < p.cout; n0 += kCols) {
    const int ntiles = min(p.cout - n0, kCols) / 8;
    float acc[MT][NT][4];
    tail::zero(acc);
    tail::mma_gemm<MT, NT>(acc, a_s, lda, w + static_cast<size_t>(n0) * C, C,
                           C, ntiles);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NT; ++i)
        if (warp + kWarps * i < ntiles)
#pragma unroll
          for (int c = 0; c < 4; c += 2) {
            const int r = m * 16 + g + (c >> 1) * 8;
            if (row0 + r >= p.M) continue;
            const int n = n0 + (warp + kWarps * i) * 8 + 2 * t;
            float v0 = acc[m][i][c] + p.b[n];
            float v1 = acc[m][i][c + 1] + p.b[n + 1];
            if (n < p.nscale) v0 *= p.scale;
            if (n + 1 < p.nscale) v1 *= p.scale;
            *reinterpret_cast<__nv_bfloat162*>(
                out + static_cast<size_t>(row0 + r) * p.ldo + n) =
                __floats2bfloat162_rn(v0, v1);
          }
  }
}

// f32: BM rows a block, the LN rows in shared memory, the output in
// 128-column chunks on the CUDA cores (block_tail.cuh's f32_gemm, weight
// tiles staged through shared memory).
template <int BM>
__global__ void __launch_bounds__(kThreads)
    ln_proj_f32_kernel(const ProjParams p) {
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
    if (row < p.M && is_valid(p, row)) {
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

size_t proj_smem_bytes(int rows, int C, bool bf16) {
  if (bf16) return 2 * static_cast<size_t>(rows) * tail::padded(C);
  return sizeof(float) * (static_cast<size_t>(rows) * C +
                          static_cast<size_t>(kBK) * (kNC + 1));
}

// Rows a block: the most that fit in shared memory, halved while the grid
// would leave SMs idle. 0 when nothing fits.
int pick_proj_rows(int M, int C, bool bf16) {
  const int least = bf16 ? 16 : 8;
  int rows = bf16 ? 128 : 64;
  while (rows > least && proj_smem_bytes(rows, C, bf16) > kSmemLimit) rows /= 2;
  if (proj_smem_bytes(rows, C, bf16) > kSmemLimit) return 0;
  while (rows > least && (M + rows - 1) / rows < 132) rows /= 2;
  return rows;
}

template <int MT>
cudaError_t launch_proj_mma(const ProjParams& p, cudaStream_t st) {
  static bool done = false;
  auto kern = ln_proj_mma_kernel<MT>;
  const cudaError_t err = tail::opt_in(kern, done);
  if (err != cudaSuccess) return err;
  kern<<<(p.M + 16 * MT - 1) / (16 * MT), kThreads,
         proj_smem_bytes(16 * MT, p.C, true), st>>>(p);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_proj_f32(const ProjParams& p, cudaStream_t st) {
  static bool done = false;
  auto kern = ln_proj_f32_kernel<BM>;
  const cudaError_t err = tail::opt_in(kern, done);
  if (err != cudaSuccess) return err;
  kern<<<(p.M + BM - 1) / BM, kThreads, proj_smem_bytes(BM, p.C, false),
         st>>>(p);
  return cudaGetLastError();
}

cudaError_t ln_proj(const ProjParams& p, bool bf16, cudaStream_t st) {
  if (p.cout % 32 != 0) return cudaErrorInvalidValue;
  const int rows = pick_proj_rows(p.M, p.C, bf16);
  if (bf16) {
    switch (rows) {
      case 16: return launch_proj_mma<1>(p, st);
      case 32: return launch_proj_mma<2>(p, st);
      case 64: return launch_proj_mma<4>(p, st);
      case 128: return launch_proj_mma<8>(p, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (rows) {
    case 8: return launch_proj_f32<8>(p, st);
    case 16: return launch_proj_f32<16>(p, st);
    case 32: return launch_proj_f32<32>(p, st);
    case 64: return launch_proj_f32<64>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

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

ProjParams proj_params(const void* x, const void* lns, const void* lnb,
                       const void* w, const void* b, void* out, int ldo,
                       int cout, int nscale, float scale, int B, int hp,
                       int wp, int C, int h, int w_real, int shift) {
  ProjParams p = {};
  p.x = x;
  p.lns = static_cast<const float*>(lns);
  p.lnb = static_cast<const float*>(lnb);
  p.w = w;
  p.b = static_cast<const float*>(b);
  p.out = out;
  p.ldo = ldo;
  p.M = B * hp * wp;
  p.C = C;
  p.cout = cout;
  p.nscale = nscale;
  p.scale = scale;
  p.hp = hp;
  p.wp = wp;
  p.vh = h;
  p.vw = w_real;
  p.shift = shift;
  return p;
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

// The tail in place on out (o in, block output out) with x as the shortcut.
cudaError_t tail_in_place(const void* x, const void* wproj, const void* bproj,
                          const void* ln2s, const void* ln2b, const void* w1,
                          const void* b1, const void* w2, const void* b2,
                          void* out, int M, int C, int hidden, int is_bf16,
                          void* stream) {
  tail::Params p = {};
  p.o = out;
  p.x = x;
  p.wp = wproj;
  p.bp = static_cast<const float*>(bproj);
  p.lns = static_cast<const float*>(ln2s);
  p.lnb = static_cast<const float*>(ln2b);
  p.w1 = w1;
  p.b1 = static_cast<const float*>(b1);
  p.w2 = w2;
  p.b2 = static_cast<const float*>(b2);
  p.out = out;
  p.M = M;
  p.cin = C;
  p.hidden = hidden;
  p.cout = C;
  return tail::run(p, is_bf16, true, stream);
}

const void* offset(const void* base, int elems, int is_bf16) {
  return static_cast<const char*>(base) +
         static_cast<size_t>(elems) * (is_bf16 ? 2 : 4);
}

}  // namespace

// The NewCRF block. x, v, out: contiguous [B, Hp, Wp, C] of the IO dtype
// (x and out 16-byte aligned); qk: scratch [B, Hp, Wp, 2C] of the IO dtype.
// Weights in the IO dtype in torch layout [out, in], contiguous; vectors,
// bias [heads, ws^2, ws^2] and mask (null, or [nW, ws^2, ws^2]) f32. (h, w)
// is the real extent of the map before the roll by (-shift, -shift).
// Returns a cudaError_t.
extern "C" int crf_rowblock_infer(
    const void* x, const void* v, const void* ln1s, const void* ln1b,
    const void* wqk, const void* bqk, const void* bias, const void* mask,
    const void* wproj, const void* bproj, const void* ln2s, const void* ln2b,
    const void* w1, const void* b1, const void* w2, const void* b2, void* qk,
    void* out, int B, int hp, int wp, int C, int heads, int hidden, int ws,
    int h, int w, int shift, float scale, int is_bf16, void* stream) {
  if (!geometry_ok(B, hp, wp, C, heads, hidden, ws) || shift < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ProjParams pp = proj_params(x, ln1s, ln1b, wqk, bqk, qk, 2 * C,
                                    2 * C, C, scale, B, hp, wp, C, h, w,
                                    shift);
  cudaError_t err = ln_proj(pp, is_bf16, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = attend(qk, offset(qk, C, is_bf16), v, 2 * C, 2 * C, C, bias, mask,
               out, B, hp, wp, C, heads, ws, is_bf16, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tail_in_place(x, wproj, bproj, ln2s, ln2b, w1, b1,
                                        w2, b2, out, pp.M, C, hidden,
                                        is_bf16, stream));
}

// The SAM block (never shifted). As crf_rowblock_infer, with LNv and the
// q and kv projections; qkv: scratch [B, Hp, Wp, 3C] of the IO dtype.
extern "C" int sam_rowblock_infer(
    const void* x, const void* v, const void* ln1s, const void* ln1b,
    const void* lnvs, const void* lnvb, const void* wq, const void* bq,
    const void* wkv, const void* bkv, const void* bias, const void* wproj,
    const void* bproj, const void* ln2s, const void* ln2b, const void* w1,
    const void* b1, const void* w2, const void* b2, void* qkv, void* out,
    int B, int hp, int wp, int C, int heads, int hidden, int ws, int h, int w,
    float scale, int is_bf16, void* stream) {
  if (!geometry_ok(B, hp, wp, C, heads, hidden, ws)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ProjParams pq = proj_params(x, ln1s, ln1b, wq, bq, qkv, 3 * C, C, C,
                                    scale, B, hp, wp, C, h, w, 0);
  cudaError_t err = ln_proj(pq, is_bf16, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* kv = const_cast<void*>(offset(qkv, C, is_bf16));
  const ProjParams pkv = proj_params(v, lnvs, lnvb, wkv, bkv, kv, 3 * C,
                                     2 * C, 0, 1.0f, B, hp, wp, C, h, w, 0);
  err = ln_proj(pkv, is_bf16, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = attend(qkv, kv, offset(qkv, 2 * C, is_bf16), 3 * C, 3 * C, 3 * C,
               bias, nullptr, out, B, hp, wp, C, heads, ws, is_bf16, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tail_in_place(x, wproj, bproj, ln2s, ln2b, w1, b1,
                                        w2, b2, out, pq.M, C, hidden,
                                        is_bf16, stream));
}
