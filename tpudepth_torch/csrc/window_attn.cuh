// Device code of the channel-packed window attention, shared by
// window_attn_infer.cu and window_attn_train.cu (windows stored
// window-major, [BW, N, C]), block_infer.cu (the same) and
// rowblock_infer.cu (windows read straight out of the image layout
// [B, Hp, Wp, C]). The arithmetic and what bounds it are described at the
// top of window_attn_infer.cu.
//
// Where a token lies is the one thing the callers do differently, so the
// kernels take a row map: rows.window(win)(i) is the row of token i of
// window win, in units of the tensors' row strides (ldq, ldk, ldv, ldo);
// window(win) does the per-window arithmetic once. The windows are
// [B, nW]-major in all of them, so window win takes mask[win % nW].
//
// Two forwards, chosen by the IO dtype in launch<T>:
//   * bf16 (fwd_tc_kernel) on the tensor cores: mma.sync m16n8k16 with bf16
//     operands and f32 sums, fed by ldmatrix. One block of 4 warps per
//     (chunk of consecutive windows, head) walks its windows in order; the
//     window's N x d slices of q, k and v go by cp.async, 16 bytes a thread,
//     into bf16 tiles [64][KD + 8] (KD: d rounded up to 16; rows past N and
//     columns past d stay zero), two sets of them, so the next window's
//     copy runs under this window's products. Each warp owns 16 query rows:
//     S = q k^T in registers (KD / 16 k16 steps), the head's bias (read
//     into registers once a block, at the fragment elements the thread
//     owns) then the mask (staged by cp.async with the window's tiles)
//     added in f32, keys past N at -inf, the f32 softmax with quad
//     shuffles and the IEEE division by the row sum (div_rn: one
//     reciprocal a row); P is rounded to bf16 and repacked from the
//     accumulator layout straight into the A fragments of O = P v (v by
//     ldmatrix.trans, 4 k16 steps); O is rounded, staged in the warp's own
//     rows of the window's dead q tile and leaves as 16-byte stores through
//     the row map. No chain sums more than four k16 steps on the tensor
//     cores, whose f32 sums are not rounded to nearest.
//   * f32 (window_attn_kernel) on the CUDA cores, as f32 on the tensor
//     cores would be TF32: one block of 128 threads per (window, head), the
//     head's slices and the N x N scores in shared memory.
// The tile loader, the staging of an accumulator and the row stores are
// shared with window_attn_train.cu's bf16 backward (namespace wtc).
//
// Everything is in namespace wattn inside an unnamed namespace: each source
// that includes it gets its own copy with internal linkage, and the names do
// not meet those of block_tail.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "gub_conv_tc.cuh"

namespace {
namespace wattn {

using tc::bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 64;
constexpr int kMaxD = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  long long ldq, ldk, ldv, ldo;  // element strides of a token row
  const float* bias;             // [heads, N, N]
  const float* mask;             // null, or [nW, N, N]
  void* out;
  int N, C, heads, nW;
};

// Window-major windows [BW, N, C]: token i of window win is row win N + i.
struct WindowMajor {
  int n;
  struct Window {
    long long base;
    __device__ __forceinline__ long long operator()(int i) const {
      return base + i;
    }
  };
  __device__ __forceinline__ Window window(int win) const {
    return {static_cast<long long>(win) * n};
  }
};

// Windows of ws x ws tokens read out of the image layout [B, Hp, Wp, C]:
// window win = (b, wi, wj) of the nW = (Hp / ws)(Wp / ws) windows of an
// image (nww per window row), token i = (r, s) is image row
// (b Hp + wi ws + r) Wp + wj ws + s.
struct ImageRows {
  int ws, hp, wp, nww, nw;
  struct Window {
    long long base;  // (b Hp + wi ws) Wp + wj ws
    int ws, wp;
    float rws;       // 1 / ws
    __device__ __forceinline__ long long operator()(int i) const {
      // r = i / ws exactly for i < 64, ws <= 8: (i + 1/2) / ws is at least
      // 1/16 from an integer, far beyond the float products' error
      const int r = static_cast<int>((static_cast<float>(i) + 0.5f) * rws);
      return base + static_cast<long long>(r) * wp + (i - r * ws);
    }
  };
  __device__ __forceinline__ Window window(int win) const {
    const int b = win / nw;
    const int w = win - b * nw;
    const int wi = w / nww;
    const int wj = w - wi * nww;
    return {(static_cast<long long>(b) * hp + wi * ws) * wp + wj * ws, ws, wp,
            1.f / static_cast<float>(ws)};
  }
};

// ---- f32 on the CUDA cores ------------------------------------------------

__host__ __device__ inline size_t smem_bytes(int n, int d) {
  return sizeof(float) * (static_cast<size_t>(n) * (3 * d + 2) +
                          static_cast<size_t>(n) * (n + 1));
}

template <typename Rows>
__global__ void __launch_bounds__(kThreads)
    window_attn_kernel(const Params p, const Rows rows) {
  extern __shared__ float smem[];
  const int n = p.N;
  const int d = p.C / p.heads;
  const int win = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  float* qs = smem;                 // [n][d + 1]
  float* ks = qs + n * (d + 1);     // [n][d + 1]
  float* vs = ks + n * (d + 1);     // [n][d]
  float* ps = vs + n * d;           // [n][n + 1]

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const auto at = rows.window(win);
  for (int e = tid; e < n * d; e += kThreads) {
    const int i = e / d;
    const int c = e - i * d;
    const int col = h * d + c;
    const long long row = at(i);
    qs[i * (d + 1) + c] = q[row * p.ldq + col];
    ks[i * (d + 1) + c] = k[row * p.ldk + col];
    vs[i * d + c] = v[row * p.ldv + col];
  }
  __syncthreads();

  const float* bias = p.bias + static_cast<size_t>(h) * n * n;
  const float* mask =
      p.mask ? p.mask + static_cast<size_t>(win % p.nW) * n * n : nullptr;
  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n;
    const int j = e - i * n;
    const float* qi = qs + i * (d + 1);
    const float* kj = ks + j * (d + 1);
    float s = 0.f;
    for (int c = 0; c < d; ++c) s = fmaf(qi[c], kj[c], s);
    s = s + bias[e];
    if (mask) s = s + mask[e];
    ps[i * (n + 1) + j] = s;
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int i = tid >> 5; i < n; i += kWarps) {
    float* pr = ps + i * (n + 1);
    const float s0 = lane < n ? pr[lane] : -CUDART_INF_F;
    const float s1 = lane + 32 < n ? pr[lane + 32] : -CUDART_INF_F;
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float e0 = lane < n ? expf(s0 - m) : 0.f;
    const float e1 = lane + 32 < n ? expf(s1 - m) : 0.f;
    float sum = e0 + e1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane < n) pr[lane] = e0 / sum;
    if (lane + 32 < n) pr[lane + 32] = e1 / sum;
  }
  __syncthreads();

  float* out = static_cast<float*>(p.out);
  for (int e = tid; e < n * d; e += kThreads) {
    const int i = e / d;
    const int c = e - i * d;
    const float* pi = ps + i * (n + 1);
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(pi[j], vs[j * d + c], acc);
    out[at(i) * p.ldo + h * d + c] = acc;
  }
}

// ---- bf16 tiles, shared with the bf16 backward -----------------------------

constexpr int kRows = 64;  // a window's tokens, padded: 4 warps of 16 rows

// A bf16 tile of a window's kRows tokens by KD columns (d rounded up to
// 16), row stride KD + 8: the 8 extra columns make ldmatrix's eight row
// addresses fall in distinct 16-byte bank groups.
template <int KD>
struct Tile {
  static constexpr int kLd = KD + 8;
  static constexpr int kSize = kRows * kLd;
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The N x d slices of head h of a window of the NT row tensors src[t]
// (token i in row at(i), rows ld[t] elements apart) into the tiles set + t
// Tile<KD>::kSize (rows i < n, columns c < d; the rest is left alone), 16
// bytes a copy: by cp.async (kVec: every row 16-byte aligned) or by plain
// loads. Piece e is token e / (KD / 8), columns 8 (e % (KD / 8)) .., its
// row found once for all NT tensors.
template <int KD, bool kVec, int NT, typename Window>
__device__ __forceinline__ void load_tiles(bf16* set,
                                           const bf16* const (&src)[NT],
                                           const long long (&ld)[NT],
                                           const Window& at, int h, int n,
                                           int d) {
  constexpr int kPieces = KD / 8;
  for (int e = threadIdx.x; e < n * kPieces; e += kThreads) {
    const int i = e / kPieces;
    const int c = (e - i * kPieces) * 8;
    if (c >= d) continue;
    const long long row = at(i);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const bf16* from = src[t] + row * ld[t] + h * d + c;
      bf16* to = set + t * Tile<KD>::kSize + i * Tile<KD>::kLd + c;
      if constexpr (kVec) {
        tc::cp_async16(to, from);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) to[j] = from[j];
      }
    }
  }
}

// acc (rows r0 + g and r0 + g + 8, columns 8 j + 2 t ..) rounded into the
// staging tile, columns < d and rows < n only (the tile's pad stays zero).
template <int KD>
__device__ __forceinline__ void stage(bf16* tile, const float (&acc)[KD / 8][4],
                                      int r0, int n, int d) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < KD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= d) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half;
      if (row < n)
        *reinterpret_cast<uint32_t*>(tile + row * Tile<KD>::kLd + col) =
            pack2(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// The warp's 16 rows (r0 ..) of an output staged in `tile` (columns < d)
// to the columns of head h of out, token i of the window in row at(i), rows
// ldo elements apart, 16 bytes a store (out and ldo 16-byte aligned), rows
// < n.
template <int KD, typename Window>
__device__ __forceinline__ void store_rows(const bf16* tile, bf16* out,
                                           long long ldo, const Window& at,
                                           int r0, int h, int n, int d) {
  constexpr int kPieces = KD / 8;
  const int lane = threadIdx.x & 31;
  out += h * d;
#pragma unroll
  for (int e = lane; e < 16 * kPieces; e += 32) {
    const int i = r0 + e / kPieces;
    const int c = (e % kPieces) * 8;
    if (c >= d || i >= n) continue;
    *reinterpret_cast<uint4*>(out + at(i) * ldo + c) =
        *reinterpret_cast<const uint4*>(tile + i * Tile<KD>::kLd + c);
  }
}

// ---- bf16 forward on the tensor cores --------------------------------------

// x / s for a softmax's exponential 0 <= x <= 1 over its row sum 1 <= s <=
// 64, rounded to nearest even as the IEEE division, from r = 1 / s rounded
// to nearest (once a row). The division's own fast path re-checks every
// element and leaves for a slow path on a masked key's tiny quotient (the
// shift mask's -100 gives x near 2^-144); this one costs five instructions
// an element where x >= 2^-60, and its fifteen for smaller x run only in
// the warps that meet one. scripts/torch_softmax_div_check.py holds it bit
// for bit against x / s on the card.
//
// x >= 2^-60 (or 0): the product x r, corrected twice by its exact
// remainder (Markstein: the first correction makes it faithful, the second
// correctly rounded).
__device__ __forceinline__ float div_rn_normal(float x, float s, float r) {
  float q = __fmul_rn(x, r);
  q = __fmaf_rn(__fmaf_rn(-q, s, x), r, q);
  return __fmaf_rn(__fmaf_rn(-q, s, x), r, q);
}

// 0 < x < 2^-60: the quotient of x 2^100 (exact, and in the range above),
// scaled back where it is normal; below 2^-126 it is rounded to the
// denormal grid 2^-149: x / s 2^149 = q 2^49 + rem / s 2^49 with q 2^49 <
// 2^23 of 24 bits, so only a q 2^49 halfway between integers needs the sign
// of the exact remainder rem.
__device__ __forceinline__ float div_rn_tiny(float x, float s, float r) {
  const float xs = x * 0x1p100f;
  const float q = div_rn_normal(xs, s, r);
  const float rem = __fmaf_rn(-q, s, xs);
  const float y = q * 0x1p49f;
  const bool tie = y - truncf(y) == 0.5f && rem != 0.f;
  const float k = tie ? (rem > 0.f ? ceilf(y) : floorf(y)) : rintf(y);
  return q >= 0x1p-26f ? q * 0x1p-100f
                       : __int_as_float(static_cast<int>(k));  // k 2^-149
}

__device__ __forceinline__ bool tiny(float x) {
  return x > 0.f && x < 0x1p-60f;
}

__device__ __forceinline__ float div_rn(float x, float s, float r) {
  return tiny(x) ? div_rn_tiny(x, s, r) : div_rn_normal(x, s, r);
}

// About this many (chunk of windows, head) blocks a call (two rounds of 4
// blocks an SM on the H100's 132 SMs), whatever the shape.
constexpr int kFwdBlocks = 1056;

// Windows a forward block walks: a function of the shape alone.
inline int fwd_chunk(int bw, int heads) {
  const int want = (kFwdBlocks + heads - 1) / heads;
  const int blocks = bw < want ? bw : want;
  return (bw + blocks - 1) / blocks;
}

// A window's mask staged in shared memory: its n x n f32 values from the
// 16-byte boundary at or below its start (offset (start % 16) / 4 floats),
// in a slot of this many floats.
__host__ __device__ inline int mask_slot(int n) { return (n * n + 6) / 4 * 4; }

// Shared memory of the forward: two sets of the q, k, v tiles, then for a
// masked call two mask slots.
template <int KD>
__host__ __device__ inline int fwd_smem_bytes(int n, bool masked) {
  return 2 * 3 * Tile<KD>::kSize * static_cast<int>(sizeof(bf16)) +
         (masked ? 2 * mask_slot(n) * static_cast<int>(sizeof(float)) : 0);
}

__device__ __forceinline__ int mask_offset(const float* src) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15) / 4;
}

// A window's mask src (n x n f32, 4-byte aligned) into its slot, 16 bytes
// a cp.async; the two pieces that reach past its ends, 4 bytes a copy.
__device__ __forceinline__ void load_mask(float* dst, const float* src,
                                          int n) {
  const int off = mask_offset(src);
  const int end = off + n * n;
  src -= off;
  for (int i = 4 * threadIdx.x; i < end; i += 4 * kThreads) {
    if (i >= off && i + 4 <= end) {
      tc::cp_async16(dst + i, src + i);
    } else {
      for (int k = max(i, off); k < min(i + 4, end); ++k)
        tc::cp_async4(dst + k, src + k);
    }
  }
}

template <int KD, bool kVec, typename Rows>
__global__ void __launch_bounds__(kThreads, 4)
    fwd_tc_kernel(const Params p, const Rows rows, int bw, int chunk) {
  using tc::ldsm_x4;
  using tc::ldsm_x4_t;
  using tc::mma;
  constexpr int kLd = Tile<KD>::kLd;
  constexpr int kSet = 3 * Tile<KD>::kSize;  // q, k, v
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sets = reinterpret_cast<bf16*>(smem_raw);
  const int n = p.N;
  const int d = p.C / p.heads;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int w0 = blockIdx.x * chunk;
  const int w1 = min(w0 + chunk, bw);
  const bf16* const src[3] = {static_cast<const bf16*>(p.q),
                              static_cast<const bf16*>(p.k),
                              static_cast<const bf16*>(p.v)};
  const long long ld[3] = {p.ldq, p.ldk, p.ldv};
  const float* bias = p.bias + static_cast<size_t>(h) * n * n;
  bf16* out = static_cast<bf16*>(p.out);
  // a masked call stages each window's mask beside its tiles
  float* masks = reinterpret_cast<float*>(sets + 2 * kSet);
  auto window_mask = [&](int win) {
    return p.mask + static_cast<size_t>(win % p.nW) * n * n;
  };
  auto load = [&](int win) {
    const int slot = (win - w0) & 1;
    load_tiles<KD, kVec>(sets + slot * kSet, src, ld, rows.window(win), h, n,
                         d);
    if (p.mask) load_mask(masks + slot * mask_slot(n), window_mask(win), n);
  };

  // zero both sets once: rows past n and columns past d stay zero
  for (int e = threadIdx.x; e < 2 * kSet / 8; e += kThreads)
    reinterpret_cast<uint4*>(sets)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  load(w0);
  tc::cp_async_commit();

  // the head's bias at the fragment elements the thread owns (rows r0 + g
  // (+ 8), columns 8 j + 2 t (+ 1)), read once for all windows
  float bv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
      bv[j][e] = row < n && col < n ? __ldg(bias + row * n + col) : 0.f;
    }

  for (int win = w0; win < w1; ++win) {
    bf16* cur = sets + ((win - w0) & 1) * kSet;
    bf16* qs = cur;
    const bf16* ks = cur + Tile<KD>::kSize;
    const bf16* vs = cur + 2 * Tile<KD>::kSize;
    tc::cp_async_wait_all();
    __syncthreads();  // the window is in; every warp is done with the last
    if (win + 1 < w1) load(win + 1);
    tc::cp_async_commit();

    // S = q k^T for the warp's 16 query rows, 64 keys (key tiles past n
    // are zero and skipped)
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      uint32_t aq[4];
      ldsm_x4(aq, qs + (r0 + (lane & 15)) * kLd + 16 * kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (16 * np >= n) continue;
        uint32_t b[4];
        ldsm_x4(b, ks + (16 * np + (lane & 7) + (lane >> 4) * 8) * kLd +
                       16 * kk + ((lane >> 3) & 1) * 8);
        mma(s[2 * np], aq, b[0], b[1]);
        mma(s[2 * np + 1], aq, b[2], b[3]);
      }
    }

    // P = softmax(S + bias [+ mask]); rows past n and keys past n are
    // zeros. A quad holds one row: its shuffles stay inside it, and every
    // lane runs them (rows past n too).
    const float* mask =
        p.mask ? masks + ((win - w0) & 1) * mask_slot(n) +
                     mask_offset(window_mask(win))
               : nullptr;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half;
      const bool rin = row < n;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= n) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          float v = -CUDART_INF_F;
          if (rin && col < n) {
            v = s[j][2 * half + e] + bv[j][2 * half + e];
            if (mask) v = v + mask[row * n + col];
          }
          s[j][2 * half + e] = v;
          m = fmaxf(m, v);
        }
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= n) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const float x =
              rin && col < n ? expf(s[j][2 * half + e] - m) : 0.f;
          s[j][2 * half + e] = x;
          sum += x;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      // P = x / sum (rows past n: 0); the tiny quotients' path only in a
      // warp that has one
      const float inv = __frcp_rn(sum);
      bool any_tiny = false;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) any_tiny |= tiny(s[j][2 * half + e]);
      if (__any_sync(0xffffffffu, any_tiny)) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (8 * j >= n) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            s[j][2 * half + e] =
                rin ? div_rn(s[j][2 * half + e], sum, inv) : 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (8 * j >= n) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            s[j][2 * half + e] =
                rin ? div_rn_normal(s[j][2 * half + e], sum, inv) : 0.f;
        }
      }
    }

    // P rounded to bf16, straight from the accumulator layout into the A
    // fragments of O = P v (keys 16 kk ..)
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        pa[j >> 1][(j & 1) * 2 + half] =
            pack2(s[j][2 * half], s[j][2 * half + 1]);
    float o[KD / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (16 * kk >= n) continue;
#pragma unroll
      for (int np = 0; np < KD / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, vs + (16 * kk + (lane & 15)) * kLd + 16 * np +
                         (lane >> 4) * 8);
        mma(o[2 * np], pa[kk], b[0], b[1]);
        mma(o[2 * np + 1], pa[kk], b[2], b[3]);
      }
    }

    // O through the warp's own rows of the q tile, which only this warp
    // read
    __syncwarp();
    stage<KD>(qs, o, r0, n, d);
    __syncwarp();
    store_rows<KD>(qs, out, p.ldo, rows.window(win), r0, h, n, d);
  }
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <int KD, bool kVec, typename Rows>
cudaError_t launch_tc_kernel(const Params& p, const Rows& rows, int bw,
                             cudaStream_t st) {
  static bool opted_in = false;  // once, before any graph capture
  auto kern = fwd_tc_kernel<KD, kVec, Rows>;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fwd_smem_bytes<KD>(kMaxN, true));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int chunk = fwd_chunk(bw, p.heads);
  const dim3 grid((bw + chunk - 1) / chunk, p.heads);
  kern<<<grid, kThreads, fwd_smem_bytes<KD>(p.N, p.mask != nullptr), st>>>(
      p, rows, bw, chunk);
  return cudaGetLastError();
}

template <bool kVec, typename Rows>
cudaError_t launch_tc_width(const Params& p, const Rows& rows, int bw,
                            cudaStream_t st) {
  switch ((p.C / p.heads + 15) / 16) {
    case 1: return launch_tc_kernel<16, kVec>(p, rows, bw, st);
    case 2: return launch_tc_kernel<32, kVec>(p, rows, bw, st);
    case 3: return launch_tc_kernel<48, kVec>(p, rows, bw, st);
    case 4: return launch_tc_kernel<64, kVec>(p, rows, bw, st);
    default: return cudaErrorInvalidValue;
  }
}

// The shapes the kernels take: N <= 64 tokens a window, a head width that
// is a multiple of 8 up to 64, at most 65535 heads.
inline bool shape_ok(int n, int c, int heads) {
  return n >= 1 && n <= kMaxN && heads >= 1 && heads <= 65535 &&
         c % heads == 0 && (c / heads) % 8 == 0 && c / heads <= kMaxD;
}

// The attention over bw windows in the IO dtype T. bf16: the tensor-core
// kernel, q, k and v copied 16 bytes at a time when every token row is
// 16-byte aligned (else by plain loads); out and ldo must be. f32: one
// block per (window, head) on the CUDA cores.
template <typename T, typename Rows>
cudaError_t launch(const Params& p, const Rows& rows, int bw,
                   cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (!aligned16(p.out) || p.ldo % 8 != 0) return cudaErrorInvalidValue;
    const bool vec = aligned16(p.q) && aligned16(p.k) && aligned16(p.v) &&
                     (p.ldq | p.ldk | p.ldv) % 8 == 0;
    return vec ? launch_tc_width<true>(p, rows, bw, st)
               : launch_tc_width<false>(p, rows, bw, st);
  } else {
    static_assert(std::is_same<T, float>::value, "f32 or bf16");
    static bool opted_in = false;  // once, before any graph capture
    if (!opted_in) {
      cudaError_t err = cudaFuncSetAttribute(
          window_attn_kernel<Rows>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem_bytes(kMaxN, kMaxD)));
      if (err != cudaSuccess) return err;
      opted_in = true;
    }
    const dim3 grid(bw, p.heads);
    window_attn_kernel<Rows>
        <<<grid, kThreads, smem_bytes(p.N, p.C / p.heads), st>>>(p, rows);
    return cudaGetLastError();
  }
}

}  // namespace wattn
}  // namespace
