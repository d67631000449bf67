// Channel-packed window attention for training, for Hopper (sm_90a): the
// forward and its analytic backward.
//
//   forward:  out[w, :, h*d:(h+1)*d] = P_h v_h,
//             P_h = softmax(q_h k_h^T + bias[h] [+ mask[w % nW]])
//   backward: dv = Pd^T g, dp = g v^T, ds = P (dp - rowsum(dp P)),
//             dq = dsd k, dk = dsd^T q, dbias[h] = sum over windows of ds
//
// for every window w of q, k, v, g [BW, N, C] (C = heads * d, q
// pre-scaled), bias [heads, N, N] f32 and the optional additive shift mask
// [nW, N, N] f32 (windows are [B, nW]-major, so window w takes
// mask[w % nW]). The mask gets no gradient.
//
// Replaces tpudepth/ops/pallas/window_attn.py::window_attention_pallas
// (:103, the forward) and ::window_attention_bwd_pallas (:236, body
// _bwd_body :176), the Pallas TPU kernels under the custom VJP
// window_attention (:298-338). Same arithmetic, in this order:
//   * forward: that of window_attn_infer.cu (products of IO-dtype values
//     summed in f32, bias then mask added in f32, f32 softmax, the
//     probabilities ROUNDED to the IO dtype before P v, which sums in f32,
//     the output rounded); this entry launches the same device code
//     (window_attn.cuh: bf16 on the tensor cores, f32 on the CUDA cores)
//     under its own name;
//   * backward: P recomputed in f32 and kept unrounded; Pd = round(P) for
//     dv; dp = g v^T summed in f32; ds in f32; dsd = round(ds) for dq and
//     dk; dq, dk, dv rounded to the IO dtype; dbias summed in f32 from the
//     unrounded ds.
//
// What bounds it: per window and head the backward does 10 N^2 d
// operations (five N x N x d products) against 7 N d IO elements, about 70
// operations per element (35 per bf16 byte): far below the card's ~295 per
// byte, so bytes bound it (q, k, v, g read once; dq, dk, dv written once).
//
// Design of the bf16 backward (namespace wtc). The products go on the
// tensor cores: mma.sync m16n8k16 with bf16 operands and f32 sums, fed by
// ldmatrix, which maps the rounding order exactly (q, k, v, g are bf16; dv
// takes Pd = round(P), dq and dk take dsd = round(ds); every sum is f32).
// One block of 4 warps per (chunk of windows, head) walks its chunk's
// windows in order:
//   1. the window's N x d slices of q, k, v and g are copied by cp.async,
//      16 bytes a thread, into bf16 tiles in shared memory [64][KD + 8]
//      (KD: d rounded up to 16; rows and columns past N and d stay zero),
//      two sets of them, so the next window's copy runs under this
//      window's products;
//   2. each warp owns 16 query rows: S = q k^T and dP = g v^T in registers
//      (KD / 16 k16 steps), bias then mask added in f32, the f32 softmax
//      and rowsum(dP P) with quad shuffles (columns past N at -inf), ds =
//      P (dP - rowsum), and dq = dsd k with the A fragments taken straight
//      from the accumulator layout (k read by ldmatrix.trans); Pd and dsd
//      go to [64][72] bf16 tiles;
//   3. after one barrier each warp owns 16 key rows: dv = Pd^T g and dk =
//      dsd^T q, both operands read by ldmatrix.trans;
//   4. dq, dk and dv are staged in the warp's own rows of the window's
//      dead k and v tiles and leave as 16-byte stores.
// The tiles, their loader, the staging and the row stores are those of the
// bf16 forward (window_attn.cuh).
// No chain sums more than four k16 steps on the tensor cores (K = KD <= 64
// for S and dP, K = 64 keys for the rest): their f32 sums are not rounded
// to nearest, and chains that short stay within the f32 tolerance.
// dbias: each thread adds the unrounded ds of the fragment elements it
// owns, over its windows in order, into an f32 [64][68] tile in shared
// memory (registers would hold them at the cost of a third block an SM),
// which the block writes to its chunk's slot of the partial buffer
// [chunks, heads, N, N]; a second kernel adds the chunks in a fixed order.
// The chunking depends on the shape alone, so a rerun is bit-equal. Each
// thread reads the head's bias at its fragment elements once, into
// registers, for all its windows, so a window's softmax loads nothing but
// the mask. At d 32 a block takes 75 KB of shared memory and at most 168
// registers a thread: 3 blocks an SM. The f32 softmax and its division,
// not the products, take most of the instructions; on an NVIDIA H100 80GB
// HBM3 at 700 W the four calls of a batch-8 SAM step take 0.716 ms this
// way, 3.838 on the CUDA cores (chip_smoke.py [train kernel time]).
//
// The f32 backward (namespace wtrain) stays on the CUDA cores: one block of
// 128 threads per (chunk of windows, head), the head's N x d slices and the
// N x N f32 probabilities and ds in shared memory (about 55 KB at N 49, d
// 32); scores and dp one (i, j) per thread pass; softmax, the row sums of
// dp P and ds one warp per row; dq, dk, dv one (row, channel) per thread
// pass, products in f32; dbias from an N x N f32 accumulator in shared
// memory per block into the same partial buffer.

#include "window_attn.cuh"

namespace {
namespace wtrain {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* g;           // [BW, N, C] contiguous
  long long ldq, ldk, ldv;  // element strides of a token row of q, k, v
  const float* bias;       // [heads, N, N]
  const float* mask;       // null, or [nW, N, N]
  void* dq;                // [BW, N, C] contiguous, IO dtype
  void* dk;
  void* dv;
  float* partial;          // [chunks, heads, N, N]
  int bw, N, C, heads, nW, chunk;
};

__host__ __device__ inline size_t bwd_smem_bytes(int n, int d) {
  // q, k, v, g: n x (d + 1); P and ds: n x (n + 1); the dbias accumulator
  return sizeof(float) * (4 * static_cast<size_t>(n) * (d + 1) +
                          2 * static_cast<size_t>(n) * (n + 1) +
                          static_cast<size_t>(n) * n);
}

// The f32 backward (bf16 runs wtc::bwd_tc_kernel below).
__global__ void __launch_bounds__(kThreads) bwd_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  const int n = p.N;
  const int d = p.C / p.heads;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ld = d + 1;
  const int lp = n + 1;
  float* qs = smem;          // [n][d + 1]
  float* ks = qs + n * ld;
  float* vs = ks + n * ld;
  float* gs = vs + n * ld;
  float* ps = gs + n * ld;   // [n][n + 1]: P, f32
  float* ds = ps + n * lp;   // [n][n + 1]: dp, then ds
  float* acc = ds + n * lp;  // [n * n]: this chunk's sum of ds
  for (int e = tid; e < n * n; e += kThreads) acc[e] = 0.f;

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* g = static_cast<const float*>(p.g);
  float* dq = static_cast<float*>(p.dq);
  float* dk = static_cast<float*>(p.dk);
  float* dv = static_cast<float*>(p.dv);
  const float* bias = p.bias + static_cast<size_t>(h) * n * n;
  const int w0 = blockIdx.x * p.chunk;
  const int w1 = min(w0 + p.chunk, p.bw);

  for (int win = w0; win < w1; ++win) {
    __syncthreads();  // the previous window is done with shared memory
    for (int e = tid; e < n * d; e += kThreads) {
      const int i = e / d;
      const int c = e - i * d;
      const int col = h * d + c;
      const long long row = static_cast<long long>(win) * n + i;
      qs[i * ld + c] = q[row * p.ldq + col];
      ks[i * ld + c] = k[row * p.ldk + col];
      vs[i * ld + c] = v[row * p.ldv + col];
      gs[i * ld + c] = g[row * p.C + col];
    }
    __syncthreads();

    // scores q k^T + bias [+ mask] and dp = g v^T, f32
    const float* mask =
        p.mask ? p.mask + static_cast<size_t>(win % p.nW) * n * n : nullptr;
    for (int e = tid; e < n * n; e += kThreads) {
      const int i = e / n;
      const int j = e - i * n;
      const float* qi = qs + i * ld;
      const float* kj = ks + j * ld;
      const float* gi = gs + i * ld;
      const float* vj = vs + j * ld;
      float s = 0.f, t = 0.f;
      for (int c = 0; c < d; ++c) {
        s = fmaf(qi[c], kj[c], s);
        t = fmaf(gi[c], vj[c], t);
      }
      s = s + bias[e];
      if (mask) s = s + mask[e];
      ps[i * lp + j] = s;
      ds[i * lp + j] = t;
    }
    __syncthreads();

    // P = softmax(scores) unrounded; ds = P (dp - sum_j dp P), a warp a row
    for (int i = tid >> 5; i < n; i += kWarps) {
      float* pr = ps + i * lp;
      float* dr = ds + i * lp;
      const bool in0 = lane < n;
      const bool in1 = lane + 32 < n;
      const float s0 = in0 ? pr[lane] : -CUDART_INF_F;
      const float s1 = in1 ? pr[lane + 32] : -CUDART_INF_F;
      float m = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float e0 = in0 ? expf(s0 - m) : 0.f;
      const float e1 = in1 ? expf(s1 - m) : 0.f;
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float p0 = e0 / sum;
      const float p1 = e1 / sum;
      const float dp0 = in0 ? dr[lane] : 0.f;
      const float dp1 = in1 ? dr[lane + 32] : 0.f;
      float r = dp0 * p0 + dp1 * p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        r += __shfl_xor_sync(0xffffffffu, r, off);
      if (in0) {
        pr[lane] = p0;
        dr[lane] = p0 * (dp0 - r);
      }
      if (in1) {
        pr[lane + 32] = p1;
        dr[lane + 32] = p1 * (dp1 - r);
      }
    }
    __syncthreads();

    // dbias: the unrounded ds, each element always by the same thread
    for (int e = tid; e < n * n; e += kThreads) {
      const int i = e / n;
      acc[e] += ds[i * lp + (e - i * n)];
    }

    // dv[r] = sum_t Pd[t, r] g[t]; dk[r] = sum_t dsd[t, r] q[t];
    // dq[r] = sum_t dsd[r, t] k[t]
    for (int e = tid; e < n * d; e += kThreads) {
      const int r = e / d;
      const int c = e - r * d;
      float a_dv = 0.f, a_dk = 0.f, a_dq = 0.f;
      for (int t = 0; t < n; ++t) {
        a_dv = fmaf(ps[t * lp + r], gs[t * ld + c], a_dv);
        a_dk = fmaf(ds[t * lp + r], qs[t * ld + c], a_dk);
        a_dq = fmaf(ds[r * lp + t], ks[t * ld + c], a_dq);
      }
      const long long o =
          (static_cast<long long>(win) * n + r) * p.C + h * d + c;
      dq[o] = a_dq;
      dk[o] = a_dk;
      dv[o] = a_dv;
    }
  }
  float* part =
      p.partial + (static_cast<size_t>(blockIdx.x) * p.heads + h) * n * n;
  for (int e = tid; e < n * n; e += kThreads) part[e] = acc[e];
}

// dbias[e] = sum over chunks z, in order, of partial[z][e]
__global__ void dbias_sum_kernel(const float* partial, int chunks, int total,
                                 float* dbias) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.f;
  for (int z = 0; z < chunks; ++z)
    s += partial[static_cast<size_t>(z) * total + e];
  dbias[e] = s;
}

cudaError_t launch_bwd(const BwdParams& p, int chunks, float* dbias,
                       cudaStream_t st) {
  static bool opted_in = false;  // once, before any graph capture
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bwd_smem_bytes(wattn::kMaxN, wattn::kMaxD)));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(chunks, p.heads);
  bwd_kernel<<<grid, kThreads, bwd_smem_bytes(p.N, p.C / p.heads), st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = p.heads * p.N * p.N;
  dbias_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(p.partial, chunks,
                                                        total, dbias);
  return cudaGetLastError();
}

}  // namespace wtrain

namespace wtc {

using tc::bf16;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma;
using wattn::aligned16;
using wattn::kRows;
using wattn::pack2;
using wattn::stage;
using wattn::store_rows;
using wattn::Tile;
using wtrain::BwdParams;

using wattn::kThreads;          // 4 warps of 16 query (then key) rows
constexpr int kLdP = kRows + 8;  // row stride of the Pd and dsd tiles
constexpr int kLdB = kRows + 4;  // row stride of the f32 dbias sums

// Shared memory of the kernel for heads KD wide (d rounded up to 16): two
// sets of the q, k, v, g tiles (wattn::Tile<KD>), then Pd and dsd
// [kRows][kLdP], all bf16, then the f32 dbias sums [kRows][kLdB].
template <int KD>
struct Layout {
  static constexpr int kLd = Tile<KD>::kLd;
  static constexpr int kTile = Tile<KD>::kSize;
  static constexpr int kSet = 4 * kTile;
  static constexpr int kBytes =
      2 * (2 * kSet + 2 * kRows * kLdP) + 4 * kRows * kLdB;
};

// The N x d slices of head h of window win of q, k, v and g into the tiles
// of `set` (wattn::load_tiles on window-major rows; g's rows are C apart).
template <int KD, bool kVec>
__device__ __forceinline__ void load_window(bf16* set, const BwdParams& p,
                                            int win, int h, int n, int d) {
  const bf16* const src[4] = {
      static_cast<const bf16*>(p.q), static_cast<const bf16*>(p.k),
      static_cast<const bf16*>(p.v), static_cast<const bf16*>(p.g)};
  const long long ld[4] = {p.ldq, p.ldk, p.ldv, p.C};
  wattn::load_tiles<KD, kVec>(set, src, ld, wattn::WindowMajor{n}.window(win),
                              h, n, d);
}

template <int KD, bool kVec>
__global__ void __launch_bounds__(kThreads, 3) bwd_tc_kernel(const BwdParams p) {
  using L = Layout<KD>;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sets = reinterpret_cast<bf16*>(smem_raw);
  bf16* pd_s = sets + 2 * L::kSet;      // [kRows][kLdP]
  bf16* ds_s = pd_s + kRows * kLdP;     // [kRows][kLdP]
  float* db_s = reinterpret_cast<float*>(ds_s + kRows * kLdP);
                                        // [kRows][kLdB]: this chunk's dbias
  const int n = p.N;
  const int d = p.C / p.heads;
  const wattn::WindowMajor rows = {n};
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const int w0 = blockIdx.x * p.chunk;
  const int w1 = min(w0 + p.chunk, p.bw);
  const float* bias = p.bias + static_cast<size_t>(h) * n * n;
  bf16* dq_g = static_cast<bf16*>(p.dq);
  bf16* dk_g = static_cast<bf16*>(p.dk);
  bf16* dv_g = static_cast<bf16*>(p.dv);

  // zero both sets once: rows past n and columns past d stay zero
  for (int e = threadIdx.x; e < 2 * L::kSet / 8; e += kThreads)
    reinterpret_cast<uint4*>(sets)[e] = make_uint4(0, 0, 0, 0);
  for (int e = threadIdx.x; e < kRows * kLdB; e += kThreads) db_s[e] = 0.f;
  __syncthreads();
  load_window<KD, kVec>(sets, p, w0, h, n, d);
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
    bf16* cur = sets + ((win - w0) & 1) * L::kSet;
    const bf16* qs = cur;
    bf16* ks = cur + L::kTile;
    bf16* vs = cur + 2 * L::kTile;
    const bf16* gs = cur + 3 * L::kTile;
    tc::cp_async_wait_all();
    __syncthreads();  // the window is in; every warp is done with the last
    if (win + 1 < w1)
      load_window<KD, kVec>(sets + ((win + 1 - w0) & 1) * L::kSet, p,
                            win + 1, h, n, d);
    tc::cp_async_commit();

    // S = q k^T and dP = g v^T for the warp's 16 query rows, 64 keys
    float s[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      uint32_t aq[4], ag[4];
      const int ao = (r0 + (lane & 15)) * kLd + 16 * kk + (lane >> 4) * 8;
      ldsm_x4(aq, qs + ao);
      ldsm_x4(ag, gs + ao);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        const int bo = (16 * np + (lane & 7) + (lane >> 4) * 8) * kLd +
                       16 * kk + ((lane >> 3) & 1) * 8;
        ldsm_x4(b, ks + bo);
        mma(s[2 * np], aq, b[0], b[1]);
        mma(s[2 * np + 1], aq, b[2], b[3]);
        ldsm_x4(b, vs + bo);
        mma(dp[2 * np], ag, b[0], b[1]);
        mma(dp[2 * np + 1], ag, b[2], b[3]);
      }
    }

    // P = softmax(S + bias [+ mask]) unrounded, ds = P (dP - rowsum(dP P));
    // rows past n are zeros. A quad holds one row: its shuffles stay inside
    // it, and every lane runs them (rows past n too).
    const float* mask =
        p.mask ? p.mask + static_cast<size_t>(win % p.nW) * n * n : nullptr;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half;
      const bool rin = row < n;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          float v = -CUDART_INF_F;
          if (rin && col < n) {
            v = s[j][2 * half + e] + bv[j][2 * half + e];
            if (mask) v = v + __ldg(mask + row * n + col);
          }
          s[j][2 * half + e] = v;
          m = fmaxf(m, v);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const float x =
              rin && col < n ? expf(s[j][2 * half + e] - m) : 0.f;
          s[j][2 * half + e] = x;
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      float r = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = rin ? s[j][2 * half + e] / sum : 0.f;
          s[j][2 * half + e] = pv;
          r += dp[j][2 * half + e] * pv;
        }
      r += __shfl_xor_sync(0xffffffffu, r, 1);
      r += __shfl_xor_sync(0xffffffffu, r, 2);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = s[j][2 * half + e];
          dp[j][2 * half + e] = rin ? pv * (dp[j][2 * half + e] - r) : 0.f;
        }
    }

    // dbias (unrounded ds; each element always by the same thread); Pd and
    // dsd into their tiles and, as the A fragments of dq = dsd k, into
    // registers
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        db_s[(r0 + g + 8 * (e >> 1)) * kLdB + 8 * j + 2 * t + (e & 1)] +=
            dp[j][e];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o = (r0 + g + 8 * half) * kLdP + 8 * j + 2 * t;
        const uint32_t pp = pack2(s[j][2 * half], s[j][2 * half + 1]);
        const uint32_t dd = pack2(dp[j][2 * half], dp[j][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(pd_s + o) = pp;
        *reinterpret_cast<uint32_t*>(ds_s + o) = dd;
        da[j >> 1][(j & 1) * 2 + half] = dd;
      }
    }
    float acc[KD / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < KD / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, ks + (16 * kk + (lane & 15)) * kLd + 16 * np +
                         (lane >> 4) * 8);
        mma(acc[2 * np], da[kk], b[0], b[1]);
        mma(acc[2 * np + 1], da[kk], b[2], b[3]);
      }
    __syncthreads();  // Pd and dsd are whole; k and v are dead

    // dq through the warp's rows of the k tile
    stage<KD>(ks, acc, r0, n, d);
    __syncwarp();
    store_rows<KD>(ks, dq_g, p.C, rows.window(win), r0, h, n, d);
    __syncwarp();

    // dv = Pd^T g and dk = dsd^T q for the warp's 16 key rows
    float dv[KD / 8][4] = {}, dk[KD / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ap[4], ad[4];
      const int ao = (16 * kk + (lane & 7) + (lane >> 4) * 8) * kLdP + r0 +
                     ((lane >> 3) & 1) * 8;
      ldsm_x4_t(ap, pd_s + ao);
      ldsm_x4_t(ad, ds_s + ao);
#pragma unroll
      for (int np = 0; np < KD / 16; ++np) {
        uint32_t b[4];
        const int bo = (16 * kk + (lane & 15)) * kLd + 16 * np +
                       (lane >> 4) * 8;
        ldsm_x4_t(b, gs + bo);
        mma(dv[2 * np], ap, b[0], b[1]);
        mma(dv[2 * np + 1], ap, b[2], b[3]);
        ldsm_x4_t(b, qs + bo);
        mma(dk[2 * np], ad, b[0], b[1]);
        mma(dk[2 * np + 1], ad, b[2], b[3]);
      }
    }
    stage<KD>(ks, dk, r0, n, d);
    stage<KD>(vs, dv, r0, n, d);
    __syncwarp();
    store_rows<KD>(ks, dk_g, p.C, rows.window(win), r0, h, n, d);
    store_rows<KD>(vs, dv_g, p.C, rows.window(win), r0, h, n, d);
  }

  __syncthreads();
  float* part =
      p.partial + (static_cast<size_t>(blockIdx.x) * p.heads + h) * n * n;
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int row = e / n;
    part[e] = db_s[row * kLdB + e - row * n];
  }
}

template <int KD, bool kVec>
cudaError_t launch_kernel(const BwdParams& p, int chunks, cudaStream_t st) {
  static bool opted_in = false;  // once, before any graph capture
  auto kern = bwd_tc_kernel<KD, kVec>;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<KD>::kBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  kern<<<dim3(chunks, p.heads), kThreads, Layout<KD>::kBytes, st>>>(p);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_width(const BwdParams& p, int chunks, cudaStream_t st) {
  switch ((p.C / p.heads + 15) / 16) {
    case 1: return launch_kernel<16, kVec>(p, chunks, st);
    case 2: return launch_kernel<32, kVec>(p, chunks, st);
    case 3: return launch_kernel<48, kVec>(p, chunks, st);
    case 4: return launch_kernel<64, kVec>(p, chunks, st);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 backward: the tensor-core kernel, then the chunks' dbias sums.
// q, k, v and g are copied 16 bytes at a time when every token row is
// 16-byte aligned (else by plain loads); dq, dk and dv must be.
cudaError_t launch(const BwdParams& p, int chunks, float* dbias,
                   cudaStream_t st) {
  if (!aligned16(p.dq) || !aligned16(p.dk) || !aligned16(p.dv))
    return cudaErrorInvalidValue;
  const bool vec = aligned16(p.q) && aligned16(p.k) && aligned16(p.v) &&
                   aligned16(p.g) && (p.ldq | p.ldk | p.ldv) % 8 == 0;
  cudaError_t err = vec ? launch_width<true>(p, chunks, st)
                        : launch_width<false>(p, chunks, st);
  if (err != cudaSuccess) return err;
  const int total = p.heads * p.N * p.N;
  wtrain::dbias_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      p.partial, chunks, total, dbias);
  return cudaGetLastError();
}

}  // namespace wtc
}  // namespace

// The forward: q, k, v [BW, N, C] with token rows ldq / ldk / ldv elements
// apart and channels contiguous; bias f32 [heads, N, N] and mask (null or
// f32 [nW, N, N], BW a multiple of nW) contiguous; out contiguous
// [BW, N, C]. Returns a cudaError_t.
extern "C" int window_attn_train_fwd(const void* q, const void* k,
                                     const void* v, long long ldq,
                                     long long ldk, long long ldv,
                                     const void* bias, const void* mask,
                                     void* out, int bw, int n, int c,
                                     int heads, int nw, int is_bf16,
                                     void* stream) {
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

// The backward: q, k, v as for the forward; g, dq, dk, dv contiguous
// [BW, N, C] of the IO dtype; dbias f32 [heads, N, N]; partial f32 scratch
// [chunks, heads, N, N] with chunks = ceil(BW / chunk). Two kernels.
// Returns a cudaError_t.
extern "C" int window_attn_train_bwd(const void* q, const void* k,
                                     const void* v, long long ldq,
                                     long long ldk, long long ldv,
                                     const void* g, const void* bias,
                                     const void* mask, void* dq, void* dk,
                                     void* dv, void* dbias, void* partial,
                                     int bw, int n, int c, int heads, int nw,
                                     int chunk, int is_bf16, void* stream) {
  if (bw < 1 || chunk < 1 || !wattn::shape_ok(n, c, heads) ||
      (mask != nullptr && (nw < 1 || bw % nw != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  wtrain::BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.ldq = ldq;
  p.ldk = ldk;
  p.ldv = ldv;
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.partial = static_cast<float*>(partial);
  p.bw = bw;
  p.N = n;
  p.C = c;
  p.heads = heads;
  p.nW = nw;
  p.chunk = chunk;
  const int chunks = (bw + chunk - 1) / chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* db = static_cast<float*>(dbias);
  const cudaError_t err = is_bf16 ? wtc::launch(p, chunks, db, st)
                                  : wtrain::launch_bwd(p, chunks, db, st);
  return static_cast<int>(err);
}
