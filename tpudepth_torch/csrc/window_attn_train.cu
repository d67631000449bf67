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
//     (window_attn.cuh) under its own name;
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
// Design. One block of 128 threads per (chunk of windows, head). The head's
// N x d slices of q, k, v and g and the N x N f32 probabilities and ds live
// in shared memory only (N <= 64, d <= 64: about 55 KB at N 49, d 32); the
// block walks its chunk's windows one after another. Scores and dp: one
// (i, j) per thread pass; softmax, the row sums of dp P and ds: one warp per
// row; dq, dk, dv: one (row, channel) per thread pass. The products run on
// the CUDA cores in f32 (the products of bf16 values are exact there).
//
// dbias without atomics: each block adds its windows' ds into an N x N f32
// accumulator in shared memory (each element owned by one thread, windows
// in order) and writes it to its chunk's slot of a partial buffer
// [chunks, heads, N, N]; a second kernel adds the chunks in a fixed order.
// The chunking depends on the shape alone, so a rerun is bit-equal.

#include "window_attn.cuh"

namespace {
namespace wtrain {

using wattn::from_f;
using wattn::round_io;
using wattn::to_f;

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

template <typename T>
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

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* g = static_cast<const T*>(p.g);
  T* dq = static_cast<T*>(p.dq);
  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
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
      qs[i * ld + c] = to_f(q[row * p.ldq + col]);
      ks[i * ld + c] = to_f(k[row * p.ldk + col]);
      vs[i * ld + c] = to_f(v[row * p.ldv + col]);
      gs[i * ld + c] = to_f(g[row * p.C + col]);
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
        a_dv = fmaf(round_io<T>(ps[t * lp + r]), gs[t * ld + c], a_dv);
        a_dk = fmaf(round_io<T>(ds[t * lp + r]), qs[t * ld + c], a_dk);
        a_dq = fmaf(round_io<T>(ds[r * lp + t]), ks[t * ld + c], a_dq);
      }
      const long long o =
          (static_cast<long long>(win) * n + r) * p.C + h * d + c;
      dq[o] = from_f<T>(a_dq);
      dk[o] = from_f<T>(a_dk);
      dv[o] = from_f<T>(a_dv);
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

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, int chunks, float* dbias,
                       cudaStream_t st) {
  static bool opted_in = false;  // once, before any graph capture
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bwd_smem_bytes(wattn::kMaxN, wattn::kMaxD)));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(chunks, p.heads);
  bwd_kernel<T><<<grid, kThreads, bwd_smem_bytes(p.N, p.C / p.heads), st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = p.heads * p.N * p.N;
  dbias_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(p.partial, chunks,
                                                        total, dbias);
  return cudaGetLastError();
}

}  // namespace wtrain
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
  const cudaError_t err =
      is_bf16 ? wtrain::launch_bwd<__nv_bfloat16>(p, chunks, db, st)
              : wtrain::launch_bwd<float>(p, chunks, db, st);
  return static_cast<int>(err);
}
