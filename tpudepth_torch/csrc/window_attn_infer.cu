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
// Design: one block of 128 threads per (window, head). The head's N x d
// slices of q, k and v (read through a row stride, so k and v may be views
// of one [BW, N, 2C] projection) and the N x N f32 scores live in shared
// memory only (N <= 64, d <= 64 and a multiple of 8: under 70 KB; a whole
// 49 x C row set would be 300 KB at C = 1024). Scores: one (i, j) per
// thread pass, rows padded by one float so neighbouring j fall in different
// banks. Softmax: one warp per row, two columns per lane. Output: one
// (i, c) per thread pass, written channel-packed. The products run on the
// CUDA cores in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 64;
constexpr int kMaxD = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_io(float v);
template <>
__device__ __forceinline__ float round_io<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_io<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  long long ldq, ldk, ldv;  // element strides of a token row
  const float* bias;        // [heads, N, N]
  const float* mask;        // null, or [nW, N, N]
  void* out;                // [BW, N, C] contiguous
  int N, C, heads, nW;
};

__host__ __device__ inline size_t smem_bytes(int n, int d) {
  return sizeof(float) * (static_cast<size_t>(n) * (3 * d + 2) +
                          static_cast<size_t>(n) * (n + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    window_attn_infer_kernel(const Params p) {
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

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const long long row = static_cast<long long>(win) * n;
  for (int e = tid; e < n * d; e += kThreads) {
    const int i = e / d;
    const int c = e - i * d;
    const int col = h * d + c;
    qs[i * (d + 1) + c] = to_f(q[(row + i) * p.ldq + col]);
    ks[i * (d + 1) + c] = to_f(k[(row + i) * p.ldk + col]);
    vs[i * d + c] = to_f(v[(row + i) * p.ldv + col]);
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
    if (lane < n) pr[lane] = round_io<T>(e0 / sum);
    if (lane + 32 < n) pr[lane + 32] = round_io<T>(e1 / sum);
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  for (int e = tid; e < n * d; e += kThreads) {
    const int i = e / d;
    const int c = e - i * d;
    const float* pi = ps + i * (n + 1);
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(pi[j], vs[j * d + c], acc);
    out[(row + i) * p.C + h * d + c] = from_f<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const Params& p, int bw, cudaStream_t st) {
  static bool opted_in = false;  // once, before any graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        window_attn_infer_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxN, kMaxD)));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(bw, p.heads);
  window_attn_infer_kernel<T>
      <<<grid, kThreads, smem_bytes(p.N, p.C / p.heads), st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [BW, N, C] with token rows ldq / ldk / ldv elements apart and
// channels contiguous; bias f32 [heads, N, N] and mask (null or f32
// [nW, N, N], BW a multiple of nW) contiguous; out contiguous [BW, N, C].
// Returns a cudaError_t.
extern "C" int window_attn_infer(const void* q, const void* k, const void* v,
                                 long long ldq, long long ldk, long long ldv,
                                 const void* bias, const void* mask, void* out,
                                 int bw, int n, int c, int heads, int nw,
                                 int is_bf16, void* stream) {
  if (bw < 1 || n < 1 || n > kMaxN || heads < 1 || heads > 65535 ||
      c % heads != 0 || (c / heads) % 8 != 0 || c / heads > kMaxD ||
      (mask != nullptr && (nw < 1 || bw % nw != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ldq = ldq;
  p.ldk = ldk;
  p.ldv = ldv;
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.out = out;
  p.N = n;
  p.C = c;
  p.heads = heads;
  p.nW = nw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(p, bw, st)
                                  : launch<float>(p, bw, st);
  return static_cast<int>(err);
}
