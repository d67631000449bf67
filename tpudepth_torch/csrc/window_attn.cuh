// Device code of the channel-packed window attention for inference, shared
// by window_attn_infer.cu (windows stored window-major, [BW, N, C]) and
// rowblock_infer.cu (windows read straight out of the image layout
// [B, Hp, Wp, C]). The arithmetic, the design and what bounds it are
// described at the top of window_attn_infer.cu.
//
// Where a token lies is the one thing the two callers do differently, so the
// kernel takes a row map: rows(win, i) is the row of token i of window win,
// in units of the tensors' row strides (ldq, ldk, ldv, ldo). The windows are
// [B, nW]-major in both, so window win takes mask[win % nW].
//
// Everything is in namespace wattn inside an unnamed namespace: each source
// that includes it gets its own copy with internal linkage, and the names do
// not meet those of block_tail.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {
namespace wattn {

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
  long long ldq, ldk, ldv, ldo;  // element strides of a token row
  const float* bias;             // [heads, N, N]
  const float* mask;             // null, or [nW, N, N]
  void* out;
  int N, C, heads, nW;
};

// Window-major windows [BW, N, C]: token i of window win is row win N + i.
struct WindowMajor {
  int n;
  __device__ __forceinline__ long long operator()(int win, int i) const {
    return static_cast<long long>(win) * n + i;
  }
};

// Windows of ws x ws tokens read out of the image layout [B, Hp, Wp, C]:
// window win = (b, wi, wj) of the nW = (Hp / ws)(Wp / ws) windows of an
// image (nww per window row), token i = (r, s) is image row
// (b Hp + wi ws + r) Wp + wj ws + s.
struct ImageRows {
  int ws, hp, wp, nww, nw;
  __device__ __forceinline__ long long operator()(int win, int i) const {
    const int b = win / nw;
    const int w = win - b * nw;
    const int wi = w / nww;
    const int wj = w - wi * nww;
    const int r = i / ws;
    const int s = i - r * ws;
    return (static_cast<long long>(b) * hp + wi * ws + r) * wp + wj * ws + s;
  }
};

__host__ __device__ inline size_t smem_bytes(int n, int d) {
  return sizeof(float) * (static_cast<size_t>(n) * (3 * d + 2) +
                          static_cast<size_t>(n) * (n + 1));
}

template <typename T, typename Rows>
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

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  for (int e = tid; e < n * d; e += kThreads) {
    const int i = e / d;
    const int c = e - i * d;
    const int col = h * d + c;
    const long long row = rows(win, i);
    qs[i * (d + 1) + c] = to_f(q[row * p.ldq + col]);
    ks[i * (d + 1) + c] = to_f(k[row * p.ldk + col]);
    vs[i * d + c] = to_f(v[row * p.ldv + col]);
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
    out[rows(win, i) * p.ldo + h * d + c] = from_f<T>(acc);
  }
}

// The shapes the kernel takes: N <= 64 tokens a window, a head width that
// is a multiple of 8 up to 64, at most 65535 heads.
inline bool shape_ok(int n, int c, int heads) {
  return n >= 1 && n <= kMaxN && heads >= 1 && heads <= 65535 &&
         c % heads == 0 && (c / heads) % 8 == 0 && c / heads <= kMaxD;
}

// One block per (window, head) over bw windows.
template <typename T, typename Rows>
cudaError_t launch(const Params& p, const Rows& rows, int bw,
                   cudaStream_t st) {
  static bool opted_in = false;  // once, before any graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        window_attn_kernel<T, Rows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxN, kMaxD)));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(bw, p.heads);
  window_attn_kernel<T, Rows>
      <<<grid, kThreads, smem_bytes(p.N, p.C / p.heads), st>>>(p, rows);
  return cudaGetLastError();
}

}  // namespace wattn
}  // namespace
