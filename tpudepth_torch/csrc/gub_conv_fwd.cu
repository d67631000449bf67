// Fused GUB conv forward for Hopper (sm_90a):
//
//     y = conv_k(relu(x * A + C) [+ skip], w) + b      [, sum(y), sum(y^2)]
//
// over the channel concat of up to kMaxParts NHWC inputs, without ever
// writing the activated input to device memory.
//
// Replaces tpudepth/ops/pallas/gub_conv.py::_fwd_call / _fwd_kernel (the
// Pallas TPU kernel). Same arithmetic, in this order:
//   * the prelude relu(x*A + C) is computed in f32 (multiply, then add, each
//     rounded: no contraction into an FMA), the skip is added to part 0
//     after the relu, and the result is rounded to the IO dtype;
//   * zero padding is applied AFTER the prelude: halo pixels outside the
//     image are 0, not relu(C);
//   * weights are f32 in device memory and rounded to the IO dtype when
//     staged; products accumulate in f32 registers;
//   * the bias is added in f32 before the output is rounded, and the
//     statistics sum the ROUNDED output.
// A and C are per (batch item, channel), so an SE excitation folded into
// them can differ per image. Part j uses rows off_j .. off_j + Cin_j of w.
//
// What bounds it: at the GuideDepth widths (Cout <= 64, Cin <= 64) the work
// is 2*9*Cin*Cout FLOPs per pixel against (Cin + Cout) * 2 bytes in bf16, far
// below the card's ~295 FLOP/byte ridge, so the bound is bytes. The design
// reads each input pixel once per Cout slab (one slab when Cout <= 32) and
// writes each output once; the activated input and its one-pixel halo live
// only in shared memory, and so do the weights of the slab.
//
// Design: one block per (image, 8x16 output tile, slab of <= 32 output
// channels), one output pixel per thread with the slab's accumulators in
// registers. Input channels are staged 16 at a time (any count, including
// the 3-channel RGB guide). The products run on the CUDA cores in f32; the
// tensor cores (wgmma) and TMA staging are later work. Per-channel
// statistics are reduced per block in f32 (warp shuffles, then shared
// memory: 128 pixels) and added to global f64 buffers with atomicAdd. The
// order of those additions varies from run to run, but in f64 it moves the
// sums by ~1e-16 of their size: sums over the 2.4 M pixels of a batch-8
// 480x640 stage keep f32 accuracy once rounded (f32 atomics lost ~1e-5 of
// it, which the variance q/n - mean^2 behind them doubles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxParts = 4;
constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;  // one output pixel per thread
constexpr int kChunk = 16;                 // input channels staged per pass

struct Params {
  const void* x[kMaxParts];
  const float* a[kMaxParts];  // null when the conv has no prelude
  const float* c[kMaxParts];
  int cin[kMaxParts];
  int nparts;
  const void* skip;           // null, or part 0's shape
  const float* w;             // f32, indexed through w_stride
  long long w_stride[4];      // element strides of w for (u, v, ci, co)
  const float* b;             // f32 [cout]
  void* y;                    // IO dtype [B, H, W, cout]
  double* s;                  // null, or f64 [cout], zeroed by the caller
  double* q;
  int B, H, W, cout;
};

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

__device__ __forceinline__ void store_io(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_io(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int K, int COS>
__global__ void __launch_bounds__(kThreads)
gub_conv_fwd_kernel(const Params p) {
  constexpr int P = K / 2;
  constexpr int TWP = kTileW + K - 1;
  constexpr int NPIX = (kTileH + K - 1) * TWP;
  __shared__ float xs[kChunk * NPIX];                          // [ci][pixel]
  __shared__ __align__(16) float ws[K * K * kChunk * COS];     // [tap][ci][co]
  __shared__ float red_s[COS];
  __shared__ float red_q[COS];

  const int tiles_w = (p.W + kTileW - 1) / kTileW;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const int co0 = blockIdx.y * COS;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / kTileW;
  const int tx = tid % kTileW;

  float acc[COS];
#pragma unroll
  for (int i = 0; i < COS; ++i) acc[i] = 0.f;

  int off = 0;  // first row of the current part in w
  for (int j = 0; j < p.nparts; ++j) {
    const int cin = p.cin[j];
    const T* x = static_cast<const T*>(p.x[j]);
    const float* A = p.a[j];
    const float* C = p.c[j];
    const T* skip = j == 0 ? static_cast<const T*>(p.skip) : nullptr;
    for (int c0 = 0; c0 < cin; c0 += kChunk) {
      const int cc = min(kChunk, cin - c0);
      __syncthreads();  // the previous chunk's readers are done
      // Activated input tile plus halo; zero outside the image.
      for (int idx = tid; idx < NPIX * cc; idx += kThreads) {
        const int pix = idx / cc;
        const int ci = idx - pix * cc;
        const int iy = ty0 - P + pix / TWP;
        const int ix = tx0 - P + pix % TWP;
        float v = 0.f;
        if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
          const long long e =
              (((long long)bi * p.H + iy) * p.W + ix) * cin + c0 + ci;
          v = to_f(x[e]);
          if (A != nullptr) {
            const int ch = bi * cin + c0 + ci;
            v = fmaxf(__fadd_rn(__fmul_rn(v, A[ch]), C[ch]), 0.f);
            if (skip != nullptr) v = __fadd_rn(v, to_f(skip[e]));
            v = round_io<T>(v);
          }
        }
        xs[ci * NPIX + pix] = v;
      }
      // Weights of this chunk for the Cout slab, rounded to the IO dtype.
      for (int idx = tid; idx < K * K * kChunk * COS; idx += kThreads) {
        const int co = idx % COS;
        const int ci = (idx / COS) % kChunk;
        const int tap = idx / (COS * kChunk);
        float v = 0.f;
        if (ci < cc && co0 + co < p.cout) {
          const long long e = (tap / K) * p.w_stride[0] +
                              (tap % K) * p.w_stride[1] +
                              (long long)(off + c0 + ci) * p.w_stride[2] +
                              (long long)(co0 + co) * p.w_stride[3];
          v = round_io<T>(p.w[e]);
        }
        ws[idx] = v;
      }
      __syncthreads();
      for (int ci = 0; ci < cc; ++ci) {
#pragma unroll
        for (int u = 0; u < K; ++u) {
#pragma unroll
          for (int v = 0; v < K; ++v) {
            const float xv = xs[ci * NPIX + (ty + u) * TWP + tx + v];
            const float4* wp = reinterpret_cast<const float4*>(
                &ws[((u * K + v) * kChunk + ci) * COS]);
#pragma unroll
            for (int k4 = 0; k4 < COS / 4; ++k4) {
              const float4 w4 = wp[k4];
              acc[4 * k4 + 0] = fmaf(xv, w4.x, acc[4 * k4 + 0]);
              acc[4 * k4 + 1] = fmaf(xv, w4.y, acc[4 * k4 + 1]);
              acc[4 * k4 + 2] = fmaf(xv, w4.z, acc[4 * k4 + 2]);
              acc[4 * k4 + 3] = fmaf(xv, w4.w, acc[4 * k4 + 3]);
            }
          }
        }
      }
    }
    off += cin;
  }

  // Epilogue: bias in f32, round, store; keep the rounded value for stats.
  const int oy = ty0 + ty;
  const int ox = tx0 + tx;
  const bool valid = oy < p.H && ox < p.W;
  T* y = static_cast<T*>(p.y) +
         (((long long)bi * p.H + oy) * p.W + ox) * p.cout;
#pragma unroll
  for (int i = 0; i < COS; ++i) {
    const int co = co0 + i;
    float r = 0.f;
    if (valid && co < p.cout) {
      r = round_io<T>(acc[i] + p.b[co]);
      store_io(y + co, r);
    }
    acc[i] = r;
  }

  if (p.s != nullptr) {
    if (tid < COS) {
      red_s[tid] = 0.f;
      red_q[tid] = 0.f;
    }
    __syncthreads();
    const int lane = tid & 31;
#pragma unroll
    for (int i = 0; i < COS; ++i) {
      float sv = acc[i];
      float qv = acc[i] * acc[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sv += __shfl_down_sync(0xffffffffu, sv, o);
        qv += __shfl_down_sync(0xffffffffu, qv, o);
      }
      if (lane == 0) {
        atomicAdd(&red_s[i], sv);
        atomicAdd(&red_q[i], qv);
      }
    }
    __syncthreads();
    if (tid < COS && co0 + tid < p.cout) {
      atomicAdd(&p.s[co0 + tid], static_cast<double>(red_s[tid]));
      atomicAdd(&p.q[co0 + tid], static_cast<double>(red_q[tid]));
    }
  }
}

template <typename T, int K, int COS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int tiles = ((p.H + kTileH - 1) / kTileH) * ((p.W + kTileW - 1) / kTileW);
  const dim3 grid(tiles, (p.cout + COS - 1) / COS, p.B);
  gub_conv_fwd_kernel<T, K, COS><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_slab(const Params& p, cudaStream_t stream) {
  if (p.cout <= 8) return launch<T, K, 8>(p, stream);
  if (p.cout <= 16) return launch<T, K, 16>(p, stream);
  return launch<T, K, 32>(p, stream);
}

template <typename T>
cudaError_t launch_k(const Params& p, int k, cudaStream_t stream) {
  return k == 1 ? launch_slab<T, 1>(p, stream) : launch_slab<T, 3>(p, stream);
}

}  // namespace

// Plain C entry, loaded with ctypes. Arrays hold one entry per part; a[j]
// and c[j] are null when the conv has no prelude, skip/s/q may be null; s and
// q are f64 [cout] accumulators that the caller zeroes.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gub_conv_fwd(int nparts, void* const* x, void* const* a,
                            void* const* c, const int* cin, const void* skip,
                            const void* w, const long long* w_stride,
                            const void* b, void* y, void* s, void* q, int B,
                            int H, int W, int cout, int k, int is_bf16,
                            void* stream) {
  if (nparts < 1 || nparts > kMaxParts || (k != 1 && k != 3) || B < 1 ||
      B > 65535 || H < 1 || W < 1 || cout < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  for (int j = 0; j < nparts; ++j) {
    p.x[j] = x[j];
    p.a[j] = static_cast<const float*>(a[j]);
    p.c[j] = static_cast<const float*>(c[j]);
    p.cin[j] = cin[j];
  }
  p.nparts = nparts;
  p.skip = skip;
  p.w = static_cast<const float*>(w);
  for (int i = 0; i < 4; ++i) p.w_stride[i] = w_stride[i];
  p.b = static_cast<const float*>(b);
  p.y = y;
  p.s = static_cast<double*>(s);
  p.q = static_cast<double*>(q);
  p.B = B;
  p.H = H;
  p.W = W;
  p.cout = cout;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_k<__nv_bfloat16>(p, k, st)
                                  : launch_k<float>(p, k, st);
  return static_cast<int>(err);
}
