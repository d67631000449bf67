// Analytic backward of the fused GUB conv for Hopper (sm_90a). With
//
//     xa = relu(x * A + C) [+ skip]     rounded to the IO dtype, 0 outside the image
//     y  = conv_k(xa, w) + b            [, s = sum(y), q = sum(y^2)]
//
// and the cotangents dy, ds, dq, both kernels start from
//
//     g = dy + ds + 2 * dq * y          in f32, y the ROUNDED forward output
//
// gub_conv_dw:  db[co]          = sum over (b,h,w) of g, before g is rounded;
//               dw[u,v,ci,co]   = sum over (b,h,w) of xa[b,h+u-P,w+v-P,ci] * r(g)[b,h,w,co]
// gub_conv_dx:  dxa = conv_k(r(g) zero-padded, w flipped and transposed)   per part
//               dskip = r(dxa)                       (part 0)
//               p = x*A + C, dp = dxa where p > 0, dx = r(dp * A),
//               dA[b,ci] = sum over (h,w) of dp * x,  dC[b,ci] = sum of dp
//
// where r() rounds to the IO dtype and P = k/2. They replace
// tpudepth/ops/pallas/gub_conv.py::_dw_call / _dw_kernel and ::_dx_call /
// _dx_kernel (the Pallas TPU kernels), with the same arithmetic: the prelude
// and g are computed with separate, individually rounded multiplies and adds
// (no contraction into an FMA), so the relu gate of the backward agrees with
// the forward's at p == 0 and g agrees bit for bit with the plain version;
// the halo of g outside the image is 0 (not ds); weights are f32 in device
// memory and rounded to the IO dtype when staged; products sum in f32.
//
// What bounds them: like the forward, 2*9*Cin*Cout FLOPs per pixel against
// (Cin + 2*Cout) * 2 bytes in bf16 at Cin, Cout <= 64 is far below the card's
// ridge, so the bound is bytes. Neither kernel writes an activated tensor or
// g to device memory: both are recomputed on load and live in shared memory.
//
// Design. The TPU kernels walk the batch in grid order and carry dw, db, dA
// and dC in VMEM from step to step; blocks here run in no order, so every
// cross-block sum is two passes: blocks write partial sums, a second small
// kernel adds them in a fixed order. There is no atomicAdd in this file:
// the same inputs at the same shapes give the same bits on every run.
//
// * gub_conv_dw: the parallelism is over pixels (2.46 M of them at 480x640,
//   B 8, into as few as 9*16*16 outputs). A block owns 16 input channels, a
//   slab of <= 32 output channels and every tap: thread (ci, cg) keeps
//   9 * slab/8 sums in registers. It walks 8x16 pixel tiles t = blockIdx.x,
//   blockIdx.x + gridDim.x, ...; per tile it stages xa (with halo) and r(g)
//   in shared memory. gridDim.x is chosen so that about kDwBlocks blocks run;
//   each writes one partial dw. db comes from the blocks of the first
//   channel chunk, summed while g is staged.
// * gub_conv_dx: the forward's layout with the roles swapped: one block per
//   (image, 8x16 tile, slab of <= 32 INPUT channels), one pixel per thread,
//   g staged 16 output channels at a time with its halo, the weights staged
//   flipped. The epilogue gates, stores dx (and dskip) and reduces dp*x and dp
//   over the tile (warp shuffles, then the four warps in order); a second
//   kernel adds the tiles of an image in order.
// The products run on the CUDA cores in f32; tensor cores and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxParts = 4;
constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kThreads = kTileH * kTileW;  // one pixel per thread
constexpr int kChunk = 16;                 // channels staged per pass
constexpr int kDwBlocks = 1056;            // blocks of one dw launch, about
constexpr int kSumRows = 8;                // row groups of ordered_sum

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

// The cotangents of the conv's outputs.
struct Cot {
  const void* dy;   // IO dtype [B, H, W, cout]
  const void* y;    // null (no statistics), or the rounded forward output
  const float* ds;  // f32 [cout]
  const float* dq;
};

// g = (dy + ds) + (2 * dq) * y at element e of channel co, unrounded.
template <typename T>
__device__ __forceinline__ float cot_at(const Cot& c, long long e, int co) {
  float g = to_f(static_cast<const T*>(c.dy)[e]);
  if (c.y != nullptr) {
    const float yv = to_f(static_cast<const T*>(c.y)[e]);
    g = __fadd_rn(__fadd_rn(g, c.ds[co]),
                  __fmul_rn(__fmul_rn(2.f, c.dq[co]), yv));
  }
  return g;
}

// Sum over n < count of part[n * stride + e] in a fixed order, for blocks of
// (32, kSumRows) threads: row group y adds n = y, y + kSumRows, ... and the
// sub-sums are added in order of y. The total is returned to threadIdx.y == 0.
__device__ __forceinline__ float ordered_sum(const float* part,
                                             long long stride, int count,
                                             long long e, bool valid,
                                             float (*sm)[32]) {
  float s = 0.f;
  if (valid) {
    for (int n = threadIdx.y; n < count; n += kSumRows) {
      s += part[(long long)n * stride + e];
    }
  }
  sm[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.y == 0) {
#pragma unroll
    for (int r = 0; r < kSumRows; ++r) total += sm[r][threadIdx.x];
  }
  return total;
}

// ---------------------------------------------------------------------------
// dw, db
// ---------------------------------------------------------------------------

struct DwParams {
  const void* x[kMaxParts];
  const float* a[kMaxParts];  // null when the conv has no prelude
  const float* c[kMaxParts];
  int cin[kMaxParts];
  int nparts;
  const void* skip;  // null, or part 0's shape
  Cot cot;
  float* part_dw;    // [gridDim.x][K*K][cin_total][cout]
  float* part_db;    // [gridDim.x][cout]
  int B, H, W, cout, cin_total;
};

template <typename T, int K, int COS>
__global__ void __launch_bounds__(kThreads)
gub_conv_dw_kernel(const DwParams p) {
  constexpr int P = K / 2;
  constexpr int TWP = kTileW + K - 1;
  constexpr int NPIX = (kTileH + K - 1) * TWP;
  constexpr int CPT = COS / 8;  // output channels per thread
  __shared__ float xs[kChunk * NPIX];                   // [ci][pixel + halo]
  __shared__ __align__(16) float gs[kThreads * COS];    // [pixel][co]
  __shared__ float red[kThreads];

  // blockIdx.y counts 16-channel chunks over the concat of the parts
  int chunk = blockIdx.y;
  int j = 0;
  int off = 0;  // first row of part j in w
  while (chunk >= (p.cin[j] + kChunk - 1) / kChunk) {
    chunk -= (p.cin[j] + kChunk - 1) / kChunk;
    off += p.cin[j];
    ++j;
  }
  const int cin = p.cin[j];
  const int c0 = chunk * kChunk;
  const int cc = min(kChunk, cin - c0);
  const int co0 = blockIdx.z * COS;
  const T* x = static_cast<const T*>(p.x[j]);
  const float* A = p.a[j];
  const float* C = p.c[j];
  const T* skip = j == 0 ? static_cast<const T*>(p.skip) : nullptr;

  const int tid = threadIdx.x;
  const int ci = tid / 8;  // this thread's input channel of the chunk
  const int cg = tid % 8;  // and its group of CPT output channels

  float acc[K * K * CPT];
#pragma unroll
  for (int i = 0; i < K * K * CPT; ++i) acc[i] = 0.f;
  float dbv = 0.f;  // sum of g at channel co0 + tid % COS

  const int tiles_w = (p.W + kTileW - 1) / kTileW;
  const int tiles_img = ((p.H + kTileH - 1) / kTileH) * tiles_w;
  const int total = tiles_img * p.B;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int bi = t / tiles_img;
    const int r = t - bi * tiles_img;
    const int ty0 = (r / tiles_w) * kTileH;
    const int tx0 = (r % tiles_w) * kTileW;
    __syncthreads();  // the previous tile's readers are done
    // Activated input tile plus halo, exactly as the forward stages it.
    for (int idx = tid; idx < NPIX * cc; idx += kThreads) {
      const int pix = idx / cc;
      const int c = idx - pix * cc;
      const int iy = ty0 - P + pix / TWP;
      const int ix = tx0 - P + pix % TWP;
      float v = 0.f;
      if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
        const long long e =
            (((long long)bi * p.H + iy) * p.W + ix) * cin + c0 + c;
        v = to_f(x[e]);
        if (A != nullptr) {
          const int ch = bi * cin + c0 + c;
          v = fmaxf(__fadd_rn(__fmul_rn(v, A[ch]), C[ch]), 0.f);
          if (skip != nullptr) v = __fadd_rn(v, to_f(skip[e]));
          v = round_io<T>(v);
        }
      }
      xs[c * NPIX + pix] = v;
    }
    // g of the tile for the slab; kThreads % COS == 0, so a thread meets one
    // channel only and keeps that channel's unrounded sum for db.
    for (int idx = tid; idx < kThreads * COS; idx += kThreads) {
      const int pix = idx / COS;
      const int co = co0 + idx % COS;
      const int oy = ty0 + pix / kTileW;
      const int ox = tx0 + pix % kTileW;
      float g = 0.f;
      if (oy < p.H && ox < p.W && co < p.cout) {
        const long long e =
            (((long long)bi * p.H + oy) * p.W + ox) * p.cout + co;
        g = cot_at<T>(p.cot, e, co);
        dbv += g;
        g = round_io<T>(g);
      }
      gs[idx] = g;
    }
    __syncthreads();
    if (ci < cc) {
      for (int py = 0; py < kTileH; ++py) {
        for (int px = 0; px < kTileW; ++px) {
          float gv[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            gv[c] = gs[(py * kTileW + px) * COS + cg * CPT + c];
          }
#pragma unroll
          for (int u = 0; u < K; ++u) {
#pragma unroll
            for (int v = 0; v < K; ++v) {
              const float xv = xs[ci * NPIX + (py + u) * TWP + px + v];
#pragma unroll
              for (int c = 0; c < CPT; ++c) {
                acc[(u * K + v) * CPT + c] =
                    fmaf(xv, gv[c], acc[(u * K + v) * CPT + c]);
              }
            }
          }
        }
      }
    }
  }

  if (ci < cc) {
#pragma unroll
    for (int tap = 0; tap < K * K; ++tap) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int co = co0 + cg * CPT + c;
        if (co < p.cout) {
          p.part_dw[(((long long)blockIdx.x * K * K + tap) * p.cin_total +
                     off + c0 + ci) * p.cout + co] = acc[tap * CPT + c];
        }
      }
    }
  }
  if (blockIdx.y == 0) {
    red[tid] = dbv;
    __syncthreads();
    if (tid < COS && co0 + tid < p.cout) {
      float s = 0.f;
      for (int i = tid; i < kThreads; i += COS) s += red[i];
      p.part_db[(long long)blockIdx.x * p.cout + co0 + tid] = s;
    }
  }
}

// dw (through its strides) and db from the nb partials, in a fixed order.
__global__ void gub_conv_dw_finish(const float* part_dw, const float* part_db,
                                   int nb, int K, int cin, int cout, float* dw,
                                   long long s0, long long s1, long long s2,
                                   long long s3, float* db) {
  __shared__ float sm[kSumRows][32];
  const int E = K * K * cin * cout;
  const int e = blockIdx.x * 32 + threadIdx.x;
  const bool is_dw = e < E;
  const bool is_db = !is_dw && e < E + cout;
  const float total =
      ordered_sum(is_dw ? part_dw : part_db, is_dw ? E : cout, nb,
                  is_dw ? e : e - E, is_dw || is_db, sm);
  if (threadIdx.y != 0) return;
  if (is_dw) {
    const int tap = e / (cin * cout);
    const int ci = (e / cout) % cin;
    const int co = e % cout;
    dw[(tap / K) * s0 + (tap % K) * s1 + ci * s2 + co * s3] = total;
  } else if (is_db) {
    db[e - E] = total;
  }
}

int dw_slab(int cout) { return cout <= 8 ? 8 : (cout <= 16 ? 16 : 32); }

int dw_chunks(int nparts, const int* cin) {
  int n = 0;
  for (int j = 0; j < nparts; ++j) n += (cin[j] + kChunk - 1) / kChunk;
  return n;
}

int tiles_per_image(int H, int W) {
  return ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
}

int dw_blocks(int nparts, const int* cin, int cout, int B, int H, int W) {
  const int slab = dw_slab(cout);
  const int slots = dw_chunks(nparts, cin) * ((cout + slab - 1) / slab);
  const long long total = (long long)tiles_per_image(H, W) * B;
  long long nb = kDwBlocks / slots;
  if (nb < 1) nb = 1;
  if (nb > total) nb = total;
  return static_cast<int>(nb);
}

template <typename T, int K, int COS>
cudaError_t launch_dw(const DwParams& p, int nb, cudaStream_t stream) {
  const dim3 grid(nb, dw_chunks(p.nparts, p.cin), (p.cout + COS - 1) / COS);
  gub_conv_dw_kernel<T, K, COS><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_dw_slab(const DwParams& p, int nb, cudaStream_t stream) {
  switch (dw_slab(p.cout)) {
    case 8: return launch_dw<T, K, 8>(p, nb, stream);
    case 16: return launch_dw<T, K, 16>(p, nb, stream);
    default: return launch_dw<T, K, 32>(p, nb, stream);
  }
}

// ---------------------------------------------------------------------------
// dx, dskip, dA, dC of one part
// ---------------------------------------------------------------------------

struct DxParams {
  Cot cot;
  const void* x;      // the part's raw input; read only with a prelude
  const float* a;     // null when the conv has no prelude
  const float* c;
  const float* w;     // f32 [k, k, cin_total, cout] through w_stride
  long long w_stride[4];
  int off;            // first row of the part in w
  void* dx;           // IO dtype [B, H, W, cin]
  void* dskip;        // null, or IO dtype [B, H, W, cin]
  float* part_da;     // [B][tiles][cin], with a prelude
  float* part_dc;
  int B, H, W, cin, cout;
};

template <typename T, int K, int CIS>
__global__ void __launch_bounds__(kThreads)
gub_conv_dx_kernel(const DxParams p) {
  constexpr int P = K / 2;
  constexpr int TWP = kTileW + K - 1;
  constexpr int NPIX = (kTileH + K - 1) * TWP;
  __shared__ float gs[kChunk * NPIX];                        // [co][pixel]
  __shared__ __align__(16) float ws[K * K * kChunk * CIS];   // [tap][co][ci]
  __shared__ float red_a[kThreads / 32][CIS];
  __shared__ float red_c[kThreads / 32][CIS];

  const int tiles_w = (p.W + kTileW - 1) / kTileW;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const int ci0 = blockIdx.y * CIS;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / kTileW;
  const int tx = tid % kTileW;

  float acc[CIS];
#pragma unroll
  for (int i = 0; i < CIS; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < p.cout; c0 += kChunk) {
    const int cc = min(kChunk, p.cout - c0);
    __syncthreads();  // the previous chunk's readers are done
    // r(g) of the tile plus halo; zero outside the image.
    for (int idx = tid; idx < NPIX * cc; idx += kThreads) {
      const int pix = idx / cc;
      const int c = idx - pix * cc;
      const int iy = ty0 - P + pix / TWP;
      const int ix = tx0 - P + pix % TWP;
      float g = 0.f;
      if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
        const long long e =
            (((long long)bi * p.H + iy) * p.W + ix) * p.cout + c0 + c;
        g = round_io<T>(cot_at<T>(p.cot, e, c0 + c));
      }
      gs[c * NPIX + pix] = g;
    }
    // Flipped weights of this chunk for the slab, rounded to the IO dtype:
    // tap (u, v) of the backward conv reads w[K-1-u, K-1-v, ci, co].
    for (int idx = tid; idx < K * K * kChunk * CIS; idx += kThreads) {
      const int ci = idx % CIS;
      const int co = (idx / CIS) % kChunk;
      const int tap = idx / (CIS * kChunk);
      float v = 0.f;
      if (co < cc && ci0 + ci < p.cin) {
        const long long e = (K - 1 - tap / K) * p.w_stride[0] +
                            (K - 1 - tap % K) * p.w_stride[1] +
                            (long long)(p.off + ci0 + ci) * p.w_stride[2] +
                            (long long)(c0 + co) * p.w_stride[3];
        v = round_io<T>(p.w[e]);
      }
      ws[idx] = v;
    }
    __syncthreads();
    for (int co = 0; co < cc; ++co) {
#pragma unroll
      for (int u = 0; u < K; ++u) {
#pragma unroll
        for (int v = 0; v < K; ++v) {
          const float gv = gs[co * NPIX + (ty + u) * TWP + tx + v];
          const float4* wp = reinterpret_cast<const float4*>(
              &ws[((u * K + v) * kChunk + co) * CIS]);
#pragma unroll
          for (int k4 = 0; k4 < CIS / 4; ++k4) {
            const float4 w4 = wp[k4];
            acc[4 * k4 + 0] = fmaf(gv, w4.x, acc[4 * k4 + 0]);
            acc[4 * k4 + 1] = fmaf(gv, w4.y, acc[4 * k4 + 1]);
            acc[4 * k4 + 2] = fmaf(gv, w4.z, acc[4 * k4 + 2]);
            acc[4 * k4 + 3] = fmaf(gv, w4.w, acc[4 * k4 + 3]);
          }
        }
      }
    }
  }

  // Epilogue: dskip before the gate; gate with the forward's p; dx; the
  // tile's sums of dp * x (in acc) and dp (in dcv).
  const int oy = ty0 + ty;
  const int ox = tx0 + tx;
  const bool valid = oy < p.H && ox < p.W;
  const long long e0 = (((long long)bi * p.H + oy) * p.W + ox) * p.cin;
  const T* x = static_cast<const T*>(p.x);
  T* dx = static_cast<T*>(p.dx);
  T* dskip = static_cast<T*>(p.dskip);
  float dcv[CIS];
#pragma unroll
  for (int i = 0; i < CIS; ++i) {
    const int ci = ci0 + i;
    float da = 0.f;
    float dc = 0.f;
    if (valid && ci < p.cin) {
      const float dxa = acc[i];
      if (dskip != nullptr) store_io(dskip + e0 + ci, dxa);
      if (p.a != nullptr) {
        const float xv = to_f(x[e0 + ci]);
        const float av = p.a[bi * p.cin + ci];
        const float pv = __fadd_rn(__fmul_rn(xv, av), p.c[bi * p.cin + ci]);
        const float dp = pv > 0.f ? dxa : 0.f;
        store_io(dx + e0 + ci, __fmul_rn(dp, av));
        da = __fmul_rn(dp, xv);
        dc = dp;
      } else {
        store_io(dx + e0 + ci, dxa);
      }
    }
    acc[i] = da;
    dcv[i] = dc;
  }

  if (p.a != nullptr) {
    const int lane = tid & 31;
    const int warp = tid >> 5;
#pragma unroll
    for (int i = 0; i < CIS; ++i) {
      float av = acc[i];
      float cv = dcv[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        av += __shfl_down_sync(0xffffffffu, av, o);
        cv += __shfl_down_sync(0xffffffffu, cv, o);
      }
      if (lane == 0) {
        red_a[warp][i] = av;
        red_c[warp][i] = cv;
      }
    }
    __syncthreads();
    if (tid < CIS && ci0 + tid < p.cin) {
      float av = 0.f;
      float cv = 0.f;
#pragma unroll
      for (int wi = 0; wi < kThreads / 32; ++wi) {
        av += red_a[wi][tid];
        cv += red_c[wi][tid];
      }
      const long long o =
          ((long long)bi * gridDim.x + blockIdx.x) * p.cin + ci0 + tid;
      p.part_da[o] = av;
      p.part_dc[o] = cv;
    }
  }
}

// dA, dC [B, cin] from the per-tile partials [B][tiles][cin], in tile order.
__global__ void gub_conv_dx_finish(const float* part_da, const float* part_dc,
                                   int tiles, int B, int cin, float* da,
                                   float* dc) {
  __shared__ float sm[kSumRows][32];
  const int n = B * cin;
  const int e = blockIdx.x * 32 + threadIdx.x;  // over dA then dC
  const bool valid = e < 2 * n;
  const int o = valid ? e % n : 0;
  const long long base = (long long)(o / cin) * tiles * cin + o % cin;
  const float total =
      ordered_sum(e < n ? part_da : part_dc, cin, tiles, base, valid, sm);
  if (threadIdx.y == 0 && valid) (e < n ? da : dc)[o] = total;
}

template <typename T, int K, int CIS>
cudaError_t launch_dx(const DxParams& p, cudaStream_t stream) {
  const dim3 grid(tiles_per_image(p.H, p.W), (p.cin + CIS - 1) / CIS, p.B);
  gub_conv_dx_kernel<T, K, CIS><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_dx_slab(const DxParams& p, cudaStream_t stream) {
  if (p.cin <= 8) return launch_dx<T, K, 8>(p, stream);
  if (p.cin <= 16) return launch_dx<T, K, 16>(p, stream);
  return launch_dx<T, K, 32>(p, stream);
}

bool bad_shape(int B, int H, int W, int cin, int cout, int k) {
  return (k != 1 && k != 3) || B < 1 || B > 65535 || H < 1 || W < 1 ||
         cin < 1 || cout < 1;
}

}  // namespace

// Plain C entries, loaded with ctypes. Each returns the cudaError_t of its
// launches (0 on success). Scratch is allocated by the caller.

// Tiles of one image: the middle extent of gub_conv_dx's scratch.
extern "C" int gub_conv_bwd_tiles(int H, int W) { return tiles_per_image(H, W); }

// Partial sums that one gub_conv_dw launch writes: the leading extent of its
// scratch part_dw [nb, k*k*cin_total*cout] and part_db [nb, cout].
extern "C" int gub_conv_dw_blocks(int nparts, const int* cin, int cout, int B,
                                  int H, int W) {
  return dw_blocks(nparts, cin, cout, B, H, W);
}

// Arrays hold one entry per part; a[j] and c[j] are null when the conv has no
// prelude; skip may be null; y, ds, dq are null when the forward emitted no
// statistics. dw is written through dw_stride (elements, for u, v, ci, co).
extern "C" int gub_conv_dw(int nparts, void* const* x, void* const* a,
                           void* const* c, const int* cin, const void* skip,
                           const void* dy, const void* y, const void* ds,
                           const void* dq, void* part_dw, void* part_db,
                           void* dw, const long long* dw_stride, void* db,
                           int B, int H, int W, int cout, int k, int is_bf16,
                           void* stream) {
  if (nparts < 1 || nparts > kMaxParts || bad_shape(B, H, W, 1, cout, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DwParams p = {};
  for (int j = 0; j < nparts; ++j) {
    p.x[j] = x[j];
    p.a[j] = static_cast<const float*>(a[j]);
    p.c[j] = static_cast<const float*>(c[j]);
    p.cin[j] = cin[j];
    p.cin_total += cin[j];
  }
  p.nparts = nparts;
  p.skip = skip;
  p.cot = {dy, y, static_cast<const float*>(ds), static_cast<const float*>(dq)};
  p.part_dw = static_cast<float*>(part_dw);
  p.part_db = static_cast<float*>(part_db);
  p.B = B;
  p.H = H;
  p.W = W;
  p.cout = cout;
  const int nb = dw_blocks(nparts, cin, cout, B, H, W);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = k == 1 ? launch_dw_slab<__nv_bfloat16, 1>(p, nb, st)
                 : launch_dw_slab<__nv_bfloat16, 3>(p, nb, st);
  } else {
    err = k == 1 ? launch_dw_slab<float, 1>(p, nb, st)
                 : launch_dw_slab<float, 3>(p, nb, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outs = k * k * p.cin_total * cout + cout;
  gub_conv_dw_finish<<<(outs + 31) / 32, dim3(32, kSumRows), 0, st>>>(
      p.part_dw, p.part_db, nb, k, p.cin_total, cout, static_cast<float*>(dw),
      dw_stride[0], dw_stride[1], dw_stride[2], dw_stride[3],
      static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}

// One part: x, a, c, part_da, part_dc, da, dc are null when the conv has no
// prelude; dskip is null unless this is part 0 of a conv with a skip.
extern "C" int gub_conv_dx(const void* dy, const void* y, const void* ds,
                           const void* dq, const void* x, const void* a,
                           const void* c, const void* w,
                           const long long* w_stride, int off, void* dx,
                           void* dskip, void* part_da, void* part_dc, void* da,
                           void* dc, int B, int H, int W, int cin, int cout,
                           int k, int is_bf16, void* stream) {
  if (bad_shape(B, H, W, cin, cout, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DxParams p = {};
  p.cot = {dy, y, static_cast<const float*>(ds), static_cast<const float*>(dq)};
  p.x = x;
  p.a = static_cast<const float*>(a);
  p.c = static_cast<const float*>(c);
  p.w = static_cast<const float*>(w);
  for (int i = 0; i < 4; ++i) p.w_stride[i] = w_stride[i];
  p.off = off;
  p.dx = dx;
  p.dskip = dskip;
  p.part_da = static_cast<float*>(part_da);
  p.part_dc = static_cast<float*>(part_dc);
  p.B = B;
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.cout = cout;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = k == 1 ? launch_dx_slab<__nv_bfloat16, 1>(p, st)
                 : launch_dx_slab<__nv_bfloat16, 3>(p, st);
  } else {
    err = k == 1 ? launch_dx_slab<float, 1>(p, st)
                 : launch_dx_slab<float, 3>(p, st);
  }
  if (err != cudaSuccess || a == nullptr) return static_cast<int>(err);
  gub_conv_dx_finish<<<(2 * B * cin + 31) / 32, dim3(32, kSumRows), 0, st>>>(
      p.part_da, p.part_dc, tiles_per_image(H, W), B, cin,
      static_cast<float*>(da), static_cast<float*>(dc));
  return static_cast<int>(cudaGetLastError());
}
