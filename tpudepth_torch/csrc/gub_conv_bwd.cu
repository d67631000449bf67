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
// What bounds them: 2*9*Cin*Cout FLOPs per pixel against (Cin + 2*Cout) * 2
// bytes in bf16 at Cin, Cout <= 64 is below the card's ridge on the tensor
// cores (989 TFLOP/s), so the bound is bytes; on the CUDA cores in f32 (67
// TFLOP/s) the same work is bound by operations at Cin, Cout >= 32. Neither
// kernel writes an activated tensor or g to device memory: both are
// recomputed on load and live in shared memory.
//
// Cross-block sums. The TPU kernels walk the batch in grid order and carry
// dw, db, dA and dC in VMEM from step to step; blocks here run in no order,
// so every cross-block sum is two passes: blocks write partial sums, a
// second small kernel adds them in a fixed order. There is no atomicAdd in
// this file: the same inputs at the same shapes give the same bits on every
// run.
//
// bf16, k = 3 (every GUB conv of GuideDepth's train step): implicit GEMMs on
// the tensor cores, mma.sync.m16n8k16 bf16 -> f32 fed by ldmatrix. A tap of
// the 3x3 conv is a shifted window of a tile staged once in shared memory,
// so each lane of an ldmatrix gives its own row address; the halo breaks the
// uniform core-matrix stride a wgmma shared-memory descriptor of A needs, and
// at these widths the products are a fifth of the time or less (the bound
// is bytes). Blocks are persistent and walk 8x16-pixel tiles t =
// blockIdx.x, + gridDim.x, ...; each tile's raw dy, y (and x, skip, A, C)
// are copied by cp.async into the other of two stage buffers while the
// current tile is transformed and multiplied (rows whose width or offset
// is no multiple of 8 elements, such as the RGB guide's 3 channels, by
// plain loads), then transformed once, 8 channels a thread and step, into
// bf16 [pixel][channel] tiles whose row stride is an odd number of 16-byte
// units (no ldmatrix bank conflicts; K and N padded with zeros). The
// transform masks
// by image coordinates: a halo pixel of g is 0 (not ds) and of xa 0 (not
// relu(C)). The transform, not the products, is what costs most.
// * gub_conv_dx_tc: M = the tile's 128 pixels, N = the part's input
//   channels (one block takes up to 64, so g is read and recomputed once),
//   K = 9 taps x Cout. The part's weights are flipped, transposed to
//   [tap][ci][co], rounded and staged once per block (up to 72 KB of
//   dynamic shared memory; Cout above 64 is walked in chunks of 64 that
//   restage them, each chunk's sums from 0 and the chunks' sums added in
//   f32, so no chain is longer than a 64-channel conv's 36 k16 steps).
//   Four warps split the tile rows, two groups of four split N at 32-64
//   channels. The epilogue is the CUDA-core kernel's.
// * gub_conv_dw_tc: M = (tap, ci), N = Cout, K = pixels, split over the
//   blocks. Warp w of nine owns tap w for a chunk of up to 64 (ci, co)
//   pairs and keeps its sums in registers over all the block's tiles;
//   ldmatrix.trans reads both pixel-major tiles as K-major operands. The
//   tensor cores do not round their f32 sums to nearest, so a long chain
//   drifts (about 40 ulps of dw over 144 steps, where the check against
//   the plain version allows 16): each chain is four k16 steps from 0,
//   added to the sums in f32 (gub_conv_dw_tc_rgb: one). The RGB guide (Cin <= 3) packs its 27
//   (tap, ci) rows into M = 32 in gub_conv_dw_tc_rgb, whose eight warps
//   take one tile row each and add their sums in warp order at the end. One
//   partial per block; the count of partials is a function of the shape.
//
// The tiles, the staging, ldmatrix and mma.sync and the launch preparation
// are gub_conv_tc.cuh's, shared with gub_conv_fwd.cu's forward.
//
// f32, and k = 1: the CUDA-core kernels below, f32 FMAs. The f32 checks
// hold them at 1e-4 against the plain version, which TF32 products would
// not meet, and k = 1 runs on no path of the GuideDepth step.
// * gub_conv_dw_kernel: a block owns 16 input channels, a slab of <= 32
//   output channels and every tap: thread (ci, cg) keeps 9 * slab/8 sums in
//   registers. It walks 8x16 pixel tiles t = blockIdx.x, blockIdx.x +
//   gridDim.x, ...; per tile it stages xa (with halo) and r(g) in shared
//   memory. gridDim.x is chosen so that about kDwBlocks blocks run; each
//   writes one partial dw. db comes from the blocks of the first channel
//   chunk, summed while g is staged. Each tile's sums start from 0 and are
//   added to the block's in f32: a wide conv has few blocks a channel
//   slab (8 at 256 x 256 channels), and one chain over all their tiles
//   (19,200 terms at B 8 on a 120x160 grid) drifted beyond the check.
// * gub_conv_dx_kernel: the forward's layout with the roles swapped: one
//   block per (image, 8x16 tile, slab of <= 32 INPUT channels), one pixel
//   per thread, g staged 16 output channels at a time with its halo, the
//   weights staged flipped.
// Both gub_conv_dx kernels gate, store dx (and dskip) and reduce dp*x and dp
// over the tile (warp shuffles, then the warps in order); a second kernel
// adds the tiles of an image in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gub_conv_tc.cuh"

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

  float acc[K * K * CPT];   // the block's sums: the tiles' sums added
  float tacc[K * K * CPT];  // the tile's sums
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
    float tdb = 0.f;
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
        tdb += g;
        g = round_io<T>(g);
      }
      gs[idx] = g;
    }
    dbv = __fadd_rn(dbv, tdb);
    __syncthreads();
    if (ci < cc) {
#pragma unroll
      for (int i = 0; i < K * K * CPT; ++i) tacc[i] = 0.f;
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
                tacc[(u * K + v) * CPT + c] =
                    fmaf(xv, gv[c], tacc[(u * K + v) * CPT + c]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < K * K * CPT; ++i) acc[i] = __fadd_rn(acc[i], tacc[i]);
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

__host__ __device__ inline int tiles_per_image(int H, int W) {
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

// ---------------------------------------------------------------------------
// bf16, k = 3: implicit GEMMs on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kDwThreads = 9 * 32;      // one warp a tap
constexpr int kRgbThreads = kTileH * 32;  // one warp a tile row

// --- dx ---------------------------------------------------------------------

// Elements of one stage buffer of gub_conv_dx_tc: raw dy [and y] of the tile
// and halo [kHalo][kp], [raw x of the tile [kPix][nch]].
__host__ __device__ inline int dx_stage(int kp, int nch, bool has_y,
                                        bool has_x) {
  return (has_y ? 2 : 1) * kHalo * kp + (has_x ? kPix * nch : 0);
}

// Dynamic shared memory of gub_conv_dx_tc: weights [9][nch][kp + 8], g
// [kHalo][kp + 8], two stages, and the warp rows' sums of dp*x and dp.
__host__ __device__ inline int dx_smem(int kp, int nch, bool has_y,
                                       bool has_x) {
  return 2 * ((9 * nch + kHalo) * (kp + 8) +
              2 * dx_stage(kp, nch, has_y, has_x)) +
         4 * 2 * 4 * nch;
}

// KS k16 steps a tap (a K chunk of KP = 16 KS output channels), NT n8 tiles
// a warp, WN groups of four warps along N (N = 8 NT WN input channels).
template <int KS, int NT, int WN>
__global__ void __launch_bounds__(128 * WN, 1)
gub_conv_dx_tc(const DxParams p) {
  constexpr int kThr = 128 * WN;
  constexpr int KP = 16 * KS;
  constexpr int GS = KP + 8;  // an odd number of 16-byte units
  constexpr int NCH = 8 * NT * WN;
  constexpr int KG = KP / 8;
  static_assert(kThr % KG == 0, "a thread keeps one group of g");
  extern __shared__ __align__(16) unsigned char smem[];
  const bool has_y = p.cot.y != nullptr;
  const bool has_x = p.a != nullptr;
  bf16* ws = reinterpret_cast<bf16*>(smem);  // [9][NCH][GS], flipped
  bf16* gs = ws + 9 * NCH * GS;              // [kHalo][GS]
  bf16* raw = gs + kHalo * GS;               // two stages
  const int stage = dx_stage(KP, NCH, has_y, has_x);
  float* red_a = reinterpret_cast<float*>(raw + 2 * stage);  // [4][NCH]
  float* red_c = red_a + 4 * NCH;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) & 3;  // tile rows 2 wm, 2 wm + 1
  const int wn = tid >> 7;        // n8 tiles wn NT .. wn NT + NT - 1
  const int ci0 = blockIdx.y * NCH;
  const int nci = min(NCH, p.cin - ci0);
  const int nkc = (p.cout + KP - 1) / KP;
  const int tiles_img = tiles_per_image(p.H, p.W);
  const int steps = my_tiles(p.B * tiles_img) * nkc;  // (tile, K chunk)
  const bf16* dy = static_cast<const bf16*>(p.cot.dy);
  const bf16* yv = static_cast<const bf16*>(p.cot.y);
  const bf16* x = static_cast<const bf16*>(p.x);

  // Flipped weights of K chunk kc, rounded: tap (u, v) reads
  // w[2-u, 2-v, off + ci, co], stored [tap][ci][co]; eight loads in flight
  // a thread.
  auto stage_weights = [&](int kc) {
    constexpr int kAll = 9 * NCH * KP;
    for (int i0 = tid; i0 < kAll; i0 += 8 * kThr) {
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = i0 + q * kThr;
        const int k = i % KP;
        const int n = (i / KP) % NCH;
        const int tap = i / (KP * NCH);
        const int co = kc * KP + k;
        v[q] = 0.f;
        if (i < kAll && n < nci && co < p.cout) {
          v[q] = p.w[(2 - tap / 3) * p.w_stride[0] +
                     (2 - tap % 3) * p.w_stride[1] +
                     (long long)(p.off + ci0 + n) * p.w_stride[2] +
                     (long long)co * p.w_stride[3]];
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = i0 + q * kThr;
        if (i < kAll) {
          ws[((i / (KP * NCH)) * NCH + (i / KP) % NCH) * GS + i % KP] =
              __float2bfloat16(v[q]);
        }
      }
    }
  };
  auto tile_at = [&](int s) {
    return tile_of(blockIdx.x + (s / nkc) * gridDim.x, p.H, p.W);
  };
  auto issue = [&](int s) {
    const Tile t = tile_at(s);
    const int kc = s % nkc;
    const int cc = min(KP, p.cout - kc * KP);
    bf16* st = raw + (s & 1) * stage;
    stage_rows<kHaloH, kHaloW, kThr>(st, KP, 0, dy, p.cout, kc * KP, cc, t.bi,
                                     t.y0 - 1, t.x0 - 1, p.H, p.W);
    if (has_y) {
      stage_rows<kHaloH, kHaloW, kThr>(st + kHalo * KP, KP, 0, yv, p.cout,
                                       kc * KP, cc, t.bi, t.y0 - 1, t.x0 - 1,
                                       p.H, p.W);
    }
    if (has_x && kc == nkc - 1) {
      stage_rows<kTileH, kTileW, kThr>(st + (has_y ? 2 : 1) * kHalo * KP, NCH,
                                       0, x, p.cin, ci0, nci, t.bi, t.y0,
                                       t.x0, p.H, p.W);
    }
  };

  // ds and 2 dq of the thread's eight channels cg.. of K chunk kc
  const int cg = 8 * (tid % KG);
  float ds8[8], dq8[8];
  auto load_dsq = [&](int kc) {
    const int left = min(KP, p.cout - kc * KP) - cg;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool ok = has_y && e < left;
      ds8[e] = ok ? p.cot.ds[kc * KP + cg + e] : 0.f;
      dq8[e] = ok ? __fmul_rn(2.f, p.cot.dq[kc * KP + cg + e]) : 0.f;
    }
  };
  if (nkc == 1) {
    stage_weights(0);
    load_dsq(0);
  }
  if (steps > 0) issue(0);
  cp_async_commit();
  // acc: one K chunk's sums, 9 taps x KS k16 steps from 0 (the chain of a
  // conv with up to 64 output channels); tot: the chunks' sums added in f32,
  // rounded to nearest, so a wide conv's chain stays that short (144 steps
  // in one chain at 256 output channels drifted beyond the check).
  float acc[2][NT][4];
  float tot[2][NT][4];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // this step's stage landed; the last step is done
    if (s + 1 < steps) issue(s + 1);
    cp_async_commit();
    const Tile t = tile_at(s);
    const int kc = s % nkc;
    const int cc = min(KP, p.cout - kc * KP);
    const bf16* st = raw + (s & 1) * stage;

    // r(g) of the tile and halo in g's order (cot_at): 0 outside the image
    // and beyond cc; eight channels a thread and step.
    if (nkc > 1) load_dsq(kc);
    for (int pix = tid / KG; pix < kHalo; pix += kThr / KG) {
      const int iy = t.y0 - 1 + pix / kHaloW;
      const int ix = t.x0 - 1 + pix % kHaloW;
      float g[8] = {};
      if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
        float yv[8] = {};
        load_vec<8>(st + pix * KP + cg, g);
        if (has_y) load_vec<8>(st + kHalo * KP + pix * KP + cg, yv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (has_y) {
            g[e] = __fadd_rn(__fadd_rn(g[e], ds8[e]), __fmul_rn(dq8[e], yv[e]));
          }
          if (cg + e >= cc) g[e] = 0.f;
        }
      }
      store_vec<8>(gs + pix * GS + cg, g);
    }
    if (nkc > 1) stage_weights(kc);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    __syncthreads();

    // dxa[pix, ci] += sum over taps and co of g[pix + tap, co] w~[tap, ci, co]
#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {
      const int u = tap / 3;
      const int v = tap % 3;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int hp = (2 * wm + m + u) * kHaloW + (lane & 15) + v;
          ldsm_x4(a[m], gs + hp * GS + ks * 16 + (lane >> 4) * 8);
        }
        uint32_t b[NT][2];
        const int k = ks * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int j = 0; j + 1 < NT; j += 2) {
          uint32_t r[4];
          const int n = (wn * NT + j + (lane >> 4)) * 8 + (lane & 7);
          ldsm_x4(r, ws + (tap * NCH + n) * GS + k);
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[j + 1][0] = r[2];
          b[j + 1][1] = r[3];
        }
        if (NT & 1) {
          uint32_t r[2];
          const int n = (wn * NT + NT - 1) * 8 + (lane & 7);
          ldsm_x2(r, ws + (tap * NCH + n) * GS + k);
          b[NT - 1][0] = r[0];
          b[NT - 1][1] = r[1];
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma(acc[m][j], a[m], b[j][0], b[j][1]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[m][j][e] =
              kc == 0 ? acc[m][j][e] : __fadd_rn(tot[m][j][e], acc[m][j][e]);
        }
    if (kc != nkc - 1) continue;

    // Epilogue, gub_conv_dx_kernel's arithmetic: dskip before the gate; the
    // gate with the forward's p; dx; the tile's sums of dp * x and dp.
    const bf16* xs = st + (has_y ? 2 : 1) * kHalo * KP;
    bf16* dx = static_cast<bf16*>(p.dx);
    bf16* dskip = static_cast<bf16*>(p.dskip);
    const bool pairs = (p.cin & 1) == 0;
    float sa[NT][2], sc[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sa[j][0] = sa[j][1] = sc[j][0] = sc[j][1] = 0.f;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int r = 2 * wm + m;
      const int oy = t.y0 + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = (lane >> 2) + 8 * h;
        const int ox = t.x0 + px;
        if (oy >= p.H || ox >= p.W) continue;
        const long long e0 = (((long long)t.bi * p.H + oy) * p.W + ox) * p.cin;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = (wn * NT + j) * 8 + (lane & 3) * 2;
          const int ci = ci0 + n;
          if (n >= nci) continue;
          const bool two = n + 1 < nci;
          float v0 = tot[m][j][2 * h];
          float v1 = tot[m][j][2 * h + 1];
          if (dskip != nullptr) {
            if (two && pairs) {
              *reinterpret_cast<__nv_bfloat162*>(dskip + e0 + ci) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              dskip[e0 + ci] = __float2bfloat16(v0);
              if (two) dskip[e0 + ci + 1] = __float2bfloat16(v1);
            }
          }
          if (has_x) {
            const int ch = t.bi * p.cin + ci;
            const bf16* xp = xs + (r * kTileW + px) * NCH + n;
            const float x0 = to_f(xp[0]);
            const float a0 = p.a[ch];
            const float dp0 =
                __fadd_rn(__fmul_rn(x0, a0), p.c[ch]) > 0.f ? v0 : 0.f;
            v0 = __fmul_rn(dp0, a0);
            sa[j][0] += __fmul_rn(dp0, x0);
            sc[j][0] += dp0;
            if (two) {
              const float x1 = to_f(xp[1]);
              const float a1 = p.a[ch + 1];
              const float dp1 =
                  __fadd_rn(__fmul_rn(x1, a1), p.c[ch + 1]) > 0.f ? v1 : 0.f;
              v1 = __fmul_rn(dp1, a1);
              sa[j][1] += __fmul_rn(dp1, x1);
              sc[j][1] += dp1;
            }
          }
          if (two && pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dx + e0 + ci) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            dx[e0 + ci] = __float2bfloat16(v0);
            if (two) dx[e0 + ci + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
    if (!has_x) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float av = sa[j][q];
        float cv = sc[j][q];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          av += __shfl_xor_sync(0xffffffffu, av, o);
          cv += __shfl_xor_sync(0xffffffffu, cv, o);
        }
        if (lane < 4) {
          const int n = (wn * NT + j) * 8 + lane * 2 + q;
          red_a[wm * NCH + n] = av;
          red_c[wm * NCH + n] = cv;
        }
      }
    }
    __syncthreads();
    for (int n = tid; n < nci; n += kThr) {
      float av = 0.f;
      float cv = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        av += red_a[w * NCH + n];
        cv += red_c[w * NCH + n];
      }
      const long long o =
          ((long long)t.bi * tiles_img + t.index) * p.cin + ci0 + n;
      p.part_da[o] = av;
      p.part_dc[o] = cv;
    }
  }
}

template <int KS, int NT, int WN>
cudaError_t launch_dx(const DxParams& p, cudaStream_t stream) {
  static int set = 0;
  constexpr int kThr = 128 * WN;
  constexpr int NCH = 8 * NT * WN;
  auto kern = gub_conv_dx_tc<KS, NT, WN>;
  const int smem = dx_smem(16 * KS, NCH, p.cot.y != nullptr, p.a != nullptr);
  int per_sm = 0;
  const cudaError_t err = prepare(kern, &set, smem, kThr, &per_sm);
  if (err != cudaSuccess) return err;
  const int chunks = (p.cin + NCH - 1) / NCH;
  const long long total = (long long)tiles_per_image(p.H, p.W) * p.B;
  long long nb = (long long)per_sm * sm_count() / chunks;
  nb = nb < 1 ? 1 : (nb > total ? total : nb);
  kern<<<dim3(static_cast<unsigned>(nb), chunks), kThr, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_dx_n(const DxParams& p, cudaStream_t stream) {
  if (p.cin <= 8) return launch_dx<KS, 1, 1>(p, stream);
  if (p.cin <= 16) return launch_dx<KS, 2, 1>(p, stream);
  if (p.cin <= 32 ||
      dx_smem(16 * KS, 64, p.cot.y != nullptr, p.a != nullptr) > kSmemMax) {
    return launch_dx<KS, 2, 2>(p, stream);
  }
  return launch_dx<KS, 4, 2>(p, stream);
}

cudaError_t launch_dx(const DxParams& p, cudaStream_t stream) {
  if (p.cout <= 16) return launch_dx_n<1>(p, stream);
  if (p.cout <= 32) return launch_dx_n<2>(p, stream);
  return launch_dx_n<4>(p, stream);
}

// --- dw ---------------------------------------------------------------------

// The chunking of gub_conv_dw_tc: MT m16 tiles of input channels a tap, NT
// n8 tiles of output channels; MT 0 is gub_conv_dw_tc_rgb.
struct DwCfg {
  int mt, nt;
};

DwCfg dw_cfg(int cin, int cout) {
  DwCfg c;
  c.nt = cout <= 16 ? 2 : (cout <= 32 ? 4 : 8);
  const int need = (cin + 15) / 16;
  c.mt = cin <= 3 ? 0 : (need <= 1 ? 1 : ((need <= 2 || c.nt == 8) ? 2 : 4));
  return c;
}

int dw_grid_y(int cin, DwCfg c) {
  return c.mt == 0 ? 1 : (cin + 16 * c.mt - 1) / (16 * c.mt);
}

int dw_grid_z(int cout, DwCfg c) { return (cout + 8 * c.nt - 1) / (8 * c.nt); }

// Partials of one launch: about one block an SM over the chunks at 16 tiles
// of m16 x n8 a warp, two below that; a function of the shape alone.
int dw_blocks(int cin, int cout, int B, int H, int W) {
  const DwCfg c = dw_cfg(cin, cout);
  const int per_sm = c.mt * c.nt >= 16 ? 1 : 2;
  long long nb = (long long)kSms * per_sm /
                 (dw_grid_y(cin, c) * dw_grid_z(cout, c));
  const long long total = (long long)tiles_per_image(H, W) * B;
  nb = nb < 1 ? 1 : (nb > total ? total : nb);
  return static_cast<int>(nb);
}

// Elements of one stage buffer: raw x [and skip] of the tile and halo
// [kHalo][xc], raw dy [and y] of the tile [kPix][nc], [A and C of the
// chunk's columns for the tile's image, f32 [2][xc]].
__host__ __device__ inline int dw_stage(int xc, int nc, bool has_skip,
                                        bool has_y, bool has_pre) {
  return (has_skip ? 2 : 1) * kHalo * xc + (has_y ? 2 : 1) * kPix * nc +
         (has_pre ? 4 * xc : 0);
}

// xa [kHalo][xs], r(g) [kPix][nc + 8], two stages, then f32: the threads'
// db sums [8][threads], ds and 2 dq of the slab [2][nc] and, for the RGB
// kernel, one set of a warp's sums.
__host__ __device__ inline int dw_smem(int xc, int xs, int nc, bool has_skip,
                                       bool has_y, bool has_pre, int threads,
                                       bool rgb) {
  return 2 * (kHalo * xs + kPix * (nc + 8) +
              2 * dw_stage(xc, nc, has_skip, has_y, has_pre)) +
         4 * (8 * threads + 2 * nc + (rgb ? 2 * (nc / 8) * 4 * 32 : 0));
}

// The stage of one tile: the parts' channels of the chunk and part 0's skip
// with the halo, dy and y of the slab, and the chunk's A and C for the
// tile's image, all by cp.async where the layout allows.
template <int NTHR>
__device__ __forceinline__ void dw_issue(const DwParams& p, bf16* st, int xc,
                                         int nc, int c0, int cc, int co0,
                                         int ncv, Tile t) {
  const bool has_skip = p.skip != nullptr;
  const bool has_y = p.cot.y != nullptr;
  int off = 0;
  for (int j = 0; j < p.nparts; ++j) {
    const int lo = max(c0, off);
    const int hi = min(c0 + cc, off + p.cin[j]);
    if (lo < hi) {
      stage_rows<kHaloH, kHaloW, NTHR>(st, xc, lo - c0,
                                       static_cast<const bf16*>(p.x[j]),
                                       p.cin[j], lo - off, hi - lo, t.bi,
                                       t.y0 - 1, t.x0 - 1, p.H, p.W);
      if (j == 0 && has_skip) {
        stage_rows<kHaloH, kHaloW, NTHR>(st + kHalo * xc, xc, lo - c0,
                                         static_cast<const bf16*>(p.skip),
                                         p.cin[0], lo, hi - lo, t.bi,
                                         t.y0 - 1, t.x0 - 1, p.H, p.W);
      }
    }
    off += p.cin[j];
  }
  bf16* sg = st + (has_skip ? 2 : 1) * kHalo * xc;
  stage_rows<kTileH, kTileW, NTHR>(sg, nc, 0,
                                   static_cast<const bf16*>(p.cot.dy), p.cout,
                                   co0, ncv, t.bi, t.y0, t.x0, p.H, p.W);
  if (has_y) {
    stage_rows<kTileH, kTileW, NTHR>(sg + kPix * nc, nc, 0,
                                     static_cast<const bf16*>(p.cot.y),
                                     p.cout, co0, ncv, t.bi, t.y0, t.x0, p.H,
                                     p.W);
  }
  if (p.a[0] != nullptr) {
    float* ac = reinterpret_cast<float*>(sg + (has_y ? 2 : 1) * kPix * nc);
    for (int c = threadIdx.x; c < cc; c += NTHR) {
      int j = 0;
      int ch = c0 + c;
      while (j + 1 < p.nparts && ch >= p.cin[j]) ch -= p.cin[j++];
      const int e = t.bi * p.cin[j] + ch;
      cp_async4(ac + c, p.a[j] + e);
      cp_async4(ac + xc + c, p.c[j] + e);
    }
  }
}

// The tile's xa = r(relu(x A + C) [+ skip]) with its halo into xa[pix * XS
// + c] (0 outside the image and beyond the chunk's cc columns), VW columns
// a thread and step; and r(g) into gsm[pix * (NC + 8) + c], 8 channels a
// thread, whose unrounded values the thread adds to its db sums db[e NTHR]
// (its own column of red [8][NTHR] in shared memory).
template <int NTHR, int XC, int XS, int VW, int NC>
__device__ __forceinline__ void dw_transform(const DwParams& p,
                                             const bf16* st, bf16* xa,
                                             bf16* gsm, int c0, int cc,
                                             int ncv, Tile t,
                                             const float* dsq, float* db) {
  const bool has_skip = p.skip != nullptr;
  const bool has_y = p.cot.y != nullptr;
  const bool has_pre = p.a[0] != nullptr;
  const int tid = threadIdx.x;
  const bf16* sd = st + (has_skip ? 2 : 1) * kHalo * XC;
  const bf16* sy = sd + kPix * NC;
  constexpr int G = XS / VW;  // column groups of a pixel, the padding's too
  constexpr int R = NTHR / G;
  if (tid < G * R) {
    const int col = VW * (tid % G);
    const float* ac =
        reinterpret_cast<const float*>(sy + (has_y ? kPix * NC : 0));
    const int skip_end = has_skip ? p.cin[0] - c0 : 0;  // part 0's columns
    for (int pix = tid / G; pix < kHalo; pix += R) {
      const int iy = t.y0 - 1 + pix / kHaloW;
      const int ix = t.x0 - 1 + pix % kHaloW;
      float v[VW] = {};
      if (col < cc && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
        load_vec<VW>(st + pix * XC + col, v);
        if (has_pre) {
          float s[VW] = {};
          if (col < skip_end) load_vec<VW>(st + kHalo * XC + pix * XC + col, s);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            v[e] = fmaxf(__fadd_rn(__fmul_rn(v[e], ac[col + e]),
                                   ac[XC + col + e]),
                         0.f);
            if (col + e < skip_end) v[e] = __fadd_rn(v[e], s[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          if (col + e >= cc) v[e] = 0.f;
        }
      }
      store_vec<VW>(xa + pix * XS + col, v);
    }
  }
  constexpr int GG = NC / 8;
  static_assert(NTHR % GG == 0, "a thread keeps one group of g");
  const int cg = 8 * (tid % GG);
  for (int pix = tid / GG; pix < kPix; pix += NTHR / GG) {
    const int oy = t.y0 + pix / kTileW;
    const int ox = t.x0 + pix % kTileW;
    float g[8] = {};
    if (oy < p.H && ox < p.W) {
      float yv[8] = {};
      load_vec<8>(sd + pix * NC + cg, g);
      if (has_y) load_vec<8>(sy + pix * NC + cg, yv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (has_y) {
          g[e] = __fadd_rn(__fadd_rn(g[e], dsq[cg + e]),
                           __fmul_rn(dsq[NC + cg + e], yv[e]));
        }
        if (cg + e >= ncv) g[e] = 0.f;
        db[e * NTHR] += g[e];
      }
    }
    store_vec<8>(gsm + pix * (NC + 8) + cg, g);
  }
}

// ds and 2 dq of the slab's channels into dsq [2][NC] (0 beyond ncv, and
// without statistics), and the thread's db sums red[e NTHR + tid] to 0;
// read after the next __syncthreads.
template <int NTHR, int NC>
__device__ __forceinline__ void dw_load_dsq(const Cot& cot, int co0, int ncv,
                                            float* dsq, float* red) {
  const int c = threadIdx.x;
#pragma unroll
  for (int e = 0; e < 8; ++e) red[e * NTHR + c] = 0.f;
  if (c < NC) {
    const bool ok = cot.y != nullptr && c < ncv;
    dsq[c] = ok ? cot.ds[co0 + c] : 0.f;
    dsq[NC + c] = ok ? __fmul_rn(2.f, cot.dq[co0 + c]) : 0.f;
  }
}

// db of the slab from the threads' sums red [8][NTHR], in thread order
// within a channel.
template <int NTHR, int NC>
__device__ __forceinline__ void dw_write_db(const DwParams& p,
                                            const float* red, int co0,
                                            int ncv) {
  constexpr int GG = NC / 8;
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < ncv) {
    float s = 0.f;
    for (int r = 0; r < NTHR / GG; ++r) {
      s += red[(tid % 8) * NTHR + r * GG + tid / 8];
    }
    p.part_db[(long long)blockIdx.x * p.cout + co0 + tid] = s;
  }
}

// MT m16 tiles of input channels (a chunk of 16 MT), NT n8 tiles of output
// channels (a slab of 8 NT), all nine taps: warp w owns tap w.
template <int MT, int NT>
__global__ void __launch_bounds__(kDwThreads, 1)
gub_conv_dw_tc(const DwParams p) {
  constexpr int CC = 16 * MT;
  constexpr int NC = 8 * NT;
  constexpr int XS = CC + 8;  // odd numbers of 16-byte units
  constexpr int GS = NC + 8;
  static_assert(NT % 2 == 0, "n8 tiles in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  const bool has_skip = p.skip != nullptr;
  const bool has_y = p.cot.y != nullptr;
  bf16* xa = reinterpret_cast<bf16*>(smem);  // [kHalo][XS]
  bf16* gsm = xa + kHalo * XS;               // [kPix][GS]
  bf16* raw = gsm + kPix * GS;
  const int stage = dw_stage(CC, NC, has_skip, has_y, p.a[0] != nullptr);
  float* red = reinterpret_cast<float*>(raw + 2 * stage);
  float* dsq = red + 8 * kDwThreads;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tap = tid >> 5;
  const int u = tap / 3;
  const int v = tap % 3;
  const int c0 = blockIdx.y * CC;
  const int cc = min(CC, p.cin_total - c0);
  const int co0 = blockIdx.z * NC;
  const int ncv = min(NC, p.cout - co0);
  const int total = tiles_per_image(p.H, p.W) * p.B;
  const int steps = my_tiles(total);
  dw_load_dsq<kDwThreads, NC>(p.cot, co0, ncv, dsq, red);

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  auto tile_at = [&](int s) {
    return tile_of(blockIdx.x + s * gridDim.x, p.H, p.W);
  };
  if (steps > 0) {
    dw_issue<kDwThreads>(p, raw, CC, NC, c0, cc, co0, ncv, tile_at(0));
  }
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // this tile's stage landed; the last tile is done
    if (s + 1 < steps) {
      dw_issue<kDwThreads>(p, raw + ((s + 1) & 1) * stage, CC, NC, c0, cc,
                           co0, ncv, tile_at(s + 1));
    }
    cp_async_commit();
    dw_transform<kDwThreads, CC, XS, 8, NC>(p, raw + (s & 1) * stage,
                                            xa, gsm, c0, cc, ncv, tile_at(s),
                                            dsq, red + tid);
    __syncthreads();
    // K runs over the tile's pixels, a tile row (16 pixels) a k16 step. The
    // tensor cores do not round their f32 sums to nearest, and the error of
    // each step adds up along a chain: chains of kChain steps start from 0
    // and are added to acc in f32, rounded to nearest. A chain holds the A
    // fragments of its steps and the sums of two n8 tiles.
#pragma unroll 1
    for (int py0 = 0; py0 < kTileH; py0 += kChain) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t a[kChain][4];
#pragma unroll
        for (int c = 0; c < kChain; ++c) {
          const int hp =
              (py0 + c + u) * kHaloW + (lane & 7) + (lane >> 4) * 8 + v;
          ldsm_x4_t(a[c], xa + hp * XS + m * 16 + ((lane >> 3) & 1) * 8);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          float d0[4] = {}, d1[4] = {};
#pragma unroll
          for (int c = 0; c < kChain; ++c) {
            uint32_t b[4];
            const int pix =
                (py0 + c) * kTileW + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldsm_x4_t(b, gsm + pix * GS + (j + (lane >> 4)) * 8);
            mma(d0, a[c], b[0], b[1]);
            mma(d1, a[c], b[2], b[3]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[m][j][e] += d0[e];
            acc[m][j + 1][e] += d1[e];
          }
        }
      }
    }
  }

  // One partial [tap][c0 + ci][co0 + co] per block.
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = m * 16 + (lane >> 2) + (e >> 1) * 8;
        const int co = j * 8 + (lane & 3) * 2 + (e & 1);
        if (ci < cc && co < ncv) {
          p.part_dw[(((long long)blockIdx.x * 9 + tap) * p.cin_total + c0 +
                     ci) * p.cout + co0 + co] = acc[m][j][e];
        }
      }
  if (blockIdx.y == 0) dw_write_db<kDwThreads, NC>(p, red, co0, ncv);
}

// The RGB guide (cin_total <= 3): its 9 cin (tap, ci) rows packed into M =
// 32 and A read element by element; warp w takes tile row w, and the eight
// warps add their sums in warp order at the end.
template <int NT>
__global__ void __launch_bounds__(kRgbThreads, 1)
gub_conv_dw_tc_rgb(const DwParams p) {
  constexpr int XC = 4;  // channels of a staged pixel
  constexpr int NC = 8 * NT;
  constexpr int GS = NC + 8;
  static_assert(NT % 2 == 0, "n8 tiles in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  const bool has_skip = p.skip != nullptr;
  const bool has_y = p.cot.y != nullptr;
  bf16* xa = reinterpret_cast<bf16*>(smem);  // [kHalo][XC]
  bf16* gsm = xa + kHalo * XC;               // [kPix][GS]
  bf16* raw = gsm + kPix * GS;
  const int stage = dw_stage(XC, NC, has_skip, has_y, p.a[0] != nullptr);
  float* red = reinterpret_cast<float*>(raw + 2 * stage);
  float* dsq = red + 8 * kRgbThreads;
  float* sums = dsq + 2 * NC;  // [2][NT][4][32]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int py = tid >> 5;
  const int cin = p.cin_total;
  const int co0 = blockIdx.z * NC;
  const int ncv = min(NC, p.cout - co0);
  const int total = tiles_per_image(p.H, p.W) * p.B;
  const int steps = my_tiles(total);
  dw_load_dsq<kRgbThreads, NC>(p.cot, co0, ncv, dsq, red);
  // rows (lane / 4) + 8 q of M: their offsets in the halo tile
  int off[4];
  bool row_ok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = (lane >> 2) + 8 * q;
    row_ok[q] = m < 9 * cin;
    const int tp = row_ok[q] ? m / cin : 0;
    off[q] = ((tp / 3) * kHaloW + tp % 3) * XC + (row_ok[q] ? m % cin : 0);
  }

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  auto tile_at = [&](int s) {
    return tile_of(blockIdx.x + s * gridDim.x, p.H, p.W);
  };
  if (steps > 0) {
    dw_issue<kRgbThreads>(p, raw, XC, NC, 0, cin, co0, ncv, tile_at(0));
  }
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < steps) {
      dw_issue<kRgbThreads>(p, raw + ((s + 1) & 1) * stage, XC, NC, 0, cin,
                            co0, ncv, tile_at(s + 1));
    }
    cp_async_commit();
    dw_transform<kRgbThreads, XC, XC, 4, NC>(p, raw + (s & 1) * stage,
                                             xa, gsm, 0, cin, ncv, tile_at(s),
                                             dsq, red + tid);
    __syncthreads();
    // A[m][k] = xa[py + tap / 3, k + tap % 3, ci] of row m = tap cin + ci:
    // register i of m16 tile m holds row 16 m + lane / 4 (+ 8 for odd i) at
    // k = 2 (lane % 4) (+ 8 for i >= 2) and the next k
    const bf16* row = xa + (py * kHaloW + (lane & 3) * 2) * XC;
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 2 * m + (i & 1);
        const bf16* r = row + (i >> 1) * 8 * XC + off[q];
        a[m][i] = row_ok[q] ? pack(r[0], r[XC]) : 0u;
      }
    }
    // one k16 step a tile from 0, added to acc rounded to nearest (as in
    // gub_conv_dw_tc)
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      const int pix = py * kTileW + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldsm_x4_t(b, gsm + pix * GS + (j + (lane >> 4)) * 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float d0[4] = {}, d1[4] = {};
        mma(d0, a[m], b[0], b[1]);
        mma(d1, a[m], b[2], b[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[m][j][i] += d0[i];
          acc[m][j + 1][i] += d1[i];
        }
      }
    }
  }

  // The warps' sums, added in warp order.
  for (int w = 0; w < kTileH; ++w) {
    if (py == w) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* sp = sums + ((m * NT + j) * 4 + i) * 32 + lane;
            *sp = w == 0 ? acc[m][j][i] : *sp + acc[m][j][i];
          }
    }
    __syncthreads();
  }
  for (int i = tid; i < 2 * NT * 4 * 32; i += kRgbThreads) {
    const int l = i & 31;
    const int q = (i >> 5) & 3;
    const int j = (i >> 7) % NT;
    const int m = (i >> 7) / NT;
    const int r = m * 16 + (l >> 2) + (q >> 1) * 8;
    const int co = j * 8 + (l & 3) * 2 + (q & 1);
    if (r < 9 * cin && co < ncv) {
      p.part_dw[(((long long)blockIdx.x * 9 + r / cin) * cin + r % cin) *
                    p.cout + co0 + co] = sums[i];
    }
  }
  dw_write_db<kRgbThreads, NC>(p, red, co0, ncv);
}

// Shared memory of a dw launch.
int dw_launch_smem(const DwParams& p, int xc, int xs, int nc, int threads,
                   bool rgb) {
  return dw_smem(xc, xs, nc, p.skip != nullptr, p.cot.y != nullptr,
                 p.a[0] != nullptr, threads, rgb);
}

template <int MT, int NT>
cudaError_t launch_dw(const DwParams& p, int nb, cudaStream_t stream) {
  static int set = 0;
  auto kern = gub_conv_dw_tc<MT, NT>;
  const int smem =
      dw_launch_smem(p, 16 * MT, 16 * MT + 8, 8 * NT, kDwThreads, false);
  int per_sm = 0;
  const cudaError_t err = prepare(kern, &set, smem, kDwThreads, &per_sm);
  if (err != cudaSuccess) return err;
  const DwCfg c{MT, NT};
  kern<<<dim3(nb, dw_grid_y(p.cin_total, c), dw_grid_z(p.cout, c)),
         kDwThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_dw_rgb(const DwParams& p, int nb, cudaStream_t stream) {
  static int set = 0;
  auto kern = gub_conv_dw_tc_rgb<NT>;
  const int smem = dw_launch_smem(p, 4, 4, 8 * NT, kRgbThreads, true);
  int per_sm = 0;
  const cudaError_t err = prepare(kern, &set, smem, kRgbThreads, &per_sm);
  if (err != cudaSuccess) return err;
  kern<<<dim3(nb, 1, dw_grid_z(p.cout, DwCfg{0, NT})), kRgbThreads, smem,
         stream>>>(p);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_dw_n(const DwParams& p, int mt, int nb,
                        cudaStream_t stream) {
  switch (mt) {
    case 0: return launch_dw_rgb<NT>(p, nb, stream);
    case 1: return launch_dw<1, NT>(p, nb, stream);
    case 2: return launch_dw<2, NT>(p, nb, stream);
    default: return launch_dw<(NT == 8 ? 2 : 4), NT>(p, nb, stream);
  }
}

cudaError_t launch_dw(const DwParams& p, int nb, cudaStream_t stream) {
  const DwCfg c = dw_cfg(p.cin_total, p.cout);
  switch (c.nt) {
    case 2: return launch_dw_n<2>(p, c.mt, nb, stream);
    case 4: return launch_dw_n<4>(p, c.mt, nb, stream);
    default: return launch_dw_n<8>(p, c.mt, nb, stream);
  }
}

}  // namespace tc

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
                                  int H, int W, int k, int is_bf16) {
  if (is_bf16 && k == 3) {
    int cin_total = 0;
    for (int j = 0; j < nparts; ++j) cin_total += cin[j];
    return tc::dw_blocks(cin_total, cout, B, H, W);
  }
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
  const int nb = gub_conv_dw_blocks(nparts, cin, cout, B, H, W, k, is_bf16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = k == 1 ? launch_dw_slab<__nv_bfloat16, 1>(p, nb, st)
                 : tc::launch_dw(p, nb, st);
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
                 : tc::launch_dx(p, st);
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
