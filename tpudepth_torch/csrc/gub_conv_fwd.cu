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
// below the card's ~295 FLOP/byte ridge on the tensor cores, so the bound is
// bytes; in f32 on the CUDA cores (67 TFLOP/s) the same work is bound by
// operations at Cin, Cout >= 32. Neither route writes the activated input to
// device memory: it and its one-pixel halo live only in shared memory.
//
// bf16, k = 3 (every GUB conv a served or trained GuideDepth launches): an
// implicit GEMM on the tensor cores, tc::gub_conv_fwd_tc, on the pieces it
// shares with gub_conv_bwd.cu's dx and dw (gub_conv_tc.cuh): M = a tile's
// pixels, N = every output channel (up to 64, so each input pixel is staged
// and transformed once), K = 9 taps x the parts' channels side by side (up
// to 64; the RGB guide's 3 channels: taps x channels flattened, 27 -> 32,
// one K of two k16 steps instead of nine of one). Persistent blocks stage
// all the weights once, rounded, as [tap][n][k] (up to 81 KB), and walk
// tiles of 8 x 16 pixels (4 x 16 where 8-row tiles would give fewer than
// two an SM: batch-1 up_1 has 150 of them for 132 SMs, 300 of 4 rows). Per
// tile: the raw parts, part 0's skip and the image's A and C arrive by
// cp.async in the other of two stage buffers while the current tile is
// worked on; the prelude runs once, eight channels a thread, into a bf16
// [pixel][k] tile whose row stride is an odd number of 16-byte units (0 in
// the halo outside the image); each tap is a shifted window of it that
// ldmatrix feeds to mma.sync.m16n8k16 (the RGB guide's A elements are read
// one by one). The tensor cores do not round their f32 sums to nearest, so
// each tap's <= 4 k16 steps sum from 0 and are added in f32 (a long chain
// drifts, gub_conv_bwd.cu). The epilogue adds the bias in f32, rounds,
// writes the tile through shared memory in 16-byte rows, and sums the
// rounded values per channel: the warp rows in order in f32 for the tile,
// the tiles in f64 in the block, one f64 atomicAdd a channel and block.
//
// f32, k = 1, and convs wider than 64 channels either way (none on a path):
// the CUDA-core kernel, one block per (image, 8x16 output tile, slab of <=
// 32 output channels), one output pixel per thread with the slab's
// accumulators in registers; input channels staged 16 at a time; products in
// f32; per-channel statistics reduced per block in f32 (warp shuffles, then
// shared memory: 128 pixels) and added to global f64 buffers with
// atomicAdd.
//
// The f64 atomics add in an order that varies from run to run, but in f64 it
// moves the sums by ~1e-16 of their size: sums over the 2.4 M pixels of a
// batch-8 480x640 stage keep f32 accuracy once rounded (f32 atomics lost
// ~1e-5 of it, which the variance q/n - mean^2 behind them doubles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gub_conv_tc.cuh"

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

// ---------------------------------------------------------------------------
// bf16, k = 3: an implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kMaxIn = 64;   // input channels (all parts) of one block
constexpr int kMaxOut = 64;  // output channels of one block
constexpr int kRgbIn = 3;    // at most this many: taps x channels flattened
constexpr int kRgbK = 32;    // ... into one K of 32 (27 used by RGB)

// Tiles of TH x kTileW pixels of every image, image-major.
struct FTile {
  int bi, y0, x0;
};

template <int TH>
__device__ __forceinline__ FTile ftile_of(int t, int H, int W) {
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int per_img = ((H + TH - 1) / TH) * tiles_w;
  FTile r;
  r.bi = t / per_img;
  const int i = t - r.bi * per_img;
  r.y0 = (i / tiles_w) * TH;
  r.x0 = (i % tiles_w) * kTileW;
  return r;
}

__host__ __device__ inline long long ftiles(int B, int H, int W, int th) {
  return (long long)B * ((H + th - 1) / th) * ((W + kTileW - 1) / kTileW);
}

// The layout of one block's dynamic shared memory, in bytes: weights
// [taps][nch][kp + 8] bf16; the activated tile and halo [halo][xs] bf16,
// which the output tile [pix][nch + 8] bf16 reuses once the products are
// done; two stages of the raw parts [halo][xc] bf16 (and part 0's skip,
// same layout) and the tile's image's A and C f32 [2][xc]; the block's f64
// sums of y and y^2 [2][nch]; the warp rows' f32 sums [2][4][nch]; the bias
// f32 [nch].
struct FwdSmem {
  int ws, xa, stage, stage_bytes, sums, red, bias, total;
};

__host__ __device__ inline FwdSmem fwd_smem(bool rgb, int ks, int nch, int th,
                                            bool has_skip) {
  const int halo = (th + 2) * kHaloW;
  const int kp = rgb ? kRgbK : 16 * ks;
  const int xc = rgb ? 4 : kp;
  const int xs = rgb ? 4 : kp + 8;
  const int taps = rgb ? 1 : 9;
  FwdSmem m;
  m.ws = 0;
  m.xa = m.ws + 2 * taps * nch * (kp + 8);
  int xa_bytes = 2 * halo * xs;
  const int out_bytes = 2 * th * kTileW * (nch + 8);
  if (out_bytes > xa_bytes) xa_bytes = out_bytes;
  m.stage = m.xa + ((xa_bytes + 15) & ~15);
  m.stage_bytes = 2 * (has_skip ? 2 : 1) * halo * xc + 4 * 2 * xc;
  m.sums = m.stage + 2 * m.stage_bytes;
  m.red = m.sums + 8 * 2 * nch;
  m.bias = m.red + 4 * 2 * 4 * nch;
  m.total = m.bias + 4 * nch;
  return m;
}

// y = conv3(xa) + b with xa = r(relu(x A + C) [+ skip]) (or x), the
// statistics of r(y). KS k16 steps a tap (KS = 0: the RGB layout, taps x
// channels flattened into one K of 32), NT n8 tiles a warp, WN groups of
// four warps along N (N = 8 NT WN output channels), MT m16 tiles (tile
// rows) a warp: tiles of 4 MT x 16 pixels.
template <int KS, int NT, int WN, int MT>
__global__ void __launch_bounds__(128 * WN, 1)
gub_conv_fwd_tc(const Params p) {
  constexpr bool RGB = KS == 0;
  constexpr int kThr = 128 * WN;
  constexpr int TH = 4 * MT;
  constexpr int HH = TH + 2;
  constexpr int HALO = HH * kHaloW;
  constexpr int PIX = TH * kTileW;
  constexpr int KP = RGB ? kRgbK : 16 * KS;  // K of one tap
  constexpr int KSTEPS = KP / 16;
  constexpr int TAPS = RGB ? 1 : 9;
  constexpr int GS = KP + 8;                  // odd numbers of 16-byte units
  constexpr int XC = RGB ? 4 : KP;            // channels of a staged pixel
  constexpr int XS = RGB ? 4 : KP + 8;
  constexpr int NCH = 8 * NT * WN;
  constexpr int OS = NCH + 8;
  constexpr int VW = RGB ? 4 : 8;             // channels a thread transforms
  constexpr int G = XC / VW;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool has_skip = p.skip != nullptr;
  const bool has_pre = p.a[0] != nullptr;
  const bool has_stats = p.s != nullptr;
  const FwdSmem L = fwd_smem(RGB, KS, NCH, TH, has_skip);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);   // [TAPS][NCH][GS]
  bf16* xa = reinterpret_cast<bf16*>(smem + L.xa);   // [HALO][XS]
  bf16* os = xa;                                     // [PIX][OS]
  double* sums = reinterpret_cast<double*>(smem + L.sums);  // [2][NCH]
  float* red = reinterpret_cast<float*>(smem + L.red);      // [2][4][NCH]
  float* bias = reinterpret_cast<float*>(smem + L.bias);    // [NCH]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) & 3;  // tile rows wm MT .. wm MT + MT - 1
  const int wn = tid >> 7;        // n8 tiles wn NT .. wn NT + NT - 1
  int cin = 0;
  for (int j = 0; j < p.nparts; ++j) cin += p.cin[j];
  const int cin0 = p.cin[0];
  const int steps = my_tiles(static_cast<int>(ftiles(p.B, p.H, p.W, TH)));

  auto tile_at = [&](int s) {
    return ftile_of<TH>(blockIdx.x + s * gridDim.x, p.H, p.W);
  };
  // The parts' channels side by side, part 0's skip beside them, and the
  // image's A and C, by cp.async where the layout allows.
  auto issue = [&](int s) {
    const FTile t = tile_at(s);
    unsigned char* st = smem + L.stage + (s & 1) * L.stage_bytes;
    bf16* sx = reinterpret_cast<bf16*>(st);
    int off = 0;
    for (int j = 0; j < p.nparts; ++j) {
      stage_rows<HH, kHaloW, kThr>(sx, XC, off, static_cast<const bf16*>(p.x[j]),
                                   p.cin[j], 0, p.cin[j], t.bi, t.y0 - 1,
                                   t.x0 - 1, p.H, p.W);
      off += p.cin[j];
    }
    if (has_skip) {
      stage_rows<HH, kHaloW, kThr>(sx + HALO * XC, XC, 0,
                                   static_cast<const bf16*>(p.skip), cin0, 0,
                                   cin0, t.bi, t.y0 - 1, t.x0 - 1, p.H, p.W);
    }
    if (has_pre) {
      float* ac = reinterpret_cast<float*>(sx + (has_skip ? 2 : 1) * HALO * XC);
      for (int c = tid; c < cin; c += kThr) {
        int j = 0;
        int ch = c;
        while (j + 1 < p.nparts && ch >= p.cin[j]) ch -= p.cin[j++];
        const int e = t.bi * p.cin[j] + ch;
        cp_async4(ac + c, p.a[j] + e);
        cp_async4(ac + XC + c, p.c[j] + e);
      }
    }
  };

  if (steps > 0) issue(0);
  cp_async_commit();
  // The weights, rounded, once a block: ws[tap][n][k] = w[u, v, k, n]
  // (RGB: ws[0][n][tap cin + ci] = w[u, v, ci, n]); eight loads in flight
  // a thread, neighbouring threads on the index with the smallest stride in
  // memory (a served OIHW weight: the tap; a trained channels_last one: k;
  // an HWIO one: n), so that a warp's loads share sectors.
  {
    constexpr int kAll = TAPS * NCH * KP;
    const long long* st = p.w_stride;
    const int order = RGB ? 0
                      : (st[1] < st[2] && st[1] < st[3]) ? 2
                      : (st[3] < st[2]) ? 1 : 0;  // k, n or tap fastest
    for (int i0 = tid; i0 < kAll; i0 += 8 * kThr) {
      float v[8];
      int at[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = i0 + q * kThr;
        int k, n, tap;
        if (order == 0) {
          k = i % KP;
          n = (i / KP) % NCH;
          tap = i / (KP * NCH);
        } else if (order == 1) {
          n = i % NCH;
          k = (i / NCH) % KP;
          tap = i / (KP * NCH);
        } else {
          tap = i % TAPS;
          k = (i / TAPS) % KP;
          n = i / (TAPS * KP);
        }
        at[q] = (tap * NCH + n) * GS + k;
        int ci = k;
        bool ok = i < kAll && n < p.cout;
        if (RGB) {
          tap = k / cin;
          ci = k - tap * cin;
          ok = ok && tap < 9;
        } else {
          ok = ok && k < cin;
        }
        v[q] = ok ? p.w[(tap / 3) * st[0] + (tap % 3) * st[1] +
                        (long long)ci * st[2] + (long long)n * st[3]]
                  : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (i0 + q * kThr < kAll) ws[at[q]] = __float2bfloat16(v[q]);
      }
    }
    for (int n = tid; n < NCH; n += kThr) {
      bias[n] = n < p.cout ? p.b[n] : 0.f;
      sums[n] = 0.0;
      sums[NCH + n] = 0.0;
    }
  }

  // RGB: the offsets in xa of the thread's A elements (k = tap cin + ci)
  // from the pixel of its row, for k16 step ks, k half kh and element e
  int roff[2][2][2];
  bool rok[2][2][2];
  if (RGB) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = ks * 16 + kh * 8 + (lane & 3) * 2 + e;
          const int tap = k / cin;
          rok[ks][kh][e] = tap < 9;
          roff[ks][kh][e] = rok[ks][kh][e]
                                ? ((tap / 3) * kHaloW + tap % 3) * XS + k -
                                      tap * cin
                                : 0;
        }
  }

  float acc[MT][NT][4];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // this tile's stage landed; the last tile is done
    if (s + 1 < steps) issue(s + 1);
    cp_async_commit();
    const FTile t = tile_at(s);
    const bf16* sx =
        reinterpret_cast<const bf16*>(smem + L.stage + (s & 1) * L.stage_bytes);
    const float* ac =
        reinterpret_cast<const float*>(sx + (has_skip ? 2 : 1) * HALO * XC);

    // xa = r(relu(x A + C) [+ skip]) of the tile and halo, VW channels a
    // thread and step: 0 outside the image and beyond cin
    for (int i = tid; i < HALO * G; i += kThr) {
      const int pix = i / G;
      const int col = VW * (i - pix * G);
      const int iy = t.y0 - 1 + pix / kHaloW;
      const int ix = t.x0 - 1 + pix % kHaloW;
      float v[VW] = {};
      if (col < cin && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
        load_vec<VW>(sx + pix * XC + col, v);
        if (has_pre) {
          float sk[VW] = {};
          if (has_skip && col < cin0)
            load_vec<VW>(sx + HALO * XC + pix * XC + col, sk);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            v[e] = fmaxf(__fadd_rn(__fmul_rn(v[e], ac[col + e]),
                                   ac[XC + col + e]),
                         0.f);
            if (has_skip && col + e < cin0) v[e] = __fadd_rn(v[e], sk[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          if (col + e >= cin) v[e] = 0.f;
        }
      }
      store_vec<VW>(xa + pix * XS + col, v);
    }
    __syncthreads();

    // y[pix, n] = sum over taps and k of xa[pix + tap, k] w[tap, k, n]: each
    // tap's KSTEPS (<= 4) k16 steps sum from 0 on the tensor cores and are
    // added to acc in f32
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll 3
    for (int tap = 0; tap < TAPS; ++tap) {
      const int u = tap / 3;
      const int v = tap % 3;
      float d[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[m][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int r = wm * MT + m;
          if (RGB) {
            // register i: pixel lane / 4 (+ 8 for odd i), k half i / 2
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const bf16* px =
                  xa + (r * kHaloW + (lane >> 2) + 8 * (i & 1)) * XS;
              const int kh = i >> 1;
              const bf16 zero = __float2bfloat16(0.f);
              a[m][i] = pack(rok[ks][kh][0] ? px[roff[ks][kh][0]] : zero,
                             rok[ks][kh][1] ? px[roff[ks][kh][1]] : zero);
            }
          } else {
            const int hp = (r + u) * kHaloW + (lane & 15) + v;
            ldsm_x4(a[m], xa + hp * XS + ks * 16 + (lane >> 4) * 8);
          }
        }
        uint32_t b[NT][2];
        const int k = ks * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int j = 0; j + 1 < NT; j += 2) {
          uint32_t rr[4];
          const int n = (wn * NT + j + (lane >> 4)) * 8 + (lane & 7);
          ldsm_x4(rr, ws + (tap * NCH + n) * GS + k);
          b[j][0] = rr[0];
          b[j][1] = rr[1];
          b[j + 1][0] = rr[2];
          b[j + 1][1] = rr[3];
        }
        if (NT & 1) {
          uint32_t rr[2];
          const int n = (wn * NT + NT - 1) * 8 + (lane & 7);
          ldsm_x2(rr, ws + (tap * NCH + n) * GS + k);
          b[NT - 1][0] = rr[0];
          b[NT - 1][1] = rr[1];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma(d[m][j], a[m], b[j][0], b[j][1]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] += d[m][j][e];
    }
    __syncthreads();  // every warp is done with xa: os takes its place

    // Epilogue: bias in f32, round; the rounded tile into os and the warp
    // rows' sums of it (pixels outside the image count 0)
    float sv[NT][2] = {}, qv[NT][2] = {};
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = wm * MT + m;
      const bool row_in = t.y0 + r < p.H;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = (lane >> 2) + 8 * h;
        const bool in = row_in && t.x0 + px < p.W;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = (wn * NT + j) * 8 + (lane & 3) * 2;
          const __nv_bfloat162 y2 = __floats2bfloat162_rn(
              acc[m][j][2 * h] + bias[n], acc[m][j][2 * h + 1] + bias[n + 1]);
          *reinterpret_cast<__nv_bfloat162*>(os + (r * kTileW + px) * OS + n) =
              y2;
          if (in) {
            const float2 f = __bfloat1622float2(y2);
            sv[j][0] += f.x;
            sv[j][1] += f.y;
            qv[j][0] += f.x * f.x;
            qv[j][1] += f.y * f.y;
          }
        }
      }
    }
    if (has_stats) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = sv[j][e];
          float b = qv[j][e];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            a += __shfl_xor_sync(0xffffffffu, a, o);
            b += __shfl_xor_sync(0xffffffffu, b, o);
          }
          if (lane < 4) {
            const int n = (wn * NT + j) * 8 + lane * 2 + e;
            red[wm * NCH + n] = a;
            red[(4 + wm) * NCH + n] = b;
          }
        }
    }
    __syncthreads();
    // The tile's rows of y, 16 bytes a thread where the width allows
    bf16* y = static_cast<bf16*>(p.y);
    if ((p.cout & 7) == 0) {
      const int q8 = p.cout >> 3;
      for (int i = tid; i < PIX * q8; i += kThr) {
        const int pix = i / q8;
        const int q = i - pix * q8;
        const int oy = t.y0 + pix / kTileW;
        const int ox = t.x0 + pix % kTileW;
        if (oy >= p.H || ox >= p.W) continue;
        *reinterpret_cast<uint4*>(
            y + (((long long)t.bi * p.H + oy) * p.W + ox) * p.cout + q * 8) =
            *reinterpret_cast<const uint4*>(os + pix * OS + q * 8);
      }
    } else {
      for (int i = tid; i < PIX * p.cout; i += kThr) {
        const int pix = i / p.cout;
        const int n = i - pix * p.cout;
        const int oy = t.y0 + pix / kTileW;
        const int ox = t.x0 + pix % kTileW;
        if (oy >= p.H || ox >= p.W) continue;
        y[(((long long)t.bi * p.H + oy) * p.W + ox) * p.cout + n] =
            os[pix * OS + n];
      }
    }
    // The tile's sums in f32 (warp rows in order), added to the block's f64
    if (has_stats) {
      for (int n = tid; n < p.cout; n += kThr) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          a += red[w * NCH + n];
          b += red[(4 + w) * NCH + n];
        }
        sums[n] += static_cast<double>(a);
        sums[NCH + n] += static_cast<double>(b);
      }
    }
  }
  if (has_stats) {
    __syncthreads();
    for (int n = tid; n < p.cout; n += kThr) {
      atomicAdd(&p.s[n], sums[n]);
      atomicAdd(&p.q[n], sums[NCH + n]);
    }
  }
}

template <int KS, int NT, int WN, int MT>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  static int set = 0;
  auto kern = gub_conv_fwd_tc<KS, NT, WN, MT>;
  const int smem =
      fwd_smem(KS == 0, KS, 8 * NT * WN, 4 * MT, p.skip != nullptr).total;
  int per_sm = 0;
  const cudaError_t err = prepare(kern, &set, smem, 128 * WN, &per_sm);
  if (err != cudaSuccess) return err;
  const long long total = ftiles(p.B, p.H, p.W, 4 * MT);
  long long nb = (long long)per_sm * sm_count();
  nb = nb > total ? total : nb;
  kern<<<static_cast<unsigned>(nb), 128 * WN, smem, stream>>>(p);
  return cudaGetLastError();
}

// Tile rows: 8, or 4 where 8-row tiles would give fewer than two a
// streaming multiprocessor (batch-1 up_1: 150 tiles of 8 rows, 300 of 4).
template <int KS, int NT, int WN>
cudaError_t launch_fwd_m(const Params& p, cudaStream_t stream) {
  if (ftiles(p.B, p.H, p.W, 8) < 2LL * sm_count())
    return launch_fwd<KS, NT, WN, 1>(p, stream);
  return launch_fwd<KS, NT, WN, 2>(p, stream);
}

template <int KS>
cudaError_t launch_fwd_n(const Params& p, cudaStream_t stream) {
  if (p.cout <= 16) return launch_fwd_m<KS, 2, 1>(p, stream);
  if (p.cout <= 32) return launch_fwd_m<KS, 2, 2>(p, stream);
  return launch_fwd_m<KS, 4, 2>(p, stream);
}

// Whether the tensor-core kernel takes the conv (bf16, k = 3, all input
// and output channels in one block); the rest keeps the CUDA-core kernel.
bool fwd_ok(int cin, int cout) { return cin <= kMaxIn && cout <= kMaxOut; }

cudaError_t run_fwd(const Params& p, int cin, cudaStream_t stream) {
  if (cin <= kRgbIn) return launch_fwd_n<0>(p, stream);
  if (cin <= 16) return launch_fwd_n<1>(p, stream);
  if (cin <= 32) return launch_fwd_n<2>(p, stream);
  return launch_fwd_n<4>(p, stream);
}

}  // namespace tc

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
  int cin_total = 0;
  for (int j = 0; j < nparts; ++j) cin_total += cin[j];
  cudaError_t err;
  if (is_bf16 && k == 3 && tc::fwd_ok(cin_total, cout)) {
    err = tc::run_fwd(p, cin_total, st);
  } else {
    err = is_bf16 ? launch_k<__nv_bfloat16>(p, k, st)
                  : launch_k<float>(p, k, st);
  }
  return static_cast<int>(err);
}
