// Transformer FFN for training, for Hopper (sm_90a): the forward
// out = fc2(gelu(fc1(x))) and its analytic backward.
//
//   forward:  h = round(x W1 + b1); a = round(gelu(h)); out = round(a W2 + b2)
//   backward: h recomputed; gelu(h) and gelu'(h) in f32; a = round(gelu(h));
//             dw2 = a^T g;  db2 = sum_rows g;  da = g W2^T;
//             dh1 = da * gelu'(h);  dh1d = round(dh1);
//             dx = round(dh1d W1^T);  dw1 = x^T dh1d;  db1 = sum_rows dh1
//
// over rows of x [M, C] and g [M, C2], with W1 [C, H] and W2 [H, C2] (the
// JAX package's [in, out]) rounded to the IO dtype and b1, b2 given as f32
// vectors holding IO-dtype values (the JAX wrapper casts all four with
// .astype(dt)). Weight and bias gradients are f32 sums.
//
// Replaces tpudepth/ops/pallas/mlp_train.py::_mlp_fwd_pallas (:132) and
// ::_mlp_bwd_pallas (:163, body _bwd_kernel :58), the Pallas TPU kernels
// under the custom VJP mlp_train (:205-237). Same arithmetic, in this
// order; products of IO-dtype operands sum in f32; the exact GELU
// 0.5 h (1 + erf(h / sqrt 2)) and its derivative 0.5 (1 + erf(h / sqrt 2))
// + h exp(-h^2 / 2) / sqrt(2 pi); db1 sums the unrounded f32 dh1. erf: the
// bf16 paths evaluate the TPU kernel's degree-16 polynomial
// (tpudepth/ops/pallas/mlp_infer.py::_erf, gemm::erf_poly; the forward
// looks gelu(h) up by h's bits in a table that it fills, gemm::gelu_table),
// so the bf16 forward and its backward agree on a; the f32 paths evaluate
// the native erff, within 2.1e-7 of it.
//
// What bounds it: the forward does 2 products of 2 M C H operations, the
// backward five (h, da, dx, dw1, dw2), against M (2 C + C2) IO elements and
// the weights: at C = 128..1024, H = 4 C that is 500..4000 operations per
// bf16 byte, above the card's ~295: operations bound both. The backward
// also writes a and dh1d ([M, H] bf16 each) once and reads them three
// times in all (dx, dw1, dw2): summed over the four stages of a 480x640
// batch-8 step (sum M H = 147.5 M elements) about 1.47 GB, 0.44 ms at
// 3.35 TB/s, which the five products in cuBLAS pay as well (the TPU kernel
// kept the hidden in VMEM); part of it stays in the 50 MB L2 at C 512-1024.
// Measured (NVIDIA H100 80GB HBM3, scripts/torch_ffn_stage_times.py): the
// weight gradients run at 280 (C 128) to 550 (C 1024) TFLOP/s; the hidden step, whose epilogue
// evaluates erf and exp on every element of [M, 4C] and writes a and dh1d,
// takes 1/3 (C 1024) to 1/2 (C 128) of the backward.
//
// Design.
//   * forward, bf16 (the training path): mlp_infer's chain on the wgmma core
//     of gemm_sm90.cuh (gemm::ffn_bf16): a = round(gelu(round(x W1 + b1)))
//     into the bf16 scratch [M, H] that the wrapper allocates, then
//     out = round(a W2 + b2). a is not kept for the backward, which
//     recomputes it as the TPU kernel does. The first design (block_tail.cuh's
//     FFN on mma.sync, the hidden held on the chip) took 2.556 ms for the
//     calls of a B 8 SAM step on an NVIDIA H100 80GB HBM3 at 700 W, 6.4 % of
//     the bound and 6.71x the two cuBLAS products; the chain takes 0.723 ms
//     there (chip_smoke.py), 1.9x cuBLAS;
//   * forward, f32: the CUDA-core FFN of block_tail.cuh (mlp_infer's);
//   * backward, bf16 (the training path): the products on the pipelined
//     wgmma core of gemm_sm90.cuh (TMA ring of 64-deep k-blocks, two
//     consumer warpgroups, persistent blocks two an SM, bf16 outputs stored
//     by TMA), one kernel per step:
//       1. hidden: per tile of 128 rows x 64 hidden columns, h = x W1 and
//          da = g W2^T into two accumulators; the epilogue rounds h, takes
//          gelu and gelu' in f32, writes a and dh1d to the scratch [M, H]
//          and the tile's column sums of the unrounded dh1 to a partial
//          [row tiles, H];
//       2. dx = dh1d W1^T, rounded;
//       3. dw1 = x^T dh1d and dw2 = a^T g with both operands MN-major
//          (wgmma's transpose bits: nothing is transposed element by
//          element), per tile of 128 x 128 of the weight and per chunk of
//          rows (a multiple of 64), into partials [chunks, ., .] (or
//          straight into the gradient for one chunk);
//       4. db2: column sums of g per chunk of 256 rows;
//       5. the partials of dw1, dw2, db1, db2 added over their chunks in a
//          fixed order (beyond 32 chunks as 32 strided partial sums, then
//          those in order).
//     No atomics: the tiles and chunks depend on the shape alone, so a
//     rerun is bit-equal. The first design ran these products on mma.sync
//     from synchronously staged 128 x 64 x 32 tiles, the weight gradients'
//     operands transposed element by element while staging: 9.36 ms per
//     B 8 SAM step, ~10x the same products in cuBLAS.
//   * backward, f32 (held against the plain version in full f32, as the
//     JAX package's HIGHEST): the same five steps on the CUDA cores, tiles
//     of 128 x 64 x 32 staged through shared memory (the weight gradients'
//     operands transposed while staging), each thread an 8 x 4 piece.

#include "block_tail.cuh"
#include "gemm_sm90.cuh"

#include <type_traits>

namespace {
namespace mlpt {

constexpr int kThreads = 256;
constexpr int kBM = 128;   // rows of a tile
constexpr int kBN = 64;    // columns of a tile
constexpr int kBK = 32;    // depth of a k-block
constexpr int kAcc = kBM * kBN / kThreads;  // accumulators a thread
constexpr int kColsumRows = 256;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;
// shared memory: the staged tiles, or the [kBM][kBN] f32 column-sum tile
constexpr int kSmemBytes = kBM * kBN * 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

template <typename T>
__device__ __forceinline__ float round_io(float v) {
  return to_f(from_f<T>(v));
}

// Row stride of a staged f32 tile in elements: rows of 33 put a warp's
// loads in distinct banks.
template <typename T>
__host__ __device__ constexpr int lds() { return 33; }

// 8 consecutive elements from 16-byte aligned device memory
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Stage the R x kBK block (rows r0.., contraction index k0..) of an operand
// into s, element (r, k) at s[r * lds + k]. Not kTrans: element (r, k) of
// the operand lies at src[r * ld + k] (k contiguous; the k-block is always
// whole); kTrans: at src[k * ld + r] (r contiguous). Rows >= rlim and
// k >= klim are zeros. 8 elements a load; ld, r0 and k0 multiples of 8.
template <typename T, bool kTrans, int R>
__device__ __forceinline__ void stage(const T* src, long long ld, int r0,
                                      int rlim, int k0, int klim, T* s) {
  constexpr int LDS = lds<T>();
  if (!kTrans) {
    for (int e = threadIdx.x; e < R * (kBK / 8); e += kThreads) {
      const int r = e / (kBK / 8);
      const int kk = (e - r * (kBK / 8)) * 8;
      alignas(16) T v[8];
      if (r0 + r < rlim) {
        load8(src + static_cast<long long>(r0 + r) * ld + k0 + kk, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = from_f<T>(0.f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s[r * LDS + kk + i] = v[i];
    }
  } else {
    for (int e = threadIdx.x; e < (R / 8) * kBK; e += kThreads) {
      const int k = e / (R / 8);
      const int rr = (e - k * (R / 8)) * 8;
      alignas(16) T v[8];
      if (k0 + k < klim && r0 + rr < rlim) {
        load8(src + static_cast<long long>(k0 + k) * ld + r0 + rr, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = from_f<T>(0.f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s[(rr + i) * LDS + k] = v[i];
    }
  }
}

// One k-block of the f32 tile product acc += As Bs^T, and where a
// thread's accumulators lie in the kBM x kBN tile.
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  // thread (ty, tx) = (tid / 16, tid % 16): rows ty + 16 i, columns
  // tx + 16 j; accumulator acc[i * 4 + j]
  static __device__ __forceinline__ void compute(float (&acc)[kAcc],
                                                 const float* As,
                                                 const float* Bs) {
    constexpr int LDS = lds<float>();
    const int ty = threadIdx.x >> 4;
    const int tx = threadIdx.x & 15;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * LDS + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * LDS + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i * 4 + j] = fmaf(a[i], b[j], acc[i * 4 + j]);
    }
  }
  static __device__ __forceinline__ void coord(int idx, int& r, int& c) {
    r = (threadIdx.x >> 4) + 16 * (idx >> 2);
    c = (threadIdx.x & 15) + 16 * (idx & 3);
  }
};

// acc (kBM x kBN tile at rows m0, columns n0) += sum over k in [kbeg, kend)
// of A(m, k) B(n, k); kTA / kTB as in stage().
template <typename T, bool kTA, bool kTB>
__device__ __forceinline__ void mainloop(float (&acc)[kAcc], const T* A,
                                         long long lda, int m0, int mlim,
                                         const T* B, long long ldb, int n0,
                                         int nlim, int kbeg, int kend,
                                         unsigned char* smem) {
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kBM * lds<T>();
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    stage<T, kTA, kBM>(A, lda, m0, mlim, k0, kend, As);
    stage<T, kTB, kBN>(B, ldb, n0, nlim, k0, kend, Bs);
    __syncthreads();
    Mma<T>::compute(acc, As, Bs);
    __syncthreads();
  }
}

struct BwdParams {
  const void* x;     // [M, C]
  const void* g;     // [M, C2]
  const void* w1t;   // [H, C]: W1^T (fc1's torch weight)
  const void* w1;    // [C, H]
  const float* b1;   // [H]
  const void* w2;    // [H, C2]
  void* dx;          // [M, C]
  void* a;           // scratch [M, H]
  void* dh;          // scratch [M, H]
  float* db1_part;   // [ceil(M / kBM), H]
  int M, C, H, C2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) hidden_kernel(const BwdParams p) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const int m0 = blockIdx.x * kBM;
  const int j0 = blockIdx.y * kBN;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  // h = x W1 (+ b1), from W1^T [H, C]
  mainloop<T, false, false>(acc, static_cast<const T*>(p.x), p.C, m0, p.M,
                            static_cast<const T*>(p.w1t), p.C, j0, p.H, 0,
                            p.C, smem);
  float a[kAcc], gp[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    int r, c;
    Mma<T>::coord(i, r, c);
    const float h = round_io<T>(acc[i] + p.b1[j0 + c]);
    const float cdf = 0.5f * (1.0f + erff(h * kInvSqrt2));
    a[i] = h * cdf;
    gp[i] = cdf + h * (expf(-0.5f * h * h) * kInvSqrt2Pi);
    acc[i] = 0.f;
  }
  // da = g W2^T, from W2 [H, C2]; rows past M of g are zeros, so da and dh1
  // are 0 there
  mainloop<T, false, false>(acc, static_cast<const T*>(p.g), p.C2, m0, p.M,
                            static_cast<const T*>(p.w2), p.C2, j0, p.H, 0,
                            p.C2, smem);
  float* cs = reinterpret_cast<float*>(smem);  // [kBM][kBN] after the loop
  T* ad = static_cast<T*>(p.a);
  T* dhd = static_cast<T*>(p.dh);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    int r, c;
    Mma<T>::coord(i, r, c);
    const float dh = acc[i] * gp[i];
    cs[r * kBN + c] = dh;
    if (m0 + r < p.M) {
      const size_t o = static_cast<size_t>(m0 + r) * p.H + j0 + c;
      ad[o] = from_f<T>(a[i]);
      dhd[o] = from_f<T>(dh);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kBN; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kBM; ++r) s += cs[r * kBN + c];
    p.db1_part[static_cast<size_t>(blockIdx.x) * p.H + j0 + c] = s;
  }
}

// out[m, n] = round(sum_k A[m, k] B[n, k]) for rows m < M: dx = dh1d W1^T
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const T* A, int K, const T* B, T* out, int M, int N) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  mainloop<T, false, false>(acc, A, K, m0, M, B, K, n0, N, 0, K, smem);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    int r, c;
    Mma<T>::coord(i, r, c);
    if (m0 + r < M && n0 + c < N)
      out[static_cast<size_t>(m0 + r) * N + n0 + c] = from_f<T>(acc[i]);
  }
}

// out[z, r, n] = sum over rows k of chunk z of A[k, r] B[k, n], A [K, R],
// B [K, N]: dw1 = x^T dh1d, dw2 = a^T g
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wgrad_kernel(const T* A, int R, const T* B, int N, int K, int kchunk,
                 float* out) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  mainloop<T, true, true>(acc, A, R, r0, R, B, N, n0, N, kbeg, kend, smem);
  float* o = out + static_cast<size_t>(blockIdx.z) * R * N;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    int r, c;
    Mma<T>::coord(i, r, c);
    if (r0 + r < R && n0 + c < N)
      o[static_cast<size_t>(r0 + r) * N + n0 + c] = acc[i];
  }
}

// part[z, n] = sum of X[r, n] over the rows r of chunk z (kColsumRows rows)
template <typename T>
__global__ void colsum_kernel(const T* X, int M, int N, float* part) {
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.x * kColsumRows;
  const int r1 = min(M, r0 + kColsumRows);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += to_f(X[static_cast<size_t>(r) * N + n]);
  part[static_cast<size_t>(blockIdx.x) * N + n] = s;
}

// out[e] = sum over chunks z, in order, of part[z, e]
__global__ void chunk_sum_kernel(const float* part, int chunks, int n,
                                 float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int z = 0; z < chunks; ++z) s += part[static_cast<size_t>(z) * n + e];
  out[e] = s;
}

// out[e] = sum over chunks z of part[z, e] in a fixed order: 32 strided
// partial sums (z = g, g + 32, ...), then added in the order g = 0..31.
// Block (32, 32): 32 elements, 32 groups.
__global__ void chunk_sum_tree_kernel(const float* part, int chunks, int n,
                                      float* out) {
  __shared__ float s[32][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (e < n)
    for (int z = threadIdx.y; z < chunks; z += 32)
      v += part[static_cast<size_t>(z) * n + e];
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && e < n) {
    float t = 0.f;
    for (int g = 0; g < 32; ++g) t += s[g][threadIdx.x];
    out[e] = t;
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The chunk sums: in order (f32, and bf16 up to 32 chunks), or as a tree.
cudaError_t chunk_sum(const float* part, int chunks, int n, float* out,
                      bool tree, cudaStream_t st) {
  if (tree && chunks > 32) {
    chunk_sum_tree_kernel<<<cdiv(n, 32), dim3(32, 32), 0, st>>>(part, chunks,
                                                                n, out);
  } else {
    chunk_sum_kernel<<<cdiv(n, 256), 256, 0, st>>>(part, chunks, n, out);
  }
  return cudaGetLastError();
}

// dw (R x N) over K rows in chunks of kchunk: straight into dw for one
// chunk, else through part [chunks, R, N] and a fixed-order sum (f32)
cudaError_t wgrad_f32(const float* A, int R, const float* B, int N, int K,
                      int kchunk, float* dw, float* part, cudaStream_t st) {
  const int chunks = cdiv(K, kchunk);
  const dim3 grid(cdiv(R, kBM), cdiv(N, kBN), chunks);
  wgrad_kernel<float><<<grid, kThreads, 0, st>>>(A, R, B, N, K, kchunk,
                                                 chunks == 1 ? dw : part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  return chunk_sum(part, chunks, R * N, dw, false, st);
}

// Steps 1-3 in f32 on the CUDA cores.
cudaError_t products_f32(const BwdParams& p, float* dw1, float* dw2,
                         float* dw1_part, float* dw2_part, int kchunk1,
                         int kchunk2, cudaStream_t st) {
  const int row_tiles = cdiv(p.M, kBM);
  hidden_kernel<float><<<dim3(row_tiles, cdiv(p.H, kBN)), kThreads, 0, st>>>(
      p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rows_kernel<float><<<dim3(row_tiles, cdiv(p.C, kBN)), kThreads, 0, st>>>(
      static_cast<const float*>(p.dh), p.H, static_cast<const float*>(p.w1),
      static_cast<float*>(p.dx), p.M, p.C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = wgrad_f32(static_cast<const float*>(p.x), p.C,
                  static_cast<const float*>(p.dh), p.H, p.M, kchunk1, dw1,
                  dw1_part, st);
  if (err != cudaSuccess) return err;
  return wgrad_f32(static_cast<const float*>(p.a), p.H,
                   static_cast<const float*>(p.g), p.C2, p.M, kchunk2, dw2,
                   dw2_part, st);
}

// The hidden tile's epilogue (bf16): h = round(x W1 + b1); gelu(h) and
// gelu'(h) in f32 (erf as the TPU kernel's polynomial); a = round(gelu(h))
// and dh1d = round(da gelu'(h)) into the scratch; the tile's column sums of
// the unrounded dh1 (each warp's 16 rows by shuffles, then the 8 warps in
// order) into db1_part[row tile]. Rows past M read x and g as zeros: their
// da, and so dh1, is 0. (Looking gelu and gelu' up by h's bits, as the
// forward's gemm::BiasGelu does, measured no faster here: this epilogue is
// held by its two outputs' stores and the column sums.)
struct HiddenEpi {
  static constexpr int kProducts = 2;
  static constexpr int kTiles = 2;                  // a, dh1d
  static constexpr int kSmemBytes = 8 * 128 * 4;   // [warp][column] sums
  struct Params {
    const float* b1;
    float* db1_part;
    int M, H;
  };
  template <int BN>
  static __device__ __forceinline__ void apply(const Params& p,
                                               float (&acc)[2][BN / 2],
                                               const gemm::Tile& t,
                                               unsigned char* smem,
                                               const CUtensorMap* c_maps,
                                               unsigned char* staging,
                                               uint32_t) {
    float* cs = reinterpret_cast<float*>(smem);
    const int c0 = t.n0 + gemm::frag_col();
    const int lane = threadIdx.x & 31;
    uint32_t wa[BN / 8][2], wd[BN / 8][2];
    gemm::consumers_sync();   // the previous tile's sums have been read
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c0 + 8 * j;
      const bool in = col < p.H;
      const float bias[2] = {in ? p.b1[col] : 0.f, in ? p.b1[col + 1] : 0.f};
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float av[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float hv = gemm::bf16r(acc[0][i] + bias[e]);
          const float cdf = gemm::normal_cdf(hv);
          av[e] = hv * cdf;
          dv[e] = acc[1][i] *
                  (cdf + hv * (expf(-0.5f * hv * hv) * kInvSqrt2Pi));
          sum[e] += dv[e];
        }
        wa[j][h] = gemm::pack2(av[0], av[1]);
        wd[j][h] = gemm::pack2(dv[0], dv[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = sum[e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4)
          cs[(threadIdx.x >> 5) * BN + gemm::frag_col() + 8 * j + e] = v;
      }
    }
    gemm::store_words<BN>(wa, &c_maps[0], staging, t.m0, t.n0);
    gemm::store_words<BN>(wd, &c_maps[1], staging, t.m0, t.n0);
    gemm::consumers_sync();
    const int c = threadIdx.x;
    if (c < BN && t.n0 + c < p.H) {
      float v = 0.f;
      for (int w = 0; w < gemm::kConsumers / 32; ++w) v += cs[w * BN + c];
      p.db1_part[static_cast<size_t>(t.mt) * p.H + t.n0 + c] = v;
    }
  }
};

// dw (R x N) = sum over the K rows of A [K, R]^T B [K, N] (bf16, both
// MN-major), in chunks of kchunk rows (a multiple of 64): straight into dw
// for one chunk, else through part [chunks, R, N] and a fixed-order sum.
cudaError_t wgrad_bf16(const void* A, int R, const void* B, int N, int K,
                       int kchunk, float* dw, float* part, cudaStream_t st) {
  const int chunks = cdiv(K, kchunk);
  const gemm::F32Store::Params e = {chunks == 1 ? dw : part, R, N};
  const void* a[1] = {A};
  const void* b[1] = {B};
  const long long lda[1] = {R}, ldb[1] = {N};
  const int k[1] = {K};
  cudaError_t err = gemm::run_bn<gemm::F32Store, gemm::kMN>(
      gemm::tile_n(N), e, a, lda, b, ldb, k, R, N, chunks,
      kchunk / gemm::kBK, st);
  if (err != cudaSuccess || chunks == 1) return err;
  return chunk_sum(part, chunks, R * N, dw, true, st);
}

// Steps 1-3 in bf16 on the wgmma core.
cudaError_t products_bf16(const BwdParams& p, float* dw1, float* dw2,
                          float* dw1_part, float* dw2_part, int kchunk1,
                          int kchunk2, cudaStream_t st) {
  constexpr int kAll = 1 << 30;   // k-blocks of one split: all of them
  __nv_bfloat16* a = static_cast<__nv_bfloat16*>(p.a);
  __nv_bfloat16* dh = static_cast<__nv_bfloat16*>(p.dh);
  {
    // h = x W1 from W1^T [H, C]; da = g W2^T from W2 [H, C2]
    const HiddenEpi::Params e = {p.b1, p.db1_part, p.M, p.H};
    const void* A[2] = {p.x, p.g};
    const void* B[2] = {p.w1t, p.w2};
    void* out[2] = {a, dh};
    const long long lda[2] = {p.C, p.C2}, ldb[2] = {p.C, p.C2};
    const int k[2] = {p.C, p.C2};
    const cudaError_t err = gemm::run<HiddenEpi, gemm::kK, 64>(
        e, A, lda, B, ldb, k, p.M, p.H, 1, kAll, st, out);
    if (err != cudaSuccess) return err;
  }
  {
    // dx = dh1d W1^T from W1 [C, H]
    const void* A[1] = {dh};
    const void* B[1] = {p.w1};
    void* out[1] = {p.dx};
    const long long lda[1] = {p.H}, ldb[1] = {p.H};
    const int k[1] = {p.H};
    const cudaError_t err = gemm::run_bn<gemm::RoundStore, gemm::kK>(
        gemm::tile_n(p.C), {}, A, lda, B, ldb, k, p.M, p.C, 1, kAll, st,
        out);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err =
      wgrad_bf16(p.x, p.C, dh, p.H, p.M, kchunk1, dw1, dw1_part, st);
  if (err != cudaSuccess) return err;
  return wgrad_bf16(a, p.H, p.g, p.C2, p.M, kchunk2, dw2, dw2_part, st);
}

template <typename T>
cudaError_t backward(const BwdParams& p, float* dw1, float* db1, float* dw2,
                     float* db2, float* dw1_part, float* dw2_part,
                     float* db2_part, int kchunk1, int kchunk2,
                     cudaStream_t st) {
  cudaError_t err =
      std::is_same<T, float>::value
          ? products_f32(p, dw1, dw2, dw1_part, dw2_part, kchunk1, kchunk2, st)
          : products_bf16(p, dw1, dw2, dw1_part, dw2_part, kchunk1, kchunk2,
                          st);
  if (err != cudaSuccess) return err;
  const int rchunks = cdiv(p.M, kColsumRows);
  colsum_kernel<T><<<dim3(rchunks, cdiv(p.C2, 256)), 256, 0, st>>>(
      static_cast<const T*>(p.g), p.M, p.C2, db2_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr bool kTree = !std::is_same<T, float>::value;
  err = chunk_sum(db2_part, rchunks, p.C2, db2, kTree, st);
  if (err != cudaSuccess) return err;
  return chunk_sum(p.db1_part, cdiv(p.M, kBM), p.H, db1, kTree, st);
}

}  // namespace mlpt
}  // namespace

// The forward: out = fc2(gelu(fc1(x))), x [M, cin], w1t [hidden, cin] and
// w2t [cout, hidden] (torch layout) in the IO dtype, b1, b2 f32 vectors of
// IO-dtype values; x and out contiguous and 16-byte aligned. bf16 takes the
// scratch a [M, hidden] (bf16; unused in f32). Returns a cudaError_t.
extern "C" int mlp_train_fwd(const void* x, const void* w1t, const void* b1,
                             const void* w2t, const void* b2, void* out,
                             void* a, int M, int cin, int hidden, int cout,
                             int is_bf16, void* stream) {
  tail::Params p = {};
  p.o = x;
  p.w1 = w1t;
  p.b1 = static_cast<const float*>(b1);
  p.w2 = w2t;
  p.b2 = static_cast<const float*>(b2);
  p.out = out;
  p.M = M;
  p.cin = cin;
  p.hidden = hidden;
  p.cout = cout;
  if (!is_bf16) return static_cast<int>(tail::run<tail::kFfn>(p, stream));
  if (!tail::shape_ok(p, tail::kFfn) || a == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gemm::ffn_bf16(x, w1t, p.b1, w2t, p.b2, a, out, M,
                                         cin, hidden, cout,
                                         static_cast<cudaStream_t>(stream)));
}

// The backward: x [M, C], g [M, C2], w1t [H, C], w1 [C, H], w2 [H, C2] in
// the IO dtype, all contiguous and 16-byte aligned; b1 f32 [H] of IO-dtype
// values. Writes dx [M, C] (IO dtype), dw1 [C, H], db1 [H], dw2 [H, C2],
// db2 [C2] (f32). Scratch: a, dh [M, H] (IO dtype); db1_part
// [ceil(M / 128), H]; db2_part [ceil(M / 256), C2]; dw1_part
// [ceil(M / kchunk1), C, H] and dw2_part [ceil(M / kchunk2), H, C2] (unused
// for one chunk). C, H, C2 multiples of 32; kchunk1, kchunk2 multiples of
// 64 (the bf16 products' k-block). Returns a cudaError_t.
extern "C" int mlp_train_bwd(const void* x, const void* g, const void* w1t,
                             const void* w1, const void* b1, const void* w2,
                             void* dx, void* dw1, void* db1, void* dw2,
                             void* db2, void* a, void* dh, void* db1_part,
                             void* db2_part, void* dw1_part, void* dw2_part,
                             int M, int C, int H, int C2, int kchunk1,
                             int kchunk2, int is_bf16, void* stream) {
  if (M < 1 || C < 32 || H < 32 || C2 < 32 || C % 32 || H % 32 || C2 % 32 ||
      kchunk1 < 64 || kchunk1 % 64 || kchunk2 < 64 || kchunk2 % 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mlpt::BwdParams p = {};
  p.x = x;
  p.g = g;
  p.w1t = w1t;
  p.w1 = w1;
  p.b1 = static_cast<const float*>(b1);
  p.w2 = w2;
  p.dx = dx;
  p.a = a;
  p.dh = dh;
  p.db1_part = static_cast<float*>(db1_part);
  p.M = M;
  p.C = C;
  p.H = H;
  p.C2 = C2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f[6] = {static_cast<float*>(dw1), static_cast<float*>(db1),
                 static_cast<float*>(dw2), static_cast<float*>(db2),
                 static_cast<float*>(dw1_part), static_cast<float*>(dw2_part)};
  const cudaError_t err =
      is_bf16 ? mlpt::backward<__nv_bfloat16>(
                    p, f[0], f[1], f[2], f[3], f[4], f[5],
                    static_cast<float*>(db2_part), kchunk1, kchunk2, st)
              : mlpt::backward<float>(p, f[0], f[1], f[2], f[3], f[4], f[5],
                                      static_cast<float*>(db2_part), kchunk1,
                                      kchunk2, st);
  return static_cast<int>(err);
}
