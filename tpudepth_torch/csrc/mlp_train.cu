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
// + h exp(-h^2 / 2) / sqrt(2 pi) with the native erff (the TPU kernel used a
// rational erf within 1.5e-7 of it); db1 sums the unrounded f32 dh1.
//
// What bounds it: the forward does 2 products of 2 M C H operations, the
// backward five (h, da, dx, dw1, dw2), against M (2 C + C2) IO elements and
// the weights: at C = 128..1024, H = 4 C that is 500..4000 operations per
// bf16 byte, above the card's ~295: operations bound both.
//
// Design.
//   * forward: the FFN device code of block_tail.cuh (mlp_infer's), the 4C
//     hidden activation held on the chip, under its own entry;
//   * backward: five kernels, one entry.
//       1. hidden: per tile of 128 rows x 64 hidden columns, h = x W1 and
//          da = g W2^T, then a, dh1 in registers; writes a and dh1d to
//          scratch [M, H] in the IO dtype, and the tile's column sums of the
//          unrounded dh1 to a partial [row tiles, H];
//       2. dx = dh1d W1^T per tile of 128 rows x 64 columns;
//       3. dw1 = x^T dh1d and dw2 = a^T g, each per tile of 128 x 64 of the
//          weight and per chunk of rows, into partials [chunks, ., .] (or
//          straight into the gradient when there is one chunk);
//       4. db2: column sums of g per chunk of 256 rows;
//       5. the partials of dw1, dw2, db1, db2 added over their chunks in a
//          fixed order.
//     No atomics: the chunking depends on the shape alone, so a rerun is
//     bit-equal. The scratch a and dh1d ([M, 4C] each, written once and
//     read twice) is the hidden round trip through device memory that the
//     TPU kernel kept in VMEM; fusing it away is left to a later version.
//   * products: one GEMM main loop for all four product kinds, tiles of
//     128 x 64 x 32 staged through shared memory (operands stored with
//     their contraction index contiguous or, for the weight gradients,
//     with their rows contiguous: those are transposed while staging).
//     bf16: the tensor cores, mma.sync m16n8k16 (bf16 in, f32 accumulate),
//     each of 8 warps a 32 x 32 piece of the tile. f32 (held against the
//     plain version in full f32, as the JAX package's HIGHEST): the CUDA
//     cores, each thread an 8 x 4 piece of the tile.

#include "block_tail.cuh"

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ float round_io(float v) {
  return to_f(from_f<T>(v));
}

// Row stride of a staged tile in elements: bf16 rows of 40 (80 bytes) put
// the 32-bit fragment loads of a warp in 32 distinct banks; f32 rows of 33.
template <typename T>
__host__ __device__ constexpr int lds() { return 33; }
template <>
__host__ __device__ constexpr int lds<__nv_bfloat16>() { return kBK + 8; }

// 8 consecutive elements from 16-byte aligned device memory
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      __nv_bfloat16 (&v)[8]) {
  *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
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

// One k-block of the tile product acc += As Bs^T, and where a thread's
// accumulators lie in the kBM x kBN tile.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  // warp w: rows 32 (w >> 1).., columns 32 (w & 1)..; accumulator
  // (mi, ni, c) = acc[(mi * 4 + ni) * 4 + c] of the m16 tile mi and the n8
  // tile ni, in mma.sync's C layout
  static __device__ __forceinline__ void compute(float (&acc)[kAcc],
                                                 const __nv_bfloat16* As,
                                                 const __nv_bfloat16* Bs) {
    constexpr int LDS = lds<__nv_bfloat16>();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;
    const int t = lane & 3;
    const __nv_bfloat16* a_base = As + (warp >> 1) * 32 * LDS;
    const __nv_bfloat16* b_base = Bs + (warp & 1) * 32 * LDS;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* r0 = a_base + (mi * 16 + g) * LDS + kk + 2 * t;
        const __nv_bfloat16* r1 = r0 + 8 * LDS;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(r1);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* c0 = b_base + (ni * 8 + g) * LDS + kk + 2 * t;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(c0);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(c0 + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float* c = acc + (mi * 4 + ni) * 4;
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
              : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]),
                "r"(b[ni][0]), "r"(b[ni][1]));
        }
    }
  }
  static __device__ __forceinline__ void coord(int idx, int& r, int& c) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int mi = idx >> 4;
    const int ni = (idx >> 2) & 3;
    const int e = idx & 3;
    r = (warp >> 1) * 32 + mi * 16 + (lane >> 2) + (e >> 1) * 8;
    c = (warp & 1) * 32 + ni * 8 + 2 * (lane & 3) + (e & 1);
  }
};

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

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

cudaError_t chunk_sum(const float* part, int chunks, int n, float* out,
                      cudaStream_t st) {
  chunk_sum_kernel<<<cdiv(n, 256), 256, 0, st>>>(part, chunks, n, out);
  return cudaGetLastError();
}

// dw (R x N) over K rows in chunks of kchunk: straight into dw for one
// chunk, else through part [chunks, R, N] and a fixed-order sum
template <typename T>
cudaError_t wgrad(const T* A, int R, const T* B, int N, int K, int kchunk,
                  float* dw, float* part, cudaStream_t st) {
  const int chunks = cdiv(K, kchunk);
  const dim3 grid(cdiv(R, kBM), cdiv(N, kBN), chunks);
  wgrad_kernel<T><<<grid, kThreads, 0, st>>>(A, R, B, N, K, kchunk,
                                             chunks == 1 ? dw : part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  return chunk_sum(part, chunks, R * N, dw, st);
}

template <typename T>
cudaError_t backward(const BwdParams& p, float* dw1, float* db1, float* dw2,
                     float* db2, float* dw1_part, float* dw2_part,
                     float* db2_part, int kchunk1, int kchunk2,
                     cudaStream_t st) {
  const int row_tiles = cdiv(p.M, kBM);
  hidden_kernel<T><<<dim3(row_tiles, cdiv(p.H, kBN)), kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rows_kernel<T><<<dim3(row_tiles, cdiv(p.C, kBN)), kThreads, 0, st>>>(
      static_cast<const T*>(p.dh), p.H, static_cast<const T*>(p.w1),
      static_cast<T*>(p.dx), p.M, p.C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = wgrad<T>(static_cast<const T*>(p.x), p.C, static_cast<const T*>(p.dh),
                 p.H, p.M, kchunk1, dw1, dw1_part, st);
  if (err != cudaSuccess) return err;
  err = wgrad<T>(static_cast<const T*>(p.a), p.H, static_cast<const T*>(p.g),
                 p.C2, p.M, kchunk2, dw2, dw2_part, st);
  if (err != cudaSuccess) return err;
  const int rchunks = cdiv(p.M, kColsumRows);
  colsum_kernel<T><<<dim3(rchunks, cdiv(p.C2, 256)), 256, 0, st>>>(
      static_cast<const T*>(p.g), p.M, p.C2, db2_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = chunk_sum(db2_part, rchunks, p.C2, db2, st);
  if (err != cudaSuccess) return err;
  return chunk_sum(p.db1_part, row_tiles, p.H, db1, st);
}

}  // namespace mlpt
}  // namespace

// The forward: out = fc2(gelu(fc1(x))), x [M, cin], w1t [hidden, cin] and
// w2t [cout, hidden] (torch layout) in the IO dtype, b1, b2 f32 vectors of
// IO-dtype values. Returns a cudaError_t.
extern "C" int mlp_train_fwd(const void* x, const void* w1t, const void* b1,
                             const void* w2t, const void* b2, void* out,
                             int M, int cin, int hidden, int cout,
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
  return static_cast<int>(tail::run<tail::kFfn>(p, is_bf16, stream));
}

// The backward: x [M, C], g [M, C2], w1t [H, C], w1 [C, H], w2 [H, C2] in
// the IO dtype, all contiguous and 16-byte aligned; b1 f32 [H] of IO-dtype
// values. Writes dx [M, C] (IO dtype), dw1 [C, H], db1 [H], dw2 [H, C2],
// db2 [C2] (f32). Scratch: a, dh [M, H] (IO dtype); db1_part
// [ceil(M / 128), H]; db2_part [ceil(M / 256), C2]; dw1_part
// [ceil(M / kchunk1), C, H] and dw2_part [ceil(M / kchunk2), H, C2] (unused
// for one chunk). C, H, C2 multiples of 32; kchunk1, kchunk2 multiples of
// 32. Returns a cudaError_t.
extern "C" int mlp_train_bwd(const void* x, const void* g, const void* w1t,
                             const void* w1, const void* b1, const void* w2,
                             void* dx, void* dw1, void* db1, void* dw2,
                             void* db2, void* a, void* dh, void* db1_part,
                             void* db2_part, void* dw1_part, void* dw2_part,
                             int M, int C, int H, int C2, int kchunk1,
                             int kchunk2, int is_bf16, void* stream) {
  if (M < 1 || C < 32 || H < 32 || C2 < 32 || C % 32 || H % 32 || C2 % 32 ||
      kchunk1 < 32 || kchunk1 % 32 || kchunk2 < 32 || kchunk2 % 32) {
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
