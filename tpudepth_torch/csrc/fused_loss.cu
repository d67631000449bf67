// Fused alhashim depth loss for Hopper (sm_90a): forward partial sums and the
// analytic backward, float32 throughout.
//
// Replaces the two Pallas TPU kernels of tpudepth/ops/pallas/fused_loss.py:
//   fused_loss_fwd  <-  _fused_partials (:101)  per image: sum |p-t|, sum of
//       the SSIM map (zero-padded SAME separable 11-tap sigma-1.5 gaussian
//       over p, t, p^2, t^2, pt), sum of the x/y forward-difference terms;
//   fused_loss_bwd  <-  _fused_bwd (:273)  dL/dp: sign of the L1 term, the
//       forward-difference sign terms, and the SSIM adjoint (the gaussian of
//       the three coefficient maps Cmu1, Ce11, Ce12), scaled by scales[3].
//
// What bounds it: the forward reads 2*B*H*W*4 bytes and does about 250 float
// operations per pixel (22 multiply-adds for each of 5 maps, plus the
// pointwise formulas); the backward reads the same, writes B*H*W*4 and does
// about 410 (8 maps). On the CUDA cores (67 TFLOP/s in float32; there is no
// tensor-core form of a shifted-window sum) the operations take longer than
// the bytes at 3.35 TB/s, so both directions are bound by operations: 0.0092
// and 0.0151 ms at B 8, 480x640.
//
// Forward: one kernel a call. The TPU kernel holds one whole image (~14
// float32 buffers) in VMEM per grid step; here a block of 384 threads takes a
// 40x64 output tile (namespace fwd) and
//   0. stages p and t with a 5-pixel halo, zero outside the image, by
//      16-byte loads when W is a multiple of 4 (50 x 80 floats each);
//   A. runs the statistics' gaussian down the columns for the 40 x 74
//      pixels the row pass needs: a thread slides the 11 taps down 8 rows of
//      one column and keeps the 5 maps' 8 sums in registers (18 shared loads
//      of p and t for 440 multiply-adds; 370 threads);
//   B. along the rows, 8 outputs a thread (five 16-byte shared loads a map
//      for 88 multiply-adds; 320 threads), then the SSIM map of each pixel
//      in registers; the other 64 threads walk down a column of the tile
//      each for its L1 and forward-difference terms.
// The forward needs the statistics on the tile alone, so there is no ring:
// 1.16x the column pass, 1x the row pass. Every block adds its threads'
// sums in a fixed tree and writes them to partials[B][blocks][3]; then
// (__threadfence, a ticket from atomicAdd on the image's counter, which the
// C entry zeroes with cudaMemsetAsync on the launch stream) the image's last
// block adds its blocks' sums in block order and writes out[b]. The sums
// are those of fixed trees whichever block comes last, so the loss repeats
// bit for bit from run to run; no float atomics. Tried and dropped (B 8,
// 480x640): 32x64 tiles (4.5 waves of two blocks an SM; 40x64 gives 3.6),
// 32x60 tiles (exactly 5 waves, but 6-column row strips load by 4 bytes),
// three blocks an SM (56 registers spill), and the edge terms taken by the
// column pass's threads, after it or from its own loads (more registers or
// more instructions on the longer phase).
//
// Backward: one kernel a 32x64 output tile, and the coefficient maps never
// leave the chip (a two-kernel split writes three maps to device memory and
// reads them back with a halo: 59 MB at B 8, 480x640, more than the whole
// bound's worth). A block of 384 threads (namespace bwd):
//   0. stages p and t with a 10-pixel halo, zero outside the image, by
//      16-byte loads when W is a multiple of 4 (52 x 88 floats each);
//   A. runs the statistics' gaussian down the columns for the 42 x 84
//      pixels the ring needs: a thread slides the 11 taps down 6 rows of one
//      column and keeps the 5 maps' 6 sums in registers (16 shared loads of
//      p and t for 330 multiply-adds);
//   B. along the rows for the 42 x 74 pixels of the tile and its 5-pixel
//      ring, 8 pixels of a row a thread (18 shared loads a map for 88
//      multiply-adds; the last 2 columns a thread of their own), then forms
//      the coefficient maps there, 0 outside the image (the adjoint is
//      zero-padded and the formulas do not give 0 at p = t = 0);
//   C. runs the adjoint gaussian down the columns of the three maps, 8 rows
//      a thread, and stages p and t of the tile and a 1-pixel ring (loaded
//      before the column pass, stored after it);
//   D. along the rows, 8 outputs a thread, adds the L1 and forward-
//      difference sign terms, and writes dL/dp through shared memory, so
//      that consecutive threads store consecutive 16-byte pieces of a row
//      (a thread's own 8 outputs in a row of their own cost a warp 32 L1
//      wavefronts a store).
// Phase 0's staging shares its memory with B's maps, C's results and the
// ring with A's; 109,208 bytes of dynamic shared memory and at most 85
// registers a thread keep two blocks, 24 warps, on an SM. The ring costs
// 1.72x the statistics' column pass and 1.52x their row pass and the
// coefficient formulas (four IEEE divisions a pixel), 1.16x the adjoint's
// column pass: about 250 multiply-adds a pixel where the function needs 176,
// and 163 instructions of coefficients where it needs 107. What holds it
// is the instruction count (about 560 a pixel) and the instruction slots the
// four barriers leave idle, which the SM's second block fills in part.
// Tried and dropped: a division without its per-element branch, checked by
// its exact remainder (more instructions, no gain); the sign terms as
// bytes made by phase A's spare threads (more instructions in all);
// persistent blocks that walk down a strip and keep the maps' last 10 rows
// for the next tile (fewer instructions, but no room left to stage p and
// t, and phase A reading them through L1 lost more than the ring saved).

// The gaussian taps use fused multiply-adds, tap 0's product first and
// taps 1..10 added in order, columns before rows; every formula after them
// (SSIM map, coefficients, the final sum) uses the non-contracting
// intrinsics, so that with equal statistics it is bit-equal to the plain
// PyTorch version, and pred == target gives an SSIM of exactly 1. Every
// output's operations are those of the two-kernel backward this replaced,
// in the same order, so its bits did not move.
//
// sign(0) is 0, as in jnp.sign. The forward-difference terms leave out the
// last column (x) and the last row (y).

#include <cuda_runtime.h>

namespace {

constexpr int WS = 11;
constexpr int HALF = WS / 2;
struct Taps {
    float g[WS];
};

__device__ __forceinline__ float sgn(float v) {
    return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// The SSIM terms of one pixel from its five statistics, in the operation
// order of the plain version, without contraction.
struct Ssim {
    float m1, m2, n1, d1, n2, d2;
};

__device__ __forceinline__ Ssim ssim_terms(float mu1, float mu2, float e11,
                                           float e22, float e12, float c1,
                                           float c2) {
    Ssim s;
    s.m1 = mu1;
    s.m2 = mu2;
    const float m11 = __fmul_rn(mu1, mu1);
    const float m22 = __fmul_rn(mu2, mu2);
    const float m12 = __fmul_rn(mu1, mu2);
    const float s11 = __fsub_rn(e11, m11);
    const float s22 = __fsub_rn(e22, m22);
    const float s12 = __fsub_rn(e12, m12);
    s.n1 = __fadd_rn(__fmul_rn(2.0f, m12), c1);
    s.d1 = __fadd_rn(__fadd_rn(m11, m22), c1);
    s.n2 = __fadd_rn(__fmul_rn(2.0f, s12), c2);
    s.d2 = __fadd_rn(__fadd_rn(s11, s22), c2);
    return s;
}

// p and t of rows ytop .. ytop + ROWS - 1, columns xleft .. xleft + COLS - 1
// (xleft a multiple of 4), zero outside the image, into sp and st (row
// stride COLS): a thread keeps one 4-column group and steps down the rows.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage(const float* __restrict__ pred,
                                      const float* __restrict__ tgt, int H,
                                      int W, int ytop, int xleft, bool vec,
                                      float* __restrict__ sp,
                                      float* __restrict__ st) {
    constexpr int Q4 = COLS / 4;         // groups a row
    constexpr int STEP = NT / Q4;        // rows at a time
    const int q = threadIdx.x % Q4, r0 = threadIdx.x / Q4;
    if (r0 >= STEP) return;
    const int x = xleft + 4 * q;
    const bool in[4] = {x >= 0 && x < W, x + 1 >= 0 && x + 1 < W,
                        x + 2 >= 0 && x + 2 < W, x + 3 >= 0 && x + 3 < W};
#pragma unroll
    for (int k = 0; k < (ROWS + STEP - 1) / STEP; ++k) {
        const int r = r0 + k * STEP;
        if (r >= ROWS) break;
        const int y = ytop + r;
        float4 vp = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vt = vp;
        if (y >= 0 && y < H) {
            const size_t at = (size_t)y * W + x;
            if (vec) {
                // W % 4 == 0 and x % 4 == 0: all four inside or all outside
                if (in[0]) {
                    vp = *reinterpret_cast<const float4*>(pred + at);
                    vt = *reinterpret_cast<const float4*>(tgt + at);
                }
            } else {
                if (in[0]) vp.x = pred[at], vt.x = tgt[at];
                if (in[1]) vp.y = pred[at + 1], vt.y = tgt[at + 1];
                if (in[2]) vp.z = pred[at + 2], vt.z = tgt[at + 2];
                if (in[3]) vp.w = pred[at + 3], vt.w = tgt[at + 3];
            }
        }
        *reinterpret_cast<float4*>(sp + r * COLS + 4 * q) = vp;
        *reinterpret_cast<float4*>(st + r * COLS + 4 * q) = vt;
    }
}

// The column pass of p, t, p*p, t*t, p*t for N rows of one column: from the
// staged rows r0 .. r0 + N + 9 of sp[c], st[c] (row stride SWS) into
// sums[(m * MS + r0 + j) * AS + c], map m, j < N. acc = g0 * v at the
// window's first row, then fmaf(g[k], v, acc) for k = 1..10 in order.
template <int N, int SWS, int MS, int AS>
__device__ __forceinline__ void column_stats(const Taps& taps,
                                             const float* __restrict__ sp,
                                             const float* __restrict__ st,
                                             float* __restrict__ sums, int r0,
                                             int c) {
    float a[5][N];
#pragma unroll
    for (int i = 0; i < N + WS - 1; ++i) {
        const float p = sp[(r0 + i) * SWS + c];
        const float t = st[(r0 + i) * SWS + c];
        const float v[5] = {p, t, __fmul_rn(p, p), __fmul_rn(t, t),
                            __fmul_rn(p, t)};
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const int k = i - j;
            if (k < 0 || k >= WS) continue;
#pragma unroll
            for (int m = 0; m < 5; ++m)
                a[m][j] = k == 0 ? __fmul_rn(taps.g[0], v[m])
                                 : fmaf(taps.g[k], v[m], a[m][j]);
        }
    }
#pragma unroll
    for (int m = 0; m < 5; ++m)
#pragma unroll
        for (int j = 0; j < N; ++j)
            sums[(m * MS + r0 + j) * AS + c] = a[m][j];
}

// The row pass of one map over N consecutive outputs from the values
// v[0 .. N + 9] of a row: out[j] = g0 * v[j], then fmaf with taps 1..10.
template <int N>
__device__ __forceinline__ void taps_of(const Taps& taps, const float* v,
                                        float (&out)[N]) {
#pragma unroll
    for (int i = 0; i < N + WS - 1; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const int k = i - j;
            if (k < 0 || k >= WS) continue;
            out[j] = k == 0 ? __fmul_rn(taps.g[0], v[i])
                            : fmaf(taps.g[k], v[i], out[j]);
        }
    }
}

// The row pass from the row src[0 .. N + 9] in shared memory.
template <int N>
__device__ __forceinline__ void row_taps(const Taps& taps,
                                         const float* __restrict__ src,
                                         float (&out)[N]) {
    float v[N + WS - 1];
#pragma unroll
    for (int i = 0; i < N + WS - 1; ++i) v[i] = src[i];
    taps_of<N>(taps, v, out);
}

// The same from a 16-byte aligned row, by 16-byte loads.
template <int N>
__device__ __forceinline__ void row_taps4(const Taps& taps,
                                          const float* __restrict__ src,
                                          float (&out)[N]) {
    constexpr int L = (N + WS - 1 + 3) / 4;
    float v[4 * L];
#pragma unroll
    for (int q = 0; q < L; ++q) {
        const float4 f = reinterpret_cast<const float4*>(src)[q];
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
    }
    taps_of<N>(taps, v, out);
}

namespace fwd {

constexpr int TH = 40;                 // output tile
constexpr int TW = 64;
constexpr int SH = TH + 2 * HALF;      // 50 staged rows of p and t
constexpr int RW = TW + 2 * HALF;      // 74 columns of the column pass
constexpr int SX = 3;                  // staged column of image column x0 - 5
constexpr int SWS = 80;                // staged columns x0 - 8 .. x0 + 71
// row stride of A's sums: 16-byte rows, and 8 rows of B's 16-byte loads
// fall on 32 distinct banks (76 = 12 mod 32)
constexpr int AS = 76;
constexpr int NT = 384;                // 12 warps, two blocks an SM
constexpr int RA = 8;                  // rows a thread in A
constexpr int RB = 8;                  // columns a thread in B
constexpr int A_ITEMS = (TH / RA) * RW;
constexpr int B_ITEMS = TH * (TW / RB);
constexpr int SMEM_BYTES = (2 * SH * SWS + 5 * TH * AS) * 4;
static_assert(TH % RA == 0 && TW % RB == 0, "strips");
static_assert(A_ITEMS <= NT && B_ITEMS + TW == NT,
              "one item a thread in A; in B and the edge terms");
static_assert(SX + RW + 1 <= SWS, "the staged columns");
static_assert(AS % 4 == 0 && AS >= TW + 12 && TH % 8 == 0, "B's loads");

// Sum three per-thread values over the block in a fixed tree; thread 0
// holds the result.
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c) {
    __shared__ float red[3][NT / 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
        c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        red[0][warp] = a;
        red[1][warp] = b;
        red[2][warp] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        a = red[0][0];
        b = red[1][0];
        c = red[2][0];
        for (int w = 1; w < NT / 32; ++w) {
            a += red[0][w];
            b += red[1][w];
            c += red[2][w];
        }
    }
}

// The L1 and forward-difference terms of the tile's column x, rows y0 ..
// y0 + TH - 1, from the staged p, t there (sp, st at the tile's first row;
// row stride SWS), right of them and below them.
__device__ __forceinline__ void edge_terms(const float* __restrict__ sp,
                                           const float* __restrict__ st,
                                           int y0, int x, int H, int W,
                                           float& l1, float& gr) {
    float p = sp[0], t = st[0];
#pragma unroll 4
    for (int j = 0; j < TH; ++j) {
        if (y0 + j >= H) break;
        const float pd = sp[(j + 1) * SWS], td = st[(j + 1) * SWS];
        l1 += fabsf(__fsub_rn(p, t));
        if (x + 1 < W) {
            const float dt = __fsub_rn(st[j * SWS + 1], t);
            const float dp = __fsub_rn(sp[j * SWS + 1], p);
            gr += fabsf(__fsub_rn(dt, dp));
        }
        if (y0 + j + 1 < H) {
            const float dt = __fsub_rn(td, t);
            const float dp = __fsub_rn(pd, p);
            gr += fabsf(__fsub_rn(dt, dp));
        }
        p = pd;
        t = td;
    }
}

__global__ void __launch_bounds__(NT, 2)
fwd_kernel(const float* __restrict__ pred, const float* __restrict__ tgt,
           float* __restrict__ partials, unsigned* __restrict__ count,
           float* __restrict__ out, int H, int W, float c1, float c2,
           Taps taps) {
    extern __shared__ __align__(16) float smem[];
    float* sp = smem;
    float* st = sp + SH * SWS;
    float* sums = st + SH * SWS;
    __shared__ bool last;

    const int b = blockIdx.z;
    const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const size_t img = (size_t)b * H * W;
    const bool vec = (W & 3) == 0 &&
        ((reinterpret_cast<size_t>(pred) | reinterpret_cast<size_t>(tgt)) &
         15) == 0;
    const int tid = threadIdx.x;

    // 0. p, t of rows y0-5 .. y0+44, columns x0-8 .. x0+71
    stage<SH, SWS, NT>(pred + img, tgt + img, H, W, y0 - HALF, x0 - 8, vec,
                       sp, st);
    __syncthreads();

    // A. the statistics down the columns
    if (tid < A_ITEMS)
        column_stats<RA, SWS, TH, AS>(taps, sp + SX, st + SX, sums,
                                      (tid / RW) * RA, tid % RW);
    __syncthreads();

    // B. along the rows and the SSIM map of each pixel; the other TW threads
    // take the edge terms, a column of the tile each
    float l1 = 0.0f, ss = 0.0f, gr = 0.0f;
    if (tid < B_ITEMS) {
        const int r = tid % TH, c0 = (tid / TH) * RB;
        float s[5][RB];
#pragma unroll
        for (int m = 0; m < 5; ++m)
            row_taps4<RB>(taps, sums + (m * TH + r) * AS + c0, s[m]);
        if (y0 + r < H) {
#pragma unroll
            for (int j = 0; j < RB; ++j) {
                if (x0 + c0 + j >= W) break;
                const Ssim q = ssim_terms(s[0][j], s[1][j], s[2][j], s[3][j],
                                          s[4][j], c1, c2);
                ss += __fdiv_rn(__fmul_rn(q.n1, q.n2), __fmul_rn(q.d1, q.d2));
            }
        }
    } else if (x0 + tid - B_ITEMS < W) {
        const int at = HALF * SWS + SX + HALF + tid - B_ITEMS;
        edge_terms(sp + at, st + at, y0, x0 + tid - B_ITEMS, H, W, l1, gr);
    }

    // the block's sums, then the image's last block adds the blocks' sums
    const int blocks = gridDim.x * gridDim.y;
    float* mine = partials + (size_t)b * blocks * 3;
    block_sum3(l1, ss, gr);
    if (tid == 0) {
        const int at = blockIdx.y * gridDim.x + blockIdx.x;
        mine[at * 3 + 0] = l1;
        mine[at * 3 + 1] = ss;
        mine[at * 3 + 2] = gr;
        __threadfence();
        last = atomicAdd(count + b, 1u) == static_cast<unsigned>(blocks - 1);
    }
    __syncthreads();
    if (!last) return;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int i = tid; i < blocks; i += NT) {
        a0 += __ldcg(mine + i * 3 + 0);
        a1 += __ldcg(mine + i * 3 + 1);
        a2 += __ldcg(mine + i * 3 + 2);
    }
    block_sum3(a0, a1, a2);
    if (tid == 0) {
        out[b * 3 + 0] = a0;
        out[b * 3 + 1] = a1;
        out[b * 3 + 2] = a2;
    }
}

}  // namespace fwd

namespace bwd {

constexpr int TH = 32;                 // output tile
constexpr int TW = 64;
constexpr int RH = TH + 2 * HALF;      // 42 rows of statistics and maps
constexpr int RW = TW + 2 * HALF;      // 74 columns
constexpr int SH = TH + 4 * HALF;      // 52 staged rows of p and t
constexpr int CW = TW + 4 * HALF;      // 84 columns of the statistics' column pass
constexpr int SX = 2;                  // staged column of image column x0 - 10
constexpr int SWS = 88;                // staged columns x0 - 12 .. x0 + 75
constexpr int AS = CW + 1;             // row stride of A's sums (odd: B's rows)
constexpr int CS = RW + 1;             // row stride of the maps and of C's sums
constexpr int NT = 384;                // 12 warps, two blocks an SM
constexpr int RA = 6;                  // rows a thread in A (RH = 7 RA)
constexpr int RB = 8;                  // columns a thread in B and D
constexpr int RC = 8;                  // rows a thread in C (TH = 4 RC)
constexpr int B_FULL = RW / RB;        // 9 strips of RB columns in B ...
constexpr int RB_LAST = RW - B_FULL * RB;      // ... and one of 2
constexpr int C_STRIPS = TH / RC;
constexpr int QH = TH + 2, QW = TW + 2, QS = QW + 1;  // p, t with a 1-pixel ring
constexpr int Q_TRIPS = (QH * QW + NT - 1) / NT;     // its elements a thread
constexpr int OS = TW + 4;             // row stride of D's outputs

// Dynamic shared memory, in floats: region 1 holds A's sums, then C's and
// the p, t ring; region 2 holds the staged p and t, then the maps, then D's
// outputs on their way to device memory.
constexpr int R1 = (5 * RH * AS + 3) / 4 * 4;   // region 2 16-byte aligned
constexpr int R2 = 3 * RH * CS;
constexpr int RING = 3 * TH * CS;      // the p, t ring in region 1
constexpr int SMEM_BYTES = (R1 + R2) * 4;
static_assert(RING + 2 * QH * QS <= R1, "region 1 too small");
static_assert(2 * SH * SWS <= R2 && TH * OS <= R2, "region 2 too small");
static_assert(RH % RA == 0 && RW % RB != 0 && TH % RC == 0, "strips");
static_assert(C_STRIPS * RW <= NT && (TW / RB) * TH <= NT,
              "one item a thread in C and D");

// The coefficient maps of one pixel from its five statistics.
struct Coef {
    float mu1, e11, e12;
};

__device__ __forceinline__ Coef coef_of(float mu1, float mu2, float e11,
                                        float e22, float e12, float c1,
                                        float c2) {
    const Ssim s = ssim_terms(mu1, mu2, e11, e22, e12, c1, c2);
    // R = 1/(D1*D2), M = N1*N2*R
    const float rr = __fdiv_rn(1.0f, __fmul_rn(s.d1, s.d2));
    const float m = __fmul_rn(__fmul_rn(s.n1, s.n2), rr);
    // Cmu1 = 2*mu2*R*(N2 - N1) - 2*mu1*M*(1/D1 - 1/D2)
    const float ta = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, s.m2), rr),
                               __fsub_rn(s.n2, s.n1));
    const float tb = __fmul_rn(
        __fmul_rn(__fmul_rn(2.0f, s.m1), m),
        __fsub_rn(__fdiv_rn(1.0f, s.d1), __fdiv_rn(1.0f, s.d2)));
    Coef c;
    c.mu1 = __fsub_rn(ta, tb);
    c.e11 = __fdiv_rn(-m, s.d2);
    c.e12 = __fmul_rn(__fmul_rn(2.0f, s.n1), rr);
    return c;
}

// B: the row pass of the five statistics at pixels c0 .. c0 + N - 1 of
// row r of the ring (RH x RW, origin (y0 - 5, x0 - 5)), then the maps there.
template <int N>
__device__ __forceinline__ void ring_maps(const Taps& taps,
                                          const float* __restrict__ sums,
                                          float* __restrict__ maps, int r,
                                          int c0, int H, int W, int y0,
                                          int x0, float c1, float c2) {
    float st[5][N];
#pragma unroll
    for (int m = 0; m < 5; ++m)
        row_taps<N>(taps, sums + (m * RH + r) * AS + c0, st[m]);
    const int y = y0 - HALF + r;
#pragma unroll
    for (int j = 0; j < N; ++j) {
        const int x = x0 - HALF + c0 + j;
        Coef c = {0.0f, 0.0f, 0.0f};
        if (y >= 0 && y < H && x >= 0 && x < W)
            c = coef_of(st[0][j], st[1][j], st[2][j], st[3][j], st[4][j], c1,
                        c2);
        maps[(0 * RH + r) * CS + c0 + j] = c.mu1;
        maps[(1 * RH + r) * CS + c0 + j] = c.e11;
        maps[(2 * RH + r) * CS + c0 + j] = c.e12;
    }
}

// C: the adjoint's column pass of the three maps at rows r0 .. r0 + RC - 1
// of the tile, column c of the ring.
__device__ __forceinline__ void column_adjoint(const Taps& taps,
                                               const float* __restrict__ maps,
                                               float* __restrict__ sums,
                                               int r0, int c) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        float a[RC];
#pragma unroll
        for (int i = 0; i < RC + WS - 1; ++i) {
            const float v = maps[(m * RH + r0 + i) * CS + c];
#pragma unroll
            for (int j = 0; j < RC; ++j) {
                const int k = i - j;
                if (k < 0 || k >= WS) continue;
                a[j] = k == 0 ? __fmul_rn(taps.g[0], v)
                              : fmaf(taps.g[k], v, a[j]);
            }
        }
#pragma unroll
        for (int j = 0; j < RC; ++j) sums[(m * TH + r0 + j) * CS + c] = a[j];
    }
}

// D: dL/dp at pixels c0 .. c0 + RB - 1 of row r of the tile into out (row
// stride OS): the adjoint's row pass of C's sums, the L1 and forward-
// difference sign terms from the p, t ring (qp, qt; row stride QS, origin
// (y0 - 1, x0 - 1)).
__device__ __forceinline__ void out_tile(const Taps& taps,
                                         const float* __restrict__ sums,
                                         const float* __restrict__ qp,
                                         const float* __restrict__ qt,
                                         float* __restrict__ out,
                                         const float* __restrict__ scales,
                                         int r, int c0, int y0, int x0, int H,
                                         int W) {
    const int y = y0 + r, xs = x0 + c0;
    const float* prow = qp + (r + 1) * QS + c0;   // column xs - 1
    const float* trow = qt + (r + 1) * QS + c0;
    const float s_l1 = scales[0], s_ssim = scales[1], s_grad = scales[2];
    // sign q[x], q[x] = (t[x+1]-t[x]) - (p[x+1]-p[x]), at x = xs-1+j, 0
    // where x+1 lies outside: the forward term of x, the backward one of x+1
    float sx[RB + 1];
#pragma unroll
    for (int j = 0; j <= RB; ++j) {
        const int x = xs - 1 + j;
        sx[j] = x >= 0 && x + 1 < W
                    ? sgn(__fsub_rn(__fsub_rn(trow[j + 1], trow[j]),
                                    __fsub_rn(prow[j + 1], prow[j])))
                    : 0.0f;
    }
    float g[3][RB];
#pragma unroll
    for (int m = 0; m < 3; ++m)
        row_taps<RB>(taps, sums + (m * TH + r) * CS + c0, g[m]);
#pragma unroll
    for (int j = 0; j < RB; ++j) {
        const float* pr = prow + j + 1;
        const float* tr = trow + j + 1;
        const float p = pr[0], t = tr[0];
        float d = __fmul_rn(s_l1, sgn(__fsub_rn(p, t)));
        // d/dp[x] = sign q[x] - sign q[x-1], along x and along y
        d = __fadd_rn(d, __fmul_rn(s_grad, __fsub_rn(sx[j + 1], sx[j])));
        float fwd = 0.0f, back = 0.0f;
        if (y + 1 < H)
            fwd = sgn(__fsub_rn(__fsub_rn(tr[QS], t), __fsub_rn(pr[QS], p)));
        if (y > 0)
            back = sgn(__fsub_rn(__fsub_rn(t, tr[-QS]), __fsub_rn(p, pr[-QS])));
        d = __fadd_rn(d, __fmul_rn(s_grad, __fsub_rn(fwd, back)));
        // g0 + g1*2*p + g2*t
        const float adj = __fadd_rn(
            __fadd_rn(g[0][j], __fmul_rn(__fmul_rn(g[1][j], 2.0f), p)),
            __fmul_rn(g[2][j], t));
        out[r * OS + c0 + j] = __fadd_rn(d, __fmul_rn(s_ssim, adj));
    }
}

__global__ void __launch_bounds__(NT, 2)
bwd_kernel(const float* __restrict__ pred, const float* __restrict__ tgt,
           const float* __restrict__ scales, float* __restrict__ dout, int H,
           int W, float c1, float c2, Taps taps) {
    extern __shared__ __align__(16) float smem[];
    float* region1 = smem;
    float* region2 = smem + R1;

    const int b = blockIdx.z;
    const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const size_t img = (size_t)b * H * W;
    const bool vec = (W & 3) == 0 &&
        ((reinterpret_cast<size_t>(pred) | reinterpret_cast<size_t>(tgt) |
          reinterpret_cast<size_t>(dout)) & 15) == 0;
    const int tid = threadIdx.x;

    // 0. p, t with a 10-pixel halo into region 2
    float* sp = region2;
    float* st = region2 + SH * SWS;
    stage<SH, SWS, NT>(pred + img, tgt + img, H, W, y0 - 2 * HALF, x0 - 12,
                       vec, sp, st);
    __syncthreads();

    // A. the statistics down the columns into region 1
    for (int idx = tid; idx < (RH / RA) * CW; idx += NT)
        column_stats<RA, SWS, RH, AS>(taps, sp + SX, st + SX, region1,
                                      (idx / CW) * RA, idx % CW);
    __syncthreads();

    // B. along the rows, and the coefficient maps into region 2
    for (int idx = tid; idx < RH * (B_FULL + 1); idx += NT) {
        if (idx < RH * B_FULL)
            ring_maps<RB>(taps, region1, region2, idx % RH, (idx / RH) * RB,
                          H, W, y0, x0, c1, c2);
        else
            ring_maps<RB_LAST>(taps, region1, region2, idx - RH * B_FULL,
                               B_FULL * RB, H, W, y0, x0, c1, c2);
    }
    __syncthreads();

    // C. the adjoint down the columns into region 1; p and t of the tile and
    // a 1-pixel ring beside it (loaded before the column pass, stored after)
    float* qp = region1 + RING;
    float* qt = qp + QH * QS;
    float ring_p[Q_TRIPS], ring_t[Q_TRIPS];
#pragma unroll
    for (int k = 0; k < Q_TRIPS; ++k) {
        const int idx = tid + k * NT, rq = idx / QW;
        const int y = y0 - 1 + rq, x = x0 - 1 + (idx - rq * QW);
        const bool in = idx < QH * QW && y >= 0 && y < H && x >= 0 && x < W;
        ring_p[k] = in ? pred[img + (size_t)y * W + x] : 0.0f;
        ring_t[k] = in ? tgt[img + (size_t)y * W + x] : 0.0f;
    }
    if (tid < C_STRIPS * RW)
        column_adjoint(taps, region2, region1, (tid / RW) * RC, tid % RW);
#pragma unroll
    for (int k = 0; k < Q_TRIPS; ++k) {
        const int idx = tid + k * NT, rq = idx / QW;
        if (idx < QH * QW) {
            qp[rq * QS + idx - rq * QW] = ring_p[k];
            qt[rq * QS + idx - rq * QW] = ring_t[k];
        }
    }
    __syncthreads();

    // D. along the rows, the sign terms, dL/dp into region 2
    if (tid < (TW / RB) * TH)
        out_tile(taps, region1, qp, qt, region2, scales, tid % TH,
                 (tid / TH) * RB, y0, x0, H, W);
    __syncthreads();

    // the tile's outputs to device memory, consecutive threads on
    // consecutive 16-byte pieces of a row
    constexpr int P4 = TW / 4;
    for (int idx = tid; idx < TH * P4; idx += NT) {
        const int ro = idx / P4, x = x0 + 4 * (idx - ro * P4);
        const int yo = y0 + ro;
        if (yo >= H) continue;
        const float* o = region2 + ro * OS + 4 * (idx - ro * P4);
        float* dst = dout + img + (size_t)yo * W + x;
        if (vec && x + 4 <= W) {
            *reinterpret_cast<float4*>(dst) =
                make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (x + e < W) dst[e] = o[e];
        }
    }
}

}  // namespace bwd

Taps make_taps(const float* g) {
    Taps t;
    for (int k = 0; k < WS; ++k) t.g[k] = g[k];
    return t;
}

}  // namespace

// The forward's output tile, rows and columns, into tile[0..1], so the
// wrapper can size the scratch. Returns 0.
extern "C" int fused_loss_fwd_tile(int* tile) {
    tile[0] = fwd::TH;
    tile[1] = fwd::TW;
    return 0;
}

// pred, tgt: [B,H,W] float32 contiguous. scratch: scratch_words 32-bit
// words, at least B * blocks * 3 + B with blocks = ceil(H/40) * ceil(W/64):
// each block's three sums, then one ticket counter an image (zeroed here on
// the stream). out: [B,3]. taps: 11 host floats. One kernel. Returns the
// CUDA error of the memset or the launch (0 on success).
extern "C" int fused_loss_fwd(const void* pred, const void* tgt,
                              void* scratch, void* out, int B, int H, int W,
                              int scratch_words, float c1, float c2,
                              const float* taps, void* stream) {
    const dim3 grid((W + fwd::TW - 1) / fwd::TW, (H + fwd::TH - 1) / fwd::TH,
                    B);
    const long long sums = 3LL * B * grid.x * grid.y;
    if (scratch_words < sums + B)
        return static_cast<int>(cudaErrorInvalidValue);
    float* partials = static_cast<float*>(scratch);
    unsigned* count = reinterpret_cast<unsigned*>(partials + sums);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaFuncSetAttribute(
        fwd::fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fwd::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemsetAsync(count, 0, B * sizeof(unsigned), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    fwd::fwd_kernel<<<grid, fwd::NT, fwd::SMEM_BYTES, s>>>(
        static_cast<const float*>(pred), static_cast<const float*>(tgt),
        partials, count, static_cast<float*>(out), H, W, c1, c2,
        make_taps(taps));
    return static_cast<int>(cudaGetLastError());
}

// scales: 3 device floats (L1, SSIM, gradient). dout: [B,H,W]. taps: 11 host
// floats. One kernel, no scratch. Returns the CUDA error of the launch (0 on
// success).
extern "C" int fused_loss_bwd(const void* pred, const void* tgt,
                              const void* scales, void* dout, int B, int H,
                              int W, float c1, float c2, const float* taps,
                              void* stream) {
    const cudaError_t attr = cudaFuncSetAttribute(
        bwd::bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bwd::SMEM_BYTES);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((W + bwd::TW - 1) / bwd::TW, (H + bwd::TH - 1) / bwd::TH,
                    B);
    bwd::bwd_kernel<<<grid, bwd::NT, bwd::SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pred), static_cast<const float*>(tgt),
        static_cast<const float*>(scales), static_cast<float*>(dout), H, W, c1,
        c2, make_taps(taps));
    return static_cast<int>(cudaGetLastError());
}
