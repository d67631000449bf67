// Fused root-recipe loss for Hopper (sm_90a): forward partial sums and the
// analytic backward of ssim_weight * mean(clip((1 - SSIM) / 2, 0, 1)) +
// l1_weight * mean|p - t|, float32 throughout.
//
// Replaces the two Pallas TPU kernels of tpudepth/ops/pallas/fused_root_loss.py:
//   fused_root_loss_fwd  <-  _fused_partials (:148)  per image: the sum of
//       the clipped SSIM loss map (monodepth2: ReflectionPad(1) and a 3x3
//       average pool over p, t, p^2, t^2, pt) and the sum of |p - t|;
//   fused_root_loss_bwd  <-  the pallas_call of _frl_bwd (:189)  dL/dp: the
//       L1 sign term and the SSIM adjoint (the adjoint 3x3 box, reflection
//       folded, of the three per-pixel gated coefficient maps Cmu1, Ce11,
//       Ce12), scaled by scales = [s_ssim, s_l1].
//
// Same arithmetic as the Pallas kernels, in this order (the plain versions
// in ops/kernels/fused_root_loss.py repeat it op for op):
//   * box: down the columns ((x[y-1] + x[y]) + x[y+1]) * third, then along
//     the rows the same, each with the reflected neighbour at the border;
//   * adjoint box: along the rows first, ((s[x-1] + s[x]) + s[x+1]) * third
//     with zeros outside, then s[0] * third added at x = 1 and s[W-1] *
//     third at x = W-2 (the reflection's transpose); then down the columns
//     the same;
//   * every formula without contraction (the __f*_rn intrinsics), so with
//     equal inputs the per-pixel maps are the plain version's bit for bit;
//     only the sums over pixels take another order.
//
// The TPU kernels hold one whole image in VMEM per grid step. Here the
// image is cut into 32x32 output tiles; a block stages its tile of p and t
// with a 1-pixel reflected halo in shared memory.
//
// Forward: every block writes its two sums to tile_partials[B][tiles][2]; a
// second small kernel adds each image's tiles in a fixed order, so the loss
// repeats bit for bit from run to run (no atomics).
//
// Backward: two kernels with three maps through device memory. The first
// recomputes the statistics per tile and writes the gated coefficient maps
// for the pixels of the image; the second stages them with a 1-pixel halo
// that is zero outside the image, runs the adjoint box and adds the L1 sign
// term. One kernel would need a 2-pixel halo of recomputed statistics; the
// three maps cost 2 x 3 x B*H*W*4 bytes of traffic (59 MB at B 8, 480x640)
// that the TPU kernel keeps on the chip.
//
// What bounds it: the forward reads 2*B*H*W*4 bytes and does about 58 float
// operations per pixel, the backward reads 2 and writes 1 such plane and
// does about 95: at 3.35 TB/s and 67 TFLOP/s (float32 outside the tensor
// cores) both are bound by bytes.
//
// sign(0) is 0, as in jnp.sign. H and W must be at least 2.

#include <cuda_runtime.h>

namespace {
namespace rootloss {

constexpr int TH = 32;               // output tile
constexpr int TW = 32;
constexpr int PH = TH + 2;           // staged tile with a 1-pixel halo
constexpr int PW = TW + 2;
constexpr int PWS = PW + 1;          // row stride in shared memory
constexpr int NT = 256;              // threads per block
constexpr int PER_THREAD = TH * TW / NT;
constexpr float THIRD = 1.0f / 3.0f;

__device__ __forceinline__ float sgn(float v) {
    return static_cast<float>((v > 0.0f) - (v < 0.0f));
}

// ReflectionPad(1) index of i in [-1, n]
__device__ __forceinline__ int reflect(int i, int n) {
    return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ float sum3(float a, float b, float c) {
    return __fmul_rn(__fadd_rn(__fadd_rn(a, b), c), THIRD);
}

// Stage a PH x PW window of one image whose interior starts at (y0, x0),
// the halo reflected at the image's border; rows and columns further out
// (past a partial tile) are 0 and feed no output.
__device__ __forceinline__ void stage_reflect(const float* __restrict__ img,
                                              int H, int W, int y0, int x0,
                                              float (*dst)[PWS]) {
    for (int idx = threadIdx.x; idx < PH * PW; idx += NT) {
        const int r = idx / PW, c = idx - r * PW;
        const int y = y0 - 1 + r, x = x0 - 1 + c;
        float v = 0.0f;
        if (y <= H && x <= W)
            v = img[(size_t)reflect(y, H) * W + reflect(x, W)];
        dst[r][c] = v;
    }
}

// Stage a PH x PW window, zero outside the image.
__device__ __forceinline__ void stage_zero(const float* __restrict__ img,
                                           int H, int W, int y0, int x0,
                                           float (*dst)[PWS]) {
    for (int idx = threadIdx.x; idx < PH * PW; idx += NT) {
        const int r = idx / PW, c = idx - r * PW;
        const int y = y0 - 1 + r, x = x0 - 1 + c;
        float v = 0.0f;
        if (y >= 0 && y < H && x >= 0 && x < W) v = img[(size_t)y * W + x];
        dst[r][c] = v;
    }
}

// Column pass of the five maps p, t, p*p, t*t, p*t over the staged tile:
// col[m][r][c] for r < TH, c < PW.
__device__ __forceinline__ void column_pass5(float (*sp)[PWS],
                                             float (*st)[PWS],
                                             float (*col)[TH][PWS]) {
    for (int idx = threadIdx.x; idx < TH * PW; idx += NT) {
        const int r = idx / PW, c = idx - r * PW;
        const float p0 = sp[r][c], p1 = sp[r + 1][c], p2 = sp[r + 2][c];
        const float t0 = st[r][c], t1 = st[r + 1][c], t2 = st[r + 2][c];
        col[0][r][c] = sum3(p0, p1, p2);
        col[1][r][c] = sum3(t0, t1, t2);
        col[2][r][c] = sum3(__fmul_rn(p0, p0), __fmul_rn(p1, p1),
                            __fmul_rn(p2, p2));
        col[3][r][c] = sum3(__fmul_rn(t0, t0), __fmul_rn(t1, t1),
                            __fmul_rn(t2, t2));
        col[4][r][c] = sum3(__fmul_rn(p0, t0), __fmul_rn(p1, t1),
                            __fmul_rn(p2, t2));
    }
}

// Row pass of map m at interior pixel (r, c).
__device__ __forceinline__ float row_pass(float (*col)[PWS], int r, int c) {
    return sum3(col[r][c], col[r][c + 1], col[r][c + 2]);
}

// The SSIM terms of one pixel from its five statistics (JAX's _stats).
struct Ssim {
    float m1, m2, n1, d1, n2, d2;
};

__device__ __forceinline__ Ssim ssim_terms(float (*col)[TH][PWS], int r,
                                           int c, float c1, float c2) {
    Ssim s;
    const float m1 = row_pass(col[0], r, c);
    const float m2 = row_pass(col[1], r, c);
    const float e11 = row_pass(col[2], r, c);
    const float e22 = row_pass(col[3], r, c);
    const float e12 = row_pass(col[4], r, c);
    const float m11 = __fmul_rn(m1, m1);
    const float m22 = __fmul_rn(m2, m2);
    const float s11 = __fsub_rn(e11, m11);
    const float s22 = __fsub_rn(e22, m22);
    const float s12 = __fsub_rn(e12, __fmul_rn(m1, m2));
    s.m1 = m1;
    s.m2 = m2;
    s.n1 = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, m1), m2), c1);
    s.d1 = __fadd_rn(__fadd_rn(m11, m22), c1);
    s.n2 = __fadd_rn(__fmul_rn(2.0f, s12), c2);
    s.d2 = __fadd_rn(__fadd_rn(s11, s22), c2);
    return s;
}

// Sum two per-thread values over the block; thread 0 holds the result.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
    __shared__ float red[2][NT / 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        red[0][warp] = a;
        red[1][warp] = b;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        a = red[0][0];
        b = red[1][0];
        for (int w = 1; w < NT / 32; ++w) {
            a += red[0][w];
            b += red[1][w];
        }
    }
}

__global__ void __launch_bounds__(NT)
fwd_tiles_kernel(const float* __restrict__ pred, const float* __restrict__ tgt,
                 float* __restrict__ tile_partials, int H, int W, float c1,
                 float c2) {
    __shared__ float sp[PH][PWS];
    __shared__ float st[PH][PWS];
    __shared__ float col[5][TH][PWS];

    const int b = blockIdx.z;
    const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const size_t img = (size_t)b * H * W;
    stage_reflect(pred + img, H, W, y0, x0, sp);
    stage_reflect(tgt + img, H, W, y0, x0, st);
    __syncthreads();
    column_pass5(sp, st, col);
    __syncthreads();

    float ss = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int n = 0; n < PER_THREAD; ++n) {
        const int idx = threadIdx.x + n * NT;
        const int r = idx / TW, c = idx - r * TW;
        if (y0 + r >= H || x0 + c >= W) continue;
        const Ssim s = ssim_terms(col, r, c, c1, c2);
        const float map = __fdiv_rn(__fmul_rn(s.n1, s.n2),
                                    __fmul_rn(s.d1, s.d2));
        const float pre = __fmul_rn(__fsub_rn(1.0f, map), 0.5f);
        ss += fminf(fmaxf(pre, 0.0f), 1.0f);
        l1 += fabsf(__fsub_rn(sp[r + 1][c + 1], st[r + 1][c + 1]));
    }
    block_sum2(ss, l1);
    if (threadIdx.x == 0) {
        const size_t tile = (size_t)b * gridDim.y * gridDim.x
                            + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
        tile_partials[tile * 2 + 0] = ss;
        tile_partials[tile * 2 + 1] = l1;
    }
}

// out[b][k] = sum over the image's tiles, each thread over a fixed stride and
// the block in a fixed tree: the same bits on every run.
__global__ void __launch_bounds__(NT)
fwd_reduce_kernel(const float* __restrict__ tile_partials,
                  float* __restrict__ out, int tiles) {
    const int b = blockIdx.x;
    const float* src = tile_partials + (size_t)b * tiles * 2;
    float a0 = 0.0f, a1 = 0.0f;
    for (int i = threadIdx.x; i < tiles; i += NT) {
        a0 += src[i * 2 + 0];
        a1 += src[i * 2 + 1];
    }
    block_sum2(a0, a1);
    if (threadIdx.x == 0) {
        out[b * 2 + 0] = a0;
        out[b * 2 + 1] = a1;
    }
}

// Backward, first kernel: the gated coefficient maps on the pixels of the
// image. coef is [3][B][H][W].
__global__ void __launch_bounds__(NT)
bwd_coef_kernel(const float* __restrict__ pred, const float* __restrict__ tgt,
                const float* __restrict__ scales, float* __restrict__ coef,
                int B, int H, int W, float c1, float c2) {
    __shared__ float sp[PH][PWS];
    __shared__ float st[PH][PWS];
    __shared__ float col[5][TH][PWS];

    const int b = blockIdx.z;
    const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const size_t img = (size_t)b * H * W;
    const size_t plane = (size_t)B * H * W;
    stage_reflect(pred + img, H, W, y0, x0, sp);
    stage_reflect(tgt + img, H, W, y0, x0, st);
    __syncthreads();
    column_pass5(sp, st, col);
    __syncthreads();

    const float s_ssim = scales[0];
#pragma unroll
    for (int n = 0; n < PER_THREAD; ++n) {
        const int idx = threadIdx.x + n * NT;
        const int r = idx / TW, c = idx - r * TW;
        const int y = y0 + r, x = x0 + c;
        if (y >= H || x >= W) continue;
        const Ssim s = ssim_terms(col, r, c, c1, c2);
        // R = 1/(D1*D2), M = N1*N2*R; d clip((1-M)/2, 0, 1)/dM = -1/2
        // strictly inside the clip, else 0
        const float rr = __fdiv_rn(1.0f, __fmul_rn(s.d1, s.d2));
        const float m = __fmul_rn(__fmul_rn(s.n1, s.n2), rr);
        const float pre = __fmul_rn(__fsub_rn(1.0f, m), 0.5f);
        const float gate = __fmul_rn((pre > 0.0f && pre < 1.0f) ? -0.5f : 0.0f,
                                     s_ssim);
        // Cmu1 = 2*mu2*R*(N2 - N1) - 2*mu1*M*(1/D1 - 1/D2)
        const float ta = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, s.m2), rr),
                                   __fsub_rn(s.n2, s.n1));
        const float tb = __fmul_rn(
            __fmul_rn(__fmul_rn(2.0f, s.m1), m),
            __fsub_rn(__fdiv_rn(1.0f, s.d1), __fdiv_rn(1.0f, s.d2)));
        const size_t at = img + (size_t)y * W + x;
        coef[at] = __fmul_rn(gate, __fsub_rn(ta, tb));
        coef[plane + at] = __fmul_rn(gate, __fdiv_rn(-m, s.d2));            // Ce11
        coef[2 * plane + at] = __fmul_rn(
            gate, __fmul_rn(__fmul_rn(2.0f, s.n1), rr));                    // Ce12
    }
}

// Backward, second kernel: the adjoint box of the three coefficient maps
// (zero outside the image, the reflection folded back at rows / columns 1
// and n-2), then the sum with the L1 sign term.
__global__ void __launch_bounds__(NT)
bwd_out_kernel(const float* __restrict__ pred, const float* __restrict__ tgt,
               const float* __restrict__ coef,
               const float* __restrict__ scales, float* __restrict__ dout,
               int B, int H, int W) {
    __shared__ float sc[3][PH][PWS];
    __shared__ float rw[3][PH][TW + 1];   // after the row pass

    const int b = blockIdx.z;
    const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const size_t img = (size_t)b * H * W;
    const size_t plane = (size_t)B * H * W;
    for (int m = 0; m < 3; ++m)
        stage_zero(coef + m * plane + img, H, W, y0, x0, sc[m]);
    __syncthreads();
    // along the rows, on every staged row (rows outside the image are 0)
    for (int idx = threadIdx.x; idx < PH * TW; idx += NT) {
        const int r = idx / TW, c = idx - r * TW;
        const int x = x0 + c;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            float a = sum3(sc[m][r][c], sc[m][r][c + 1], sc[m][r][c + 2]);
            if (x == 1) a = __fadd_rn(a, __fmul_rn(sc[m][r][c], THIRD));
            if (x == W - 2) a = __fadd_rn(a, __fmul_rn(sc[m][r][c + 2], THIRD));
            rw[m][r][c] = a;
        }
    }
    __syncthreads();

    const float s_l1 = scales[1];
#pragma unroll
    for (int n = 0; n < PER_THREAD; ++n) {
        const int idx = threadIdx.x + n * NT;
        const int r = idx / TW, c = idx - r * TW;
        const int y = y0 + r, x = x0 + c;
        if (y >= H || x >= W) continue;
        float g[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            float a = sum3(rw[m][r][c], rw[m][r + 1][c], rw[m][r + 2][c]);
            if (y == 1) a = __fadd_rn(a, __fmul_rn(rw[m][r][c], THIRD));
            if (y == H - 2) a = __fadd_rn(a, __fmul_rn(rw[m][r + 2][c], THIRD));
            g[m] = a;
        }
        const size_t at = img + (size_t)y * W + x;
        const float p = pred[at], t = tgt[at];
        // ((d + g0) + (g1*2)*p) + g2*t, d = s_l1 * sign(p - t)
        float d = __fmul_rn(s_l1, sgn(__fsub_rn(p, t)));
        d = __fadd_rn(d, g[0]);
        d = __fadd_rn(d, __fmul_rn(__fmul_rn(g[1], 2.0f), p));
        dout[at] = __fadd_rn(d, __fmul_rn(g[2], t));
    }
}

}  // namespace rootloss
}  // namespace

extern "C" {

// The tile edge, so the wrapper can size tile_partials.
int fused_root_loss_tile() { return rootloss::TH; }

// pred, tgt: [B,H,W] float32 contiguous, H, W >= 2. tile_partials:
// [B, tiles, 2] scratch with tiles = ceil(H/32)*ceil(W/32). out: [B,2]
// (sum of the clipped SSIM loss map, sum |p-t|). Returns the CUDA error of
// the launches (0 on success).
int fused_root_loss_fwd(const void* pred, const void* tgt, void* tile_partials,
                        void* out, int B, int H, int W, float c1, float c2,
                        void* stream) {
    using namespace rootloss;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    fwd_tiles_kernel<<<grid, NT, 0, s>>>(
        static_cast<const float*>(pred), static_cast<const float*>(tgt),
        static_cast<float*>(tile_partials), H, W, c1, c2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fwd_reduce_kernel<<<B, NT, 0, s>>>(
        static_cast<const float*>(tile_partials), static_cast<float*>(out),
        static_cast<int>(grid.x * grid.y));
    return static_cast<int>(cudaGetLastError());
}

// scales: 2 device floats (SSIM, L1 factors of dL/dp). coef: [3,B,H,W]
// scratch. dout: [B,H,W].
int fused_root_loss_bwd(const void* pred, const void* tgt, const void* scales,
                        void* coef, void* dout, int B, int H, int W, float c1,
                        float c2, void* stream) {
    using namespace rootloss;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    bwd_coef_kernel<<<grid, NT, 0, s>>>(
        static_cast<const float*>(pred), static_cast<const float*>(tgt),
        static_cast<const float*>(scales), static_cast<float*>(coef), B, H, W,
        c1, c2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_out_kernel<<<grid, NT, 0, s>>>(
        static_cast<const float*>(pred), static_cast<const float*>(tgt),
        static_cast<const float*>(coef), static_cast<const float*>(scales),
        static_cast<float*>(dout), B, H, W);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
