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
// The TPU kernels hold one whole image (~14 float32 buffers) in VMEM per grid
// step. A block here has 227 KB of shared memory at most, so the image is cut
// into 32x32 output tiles. A block stages its tile of p and t with a 5-pixel
// halo (zero outside the image), forms the five products after the zero fill
// (so they are zero outside too), runs the gaussian down the columns and then
// along the rows through shared memory, and finishes on the tile's interior.
//
// Forward: every block writes its three sums to tile_partials[B][tiles][3];
// a second small kernel adds each image's tiles in a fixed order, so the loss
// repeats bit for bit from run to run (no atomics).
//
// Backward: two kernels with three maps through device memory. The first
// recomputes the statistics per tile and writes Cmu1, Ce11, Ce12 for the
// pixels of the image; the second stages those maps with a 5-pixel halo that
// is ZERO outside the image (the adjoint convolution is zero-padded too: the
// formulas do not give zero for p = t = 0 there), runs the gaussian over them
// and adds the L1 and forward-difference sign terms. The alternative, one
// kernel with a 10-pixel halo, recomputes the five statistics on 1.7x the
// pixels; three maps through device memory cost 59 MB of traffic at B 8,
// 480x640 and keep both kernels at a 5-pixel halo.
//
// What bounds it: the forward reads 2*B*H*W*4 bytes and does about 250 float
// operations per pixel (22 multiply-adds for each of 5 maps, plus the
// pointwise formulas); the backward reads the same, writes B*H*W*4 and does
// about 410 (8 maps). On the CUDA cores (67 TFLOP/s in float32; there is no
// tensor-core form of a shifted-window sum) the operations take longer than
// the bytes at 3.35 TB/s, so both directions are bound by operations: 0.0092
// and 0.0151 ms at B 8, 480x640. Every multiply-add of the two passes takes
// one shared-memory load, and an SM loads 32 floats per clock against 128
// multiply-adds, which holds this layout to a quarter of that peak at best;
// on an H100 80GB HBM3 at 700 W it takes 0.052 ms forward and 0.120 ms
// backward (17 % and 13 % of the bound). Keeping a column of taps in
// registers across neighbouring outputs is the next step.
//
// The gaussian taps use fused multiply-adds; every formula after them (SSIM
// map, coefficients, the final sum) uses the non-contracting intrinsics, so
// that with equal statistics it is bit-equal to the plain PyTorch version,
// and pred == target gives an SSIM of exactly 1.
//
// sign(0) is 0, as in jnp.sign. The forward-difference terms leave out the
// last column (x) and the last row (y).

#include <cuda_runtime.h>

namespace {

constexpr int WS = 11;
constexpr int HALF = WS / 2;
constexpr int TH = 32;               // output tile
constexpr int TW = 32;
constexpr int PH = TH + 2 * HALF;    // staged tile with halo
constexpr int PW = TW + 2 * HALF;
constexpr int PWS = PW + 1;          // row stride in shared memory
constexpr int NT = 256;              // threads per block
constexpr int PER_THREAD = TH * TW / NT;

struct Taps {
    float g[WS];
};

__device__ __forceinline__ float sgn(float v) {
    return static_cast<float>((v > 0.0f) - (v < 0.0f));
}

// Stage a PH x PW window of one image whose interior starts at (y0, x0);
// pixels outside the image are 0.
__device__ __forceinline__ void stage_tile(const float* __restrict__ img,
                                           int H, int W, int y0, int x0,
                                           float (*dst)[PWS]) {
    for (int idx = threadIdx.x; idx < PH * PW; idx += NT) {
        const int r = idx / PW, c = idx - r * PW;
        const int y = y0 - HALF + r, x = x0 - HALF + c;
        float v = 0.0f;
        if (y >= 0 && y < H && x >= 0 && x < W) v = img[(size_t)y * W + x];
        dst[r][c] = v;
    }
}

// Column pass (along H) of the five maps p, t, p*p, t*t, p*t over the staged
// tile: col[m][r][c] for r < TH, c < PW. The sum starts with tap 0 and adds
// taps 1..10 in order, as the plain version does.
__device__ __forceinline__ void column_pass5(const Taps& taps,
                                             float (*sp)[PWS],
                                             float (*st)[PWS],
                                             float (*col)[TH][PWS]) {
    for (int idx = threadIdx.x; idx < TH * PW; idx += NT) {
        const int r = idx / PW, c = idx - r * PW;
        float p = sp[r][c], t = st[r][c];
        float a0 = __fmul_rn(taps.g[0], p);
        float a1 = __fmul_rn(taps.g[0], t);
        float a2 = __fmul_rn(taps.g[0], __fmul_rn(p, p));
        float a3 = __fmul_rn(taps.g[0], __fmul_rn(t, t));
        float a4 = __fmul_rn(taps.g[0], __fmul_rn(p, t));
#pragma unroll
        for (int k = 1; k < WS; ++k) {
            p = sp[r + k][c];
            t = st[r + k][c];
            a0 = fmaf(taps.g[k], p, a0);
            a1 = fmaf(taps.g[k], t, a1);
            a2 = fmaf(taps.g[k], __fmul_rn(p, p), a2);
            a3 = fmaf(taps.g[k], __fmul_rn(t, t), a3);
            a4 = fmaf(taps.g[k], __fmul_rn(p, t), a4);
        }
        col[0][r][c] = a0;
        col[1][r][c] = a1;
        col[2][r][c] = a2;
        col[3][r][c] = a3;
        col[4][r][c] = a4;
    }
}

// Row pass (along W) of map m at interior pixel (r, c).
__device__ __forceinline__ float row_pass(const Taps& taps,
                                          float (*col)[PWS],
                                          int r, int c) {
    float a = __fmul_rn(taps.g[0], col[r][c]);
#pragma unroll
    for (int k = 1; k < WS; ++k) a = fmaf(taps.g[k], col[r][c + k], a);
    return a;
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

// Sum three per-thread values over the block; thread 0 holds the result.
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

__global__ void __launch_bounds__(NT)
fwd_tiles_kernel(const float* __restrict__ pred, const float* __restrict__ tgt,
                 float* __restrict__ tile_partials, int H, int W, float c1,
                 float c2, Taps taps) {
    __shared__ float sp[PH][PWS];
    __shared__ float st[PH][PWS];
    __shared__ float col[5][TH][PWS];

    const int b = blockIdx.z;
    const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const size_t img = (size_t)b * H * W;
    stage_tile(pred + img, H, W, y0, x0, sp);
    stage_tile(tgt + img, H, W, y0, x0, st);
    __syncthreads();
    column_pass5(taps, sp, st, col);
    __syncthreads();

    float l1 = 0.0f, ss = 0.0f, gr = 0.0f;
#pragma unroll
    for (int n = 0; n < PER_THREAD; ++n) {
        const int idx = threadIdx.x + n * NT;
        const int r = idx / TW, c = idx - r * TW;
        const int y = y0 + r, x = x0 + c;
        if (y >= H || x >= W) continue;
        const float mu1 = row_pass(taps, col[0], r, c);
        const float mu2 = row_pass(taps, col[1], r, c);
        const float e11 = row_pass(taps, col[2], r, c);
        const float e22 = row_pass(taps, col[3], r, c);
        const float e12 = row_pass(taps, col[4], r, c);
        const Ssim s = ssim_terms(mu1, mu2, e11, e22, e12, c1, c2);
        ss += __fdiv_rn(__fmul_rn(s.n1, s.n2), __fmul_rn(s.d1, s.d2));

        const float p = sp[r + HALF][c + HALF], t = st[r + HALF][c + HALF];
        l1 += fabsf(__fsub_rn(p, t));
        if (x + 1 < W) {
            const float dt = __fsub_rn(st[r + HALF][c + HALF + 1], t);
            const float dp = __fsub_rn(sp[r + HALF][c + HALF + 1], p);
            gr += fabsf(__fsub_rn(dt, dp));
        }
        if (y + 1 < H) {
            const float dt = __fsub_rn(st[r + HALF + 1][c + HALF], t);
            const float dp = __fsub_rn(sp[r + HALF + 1][c + HALF], p);
            gr += fabsf(__fsub_rn(dt, dp));
        }
    }
    block_sum3(l1, ss, gr);
    if (threadIdx.x == 0) {
        const size_t tile = (size_t)b * gridDim.y * gridDim.x
                            + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
        tile_partials[tile * 3 + 0] = l1;
        tile_partials[tile * 3 + 1] = ss;
        tile_partials[tile * 3 + 2] = gr;
    }
}

// out[b][k] = sum over the image's tiles, each thread over a fixed stride and
// the block in a fixed tree: the same bits on every run.
__global__ void __launch_bounds__(NT)
fwd_reduce_kernel(const float* __restrict__ tile_partials,
                  float* __restrict__ out, int tiles) {
    const int b = blockIdx.x;
    const float* src = tile_partials + (size_t)b * tiles * 3;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int i = threadIdx.x; i < tiles; i += NT) {
        a0 += src[i * 3 + 0];
        a1 += src[i * 3 + 1];
        a2 += src[i * 3 + 2];
    }
    block_sum3(a0, a1, a2);
    if (threadIdx.x == 0) {
        out[b * 3 + 0] = a0;
        out[b * 3 + 1] = a1;
        out[b * 3 + 2] = a2;
    }
}

// Backward, first kernel: the coefficient maps on the pixels of the image.
// coef is [3][B][H][W].
__global__ void __launch_bounds__(NT)
bwd_coef_kernel(const float* __restrict__ pred, const float* __restrict__ tgt,
                float* __restrict__ coef, int B, int H, int W, float c1,
                float c2, Taps taps) {
    __shared__ float sp[PH][PWS];
    __shared__ float st[PH][PWS];
    __shared__ float col[5][TH][PWS];

    const int b = blockIdx.z;
    const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const size_t img = (size_t)b * H * W;
    const size_t plane = (size_t)B * H * W;
    stage_tile(pred + img, H, W, y0, x0, sp);
    stage_tile(tgt + img, H, W, y0, x0, st);
    __syncthreads();
    column_pass5(taps, sp, st, col);
    __syncthreads();

#pragma unroll
    for (int n = 0; n < PER_THREAD; ++n) {
        const int idx = threadIdx.x + n * NT;
        const int r = idx / TW, c = idx - r * TW;
        const int y = y0 + r, x = x0 + c;
        if (y >= H || x >= W) continue;
        const float mu1 = row_pass(taps, col[0], r, c);
        const float mu2 = row_pass(taps, col[1], r, c);
        const float e11 = row_pass(taps, col[2], r, c);
        const float e22 = row_pass(taps, col[3], r, c);
        const float e12 = row_pass(taps, col[4], r, c);
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
        const size_t at = img + (size_t)y * W + x;
        coef[at] = __fsub_rn(ta, tb);
        coef[plane + at] = __fdiv_rn(-m, s.d2);                 // Ce11
        coef[2 * plane + at] = __fmul_rn(__fmul_rn(2.0f, s.n1), rr);  // Ce12
    }
}

// Backward, second kernel: gaussian of the three coefficient maps (zero
// outside the image), then the sum with the L1 and forward-difference terms.
__global__ void __launch_bounds__(NT)
bwd_out_kernel(const float* __restrict__ pred, const float* __restrict__ tgt,
               const float* __restrict__ coef,
               const float* __restrict__ scales, float* __restrict__ dout,
               int B, int H, int W, Taps taps) {
    __shared__ float sc[3][PH][PWS];
    __shared__ float col[3][TH][PWS];

    const int b = blockIdx.z;
    const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
    const size_t img = (size_t)b * H * W;
    const size_t plane = (size_t)B * H * W;
    for (int m = 0; m < 3; ++m)
        stage_tile(coef + m * plane + img, H, W, y0, x0, sc[m]);
    __syncthreads();
    for (int idx = threadIdx.x; idx < TH * PW; idx += NT) {
        const int r = idx / PW, c = idx - r * PW;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            float a = __fmul_rn(taps.g[0], sc[m][r][c]);
#pragma unroll
            for (int k = 1; k < WS; ++k) a = fmaf(taps.g[k], sc[m][r + k][c], a);
            col[m][r][c] = a;
        }
    }
    __syncthreads();

    const float s_l1 = scales[0], s_ssim = scales[1], s_grad = scales[2];
    const float* p_img = pred + img;
    const float* t_img = tgt + img;
#pragma unroll
    for (int n = 0; n < PER_THREAD; ++n) {
        const int idx = threadIdx.x + n * NT;
        const int r = idx / TW, c = idx - r * TW;
        const int y = y0 + r, x = x0 + c;
        if (y >= H || x >= W) continue;
        const size_t at = (size_t)y * W + x;
        const float p = p_img[at], t = t_img[at];

        float d = __fmul_rn(s_l1, sgn(__fsub_rn(p, t)));

        // q[x] = (t[x+1]-t[x]) - (p[x+1]-p[x]);  d/dp[x] = sign q[x] - sign q[x-1]
        float fwd = 0.0f, back = 0.0f;
        if (x + 1 < W)
            fwd = sgn(__fsub_rn(__fsub_rn(t_img[at + 1], t),
                                __fsub_rn(p_img[at + 1], p)));
        if (x > 0)
            back = sgn(__fsub_rn(__fsub_rn(t, t_img[at - 1]),
                                 __fsub_rn(p, p_img[at - 1])));
        d = __fadd_rn(d, __fmul_rn(s_grad, __fsub_rn(fwd, back)));
        fwd = 0.0f;
        back = 0.0f;
        if (y + 1 < H)
            fwd = sgn(__fsub_rn(__fsub_rn(t_img[at + W], t),
                                __fsub_rn(p_img[at + W], p)));
        if (y > 0)
            back = sgn(__fsub_rn(__fsub_rn(t, t_img[at - W]),
                                 __fsub_rn(p, p_img[at - W])));
        d = __fadd_rn(d, __fmul_rn(s_grad, __fsub_rn(fwd, back)));

        const float g0 = row_pass(taps, col[0], r, c);
        const float g1 = row_pass(taps, col[1], r, c);
        const float g2 = row_pass(taps, col[2], r, c);
        // g0 + g1*2*p + g2*t
        const float adj = __fadd_rn(
            __fadd_rn(g0, __fmul_rn(__fmul_rn(g1, 2.0f), p)),
            __fmul_rn(g2, t));
        dout[img + at] = __fadd_rn(d, __fmul_rn(s_ssim, adj));
    }
}

Taps make_taps(const float* g) {
    Taps t;
    for (int k = 0; k < WS; ++k) t.g[k] = g[k];
    return t;
}

}  // namespace

extern "C" {

// The tile edge, so the wrapper can size tile_partials.
int fused_loss_tile() { return TH; }

// pred, tgt: [B,H,W] float32 contiguous. tile_partials: [B, tiles, 3] scratch
// with tiles = ceil(H/32)*ceil(W/32). out: [B,3]. taps: 11 host floats.
// Returns the CUDA error of the launches (0 on success).
int fused_loss_fwd(const void* pred, const void* tgt, void* tile_partials,
                   void* out, int B, int H, int W, float c1, float c2,
                   const float* taps, void* stream) {
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    fwd_tiles_kernel<<<grid, NT, 0, s>>>(
        static_cast<const float*>(pred), static_cast<const float*>(tgt),
        static_cast<float*>(tile_partials), H, W, c1, c2, make_taps(taps));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fwd_reduce_kernel<<<B, NT, 0, s>>>(
        static_cast<const float*>(tile_partials), static_cast<float*>(out),
        static_cast<int>(grid.x * grid.y));
    return static_cast<int>(cudaGetLastError());
}

// coef: [3,B,H,W] scratch. scales: 3 device floats (L1, SSIM, gradient).
// dout: [B,H,W].
int fused_loss_bwd(const void* pred, const void* tgt, const void* scales,
                   void* coef, void* dout, int B, int H, int W, float c1,
                   float c2, const float* taps, void* stream) {
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Taps tp = make_taps(taps);
    bwd_coef_kernel<<<grid, NT, 0, s>>>(
        static_cast<const float*>(pred), static_cast<const float*>(tgt),
        static_cast<float*>(coef), B, H, W, c1, c2, tp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_out_kernel<<<grid, NT, 0, s>>>(
        static_cast<const float*>(pred), static_cast<const float*>(tgt),
        static_cast<const float*>(coef), static_cast<const float*>(scales),
        static_cast<float*>(dout), B, H, W, tp);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
