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
// What bounds it: the forward reads 2*B*H*W*4 bytes and does about 59 float
// operations per pixel, the backward reads 2 and writes 1 such plane and
// does about 99: at 3.35 TB/s and 67 TFLOP/s (float32 outside the tensor
// cores) both are bound by bytes (0.0059 and 0.0088 ms at B 8, 480x640).
//
// Forward: one kernel a call. The TPU kernel holds one whole image in VMEM
// per grid step; here a warp walks down a strip of 8 output rows and 62
// output columns (the backward's strip without its adjoint ring): each lane
// holds two neighbouring columns, from one left of the strip to one right
// of it, so the strip's lanes start at an even column and a row of p and t
// comes in as one 8-byte load a lane when W is even (strip k holds the
// columns 62k - 1 .. 62k + 60). A lane keeps the five maps of the last row
// and the sum of the last two rows' (the box's column pass is then one add
// and one multiply a map as a row comes in), takes the neighbours along a
// row from the next lanes by shuffles (the row pass), and sums the clipped
// SSIM loss map and |p - t| in registers: no shared memory and no barrier
// in the walk. The walk has a fixed length, unrolled: rows past the image
// and warps past the last strip are walked and not added, so no branch
// around the shuffles depends on the warp (a walk of variable length made
// the compiler reconverge the warp at every shuffle). A block of four warps
// takes four strips of one image, adds its lanes' sums in a fixed tree and
// writes them to partials[B][blocks][2]; then (__threadfence, a ticket from
// atomicAdd on the image's counter, which the C entry zeroes with
// cudaMemsetAsync on the launch stream) the image's last block adds its
// blocks' sums in block order and writes out[b]. The sums are those of
// fixed trees whichever block comes last, so the loss repeats bit for bit
// from run to run; no float atomics. At B 8, 480x640 the 1320 blocks of 48
// registers a thread are one wave of ten blocks an SM.
//
// Backward: one kernel, and the coefficient maps never leave the chip (the
// TPU kernel keeps them in VMEM; a two-kernel split writes three maps and
// reads them back with a halo, 11 planes of traffic where the function needs
// 3). A warp walks down a strip of 16 output rows and 60 output columns;
// each lane holds two neighbouring columns (from 2 left of the strip to 2
// right of it), so a row of p and t comes in as one 8-byte load a lane when
// W is even. Per row it keeps in registers p, t and their products on the
// last three rows (the box's column pass) and the adjoint's row pass on the
// last three rows (its column pass), each in a ring of three slots that the
// loop, unrolled by three, addresses by constants (no moves); the
// neighbours along a row come from the next lanes by shuffles (two a map
// and row). A row or column one step outside the image is the reflected
// one, as the statistics' ReflectionPad(1) wants; the coefficient maps are
// 0 outside the image, which the adjoint's folds at x = 1, W-2 and y = 1,
// H-2 read. The ring the strip recomputes is 4 of 64 columns and 2 of 18
// rows of statistics; there is no shared memory and no barrier, and the
// next row's loads start before the current row's arithmetic. The
// four IEEE divisions a pixel and the ~100 other operations then take
// longer than the bytes: the kernel is bound by its instructions.
//
// sign(0) is 0, as in jnp.sign. H and W must be at least 2.

#include <cuda_runtime.h>

namespace {
namespace rootloss {

constexpr float THIRD = 1.0f / 3.0f;

__device__ __forceinline__ float sgn(float v) {
    return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// ReflectionPad(1) index of i in [-1, n]
__device__ __forceinline__ int reflect(int i, int n) {
    return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ float sum3(float a, float b, float c) {
    return __fmul_rn(__fadd_rn(__fadd_rn(a, b), c), THIRD);
}

// The SSIM terms of one pixel from its five statistics (JAX's _stats).
struct Ssim {
    float m1, m2, n1, d1, n2, d2;
};

__device__ __forceinline__ Ssim ssim_of(float m1, float m2, float e11,
                                        float e22, float e12, float c1,
                                        float c2) {
    Ssim s;
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

// -- the warp strip of both directions ---------------------------------------

constexpr unsigned FULL = 0xffffffffu;

// Where a lane reads its two columns xa, xa + 1 (a strip's lanes start at
// an even column left of it): a column one step outside the image is the
// reflected one, as the statistics' ReflectionPad(1) wants; a column
// further out feeds only pixels outside the image (coefficient maps, which
// are 0, or losses that are not summed), so it reads any column of the
// image. With 8-byte rows (vec) one float2
// at the even column clamped into [0, W - 2] gives both: at xa = -2 its
// second column 1 = reflect(-1), at xa = W its first column W - 2 =
// reflect(W).
struct Columns {
    int v;        // the float2's column (vec)
    int a, b;     // the two columns' own (otherwise)
};

__device__ __forceinline__ Columns columns_of(int xa, int W) {
    Columns c;
    c.v = min(max(xa, 0), W - 2);
    c.a = reflect(min(max(xa, -1), W), W);
    c.b = reflect(min(max(xa + 1, -1), W), W);
    return c;
}

// One row of p or t at the lane's columns; rows further out than one step
// are as columns are.
__device__ __forceinline__ float2 load_pair(const float* __restrict__ img,
                                            int H, int W, int y,
                                            const Columns& c, bool vec) {
    const float* row = img + (size_t)reflect(min(max(y, -1), H), H) * W;
    if (vec) return *reinterpret_cast<const float2*>(row + c.v);
    return make_float2(row[c.a], row[c.b]);
}

// The five maps of one row at the lane's two columns.
struct Maps {
    float2 p, t, pp, tt, pt;
};

__device__ __forceinline__ Maps maps_of(float2 p, float2 t) {
    Maps m;
    m.p = p;
    m.t = t;
    m.pp = make_float2(__fmul_rn(p.x, p.x), __fmul_rn(p.y, p.y));
    m.tt = make_float2(__fmul_rn(t.x, t.x), __fmul_rn(t.y, t.y));
    m.pt = make_float2(__fmul_rn(p.x, t.x), __fmul_rn(p.y, t.y));
    return m;
}

__device__ __forceinline__ float2 sum3v(float2 a, float2 b, float2 c) {
    return make_float2(sum3(a.x, b.x, c.x), sum3(a.y, b.y, c.y));
}

// The box at the lane's two columns from the column pass v there: the
// neighbours along the row from the lanes beside it.
__device__ __forceinline__ float2 row_box(float2 v) {
    const float left = __shfl_up_sync(FULL, v.y, 1);
    const float right = __shfl_down_sync(FULL, v.x, 1);
    return make_float2(sum3(left, v.x, v.y), sum3(v.x, v.y, right));
}

// -- forward -----------------------------------------------------------------

constexpr int FWD_WARPS = 4;      // warps per block, each a strip of its own
constexpr int FWD_COLS = 62;      // output columns of a strip (64 held)
constexpr int FWD_ROWS = 8;       // output rows of a strip

// Sum two per-thread values over a block of FWD_WARPS warps in a fixed
// tree; thread 0 holds the result.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
    __shared__ float red[2][FWD_WARPS];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(FULL, a, off);
        b += __shfl_xor_sync(FULL, b, off);
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
        for (int w = 1; w < FWD_WARPS; ++w) {
            a += red[0][w];
            b += red[1][w];
        }
    }
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ Maps add_maps(const Maps& a, const Maps& b) {
    Maps m;
    m.p = add2(a.p, b.p);
    m.t = add2(a.t, b.t);
    m.pp = add2(a.pp, b.pp);
    m.tt = add2(a.tt, b.tt);
    m.pt = add2(a.pt, b.pt);
    return m;
}

// The box's column pass, ((x[y-1] + x[y]) + x[y+1]) * third, from the sum
// of the two rows above and the row below.
__device__ __forceinline__ float2 col3(float2 pair, float2 below) {
    return make_float2(__fmul_rn(__fadd_rn(pair.x, below.x), THIRD),
                       __fmul_rn(__fadd_rn(pair.y, below.y), THIRD));
}

// The clipped SSIM loss of one pixel from its five statistics.
__device__ __forceinline__ float loss_of(float m1, float m2, float e11,
                                         float e22, float e12, float c1,
                                         float c2) {
    const Ssim s = ssim_of(m1, m2, e11, e22, e12, c1, c2);
    const float map = __fdiv_rn(__fmul_rn(s.n1, s.n2), __fmul_rn(s.d1, s.d2));
    const float pre = __fmul_rn(__fsub_rn(1.0f, map), 0.5f);
    return fminf(fmaxf(pre, 0.0f), 1.0f);
}

// One warp a strip of FWD_ROWS x FWD_COLS outputs of image blockIdx.y;
// task = blockIdx.x * FWD_WARPS + warp = (column strip, row strip), the row
// strip fastest. out[b] = (sum of the clipped SSIM loss map, sum |p - t|).
__global__ void __launch_bounds__(FWD_WARPS * 32)
fwd_kernel(const float* __restrict__ pred, const float* __restrict__ tgt,
           float* __restrict__ partials, unsigned* __restrict__ count,
           float* __restrict__ out, int H, int W, int strips_y, int strips_x,
           float c1, float c2) {
    __shared__ bool last;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.y;
    // A warp past the last strip walks the last one and adds nothing, and
    // rows past the image are walked and not added: no branch around the
    // shuffles depends on the warp, so they need no reconvergence.
    const int tasks = strips_y * strips_x;
    const int task = blockIdx.x * FWD_WARPS + (threadIdx.x >> 5);
    const bool live = task < tasks;
    const int strip = live ? task : tasks - 1;
    const int ys = (strip % strips_y) * FWD_ROWS;
    const int xa = (strip / strips_y) * FWD_COLS - 2 + 2 * lane;
    const float* P = pred + (size_t)b * H * W;
    const float* T = tgt + (size_t)b * H * W;
    const Columns cols = columns_of(xa, W);
    // W even: xa is even, so an 8-byte load at the even column is aligned
    const bool vec = (W & 1) == 0 &&
        ((reinterpret_cast<size_t>(pred) | reinterpret_cast<size_t>(tgt)) &
         7) == 0;
    const bool own_a = live && lane >= 1 && xa >= 0 && xa < W;
    const bool own_b = live && lane <= 30 && xa + 1 >= 0 && xa + 1 < W;

    // rows ys - 1 .. ys + FWD_ROWS: prev is the last row's five maps, pair
    // the sum of the last two rows', so the column pass of the row above
    // the new one is col3(pair, new)
    Maps prev = maps_of(load_pair(P, H, W, ys - 1, cols, vec),
                        load_pair(T, H, W, ys - 1, cols, vec));
    Maps cur = maps_of(load_pair(P, H, W, ys, cols, vec),
                       load_pair(T, H, W, ys, cols, vec));
    Maps pair = add_maps(prev, cur);
    prev = cur;
    float2 np = load_pair(P, H, W, ys + 1, cols, vec);
    float2 nt = load_pair(T, H, W, ys + 1, cols, vec);
    float ss = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int j = 1; j <= FWD_ROWS; ++j) {
        const int y = ys + j;   // the new row; output row y - 1
        cur = maps_of(np, nt);
        if (j < FWD_ROWS) {
            np = load_pair(P, H, W, y + 1, cols, vec);
            nt = load_pair(T, H, W, y + 1, cols, vec);
        }
        const float2 mu1 = row_box(col3(pair.p, cur.p));
        const float2 mu2 = row_box(col3(pair.t, cur.t));
        const float2 e11 = row_box(col3(pair.pp, cur.pp));
        const float2 e22 = row_box(col3(pair.tt, cur.tt));
        const float2 e12 = row_box(col3(pair.pt, cur.pt));
        const float la = loss_of(mu1.x, mu2.x, e11.x, e22.x, e12.x, c1, c2);
        const float lb = loss_of(mu1.y, mu2.y, e11.y, e22.y, e12.y, c1, c2);
        const bool in = y - 1 < H;
        if (own_a && in) {
            ss += la;
            l1 += fabsf(__fsub_rn(prev.p.x, prev.t.x));
        }
        if (own_b && in) {
            ss += lb;
            l1 += fabsf(__fsub_rn(prev.p.y, prev.t.y));
        }
        pair = add_maps(prev, cur);
        prev = cur;
    }

    // the block's sums, then the image's last block adds the blocks' sums
    const int blocks = gridDim.x;
    float* mine = partials + (size_t)b * blocks * 2;
    block_sum2(ss, l1);
    if (threadIdx.x == 0) {
        mine[blockIdx.x * 2 + 0] = ss;
        mine[blockIdx.x * 2 + 1] = l1;
        __threadfence();
        last = atomicAdd(count + b, 1u) == static_cast<unsigned>(blocks - 1);
    }
    __syncthreads();
    if (!last) return;
    float a0 = 0.0f, a1 = 0.0f;
    for (int i = threadIdx.x; i < blocks; i += FWD_WARPS * 32) {
        a0 += __ldcg(mine + i * 2 + 0);
        a1 += __ldcg(mine + i * 2 + 1);
    }
    block_sum2(a0, a1);
    if (threadIdx.x == 0) {
        out[b * 2 + 0] = a0;
        out[b * 2 + 1] = a1;
    }
}

// -- backward ----------------------------------------------------------------

constexpr int BWD_WARPS = 4;      // warps per block, each a strip of its own
constexpr int BWD_COLS = 60;      // output columns of a strip (64 held, 2 a side)
constexpr int BWD_ROWS = 16;      // output rows of a strip

// The adjoint's pass along a row at columns x and x + 1 from the map c there
// (0 outside the image), with the reflection's folds.
__device__ __forceinline__ float2 row_adjoint(float2 c, int x, int W) {
    const float left = __shfl_up_sync(FULL, c.y, 1);
    const float right = __shfl_down_sync(FULL, c.x, 1);
    float a = sum3(left, c.x, c.y);
    if (x == 1) a = __fadd_rn(a, __fmul_rn(left, THIRD));
    if (x == W - 2) a = __fadd_rn(a, __fmul_rn(c.y, THIRD));
    float b = sum3(c.x, c.y, right);
    if (x + 1 == 1) b = __fadd_rn(b, __fmul_rn(c.x, THIRD));
    if (x + 1 == W - 2) b = __fadd_rn(b, __fmul_rn(right, THIRD));
    return make_float2(a, b);
}

// The gated coefficient maps of one pixel (0 where it lies outside).
struct Coef {
    float mu1, e11, e12;
};

__device__ __forceinline__ Coef coef_of(const Ssim& s, float s_ssim) {
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
    Coef c;
    c.mu1 = __fmul_rn(gate, __fsub_rn(ta, tb));
    c.e11 = __fmul_rn(gate, __fdiv_rn(-m, s.d2));
    c.e12 = __fmul_rn(gate, __fmul_rn(__fmul_rn(2.0f, s.n1), rr));
    return c;
}

// ((d + g0) + (g1*2)*p) + g2*t, d = s_l1 * sign(p - t)
__device__ __forceinline__ float out_of(float p, float t, float g0, float g1,
                                        float g2, float s_l1) {
    float d = __fmul_rn(s_l1, sgn(__fsub_rn(p, t)));
    d = __fadd_rn(d, g0);
    d = __fadd_rn(d, __fmul_rn(__fmul_rn(g1, 2.0f), p));
    return __fadd_rn(d, __fmul_rn(g2, t));
}

// The adjoint's pass down the columns at output row y from its row pass a
// on rows y-1, y, y+1 (0 outside the image), with the reflection's folds.
__device__ __forceinline__ float col_adjoint(float a0, float a1, float a2,
                                             int y, int H) {
    float g = sum3(a0, a1, a2);
    if (y == 1) g = __fadd_rn(g, __fmul_rn(a0, THIRD));
    if (y == H - 2) g = __fadd_rn(g, __fmul_rn(a2, THIRD));
    return g;
}

// What a lane carries from row to row: the five maps of the last three
// rows of p and t (m), and the adjoint's row pass of the three coefficient
// maps on the last three rows of them (a), each in a ring of three slots.
struct Window {
    Maps m[3];
    float2 a[3][3];   // [slot][map]
};

// Everything one row step needs besides the window.
struct Strip {
    const float* P;
    const float* T;
    float* out;
    int H, W, xa;
    Columns cols;
    bool vec, in_a, in_b, mine;
    float c1, c2, s_ssim, s_l1;
};

// Row step j of a strip starting at output row ys: p and t of row y = ys -
// 2 + j (loaded one step ahead into np, nt) into slot S = j % 3; from
// j = 2 the statistics, coefficient maps and the adjoint's row pass of row
// y - 1 into slot S; from j = 4 output row y - 2. Slots by S, so that the
// rings need no moves.
template <int S>
__device__ __forceinline__ void row_step(Window& w, const Strip& s, int j,
                                         int ys, int steps, float2& np,
                                         float2& nt) {
    constexpr int S1 = (S + 1) % 3, S2 = (S + 2) % 3;   // rows y-2, y-1
    const int y = ys - 2 + j;
    w.m[S] = maps_of(np, nt);
    if (j + 1 < steps) {
        np = load_pair(s.P, s.H, s.W, y + 1, s.cols, s.vec);
        nt = load_pair(s.T, s.H, s.W, y + 1, s.cols, s.vec);
    }
    if (j < 2) return;
    const int ym = y - 1;
    const Maps& m0 = w.m[S1];
    const Maps& m1 = w.m[S2];
    const Maps& m2 = w.m[S];
    if (ym >= 0 && ym < s.H) {
        const float2 mu1 = row_box(sum3v(m0.p, m1.p, m2.p));
        const float2 mu2 = row_box(sum3v(m0.t, m1.t, m2.t));
        const float2 e11 = row_box(sum3v(m0.pp, m1.pp, m2.pp));
        const float2 e22 = row_box(sum3v(m0.tt, m1.tt, m2.tt));
        const float2 e12 = row_box(sum3v(m0.pt, m1.pt, m2.pt));
        // both columns' maps (a branch each would not save the warp's time)
        Coef ca = coef_of(ssim_of(mu1.x, mu2.x, e11.x, e22.x, e12.x, s.c1,
                                  s.c2), s.s_ssim);
        Coef cb = coef_of(ssim_of(mu1.y, mu2.y, e11.y, e22.y, e12.y, s.c1,
                                  s.c2), s.s_ssim);
        if (!s.in_a) ca = {0.0f, 0.0f, 0.0f};
        if (!s.in_b) cb = {0.0f, 0.0f, 0.0f};
        w.a[S][0] = row_adjoint(make_float2(ca.mu1, cb.mu1), s.xa, s.W);
        w.a[S][1] = row_adjoint(make_float2(ca.e11, cb.e11), s.xa, s.W);
        w.a[S][2] = row_adjoint(make_float2(ca.e12, cb.e12), s.xa, s.W);
    } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) w.a[S][k] = make_float2(0.0f, 0.0f);
    }
    if (j < 4 || !s.mine) return;
    // output row y - 2: the adjoint's column pass over rows y-3, y-2, y-1
    const int yo = y - 2;
    const float2* a0 = w.a[S1];
    const float2* a1 = w.a[S2];
    const float2* a2 = w.a[S];
    const float oa = out_of(
        m0.p.x, m0.t.x, col_adjoint(a0[0].x, a1[0].x, a2[0].x, yo, s.H),
        col_adjoint(a0[1].x, a1[1].x, a2[1].x, yo, s.H),
        col_adjoint(a0[2].x, a1[2].x, a2[2].x, yo, s.H), s.s_l1);
    const float ob = out_of(
        m0.p.y, m0.t.y, col_adjoint(a0[0].y, a1[0].y, a2[0].y, yo, s.H),
        col_adjoint(a0[1].y, a1[1].y, a2[1].y, yo, s.H),
        col_adjoint(a0[2].y, a1[2].y, a2[2].y, yo, s.H), s.s_l1);
    float* row = s.out + (size_t)yo * s.W + s.xa;
    if (s.vec && s.in_a) {
        *reinterpret_cast<float2*>(row) = make_float2(oa, ob);
    } else {
        if (s.in_a) row[0] = oa;
        if (s.in_b) row[1] = ob;
    }
}

// One warp a strip of BWD_ROWS x BWD_COLS outputs; task = (image, column
// strip, row strip), the row strip fastest.
__global__ void __launch_bounds__(BWD_WARPS * 32)
bwd_kernel(const float* __restrict__ pred, const float* __restrict__ tgt,
           const float* __restrict__ scales, float* __restrict__ dout, int B,
           int H, int W, int strips_y, int strips_x, float c1, float c2) {
    const int lane = threadIdx.x & 31;
    const int task = blockIdx.x * BWD_WARPS + (threadIdx.x >> 5);
    const int b = task / (strips_y * strips_x);
    if (b >= B) return;
    const int rest = task - b * strips_y * strips_x;
    const int ys = (rest % strips_y) * BWD_ROWS;
    const int steps = min(BWD_ROWS, H - ys) + 4;
    const size_t img = (size_t)b * H * W;
    Strip s;
    s.P = pred + img;
    s.T = tgt + img;
    s.out = dout + img;
    s.H = H;
    s.W = W;
    s.xa = (rest / strips_y) * BWD_COLS - 2 + 2 * lane;
    s.cols = columns_of(s.xa, W);
    // W even: xa is even, so an 8-byte load at the even column is aligned
    s.vec = (W & 1) == 0 &&
        ((reinterpret_cast<size_t>(pred) | reinterpret_cast<size_t>(tgt) |
          reinterpret_cast<size_t>(dout)) & 7) == 0;
    s.in_a = s.xa >= 0 && s.xa < W;
    s.in_b = s.xa + 1 >= 0 && s.xa + 1 < W;
    s.mine = lane >= 1 && lane <= 30;   // the strip's own columns
    s.c1 = c1;
    s.c2 = c2;
    s.s_ssim = scales[0];
    s.s_l1 = scales[1];

    Window w;
    float2 np = load_pair(s.P, H, W, ys - 2, s.cols, s.vec);
    float2 nt = load_pair(s.T, H, W, ys - 2, s.cols, s.vec);
    for (int j = 0; j < steps; j += 3) {
        row_step<0>(w, s, j, ys, steps, np, nt);
        if (j + 1 < steps) row_step<1>(w, s, j + 1, ys, steps, np, nt);
        if (j + 2 < steps) row_step<2>(w, s, j + 2, ys, steps, np, nt);
    }
}

}  // namespace rootloss
}  // namespace

// The forward's strip, rows and columns, and its warps a block into
// strip[0..2], so the wrapper can size the scratch. Returns 0.
extern "C" int fused_root_loss_fwd_strip(int* strip) {
    strip[0] = rootloss::FWD_ROWS;
    strip[1] = rootloss::FWD_COLS;
    strip[2] = rootloss::FWD_WARPS;
    return 0;
}

// pred, tgt: [B,H,W] float32 contiguous, H, W >= 2. scratch: scratch_words
// 32-bit words, at least B * blocks * 2 + B with blocks = ceil(ceil(H/8) *
// ceil((W+1)/62) / 4): each block's two sums, then one ticket counter an
// image (zeroed here on the stream). out: [B,2] (sum of the clipped SSIM
// loss map, sum |p-t|). One kernel. Returns the CUDA error of the memset or
// the launch (0 on success).
extern "C" int fused_root_loss_fwd(const void* pred, const void* tgt,
                                   void* scratch, void* out, int B, int H,
                                   int W, int scratch_words, float c1,
                                   float c2, void* stream) {
    using namespace rootloss;
    const int strips_y = (H + FWD_ROWS - 1) / FWD_ROWS;
    const int strips_x = (W + FWD_COLS) / FWD_COLS;   // columns -1 .. W - 1
    const int blocks = (strips_y * strips_x + FWD_WARPS - 1) / FWD_WARPS;
    const long long sums = 2LL * B * blocks;
    if (scratch_words < sums + B)
        return static_cast<int>(cudaErrorInvalidValue);
    float* partials = static_cast<float*>(scratch);
    unsigned* count = reinterpret_cast<unsigned*>(partials + sums);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = cudaMemsetAsync(count, 0, B * sizeof(unsigned), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    fwd_kernel<<<dim3(blocks, B), FWD_WARPS * 32, 0, s>>>(
        static_cast<const float*>(pred), static_cast<const float*>(tgt),
        partials, count, static_cast<float*>(out), H, W, strips_y, strips_x,
        c1, c2);
    return static_cast<int>(cudaGetLastError());
}

// scales: 2 device floats (SSIM, L1 factors of dL/dp). dout: [B,H,W]. One
// kernel, no scratch. Returns the CUDA error of the launch (0 on success).
extern "C" int fused_root_loss_bwd(const void* pred, const void* tgt,
                                   const void* scales, void* dout, int B,
                                   int H, int W, float c1, float c2,
                                   void* stream) {
    using namespace rootloss;
    const int strips_y = (H + BWD_ROWS - 1) / BWD_ROWS;
    const int strips_x = (W + BWD_COLS - 1) / BWD_COLS;
    const long long tasks = (long long)B * strips_y * strips_x;
    const int blocks = static_cast<int>((tasks + BWD_WARPS - 1) / BWD_WARPS);
    bwd_kernel<<<blocks, BWD_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pred), static_cast<const float*>(tgt),
        static_cast<const float*>(scales), static_cast<float*>(dout), B, H, W,
        strips_y, strips_x, c1, c2);
    return static_cast<int>(cudaGetLastError());
}
