// Device code of the bf16 k = 3 GUB convs on the tensor cores, shared by
// gub_conv_fwd.cu (the forward) and gub_conv_bwd.cu (dx and dw): the 8x16
// pixel tiles that persistent blocks walk, their one-pixel halo, the
// cp.async staging of NHWC rows into shared memory, ldmatrix and
// mma.sync.m16n8k16 (bf16 in, f32 sums), bf16 vectors to and from f32, and
// the launch preparation (dynamic shared memory set on a first launch,
// blocks an SM). How each kernel uses them is in its source's header.
// window_attn_train.cu's bf16 backward uses the cp.async, ldmatrix and
// mma.sync wrappers alone.
//
// Everything is in namespace tc inside an unnamed namespace, as in the other
// headers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace tc {

constexpr int kTileH = 8;   // rows of a tile
constexpr int kTileW = 16;  // pixels of a tile row
using bf16 = __nv_bfloat16;

constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kHalo = kHaloH * kHaloW;  // pixels of a tile and its halo
constexpr int kPix = kTileH * kTileW;   // pixels of a tile
constexpr int kSms = 132;               // partials of gub_conv_dw: 1-2 an SM
constexpr int kSmemMax = 232448;        // dynamic shared memory of a block
constexpr int kChain = 4;  // k16 steps summed on the tensor cores alone

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a b: A 16x16 row-major, B 16x8 column-major, bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// VW bf16 values (VW 4 or 8, 8 or 16 bytes) to and from f32.
template <int VW>
struct Vec;
template <>
struct Vec<4> {
  using T = uint2;
};
template <>
struct Vec<8> {
  using T = uint4;
};

template <int VW>
__device__ __forceinline__ void load_vec(const bf16* p, float (&f)[VW]) {
  using T = typename Vec<VW>::T;
  const T u = *reinterpret_cast<const T*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VW / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(bf16* p, const float (&f)[VW]) {
  typename Vec<VW>::T u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VW / 2; ++i) {
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  }
  *reinterpret_cast<typename Vec<VW>::T*>(p) = u;
}

// Copies channels [cs, cs + n) of the NHWC rows (C wide) of image bi, for the
// R x CW pixels whose first is (y0, x0), to dst[pix * ds + cd + c], pix in
// row-major order; pixels outside the image are left alone. 16-byte cp.async
// where the base and every offset allow it, else plain loads.
template <int R, int CW, int NTHR>
__device__ __forceinline__ void stage_rows(bf16* dst, int ds, int cd,
                                           const bf16* src, int C, int cs,
                                           int n, int bi, int y0, int x0,
                                           int H, int W) {
  const int tid = threadIdx.x;
  if (((C | cs | n | cd | ds) & 7) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int q8 = n >> 3;
    for (int i = tid; i < R * CW * q8; i += NTHR) {
      const int pix = i / q8;
      const int q = i - pix * q8;
      const int iy = y0 + pix / CW;
      const int ix = x0 + pix % CW;
      if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
      cp_async16(dst + pix * ds + cd + q * 8,
                 src + (((long long)bi * H + iy) * W + ix) * C + cs + q * 8);
    }
  } else {
    for (int i = tid; i < R * CW * n; i += NTHR) {
      const int pix = i / n;
      const int c = i - pix * n;
      const int iy = y0 + pix / CW;
      const int ix = x0 + pix % CW;
      if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
      dst[pix * ds + cd + c] =
          src[(((long long)bi * H + iy) * W + ix) * C + cs + c];
    }
  }
}

struct Tile {
  int bi, y0, x0;  // image and first pixel
  int index;       // tile within the image
};

__device__ __forceinline__ Tile tile_of(int t, int H, int W) {
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int per_img = ((H + kTileH - 1) / kTileH) * tiles_w;
  Tile r;
  r.bi = t / per_img;
  r.index = t - r.bi * per_img;
  r.y0 = (r.index / tiles_w) * kTileH;
  r.x0 = (r.index % tiles_w) * kTileW;
  return r;
}

// Tiles that block blockIdx.x walks: blockIdx.x, + gridDim.x, ...
__device__ __forceinline__ int my_tiles(int total) {
  const int b = blockIdx.x;
  const int g = gridDim.x;
  return b < total ? (total - b + g - 1) / g : 0;
}

int sm_count() {
  int dev = 0;
  int n = kSms;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Raises the kernel's dynamic shared memory limit to `bytes` the first time
// a launch needs more than the last setting (checks run before any graph is
// captured), and returns the blocks of `threads` that fit on an SM.
template <typename Kernel>
cudaError_t prepare(Kernel kern, int* set, int bytes, int threads,
                    int* per_sm) {
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  if (bytes > *set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    *set = bytes;
  }
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads,
                                                    bytes);
  if (err == cudaSuccess && *per_sm < 1) return cudaErrorInvalidConfiguration;
  return err;
}

}  // namespace tc
}  // namespace
