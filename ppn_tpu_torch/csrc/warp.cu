// ppn_warp_kernel — the batched same-size affine warp of the training
// augmentation, on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel ppn_tpu/ops/pallas_warp.py
// _make_warp_kernel / affine_warp_batch_pallas. What it computes is
// ppn_tpu/ops/image.py affine_warp_separable for every image of the batch:
// two 1-D hat-kernel resampling passes (Catmull–Smith) by the image's
// OUTPUT→INPUT matrix [a b c; d e f],
//   pass 1  tmp[y, x] = Σ_k bf16(hat(r·x + t(y) − k)) · bf16(in[y, k])
//           with r = a − b·d/e, t(y) = (b/e)·y + (c − b·f/e), rounded to bf16;
//   pass 2  out[y, x] = Σ_m bf16(hat(e·y + (d·x + f) − m)) · tmp[m, x],
// sums in f32, zero outside the source frame, output in the input dtype.
// Its plain PyTorch version is ppn_tpu_torch/ops/image.py
// affine_warp_separable_plain.
//
// The TPU kernel's log-shift lane rolls, one-hot MXU gathers and NCHW
// transposes exist for the TPU only. Here a CTA of 128 threads covers 128
// output columns × 4 rows (grid: x-tile, row-tile, image; 32-bit indices
// inside an image), one column per thread, so the lanes of a warp sit on
// neighbouring pixels: their tap loads (read-only path) fall on
// neighbouring input pixels, and each store instruction writes 32·C
// contiguous values. Each thread computes the image's coefficients r, b/e,
// c − b·f/e itself (no barrier, no shared memory; staging the tile in
// shared memory for 16-byte stores measured slower). A hat row has at most
// two non-zero taps, floor(u) and floor(u) + 1, so an output pixel needs
// pass 1 at two rows m of its column, each from two input pixels. Pass 1 at
// (m, x) depends on m and x alone, and a thread walks down its column, so it
// keeps the last two rows of pass 1 it computed and reuses them: at scale ~1
// the next pixel needs one new row, not two. The channel count is a
// template parameter, so the sums stay in registers.
//
// Bound: bytes. The warp must read each input pixel once and write each
// output pixel once: at B=32, 384×384×3 in bf16 that is 2 × 28.3 MB =
// 56.6 MB, 16.9 µs at the data sheet's 3.35 TB/s. Its operations (~60 f32
// per pixel and channel) are far below the f32 rate. The rotated gathers
// re-read neighbouring input rows; L1 and L2 serve those re-reads. No single
// PyTorch call computes this function (library time: none).
//
// Numerics: each bf16×bf16 product is exact in f32 and at most two of them
// are non-zero, so every sum rounds once, in any order; with the same f32
// coefficient arithmetic (the same expressions in the same order, d·x + f
// hoisted out of e·y + (d·x + f) unchanged) the kernel is bitwise equal to
// the plain version. Build with --fmad=false: an FMA contraction of r·x + t,
// d·x + f or e·y + u moves the hat argument by an ulp. bf16 conversions round
// to nearest even (__float2bfloat16_rn). The frame tests run on the float
// tap index, before any conversion to int: zoom-outs with large shifts push
// floor(u) far outside the frame.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define WARP_THREADS 128  // one output column each
#define TILE_H 4          // output rows per CTA
#define WARP_MAX_C 4

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// a pixel's value rounded to bf16, held in f32 (a bf16 pixel already is)
__device__ __forceinline__ float bf16_value(float v) { return round_bf16(v); }
__device__ __forceinline__ float bf16_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float from_f32(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}
// bf16(max(0, 1 − |u|)) held in f32
__device__ __forceinline__ float hat_bf16(float u) {
  return round_bf16(fmaxf(0.0f, 1.0f - fabsf(u)));
}

// Pass 1 at (row mf, column with r·x = rx), rounded to bf16.
template <typename T, int C>
__device__ __forceinline__ void pass1(const T* __restrict__ img, int W,
                                      float rx, float be, float ct, float mf,
                                      float (&tmp)[C]) {
  const float xi = rx + (be * mf + ct);
  const float k0 = floorf(xi);
  const T* rowp = img + (int)mf * W * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) tmp[ch] = 0.0f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float kf = k0 + (float)j;
    if (!(kf >= 0.0f && kf <= (float)(W - 1))) continue;
    const float w1 = hat_bf16(xi - kf);
    const T* px = rowp + (int)kf * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) tmp[ch] += w1 * bf16_value(__ldg(px + ch));
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) tmp[ch] = round_bf16(tmp[ch]);
}

template <typename T, int C>
__global__ void __launch_bounds__(WARP_THREADS)
ppn_warp_kernel(const T* __restrict__ in, T* __restrict__ out,
                const float* __restrict__ mats, int H, int W) {
  const int x = blockIdx.x * WARP_THREADS + threadIdx.x;
  const int y0 = blockIdx.y * TILE_H, b = blockIdx.z;
  if (x >= W) return;
  const float* m = mats + 6 * b;
  const float a = __ldg(m), bb = __ldg(m + 1), c = __ldg(m + 2);
  const float d = __ldg(m + 3), f = __ldg(m + 5);
  float e = __ldg(m + 4);
  // the degenerate-e guard of affine_warp_separable
  if (fabsf(e) < 1e-3f) e = (e > 0.0f) ? 1e-3f : (e < 0.0f ? -1e-3f : 1e-3f);
  const float r = a - bb * d / e, be = bb / e, ct = c - bb * f / e;
  const T* img = in + (size_t)b * H * W * C;
  T* o = out + (((size_t)b * H + y0) * W + x) * C;
  const float fx = (float)x;
  const float rx = r * fx;
  const float ux = d * fx + f;
  // the last two rows of pass 1 computed in this column, older first
  int ra = INT_MIN, rb = INT_MIN;
  float ta[C], tb[C];
  for (int ry = 0; ry < min(TILE_H, H - y0); ++ry) {
    const float yi = e * (float)(y0 + ry) + ux;
    const float m0 = floorf(yi);
    float acc[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const float mf = m0 + (float)i2;
      if (!(mf >= 0.0f && mf <= (float)(H - 1))) continue;
      const float w2 = hat_bf16(yi - mf);
      const int row = (int)mf;
      if (row != ra && row != rb) {
        ra = rb;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) ta[ch] = tb[ch];
        rb = row;
        pass1<T, C>(img, W, rx, be, ct, mf, tb);
      }
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        acc[ch] += w2 * (row == rb ? tb[ch] : ta[ch]);
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      o[(size_t)ry * W * C + ch] = from_f32(acc[ch], T());
  }
}

template <typename T>
static void launch(const void* in, void* out, const float* mats, int B,
                   int H, int W, int C, cudaStream_t s) {
  const dim3 grid((W + WARP_THREADS - 1) / WARP_THREADS,
                  (H + TILE_H - 1) / TILE_H, B);
  const T* i = (const T*)in;
  T* o = (T*)out;
  switch (C) {
    case 1: ppn_warp_kernel<T, 1><<<grid, WARP_THREADS, 0, s>>>(i, o, mats, H, W); break;
    case 2: ppn_warp_kernel<T, 2><<<grid, WARP_THREADS, 0, s>>>(i, o, mats, H, W); break;
    case 3: ppn_warp_kernel<T, 3><<<grid, WARP_THREADS, 0, s>>>(i, o, mats, H, W); break;
    default: ppn_warp_kernel<T, 4><<<grid, WARP_THREADS, 0, s>>>(i, o, mats, H, W); break;
  }
}

extern "C" {

// Launches ppn_warp_kernel on `stream` for B (H, W, C) NHWC images, float32
// (bf16 == 0) or bfloat16 (bf16 == 1), by the (B, 2, 3) f32 matrices `mats`
// in device memory. Returns the CUDA error code (0 = launched).
int ppn_warp_launch(const void* in, void* out, const float* mats, int B,
                    int H, int W, int C, int bf16, int device, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || C > WARP_MAX_C || B > 65535 ||
      (H + TILE_H - 1) / TILE_H > 65535 || (int64_t)H * W * C > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  int cur;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    launch<__nv_bfloat16>(in, out, mats, B, H, W, C, s);
  else
    launch<float>(in, out, mats, B, H, W, C, s);
  return (int)cudaGetLastError();
}

const char* ppn_warp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
