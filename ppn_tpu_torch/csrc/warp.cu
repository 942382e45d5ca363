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
// transposes exist for the TPU only. Here: one thread per output pixel
// (b, y, x), all C channels, NHWC read and written in place. A hat row has
// at most two non-zero taps, floor(u) and floor(u) + 1, so the thread reads
// two rows of tmp, each from two input pixels: 4·C reads, C writes.
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
// coefficient arithmetic the kernel is bitwise equal to the plain version.
// Build with --fmad=false: an FMA contraction of r·x + t, d·x + f or
// e·y + u moves the hat argument by an ulp. bf16 conversions round to
// nearest even (__float2bfloat16_rn). The frame tests run on the float tap
// index, before any conversion to int: zoom-outs with large shifts push
// floor(u) far outside the frame.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define WARP_THREADS 256
#define WARP_MAX_C 4

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// bf16(max(0, 1 − |u|)) held in f32
__device__ __forceinline__ float hat_bf16(float u) {
  return round_bf16(fmaxf(0.0f, 1.0f - fabsf(u)));
}

template <typename T>
__global__ void __launch_bounds__(WARP_THREADS)
ppn_warp_kernel(const T* __restrict__ in, T* __restrict__ out,
                const float* __restrict__ mats, int B, int H, int W, int C) {
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (int64_t)B * H * W) return;
  const int x = (int)(pix % W);
  const int y = (int)((pix / W) % H);
  const int b = (int)(pix / ((int64_t)W * H));

  const float* m = mats + 6 * b;
  const float a = m[0], bb = m[1], c = m[2], d = m[3], f = m[5];
  float e = m[4];
  // the degenerate-e guard of affine_warp_separable
  if (fabsf(e) < 1e-3f) e = (e > 0.0f) ? 1e-3f : (e < 0.0f ? -1e-3f : 1e-3f);
  const float r = a - bb * d / e;
  const float be = bb / e;
  const float ct = c - bb * f / e;
  const float fx = (float)x;
  const float rx = r * fx;
  const float yi = e * (float)y + (d * fx + f);

  const T* img = in + (int64_t)b * H * W * C;
  float acc[WARP_MAX_C];
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;

  const float m0 = floorf(yi);
  for (int i = 0; i < 2; ++i) {
    const float mf = m0 + (float)i;
    if (!(mf >= 0.0f && mf <= (float)(H - 1))) continue;
    const float w2 = hat_bf16(yi - mf);
    const int row = (int)mf;
    // pass 1 at (row, x), rounded to bf16
    const float xi = rx + (be * mf + ct);
    const float k0 = floorf(xi);
    float tmp[WARP_MAX_C];
    for (int ch = 0; ch < C; ++ch) tmp[ch] = 0.0f;
    for (int j = 0; j < 2; ++j) {
      const float kf = k0 + (float)j;
      if (!(kf >= 0.0f && kf <= (float)(W - 1))) continue;
      const float w1 = hat_bf16(xi - kf);
      const T* p = img + ((int64_t)row * W + (int)kf) * C;
      for (int ch = 0; ch < C; ++ch)
        tmp[ch] += w1 * round_bf16(to_f32(p[ch]));
    }
    for (int ch = 0; ch < C; ++ch) acc[ch] += w2 * round_bf16(tmp[ch]);
  }
  T* o = out + pix * C;
  for (int ch = 0; ch < C; ++ch) store(o + ch, acc[ch]);
}

extern "C" {

// Launches ppn_warp_kernel on `stream` for B (H, W, C) NHWC images, float32
// (bf16 == 0) or bfloat16 (bf16 == 1), by the (B, 2, 3) f32 matrices `mats`
// in device memory. Returns the CUDA error code (0 = launched).
int ppn_warp_launch(const void* in, void* out, const float* mats, int B,
                    int H, int W, int C, int bf16, int device, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || C > WARP_MAX_C)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)B * H * W;
  const unsigned grid = (unsigned)((n + WARP_THREADS - 1) / WARP_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    ppn_warp_kernel<__nv_bfloat16><<<grid, WARP_THREADS, 0, s>>>(
        (const __nv_bfloat16*)in, (__nv_bfloat16*)out, mats, B, H, W, C);
  else
    ppn_warp_kernel<float><<<grid, WARP_THREADS, 0, s>>>(
        (const float*)in, (float*)out, mats, B, H, W, C);
  return (int)cudaGetLastError();
}

const char* ppn_warp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
