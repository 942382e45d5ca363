// ppn_bn_* — training-mode BatchNorm with its activation folded in, forward
// and backward, on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's BatchNorm is Flax's
// nnx.BatchNorm, which XLA fuses on the TPU, and ppn_tpu/ has no Pallas
// kernel for it. The port ran it as ~30 eager PyTorch passes forward and as
// many backward over f32 copies of every map (the cast, Σx, Σx², the
// normalize, the cast back, and their autograd), most of a training step.
// Its plain PyTorch version is ppn_tpu_torch/ops/cuda_bn.py
// (batch_norm_train_plain for the forward, grad_sums_plain and
// backward_plain for the backward's arithmetic).
//
// What it computes, per channel c over the N·H·W rows of a channels_last
// map x (N, C, H, W) in T (bfloat16 or float32), as the plain version does:
//   sums   Σx, Σx² in f32 and the count n;
//   mean = Σx/n, v = Σx²/n − mean², var = max(v, 0),
//   r = rsqrt(var + eps), mul = r·T(scale), b = T(bias) (f32 values);
//   y0 = T((x − mean)·mul + b), y = act(y0): none, ReLU, or LeakyReLU(0.1)
//   in T as F.leaky_relu rounds it; running ← keep·running + take·(mean, var).
// Backward, with dy' = dy through the activation's mask (taken from y0,
// recomputed from x), dz = f32(dy'):
//   A = Σdz, B = Σdz·(x − mean)            (over the joined batch's ranks)
//   dvar = (−0.5·B·w)·r³ where v ≥ 0, else 0
//   dmean = −mul·A − 2·dvar·mean
//   dx = T(dz·mul + dmean/n + (2·dvar/n)·x)
//   dscale = f32(T(B_local·r)), dbias = f32(T(A_local)).
//
// Bound: bytes. Each pass streams the map once; the least a layer can move
// in T is x read for the statistics, x read and y written by the apply
// (3 maps forward), dy and x read for the two gradient sums, dy and x read
// and dx written by the apply (5 maps backward): 16 bytes a value in bf16.
// Nothing else touches a map: the activation's mask is recomputed from x in
// both backward passes (y is never read), no f32 copy of a map is made, and
// only x and the per-channel sums are kept for the backward.
//
// Design. Memory is channels_last, so a row of the map is C contiguous
// values. A CTA of 256 threads covers up to 256 16-byte vectors of a row
// (8 bf16 or 4 f32 values a thread; the wrapper refuses a C that is not a
// multiple of that, or a map not on a 16-byte boundary: every model's widths
// are multiples of 64) and, with the threads left, RPI = 256/TPR rows at
// once, so its loads are RPI·C contiguous values; channel chunks beyond 256
// vectors go to gridDim.y. Each thread keeps its channels for the whole pass, so their
// per-channel coefficients sit in registers and its sums in registers too.
// The grid's rows: a contiguous run of rows per CTA, as many CTAs as fill
// the card's SMs (4 a SM for the reductions, 8 for the applies) while each
// thread still walks 32 (8) rows, four loads in flight at a time. The stem
// (4.7 M rows × 64 channels at B=128) and ResNet-50's last stage (9,216 rows
// × 2,048 channels at B=64) both fill all SMs.
//
// Determinism: no float atomics. A thread sums its rows in order, the CTA's
// rows meet in shared memory in a fixed order into one partial per CTA
// (ppn_bn_stats_kernel, ppn_bn_grad_stats_kernel), and ppn_bn_reduce_kernel
// adds the partials in a fixed order. The partition depends on the shape
// and the SM count alone, so two calls on the same input are bitwise equal.
// The terms are f32 values as the plain version forms them (x, x² and
// dz·(x − mean) each rounded in f32); they accumulate in f64 and each sum
// rounds once to f32. With f32 accumulators a thread's chain of some
// hundred adds left the sums ~2e-7 of Σ|x| off, which E[x²] − E[x]²
// magnifies where a channel's mean is large against its spread: two
// data-parallel ranks then parted from one process on the joined batch
// 9× further than with PyTorch's own reductions. f64 adds are far below
// the card's rate at these kernels' bytes.
// Three launches each way: partial sums, their reduction, the apply. Under
// data parallelism the wrapper all-reduces the sums between the second and
// the third.
//
// Numerics: build with --fmad=false, so every product and sum rounds on its
// own, as PyTorch's separate elementwise kernels round them; T conversions
// round to nearest even; division is IEEE; rsqrtf is what PyTorch's CUDA
// rsqrt calls. Only the sums differ from the plain version: their order,
// and their f64 accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BN_THREADS 256
#define BN_UNROLL 4
#define RED_X 32       // channels per CTA of ppn_bn_reduce_kernel
#define RED_Y 16       // partials each channel's column is split over
#define STATS_PER_SM 4
#define STATS_ITERS 32
#define APPLY_PER_SM 8
#define APPLY_ITERS 8
#define LEAKY_SLOPE 0.1f

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T, held in f32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// V values of T, moved as one aligned load or store (16 bytes when V·size
// is 16)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Channel c's statistics from the sums [Σx (C), Σx² (C), n].
template <typename T>
__device__ __forceinline__ void channel(const float* __restrict__ sums,
                                        const float* __restrict__ weight,
                                        const float* __restrict__ bias, int C,
                                        int c, float eps, float& mean,
                                        float& v, float& r, float& mul,
                                        float& b) {
  const float n = sums[2 * C];
  mean = sums[c] / n;
  v = sums[C + c] / n - mean * mean;
  const float var = v < 0.0f ? 0.0f : v;  // clamp_min(v, 0), NaN kept
  r = rsqrtf(var + eps);
  mul = r * round_to<T>(weight[c]);
  b = round_to<T>(bias[c]);
}

// y0 = T((x − mean)·mul + b) held in f32
template <typename T>
__device__ __forceinline__ float normalized(float xf, float mean, float mul,
                                            float b) {
  return round_to<T>((xf - mean) * mul + b);
}

template <typename T, int ACT>
__device__ __forceinline__ float activate(float y0) {
  if (ACT == ACT_RELU) return y0 <= 0.0f ? 0.0f : y0;
  if (ACT == ACT_LEAKY) return y0 > 0.0f ? y0 : round_to<T>(y0 * LEAKY_SLOPE);
  return y0;
}

// dz: dy (in T) through the activation at y0, in f32
template <typename T, int ACT>
__device__ __forceinline__ float through(float dyf, float y0) {
  if (ACT == ACT_RELU) return y0 <= 0.0f ? 0.0f : dyf;
  if (ACT == ACT_LEAKY) return y0 > 0.0f ? dyf : round_to<T>(dyf * LEAKY_SLOPE);
  return dyf;
}

// The rows a CTA walks and the channel vector a thread holds.
struct Lane {
  int tx, ty, c0;
  bool active;
  long long r0, r1;
};

template <int V>
__device__ __forceinline__ Lane lane(int C, int TPR, int RPI, long long M,
                                     long long rpb) {
  Lane l;
  l.tx = threadIdx.x % TPR;
  l.ty = threadIdx.x / TPR;
  l.c0 = (blockIdx.y * TPR + l.tx) * V;
  l.active = l.ty < RPI && l.c0 < C;
  l.r0 = (long long)blockIdx.x * rpb;
  l.r1 = min(l.r0 + rpb, M);
  return l;
}

// The CTA's per-thread sums (q = 0, 1) of V channels each, met in shared
// memory over its RPI rows in order, as one partial per channel.
template <int V>
__device__ __forceinline__ void write_partials(const Lane& l,
                                               const double (&a)[V],
                                               const double (&bsum)[V],
                                               double* __restrict__ partials,
                                               int C, int TPR, int RPI) {
  __shared__ double sm[2 * BN_THREADS * 8];
  const int W = TPR * V;  // channels of this chunk's row slice
  if (l.active) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sm[(l.ty * 2) * W + l.tx * V + k] = a[k];
      sm[(l.ty * 2 + 1) * W + l.tx * V + k] = bsum[k];
    }
  }
  __syncthreads();
  const int cb = blockIdx.y * W;
  const int width = min(W, C - cb);
  for (int j = threadIdx.x; j < 2 * width; j += BN_THREADS) {
    const int q = j / width, cl = j - q * width;
    double s = 0.0;
    for (int k = 0; k < RPI; ++k) s += sm[(k * 2 + q) * W + cl];
    partials[((long long)blockIdx.x * 2 + q) * C + cb + cl] = s;
  }
}

// Forward pass 1: per-CTA partial Σx and Σx².
template <typename T, int V>
__global__ void __launch_bounds__(BN_THREADS)
ppn_bn_stats_kernel(const T* __restrict__ x, double* __restrict__ partials,
                    long long M, int C, int TPR, int RPI, long long rpb) {
  const Lane l = lane<V>(C, TPR, RPI, M, rpb);
  double s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.0;
  if (l.active) {
    const T* base = x + l.c0;
    for (long long row = l.r0 + l.ty; row < l.r1;
         row += (long long)RPI * BN_UNROLL) {
      Pack<T, V> p[BN_UNROLL];
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) {
        const long long r = row + (long long)u * RPI;
        if (r < l.r1) p[u] = *reinterpret_cast<const Pack<T, V>*>(base + r * C);
      }
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) {
        if (row + (long long)u * RPI >= l.r1) break;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float f = to_f32(p[u].v[k]);
          s1[k] += f;
          s2[k] += (double)(f * f);  // the square rounded in f32
        }
      }
    }
  }
  write_partials<V>(l, s1, s2, partials, C, TPR, RPI);
}

// Backward pass 1: per-CTA partial A = Σdz and B = Σdz·(x − mean).
template <typename T, int V, int ACT>
__global__ void __launch_bounds__(BN_THREADS)
ppn_bn_grad_stats_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         const float* __restrict__ sums,
                         const float* __restrict__ weight,
                         const float* __restrict__ bias, float eps,
                         double* __restrict__ partials, long long M, int C,
                         int TPR, int RPI, long long rpb) {
  const Lane l = lane<V>(C, TPR, RPI, M, rpb);
  double sa[V], sb[V];
  float mean[V], mul[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sa[k] = sb[k] = 0.0;
  if (l.active) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float v, r;
      channel<T>(sums, weight, bias, C, l.c0 + k, eps, mean[k], v, r, mul[k],
                 b[k]);
    }
    for (long long row = l.r0 + l.ty; row < l.r1;
         row += (long long)RPI * BN_UNROLL) {
      Pack<T, V> px[BN_UNROLL], pd[BN_UNROLL];
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) {
        const long long r = row + (long long)u * RPI;
        if (r < l.r1) {
          px[u] = *reinterpret_cast<const Pack<T, V>*>(x + r * C + l.c0);
          pd[u] = *reinterpret_cast<const Pack<T, V>*>(dy + r * C + l.c0);
        }
      }
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) {
        if (row + (long long)u * RPI >= l.r1) break;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xc = to_f32(px[u].v[k]) - mean[k];
          float dz = to_f32(pd[u].v[k]);
          if (ACT != ACT_NONE)
            dz = through<T, ACT>(dz, round_to<T>(xc * mul[k] + b[k]));
          sa[k] += dz;
          sb[k] += (double)(dz * xc);  // the product rounded in f32
        }
      }
    }
  }
  write_partials<V>(l, sa, sb, partials, C, TPR, RPI);
}

// Pass 2, both ways: the partials of each channel added in a fixed order.
// Forward (GRAD 0): out = [Σx, Σx², count]. Backward (GRAD 1): out = [A, B]
// of this rank, and the parameter gradients rounded through T.
template <typename T, int GRAD>
__global__ void __launch_bounds__(RED_X * RED_Y)
ppn_bn_reduce_kernel(const double* __restrict__ partials, int P, int C,
                     float* __restrict__ out, float count,
                     const float* __restrict__ sums,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias, float eps,
                     float* __restrict__ dweight, float* __restrict__ dbias) {
  __shared__ double sm[RED_Y][2][RED_X];
  const int tx = threadIdx.x % RED_X, ty = threadIdx.x / RED_X;
  const int c = blockIdx.x * RED_X + tx;
  double s0 = 0.0, s1 = 0.0;
  if (c < C) {
    for (int p = ty; p < P; p += RED_Y) {
      s0 += partials[(long long)p * 2 * C + c];
      s1 += partials[((long long)p * 2 + 1) * C + c];
    }
  }
  sm[ty][0][tx] = s0;
  sm[ty][1][tx] = s1;
  __syncthreads();
  if (ty != 0 || c >= C) return;
  double u0 = 0.0, u1 = 0.0;
  for (int k = 0; k < RED_Y; ++k) {
    u0 += sm[k][0][tx];
    u1 += sm[k][1][tx];
  }
  const float t0 = (float)u0, t1 = (float)u1;  // the sums, rounded once
  out[c] = t0;
  out[C + c] = t1;
  if (GRAD) {
    float mean, v, r, mul, b;
    channel<T>(sums, weight, bias, C, c, eps, mean, v, r, mul, b);
    dbias[c] = round_to<T>(t0);
    dweight[c] = round_to<T>(t1 * r);
  } else if (c == 0) {
    out[2 * C] = count;
  }
}

// Forward pass 3: y = act(T((x − mean)·mul + b)); the first CTA of each
// channel chunk updates the running statistics.
template <typename T, int V, int ACT>
__global__ void __launch_bounds__(BN_THREADS)
ppn_bn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const float* __restrict__ sums,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias, float eps,
                    float* __restrict__ running_mean,
                    float* __restrict__ running_var, float keep, float take,
                    long long M, int C, int TPR, int RPI, long long rpb) {
  const Lane l = lane<V>(C, TPR, RPI, M, rpb);
  if (!l.active) return;
  float mean[V], mul[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float v, r;
    const int c = l.c0 + k;
    channel<T>(sums, weight, bias, C, c, eps, mean[k], v, r, mul[k], b[k]);
    if (blockIdx.x == 0 && l.ty == 0) {
      const float var = v < 0.0f ? 0.0f : v;
      running_mean[c] = keep * running_mean[c] + take * mean[k];
      running_var[c] = keep * running_var[c] + take * var;
    }
  }
  for (long long row = l.r0 + l.ty; row < l.r1;
       row += (long long)RPI * BN_UNROLL) {
    Pack<T, V> p[BN_UNROLL];
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long r = row + (long long)u * RPI;
      if (r < l.r1) p[u] = *reinterpret_cast<const Pack<T, V>*>(x + r * C + l.c0);
    }
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long r = row + (long long)u * RPI;
      if (r >= l.r1) break;
      Pack<T, V> o;
#pragma unroll
      for (int k = 0; k < V; ++k)
        o.v[k] = from_f32<T>(activate<T, ACT>(
            normalized<T>(to_f32(p[u].v[k]), mean[k], mul[k], b[k])));
      *reinterpret_cast<Pack<T, V>*>(y + r * C + l.c0) = o;
    }
  }
}

// Backward pass 3: dx from dy, x, the forward's sums and the gradient sums
// [A, B] (the joined batch's under data parallelism).
template <typename T, int V, int ACT>
__global__ void __launch_bounds__(BN_THREADS)
ppn_bn_grad_apply_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         T* __restrict__ dx, const float* __restrict__ sums,
                         const float* __restrict__ gsums,
                         const float* __restrict__ weight,
                         const float* __restrict__ bias, float eps,
                         long long M, int C, int TPR, int RPI, long long rpb) {
  const Lane l = lane<V>(C, TPR, RPI, M, rpb);
  if (!l.active) return;
  const float n = sums[2 * C];
  float mean[V], mul[V], b[V], ds1[V], c2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = l.c0 + k;
    float v, r;
    channel<T>(sums, weight, bias, C, c, eps, mean[k], v, r, mul[k], b[k]);
    const float a = gsums[c], bm = gsums[C + c];
    const float dr = bm * round_to<T>(weight[c]);
    const float dvar = (-0.5f * dr) * (r * r * r);
    const float dv = v >= 0.0f ? dvar : 0.0f;
    const float dmean = -(mul[k] * a) + (-dv * 2.0f) * mean[k];
    ds1[k] = dmean / n;
    c2[k] = dv / n * 2.0f;
  }
  for (long long row = l.r0 + l.ty; row < l.r1;
       row += (long long)RPI * BN_UNROLL) {
    Pack<T, V> px[BN_UNROLL], pd[BN_UNROLL];
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long r = row + (long long)u * RPI;
      if (r < l.r1) {
        px[u] = *reinterpret_cast<const Pack<T, V>*>(x + r * C + l.c0);
        pd[u] = *reinterpret_cast<const Pack<T, V>*>(dy + r * C + l.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      const long long r = row + (long long)u * RPI;
      if (r >= l.r1) break;
      Pack<T, V> o;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xf = to_f32(px[u].v[k]);
        float dz = to_f32(pd[u].v[k]);
        if (ACT != ACT_NONE)
          dz = through<T, ACT>(dz, normalized<T>(xf, mean[k], mul[k], b[k]));
        o.v[k] = from_f32<T>(dz * mul[k] + ds1[k] + c2[k] * xf);
      }
      *reinterpret_cast<Pack<T, V>*>(dx + r * C + l.c0) = o;
    }
  }
}

// ---- host side -------------------------------------------------------------

struct Tiling {
  int TPR, RPI, chunks, P;
  long long rpb;
};

static int sm_count(int device) {
  static int cache[64];
  if (device < 0 || device >= 64) return 132;
  if (cache[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n < 1)
      n = 132;
    cache[device] = n;
  }
  return cache[device];
}

// The grid of a pass over M rows of C channels at V values a thread: as
// many CTAs as `per_sm` a SM, each thread walking at least `iters` rows.
static Tiling tiling(long long M, int C, int V, int per_sm, int iters,
                     int sms) {
  Tiling t;
  const int CV = C / V;
  t.TPR = CV < BN_THREADS ? CV : BN_THREADS;
  t.RPI = BN_THREADS / t.TPR;
  t.chunks = (CV + t.TPR - 1) / t.TPR;
  const long long target = ((long long)per_sm * sms + t.chunks - 1) / t.chunks;
  const long long step = (long long)t.RPI * iters;
  long long P = (M + step - 1) / step;
  if (P > target) P = target;
  if (P < 1) P = 1;
  long long rpb = (M + P - 1) / P;
  rpb = (rpb + t.RPI - 1) / t.RPI * t.RPI;
  t.rpb = rpb;
  t.P = (int)((M + rpb - 1) / rpb);
  return t;
}

static int values_per_thread(int bf16) { return bf16 ? 8 : 4; }

static cudaError_t use_device(int device) {
  int cur;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

static bool bad_shape(long long M, int C, int bf16) {
  const int V = values_per_thread(bf16);
  return M < 1 || C < 1 || C % V != 0 || M > (1LL << 40);
}

template <typename T, int V, int ACT>
static void forward_t(const void* x, void* y, double* partials, float* sums,
                      const float* weight, const float* bias, float* rmean,
                      float* rvar, long long M, int C, float eps, float keep,
                      float take, int phases, int sms, cudaStream_t s) {
  if (phases & 1) {
    const Tiling t = tiling(M, C, V, STATS_PER_SM, STATS_ITERS, sms);
    ppn_bn_stats_kernel<T, V><<<dim3(t.P, t.chunks), BN_THREADS, 0, s>>>(
        (const T*)x, partials, M, C, t.TPR, t.RPI, t.rpb);
    ppn_bn_reduce_kernel<T, 0>
        <<<(C + RED_X - 1) / RED_X, RED_X * RED_Y, 0, s>>>(
            partials, t.P, C, sums, (float)M, nullptr, nullptr, nullptr, eps,
            nullptr, nullptr);
  }
  if (phases & 2) {
    const Tiling t = tiling(M, C, V, APPLY_PER_SM, APPLY_ITERS, sms);
    ppn_bn_apply_kernel<T, V, ACT><<<dim3(t.P, t.chunks), BN_THREADS, 0, s>>>(
        (const T*)x, (T*)y, sums, weight, bias, eps, rmean, rvar, keep, take,
        M, C, t.TPR, t.RPI, t.rpb);
  }
}

template <typename T, int V, int ACT>
static void backward_t(const void* dy, const void* x, void* dx,
                       double* partials, float* gsums, const float* sums,
                       const float* weight, const float* bias, float* dweight,
                       float* dbias, long long M, int C, float eps, int phases,
                       int sms, cudaStream_t s) {
  if (phases & 1) {
    const Tiling t = tiling(M, C, V, STATS_PER_SM, STATS_ITERS, sms);
    ppn_bn_grad_stats_kernel<T, V, ACT>
        <<<dim3(t.P, t.chunks), BN_THREADS, 0, s>>>(
            (const T*)dy, (const T*)x, sums, weight, bias, eps, partials, M, C,
            t.TPR, t.RPI, t.rpb);
    ppn_bn_reduce_kernel<T, 1>
        <<<(C + RED_X - 1) / RED_X, RED_X * RED_Y, 0, s>>>(
            partials, t.P, C, gsums, 0.0f, sums, weight, bias, eps, dweight,
            dbias);
  }
  if (phases & 2) {
    const Tiling t = tiling(M, C, V, APPLY_PER_SM, APPLY_ITERS, sms);
    ppn_bn_grad_apply_kernel<T, V, ACT>
        <<<dim3(t.P, t.chunks), BN_THREADS, 0, s>>>(
            (const T*)dy, (const T*)x, (T*)dx, sums, gsums, weight, bias, eps,
            M, C, t.TPR, t.RPI, t.rpb);
  }
}

// One function per (T, ACT), picked at run time; 16 bytes a thread.
#define BN_DISPATCH(FN, ARGS)                                          \
  do {                                                                 \
    if (bf16) {                                                        \
      if (act == ACT_RELU) FN<__nv_bfloat16, 8, ACT_RELU> ARGS;        \
      else if (act == ACT_LEAKY) FN<__nv_bfloat16, 8, ACT_LEAKY> ARGS; \
      else FN<__nv_bfloat16, 8, ACT_NONE> ARGS;                        \
    } else {                                                           \
      if (act == ACT_RELU) FN<float, 4, ACT_RELU> ARGS;                \
      else if (act == ACT_LEAKY) FN<float, 4, ACT_LEAKY> ARGS;         \
      else FN<float, 4, ACT_NONE> ARGS;                                \
    }                                                                  \
  } while (0)

extern "C" {

// The number of partials (CTAs along the rows) both gradient and statistics
// passes write for M rows of C channels: the workspace holds P·2·C doubles.
// Returns -1 on a shape the kernels do not take.
int ppn_bn_partials(long long M, int C, int bf16, int device) {
  if (bad_shape(M, C, bf16) || use_device(device) != cudaSuccess) return -1;
  const Tiling t = tiling(M, C, values_per_thread(bf16), STATS_PER_SM,
                          STATS_ITERS, sm_count(device));
  return t.P;
}

// The forward on `stream` for a channels_last map of M rows × C channels,
// float32 (bf16 == 0) or bfloat16 (bf16 == 1), C a multiple of 16 bytes and
// every map on a 16-byte boundary; act 0 none, 1 ReLU, 2 LeakyReLU(0.1).
// phases & 1: the statistics into sums [2C + 1]; phases & 2: y and the
// running statistics from `sums`.
// Returns the CUDA error code (0 = launched).
int ppn_bn_forward(const void* x, void* y, double* partials, float* sums,
                   const float* weight, const float* bias, float* running_mean,
                   float* running_var, long long M, int C, float eps,
                   float keep, float take, int bf16, int act, int phases,
                   int device, void* stream) {
  if (bad_shape(M, C, bf16) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count(device);
  cudaStream_t s = (cudaStream_t)stream;
  BN_DISPATCH(forward_t, (x, y, partials, sums, weight, bias, running_mean,
                          running_var, M, C, eps, keep, take, phases, sms, s));
  return (int)cudaGetLastError();
}

// The backward: phases & 1, this rank's gradient sums [A, B] into gsums
// [2C] and the parameter gradients; phases & 2, dx from gsums.
int ppn_bn_backward(const void* dy, const void* x, void* dx, double* partials,
                    float* gsums, const float* sums, const float* weight,
                    const float* bias, float* dweight, float* dbias,
                    long long M, int C, float eps, int bf16, int act,
                    int phases, int device, void* stream) {
  if (bad_shape(M, C, bf16) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count(device);
  cudaStream_t s = (cudaStream_t)stream;
  BN_DISPATCH(backward_t, (dy, x, dx, partials, gsums, sums, weight, bias,
                           dweight, dbias, M, C, eps, phases, sms, s));
  return (int)cudaGetLastError();
}

const char* ppn_bn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
