// ppn_post_kernel — the fused PPN post-process on Hopper (sm_90a).
//
// Replaces the two TPU Pallas kernels that compute the same function:
//   * ppn_tpu/ops/pallas_post.py        _make_kernel / postprocess_batch_pallas
//     (one image per grid step, B < G);
//   * ppn_tpu/ops/pallas_post_packed.py _make_packed_kernel / packed_call
//     (G images packed into lanes per grid step, B >= G).
// Their lane packing, 128-lane padded outputs, bf16 prep views and q choice
// are TPU layout devices; one kernel here serves every B. What it computes is
// ppn_tpu/ops/postprocess.py postprocess_batch_fn, and its plain PyTorch
// version is ppn_tpu_torch/ops/postprocess.py postprocess_batch_plain.
//
// Design: one CTA per image, 256 threads, everything but the limb logits in
// dynamic shared memory (~134 KB at mpii_r18_384, ~142 KB at COCO):
//   1. decode   σ scores and boxes for N×K1 proposals;
//   2. NMS      per-class N×N "j suppresses i" bitmasks (ceil(N/32) words per
//               row), then the wave fixpoint of ppn_tpu/ops/nms.py: drop
//               undecided proposals blocked by a kept one, keep those with no
//               undecided earlier overlap, until none is undecided;
//   3. windows  one thread per (source cell, limb): ascending window offsets
//               with a strict > from 0 (first-max rule), σ of the raw limb
//               logits read from global memory;
//   4. seeds    warp 0: P rounds of first-argmax over the instance scores
//               (lax.top_k's order: value descending, ties by lower index);
//   5. walk     one thread per person slot over the L edges, then the box
//               gather and the min-keypoint filter, written as People fields.
//
// Bound: bytes. The kernel must read the f32 feature map once: at mpii B=128
// that is 128 × 144 × 1398 × 4 B = 103 MB, about 31 µs at the data sheet's
// 3.35 TB/s; its outputs are under 1% of that. No single PyTorch call
// computes this function (library time: none).
//
// Numerics: build with --fmad=false and without --use_fast_math. The decision
// arithmetic (x0 = cx − w/2, union = a + a' − inter) would otherwise contract
// into FMAs and flip NMS decisions near the threshold against the plain
// version. σ is 1 / (1 + expf(−x)) with the full-precision expf, the same
// formula the plain version evaluates.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#define PPN_MAX_LIMBS 64
#define PPN_THREADS 256

struct PostParams {
  int H, W, C, K1, L, Hl, Wl, P, min_kp, size_exp;
  float sx, sy, img_w, img_h, det_t, nms_t;
  int src[PPN_MAX_LIMBS], dst[PPN_MAX_LIMBS];
};

// Shared-memory words (4 bytes each) for one image; the host and the kernel
// carve the same layout.
__host__ __device__ static size_t post_smem_words(int N, int K1, int L, int P) {
  const size_t KN = (size_t)K1 * N, NWD = (N + 31) / 32;
  return 5 * KN             // score, cx, cy, bw, bh
         + 3 * (size_t)L * N  // window maps: best value, cell, score
         + N                  // instance scores being consumed by the seeds
         + 3 * (size_t)P * K1 // per slot: cell, score, ok
         + 2 * (size_t)P      // person valid, num_kp
         + KN * NWD           // suppression bitmasks
         + 3 * K1 * NWD;      // kept, undecided, newly kept bitsets
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(PPN_THREADS)
ppn_post_kernel(const float* __restrict__ fm, const PostParams p,
                int32_t* __restrict__ kp_cell, float* __restrict__ kp_box,
                float* __restrict__ kp_score, uint8_t* __restrict__ kp_valid,
                uint8_t* __restrict__ valid, int32_t* __restrict__ num_kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nth = blockDim.x, b = blockIdx.x;
  const int H = p.H, W = p.W, K1 = p.K1, L = p.L, P = p.P;
  const int N = H * W, NW = p.Hl * p.Wl, KN = K1 * N, NWD = (N + 31) / 32;
  const int ch = p.Hl / 2, cw = p.Wl / 2;

  float* s_score = reinterpret_cast<float*>(smem);  // [K1][N]
  float* s_cx = s_score + KN;
  float* s_cy = s_cx + KN;
  float* s_bw = s_cy + KN;
  float* s_bh = s_bw + KN;
  float* s_bv = s_bh + KN;                           // [L][N]
  float* s_bs = s_bv + L * N;                        // [L][N]
  int* s_bd = reinterpret_cast<int*>(s_bs + L * N);  // [L][N]
  float* s_inst = reinterpret_cast<float*>(s_bd + L * N);  // [N]
  float* s_kpsc = s_inst + N;                        // [P][K1]
  int* s_kpcell = reinterpret_cast<int*>(s_kpsc + P * K1);
  int* s_kpok = s_kpcell + P * K1;
  int* s_pvalid = s_kpok + P * K1;                   // [P]
  int* s_numkp = s_pvalid + P;                       // [P]
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_numkp + P);  // [K1][N][NWD]
  uint32_t* s_kept = s_mask + (size_t)KN * NWD;      // [K1][NWD]
  uint32_t* s_und = s_kept + K1 * NWD;
  uint32_t* s_new = s_und + K1 * NWD;

  const float* f = fm + (size_t)b * N * p.C;

  // ---- 1. decode ----------------------------------------------------------
  for (int t = tid; t < KN; t += nth) {
    const int n = t / K1, c = t % K1;
    const float* fc = f + (size_t)n * p.C + c;
    const float resp = sigmoid_f(fc[0]);
    const float conf = sigmoid_f(fc[K1]);
    const float xo = sigmoid_f(fc[2 * K1]);
    const float yo = sigmoid_f(fc[3 * K1]);
    float wo, ho;
    if (p.size_exp) {
      wo = expf(fminf(fmaxf(fc[4 * K1], -10.0f), 4.0f));
      ho = expf(fminf(fmaxf(fc[5 * K1], -10.0f), 4.0f));
    } else {
      wo = sigmoid_f(fc[4 * K1]);
      ho = sigmoid_f(fc[5 * K1]);
    }
    const float iy = (float)(n / W), ix = (float)(n % W);
    const int o = c * N + n;
    s_score[o] = resp * conf;
    s_cx[o] = (ix + xo) * p.sx;
    s_cy[o] = (iy + yo) * p.sy;
    s_bw[o] = wo * p.img_w;
    s_bh[o] = ho * p.img_h;
  }
  __syncthreads();

  // ---- 2. NMS -------------------------------------------------------------
  for (int t = tid; t < K1 * NWD; t += nth) {
    const int c = t / NWD, w = t % NWD;
    uint32_t bits = 0;
    for (int k = 0; k < 32; ++k) {
      const int j = w * 32 + k;
      if (j < N && s_score[c * N + j] > p.det_t) bits |= 1u << k;
    }
    s_und[t] = bits;
    s_kept[t] = 0;
    s_new[t] = 0;
  }
  // mask bit j of row (c, i): j is earlier in greedy order (higher score,
  // ties by lower index), above the detection threshold, and overlaps i
  // above nms_thresh — ppn_tpu/ops/nms.py _suppression_matrix with the
  // divide-free test of ppn_tpu/ops/boxes.py, area from the corners.
  for (int t = tid; t < KN * NWD; t += nth) {
    const int w = t % NWD, ci = t / NWD;
    const int c = ci / N, i = ci % N;
    const float* cx = s_cx + c * N;
    const float* cy = s_cy + c * N;
    const float* bw = s_bw + c * N;
    const float* bh = s_bh + c * N;
    const float* sc = s_score + c * N;
    const float ax0 = cx[i] - bw[i] / 2.0f, ay0 = cy[i] - bh[i] / 2.0f;
    const float ax1 = cx[i] + bw[i] / 2.0f, ay1 = cy[i] + bh[i] / 2.0f;
    const float area_a = (ax1 - ax0) * (ay1 - ay0);
    const float si = sc[i];
    uint32_t bits = 0;
    for (int k = 0; k < 32; ++k) {
      const int j = w * 32 + k;
      if (j >= N) break;
      const float sj = sc[j];
      if (!(sj > p.det_t)) continue;
      if (!(sj > si || (sj == si && j < i))) continue;
      const float bx0 = cx[j] - bw[j] / 2.0f, by0 = cy[j] - bh[j] / 2.0f;
      const float bx1 = cx[j] + bw[j] / 2.0f, by1 = cy[j] + bh[j] / 2.0f;
      const float iw = fmaxf(fminf(ax1, bx1) - fmaxf(ax0, bx0), 0.0f);
      const float ih = fmaxf(fminf(ay1, by1) - fmaxf(ay0, by0), 0.0f);
      const float inter = iw * ih;
      const float uni = area_a + (bx1 - bx0) * (by1 - by0) - inter;
      if (inter > p.nms_t * fmaxf(uni, 1e-9f)) bits |= 1u << k;
    }
    s_mask[t] = bits;
  }
  __syncthreads();

  for (;;) {
    int open = 0;
    for (int t = tid; t < K1 * NWD; t += nth) open |= (s_und[t] != 0);
    if (!__syncthreads_or(open)) break;
    // undecided proposals blocked by a kept one are suppressed
    for (int t = tid; t < KN; t += nth) {
      const int c = t / N, i = t % N;
      const uint32_t ib = 1u << (i & 31);
      uint32_t* uw = s_und + c * NWD + (i >> 5);
      if (!(*uw & ib)) continue;
      const uint32_t* row = s_mask + (size_t)t * NWD;
      const uint32_t* kept = s_kept + c * NWD;
      bool blocked = false;
      for (int w = 0; w < NWD && !blocked; ++w) blocked = (row[w] & kept[w]) != 0;
      if (blocked) atomicAnd(uw, ~ib);
    }
    __syncthreads();
    // undecided proposals with no undecided earlier overlap are kept
    for (int t = tid; t < KN; t += nth) {
      const int c = t / N, i = t % N;
      const uint32_t ib = 1u << (i & 31);
      if (!(s_und[c * NWD + (i >> 5)] & ib)) continue;
      const uint32_t* row = s_mask + (size_t)t * NWD;
      const uint32_t* und = s_und + c * NWD;
      bool higher_open = false;
      for (int w = 0; w < NWD && !higher_open; ++w)
        higher_open = (row[w] & und[w]) != 0;
      if (!higher_open) atomicOr(s_new + c * NWD + (i >> 5), ib);
    }
    __syncthreads();
    for (int t = tid; t < K1 * NWD; t += nth) {
      const uint32_t nk = s_new[t];
      s_kept[t] |= nk;
      s_und[t] &= ~nk;
      s_new[t] = 0;
    }
  }
  // post-NMS scores: zero where not kept
  for (int t = tid; t < KN; t += nth) {
    const int c = t / N, i = t % N;
    if (!(s_kept[c * NWD + (i >> 5)] & (1u << (i & 31)))) s_score[t] = 0.0f;
  }
  __syncthreads();

  // ---- 3. limb-window best-destination maps -------------------------------
  for (int t = tid; t < L * N; t += nth) {
    const int n = t / L, l = t % L;
    const int y = n / W, x = n % W;
    const float* e = f + (size_t)n * p.C + 6 * K1 + l * NW;
    const float* sd = s_score + p.dst[l] * N;
    float best = 0.0f, bsc = 0.0f;
    int bdst = 0;
    for (int j = 0; j < NW; ++j) {
      const int yy = y + j / p.Wl - ch, xx = x + j % p.Wl - cw;
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      const int nb = yy * W + xx;
      const float v = sigmoid_f(e[j]) * sd[nb];
      if (v > best) {  // strict: the first maximum wins
        best = v;
        bdst = nb;
        bsc = sd[nb];
      }
    }
    s_bv[l * N + n] = best;
    s_bd[l * N + n] = bdst;
    s_bs[l * N + n] = bsc;
  }

  // ---- 4. seeds: top-P instance proposals, ties by lower index ------------
  if (tid < 32) {
    for (int n = tid; n < N; n += 32) s_inst[n] = s_score[n];
    __syncwarp();
    for (int q = 0; q < P; ++q) {
      float bv = -FLT_MAX;
      int bi = N;
      for (int n = tid; n < N; n += 32) {
        const float v = s_inst[n];
        if (v > bv) { bv = v; bi = n; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      if (tid == 0) {
        s_kpcell[q * K1] = bi;
        s_kpsc[q * K1] = bv;
        s_kpok[q * K1] = bv > 0.0f;
        s_inst[bi] = -1.0f;  // scores are >= 0: a taken cell never wins again
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- 5. walk the limb tree, one thread per person slot ------------------
  for (int q = tid; q < P; q += nth) {
    int* cell = s_kpcell + q * K1;
    float* sc = s_kpsc + q * K1;
    int* ok = s_kpok + q * K1;
    for (int c = 1; c < K1; ++c) { cell[c] = 0; sc[c] = 0.0f; ok[c] = 0; }
    for (int l = 0; l < L; ++l) {
      const int s = p.src[l], d = p.dst[l], from = l * N + cell[s];
      const bool o = ok[s] && s_bv[from] > 0.0f;
      cell[d] = o ? s_bd[from] : 0;
      sc[d] = o ? s_bs[from] : 0.0f;
      ok[d] = o;
    }
    int nk = 0;
    for (int c = 1; c < K1; ++c) nk += ok[c];
    s_numkp[q] = nk;
    s_pvalid[q] = ok[0] && nk >= p.min_kp;
  }
  __syncthreads();

  // boxes and scores are masked by per-keypoint validity only; kp_valid
  // also by the person filter (ppn_tpu/ops/parse.py parse_single)
  for (int t = tid; t < P * K1; t += nth) {
    const int q = t / K1, c = t % K1;
    const size_t o = (size_t)b * P * K1 + t;
    const int cl = s_kpcell[t];
    const bool okv = s_kpok[t] != 0;
    kp_cell[2 * o] = cl / W;
    kp_cell[2 * o + 1] = cl % W;
    kp_score[o] = s_kpsc[t];
    kp_valid[o] = okv && s_pvalid[q];
    const int src = c * N + cl;
    kp_box[4 * o + 0] = okv ? s_cx[src] : 0.0f;
    kp_box[4 * o + 1] = okv ? s_cy[src] : 0.0f;
    kp_box[4 * o + 2] = okv ? s_bw[src] : 0.0f;
    kp_box[4 * o + 3] = okv ? s_bh[src] : 0.0f;
  }
  for (int q = tid; q < P; q += nth) {
    valid[(size_t)b * P + q] = s_pvalid[q] != 0;
    num_kp[(size_t)b * P + q] = s_numkp[q];
  }
}

extern "C" {

// Launches ppn_post_kernel on `stream` for B images of the (B, N, C) f32
// feature map; edges holds L (src, dst) pairs in host memory. Returns the
// CUDA error code (0 = launched).
int ppn_post_launch(const float* fm, int32_t* kp_cell, float* kp_box,
                    float* kp_score, uint8_t* kp_valid, uint8_t* valid,
                    int32_t* num_kp, int device, int B, int H, int W, int C,
                    int K1, int L, int Hl, int Wl, int P, float sx, float sy,
                    float img_w, float img_h, float det_t, float nms_t,
                    int min_kp, int size_exp, const int32_t* edges,
                    void* stream) {
  if (B < 1 || L < 1 || L > PPN_MAX_LIMBS || P > H * W)
    return (int)cudaErrorInvalidValue;
  PostParams p;
  p.H = H; p.W = W; p.C = C; p.K1 = K1; p.L = L; p.Hl = Hl; p.Wl = Wl;
  p.P = P; p.min_kp = min_kp; p.size_exp = size_exp;
  p.sx = sx; p.sy = sy; p.img_w = img_w; p.img_h = img_h;
  p.det_t = det_t; p.nms_t = nms_t;
  for (int l = 0; l < L; ++l) { p.src[l] = edges[2 * l]; p.dst[l] = edges[2 * l + 1]; }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = post_smem_words(H * W, K1, L, P) * 4;
  err = cudaFuncSetAttribute(ppn_post_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ppn_post_kernel<<<B, PPN_THREADS, smem, (cudaStream_t)stream>>>(
      fm, p, kp_cell, kp_box, kp_score, kp_valid, valid, num_kp);
  return (int)cudaGetLastError();
}

const char* ppn_post_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
