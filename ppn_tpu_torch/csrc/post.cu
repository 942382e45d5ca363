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
// Design: one CTA of 1024 threads (32 warps) per image, everything but the
// limb logits in dynamic shared memory (~192 KB at mpii_r18_384, ~204 KB at
// COCO). Each stage ends at a barrier:
//   1. decode   σ scores and boxes for N×K1 proposals, neighbouring threads
//               on neighbouring channels of a cell;
//   2. mask     per class, the candidates (score > detection_thresh) in greedy
//               order — score descending, ties by lower index, ranked by
//               counting — with their corners and area; then suppression
//               bits between candidates only, each row toward later ones
//               (M_c·⌈M_c/32⌉ words for M_c candidates);
//   3. nms      one warp per class walks its ranked candidates in order: a
//               candidate that no kept one has removed is kept and ORs its
//               row into the removed set. Under a strict total order this is
//               the one fixpoint of the wave algorithm of ppn_tpu/ops/nms.py
//               nms_single. The warp then zeroes the scores it dropped and
//               lists (limb, kept cell) for each limb ending in its class;
//   4. windows  only a destination that keeps a score > 0 can win a window
//               (σ(e)·0 is 0 or NaN and never passes the strict > against a
//               best of 0), so the stage runs from the listed destinations,
//               one warp each, its lanes across the window offsets: each
//               lane loads the one limb logit that reaches the destination
//               from the source cell at that offset, and folds σ(e)·score
//               into the source row's 64-bit key — value bits high, then
//               the complement of the destination cell — by a shared-memory
//               atomicMax. Among in-frame offsets a lower offset is a lower
//               destination cell, so the largest key is the sequential rule's
//               winner: the largest value, ties by lower offset; key 0 is
//               "no winner" (a NaN logit is settled in the walk);
//   5. seeds    the top-P instance proposals (lax.top_k's order: value
//               descending, ties by lower index), each cell's rank counted
//               by a warp;
//   6. walk     one thread per person slot over the L edges, decoding the
//               keys. A NaN limb logit at any in-frame offset makes the
//               plain version's window max NaN, so that row has no winner,
//               whatever its destinations keep. Only the rows the walk
//               consults matter, so the walk records them, the warps scan
//               the listed rows' in-frame logits (NW contiguous floats a
//               row) for a NaN, and each slot is walked again on the
//               recorded keys, invalidating the subtree below a row holding
//               one;
//   7. write    the box gather and the min-keypoint filter, as People fields.
//
// Bound: bytes. The kernel must read the 6·K1 proposal channels of every
// cell, the limb logits whose destination keeps a score, and every
// in-frame limb logit of a row the walk consults that could have a winner
// (to rule out a NaN), and write People (ops/cuda_post.py needed_bytes).
// No single PyTorch call computes this function (library time: none). The
// logits toward kept destinations are read from scattered source cells, 4
// bytes of each 32-byte sector; they are few on a model's map. Scanning
// every row that has a winner instead (about a tenth of the L·N rows on the
// main-path map) doubled the kernel's time on the H100.
//
// NaN: a NaN proposal logit gives a NaN score, which fails the
// detection_thresh test here as in the plain version; a NaN box corner
// makes the plain version's overlap test false (torch.minimum, maximum and
// clamp_min propagate NaN), and here the union, NaN with it, is clamped by
// a comparison that keeps NaN instead of fmaxf, which drops it.
//
// Numerics: build with --fmad=false and without --use_fast_math. The decision
// arithmetic (x0 = cx − w/2, union = a + a' − inter) would otherwise contract
// into FMAs and flip NMS decisions near the threshold against the plain
// version. σ is 1 / (1 + expf(−x)) with the full-precision expf, the same
// formula the plain version evaluates; corners and areas use the plain
// version's expressions in its order.

#include <cuda_runtime.h>
#include <stdint.h>

#define PPN_MAX_LIMBS 64
#define PPN_THREADS 1024
#define PPN_MAX_WINDOW 128   // Hl·Wl: four offsets per lane
#define PPN_STAMPS 8         // entry + one per stage
#define FULL 0xffffffffu

struct PostParams {
  int H, W, C, K1, L, Hl, Wl, P, min_kp, size_exp;
  float sx, sy, img_w, img_h, det_t, nms_t;
  int src[PPN_MAX_LIMBS], dst[PPN_MAX_LIMBS];
};

// Offsets (in 4-byte words) of the shared-memory arrays of one image; the
// host and the kernel carve the same layout.
struct Smem {
  size_t score, cx, cy, bw, bh;      // [K1][N] by proposal
  size_t ord, x0, y0, x1, y1, area;  // [K1][N] by class and rank
  size_t cnt, moff;                  // [K1], [K1 + 1]
  size_t mask;  // at most [K1][N][ceil(N/32)]; in stage 6, the list of
                // consulted (slot, limb) pairs [P·L]
  size_t lists;  // stage 2: candidate index and score lists [2][K1][N];
                 // stage 3 on: window keys [L][N] (64-bit)
  size_t nent, ent;  // [1], (limb, kept cell) [L·N]; in stage 6, the
                     // count of consulted rows and the row each (slot,
                     // limb) of the walk consults [P·L]
  size_t kpsc, kpcell, kpok, pvalid, numkp;  // [P][K1] ×3, [P] ×2
  size_t total;
};

__host__ __device__ static Smem smem_layout(int H, int W, int K1, int L,
                                            int P) {
  const size_t N = (size_t)H * W, KN = K1 * N, LN = L * N;
  Smem s;
  size_t o = 0;
  s.score = o; o += KN;
  s.cx = o; o += KN;
  s.cy = o; o += KN;
  s.bw = o; o += KN;
  s.bh = o; o += KN;
  s.ord = o; o += KN;
  s.x0 = o; o += KN;
  s.y0 = o; o += KN;
  s.x1 = o; o += KN;
  s.y1 = o; o += KN;
  s.area = o; o += KN;
  s.cnt = o; o += K1;
  s.moff = o; o += K1 + 1;
  s.mask = o; o += KN * ((N + 31) / 32);
  o += o & 1;  // 8-byte alignment of the keys
  s.lists = o; o += 2 * (LN > KN ? LN : KN);
  s.nent = o; o += 1;
  s.ent = o; o += LN;
  s.kpsc = o; o += (size_t)P * K1;
  s.kpcell = o; o += (size_t)P * K1;
  s.kpok = o; o += (size_t)P * K1;
  s.pvalid = o; o += P;
  s.numkp = o; o += P;
  s.total = o;
  return s;
}

// %globaltimer (ns); thread 0 stamps it into clocks[b][k] after the barrier
// that closes stage k (k = 1..7; k = 0 at entry) when a buffer is given.
__device__ __forceinline__ void stamp(int64_t* clocks, int b, int k) {
  if (clocks != nullptr && threadIdx.x == 0) {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    clocks[b * PPN_STAMPS + k] = (int64_t)t;
  }
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// torch.clamp: NaN stays NaN (fminf and fmaxf would drop it)
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(PPN_THREADS, 1)
ppn_post_kernel(const float* __restrict__ fm,
                const __grid_constant__ PostParams p,
                int32_t* __restrict__ kp_cell, float* __restrict__ kp_box,
                float* __restrict__ kp_score, uint8_t* __restrict__ kp_valid,
                uint8_t* __restrict__ valid, int32_t* __restrict__ num_kp,
                int64_t* __restrict__ clocks) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, nth = blockDim.x, b = blockIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const int H = p.H, W = p.W, K1 = p.K1, L = p.L, P = p.P;
  const int N = H * W, NW = p.Hl * p.Wl, KN = K1 * N, LN = L * N;
  const int ch = p.Hl / 2, cw = p.Wl / 2;
  const Smem lay = smem_layout(H, W, K1, L, P);

  float* s_score = reinterpret_cast<float*>(smem + lay.score);
  float* s_cx = reinterpret_cast<float*>(smem + lay.cx);
  float* s_cy = reinterpret_cast<float*>(smem + lay.cy);
  float* s_bw = reinterpret_cast<float*>(smem + lay.bw);
  float* s_bh = reinterpret_cast<float*>(smem + lay.bh);
  int* s_ord = reinterpret_cast<int*>(smem + lay.ord);
  float* s_x0 = reinterpret_cast<float*>(smem + lay.x0);
  float* s_y0 = reinterpret_cast<float*>(smem + lay.y0);
  float* s_x1 = reinterpret_cast<float*>(smem + lay.x1);
  float* s_y1 = reinterpret_cast<float*>(smem + lay.y1);
  float* s_area = reinterpret_cast<float*>(smem + lay.area);
  int* s_cnt = reinterpret_cast<int*>(smem + lay.cnt);
  int* s_moff = reinterpret_cast<int*>(smem + lay.moff);
  uint32_t* s_mask = smem + lay.mask;
  int* l_idx = reinterpret_cast<int*>(smem + lay.lists);          // [K1][N]
  float* l_sc = reinterpret_cast<float*>(smem + lay.lists + KN);  // [K1][N]
  unsigned long long* s_key =
      reinterpret_cast<unsigned long long*>(smem + lay.lists);   // [L][N]
  int* s_nent = reinterpret_cast<int*>(smem + lay.nent);
  int* s_ent = reinterpret_cast<int*>(smem + lay.ent);
  float* s_kpsc = reinterpret_cast<float*>(smem + lay.kpsc);
  int* s_kpcell = reinterpret_cast<int*>(smem + lay.kpcell);
  int* s_kpok = reinterpret_cast<int*>(smem + lay.kpok);
  int* s_pvalid = reinterpret_cast<int*>(smem + lay.pvalid);
  int* s_numkp = reinterpret_cast<int*>(smem + lay.numkp);

  const float* f = fm + (size_t)b * N * p.C;
  stamp(clocks, b, 0);

  // ---- 1. decode ----------------------------------------------------------
  // three proposals per thread and pass, their 18 loads issued together
  for (int t0 = 0; t0 < KN; t0 += 3 * nth) {
    float v[3][6];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int t = t0 + u * nth + tid;
      if (t >= KN) continue;
      const int n = t / K1, c = t - n * K1;
      const float* fc = f + (size_t)n * p.C + c;
#pragma unroll
      for (int q = 0; q < 6; ++q) v[u][q] = __ldg(fc + q * K1);
    }
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int t = t0 + u * nth + tid;
      if (t >= KN) continue;
      const int n = t / K1, c = t - n * K1;
      const float resp = sigmoid_f(v[u][0]), conf = sigmoid_f(v[u][1]);
      const float xo = sigmoid_f(v[u][2]), yo = sigmoid_f(v[u][3]);
      float wo, ho;
      if (p.size_exp) {
        wo = expf(clamp_nan(v[u][4], -10.0f, 4.0f));
        ho = expf(clamp_nan(v[u][5], -10.0f, 4.0f));
      } else {
        wo = sigmoid_f(v[u][4]);
        ho = sigmoid_f(v[u][5]);
      }
      const int iy = n / W;
      const int o = c * N + n;
      s_score[o] = resp * conf;
      s_cx[o] = ((float)(n - iy * W) + xo) * p.sx;
      s_cy[o] = ((float)iy + yo) * p.sy;
      s_bw[o] = wo * p.img_w;
      s_bh[o] = ho * p.img_h;
    }
  }
  if (tid == 0) *s_nent = 0;
  __syncthreads();
  stamp(clocks, b, 1);

  // ---- 2. candidates in greedy order, suppression bits between them -------
  // 2a. one warp per class lists its candidates by index (ballot); every
  //     other proposal's post-NMS score is 0
  for (int c = warp; c < K1; c += nwarps) {
    int base = 0;
    for (int n0 = 0; n0 < N; n0 += 32) {
      const int n = n0 + lane;
      float s = 0.0f;
      bool cand = false;
      if (n < N) {
        s = s_score[c * N + n];
        cand = s > p.det_t;
        if (!cand) s_score[c * N + n] = 0.0f;
      }
      const uint32_t bal = __ballot_sync(FULL, cand);
      if (cand) {
        const int pos = base + __popc(bal & ((1u << lane) - 1u));
        l_idx[c * N + pos] = n;
        l_sc[c * N + pos] = s;
      }
      base += __popc(bal);
    }
    if (lane == 0) s_cnt[c] = base;
  }
  __syncthreads();
  if (tid == 0) {
    int o = 0;
    for (int c = 0; c < K1; ++c) {
      s_moff[c] = o;
      o += s_cnt[c] * ((s_cnt[c] + 31) >> 5);
    }
    s_moff[K1] = o;
  }
  // 2b. rank = the number of candidates earlier in greedy order (higher
  //     score, ties by lower index: the list is in index order); corners
  //     and area are stored by rank, in the plain version's expressions
  for (int t = tid; t < KN; t += nth) {
    const int c = t / N, a = t - c * N;
    const int M = s_cnt[c];
    if (a >= M) continue;
    const float* ls = l_sc + c * N;
    const float sa = ls[a];
    int r = 0;
    for (int q = 0; q < M; ++q) {
      const float sq = ls[q];
      r += (sq > sa) | ((sq == sa) & (q < a));
    }
    const int i = l_idx[c * N + a], pi = c * N + i, o = c * N + r;
    const float cx = s_cx[pi], cy = s_cy[pi], bw = s_bw[pi], bh = s_bh[pi];
    const float x0 = cx - bw / 2.0f, y0 = cy - bh / 2.0f;
    const float x1 = cx + bw / 2.0f, y1 = cy + bh / 2.0f;
    s_ord[o] = i;
    s_x0[o] = x0;
    s_y0[o] = y0;
    s_x1[o] = x1;
    s_y1[o] = y1;
    s_area[o] = (x1 - x0) * (y1 - y0);
  }
  __syncthreads();
  // 2c. bit k of word w of row a (class c): candidate 32w + k, later than a,
  //     overlaps a above nms_thresh — ppn_tpu/ops/nms.py
  //     _suppression_matrix with the divide-free test of
  //     ppn_tpu/ops/boxes.py. Items run (class, word, row), so the lanes of
  //     a warp hold neighbouring rows of one word and read the same later
  //     candidate at each step.
  {
    const int total = s_moff[K1];
    int c = 0;
    for (int t = tid; t < total; t += nth) {
      while (t >= s_moff[c + 1]) ++c;
      const int M = s_cnt[c], nwc = (M + 31) >> 5, r = t - s_moff[c];
      const int w = r / M, a = r - w * M, o = c * N;
      const int j0 = max(32 * w, a + 1), j1 = min(32 * w + 32, M);
      uint32_t bits = 0;
      if (j0 < j1) {
        const float ax0 = s_x0[o + a], ay0 = s_y0[o + a];
        const float ax1 = s_x1[o + a], ay1 = s_y1[o + a];
        const float area_a = s_area[o + a];
        for (int j = j0; j < j1; ++j) {
          const float iw =
              fmaxf(fminf(ax1, s_x1[o + j]) - fmaxf(ax0, s_x0[o + j]), 0.0f);
          const float ih =
              fmaxf(fminf(ay1, s_y1[o + j]) - fmaxf(ay0, s_y0[o + j]), 0.0f);
          const float inter = iw * ih;
          // a NaN corner makes an area, so the union, NaN: no overlap
          const float uni = s_area[o + j] + area_a - inter;
          const float den = uni < 1e-9f ? 1e-9f : uni;
          if (inter > p.nms_t * den) bits |= 1u << (j - 32 * w);
        }
      }
      s_mask[s_moff[c] + a * nwc + w] = bits;
    }
  }
  __syncthreads();
  stamp(clocks, b, 2);

  // ---- 3. NMS: one warp per class, greedy over its ranked candidates ------
  for (int t = tid; t < LN; t += nth) s_key[t] = 0ull;  // the lists are done
  for (int c = warp; c < K1; c += nwarps) {
    const int M = s_cnt[c], nwc = (M + 31) >> 5;
    const uint32_t* mk = s_mask + s_moff[c];
    uint32_t removed = 0, kept = 0;  // lane w holds word w of each set
    for (int wd = 0; wd < nwc; ++wd) {
      const int a = 32 * wd + lane;
      const uint32_t row = a < M ? mk[a * nwc + wd] : 0u;
      const int nb = min(32, M - 32 * wd);
      uint32_t cur = __shfl_sync(FULL, removed, wd), kw = 0;
      for (int k = 0; k < nb; ++k) {  // cur and kw are the same in every lane
        const uint32_t rk = __shfl_sync(FULL, row, k);
        if (!((cur >> k) & 1u)) {
          kw |= 1u << k;
          cur |= rk;
        }
      }
      // the kept rows of this word remove their later words
      const bool mine = (kw >> lane) & 1u;
      for (int w = wd + 1; w < nwc; ++w) {
        const uint32_t v =
            __reduce_or_sync(FULL, mine ? mk[a * nwc + w] : 0u);
        if (lane == w) removed |= v;
      }
      if (lane == wd) kept = kw;
    }
    // drop the scores of the candidates not kept; list (limb, kept cell)
    // for every limb that ends in class c
    for (int wd = 0; wd < nwc; ++wd) {
      const uint32_t kw = __shfl_sync(FULL, kept, wd);
      const int a = 32 * wd + lane;
      const bool keep = (kw >> lane) & 1u;
      const int m = a < M ? s_ord[c * N + a] : 0;
      if (a < M && !keep) s_score[c * N + m] = 0.0f;
      for (int l = 0; l < L; ++l) {
        if (p.dst[l] != c) continue;
        int base = 0;
        if (lane == 0) base = atomicAdd(s_nent, __popc(kw));
        base = __shfl_sync(FULL, base, 0);
        if (keep) s_ent[base + __popc(kw & ((1u << lane) - 1u))] = (l << 16) | m;
      }
    }
  }
  __syncthreads();
  stamp(clocks, b, 3);

  // ---- 4. limb windows, from the kept destinations ------------------------
  {
    int jdy[4], jdx[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = lane + 32 * s;
      jdy[s] = j / p.Wl - ch;
      jdx[s] = j % p.Wl - cw;
    }
    // two destinations per warp and pass, their loads issued together
    const int nent = *s_nent;
    for (int i0 = warp; i0 < nent; i0 += 2 * nwarps) {
      float ev[2][4], sm[2];
      int row[2][4], l[2], m[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * nwarps;
        const bool live = i < nent;
        const int ent = live ? s_ent[i] : 0;
        l[u] = ent >> 16;
        m[u] = ent & 0xffff;
        const int my = m[u] / W, mx = m[u] - my * W;
        sm[u] = s_score[p.dst[l[u]] * N + m[u]];
        const float* e = f + 6 * K1 + l[u] * NW;
#pragma unroll
        for (int s = 0; s < 4; ++s) {  // the source cell at offset j reaches m
          const int j = lane + 32 * s, y = my - jdy[s], x = mx - jdx[s];
          row[u][s] = (live && j < NW && y >= 0 && y < H && x >= 0 && x < W)
                          ? y * W + x : -1;
          ev[u][s] = row[u][s] >= 0 ? __ldg(e + (size_t)row[u][s] * p.C + j) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (row[u][s] < 0) continue;
          const float v = sigmoid_f(ev[u][s]) * sm[u];
          if (v > 0.0f)
            atomicMax(s_key + l[u] * N + row[u][s],
                      ((unsigned long long)__float_as_uint(v) << 32) |
                          (0xffffffffu - (uint32_t)m[u]));
        }
      }
    }
  }
  __syncthreads();
  stamp(clocks, b, 4);

  // ---- 5. seeds: top-P instance proposals, ties by lower index ------------
  for (int n = warp; n < N; n += nwarps) {
    const float v = s_score[n];  // class 0, post-NMS
    int r = 0;
    for (int m = lane; m < N; m += 32) {
      const float u = s_score[m];
      r += (u > v) | ((u == v) & (m < n));
    }
    r = __reduce_add_sync(FULL, r);
    if (lane == 0 && r < P) {
      s_kpcell[r * K1] = n;
      s_kpsc[r * K1] = v;
      s_kpok[r * K1] = v > 0.0f;
    }
  }
  __syncthreads();
  stamp(clocks, b, 5);

  // ---- 6. walk the limb tree, one thread per person slot ------------------
  // 6a. the walk on the keys, recording the row each (slot, limb) consults
  //     where the source is valid and the row has a winner (else -1)
  if (tid == 0) *s_nent = 0;  // stage 4 has read it: now the list's count
  for (int q = tid; q < P; q += nth) {
    int* cell = s_kpcell + q * K1;
    float* sc = s_kpsc + q * K1;
    int* ok = s_kpok + q * K1;
    for (int c = 1; c < K1; ++c) { cell[c] = 0; sc[c] = 0.0f; ok[c] = 0; }
    for (int l = 0; l < L; ++l) {
      const int s = p.src[l], d = p.dst[l], row = l * N + cell[s];
      const unsigned long long key = s_key[row];
      const bool o = ok[s] && key != 0ull;  // the best value is > 0
      const int nb = o ? (int)(0xffffffffu - (uint32_t)key) : 0;
      s_ent[q * L + l] = o ? row : -1;
      cell[d] = nb;
      sc[d] = o ? s_score[d * N + nb] : 0.0f;
      ok[d] = o;
    }
  }
  __syncthreads();
  // 6b. a NaN limb logit at an in-frame offset of a consulted row means that
  //     row has no winner (the plain version's window max is NaN). The
  //     consulted (slot, limb) pairs are listed (in the mask's space, free
  //     since stage 3), then each warp loads two rows' in-frame logits at a
  //     time (NW contiguous floats a row, the lanes across them) and marks a
  //     row holding a NaN with -2. The list keeps the warps idle where the
  //     walk consults nothing: a loop over all P·L pairs with the loads in
  //     it cost ~12 µs per CTA on the H100 even with no row to read.
  {
    int* chk = reinterpret_cast<int*>(s_mask);
    for (int r0 = warp * 32; r0 < P * L; r0 += nth) {
      const int r = r0 + lane;
      const uint32_t m = __ballot_sync(FULL, r < P * L && s_ent[r] >= 0);
      int base = 0;
      if (lane == 0 && m) base = atomicAdd(s_nent, __popc(m));
      base = __shfl_sync(FULL, base, 0);
      if ((m >> lane) & 1u) chk[base + __popc(m & ((1u << lane) - 1u))] = r;
    }
    __syncthreads();
    int jdy[4], jdx[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = lane + 32 * s;
      jdy[s] = j / p.Wl - ch;
      jdx[s] = j % p.Wl - cw;
    }
    const int nchk = *s_nent;
    for (int i0 = warp; i0 < nchk; i0 += 2 * nwarps) {
      int ids[2], rows[2];
      bool bad[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * nwarps;
        ids[u] = i < nchk ? chk[i] : -1;
        rows[u] = ids[u] >= 0 ? s_ent[ids[u]] : -1;
        const int row = rows[u] < 0 ? 0 : rows[u];
        const int l = row / N, n = row - l * N, ny = n / W, nx = n - ny * W;
        const float* e = f + (size_t)n * p.C + 6 * K1 + l * NW;
        bad[u] = false;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = lane + 32 * s, y = ny + jdy[s], x = nx + jdx[s];
          if (rows[u] >= 0 && j < NW && y >= 0 && y < H && x >= 0 && x < W)
            bad[u] |= isnan(__ldg(e + j));
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (__any_sync(FULL, bad[u]) && lane == 0) s_ent[ids[u]] = -2;
    }
  }
  __syncthreads();
  // 6c. below a row without a winner nothing is valid: redo each slot's
  //     walk in edge order on the recorded results, then the person filter.
  //     Where the source stays valid its cell is unchanged, so the recorded
  //     row is the one the plain walk consults.
  for (int q = tid; q < P; q += nth) {
    int* cell = s_kpcell + q * K1;
    float* sc = s_kpsc + q * K1;
    int* ok = s_kpok + q * K1;
    for (int l = 0; l < L; ++l) {
      const int s = p.src[l], d = p.dst[l];
      if (!ok[s] || s_ent[q * L + l] == -2) { cell[d] = 0; sc[d] = 0.0f; ok[d] = 0; }
    }
    int nk = 0;
    for (int c = 1; c < K1; ++c) nk += ok[c];
    s_numkp[q] = nk;
    s_pvalid[q] = ok[0] && nk >= p.min_kp;
  }
  __syncthreads();
  stamp(clocks, b, 6);

  // ---- 7. write -----------------------------------------------------------
  // boxes and scores are masked by per-keypoint validity only; kp_valid
  // also by the person filter (ppn_tpu/ops/parse.py parse_single)
  for (int t = tid; t < P * K1; t += nth) {
    const int q = t / K1, c = t - q * K1;
    const size_t o = (size_t)b * P * K1 + t;
    const int cl = s_kpcell[t];
    const bool okv = s_kpok[t] != 0;
    const int cy = cl / W;
    kp_cell[2 * o] = cy;
    kp_cell[2 * o + 1] = cl - cy * W;
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
  if (clocks != nullptr) __syncthreads();  // the write closes here when timed
  stamp(clocks, b, 7);
}

extern "C" {

// Launches ppn_post_kernel on `stream` for B images of the (B, N, C) f32
// feature map; edges holds L (src, dst) pairs in host memory; clocks is null
// or a (B, 8) int64 device buffer for the stage stamps. Returns the CUDA
// error code (0 = launched).
int ppn_post_launch(const float* fm, int32_t* kp_cell, float* kp_box,
                    float* kp_score, uint8_t* kp_valid, uint8_t* valid,
                    int32_t* num_kp, int device, int B, int H, int W, int C,
                    int K1, int L, int Hl, int Wl, int P, float sx, float sy,
                    float img_w, float img_h, float det_t, float nms_t,
                    int min_kp, int size_exp, const int32_t* edges,
                    int64_t* clocks, void* stream) {
  // the walk's list of consulted rows (P·L) lives in the mask's space
  const long long mask_words = (long long)K1 * H * W * ((H * W + 31) / 32);
  if (B < 1 || L < 1 || L > PPN_MAX_LIMBS || P > H * W || H * W > 0xffff ||
      Hl * Wl > PPN_MAX_WINDOW || (long long)P * L > mask_words)
    return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  PostParams p;
  p.H = H; p.W = W; p.C = C; p.K1 = K1; p.L = L; p.Hl = Hl; p.Wl = Wl;
  p.P = P; p.min_kp = min_kp; p.size_exp = size_exp;
  p.sx = sx; p.sy = sy; p.img_w = img_w; p.img_h = img_h;
  p.det_t = det_t; p.nms_t = nms_t;
  for (int l = 0; l < L; ++l) { p.src[l] = edges[2 * l]; p.dst[l] = edges[2 * l + 1]; }
  int cur;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the dynamic shared-memory limit is raised once per device and size
  static int smem_set[64];
  const size_t smem = smem_layout(H, W, K1, L, P).total * 4;
  if ((int)smem > smem_set[device]) {
    err = cudaFuncSetAttribute(ppn_post_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = (int)smem;
  }
  ppn_post_kernel<<<B, PPN_THREADS, smem, (cudaStream_t)stream>>>(
      fm, p, kp_cell, kp_box, kp_score, kp_valid, valid, num_kp, clocks);
  return (int)cudaGetLastError();
}

const char* ppn_post_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
