// DAMSM word-region similarity, forward and image gradient, for Hopper
// (sm_90a).  Two kernels, both still the first design:
//
//   K1 damsm_sim_fwd    replaces sba_gan_tpu/ops/damsm_sim.py:_fwd_kernel
//   K2 damsm_sim_dimg   replaces sba_gan_tpu/ops/damsm_sim.py:_dimg_kernel
//
// The word gradient (K3, _dwords_kernel) has a design of its own on the
// tensor cores, in damsm_dwords.cu.  What the two files share (the row
// scalars, warp reductions, the split sum, the shared-memory cap) is in
// damsm_common.cuh.
//
// For text i (words W_i, T x D, of which the first L_i are real) and image j
// (regions X_j, R x D), with gamma1 g1 and gamma2 g2:
//
//     S  = W_i X_j^T                      (L x R) word/region scores
//     A1 = softmax over words of S        (Eq. 8)
//     A2 = softmax over regions of g1 A1  (Eq. 9)
//     C  = A2 X_j                         (L x D) region context per word
//     rs = g2 cos(W_i[t], C[t])           per word
//     sim[i, j] = logsumexp_t rs          (Eq. 10)
//
// Words t >= L_i take no part: the JAX package masks them with -1e9 before
// both softmaxes, which gives them exactly zero weight in Eq. 8 and Eq. 10
// and zero gradient, so the kernels skip them and write zero gradient there.
//
// K2 returns d_img[j] = sum_i g[i, j] d sim[i, j] / d X_j.  It recomputes
// the pair's forward and runs the backward of _pair_backward
// (damsm_sim.py:90-151).
//
// What bounds them on this card: operations.  A pair costs 4 L R D flops
// forward (S, C); K2 recomputes them and adds dA2, A2^T dC and dS^T W, 10
// L R D in all; against (L + R) D * 4 bytes of input, 19 to 47 flops a
// byte at L 20, R 289, D 256 (each pair's
// inputs read once), and at B 32 all of img (9.5 MB)
// stays in L2.  The products run in float32 on the CUDA cores (67 TFLOP/s),
// computed here, with no library call.
//
// Design (simple and right first):
//   * one block of 256 threads per pair (K1) or per (image, range of
//     texts) (K2).  K2 writes one partial sum per range into scratch that
//     only the block owns, and a second kernel sums the ranges in a fixed
//     order: deterministic, no atomics.
//   * W_i, C (later dC), and two (L x R) matrices (A1/A2 and A2/dA...) sit in
//     shared memory; X_j does not fit (289 x 256 x 4 = 296 KB) and streams
//     through shared memory in chunks of 16 regions, once per product.
//   * row strides are padded (D + 4, R rounded up to 4) so that float4 reads
//     stay aligned and a warp's rows fall in different banks.
//   * A2 is not kept beside A1 in the backward: it is recomputed from A1 and
//     the per-word row max and sum of Eq. 9, with the same rounding.
// Making them fast (the tensor-core product core of damsm_dwords.cu) is
// later work.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

#include "damsm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;   // regions of X staged in shared memory at a time
constexpr int kRowVals = 12; // per-word scalars kept in shared memory
static_assert(kRowCount <= kRowVals, "row scalars");

__host__ __device__ inline int pad_d(int d) { return d + 4; }
__host__ __device__ inline int pad_r(int r) { return (r + 3) & ~3; }

size_t smem_bytes(int t, int r, int d) {
  const size_t floats = static_cast<size_t>(t) * (2 * pad_d(d) + 2 * pad_r(r)) +
                        static_cast<size_t>(kChunk) * pad_d(d) + kRowVals * kMaxT;
  return floats * sizeof(float);
}

struct Smem {
  float* w;    // (T, Dp) words of the text
  float* c;    // (T, Dp) context C, then its gradient dC
  float* p;    // (T, Rp) A1, then A2 in the backward's last step
  float* q;    // (T, Rp) A2, then A2*dA2, dA1, dS
  float* x;    // (kChunk, Dp) staged regions
  float* row;  // (kRowVals, kMaxT) per-word scalars
  int dp, rp;
};

__device__ Smem carve(float* base, int t, int r, int d) {
  Smem s;
  s.dp = pad_d(d);
  s.rp = pad_r(r);
  s.w = base;
  s.c = s.w + t * s.dp;
  s.p = s.c + t * s.dp;
  s.q = s.p + t * s.rp;
  s.x = s.q + t * s.rp;
  s.row = s.x + kChunk * s.dp;
  return s;
}

// Zero the padding columns R..Rp-1 of p and q: the float4 reads of the
// context and d_img passes cover them, against staged rows that are zero.
__device__ void zero_pad_columns(const Smem& s, int t_rows, int r) {
  const int extra = s.rp - r;
  for (int i = threadIdx.x; i < t_rows * extra; i += blockDim.x) {
    const int t = i / extra, col = r + i % extra;
    s.p[t * s.rp + col] = 0.f;
    s.q[t * s.rp + col] = 0.f;
  }
}

__device__ void load_words(const Smem& s, const float* __restrict__ wg, int l, int d) {
  const int d4 = d / 4;
  const float4* src = reinterpret_cast<const float4*>(wg);
  for (int i = threadIdx.x; i < l * d4; i += blockDim.x) {
    const int t = i / d4, k = i % d4;
    *reinterpret_cast<float4*>(s.w + t * s.dp + 4 * k) = src[i];
  }
}

// Regions r0 .. r0+nr-1 of X into s.x; rows nr..kChunk-1 are zero.
__device__ void stage_regions(const Smem& s, const float* __restrict__ xg, int r0,
                              int nr, int d) {
  const int d4 = d / 4;
  const float4* src = reinterpret_cast<const float4*>(xg + static_cast<size_t>(r0) * d);
  for (int i = threadIdx.x; i < kChunk * d4; i += blockDim.x) {
    const int rr = i / d4, k = i % d4;
    const float4 v = rr < nr ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(s.x + rr * s.dp + 4 * k) = v;
  }
}

// out[t][r] = sum_d a[t][d] X[r][d] for t < l, every r (kMul: out[t][r] *=
// that sum instead).  a and out in shared memory, X streamed.  Thread
// (rr, tg) takes region rr of the chunk and words tg and tg + 16.
template <bool kMul>
__device__ void scores_pass(const Smem& s, const float* a, float* out,
                            const float* __restrict__ xg, int l, int r, int d) {
  const int rr = threadIdx.x % kChunk, tg = threadIdx.x / kChunk;
  const int d4 = d / 4;
  for (int r0 = 0; r0 < r; r0 += kChunk) {
    const int nr = min(kChunk, r - r0);
    __syncthreads();
    stage_regions(s, xg, r0, nr, d);
    __syncthreads();
    if (rr >= nr || tg >= l) continue;
    const bool second = tg + 16 < l;
    const float4* xr = reinterpret_cast<const float4*>(s.x + rr * s.dp);
    const float4* a0 = reinterpret_cast<const float4*>(a + tg * s.dp);
    const float4* a1 = reinterpret_cast<const float4*>(a + (tg + 16) * s.dp);
    float acc0 = 0.f, acc1 = 0.f;
    for (int k = 0; k < d4; ++k) {
      const float4 xv = xr[k];
      const float4 u = a0[k];
      acc0 = fmaf(u.x, xv.x, acc0);
      acc0 = fmaf(u.y, xv.y, acc0);
      acc0 = fmaf(u.z, xv.z, acc0);
      acc0 = fmaf(u.w, xv.w, acc0);
      if (second) {
        const float4 v = a1[k];
        acc1 = fmaf(v.x, xv.x, acc1);
        acc1 = fmaf(v.y, xv.y, acc1);
        acc1 = fmaf(v.z, xv.z, acc1);
        acc1 = fmaf(v.w, xv.w, acc1);
      }
    }
    float* o0 = out + tg * s.rp + r0 + rr;
    *o0 = kMul ? *o0 * acc0 : acc0;
    if (second) {
      float* o1 = out + (tg + 16) * s.rp + r0 + rr;
      *o1 = kMul ? *o1 * acc1 : acc1;
    }
  }
  __syncthreads();
}

// acc[k] += sum_r a[t][r] X[r][d] for t = tg + G k < l, where thread
// (d, tg) = (tid % D, tid / D) and G = blockDim / D.  a in shared memory
// (zero in its padding columns), X streamed.
__device__ void context_pass(const Smem& s, const float* a, float (&acc)[kMaxT],
                             const float* __restrict__ xg, int l, int r, int d) {
  const int groups = blockDim.x / d;
  const int dd = threadIdx.x % d, tg = threadIdx.x / d;
  for (int r0 = 0; r0 < r; r0 += kChunk) {
    const int nr = min(kChunk, r - r0);
    __syncthreads();
    stage_regions(s, xg, r0, nr, d);
    __syncthreads();
    if (tg >= groups) continue;
    for (int rr = 0; rr < nr; rr += 4) {
      const float x0 = s.x[rr * s.dp + dd];
      const float x1 = s.x[(rr + 1) * s.dp + dd];
      const float x2 = s.x[(rr + 2) * s.dp + dd];
      const float x3 = s.x[(rr + 3) * s.dp + dd];
#pragma unroll
      for (int k = 0; k < kMaxT; ++k) {
        const int t = tg + groups * k;
        if (t < l) {
          const float4 av = *reinterpret_cast<const float4*>(a + t * s.rp + r0 + rr);
          float v = acc[k];
          v = fmaf(av.x, x0, v);
          v = fmaf(av.y, x1, v);
          v = fmaf(av.z, x2, v);
          v = fmaf(av.w, x3, v);
          acc[k] = v;
        }
      }
    }
  }
  __syncthreads();
}

// The pair forward up to Eq. 10.  Needs s.w loaded (l rows) and returns, in
// s.row: M2/S2 (Eq. 9 row max and sum), Num/Wn/Cn/Rs per word, and Lse.
// Leaves A1 in s.p, A2 in s.q and C in s.c.
__device__ void pair_forward(const Smem& s, const float* __restrict__ xg, int l,
                             int r, int d, float g1, float g2) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* row = s.row;

  scores_pass<false>(s, s.w, s.p, xg, l, r, d);

  // Eq. 8: softmax over the l real words, one thread per region.
  for (int rr = threadIdx.x; rr < r; rr += blockDim.x) {
    float m = -FLT_MAX;
    for (int t = 0; t < l; ++t) m = fmaxf(m, s.p[t * s.rp + rr]);
    float sum = 0.f;
    for (int t = 0; t < l; ++t) {
      const float e = expf(s.p[t * s.rp + rr] - m);
      s.p[t * s.rp + rr] = e;
      sum += e;
    }
    for (int t = 0; t < l; ++t) s.p[t * s.rp + rr] = s.p[t * s.rp + rr] / sum;
  }
  __syncthreads();

  // Eq. 9: softmax over regions of g1 A1, one warp per word.
  for (int t = warp; t < l; t += kWarps) {
    const float* a1 = s.p + t * s.rp;
    float* a2 = s.q + t * s.rp;
    float m = -FLT_MAX;
    for (int rr = lane; rr < r; rr += 32) m = fmaxf(m, region_logit(g1, a1[rr]));
    m = warp_max(m);
    float sum = 0.f;
    for (int rr = lane; rr < r; rr += 32) {
      const float e = expf(region_logit(g1, a1[rr]) - m);
      a2[rr] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int rr = lane; rr < r; rr += 32) a2[rr] = a2[rr] / sum;
    if (lane == 0) {
      row[kM2 * kMaxT + t] = m;
      row[kS2 * kMaxT + t] = sum;
    }
  }

  // C = A2 X
  float acc[kMaxT];
#pragma unroll
  for (int k = 0; k < kMaxT; ++k) acc[k] = 0.f;
  context_pass(s, s.q, acc, xg, l, r, d);
  {
    const int groups = blockDim.x / d;
    const int dd = threadIdx.x % d, tg = threadIdx.x / d;
    if (tg < groups) {
#pragma unroll
      for (int k = 0; k < kMaxT; ++k) {
        const int t = tg + groups * k;
        if (t < l) s.c[t * s.dp + dd] = acc[k];
      }
    }
  }
  __syncthreads();

  // cosine per word, one warp per word
  for (int t = warp; t < l; t += kWarps) {
    float num = 0.f, ww = 0.f, cc = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float w = s.w[t * s.dp + k], c = s.c[t * s.dp + k];
      num = fmaf(w, c, num);
      ww = fmaf(w, w, ww);
      cc = fmaf(c, c, cc);
    }
    num = warp_sum(num);
    ww = warp_sum(ww);
    cc = warp_sum(cc);
    if (lane == 0) {
      const float wn = sqrtf(ww), cn = sqrtf(cc);
      row[kNum * kMaxT + t] = num;
      row[kWn * kMaxT + t] = wn;
      row[kCn * kMaxT + t] = cn;
      row[kRs * kMaxT + t] = g2 * num / fmaxf(wn * cn, kEps);
    }
  }
  __syncthreads();

  // Eq. 10: logsumexp over the real words (l <= 32: one warp)
  if (warp == 0) {
    const float v = lane < l ? row[kRs * kMaxT + lane] : -FLT_MAX;
    const float m = warp_max(v);
    const float e = lane < l ? expf(v - m) : 0.f;
    const float sum = warp_sum(e);
    if (lane == 0) row[kLse * kMaxT] = m + logf(sum);
    if (lane == 1) row[kLse * kMaxT + 1] = sum;
    if (lane == 2) row[kLse * kMaxT + 2] = m;
  }
  __syncthreads();
}

// The image side of the pair backward for cotangent g of sim[i, j], after
// pair_forward: dx (R x D in global memory, owned by the block) gets
// dsim/dX_j, added (first == false) or written (first == true).
__device__ void pair_backward(const Smem& s, const float* __restrict__ xg, int l,
                              int r, int d, float g1, float g2, float g,
                              float* __restrict__ dx, bool first) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* row = s.row;
  const int groups = blockDim.x / d;
  const int dd = threadIdx.x % d, tg = threadIdx.x / d;

  // logsumexp -> cosine backward: per-word coefficients
  if (warp == 0 && lane < l) {
    const float sum = row[kLse * kMaxT + 1], m = row[kLse * kMaxT + 2];
    const float p = expf(row[kRs * kMaxT + lane] - m) / sum;
    const float d_rs = g * p;
    const float num = row[kNum * kMaxT + lane];
    const float wn = row[kWn * kMaxT + lane], cn = row[kCn * kMaxT + lane];
    const float denom_raw = wn * cn;
    const float denom = fmaxf(denom_raw, kEps);
    const float d_num = d_rs * g2 / denom;
    const float d_denom = denom_raw > kEps ? -d_rs * g2 * num / (denom * denom) : 0.f;
    row[kDNum * kMaxT + lane] = d_num;
    row[kFc * kMaxT + lane] = d_denom * wn / fmaxf(cn, kEps);
    row[kFw * kMaxT + lane] = d_denom * cn / fmaxf(wn, kEps);
  }
  __syncthreads();

  // dC = d_num W + fc C (into s.c)
  if (tg < groups) {
#pragma unroll
    for (int k = 0; k < kMaxT; ++k) {
      const int t = tg + groups * k;
      if (t < l) {
        const float dn = row[kDNum * kMaxT + t];
        const float c = s.c[t * s.dp + dd], w = s.w[t * s.dp + dd];
        s.c[t * s.dp + dd] = dn * w + row[kFc * kMaxT + t] * c;
      }
    }
  }
  // (scores_pass starts with a barrier)

  // u = A2 * dA2 with dA2 = dC X^T, in s.q
  scores_pass<true>(s, s.c, s.q, xg, l, r, d);

  // inner2[t] = sum_r u, one warp per word
  for (int t = warp; t < l; t += kWarps) {
    float v = 0.f;
    for (int rr = lane; rr < r; rr += 32) v += s.q[t * s.rp + rr];
    v = warp_sum(v);
    if (lane == 0) row[kInner2 * kMaxT + t] = v;
  }
  __syncthreads();

  // dA1 = g1 A2 (dA2 - inner2) = g1 (u - A2 inner2), then per region
  // inner1 = sum_t dA1 A1 and dS = A1 (dA1 - inner1); p takes A2 back.
  for (int rr = threadIdx.x; rr < r; rr += blockDim.x) {
    float inner1 = 0.f;
    for (int t = 0; t < l; ++t) {
      const float a1 = s.p[t * s.rp + rr];
      const float a2 = expf(region_logit(g1, a1) - row[kM2 * kMaxT + t]) /
                       row[kS2 * kMaxT + t];
      const float da1 = g1 * (s.q[t * s.rp + rr] - a2 * row[kInner2 * kMaxT + t]);
      s.q[t * s.rp + rr] = da1;
      inner1 = fmaf(da1, a1, inner1);
    }
    for (int t = 0; t < l; ++t) {
      const float a1 = s.p[t * s.rp + rr];
      s.q[t * s.rp + rr] = a1 * (s.q[t * s.rp + rr] - inner1);
      s.p[t * s.rp + rr] = expf(region_logit(g1, a1) - row[kM2 * kMaxT + t]) /
                           row[kS2 * kMaxT + t];
    }
  }
  __syncthreads();

  // dX = A2^T dC + dS^T W: thread (d, rg) takes regions 4 rg .. 4 rg + 3,
  // then every 4 G-th.
  if (tg < groups) {
    for (int r4 = 4 * tg; r4 < r; r4 += 4 * groups) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int t = 0; t < l; ++t) {
        const float c = s.c[t * s.dp + dd], w = s.w[t * s.dp + dd];
        const float4 pv = *reinterpret_cast<const float4*>(s.p + t * s.rp + r4);
        const float4 qv = *reinterpret_cast<const float4*>(s.q + t * s.rp + r4);
        a0 = fmaf(pv.x, c, fmaf(qv.x, w, a0));
        a1 = fmaf(pv.y, c, fmaf(qv.y, w, a1));
        a2 = fmaf(pv.z, c, fmaf(qv.z, w, a2));
        a3 = fmaf(pv.w, c, fmaf(qv.w, w, a3));
      }
      const float vals[4] = {a0, a1, a2, a3};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (r4 + m < r) {
          float* o = dx + static_cast<size_t>(r4 + m) * d + dd;
          *o = first ? vals[m] : *o + vals[m];
        }
      }
    }
  }
  __syncthreads();
}

// K1: one block per (image j, text i).
__global__ void __launch_bounds__(kThreads) damsm_sim_fwd_kernel(
    const float* __restrict__ words, const float* __restrict__ img,
    const int* __restrict__ lens, float* __restrict__ sim, int bj, int t_len,
    int r, int d, float g1, float g2) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), t_len, r, d);
  const int j = blockIdx.x, i = blockIdx.y;
  const int l = lens[i];
  zero_pad_columns(s, t_len, r);
  load_words(s, words + static_cast<size_t>(i) * t_len * d, l, d);
  pair_forward(s, img + static_cast<size_t>(j) * r * d, l, r, d, g1, g2);
  if (threadIdx.x == 0) sim[static_cast<size_t>(i) * bj + j] = s.row[kLse * kMaxT];
}

// K2: one block per (image j, range of texts); part[split][j] (R x D).
__global__ void __launch_bounds__(kThreads) damsm_sim_dimg_kernel(
    const float* __restrict__ words, const float* __restrict__ img,
    const int* __restrict__ lens, const float* __restrict__ grad,
    float* __restrict__ part, int b, int bj, int t_len, int r, int d, int chunk,
    float g1, float g2) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), t_len, r, d);
  const int j = blockIdx.x, split = blockIdx.y;
  const float* xg = img + static_cast<size_t>(j) * r * d;
  float* dx = part + (static_cast<size_t>(split) * bj + j) * r * d;
  zero_pad_columns(s, t_len, r);
  const int i0 = split * chunk, i1 = min(b, i0 + chunk);
  for (int i = i0; i < i1; ++i) {
    const int l = lens[i];
    __syncthreads();  // s.w of the previous text is no longer read
    load_words(s, words + static_cast<size_t>(i) * t_len * d, l, d);
    pair_forward(s, xg, l, r, d, g1, g2);
    pair_backward(s, xg, l, r, d, g1, g2, grad[static_cast<size_t>(i) * bj + j], dx,
                  i == i0);
  }
}

bool shape_ok(int b, int bj, int t_len, int r, int d) {
  return b >= 1 && b <= 65535 && bj >= 1 && t_len >= 1 && t_len <= kMaxT &&
         r >= 1 && d >= 4 && d <= kMaxD && d % 4 == 0 &&
         smem_bytes(t_len, r, d) <= kSmemLimit;
}

size_t fwd_granted[kMaxDevices], dimg_granted[kMaxDevices];

}  // namespace

// Plain C entry points, loaded with ctypes.  Device pointers to contiguous
// arrays: words (B, T, D) and img (Bj, R, D) float32, lens (B,) int32 with
// every length in [1, T], grad and sim (B, Bj) float32.  Each launches on
// `stream` and returns cudaGetLastError() (0 on success).

extern "C" int damsm_sim_fwd(const float* words, const float* img, const int* lens,
                             float* sim, int b, int bj, int t_len, int r, int d,
                             float g1, float g2, cudaStream_t stream) {
  if (!shape_ok(b, bj, t_len, r, d)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(t_len, r, d);
  cudaError_t err = allow_smem(damsm_sim_fwd_kernel, bytes, fwd_granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  damsm_sim_fwd_kernel<<<dim3(bj, b), kThreads, bytes, stream>>>(
      words, img, lens, sim, bj, t_len, r, d, g1, g2);
  return static_cast<int>(cudaGetLastError());
}

// part: scratch of splits * Bj * R * D floats, splits = ceil(B / chunk); when
// splits == 1 it may be d_img itself.  d_img (Bj, R, D).
extern "C" int damsm_sim_dimg(const float* words, const float* img, const int* lens,
                              const float* grad, float* part, float* d_img, int b,
                              int bj, int t_len, int r, int d, int chunk, float g1,
                              float g2, cudaStream_t stream) {
  if (!shape_ok(b, bj, t_len, r, d) || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (b + chunk - 1) / chunk;
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(t_len, r, d);
  cudaError_t err = allow_smem(damsm_sim_dimg_kernel, bytes, dimg_granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  damsm_sim_dimg_kernel<<<dim3(bj, splits), kThreads, bytes, stream>>>(
      words, img, lens, grad, part, b, bj, t_len, r, d, chunk, g1, g2);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      sum_splits(part, d_img, splits, static_cast<size_t>(bj) * r * d, stream));
}
