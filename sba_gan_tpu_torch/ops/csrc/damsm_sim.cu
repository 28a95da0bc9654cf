// DAMSM word-region similarity, forward and image gradient, for Hopper
// (sm_90a), on the tensor cores:
//
//   K1 damsm_sim_fwd    replaces sba_gan_tpu/ops/damsm_sim.py:_fwd_kernel
//   K2 damsm_sim_dimg   replaces sba_gan_tpu/ops/damsm_sim.py:_dimg_kernel
//
// K1 returns sim (B, Bj) (Eq. 10 of each pair, damsm_common.cuh).  K2
// returns d_img[j] = sum_i g[i, j] d sim[i, j] / d X_j: it recomputes each
// pair's forward and runs the image side of the backward of _pair_backward
// (damsm_sim.py:90-151):
//
//     dC -> dA2 = dC X^T -> dA1 -> dS;   dX = A2^T dC + dS^T W
//
// What bounds them on this card: operations.  A pair costs 4 L R D flops
// forward (S, C); K2 recomputes them and adds dA2, A2^T dC and dS^T W, 10
// L R D in all, against (L + R) D * 4 bytes of input.  The first design ran
// them as scalar float32 FMAs on the CUDA cores with both operands read
// from shared memory, staged X synchronously in chunks of 16 regions
// between two barriers, ran K1 as one block of 256 threads per pair and K2
// as one text at a time per block, adding each text's dX into global
// memory with scalar read-modify-writes: 12.6x (K2) and 14.5x (K1) its
// float32 bound at B 32 T 20.
//
// What this design does about it: both kernels run on the product core of
// damsm_common.cuh, the one K3 (damsm_dwords.cu) runs -- the products on the
// tensor cores in 3xTF32 mma.sync, X through the two-stage cp.async ring
// tracked by mbarriers, two texts a block where shared memory allows (one
// at T 32), 16 warps, one block a SM, one wave of blocks (the grids are
// sized by the caller, ops/damsm_sim.py).
//
//   * K1: a block takes a group of texts and a range of images, two passes
//     over each image (S, then C), the ring running on into the next image;
//     then the cosine and the log-sum-exp, and sim[i, j] is written once:
//     no partial sums.
//   * K2: a block takes image j and a range of text groups.  Per group it
//     runs K3's passes (S, C, then u = A2 * dA2), the ring running on from
//     one group into the next (chunk 0 of X_j again), then the image-side
//     product dX_j += A2^T dC + dS^T W as one product on the tensor cores:
//     M the regions (16-row tiles), N the channels (8), K the real words of
//     both texts twice, [A2; dS] against [dC; W].  It reads no X, so the
//     next group's first chunk loads meanwhile.  The operands are read
//     transposed (lanes tq along the words); fragment column c of a k-step
//     stands for word 2 (c % 4) + c / 4 in both operands (a permutation of
//     K leaves the product as it is), which puts the four word rows of a
//     read two rows apart: at row strides of 4 mod 8 (D + 4, Rp) the reads
//     fall in 32 banks.  dX_j (296 KB at R 289, D 256) fits neither shared
//     memory nor registers: each warp owns a set of (32-region x
//     32-channel) tiles of the block's slice of `part`, loads them, adds the
//     group and stores them back (the first group writes); region rows >= R
//     are never stored.  Fixed order, no atomics: the result is the same
//     bit for bit from run to run.  The ranges of texts are added in split
//     order by sum_splits.  Texts change within a block, so rows >= L of
//     the shared arrays hold the previous group's values: every pass stops
//     at L or drops those rows, and the K side of the image-side product
//     reads zero past L.
// What bounds them still (scripts/torch_kernel_variants.py): as for K3,
// plain TF32 (a third of the MMAs) saves only 11-17%, so the passes are
// bound by instruction latency and the per-chunk barriers at one block a
// SM, not by the tensor cores.

#include <cstddef>
#include <cuda_runtime.h>

#include "damsm_common.cuh"

namespace {

// dX (+)= sum over the block's texts of A2^T dC + dS^T W (A2 in p, dS in
// q, dC in c, W in w), into dx (R x D, global memory, owned by the block).
// A warp takes (kMB 16-region x kNB 8-channel) tiles at a time; word k of
// a k-step at column 2 (k % 4) + k / 4 (see the note at the top).
constexpr int kMB = 2, kNB = 4;

template <int kTexts>
__device__ __forceinline__ void image_product(const Block<kTexts>& bk, float* __restrict__ dx,
                                              bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r = bk.r, d = bk.d;
  const int mtiles = (r + 15) / 16, ntiles = bk.d8 / 8;
  const int nb = (ntiles + kNB - 1) / kNB;
  const int batches = (mtiles + kMB - 1) / kMB * nb;
  for (int batch = warp; batch < batches; batch += kWarps) {
    const int mt0 = batch / nb * kMB, nt0 = batch % nb * kNB;
    float acc[kMB][kNB][4];
#pragma unroll
    for (int i = 0; i < kMB; ++i)
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (mt0 + i) * 16 + g + 8 * h, col = (nt0 + j) * 8 + 2 * tq;
          float2 v = make_float2(0.f, 0.f);
          if (!first && row < r && col < d)
            v = *reinterpret_cast<const float2*>(dx + static_cast<size_t>(row) * d + col);
          acc[i][j][2 * h] = v.x;
          acc[i][j][2 * h + 1] = v.y;
        }
#pragma unroll
    for (int a = 0; a < kTexts; ++a) {
      const int l = bk.len(a);
      const TextSmem ts = bk.text(a);
#pragma unroll
      for (int seg = 0; seg < 2; ++seg) {
        const float* am = seg == 0 ? ts.p : ts.q;  // A2, dS: (T, Rp)
        const float* bm = seg == 0 ? ts.c : ts.w;  // dC, W: (T, Dp)
        for (int k0 = 0; k0 < l; k0 += 8) {
          const int k = k0 + 2 * tq;  // words k (column tq) and k + 1 (tq + 4)
          const bool v0 = k < l, v1 = k + 1 < l;
          const float* a0 = am + k * bk.rp;
          const float* a1 = a0 + bk.rp;
          const float* b0 = bm + k * bk.dp;
          const float* b1 = b0 + bk.dp;
          Split<4> af[kMB];
          Split<2> bf[kNB];
#pragma unroll
          for (int i = 0; i < kMB; ++i) {
            const int m = (mt0 + i) * 16 + g;
            const bool ok = mt0 + i < mtiles;
            const float av[4] = {ok && v0 ? a0[m] : 0.f, ok && v0 ? a0[m + 8] : 0.f,
                                 ok && v1 ? a1[m] : 0.f, ok && v1 ? a1[m + 8] : 0.f};
            af[i].set(av);
          }
#pragma unroll
          for (int j = 0; j < kNB; ++j) {
            const int n = (nt0 + j) * 8 + g;
            const bool ok = nt0 + j < ntiles;
            const float bv[2] = {ok && v0 ? b0[n] : 0.f, ok && v1 ? b1[n] : 0.f};
            bf[j].set(bv);
          }
          // term by term over the tiles: an accumulator's MMAs are kMB kNB apart
#pragma unroll
          for (int i = 0; i < kMB; ++i)
#pragma unroll
            for (int j = 0; j < kNB; ++j)
              if (mt0 + i < mtiles && nt0 + j < ntiles) mma_tf32(acc[i][j], af[i].lo, bf[j].hi);
#pragma unroll
          for (int i = 0; i < kMB; ++i)
#pragma unroll
            for (int j = 0; j < kNB; ++j)
              if (mt0 + i < mtiles && nt0 + j < ntiles) mma_tf32(acc[i][j], af[i].hi, bf[j].lo);
#pragma unroll
          for (int i = 0; i < kMB; ++i)
#pragma unroll
            for (int j = 0; j < kNB; ++j)
              if (mt0 + i < mtiles && nt0 + j < ntiles) mma_tf32(acc[i][j], af[i].hi, bf[j].hi);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMB; ++i)
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (mt0 + i) * 16 + g + 8 * h, col = (nt0 + j) * 8 + 2 * tq;
          if (row < r && col < d)
            *reinterpret_cast<float2*>(dx + static_cast<size_t>(row) * d + col) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
  }
}

// K1: one block per (group of kTexts texts, range of images); sim (B, Bj).
template <int kTexts>
__global__ void __launch_bounds__(kThreads, 1) damsm_sim_fwd_kernel(
    const float* __restrict__ words, const float* __restrict__ img,
    const int* __restrict__ lens, float* __restrict__ sim, int b, int bj, int t_len, int r,
    int d, int chunk, float g1, float g2) {
  extern __shared__ float4 smem4[];
  Block<kTexts> bk = setup_block<kTexts>(reinterpret_cast<char*>(smem4), t_len, r, d);
  const int i0 = blockIdx.x * kTexts;
  load_words<kTexts>(bk, words, lens, i0, b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int j0 = blockIdx.y * chunk, j1 = min(bj, j0 + chunk);
  const size_t img_floats = static_cast<size_t>(r) * d;
  start_stream(bk, img + j0 * img_floats);
  for (int j = j0; j < j1; ++j) {
    const float* xg = img + j * img_floats;
    pair_forward<kTexts>(bk, xg, j + 1 < j1 ? xg + img_floats : nullptr, g1, g2);
    // Eq. 10: log-sum-exp over the real words (L <= 32: one warp a text)
    if (warp < kTexts && bk.len(warp) > 0) {
      const int l = bk.len(warp);
      const float v = lane < l ? bk.text(warp).row[kRs * kMaxT + lane] : -FLT_MAX;
      const float m = warp_max(v);
      const float sum = warp_sum(lane < l ? expf(v - m) : 0.f);
      if (lane == 0) sim[static_cast<size_t>(i0 + warp) * bj + j] = m + logf(sum);
    }
    // (the next pass starts with a barrier)
  }
}

// K2: one block per (image j, range of text groups); part[split][j] (R x D).
template <int kTexts>
__global__ void __launch_bounds__(kThreads, 1) damsm_sim_dimg_kernel(
    const float* __restrict__ words, const float* __restrict__ img,
    const int* __restrict__ lens, const float* __restrict__ grad, float* __restrict__ part,
    int b, int bj, int t_len, int r, int d, int chunk, float g1, float g2) {
  extern __shared__ float4 smem4[];
  Block<kTexts> bk = setup_block<kTexts>(reinterpret_cast<char*>(smem4), t_len, r, d);
  const int j = blockIdx.x;
  const float* xg = img + static_cast<size_t>(j) * r * d;
  float* dx = part + (static_cast<size_t>(blockIdx.y) * bj + j) * r * d;
  const int groups = (b + kTexts - 1) / kTexts;
  const int g0 = blockIdx.y * chunk, g_end = min(groups, g0 + chunk);

  start_stream(bk, xg);
  for (int grp = g0; grp < g_end; ++grp) {
    const int i0 = grp * kTexts;
    load_words<kTexts>(bk, words, lens, i0, b);
    pair_forward<kTexts>(bk, xg, xg, g1, g2);
    lse_backward<kTexts>(bk, grad + static_cast<size_t>(i0) * bj + j, bj, g2);
    // dC = d_num W + fc C
#pragma unroll
    for (int a = 0; a < kTexts; ++a) {
      const TextSmem ts = bk.text(a);
      for (int i = threadIdx.x; i < bk.len(a) * d; i += kThreads) {
        const int t = i / d, ch = i - t * d;
        float* c = ts.c + t * bk.dp + ch;
        *c = ts.row[kDNum * kMaxT + t] * ts.w[t * bk.dp + ch] + ts.row[kFc * kMaxT + t] * *c;
      }
    }
    // (the next pass starts with a barrier)
    pair_ds<kTexts, true>(bk, xg, grp + 1 < g_end ? xg : nullptr, g1);
    __syncthreads();
    image_product<kTexts>(bk, dx, grp == g0);
    __syncthreads();  // w, c, p and q are free for the next group
  }
}

size_t fwd_granted1[kMaxDevices], fwd_granted2[kMaxDevices];
size_t dimg_granted1[kMaxDevices], dimg_granted2[kMaxDevices];

template <int kTexts>
cudaError_t launch_fwd(const float* words, const float* img, const int* lens, float* sim, int b,
                       int bj, int t_len, int r, int d, int chunk, float g1, float g2,
                       int splits, cudaStream_t stream, size_t (&granted)[kMaxDevices]) {
  const size_t bytes = smem_bytes(kTexts, t_len, r, d);
  const cudaError_t err = allow_smem(damsm_sim_fwd_kernel<kTexts>, bytes, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kTexts - 1) / kTexts, splits);
  damsm_sim_fwd_kernel<kTexts><<<grid, kThreads, bytes, stream>>>(
      words, img, lens, sim, b, bj, t_len, r, d, chunk, g1, g2);
  return cudaGetLastError();
}

template <int kTexts>
cudaError_t launch_dimg(const float* words, const float* img, const int* lens,
                        const float* grad, float* part, int b, int bj, int t_len, int r, int d,
                        int chunk, float g1, float g2, int splits, cudaStream_t stream,
                        size_t (&granted)[kMaxDevices]) {
  const size_t bytes = smem_bytes(kTexts, t_len, r, d);
  const cudaError_t err = allow_smem(damsm_sim_dimg_kernel<kTexts>, bytes, granted);
  if (err != cudaSuccess) return err;
  damsm_sim_dimg_kernel<kTexts><<<dim3(bj, splits), kThreads, bytes, stream>>>(
      words, img, lens, grad, part, b, bj, t_len, r, d, chunk, g1, g2);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Device pointers to contiguous
// arrays: words (B, T, D) and img (Bj, R, D) float32, lens (B,) int32 with
// every length in [1, T], grad and sim (B, Bj) float32.  `texts` texts a
// block (damsm_sim_texts).  Each launches on `stream` and returns
// cudaGetLastError() (0 on success).

// Texts a block takes at this shape: the most (up to two, and no more than
// B) whose block fits in shared memory; 0 if none does.
extern "C" int damsm_sim_texts(int b, int t_len, int r, int d) {
  return block_texts(b, t_len, r, d);
}

// K1; `chunk` images a block.
extern "C" int damsm_sim_fwd(const float* words, const float* img, const int* lens,
                             float* sim, int b, int bj, int t_len, int r, int d, int texts,
                             int chunk, float g1, float g2, cudaStream_t stream) {
  if (!shape_ok(texts, b, bj, t_len, r, d) || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (bj + chunk - 1) / chunk;
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      texts == 2 ? launch_fwd<2>(words, img, lens, sim, b, bj, t_len, r, d, chunk, g1, g2,
                                 splits, stream, fwd_granted2)
                 : launch_fwd<1>(words, img, lens, sim, b, bj, t_len, r, d, chunk, g1, g2,
                                 splits, stream, fwd_granted1));
}

// K2; `chunk` groups of `texts` texts a block.  part: scratch of splits * Bj
// * R * D floats, splits = ceil(ceil(B / texts) / chunk); when splits == 1
// it may be d_img itself.  d_img (Bj, R, D).
extern "C" int damsm_sim_dimg(const float* words, const float* img, const int* lens,
                              const float* grad, float* part, float* d_img, int b, int bj,
                              int t_len, int r, int d, int texts, int chunk, float g1,
                              float g2, cudaStream_t stream) {
  if (!shape_ok(texts, b, bj, t_len, r, d) || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (b + texts - 1) / texts;
  const int splits = (groups + chunk - 1) / chunk;
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      texts == 2 ? launch_dimg<2>(words, img, lens, grad, part, b, bj, t_len, r, d, chunk, g1,
                                  g2, splits, stream, dimg_granted2)
                 : launch_dimg<1>(words, img, lens, grad, part, b, bj, t_len, r, d, chunk, g1,
                                  g2, splits, stream, dimg_granted1);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      sum_splits(part, d_img, splits, static_cast<size_t>(bj) * r * d, stream));
}
