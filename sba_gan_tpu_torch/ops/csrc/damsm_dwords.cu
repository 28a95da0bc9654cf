// DAMSM word gradient (K3) for Hopper (sm_90a), on the tensor cores.
//
// Replaces sba_gan_tpu/ops/damsm_sim.py:_dwords_kernel.  For text i (words
// W_i, T x D, of which the first L_i are real) it returns
//
//     d_words[i] = sum_j g[i, j] d sim[i, j] / d W_i      over all images j
//
// recomputing each pair's forward and running the word side of the
// backward of _pair_backward (damsm_sim.py:90-151):
//
//     S = W X^T  -> A1 (Eq. 8) -> A2 (Eq. 9) -> C = A2 X -> sim (Eq. 10)
//     dC -> dA2 = dC X^T -> dA1 -> dS;   dW = d_num C + fw W + dS X
//
// Padding words get exactly zero.  The sum over images is deterministic:
// one partial sum per range of images, added in a fixed order by a second
// kernel; no atomics.
//
// What bounds it on this card: operations.  Four products per pair (S, C,
// dA2, dS X), 8 L R D flops, against (L + R) D * 4 bytes of input.  The
// first design ran them as scalar float32 FMAs reading shared memory once
// per two FMAs, at 220 registers a thread (one block of 8 warps per SM),
// staging X synchronously four times per pair: 21.8x its float32 bound.
//
// What this design does about it:
//   * the four products run on the tensor cores, mma.sync m16n8k8 TF32,
//     with float32 accuracy kept by the 3xTF32 split (a = big + small, big
//     the top 10 mantissa bits by a mask; small_big + big_small + big_big,
//     float32 accumulation).  Words are the M side (two 16-row tiles a
//     text; a tile past L_i is skipped, rows past L_i are dropped); regions
//     or channels are N or K.  Padded regions read as zero and stay out of
//     the Eq. 8 and 9 softmaxes;
//   * X streams through a ring of two stages filled by cp.async, each
//     stage tracked by an mbarrier that the copies arrive on, so the next
//     chunk of regions loads while the current one is multiplied; the
//     stream runs on across the four passes and into the next image.  The
//     stage is XOR-swizzled so that both fragment shapes read it without
//     bank conflicts;
//   * the word gradient lives in MMA accumulator fragments for the whole
//     range of images (no per-thread kMaxT arrays);
//   * a block takes two texts where shared memory allows (else one)
//     against each image, so each staged chunk of X feeds up to 64 word
//     rows; one block of 16 warps per SM (shared memory allows no second
//     one), one wave of blocks on the card's SMs (the grid is sized by
//     the caller, ops/damsm_sim.py);
//   * in the (words x regions) products every warp owns one tile and a
//     slice of K; the slices' sums meet in shared memory and are added in
//     a fixed order.  Loads of four k-steps go ahead of their MMAs, and the
//     three terms of the split go to separate accumulators, so no MMA waits
//     on the one before it.
// What bounds it still (scripts/torch_kernel_variants.py): with a third
// of the MMAs (plain TF32) it is only ~15% faster, so the product passes
// are bound by instruction latency with one block a SM, not by the tensor
// cores.  The product core (the ring, the two product shapes, the pair
// forward and the backward down to dS) is damsm_common.cuh, which K1 and
// K2 (damsm_sim.cu) run too; this file holds what only K3 does: the word
// gradient in fragments and its last pass, dS X.

#include <cstddef>
#include <cuda_runtime.h>

#include "damsm_common.cuh"

namespace {

// ---- the pair: forward, then the word side of the backward ---------------

template <int kTexts>
__device__ __forceinline__ void pair_dwords(Block<kTexts>& bk, Frags<kTexts>& dw,
                                            const float* __restrict__ xg, const float* next_xg,
                                            const float* gij, int bj, float g1, float g2) {
  const int d = bk.d;
  pair_forward<kTexts>(bk, xg, xg, g1, g2);
  lse_backward<kTexts>(bk, gij, bj, g2);

  // dW += d_num C + fw W on this thread's fragments; dC = d_num W + fc C
  for_each_frag<kTexts>(dw, [&](int a, int t, int ch, float& v) {
    if (t >= bk.len(a) || ch >= d) return;
    const TextSmem ts = bk.text(a);
    const float dn = ts.row[kDNum * kMaxT + t];
    const float c = ts.c[t * bk.dp + ch], w = ts.w[t * bk.dp + ch];
    v += dn * c + ts.row[kFw * kMaxT + t] * w;
    ts.c[t * bk.dp + ch] = dn * w + ts.row[kFc * kMaxT + t] * c;
  });
  // (the next pass starts with a barrier)

  pair_ds<kTexts, false>(bk, xg, xg, g1);

  // dW += dS X
  stream_pass(bk, xg, next_xg, [&](const float* xst, int r0, int) {
    context_chunk<kTexts>(bk, dw, xst, r0);
  });
}

// K3: one block per (group of kTexts texts, range of images);
// part[split][i] (T x D), rows t >= L_i zero.
template <int kTexts>
__global__ void __launch_bounds__(kThreads, 1) damsm_dwords_kernel(
    const float* __restrict__ words, const float* __restrict__ img,
    const int* __restrict__ lens, const float* __restrict__ grad,
    float* __restrict__ part, int b, int bj, int t_len, int r, int d, int chunk,
    float g1, float g2) {
  extern __shared__ float4 smem4[];
  Block<kTexts> bk = setup_block<kTexts>(reinterpret_cast<char*>(smem4), t_len, r, d);
  const int i0 = blockIdx.x * kTexts;
  load_words<kTexts>(bk, words, lens, i0, b);

  Frags<kTexts> dw;
  zero_frags<kTexts>(dw);
  const int j0 = blockIdx.y * chunk, j1 = min(bj, j0 + chunk);
  const size_t img_floats = static_cast<size_t>(r) * d;
  start_stream(bk, img + j0 * img_floats);
  for (int j = j0; j < j1; ++j) {
    const float* xg = img + j * img_floats;
    const float* next_xg = j + 1 < j1 ? xg + img_floats : nullptr;
    pair_dwords<kTexts>(bk, dw, xg, next_xg, grad + static_cast<size_t>(i0) * bj + j, bj,
                        g1, g2);
  }

  for_each_frag<kTexts>(dw, [&](int a, int t, int ch, float& v) {
    if (i0 + a >= b || t >= t_len || ch >= d) return;
    float* out = part + (static_cast<size_t>(blockIdx.y) * b + i0 + a) * t_len * d;
    out[t * d + ch] = t < bk.len(a) ? v : 0.f;
  });
}

size_t granted1[kMaxDevices], granted2[kMaxDevices];

template <int kTexts>
cudaError_t launch(const float* words, const float* img, const int* lens, const float* grad,
                   float* part, int b, int bj, int t_len, int r, int d, int chunk, float g1,
                   float g2, int splits, cudaStream_t stream, size_t (&granted)[kMaxDevices]) {
  const size_t bytes = smem_bytes(kTexts, t_len, r, d);
  const cudaError_t err = allow_smem(damsm_dwords_kernel<kTexts>, bytes, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kTexts - 1) / kTexts, splits);
  damsm_dwords_kernel<kTexts><<<grid, kThreads, bytes, stream>>>(
      words, img, lens, grad, part, b, bj, t_len, r, d, chunk, g1, g2);
  return cudaGetLastError();
}

}  // namespace

// Texts a block takes at this shape: the most (up to kMaxTexts, and no
// more than B) whose block fits in shared memory; 0 if none does.
extern "C" int damsm_dwords_texts(int b, int t_len, int r, int d) {
  return block_texts(b, t_len, r, d);
}

// Plain C entry point, loaded with ctypes.  Device pointers to contiguous
// arrays: words (B, T, D) and img (Bj, R, D) float32, lens (B,) int32 with
// every length in [1, T], grad (B, Bj) float32.  `texts` texts a block
// (damsm_dwords_texts), `chunk` images a block.  part: scratch of splits *
// B * T * D floats, splits = ceil(Bj / chunk); when splits == 1 it may be
// d_words itself.  d_words (B, T, D).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int damsm_sim_dwords(const float* words, const float* img, const int* lens,
                                const float* grad, float* part, float* d_words, int b,
                                int bj, int t_len, int r, int d, int texts, int chunk,
                                float g1, float g2, cudaStream_t stream) {
  if (!shape_ok(texts, b, bj, t_len, r, d) || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (bj + chunk - 1) / chunk;
  if (splits > 65535 || (b + texts - 1) / texts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      texts == 2 ? launch<2>(words, img, lens, grad, part, b, bj, t_len, r, d, chunk, g1, g2,
                             splits, stream, granted2)
                 : launch<1>(words, img, lens, grad, part, b, bj, t_len, r, d, chunk, g1, g2,
                             splits, stream, granted1);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(
      sum_splits(part, d_words, splits, static_cast<size_t>(b) * t_len * d, stream));
}
