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
// cores.  The elementwise steps (the softmaxes, the cosine, the
// log-sum-exp and their backward) are those of K1 and K2 (damsm_sim.cu),
// in float32 on the CUDA cores; what the two files share is in
// damsm_common.cuh.

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "damsm_common.cuh"

namespace {

constexpr int kMaxTexts = 2;  // texts a block may take against each image
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = kWarps / 8;  // warps on each (word tile, region tile) of an S-type chunk
static_assert(kWarps % 8 == 0 && kMaxD / 8 % kWarps == 0, "warps");
constexpr int kStages = 2;
constexpr size_t kBarrierBytes = 16;  // kStages mbarriers, 8 bytes each
constexpr int kRedFloats = kWarps * 32 * 4;  // one float4 a lane of each warp

// Regions per stage: the S-type products give every warp one (16-word,
// 8-region) tile of one text.
__host__ __device__ constexpr int chunk_of(int texts) { return 32 / texts; }
// Row strides in floats.  W and C: D + 4 (4 mod 32 at D 256: a fragment's
// 8 rows x 4 columns fall in 32 banks).  A1 and A2/dS: R rounded up to the
// chunk, + 4 (4 mod 8, the same reason, and every chunk's columns exist).
// X stage: D + 8, swizzled (xcol).
__host__ __device__ inline int pad_d(int d) { return d + 4; }
__host__ __device__ inline int pad_r(int r, int chunk) {
  return (r + chunk - 1) / chunk * chunk + 4;
}
__host__ __device__ inline int pad_x(int d) { return d + 8; }
__host__ __device__ inline int text_floats(int t, int r, int d, int chunk) {
  return t * (2 * pad_d(d) + 2 * pad_r(r, chunk)) + kRowCount * kMaxT;
}

size_t smem_bytes(int texts, int t, int r, int d) {
  const int chunk = chunk_of(texts);
  return kBarrierBytes + (kRedFloats + static_cast<size_t>(kStages) * chunk * pad_x(d) +
                          static_cast<size_t>(texts) * text_floats(t, r, d, chunk)) *
                             sizeof(float);
}

// Column of channel k in row rr of an X stage: rows 4-7 of every 8 swap
// their halves of each 8 channels.  An S-type B fragment (8 regions x 4
// channels) and a C-type one (4 regions x 8 channels) then both fall in 32
// distinct banks at a row stride of 8 mod 32.
__device__ inline int xcol(int rr, int k) { return k ^ (((rr >> 2) & 1) << 2); }

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The barrier's phase completes when every thread's earlier copies landed.
__device__ inline void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Wait for the phase of parity `parity` to complete; trap (a launch error)
// rather than hang if it never does.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

// ---- tensor-core products ------------------------------------------------

// A fragment as big + small TF32 parts: big keeps the top 10 mantissa
// bits (a mask, exact), small = v - big (exact) and the tensor core reads
// its top bits.  |v - big - small_tf32| <= 2^-20 |v|.
template <int kN>
struct Split {
  uint32_t hi[kN], lo[kN];
  __device__ inline void set(const float (&v)[kN]) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      hi[e] = __float_as_uint(v[e]) & 0xffffe000u;
      lo[e] = __float_as_uint(v[e] - __uint_as_float(hi[e]));
    }
  }
};

__device__ inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- block state ---------------------------------------------------------

struct TextSmem {
  float* w;    // (T, Dp) the words
  float* c;    // (T, Dp) C, then dC
  float* p;    // (T, Rp) S, then A1
  float* q;    // (T, Rp) A2, then A2 * dA2, dA1, dS
  float* row;  // (kRowCount, kMaxT) per-word scalars
};

// The block's geometry and shared-memory carve.  Per-text state is reached
// through text(a) and len(a), never through an array indexed at run time,
// so that it stays in registers.
template <int kTexts>
struct Block {
  static constexpr int kChunk = chunk_of(kTexts);
  uint64_t* bar;   // (kStages,) full barriers of the X stages
  float* red;      // (kWarps, 32, 4) partial sums handed to a tile's first warp
  float* xs;       // (kStages, kChunk, Xp) X stages
  float* texts;    // kTexts x text_floats: w, c, p, q, row of each text
  int l0, l1;      // real words of texts 0 and 1 (0 past B)
  int t_len, r, d, d8, dp, rp, xp, nchunks, tf;
  uint32_t seq;    // chunks of X consumed so far (stage seq % 2)

  __device__ float* stage(uint32_t s) const { return xs + (s % kStages) * kChunk * xp; }
  __device__ int len(int a) const { return kTexts == 1 || a == 0 ? l0 : l1; }
  __device__ TextSmem text(int a) const {
    TextSmem ts;
    ts.w = texts + a * tf;
    ts.c = ts.w + t_len * dp;
    ts.p = ts.c + t_len * dp;
    ts.q = ts.p + t_len * rp;
    ts.row = ts.q + t_len * rp;
    return ts;
  }
};

// Chunk `ci` of image xg into the stage after the current one; rows past R
// are zero-filled.  Every thread arrives on the stage's barrier.
template <int kTexts>
__device__ __forceinline__ void issue_chunk(const Block<kTexts>& bk, const float* __restrict__ xg,
                                            int ci) {
  const uint32_t s = bk.seq + 1;
  float* dst = bk.stage(s);
  const int r0 = ci * Block<kTexts>::kChunk;
  const int nr = min(Block<kTexts>::kChunk, bk.r - r0);
  const int d4 = bk.d / 4;
  for (int i = threadIdx.x; i < Block<kTexts>::kChunk * d4; i += kThreads) {
    const int rr = i / d4, k = 4 * (i - rr * d4);
    const float* src = xg + static_cast<size_t>(r0 + min(rr, nr - 1)) * bk.d + k;
    cp_async16(dst + rr * bk.xp + xcol(rr, k), src, rr < nr ? 16 : 0);
  }
  cp_async_arrive(bk.bar + s % kStages);
}

// One pass over the chunks of image xg: body(stage, r0, nr) per chunk, with
// the next chunk (of this image, or chunk 0 of next_xg, or none) loading
// meanwhile.  Ends with a barrier, so the pass's results are visible.
template <int kTexts, class Body>
__device__ __forceinline__ void stream_pass(Block<kTexts>& bk, const float* xg,
                                            const float* next_xg, Body body) {
  constexpr int kChunk = Block<kTexts>::kChunk;
  for (int ci = 0; ci < bk.nchunks; ++ci) {
    mbar_wait(bk.bar + bk.seq % kStages, (bk.seq / kStages) & 1);
    __syncthreads();  // every warp is done with the other stage
    if (ci + 1 < bk.nchunks)
      issue_chunk(bk, xg, ci + 1);
    else if (next_xg != nullptr)
      issue_chunk(bk, next_xg, 0);
    body(bk.stage(bk.seq), ci * kChunk, min(kChunk, bk.r - ci * kChunk));
    ++bk.seq;
  }
  __syncthreads();
}

// kU k-steps of an S-type tile from column k (k-step stride 8): all loads
// first, then the MMAs term by term into two sets of three accumulators (one
// a term), so that no MMA waits on the one before it.
template <int kU>
__device__ __forceinline__ void scores_steps(float (&acc)[2][3][4], const float* a0,
                                             const float* a1, const float* xr, int k, int sw) {
  Split<4> af[kU];
  Split<2> bf[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int ku = k + 8 * u;
    const float av[4] = {a0[ku], a1[ku], a0[ku + 4], a1[ku + 4]};
    const float bv[2] = {xr[ku ^ sw], xr[(ku + 4) ^ sw]};
    af[u].set(av);
    bf[u].set(bv);
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) mma_tf32(acc[u & 1][0], af[u].lo, bf[u].hi);
#pragma unroll
  for (int u = 0; u < kU; ++u) mma_tf32(acc[u & 1][1], af[u].hi, bf[u].lo);
#pragma unroll
  for (int u = 0; u < kU; ++u) mma_tf32(acc[u & 1][2], af[u].hi, bf[u].hi);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// S-type product on one chunk: out[t][r0 + n] = sum_k a[t][k] X[n][k] for
// t < L, every region n of the chunk (kMul: out *= that sum).  The 2 kGroup
// warps of (text a, region tile nt) share its word tiles: kGroup warps a
// tile, each a slice of K; a text of at most 16 words has one word tile,
// and then all 2 kGroup warps slice its K.  The tile's first warp adds the
// others' sums in slice order (deterministic).  Rows past L read a row of
// the array (clamped to T - 1) and are dropped: an MMA's output rows are
// independent.
template <int kTexts, bool kMul>
__device__ __forceinline__ void scores_chunk(const Block<kTexts>& bk, const float* xst, int r0,
                                             int nr) {
  constexpr int kNT = Block<kTexts>::kChunk / 8;
  static_assert(kTexts * 2 * kNT * kGroup == kWarps, "every warp on one tile");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int group = warp / (2 * kGroup), member = warp % (2 * kGroup);
  const int a = group / kNT, nt = group % kNT;
  const int l = bk.len(a);
  if (l == 0 || nt * 8 >= nr) return;
  const bool one_tile = l <= 16;
  const int tile = one_tile ? 0 : member / kGroup;
  const int parts = one_tile ? 2 * kGroup : kGroup;
  const int part = one_tile ? member : member % kGroup;
  const int steps = bk.d8 / 8;
  const int k_begin = part * steps / parts, k_end = (part + 1) * steps / parts;
  const TextSmem ts = bk.text(a);
  const float* am = kMul ? ts.c : ts.w;
  const int t0 = tile * 16 + g, t1 = t0 + 8;
  const float* a0 = am + min(t0, bk.t_len - 1) * bk.dp;
  const float* a1 = am + min(t1, bk.t_len - 1) * bk.dp;
  const int n = nt * 8 + g;
  const float* xr = xst + n * bk.xp;
  const int sw = ((n >> 2) & 1) << 2;
  float acc[2][3][4] = {};
  int k = k_begin;
  for (; k + 4 <= k_end; k += 4) scores_steps<4>(acc, a0, a1, xr, 8 * k + tq, sw);
  for (; k < k_end; ++k) scores_steps<1>(acc, a0, a1, xr, 8 * k + tq, sw);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = ((acc[0][0][e] + acc[1][0][e]) + (acc[0][1][e] + acc[1][1][e])) +
           (acc[0][2][e] + acc[1][2][e]);
  if (parts > 1) {
    float4* slots = reinterpret_cast<float4*>(bk.red) + lane;
    if (part > 0) slots[warp * 32] = make_float4(v[0], v[1], v[2], v[3]);
    named_barrier(1 + group, 64 * kGroup);
    if (part > 0) return;
    for (int p = 1; p < parts; ++p) {
      const float4 o = slots[(warp + p) * 32];  // the tile's warps are consecutive
      v[0] += o.x;
      v[1] += o.y;
      v[2] += o.z;
      v[3] += o.w;
    }
  }
  float* out = kMul ? ts.q : ts.p;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = e < 2 ? t0 : t1;
    const int rr = r0 + nt * 8 + 2 * tq + (e & 1);
    if (t < l && rr < bk.r) {
      float* o = out + t * bk.rp + rr;
      *o = kMul ? *o * v[e] : v[e];
    }
  }
}

// Accumulators of a (words x channels) result in MMA fragments: text a,
// word tile h, channel tile warp + kWarps j.
constexpr int kJ = kMaxD / 8 / kWarps;
template <int kTexts>
using Frags = float[kTexts][2][kJ][4];

// C-type product on one chunk: acc[t][ch] += sum_r q[t][r0 + r] X[r][ch].
// q is zero in its padding columns and X in its zero-filled rows; rows of
// acc past L hold values of no word and are dropped by their readers.
template <int kTexts>
__device__ __forceinline__ void context_chunk(const Block<kTexts>& bk, Frags<kTexts>& acc,
                                              const float* xst, int r0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < Block<kTexts>::kChunk; kk += 8) {
    Split<2> bf[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int ch = (warp + kWarps * j) * 8 + g;
      float bv[2] = {0.f, 0.f};
      if (ch - g < bk.d8) {  // rows kk + tq keep their columns, kk + tq + 4 swap
        bv[0] = xst[(kk + tq) * bk.xp + ch];
        bv[1] = xst[(kk + tq + 4) * bk.xp + (ch ^ 4)];
      }
      bf[j].set(bv);
    }
#pragma unroll
    for (int a = 0; a < kTexts; ++a) {
      const int l = bk.len(a);
      const float* qm = bk.text(a).q + r0 + kk + tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h * 16 >= l) continue;
        // rows past L: a clamped row, dropped later (rows are independent)
        const float* q0 = qm + min(h * 16 + g, bk.t_len - 1) * bk.rp;
        const float* q1 = qm + min(h * 16 + g + 8, bk.t_len - 1) * bk.rp;
        const float av[4] = {q0[0], q1[0], q0[4], q1[4]};
        Split<4> af;
        af.set(av);
        // term by term over the channel tiles: an accumulator's MMAs are kJ apart
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          if ((warp + kWarps * j) * 8 < bk.d8) mma_tf32(acc[a][h][j], af.lo, bf[j].hi);
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          if ((warp + kWarps * j) * 8 < bk.d8) mma_tf32(acc[a][h][j], af.hi, bf[j].lo);
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          if ((warp + kWarps * j) * 8 < bk.d8) mma_tf32(acc[a][h][j], af.hi, bf[j].hi);
      }
    }
  }
}

// Visit every accumulator element of this thread: f(a, t, ch, value&).
template <int kTexts, class F>
__device__ inline void for_each_frag(Frags<kTexts>& acc, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int a = 0; a < kTexts; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(a, h * 16 + g + (e < 2 ? 0 : 8), (warp + kWarps * j) * 8 + 2 * tq + (e & 1),
            acc[a][h][j][e]);
}

template <int kTexts>
__device__ inline void zero_frags(Frags<kTexts>& acc) {
  for_each_frag<kTexts>(acc, [](int, int, int, float& v) { v = 0.f; });
}

// ---- the pair: forward, then the word side of the backward ---------------

template <int kTexts>
__device__ __forceinline__ void pair_dwords(Block<kTexts>& bk, Frags<kTexts>& dw,
                                            const float* __restrict__ xg, const float* next_xg,
                                            const float* gij, int bj, float g1, float g2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = bk.r, d = bk.d;

  // S = W X^T into p
  stream_pass(bk, xg, xg, [&](const float* xst, int r0, int nr) {
    scores_chunk<kTexts, false>(bk, xst, r0, nr);
  });

  // Eq. 8: softmax over the real words, one thread per (text, region)
  for (int i = threadIdx.x; i < kTexts * r; i += kThreads) {
    const int a = i / r, rr = i - a * r, l = bk.len(a);
    float* p = bk.text(a).p + rr;
    const int rp = bk.rp;
    float m = -FLT_MAX;
#pragma unroll 4
    for (int t = 0; t < l; ++t) m = fmaxf(m, p[t * rp]);
    float sum = 0.f;
#pragma unroll 4
    for (int t = 0; t < l; ++t) {
      const float e = expf(p[t * rp] - m);
      p[t * rp] = e;
      sum += e;
    }
#pragma unroll 4
    for (int t = 0; t < l; ++t) p[t * rp] = p[t * rp] / sum;
  }
  __syncthreads();

  // Eq. 9: softmax over regions of g1 A1 into q, one warp per (text, word)
  for (int i = warp; i < kTexts * kMaxT; i += kWarps) {
    const int a = i / kMaxT, t = i % kMaxT;
    if (t >= bk.len(a)) continue;
    const TextSmem ts = bk.text(a);
    const float* a1 = ts.p + t * bk.rp;
    float* a2 = ts.q + t * bk.rp;
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
      ts.row[kM2 * kMaxT + t] = m;
      ts.row[kS2 * kMaxT + t] = sum;
    }
  }
  // (the next pass starts with a barrier)

  // C = A2 X, into c
  {
    Frags<kTexts> cacc;
    zero_frags<kTexts>(cacc);
    stream_pass(bk, xg, xg, [&](const float* xst, int r0, int) {
      context_chunk<kTexts>(bk, cacc, xst, r0);
    });
    for_each_frag<kTexts>(cacc, [&](int a, int t, int ch, float& v) {
      if (t < bk.len(a) && ch < bk.d8) bk.text(a).c[t * bk.dp + ch] = v;
    });
  }
  __syncthreads();

  // cosine per (text, word), one warp each
  for (int i = warp; i < kTexts * kMaxT; i += kWarps) {
    const int a = i / kMaxT, t = i % kMaxT;
    if (t >= bk.len(a)) continue;
    const TextSmem ts = bk.text(a);
    float num = 0.f, ww = 0.f, cc = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float w = ts.w[t * bk.dp + k], c = ts.c[t * bk.dp + k];
      num = fmaf(w, c, num);
      ww = fmaf(w, w, ww);
      cc = fmaf(c, c, cc);
    }
    num = warp_sum(num);
    ww = warp_sum(ww);
    cc = warp_sum(cc);
    if (lane == 0) {
      const float wn = sqrtf(ww), cn = sqrtf(cc);
      ts.row[kNum * kMaxT + t] = num;
      ts.row[kWn * kMaxT + t] = wn;
      ts.row[kCn * kMaxT + t] = cn;
      ts.row[kRs * kMaxT + t] = g2 * num / fmaxf(wn * cn, kEps);
    }
  }
  __syncthreads();

  // Eq. 10 and its backward to the cosine: warp a takes text a
  if (warp < kTexts && bk.len(warp) > 0) {
    const int l = bk.len(warp);
    float* row = bk.text(warp).row;
    const float v = lane < l ? row[kRs * kMaxT + lane] : -FLT_MAX;
    const float m = warp_max(v);
    const float e = lane < l ? expf(v - m) : 0.f;
    const float sum = warp_sum(e);
    if (lane < l) {
      const float d_rs = gij[warp * bj] * (expf(v - m) / sum);
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
  }
  __syncthreads();

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

  // u = A2 * dA2 with dA2 = dC X^T, in q
  stream_pass(bk, xg, xg, [&](const float* xst, int r0, int nr) {
    scores_chunk<kTexts, true>(bk, xst, r0, nr);
  });

  // inner2 = sum over regions of u, one warp per (text, word)
  for (int i = warp; i < kTexts * kMaxT; i += kWarps) {
    const int a = i / kMaxT, t = i % kMaxT;
    if (t >= bk.len(a)) continue;
    const TextSmem ts = bk.text(a);
    float v = 0.f;
    for (int rr = lane; rr < r; rr += 32) v += ts.q[t * bk.rp + rr];
    v = warp_sum(v);
    if (lane == 0) ts.row[kInner2 * kMaxT + t] = v;
  }
  __syncthreads();

  // dA1 = g1 (u - A2 inner2), inner1 = sum_t dA1 A1, dS = A1 (dA1 - inner1),
  // one thread per (text, region)
  for (int i = threadIdx.x; i < kTexts * r; i += kThreads) {
    const int a = i / r, rr = i - a * r, l = bk.len(a);
    const TextSmem ts = bk.text(a);
    const float* p = ts.p + rr;
    float* q = ts.q + rr;
    const int rp = bk.rp;
    float inner1 = 0.f;
#pragma unroll 4
    for (int t = 0; t < l; ++t) {
      const float a1 = p[t * rp];
      const float a2 = expf(region_logit(g1, a1) - ts.row[kM2 * kMaxT + t]) /
                       ts.row[kS2 * kMaxT + t];
      const float da1 = g1 * (q[t * rp] - a2 * ts.row[kInner2 * kMaxT + t]);
      q[t * rp] = da1;
      inner1 = fmaf(da1, a1, inner1);
    }
#pragma unroll 4
    for (int t = 0; t < l; ++t) q[t * rp] = p[t * rp] * (q[t * rp] - inner1);
  }
  // (the next pass starts with a barrier)

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
  constexpr int kChunk = Block<kTexts>::kChunk;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  Block<kTexts> bk;
  bk.t_len = t_len;
  bk.r = r;
  bk.d = d;
  bk.d8 = (d + 7) & ~7;
  bk.dp = pad_d(d);
  bk.rp = pad_r(r, kChunk);
  bk.xp = pad_x(d);
  bk.nchunks = (r + kChunk - 1) / kChunk;
  bk.seq = 0;
  bk.bar = reinterpret_cast<uint64_t*>(base);
  bk.red = reinterpret_cast<float*>(base + kBarrierBytes);
  bk.xs = bk.red + kRedFloats;
  bk.texts = bk.xs + kStages * kChunk * bk.xp;
  bk.tf = text_floats(t_len, r, d, kChunk);
  const int i0 = blockIdx.x * kTexts;
  bk.l0 = lens[i0];
  bk.l1 = kTexts > 1 && i0 + 1 < b ? lens[i0 + 1] : 0;

  // everything zero: the padding rows and columns stay so
  {
    float* all = bk.xs;
    const int n = kStages * kChunk * bk.xp + kTexts * bk.tf;
    for (int i = threadIdx.x; i < n; i += kThreads) all[i] = 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bk.bar + s, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int d4 = d / 4;
#pragma unroll
  for (int a = 0; a < kTexts; ++a) {
    const float4* src = reinterpret_cast<const float4*>(
        words + static_cast<size_t>(i0 + a) * t_len * d);
    for (int i = threadIdx.x; i < bk.len(a) * d4; i += kThreads) {
      const int t = i / d4, k = i - t * d4;
      *reinterpret_cast<float4*>(bk.text(a).w + t * bk.dp + 4 * k) = src[i];
    }
  }

  Frags<kTexts> dw;
  zero_frags<kTexts>(dw);
  const int j0 = blockIdx.y * chunk, j1 = min(bj, j0 + chunk);
  const size_t img_floats = static_cast<size_t>(r) * d;
  bk.seq = static_cast<uint32_t>(-1);  // issue_chunk fills stage seq + 1
  issue_chunk(bk, img + j0 * img_floats, 0);
  bk.seq = 0;
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

bool shape_ok(int texts, int b, int bj, int t_len, int r, int d) {
  return texts >= 1 && texts <= kMaxTexts && b >= 1 && bj >= 1 && t_len >= 1 &&
         t_len <= kMaxT && r >= 1 && d >= 4 && d <= kMaxD && d % 4 == 0 &&
         smem_bytes(texts, t_len, r, d) <= kSmemLimit;
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
  for (int texts = kMaxTexts < b ? kMaxTexts : b; texts >= 1; --texts)
    if (shape_ok(texts, b, 1, t_len, r, d)) return texts;
  return 0;
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
