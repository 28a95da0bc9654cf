// What the DAMSM similarity kernels share: damsm_sim.cu (K1, K2) and
// damsm_dwords.cu (K3) each include it, so each library has its own copy.
//
// For text i (words W, T x D, of which the first L are real) and image j
// (regions X, R x D), with gamma1 g1 and gamma2 g2:
//
//     S  = W X^T                          (L x R) word/region scores
//     A1 = softmax over words of S        (Eq. 8)
//     A2 = softmax over regions of g1 A1  (Eq. 9)
//     C  = A2 X                           (L x D) region context per word
//     rs = g2 cos(W[t], C[t])             per word
//     sim[i, j] = logsumexp_t rs          (Eq. 10)
//
// and the backward of _pair_backward (sba_gan_tpu/ops/damsm_sim.py:90-151)
// down to dS = d sim / d S.  Words t >= L take no part: the JAX package
// masks them with -1e9 before both softmaxes, which gives them exactly zero
// weight and zero gradient.
//
// The product core: a block takes one or two texts (Block) against a
// stream of images, or one image against a stream of texts.  X streams
// through a ring of two shared-memory stages filled by cp.async, each
// tracked by an mbarrier that the copies arrive on (stream_pass), so the
// next chunk of regions loads while the current one is multiplied; the
// stream runs on from one pass into the next.  The stage is XOR-swizzled
// so that both fragment shapes read it without bank conflicts.  The (words
// x regions) products (scores_chunk) and the (words x channels) products
// (context_chunk) run on the tensor cores, mma.sync m16n8k8 TF32, with
// float32 accuracy kept by the 3xTF32 split (a = big + small, big the top
// 10 mantissa bits by a mask; small_big + big_small + big_big, float32
// accumulation).  The elementwise steps (the softmaxes, the cosine, the
// log-sum-exp and their backward) run in float32 on the CUDA cores.
//
// Every product takes a compile-time precision, kBf16 (mm_dtype of the JAX
// package's _pair_forward and _pair_backward).  false: float32 products,
// 3xTF32 as above.  true: bfloat16 products.  Each operand is rounded to
// bfloat16 as it is read into its fragment (__float2bfloat16_rn, round to
// nearest even, as XLA's convert): W, X, A2, dC and dS alike, so the
// intermediates A2, dC and dS are rounded only as operands and stay float32
// in shared memory for the elementwise steps.  A bfloat16 value is exact in
// TF32 and the product of two is exact in float32, so one mma.sync m16n8k8
// TF32 per product computes what the three of 3xTF32 compute in float32,
// with the same fragment layouts.  X still streams as float32: the inputs
// are float32 in memory, as in the JAX package.

#pragma once

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxT = 32;   // words held per text
constexpr int kMaxD = 256;  // embedding width
constexpr float kEps = 1e-8f;
constexpr size_t kSmemLimit = 232448;  // a block's dynamic shared memory on sm_90
constexpr int kSumThreads = 256;       // threads a block of sum_splits_kernel

// per-word scalars, each an array of kMaxT floats
enum Row { kM2 = 0, kS2, kNum, kWn, kCn, kRs, kDNum, kFc, kFw, kInner2, kRowCount };

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The Eq. 9 logit.  __fmul_rn keeps the compiler from fusing it into an FMA,
// so the backward's recomputation of A2 rounds exactly as the forward did.
__device__ inline float region_logit(float g1, float a1) { return __fmul_rn(g1, a1); }

// out[n] = sum over splits of part[split][n], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int splits, size_t n) {
  for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; k < n;
       k += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += part[sp * n + k];
    out[k] = v;
  }
}

cudaError_t sum_splits(const float* part, float* out, int splits, size_t n,
                       cudaStream_t stream) {
  const int blocks = static_cast<int>((n + kSumThreads - 1) / kSumThreads);
  sum_splits_kernel<<<blocks < 4096 ? blocks : 4096, kSumThreads, 0, stream>>>(
      part, out, splits, n);
  return cudaGetLastError();
}

// Raise a kernel's dynamic shared-memory cap once per device and size, so a
// launch inside CUDA-graph capture makes no attribute call after warm-up.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t (&granted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= kMaxDevices) return err;
  if (granted[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}

// ---- block geometry ------------------------------------------------------

constexpr int kMaxTexts = 2;  // texts a block may hold at once
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

bool shape_ok(int texts, int b, int bj, int t_len, int r, int d) {
  return texts >= 1 && texts <= kMaxTexts && b >= 1 && bj >= 1 && t_len >= 1 &&
         t_len <= kMaxT && r >= 1 && d >= 4 && d <= kMaxD && d % 4 == 0 &&
         smem_bytes(texts, t_len, r, d) <= kSmemLimit;
}

// Texts a block holds at this shape: the most (up to kMaxTexts, and no more
// than B) whose block fits in shared memory; 0 if none does.
int block_texts(int b, int t_len, int r, int d) {
  for (int texts = kMaxTexts < b ? kMaxTexts : b; texts >= 1; --texts)
    if (shape_ok(texts, b, 1, t_len, r, d)) return texts;
  return 0;
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

// A fragment's operands.  Float32 products: big + small TF32 parts, big
// the top 10 mantissa bits (a mask, exact), small = v - big (exact), of
// which the tensor core reads the top bits; |v - big - small_tf32| <=
// 2^-20 |v|.  Bfloat16 products (kBf16): big is v rounded to bfloat16,
// exact in TF32, and small is not used.
template <int kN, bool kBf16>
struct Split {
  uint32_t hi[kN], lo[kN];
  __device__ inline void set(const float (&v)[kN]) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      if constexpr (kBf16) {
        hi[e] = __float_as_uint(__bfloat162float(__float2bfloat16_rn(v[e])));
      } else {
        hi[e] = __float_as_uint(v[e]) & 0xffffe000u;
        lo[e] = __float_as_uint(v[e] - __uint_as_float(hi[e]));
      }
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
  float* p;    // (T, Rp) S, then A1 (then A2 again, pair_ds<true>)
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

// Carve the dynamic shared memory, zero it (the padding rows and columns
// stay so) and initialise the stage barriers.  Ends with a barrier.
template <int kTexts>
__device__ __forceinline__ Block<kTexts> setup_block(char* base, int t_len, int r, int d) {
  constexpr int kChunk = Block<kTexts>::kChunk;
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
  return bk;
}

// Texts i0 and i0 + 1 (lengths l0, l1; 0 past B): their real words into w.
// Rows past L keep what they held; every reader stops at L or drops them.
template <int kTexts>
__device__ __forceinline__ void load_words(Block<kTexts>& bk, const float* __restrict__ words,
                                           const int* __restrict__ lens, int i0, int b) {
  bk.l0 = lens[i0];
  bk.l1 = kTexts > 1 && i0 + 1 < b ? lens[i0 + 1] : 0;
  const int d4 = bk.d / 4;
#pragma unroll
  for (int a = 0; a < kTexts; ++a) {
    const float4* src = reinterpret_cast<const float4*>(
        words + static_cast<size_t>(i0 + a) * bk.t_len * bk.d);
    for (int i = threadIdx.x; i < bk.len(a) * d4; i += kThreads) {
      const int t = i / d4, k = i - t * d4;
      *reinterpret_cast<float4*>(bk.text(a).w + t * bk.dp + 4 * k) = src[i];
    }
  }
}

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

// Start the stream: chunk 0 of xg into stage 0.
template <int kTexts>
__device__ __forceinline__ void start_stream(Block<kTexts>& bk, const float* __restrict__ xg) {
  bk.seq = static_cast<uint32_t>(-1);  // issue_chunk fills stage seq + 1
  issue_chunk(bk, xg, 0);
  bk.seq = 0;
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
template <int kU, bool kBf16>
__device__ __forceinline__ void scores_steps(float (&acc)[2][3][4], const float* a0,
                                             const float* a1, const float* xr, int k, int sw) {
  Split<4, kBf16> af[kU];
  Split<2, kBf16> bf[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int ku = k + 8 * u;
    const float av[4] = {a0[ku], a1[ku], a0[ku + 4], a1[ku + 4]};
    const float bv[2] = {xr[ku ^ sw], xr[(ku + 4) ^ sw]};
    af[u].set(av);
    bf[u].set(bv);
  }
  if constexpr (!kBf16) {
#pragma unroll
    for (int u = 0; u < kU; ++u) mma_tf32(acc[u & 1][0], af[u].lo, bf[u].hi);
#pragma unroll
    for (int u = 0; u < kU; ++u) mma_tf32(acc[u & 1][1], af[u].hi, bf[u].lo);
  }
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
template <int kTexts, bool kMul, bool kBf16>
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
  for (; k + 4 <= k_end; k += 4) scores_steps<4, kBf16>(acc, a0, a1, xr, 8 * k + tq, sw);
  for (; k < k_end; ++k) scores_steps<1, kBf16>(acc, a0, a1, xr, 8 * k + tq, sw);
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
template <int kTexts, bool kBf16>
__device__ __forceinline__ void context_chunk(const Block<kTexts>& bk, Frags<kTexts>& acc,
                                              const float* xst, int r0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < Block<kTexts>::kChunk; kk += 8) {
    Split<2, kBf16> bf[kJ];
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
        Split<4, kBf16> af;
        af.set(av);
        // term by term over the channel tiles: an accumulator's MMAs are kJ apart
        if constexpr (!kBf16) {
#pragma unroll
          for (int j = 0; j < kJ; ++j)
            if ((warp + kWarps * j) * 8 < bk.d8) mma_tf32(acc[a][h][j], af.lo, bf[j].hi);
#pragma unroll
          for (int j = 0; j < kJ; ++j)
            if ((warp + kWarps * j) * 8 < bk.d8) mma_tf32(acc[a][h][j], af.hi, bf[j].lo);
        }
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

// ---- the pair --------------------------------------------------------------

// The pair forward of the block's texts against image xg, up to the cosine:
// A1 in p, A2 in q, C in c, and per word M2/S2 (Eq. 9's row max and sum)
// and Num/Wn/Cn/Rs.  The C pass hands the stream on to c_next (the next
// pass's image, or none).  Ends with a barrier.
template <int kTexts, bool kBf16>
__device__ __forceinline__ void pair_forward(Block<kTexts>& bk, const float* __restrict__ xg,
                                             const float* c_next, float g1, float g2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = bk.r, d = bk.d;

  // S = W X^T into p
  stream_pass(bk, xg, xg, [&](const float* xst, int r0, int nr) {
    scores_chunk<kTexts, false, kBf16>(bk, xst, r0, nr);
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
    stream_pass(bk, xg, c_next, [&](const float* xst, int r0, int) {
      context_chunk<kTexts, kBf16>(bk, cacc, xst, r0);
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
}

// Eq. 10 and its backward to the cosine for the cotangents gij[a * bj] of
// the block's texts: DNum, Fc, Fw per word.  Warp a takes text a.  Ends
// with a barrier.
template <int kTexts>
__device__ __forceinline__ void lse_backward(const Block<kTexts>& bk, const float* gij, int bj,
                                             float g2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
}

// From dC (in c) to dS (in q): u = A2 * dA2 with dA2 = dC X^T (a pass over
// image xg that hands the stream on to u_next), inner2, dA1 = g1 (u - A2
// inner2), inner1 = sum_t dA1 A1, dS = A1 (dA1 - inner1).  kA2: p takes
// A2 back from A1 (recomputed as Eq. 9 computed it).  The caller's next
// step must start with a barrier.
template <int kTexts, bool kA2, bool kBf16>
__device__ __forceinline__ void pair_ds(Block<kTexts>& bk, const float* __restrict__ xg,
                                        const float* u_next, float g1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = bk.r;

  // u = A2 * dA2 with dA2 = dC X^T, in q
  stream_pass(bk, xg, u_next, [&](const float* xst, int r0, int nr) {
    scores_chunk<kTexts, true, kBf16>(bk, xst, r0, nr);
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

  // dA1, inner1 and dS, one thread per (text, region)
  for (int i = threadIdx.x; i < kTexts * r; i += kThreads) {
    const int a = i / r, rr = i - a * r, l = bk.len(a);
    const TextSmem ts = bk.text(a);
    float* p = ts.p + rr;
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
    for (int t = 0; t < l; ++t) {
      const float a1 = p[t * rp];
      q[t * rp] = a1 * (q[t * rp] - inner1);
      if (kA2)
        p[t * rp] = expf(region_logit(g1, a1) - ts.row[kM2 * kMaxT + t]) /
                    ts.row[kS2 * kMaxT + t];
    }
  }
}

}  // namespace
