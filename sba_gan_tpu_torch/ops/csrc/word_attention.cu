// Fused word attention, forward, for Hopper (sm_90a).
//
// Replaces sba_gan_tpu/ops/word_attention.py:_attn_kernel, the Pallas TPU
// kernel that the generator's two refinement stages call once each.  For
// every query row q (D floats) of batch b:
//
//     s_t = q . S[b, t] + bias[b, t]                  for t < T
//     P_t = exp(s_t - max_u s_u) / sum_u exp(s_u - max_u s_u)
//     ctx = sum_t P_t S[b, t]
//
// and it writes ctx (B, QL, D) and P (B, QL, T), both float32.  The pad bias
// is additive (0 or -1e9, never -inf), so an all-padding row comes out
// uniform over all T words, as in the JAX package, and not NaN.
//
// What bounds it: memory.  Per row it does 4*T*D flops against (2D + T)*4
// bytes of traffic, about 15 flops a byte at D=32, T=25, far below what
// the card needs to be bound by arithmetic.  At serving shapes (B=1,
// QL=16384, D=32, T=25) it reads 2 MiB of Q and writes 2 MiB of ctx plus
// 1.6 MB of P: about 1.7 us at 3.35 TB/s, so launch overhead dominates.
//
// Design (simple and right first): one block per (tile of 128 query rows,
// batch), one thread per row.  The (T, D) word table and the (T,) bias are
// staged in shared memory, where every thread of a warp reads the same word
// at once (a broadcast, no bank conflict).  Each thread keeps its T scores in
// registers (T <= 32, loops fully unrolled), takes a max-subtracted softmax,
// writes P, then ctx = P.S.  Rows past QL are masked, so any QL works.
// Making it fast is later work: many rows per warp with coalesced 16-byte
// loads and stores, and fusing the word projection into the kernel.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // query rows per block, one per thread
constexpr int kMaxT = 32;   // words held in registers
constexpr int kMaxD = 256;  // shared table: kMaxT * kMaxD floats = 32 KiB

__global__ void __launch_bounds__(kRows) word_attention_fwd_kernel(
    const float* __restrict__ query, const float* __restrict__ source,
    const float* __restrict__ bias, float* __restrict__ ctx,
    float* __restrict__ probs, int ql, int t_len, int d) {
  extern __shared__ float smem[];
  float* s_tab = smem;               // (T, D) word table of this batch row
  float* s_bias = smem + t_len * d;  // (T,) additive pad bias

  const int b = blockIdx.y;
  const float* src = source + static_cast<size_t>(b) * t_len * d;
  for (int i = threadIdx.x; i < t_len * d; i += blockDim.x) s_tab[i] = src[i];
  for (int i = threadIdx.x; i < t_len; i += blockDim.x)
    s_bias[i] = bias[static_cast<size_t>(b) * t_len + i];
  __syncthreads();

  const int row = blockIdx.x * kRows + threadIdx.x;
  if (row >= ql) return;
  const size_t r = static_cast<size_t>(b) * ql + row;
  const float* q = query + r * d;

  float score[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) score[t] = 0.f;
  for (int k = 0; k < d; ++k) {
    const float qk = q[k];
#pragma unroll
    for (int t = 0; t < kMaxT; ++t)
      if (t < t_len) score[t] = fmaf(qk, s_tab[t * d + k], score[t]);
  }

  float m = -FLT_MAX;
#pragma unroll
  for (int t = 0; t < kMaxT; ++t)
    if (t < t_len) {
      score[t] += s_bias[t];
      m = fmaxf(m, score[t]);
    }
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxT; ++t)
    if (t < t_len) {
      score[t] = expf(score[t] - m);
      sum += score[t];
    }
  float* p = probs + r * t_len;
#pragma unroll
  for (int t = 0; t < kMaxT; ++t)
    if (t < t_len) {
      score[t] = score[t] / sum;
      p[t] = score[t];
    }

  float* c = ctx + r * d;
  for (int k = 0; k < d; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t)
      if (t < t_len) acc = fmaf(score[t], s_tab[t * d + k], acc);
    c[k] = acc;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  All pointers are device pointers
// to contiguous float32 arrays: query (B, QL, D), source (B, T, D),
// bias (B, T), ctx (B, QL, D), probs (B, QL, T).  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int word_attention_fwd(const float* query, const float* source,
                                  const float* bias, float* ctx, float* probs,
                                  int batch, int ql, int t_len, int d,
                                  cudaStream_t stream) {
  if (batch < 1 || batch > 65535 || ql < 1 || t_len < 1 || t_len > kMaxT ||
      d < 1 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((ql + kRows - 1) / kRows, batch);
  const size_t smem = static_cast<size_t>(t_len * d + t_len) * sizeof(float);
  word_attention_fwd_kernel<<<grid, kRows, smem, stream>>>(
      query, source, bias, ctx, probs, ql, t_len, d);
  return static_cast<int>(cudaGetLastError());
}
