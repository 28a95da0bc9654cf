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
// uniform over all T words, as in the JAX package, and not NaN; the kernel
// builds it from the (B, T) padding mask itself.
//
// What bounds it on this card: bytes.  Per row it does 4*T*D flops against
// (2D + T)*4 bytes of traffic, about 15 flops a byte at D=32, T=25, far
// below what the card needs to be bound by arithmetic.  At the serving
// shape (B=1, QL=16384, D=32, T=25) it reads 2 MiB of Q and writes 2 MiB of
// ctx plus 1.6 MB of P: about 1.7 us at 3.35 TB/s.  Float32 on the CUDA
// cores: tensor cores buy nothing at 15 flops a byte.
//
// Design.  The first design (one thread per row, 128 rows a block) left
// 4 warps on an SM at B=1 and made every warp load and store stride across
// 32 rows.  This one:
//   * one block per (tile of kRows query rows, batch), kWarps warps, a
//     warp per two rows at a time (two independent shuffle chains): lane t
//     holds word t's score, so a row's max and sum are warp shuffles; for
//     the context, lane k holds channel k and reads the row's P from shared
//     memory as float4 broadcasts;
//   * the query tile comes in and the ctx tile goes out through shared
//     memory as float4 copies of one contiguous range (neighbouring threads
//     on neighbouring addresses); the P tile is one contiguous range too;
//   * the padding mask comes in as bytes and becomes the bias in shared
//     memory: no separate launch builds it;
//   * at D = 32 (the generator's width) D and the 32 word slots are
//     compile-time: each lane keeps word `lane`'s row and channel `lane`'s
//     column of the (T, D) table in registers, and every loop unrolls.
//     Any other D <= 256 takes the generic instance, which reads the table
//     from shared memory (rows padded to D + 1 against bank conflicts).
// Rows past QL are masked, so any QL works; slots t >= T take no part.
//
// Query and table come in float32 or bfloat16 (the generator's compute
// dtype, JAX.DTYPE), one instantiation each (TIn).  bfloat16 is the Pallas
// kernel on bfloat16 q and s: the values are widened to float32 as they are
// read (exact), the score FMAs run in float32 (a product of two bfloat16
// values is exact in float32), the softmax runs in float32, and each P is
// rounded to bfloat16 (round to nearest even) for the context product,
// which P.astype(s.dtype) does there.  ctx and the unrounded P are written
// as float32 in both.

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;  // query rows per block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxT = 32;   // word slots: one per lane
constexpr int kMaxD = 256;  // generic instance: up to 8 channels a lane
constexpr int kFastD = 32;  // the compile-time instance
constexpr int kStep = 2;    // rows a warp takes at a time
constexpr float kPadBias = -1e9f;
static_assert(kRows >= kWarps && kRows % 4 == 0, "tile");

// Shared memory, in floats: the word table (kMaxT, D + 1), zero in slots
// t >= T; the bias (kMaxT); kStep rows of P per warp (kWarps, kStep, kMaxT);
// the tile (kRows, D), query rows and then ctx rows; the P tile (kRows, T).
// Every part starts on a 16-byte boundary.
size_t smem_bytes(int t_len, int d) {
  return static_cast<size_t>(kMaxT * (d + 1) + kMaxT + kWarps * kStep * kMaxT +
                             kRows * d + kRows * t_len) * sizeof(float);
}

__device__ inline float widen(float v) { return v; }
__device__ inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four consecutive values from 16-byte (float) or 8-byte (bfloat16)
// aligned memory; a bfloat16 is the top half of its float32.
__device__ inline float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ inline float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// P as the context product's operand: itself, or rounded to bfloat16.
template <typename TIn>
__device__ inline float p_operand(float p) {
  if constexpr (sizeof(TIn) == 2) return __bfloat162float(__float2bfloat16_rn(p));
  return p;
}

// The softmax over the words of kStep rows for lane `lane` (its scores s),
// as the first design computed it: padding slots are -FLT_MAX and weigh 0.
// The rows' shuffle chains interleave.
__device__ inline void rows_softmax(float (&s)[kStep], bool word, float bias) {
  float m[kStep], e[kStep], sum[kStep];
#pragma unroll
  for (int i = 0; i < kStep; ++i) m[i] = s[i] = word ? s[i] + bias : -FLT_MAX;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kStep; ++i) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
#pragma unroll
  for (int i = 0; i < kStep; ++i) sum[i] = e[i] = word ? expf(s[i] - m[i]) : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kStep; ++i) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
#pragma unroll
  for (int i = 0; i < kStep; ++i) s[i] = e[i] / sum[i];
}

// kD: kFastD, or 0 for any d <= kMaxD given at run time; TIn: float or
// __nv_bfloat16, the type of query and source.
template <int kD, typename TIn>
__global__ void __launch_bounds__(kThreads) word_attention_fwd_kernel(
    const TIn* __restrict__ query, const TIn* __restrict__ source,
    const unsigned char* __restrict__ pad, float* __restrict__ ctx,
    float* __restrict__ probs, int ql, int t_len, int d_arg) {
  const int d = kD > 0 ? kD : d_arg;
  const int ld = d + 1;
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  float* s_bias = tab + kMaxT * ld;
  float* s_p = s_bias + kMaxT;
  float* tile = s_p + kWarps * kStep * kMaxT;
  float* ptile = tile + kRows * d;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int n = min(kRows, ql - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row0 = static_cast<size_t>(b) * ql + r0;

  const TIn* src = source + static_cast<size_t>(b) * t_len * d;
  for (int i = threadIdx.x; i < kMaxT * d; i += kThreads) {
    const int t = i / d;
    tab[i + t] = t < t_len ? widen(src[i]) : 0.f;  // (t, k) at t * (d + 1) + k
  }
  if (threadIdx.x < kMaxT)
    s_bias[threadIdx.x] = pad != nullptr && threadIdx.x < t_len &&
                                  pad[static_cast<size_t>(b) * t_len + threadIdx.x]
                              ? kPadBias
                              : 0.f;
  if (kD > 0) {
    const TIn* qg = query + row0 * d;
    float4* t4 = reinterpret_cast<float4*>(tile);
    for (int i = threadIdx.x; i < n * d / 4; i += kThreads) t4[i] = load4(qg + 4 * i);
  } else {
    const TIn* qg = query + row0 * d;
    for (int i = threadIdx.x; i < n * d; i += kThreads) tile[i] = widen(qg[i]);
  }
  __syncthreads();

  const bool word = lane < t_len;
  const float my_bias = s_bias[lane];
  float* p_rows = s_p + warp * kStep * kMaxT;
  if constexpr (kD > 0) {
    static_assert(kD == kMaxT, "the fast instance keeps one word and one channel a lane");
    float s_row[kD], s_col[kMaxT];  // S[lane, :] and S[:, lane]
#pragma unroll
    for (int k = 0; k < kD; ++k) s_row[k] = tab[lane * ld + k];
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) s_col[t] = tab[t * ld + lane];
    for (int first = warp * kStep; first < n; first += kWarps * kStep) {
      int rows[kStep];
      float s[kStep];
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        rows[i] = min(first + i, n - 1);  // a row past the tile repeats the last
        s[i] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kD / 4; ++k) {
#pragma unroll
        for (int i = 0; i < kStep; ++i) {
          const float4 v = reinterpret_cast<const float4*>(tile + rows[i] * kD)[k];
          s[i] = fmaf(v.x, s_row[4 * k], s[i]);
          s[i] = fmaf(v.y, s_row[4 * k + 1], s[i]);
          s[i] = fmaf(v.z, s_row[4 * k + 2], s[i]);
          s[i] = fmaf(v.w, s_row[4 * k + 3], s[i]);
        }
      }
      rows_softmax(s, word, my_bias);
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        if (word) ptile[rows[i] * t_len + lane] = s[i];
        p_rows[i * kMaxT + lane] = p_operand<TIn>(s[i]);
      }
      __syncwarp();
      float c[kStep];
#pragma unroll
      for (int i = 0; i < kStep; ++i) c[i] = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxT / 4; ++t) {
#pragma unroll
        for (int i = 0; i < kStep; ++i) {
          const float4 v = reinterpret_cast<const float4*>(p_rows + i * kMaxT)[t];
          c[i] = fmaf(v.x, s_col[4 * t], c[i]);
          c[i] = fmaf(v.y, s_col[4 * t + 1], c[i]);
          c[i] = fmaf(v.z, s_col[4 * t + 2], c[i]);
          c[i] = fmaf(v.w, s_col[4 * t + 3], c[i]);
        }
      }
      // the rows' queries were read before the shuffles
#pragma unroll
      for (int i = 0; i < kStep; ++i) tile[rows[i] * kD + lane] = c[i];
      __syncwarp();
    }
  } else {
    constexpr int kPer = kMaxD / 32;
    for (int row = warp; row < n; row += kWarps) {
      const float* q = tile + row * d;
      float s[kStep] = {};  // one row at a time here
      if (word) {
        const float* w = tab + lane * ld;
        for (int k = 0; k < d; ++k) s[0] = fmaf(q[k], w[k], s[0]);
      }
      rows_softmax(s, word, my_bias);
      if (word) ptile[row * t_len + lane] = s[0];
      p_rows[lane] = p_operand<TIn>(s[0]);
      __syncwarp();
      float acc[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
      for (int t = 0; t < t_len; ++t) {
        const float pt = p_rows[t];
        const float* w = tab + t * ld;
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (lane + 32 * j < d) acc[j] = fmaf(pt, w[lane + 32 * j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (lane + 32 * j < d) tile[row * d + lane + 32 * j] = acc[j];
      __syncwarp();
    }
  }
  __syncthreads();

  if (kD > 0) {
    const float4* t4 = reinterpret_cast<const float4*>(tile);
    float4* c4 = reinterpret_cast<float4*>(ctx + row0 * d);
    for (int i = threadIdx.x; i < n * d / 4; i += kThreads) c4[i] = t4[i];
  } else {
    float* cg = ctx + row0 * d;
    for (int i = threadIdx.x; i < n * d; i += kThreads) cg[i] = tile[i];
  }
  float* pg = probs + row0 * t_len;
  for (int i = threadIdx.x; i < n * t_len; i += kThreads) pg[i] = ptile[i];
}

// Raise the generic instance's dynamic shared-memory cap once per device
// and size, so a launch inside CUDA-graph capture makes no attribute call
// after warm-up.
constexpr int kMaxDevices = 64;
size_t generic_granted[2][kMaxDevices];  // [TIn is bfloat16]

template <typename TIn>
cudaError_t allow_generic_smem(size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= kMaxDevices) return err;
  size_t& granted = generic_granted[sizeof(TIn) == 2][dev];
  if (granted >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(word_attention_fwd_kernel<0, TIn>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) granted = bytes;
  return err;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename TIn>
cudaError_t launch(const TIn* query, const TIn* source, const unsigned char* pad, float* ctx,
                   float* probs, int batch, int ql, int t_len, int d, cudaStream_t stream) {
  const dim3 grid((ql + kRows - 1) / kRows, batch);
  const size_t smem = smem_bytes(t_len, d);
  if (d == kFastD && aligned16(query) && aligned16(ctx)) {
    word_attention_fwd_kernel<kFastD, TIn><<<grid, kThreads, smem, stream>>>(
        query, source, pad, ctx, probs, ql, t_len, d);
  } else {
    const cudaError_t err = allow_generic_smem<TIn>(smem);
    if (err != cudaSuccess) return err;
    word_attention_fwd_kernel<0, TIn><<<grid, kThreads, smem, stream>>>(
        query, source, pad, ctx, probs, ql, t_len, d);
  }
  return cudaGetLastError();
}

}  // namespace

// Query rows per block, for tests that cut QL at the tile's edge.
extern "C" int word_attention_tile_rows() { return kRows; }

// Plain C entry point, loaded with ctypes.  All pointers are device pointers
// to contiguous arrays: query (B, QL, D) and source (B, T, D), float32, or
// bfloat16 when `bf16` is nonzero; ctx (B, QL, D) and probs (B, QL, T)
// float32; pad (B, T) bytes, nonzero at padding, or null for none.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int word_attention_fwd(const void* query, const void* source,
                                  const unsigned char* pad, float* ctx, float* probs,
                                  int batch, int ql, int t_len, int d, int bf16,
                                  cudaStream_t stream) {
  if (batch < 1 || batch > 65535 || ql < 1 || t_len < 1 || t_len > kMaxT ||
      d < 1 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      bf16 ? launch(static_cast<const __nv_bfloat16*>(query),
                    static_cast<const __nv_bfloat16*>(source), pad, ctx, probs, batch, ql,
                    t_len, d, stream)
           : launch(static_cast<const float*>(query), static_cast<const float*>(source), pad,
                    ctx, probs, batch, ql, t_len, d, stream));
}
