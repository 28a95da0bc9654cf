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
//   * at D = 48 (COCO's width, GF_DIM 48) the wide instance, below.
//     Any other D <= 256 takes the generic instance, which reads the table
//     from shared memory (rows padded to D + 1 against bank conflicts).
// Rows past QL are masked, so any QL works; slots t >= T take no part.
//
// The wide instance (kD a multiple of 16; built for D = 48).  Bytes bound
// it as they bound D = 32: 4*T*D flops against (2D + T)*4 bytes a row,
// about 5 flops a byte at T = 12.  What held back the generic instance at
// D = 48 was instructions and latency, not bytes: one row at a time, a
// serial chain of D FMAs a lane with both operands from shared memory, and
// for the context 8 guarded channel slots a lane of which 2 were live (and
// only for half the lanes), with scalar tile copies.  Here:
//   * a warp takes kPass = 8 rows at a time.  For the scores, lane (g, w)
//     holds word w's row of the table in registers (kD floats) and runs
//     one FMA chain for each of its rows, independent of each other; the
//     query values come as float4 broadcasts from the tile.  With T <= 16
//     a row needs 16 lanes, so the warp scores two rows side by side
//     (kG = 16 word slots, softmax shuffles within each half): 4 rows a
//     lane; with T <= 32, 32 slots and 8 rows a lane;
//   * for the context, lane (h, m) sums rows h, h + 2, h + 4, h + 6 of the
//     pass over channels m, m + 16, m + 32: every lane has whole work
//     (8 rows x 48 channels = 12 outputs a lane), the loop over words runs
//     to T only (in steps of 4: P of 4 words is one float4), and each
//     table value read from shared memory serves 4 rows.  A half-warp reads
//     16 consecutive channels of one word: no bank conflict.  The table's
//     rows are padded to kD + 4 floats, so the score rows come in as
//     conflict-free float4 reads too;
//   * the query tile comes in and the ctx tile goes out as 16-byte copies
//     of one contiguous range (a bfloat16 row is 96 bytes, a float32 row
//     192: both 16-byte multiples, so any tile starts aligned);
//   * what remains in the way is latency: a block loads its tile, then
//     computes, then stores.  Taller tiles keep more bytes in flight and
//     spread the table's set-up over more rows, so a grid of at least
//     three 128-row tiles for each SM takes 128 rows a block (else 32, so
//     that one generation, B 1, still fills the card), and the registers
//     are capped for 4 blocks an SM (128 a thread; 96, for 5, spills).
//     On the H100 that halves the time of 32-row tiles at B 128 and
//     leaves it 1.8-2.8x the bytes bound (PERF.md).
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
constexpr int kWideD = 48;  // the wide instance's D
constexpr int kPass = 8;    // wide instance: rows a warp takes at a time
constexpr int kWideBlocks = 4;  // wide instance: blocks an SM must fit
constexpr int kTallTile = 128;  // wide instance: query rows per block on a tall grid,
// one of at least three such tiles for each of the H100's 132 SMs (B x QL
// rows), else kRows, so that a small grid still fills the card
constexpr long kTallRows = 3L * 132 * kTallTile;
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

// Four bfloat16 values packed in 8 bytes, as float32: a bfloat16 is the
// top half of its float32.
__device__ inline float4 widen4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
// Four consecutive values from 16-byte (float) or 8-byte (bfloat16)
// aligned memory.
__device__ inline float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ inline float4 load4(const __nv_bfloat16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}

// `count` values (a multiple of 8) from 16-byte aligned global memory into
// the float tile, as 16-byte loads: 4 floats or 8 bfloat16 values each.
__device__ inline void tile_in(const float* g, float* tile, int count) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* t4 = reinterpret_cast<float4*>(tile);
  for (int i = threadIdx.x; i < count / 4; i += kThreads) t4[i] = g4[i];
}
__device__ inline void tile_in(const __nv_bfloat16* g, float* tile, int count) {
  const uint4* g8 = reinterpret_cast<const uint4*>(g);
  float4* t4 = reinterpret_cast<float4*>(tile);
  for (int i = threadIdx.x; i < count / 8; i += kThreads) {
    const uint4 u = g8[i];
    t4[2 * i] = widen4(make_uint2(u.x, u.y));
    t4[2 * i + 1] = widen4(make_uint2(u.z, u.w));
  }
}

// P as the context product's operand: itself, or rounded to bfloat16.
template <typename TIn>
__device__ inline float p_operand(float p) {
  if constexpr (sizeof(TIn) == 2) return __bfloat162float(__float2bfloat16_rn(p));
  return p;
}

// The softmax over the words of kN rows for this lane (its scores s), each
// row over kWidth lanes (a warp, or each half of it), as the first design
// computed it: padding slots are -FLT_MAX and weigh 0.  The rows' shuffle
// chains interleave.
template <int kN, int kWidth = 32>
__device__ inline void rows_softmax(float (&s)[kN], bool word, float bias) {
  float m[kN], e[kN], sum[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) m[i] = s[i] = word ? s[i] + bias : -FLT_MAX;
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kN; ++i) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
#pragma unroll
  for (int i = 0; i < kN; ++i) sum[i] = e[i] = word ? expf(s[i] - m[i]) : 0.f;
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kN; ++i) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
#pragma unroll
  for (int i = 0; i < kN; ++i) s[i] = e[i] / sum[i];
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

// Raise a kernel's dynamic shared-memory cap (48 KB unless raised) once
// per device and size, so a launch inside CUDA-graph capture makes no
// attribute call after warm-up; `granted`: the kernel's sizes so far.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t (&granted)[kMaxDevices], size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= kMaxDevices) return err;
  if (granted[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}

// The wide instance's shared memory, in floats: the word table (kG,
// kD + 4), zero in slots t >= T; kPass rows of P per warp (kWarps, kPass,
// kG); the tile (kTile, kD), query rows and then ctx rows; the P tile
// (kTile, T).  Every part starts on a 16-byte boundary.
size_t wide_smem_bytes(int t_len, int d, int g, int tile) {
  return static_cast<size_t>(g * (d + 4) + kWarps * kPass * g + tile * d + tile * t_len) *
         sizeof(float);
}

// kD: a multiple of 16; kG: word slots a row (16 for T <= 16, else 32);
// kTile: query rows per block (a multiple of 8: 16-byte tile offsets in
// bfloat16 at kD 48); TIn: float or __nv_bfloat16, the type of query and
// source.
template <int kD, int kG, int kTile, typename TIn>
__global__ void __launch_bounds__(kThreads, kWideBlocks) word_attention_fwd_wide_kernel(
    const TIn* __restrict__ query, const TIn* __restrict__ source,
    const unsigned char* __restrict__ pad, float* __restrict__ ctx,
    float* __restrict__ probs, int ql, int t_len) {
  static_assert(kD % 16 == 0 && (kG == 16 || kG == 32), "wide instance");
  static_assert(kTile % kPass == 0, "a pass's rows lie inside the tile");
  constexpr int kLd = kD + 4;            // table row stride
  constexpr int kGroups = 32 / kG;       // rows a warp scores side by side
  constexpr int kLaneRows = kPass / kGroups;  // rows a lane scores
  constexpr int kHalfRows = kPass / 2;   // rows a lane sums in the context
  constexpr int kChan = kD / 16;         // channels a lane sums
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  float* s_p = tab + kG * kLd;
  float* tile = s_p + kWarps * kPass * kG;
  float* ptile = tile + kTile * kD;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const int n = min(kTile, ql - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row0 = static_cast<size_t>(b) * ql + r0;

  const TIn* src = source + static_cast<size_t>(b) * t_len * kD;
  for (int i = threadIdx.x; i < kG * kD; i += kThreads) {
    const int t = i / kD;
    tab[i + t * (kLd - kD)] = t < t_len ? widen(src[i]) : 0.f;  // (t, k) at t * kLd + k
  }
  tile_in(query + row0 * kD, tile, n * kD);
  for (int i = n * kD + threadIdx.x; i < kTile * kD; i += kThreads) tile[i] = 0.f;
  const int g = lane / kG, w = lane % kG;  // scores: row group, word
  const bool word = w < t_len;
  const float my_bias =
      word && pad != nullptr && pad[static_cast<size_t>(b) * t_len + w] ? kPadBias : 0.f;
  __syncthreads();

  float s_row[kD];  // S[w, :]
#pragma unroll
  for (int k = 0; k < kD / 4; ++k) {
    const float4 v = reinterpret_cast<const float4*>(tab + w * kLd)[k];
    s_row[4 * k] = v.x;
    s_row[4 * k + 1] = v.y;
    s_row[4 * k + 2] = v.z;
    s_row[4 * k + 3] = v.w;
  }
  const int h = lane >> 4, m = lane & 15;  // context: row parity, first channel
  float* p_rows = s_p + warp * kPass * kG;  // P operands of the pass's rows
  for (int first = warp * kPass; first < n; first += kWarps * kPass) {
    // row first + kGroups * j + g is slot kGroups * j + g of the pass; rows
    // past n (the tile's zeros) are scored and never written out
    const float4* q4 = reinterpret_cast<const float4*>(tile + (first + g) * kD);
    float s[kLaneRows];
#pragma unroll
    for (int j = 0; j < kLaneRows; ++j) s[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kD / 4; ++k) {
#pragma unroll
      for (int j = 0; j < kLaneRows; ++j) {
        const float4 v = q4[j * kGroups * kD / 4 + k];
        s[j] = fmaf(v.x, s_row[4 * k], s[j]);
        s[j] = fmaf(v.y, s_row[4 * k + 1], s[j]);
        s[j] = fmaf(v.z, s_row[4 * k + 2], s[j]);
        s[j] = fmaf(v.w, s_row[4 * k + 3], s[j]);
      }
    }
    rows_softmax<kLaneRows, kG>(s, word, my_bias);
#pragma unroll
    for (int j = 0; j < kLaneRows; ++j) {
      const int row = first + kGroups * j + g;
      if (word && row < n) ptile[row * t_len + w] = s[j];
      p_rows[(kGroups * j + g) * kG + w] = p_operand<TIn>(s[j]);  // 0 at t >= T
    }
    __syncwarp();
    float c[kHalfRows][kChan];
#pragma unroll
    for (int i = 0; i < kHalfRows; ++i)
#pragma unroll
      for (int k = 0; k < kChan; ++k) c[i][k] = 0.f;
    for (int t = 0; t < t_len; t += 4) {  // slots up to kG hold P = 0 and table rows of 0
      float4 p[kHalfRows];
#pragma unroll
      for (int i = 0; i < kHalfRows; ++i)
        p[i] = reinterpret_cast<const float4*>(p_rows + (h + 2 * i) * kG + t)[0];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int k = 0; k < kChan; ++k) {
          const float v = tab[(t + u) * kLd + m + 16 * k];
#pragma unroll
          for (int i = 0; i < kHalfRows; ++i) {
            const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
            c[i][k] = fmaf(pu, v, c[i][k]);
          }
        }
      }
    }
    // the pass's queries were read before the shuffles
#pragma unroll
    for (int i = 0; i < kHalfRows; ++i) {
      const int row = first + h + 2 * i;
      if (row < n)
#pragma unroll
        for (int k = 0; k < kChan; ++k) tile[row * kD + m + 16 * k] = c[i][k];
    }
    __syncwarp();
  }
  __syncthreads();

  const float4* t4 = reinterpret_cast<const float4*>(tile);
  float4* c4 = reinterpret_cast<float4*>(ctx + row0 * kD);
  for (int i = threadIdx.x; i < n * kD / 4; i += kThreads) c4[i] = t4[i];
  float* pg = probs + row0 * t_len;
  for (int i = threadIdx.x; i < n * t_len; i += kThreads) pg[i] = ptile[i];
}

// One wide instance (kG word slots); past 48 KB of shared memory (128-row
// tiles from T 23 on) it raises the kernel's cap first.
template <int kD, int kG, int kTile, typename TIn>
cudaError_t launch_wide_slots(const TIn* query, const TIn* source, const unsigned char* pad,
                              float* ctx, float* probs, int batch, int ql, int t_len,
                              cudaStream_t stream) {
  static size_t granted[kMaxDevices];
  const dim3 grid((ql + kTile - 1) / kTile, batch);
  const size_t smem = wide_smem_bytes(t_len, kD, kG, kTile);
  const cudaError_t err =
      allow_smem(word_attention_fwd_wide_kernel<kD, kG, kTile, TIn>, granted, smem);
  if (err != cudaSuccess) return err;
  word_attention_fwd_wide_kernel<kD, kG, kTile, TIn><<<grid, kThreads, smem, stream>>>(
      query, source, pad, ctx, probs, ql, t_len);
  return cudaSuccess;
}

template <int kD, int kTile, typename TIn>
cudaError_t launch_wide(const TIn* query, const TIn* source, const unsigned char* pad,
                        float* ctx, float* probs, int batch, int ql, int t_len,
                        cudaStream_t stream) {
  return t_len <= 16
             ? launch_wide_slots<kD, 16, kTile>(query, source, pad, ctx, probs, batch, ql,
                                                t_len, stream)
             : launch_wide_slots<kD, 32, kTile>(query, source, pad, ctx, probs, batch, ql,
                                                t_len, stream);
}

// The generic instance's sizes so far, [TIn is bfloat16][device].
size_t generic_granted[2][kMaxDevices];

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The compile-time D a launch takes (kFastD, kWideD), or 0 for the generic
// instance: the compile-time ones copy the query and ctx tiles as 16-byte
// vectors, so they want both 16-byte aligned.
int instance(int d, bool aligned) { return aligned && (d == kFastD || d == kWideD) ? d : 0; }

template <typename TIn>
cudaError_t launch(const TIn* query, const TIn* source, const unsigned char* pad, float* ctx,
                   float* probs, int batch, int ql, int t_len, int d, cudaStream_t stream) {
  const dim3 grid((ql + kRows - 1) / kRows, batch);
  const size_t smem = smem_bytes(t_len, d);
  const int kind = instance(d, aligned16(query) && aligned16(ctx));
  if (kind == kFastD) {
    word_attention_fwd_kernel<kFastD, TIn><<<grid, kThreads, smem, stream>>>(
        query, source, pad, ctx, probs, ql, t_len, d);
  } else if (kind == kWideD) {
    const cudaError_t err =
        static_cast<long>(batch) * ql >= kTallRows
            ? launch_wide<kWideD, kTallTile>(query, source, pad, ctx, probs, batch, ql, t_len,
                                             stream)
            : launch_wide<kWideD, kRows>(query, source, pad, ctx, probs, batch, ql, t_len,
                                         stream);
    if (err != cudaSuccess) return err;
  } else {
    const cudaError_t err = allow_smem(word_attention_fwd_kernel<0, TIn>,
                                       generic_granted[sizeof(TIn) == 2], smem);
    if (err != cudaSuccess) return err;
    word_attention_fwd_kernel<0, TIn><<<grid, kThreads, smem, stream>>>(
        query, source, pad, ctx, probs, ql, t_len, d);
  }
  return cudaGetLastError();
}

}  // namespace

// Query rows per block, for tests that cut QL at the tile's edge.
extern "C" int word_attention_tile_rows() { return kRows; }

// The instance a launch at width d takes: d for a compile-time one (32, 48),
// 0 for the generic one.  `aligned`: query and ctx start on 16 bytes.
extern "C" int word_attention_instance(int d, int aligned) { return instance(d, aligned != 0); }

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
