// What the DAMSM similarity kernels share: damsm_sim.cu (K1, K2) and
// damsm_dwords.cu (K3) each include it, so each library has its own copy.

#pragma once

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxT = 32;   // words held per text
constexpr int kMaxD = 256;  // embedding width
constexpr float kEps = 1e-8f;
constexpr size_t kSmemLimit = 232448;  // a block's dynamic shared memory on sm_90
constexpr int kSumThreads = 256;       // threads a block of sum_splits_kernel

// per-word scalars, each an array of kMaxT floats
enum Row { kM2 = 0, kS2, kNum, kWn, kCn, kRs, kDNum, kFc, kFw, kInner2, kLse, kRowCount };

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

}  // namespace
