// Code shared by the port's CUDA sources (fused_round.cu, pairwise_dist.cu,
// segment_mean.cu, flash_attention.cu, conv_pool.cu).  Each source is a
// shared library of its own and compiles its own copy of what is here.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// CTAs of `threads` threads that fill the card once at `smem` bytes of
// dynamic shared memory each, capped at `work` (the number of column tiles).
template <typename Kernel>
cudaError_t fill_grid(Kernel kernel, int threads, size_t smem, int device,
                      long long work, int* grid) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long full = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(work < full ? work : full);
  return cudaSuccess;
}

}  // namespace

// The message for a CUDA error code that an entry point returned.
extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
