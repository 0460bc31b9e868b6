// Coalition barycenter segment sum: CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/segment_mean.py:
//   segment_sum  out[j, c] = sum_i mix[j, i] * w[i, c]        (K, N) @ (N, D)
// with mix (K, N) f32 (the coalition one-hot, or the aggregation matrix with
// client weights and the empty-coalition fallback folded in) and W (N, D) f32
// or bf16, cast to f32 on load; the sums are f32.
//
// Bound.  2K floating-point operations per element of W read: device-memory
// bytes bound it, N*D*sizeof(W) read + K*D*4 written, each once.
//
// Design.  The TPU kernel emits one (K, block_d) tile per sequential grid
// step.  Here each thread owns columns instead: the (K, N) mix sits in shared
// memory (every lane of a warp reads the same word, a broadcast), a thread
// reads the N values of its column (neighbouring threads on neighbouring
// addresses, N independent loads in flight), keeps KG sums in registers and
// writes each of its K outputs once.  KG, the rows summed per read of the
// column, is a compile-time 4, 8 or 16, the least that holds K (16 beyond):
// each of W's values then costs KG shared-memory broadcasts and KG FMAs, a
// few times under what the card can issue per byte it streams.  A grid that
// fills the card walks the columns with a grid stride.  Every output has one
// writer, so there is no cross-CTA reduction and no atomic.  K > 16 re-reads
// the column once per further group of 16 rows.
//
// Limits (the entry points return cudaErrorInvalidValue beyond them):
//   N >= 1, K >= 1, K*N <= kMaxMix (the mix in 48 KB of shared memory), D >= 1.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMix = 12288;   // K*N floats of shared memory: 48 KB

template <typename T, int KG>
__global__ void __launch_bounds__(kThreads)
    segment_sum_cols(const T* __restrict__ w, const float* __restrict__ mix,
                     float* __restrict__ out, int n, long long d, int k) {
  extern __shared__ float ms[];  // (k, n)
  for (int i = threadIdx.x; i < k * n; i += kThreads) ms[i] = mix[i];
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long col = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       col < d; col += stride) {
    const T* wc = w + col;
    for (int j0 = 0; j0 < k; j0 += KG) {
      float acc[KG];
#pragma unroll
      for (int g = 0; g < KG; ++g) acc[g] = 0.f;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float v = to_f32(wc[static_cast<long long>(i) * d]);
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (j0 + g < k) acc[g] = fmaf(ms[(j0 + g) * n + i], v, acc[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        if (j0 + g < k) out[static_cast<long long>(j0 + g) * d + col] = acc[g];
      }
    }
  }
}

bool shape_ok(int n, long long d, int k) {
  return n >= 1 && k >= 1 && d >= 1 &&
         static_cast<long long>(k) * n <= kMaxMix;
}

template <typename T, int KG>
cudaError_t grid_kg(int n, long long d, int k, int device, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * static_cast<size_t>(k) * n;
  return fill_grid(segment_sum_cols<T, KG>, kThreads, smem, device,
                   (d + kThreads - 1) / kThreads, grid);
}

template <typename T>
cudaError_t grid_for(int n, long long d, int k, int device, int* grid) {
  if (k <= 4) return grid_kg<T, 4>(n, d, k, device, grid);
  if (k <= 8) return grid_kg<T, 8>(n, d, k, device, grid);
  return grid_kg<T, 16>(n, d, k, device, grid);
}

template <typename T, int KG>
cudaError_t launch_kg(const T* w, const float* mix, float* out, int n,
                      long long d, int k, int grid, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(k) * n;
  segment_sum_cols<T, KG><<<grid, kThreads, smem, stream>>>(w, mix, out, n,
                                                            d, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* w_, const float* mix, float* out, int n,
                   long long d, int k, int grid, int device,
                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const T* w = static_cast<const T*>(w_);
  if (k <= 4) return launch_kg<T, 4>(w, mix, out, n, d, k, grid, stream);
  if (k <= 8) return launch_kg<T, 8>(w, mix, out, n, d, k, grid, stream);
  return launch_kg<T, 16>(w, mix, out, n, d, k, grid, stream);
}

}  // namespace

extern "C" {

// The largest K*N the kernel takes.
void sm_limits(int* max_mix) { *max_mix = kMaxMix; }

// Number of CTAs a launch uses for this shape; bf16 = 1 when W is bfloat16.
int sm_grid(int bf16, int n, long long d, int k, int device, int* grid) {
  if (!shape_ok(n, d, k)) return cudaErrorInvalidValue;
  return bf16 ? grid_for<__nv_bfloat16>(n, d, k, device, grid)
              : grid_for<float>(n, d, k, device, grid);
}

// w (n, d) row-major f32 or bf16; mix (k, n) f32; out (k, d) f32.
int sm_segment_sum(const void* w, int bf16, const float* mix, float* out,
                   int n, long long d, int k, int grid, int device,
                   void* stream) {
  if (!shape_ok(n, d, k) || grid < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(w, mix, out, n, d, k, grid, device, s)
              : launch<float>(w, mix, out, n, d, k, grid, device, s);
}

}  // extern "C"
