// Two-pass fused coalition round: CUDA kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_round.py:
//   pass 1  center_sq_dists        out[i, j] = max(sum_d (w[i, d] - c[j, d])^2, 0)
//           with c = conehot @ w rebuilt tile by tile (no (K, D) gather);
//   pass 2  fused_coalition_stats  b = m @ w (K, D), theta = mean_j b[j] (D,),
//           med_d2[i, j] = max(sum_d (w[i, d] - b[j, d])^2, 0)
//           from a single read of w.
//
// Bound.  With N, K of a few to a few dozen, each element of W costs about
// 3K floating-point operations per 4 bytes read, far below the fp32 ridge:
// both passes are bound by device-memory bytes.  Pass 1 moves N*D*sizeof(T)
// bytes, pass 2 that plus 4*(K + 1)*D bytes of b and theta.
//
// Design.  The TPU grid walks D in order into one resident accumulator.  Here
// every CTA takes a strided set of kTile-column tiles of W instead, so all SMs
// stream at once:
//   1. stage the (N, kTile) tile in shared memory, casting bf16 -> f32 on load,
//      zero past the ragged edge of D (zero columns add nothing to any sum);
//   2. build the K rows of the tile, rows = mix @ tile, in shared memory: the
//      K centers (pass 1, mix = the (K, N) center one-hot) or barycenters
//      (pass 2, mix = the (K, N) aggregation matrix), for any (K, N) matrix;
//      pass 2 writes b and theta for each column exactly once here;
//   3. accumulate sum (w - row)^2 per (i, j) pair in registers, in the diff
//      form (no cancellation, and as cheap as the Gram form at these N*K);
//      when N*K < kThreads several lanes of threads split the tile's columns.
// At the end each CTA reduces its lanes in a fixed order and writes one
// (N*K,) partial.  A second launch sums the partials of all CTAs in a fixed
// tree order and clamps at 0.  No float atomics: runs are reproducible.
//
// Limits (the entry points return cudaErrorInvalidValue beyond them):
//   1 <= N <= kMaxN, 1 <= K <= N, N*K <= kMaxPairs, D >= 1.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;             // threads per CTA
constexpr int kTile = kThreads;           // D-columns per tile: one per thread
constexpr int kStride = kTile + 1;        // padded shared-memory row stride
constexpr int kMaxItems = 8;              // (pair, lane) accumulators a thread
constexpr int kMaxN = 128;
constexpr int kMaxPairs = kThreads * kMaxItems;

__host__ __device__ inline int lanes_for(int npairs) {
  return npairs >= kThreads ? 1 : kThreads / npairs;
}

size_t smem_bytes(int n, int k) {
  const int npairs = n * k;
  const int nitems = npairs * lanes_for(npairs);
  return sizeof(float) *
         (static_cast<size_t>(n + k) * kStride + static_cast<size_t>(k) * n +
          nitems);
}

// STATS = false: pass 1.  STATS = true: pass 2, which also writes b and theta.
// partials is (N*K, gridDim.x): column blockIdx.x holds this CTA's sums.
template <typename T, bool STATS>
__global__ void __launch_bounds__(kThreads)
    tile_sq_dists(const T* __restrict__ w, const float* __restrict__ mix,
                  float* __restrict__ b, float* __restrict__ theta,
                  float* __restrict__ partials, int n, long long d, int k) {
  extern __shared__ float smem[];
  float* ws = smem;                 // (n, kStride) tile of W in f32
  float* rs = ws + n * kStride;     // (k, kStride) rows = mix @ tile
  float* ms = rs + k * kStride;     // (k, n) mix
  float* red = ms + k * n;          // (nitems,) lane reduction

  const int tid = threadIdx.x;
  const int npairs = n * k;
  const int lanes = lanes_for(npairs);
  const int nitems = npairs * lanes;

  for (int i = tid; i < k * n; i += kThreads) ms[i] = mix[i];

  float acc[kMaxItems];
#pragma unroll
  for (int s = 0; s < kMaxItems; ++s) acc[s] = 0.f;

  const long long ntiles = (d + kTile - 1) / kTile;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long col = tile * kTile + tid;
    const bool in = col < d;
    __syncthreads();  // the previous tile's readers are done with ws and rs
    for (int i = 0; i < n; ++i) {
      ws[i * kStride + tid] =
          in ? to_f32(w[static_cast<long long>(i) * d + col]) : 0.f;
    }
    // each thread builds its own column of the k rows: no barrier needed
    // between the stores above and the reads below
    float colsum = 0.f;
    for (int j = 0; j < k; ++j) {
      float r = 0.f;
      for (int i = 0; i < n; ++i) r = fmaf(ms[j * n + i], ws[i * kStride + tid], r);
      rs[j * kStride + tid] = r;
      if (STATS) {
        if (in) b[static_cast<long long>(j) * d + col] = r;
        colsum += r;
      }
    }
    if (STATS && in) theta[col] = colsum / static_cast<float>(k);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kMaxItems; ++s) {
      const int item = tid + s * kThreads;
      if (item < nitems) {
        const int p = item % npairs;
        const int lane = item / npairs;
        const float* wr = ws + (p / k) * kStride;
        const float* rr = rs + (p % k) * kStride;
        float a = acc[s];
        for (int t = lane; t < kTile; t += lanes) {
          const float diff = wr[t] - rr[t];
          a = fmaf(diff, diff, a);
        }
        acc[s] = a;
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int s = 0; s < kMaxItems; ++s) {
    const int item = tid + s * kThreads;
    if (item < nitems) red[item] = acc[s];
  }
  __syncthreads();
  for (int p = tid; p < npairs; p += kThreads) {
    float sum = 0.f;
    for (int lane = 0; lane < lanes; ++lane) sum += red[lane * npairs + p];
    partials[static_cast<long long>(p) * gridDim.x + blockIdx.x] = sum;
  }
}

// One CTA per (i, j) pair: strided sums over the CTAs' partials, then a
// fixed-shape tree, then the clamp at 0.
__global__ void __launch_bounds__(kThreads)
    reduce_partials(const float* __restrict__ partials, float* __restrict__ out,
                    int grid) {
  __shared__ float red[kThreads];
  const float* row = partials + static_cast<long long>(blockIdx.x) * grid;
  float sum = 0.f;
  for (int c = threadIdx.x; c < grid; c += kThreads) sum += row[c];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = fmaxf(red[0], 0.f);
}

bool shape_ok(int n, long long d, int k) {
  return n >= 1 && n <= kMaxN && k >= 1 && k <= n && n * k <= kMaxPairs &&
         d >= 1;
}

template <typename T, bool STATS>
cudaError_t prepare(int n, int k, int device, size_t* smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  *smem = smem_bytes(n, k);
  return cudaFuncSetAttribute(tile_sq_dists<T, STATS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename T, bool STATS>
cudaError_t grid_for(int n, long long d, int k, int device, int* grid) {
  size_t smem = 0;
  cudaError_t err = prepare<T, STATS>(n, k, device, &smem);
  if (err != cudaSuccess) return err;
  return fill_grid(tile_sq_dists<T, STATS>, kThreads, smem, device,
                   (d + kTile - 1) / kTile, grid);
}

template <typename T, bool STATS>
cudaError_t launch(const void* w, const float* mix, float* b, float* theta,
                   float* partials, float* out, int n, long long d, int k,
                   int grid, int device, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare<T, STATS>(n, k, device, &smem);
  if (err != cudaSuccess) return err;
  tile_sq_dists<T, STATS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(w), mix, b, theta, partials, n, d, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<n * k, kThreads, 0, stream>>>(partials, out, grid);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest N and N*K the kernels take.
void fr_limits(int* max_n, int* max_pairs) {
  *max_n = kMaxN;
  *max_pairs = kMaxPairs;
}

// Number of CTAs a pass launches for this shape (the columns of `partials`).
// stats = 0 for pass 1, 1 for pass 2; bf16 = 1 when W is bfloat16.
int fr_grid(int stats, int bf16, int n, long long d, int k, int device,
            int* grid) {
  if (!shape_ok(n, d, k)) return cudaErrorInvalidValue;
  if (bf16) {
    return stats ? grid_for<__nv_bfloat16, true>(n, d, k, device, grid)
                 : grid_for<__nv_bfloat16, false>(n, d, k, device, grid);
  }
  return stats ? grid_for<float, true>(n, d, k, device, grid)
               : grid_for<float, false>(n, d, k, device, grid);
}

// Pass 1.  w (n, d) row-major f32 or bf16; conehot (k, n) f32;
// partials (n*k, grid) f32 scratch; out (n, k) f32.
int fr_center_sq_dists(const void* w, int bf16, const float* conehot,
                       float* partials, float* out, int n, long long d, int k,
                       int grid, int device, void* stream) {
  if (!shape_ok(n, d, k) || grid < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16, false>(w, conehot, nullptr, nullptr, partials,
                                        out, n, d, k, grid, device, s);
  }
  return launch<float, false>(w, conehot, nullptr, nullptr, partials, out, n,
                              d, k, grid, device, s);
}

// Pass 2.  w (n, d) row-major f32 or bf16; m (k, n) f32; b (k, d) f32;
// theta (d,) f32; partials (n*k, grid) f32 scratch; med_d2 (n, k) f32.
int fr_fused_coalition_stats(const void* w, int bf16, const float* m, float* b,
                             float* theta, float* partials, float* med_d2,
                             int n, long long d, int k, int grid, int device,
                             void* stream) {
  if (!shape_ok(n, d, k) || grid < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16, true>(w, m, b, theta, partials, med_d2, n, d,
                                       k, grid, device, s);
  }
  return launch<float, true>(w, m, b, theta, partials, med_d2, n, d, k, grid,
                             device, s);
}

}  // extern "C"
