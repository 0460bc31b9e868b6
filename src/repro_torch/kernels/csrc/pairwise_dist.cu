// Distance kernels of the coalition engine: CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pairwise_dist.py:
//   sq_dists_to_points  out[i, j] = max(sum_d (w[i, d] - p[j, d])^2, 0)  (N, K)
//   pairwise_sq_dists   out[i, j] = max(sum_d (w[i, d] - w[j, d])^2, 0)  (N, N),
//                       symmetric, with the diagonal exactly 0.
// W and P may each be float32 or bfloat16; both are cast to f32 on load and
// every sum is taken in f32.
//
// Bound.  Each element of W costs about 3K (or 3N/2) floating-point operations
// per 4 bytes read, far below the fp32 ridge: both kernels are bound by
// device-memory bytes, N*D*sizeof(W) (+ K*D*sizeof(P)) read once.  At the
// sketch widths (D = S = 64..2048) the whole input is a few KB (13 KB at
// N = 10, K = 3, S = 256 f32: 0.004 us at 3.35 TB/s) and a call is bound by
// its launch.
//
// Design, full width (D > kSmallD for sq_dists_to_points; every D for
// pairwise_sq_dists).  The TPU kernels walk D in order into one resident
// accumulator, in the Gram form.  Here, as in fused_round.cu, every CTA
// takes a strided set of kTile-column tiles instead, so all SMs stream at
// once:
//   1. stage the tile of W (and of P) in shared memory as f32, zero past the
//      ragged edge of D (zero columns add nothing to any sum);
//   2. accumulate sum (x - y)^2 per (row pair, lane) item in registers, in the
//      diff form (more accurate than Gram, and as cheap at these N*K); when
//      there are fewer pairs than threads, several lanes of threads split the
//      tile's columns.  pairwise_sq_dists takes only the N(N-1)/2 pairs i < j.
// At the end each CTA reduces its lanes in a fixed order and writes one
// (npairs,) partial; a second launch sums the partials of all CTAs in a fixed
// tree order, clamps at 0 and writes the output (both halves of the symmetric
// matrix, and its zero diagonal).  No float atomics: runs are reproducible.
// pairwise_sq_dists at D <= kSmallD runs a single CTA that walks every tile
// and writes the output itself: one launch, no partials.
//
// Design, sketch widths (sq_dists_to_points at D <= kSmallD: warp_dists).
// A single CTA staging all N + K rows and reducing through shared memory is
// one chain of dependent steps on one SM, ~5 us above the launch floor for
// 13 KB.  Instead one warp owns one (i, j) pair, kSmallWarps warps a CTA,
// ceil(N K / kSmallWarps) CTAs, one launch: each lane reads 8 columns of w_i
// and of p_j at a time straight from device memory (16-byte vectors when
// both rows are 16-byte aligned, i.e. D % 8 == 0 and aligned bases; single
// elements otherwise), sums (x - y)^2 in f32 over its columns in a fixed
// order, and a fixed __shfl_xor tree reduces the warp; lane 0 clamps at 0
// and writes.  No shared memory, no __syncthreads, no atomics: deterministic.
//
// Limits (the entry points return cudaErrorInvalidValue beyond them):
//   sq_dists_to_points  1 <= N <= kMaxN, 1 <= K <= kMaxK, N*K <= kMaxPairs;
//   pairwise_sq_dists   1 <= N <= kMaxPairwiseN (N(N-1)/2 <= kMaxPairs);
//   D >= 1.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;             // threads per CTA
constexpr int kTile = kThreads;           // D-columns per tile: one per thread
constexpr int kStride = kTile + 1;        // padded shared-memory row stride
constexpr int kMaxItems = 8;              // (pair, lane) accumulators a thread
constexpr int kMaxPairs = kThreads * kMaxItems;
constexpr int kMaxN = 128;
constexpr int kMaxK = 64;
constexpr int kMaxPairwiseN = 64;         // 64 * 63 / 2 = 2016 pairs
constexpr long long kSmallD = 8 * kTile;  // the sketch widths, D <= 2048
constexpr int kSmallWarps = 8;            // pairs of a warp_dists CTA

__host__ __device__ inline int num_pairs(bool pairwise, int n, int k) {
  return pairwise ? n * (n - 1) / 2 : n * k;
}

__host__ __device__ inline int lanes_for(int npairs) {
  return npairs >= kThreads || npairs == 0 ? 1 : kThreads / npairs;
}

size_t smem_bytes(bool pairwise, int n, int k) {
  const int npairs = num_pairs(pairwise, n, k);
  const int rows = pairwise ? n : n + k;
  return sizeof(float) * static_cast<size_t>(rows) * kStride +
         sizeof(int) * static_cast<size_t>(npairs) +
         sizeof(float) * static_cast<size_t>(npairs) * lanes_for(npairs);
}

// Pair p's rows (a, b), packed as a << 16 | b: row-major (i, j) for
// sq_dists_to_points, the upper triangle i < j in row order for pairwise.
__device__ inline int pair_rows(bool pairwise, int p, int n, int k) {
  if (!pairwise) return (p / k) << 16 | (p % k);
  int a = 0;
  while (p >= n - 1 - a) {
    p -= n - 1 - a;
    ++a;
  }
  return a << 16 | (a + 1 + p);
}

// Final value of pair p (rows packed as in pair_rows): clamped at 0, written
// to (a, b), and to (b, a) for the symmetric pairwise matrix.
__device__ inline void write_pair(bool pairwise, float* out, int p, int rows,
                                  int n, int k, float sum) {
  const float v = fmaxf(sum, 0.f);
  if (!pairwise) {
    out[p] = v;
    return;
  }
  const int a = rows >> 16, b = rows & 0xffff;
  out[a * n + b] = v;
  out[b * n + a] = v;
}

// partials is (npairs, gridDim.x): column blockIdx.x holds this CTA's sums.
// With gridDim.x == 1 the CTA writes out directly and partials is unused.
// For PAIRWISE, P is W itself and p is ignored.
template <typename TW, typename TP, bool PAIRWISE>
__global__ void __launch_bounds__(kThreads)
    tile_dists(const TW* __restrict__ w, const TP* __restrict__ p,
               float* __restrict__ partials, float* __restrict__ out, int n,
               long long d, int k) {
  extern __shared__ float smem[];
  const int nrows = PAIRWISE ? n : n + k;
  float* ws = smem;                                          // (nrows, kStride)
  const float* ys = PAIRWISE ? ws : ws + n * kStride;        // second operand
  int* pr = reinterpret_cast<int*>(ws + nrows * kStride);    // (npairs,)
  const int npairs = num_pairs(PAIRWISE, n, k);
  float* red = reinterpret_cast<float*>(pr + npairs);        // (nitems,)

  const int tid = threadIdx.x;
  const int lanes = lanes_for(npairs);
  const int nitems = npairs * lanes;

  for (int q = tid; q < npairs; q += kThreads) {
    pr[q] = pair_rows(PAIRWISE, q, n, k);
  }

  float acc[kMaxItems];
#pragma unroll
  for (int s = 0; s < kMaxItems; ++s) acc[s] = 0.f;

  const long long ntiles = (d + kTile - 1) / kTile;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long col = tile * kTile + tid;
    const bool in = col < d;
    __syncthreads();  // the previous tile's readers are done with ws
    for (int i = 0; i < n; ++i) {
      ws[i * kStride + tid] =
          in ? to_f32(w[static_cast<long long>(i) * d + col]) : 0.f;
    }
    if (!PAIRWISE) {
      for (int j = 0; j < k; ++j) {
        ws[(n + j) * kStride + tid] =
            in ? to_f32(p[static_cast<long long>(j) * d + col]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kMaxItems; ++s) {
      const int item = tid + s * kThreads;
      if (item < nitems) {
        const int rows = pr[item % npairs];
        const int lane = item / npairs;
        const float* xr = ws + (rows >> 16) * kStride;
        const float* yr = ys + (rows & 0xffff) * kStride;
        float a = acc[s];
        for (int t = lane; t < kTile; t += lanes) {
          const float diff = xr[t] - yr[t];
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
  for (int q = tid; q < npairs; q += kThreads) {
    float sum = 0.f;
    for (int lane = 0; lane < lanes; ++lane) sum += red[lane * npairs + q];
    if (gridDim.x == 1) {
      write_pair(PAIRWISE, out, q, pr[q], n, k, sum);
    } else {
      partials[static_cast<long long>(q) * gridDim.x + blockIdx.x] = sum;
    }
  }
  if (PAIRWISE && gridDim.x == 1) {
    for (int i = tid; i < n; i += kThreads) out[i * n + i] = 0.f;
  }
}

// One CTA per pair: strided sums over the CTAs' partials, then a fixed-shape
// tree, then the clamp.  For PAIRWISE one more CTA writes the zero diagonal.
template <bool PAIRWISE>
__global__ void __launch_bounds__(kThreads)
    reduce_pairs(const float* __restrict__ partials, float* __restrict__ out,
                 int grid, int n, int k) {
  __shared__ float red[kThreads];
  const int q = blockIdx.x;
  if (PAIRWISE && q == num_pairs(true, n, k)) {
    for (int i = threadIdx.x; i < n; i += kThreads) out[i * n + i] = 0.f;
    return;
  }
  const float* row = partials + static_cast<long long>(q) * grid;
  float sum = 0.f;
  for (int c = threadIdx.x; c < grid; c += kThreads) sum += row[c];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    write_pair(PAIRWISE, out, q, pair_rows(PAIRWISE, q, n, k), n, k, red[0]);
  }
}

// Eight consecutive elements from p as f32: two float4 or one uint4 of bf16.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// sq_dists_to_points at D <= kSmallD: warp w of CTA c owns pair
// c * kSmallWarps + w, (i, j) row-major; out (n, k).  vec: both operands'
// rows are 16-byte aligned (D % 8 == 0, aligned bases).
template <typename TW, typename TP>
__global__ void __launch_bounds__(kSmallWarps * 32)
    warp_dists(const TW* __restrict__ w, const TP* __restrict__ p,
               float* __restrict__ out, int n, int d, int k, int vec) {
  const int pair = blockIdx.x * kSmallWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pair >= n * k) return;                // the whole warp leaves
  const TW* x = w + static_cast<long long>(pair / k) * d;
  const TP* y = p + static_cast<long long>(pair % k) * d;
  float acc = 0.f;
  if (vec) {
    for (int c = 8 * lane; c < d; c += 8 * 32) {
      float xv[8], yv[8];
      load8(x + c, xv);
      load8(y + c, yv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float diff = xv[e] - yv[e];
        acc = fmaf(diff, diff, acc);
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float diff = to_f32(x[c]) - to_f32(y[c]);
      acc = fmaf(diff, diff, acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[pair] = fmaxf(acc, 0.f);
}

template <typename TW, typename TP>
cudaError_t launch_small(const void* w, const void* p, float* out, int n,
                         long long d, int k, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const int ctas = (n * k + kSmallWarps - 1) / kSmallWarps;
  warp_dists<TW, TP><<<ctas, kSmallWarps * 32, 0, stream>>>(
      static_cast<const TW*>(w), static_cast<const TP*>(p), out, n,
      static_cast<int>(d), k, vec);
  return cudaGetLastError();
}

bool shape_ok(bool pairwise, int n, long long d, int k) {
  if (d < 1 || n < 1) return false;
  if (pairwise) return n <= kMaxPairwiseN;
  return n <= kMaxN && k >= 1 && k <= kMaxK && n * k <= kMaxPairs;
}

template <typename TW, typename TP, bool PAIRWISE>
cudaError_t prepare(int n, int k, int device, size_t* smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  *smem = smem_bytes(PAIRWISE, n, k);
  return cudaFuncSetAttribute(tile_dists<TW, TP, PAIRWISE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename TW, typename TP, bool PAIRWISE>
cudaError_t grid_for(int n, long long d, int k, int device, int* grid) {
  if (d <= kSmallD || num_pairs(PAIRWISE, n, k) == 0) {
    *grid = 1;
    return cudaSuccess;
  }
  size_t smem = 0;
  cudaError_t err = prepare<TW, TP, PAIRWISE>(n, k, device, &smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = (d + kTile - 1) / kTile;
  return fill_grid(tile_dists<TW, TP, PAIRWISE>, kThreads, smem, device,
                   ntiles, grid);
}

template <typename TW, typename TP, bool PAIRWISE>
cudaError_t launch(const void* w, const void* p, float* partials, float* out,
                   int n, long long d, int k, int grid, int device,
                   cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare<TW, TP, PAIRWISE>(n, k, device, &smem);
  if (err != cudaSuccess) return err;
  tile_dists<TW, TP, PAIRWISE><<<grid, kThreads, smem, stream>>>(
      static_cast<const TW*>(w), static_cast<const TP*>(p), partials, out, n,
      d, k);
  err = cudaGetLastError();
  if (err != cudaSuccess || grid == 1) return err;
  const int ctas = num_pairs(PAIRWISE, n, k) + (PAIRWISE ? 1 : 0);
  reduce_pairs<PAIRWISE><<<ctas, kThreads, 0, stream>>>(partials, out, grid,
                                                        n, k);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" {

// The shape limits: sq_dists_to_points takes N <= max_n, K <= max_k,
// N*K <= max_pairs; pairwise_sq_dists takes N <= max_pairwise_n.
void pd_limits(int* max_n, int* max_k, int* max_pairs, int* max_pairwise_n) {
  *max_n = kMaxN;
  *max_k = kMaxK;
  *max_pairs = kMaxPairs;
  *max_pairwise_n = kMaxPairwiseN;
}

// Number of CTAs a launch uses for this shape (the columns of `partials`;
// 1 means the kernel writes the output itself and `partials` is unused).
// pairwise = 1 for pairwise_sq_dists (k ignored); w_bf16 / p_bf16 = 1 when
// W / P is bfloat16.
int pd_grid(int pairwise, int w_bf16, int p_bf16, int n, long long d, int k,
            int device, int* grid) {
  if (!shape_ok(pairwise, n, d, k)) return cudaErrorInvalidValue;
  if (pairwise) {
    return w_bf16 ? grid_for<bf16, bf16, true>(n, d, k, device, grid)
                  : grid_for<float, float, true>(n, d, k, device, grid);
  }
  if (w_bf16) {
    return p_bf16 ? grid_for<bf16, bf16, false>(n, d, k, device, grid)
                  : grid_for<bf16, float, false>(n, d, k, device, grid);
  }
  return p_bf16 ? grid_for<float, bf16, false>(n, d, k, device, grid)
                : grid_for<float, float, false>(n, d, k, device, grid);
}

// w (n, d) and p (k, d) row-major, each f32 or bf16; partials (n*k, grid) f32
// scratch; out (n, k) f32.
int pd_sq_dists_to_points(const void* w, int w_bf16, const void* p,
                          int p_bf16, float* partials, float* out, int n,
                          long long d, int k, int grid, int device,
                          void* stream) {
  if (!shape_ok(false, n, d, k) || grid < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= kSmallD) {
    if (w_bf16) {
      return p_bf16 ? launch_small<bf16, bf16>(w, p, out, n, d, k, device, s)
                    : launch_small<bf16, float>(w, p, out, n, d, k, device, s);
    }
    return p_bf16 ? launch_small<float, bf16>(w, p, out, n, d, k, device, s)
                  : launch_small<float, float>(w, p, out, n, d, k, device, s);
  }
  if (w_bf16) {
    return p_bf16 ? launch<bf16, bf16, false>(w, p, partials, out, n, d, k,
                                              grid, device, s)
                  : launch<bf16, float, false>(w, p, partials, out, n, d, k,
                                               grid, device, s);
  }
  return p_bf16 ? launch<float, bf16, false>(w, p, partials, out, n, d, k,
                                             grid, device, s)
                : launch<float, float, false>(w, p, partials, out, n, d, k,
                                              grid, device, s);
}

// w (n, d) row-major f32 or bf16; partials (n(n-1)/2, grid) f32 scratch;
// out (n, n) f32.
int pd_pairwise_sq_dists(const void* w, int bf16_in, float* partials,
                         float* out, int n, long long d, int grid, int device,
                         void* stream) {
  if (!shape_ok(true, n, d, 0) || grid < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_in) {
    return launch<bf16, bf16, true>(w, w, partials, out, n, d, 0, grid, device,
                                    s);
  }
  return launch<float, float, true>(w, w, partials, out, n, d, 0, grid, device,
                                    s);
}

}  // extern "C"
