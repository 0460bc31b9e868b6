// Two-pass fused coalition round: CUDA kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_round.py:
//   pass 1  center_sq_dists        out[i, j] = max(sum_d (w[i, d] - c[j, d])^2, 0)
//           with c = conehot @ w built in the kernel (no (K, D) gather);
//   pass 2  fused_coalition_stats  b = m @ w (K, D), theta = mean_j b[j] (D,),
//           med_d2[i, j] = max(sum_d (w[i, d] - b[j, d])^2, 0)
//           from a single read of w.
// W is float32 or bfloat16; every sum is taken in f32, in the diff form (no
// Gram cancellation).
//
// Bound.  With N, K of a few to a few dozen, each element of W costs about
// 3K floating-point operations per 4 bytes read, far below the fp32 ridge:
// both passes are bound by device-memory bytes.  Pass 1 moves N*D*sizeof(T)
// bytes, pass 2 that plus 4*(K + 1)*D bytes of b and theta: at N = 10, K = 3,
// D = 582,026 f32, 23.3 MB (6.95 us at 3.35 TB/s) and 32.6 MB (9.73 us); at
// D = 8M, 320 MB (95.5 us) and 448 MB (133.7 us).
//
// Why the first design (tile_sq_dists below) reached only 17-25% of that
// (28-38% at D = 8M).  Every CTA staged a 256-column tile of all N rows in
// shared memory, built the K rows of the tile there, and read both back once
// per (pair, column):
//   - per element of W, ~1 + K + 2K shared-memory accesses against one DRAM
//     load (~120 a column at N = 10, K = 3): ~2 MB of shared traffic per SM,
//     ~9 us at 128 B/clk, serialized behind the loads;
//   - two __syncthreads a tile, and no overlap of a tile's loads with the
//     previous tile's arithmetic;
//   - 2-3 tiles walked back to back by each CTA, each paying the latency of
//     a flushed L2;
//   - a second launch (reduce_partials) to sum the per-CTA partials.
//
// Design (reg_sq_dists): W goes from device memory straight into registers,
// each element once.  The sweep's parts (tiers, loads, the grid-wide sweep,
// the CTA sums and the last CTA's tail) are in reg_sweep.cuh, shared with
// the full-width distance kernel and the segment sum.
//   - One CTA a SM, of 512 threads (at most 128 registers a thread) or 384
//     (168).  All CTAs sweep D together, a step of the grid over adjacent
//     columns, so the DRAM pages of a row are read in order; each thread takes
//     a group of V = 2 adjacent columns (1 where D is odd or the base is not
//     2-element aligned) of all N rows a step, so a warp's load of a row is
//     up to 256 contiguous bytes.  No shared memory per element, and no
//     barrier in the sweep.
//   - Each of the K rows r = sum_i mix[j, i] * w[i] is built in a register;
//     the (K, N) mix sits in shared memory, read with warp-uniform addresses
//     (4 values a broadcast).  (w[i] - r)^2 goes into N*K accumulators in
//     registers.  Pass 2 writes r to b[j] and the column mean to theta exactly
//     once, with the load's vector width.  N and K are compile-time, so every
//     loop over them unrolls.
//   - Loads in flight: in the exact tier the next step's loads are issued
//     before this step's arithmetic (two steps of W in registers): N*V*4 B
//     a thread, 40 KB a SM at N = 10 f32, always in flight.
//   - One launch.  Each thread's sums go through a __shfl_xor tree per pair,
//     the warps of the CTA are summed in index order, and the CTA writes one
//     row of partials, padded to the tier's caps so that every offset in it
//     is a compile-time constant.  The last CTA to finish, found by an
//     integer ticket (the CTA's barrier, then one thread's __threadfence and
//     atomicAdd: the pattern of a grid-wide barrier; the wrapper keeps one
//     zeroed ticket per device and stream, and that CTA resets it to 0), sums
//     the rows of all CTAs, one row a thread, in the same fixed tree; it
//     clamps at 0 and writes out.  Which CTA is last changes nothing in the
//     order of the sums, and the grid depends only on the shape and the card:
//     runs are reproducible bit for bit.  No float atomics.  One CTA a SM
//     keeps the rows to 132 on an H100, so the last CTA reads them all in one
//     round of loads; with more, smaller CTAs the tail grew by a round of
//     loads per row a thread, and a second launch cost more than this tail.
//   - Tiers.  Registers bound a thread's loads in flight.  Rows and pairs
//     past a runtime N or K, kept apart by predicates, took about a third
//     more registers than a kernel compiled for its exact N and K, and
//     slowed the sweep.  So the paper's configuration (N = 10, K = 3, the
//     CLI's default) has kernels of its own (ExactTier, pipelined), and every
//     other N <= kRegN, K <= kRegK shares one tier with no predicate in the
//     sweep: its rows past N read row N - 1 again, against a zero mix, and
//     the sums of rows and pairs past (N, K) are dropped at the end
//     (RegsTier, one column group a step).

// Routes by shape (the wrapper's route(); the entry points refuse a route
// the shape does not fit):
//   - (N, K) = (kExactN, kExactK): reg_sq_dists<ExactTier>, V = 2 or 1;
//   - other N <= kRegN, K <= kRegK: reg_sq_dists<RegsTier>, V = 2 or 1;
//   - larger N or K (up to the limits): tile_sq_dists, the first design
//     (its N*K sums are spread over the CTA's threads, so they need not fit
//     one thread's registers), with reduce_partials after it.
//
// Limits (the entry points return cudaErrorInvalidValue beyond them):
//   1 <= N <= kMaxN, 1 <= K <= N, N*K <= kMaxPairs, D >= 1.

#include "reg_sweep.cuh"

namespace {

constexpr int kThreads = 256;             // threads per tile_sq_dists CTA
constexpr int kTile = kThreads;           // D-columns per tile: one per thread
constexpr int kStride = kTile + 1;        // padded shared-memory row stride
constexpr int kMaxItems = 8;              // (pair, lane) accumulators a thread
constexpr int kMaxN = 128;
constexpr int kMaxPairs = kThreads * kMaxItems;

constexpr int kRegN = 16;                 // N and K caps of the register route
constexpr int kRegK = 4;
constexpr int kExactN = 10;               // the shape with a kernel of its own
constexpr int kExactK = 3;

// Routes (the entry points' `route`): the tile kernel, or the register kernel
// of a tier loading 1 or 2 columns of a row at a time.
constexpr int kRouteTile = 0;
constexpr int kRouteRegs1 = 1;
constexpr int kRouteRegs2 = 2;
constexpr int kRouteExact1 = 3;
constexpr int kRouteExact2 = 4;

using RegsTier = Tier<kRegN, kRegK, false, 1, false, 384>;
using ExactTier = Tier<kExactN, kExactK, true, 2, true, 512>;

// ------------------------------------------------------------ register route

// The arithmetic of one step: each of the KC rows r = sum_i mix[j, i] w[i]
// in registers (mix_row), then (w[i] - r)^2 into acc[i][j].  Pass 2 (STATS)
// writes r to b[j] for j < k and the mean of the k rows to theta.
template <bool STATS, int THREADS, int NC, int KC, int U, int V>
__device__ __forceinline__ void step_sums(const float (&x)[U][NC][V],
                                          const float* ms,
                                          float (&acc)[NC][KC],
                                          float* __restrict__ b,
                                          float* __restrict__ theta,
                                          long long g0, long long groups,
                                          int k, long long d) {
  constexpr int NC4 = (NC + 3) / 4 * 4;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long g = g0 + u * THREADS;
    if (g >= groups) continue;
    float colsum[V];
#pragma unroll
    for (int v = 0; v < V; ++v) colsum[v] = 0.f;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      float r[V];
      mix_row(x[u], ms + j * NC4, r);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float diff = x[u][i][v] - r[v];
          acc[i][j] = fmaf(diff, diff, acc[i][j]);
        }
      }
      if (STATS && j < k) {
        store_cols(b + static_cast<long long>(j) * d + g * V, r);
#pragma unroll
        for (int v = 0; v < V; ++v) colsum[v] += r[v];
      }
    }
    if (STATS) {
#pragma unroll
      for (int v = 0; v < V; ++v) colsum[v] /= static_cast<float>(k);
      store_cols(theta + g * V, colsum);
    }
  }
}

// STATS = false: pass 1.  STATS = true: pass 2, which also writes b and theta.
// V: columns a load takes (d % V == 0, every row start aligned to V
// elements).  partials (gridDim.x, TIER::n * TIER::k) scratch; ticket a
// zeroed counter.
template <typename T, bool STATS, class TIER, int V>
__global__ void __launch_bounds__(TIER::threads, 1)
    reg_sq_dists(const T* __restrict__ w, const float* __restrict__ mix,
                 float* __restrict__ b, float* __restrict__ theta,
                 float* __restrict__ partials, unsigned* __restrict__ ticket,
                 float* __restrict__ out, int n_in, long long d, int k_in) {
  constexpr int NC = TIER::n;
  constexpr int KC = TIER::k;
  constexpr int NC4 = (NC + 3) / 4 * 4;  // mix rows padded for float4 reads
  constexpr int U = TIER::groups(V);
  constexpr int kT = TIER::threads;
  const int n = TIER::exact ? NC : n_in;
  const int k = TIER::exact ? KC : k_in;
  __shared__ __align__(16) float ms[KC * NC4];   // mix, zero-padded
  __shared__ float red[TIER::warps * NC * KC];
  stage_mix<kT, NC, KC>(ms, mix, n, k);

  float acc[NC][KC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[i][j] = 0.f;
  }
  const long long groups = d / V;
  struct Step {
    float x[U][NC][V];
  };
  sweep<TIER, V, Step>(
      groups,
      [&](Step& s, long long g0) {
        load_step<kT>(s.x, w, g0, groups, n, d);
      },
      [&](const Step& s, long long g0) {
        step_sums<STATS, kT>(s.x, ms, acc, b, theta, g0, groups, k, d);
      });
  grid_tail<kT>(acc, red, partials, ticket, out, n, k);
}

// ---------------------------------------------------------------- tile route

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

// Every CTA takes a strided set of kTile-column tiles: it stages the (N, kTile)
// tile in shared memory as f32 (zero past the ragged edge of D), builds the K
// rows mix @ tile there (pass 2 writes b and theta from them), and sums
// (w - row)^2 per (pair, lane) item; when N*K < kThreads several lanes of
// threads split the tile's columns.  Each CTA writes one (N*K,) partial.
// partials is (N*K, gridDim.x): column blockIdx.x holds this CTA's sums.
// (The minimum of one CTA a SM lets ptxas take the ~64 registers it needs:
// with the thread count alone it chose 32 for the bf16 pass 2 and spilled.)
template <typename T, bool STATS>
__global__ void __launch_bounds__(kThreads, 1)
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

// ---------------------------------------------------------------- dispatch

// Everything a pass's launch needs.  mix is the (K, N) center one-hot (pass 1)
// or aggregation matrix (pass 2); b and theta are null in pass 1; ticket is
// used by the register route only.
struct Pass {
  const void* w;
  const float* mix;
  float* b;
  float* theta;
  float* partials;
  unsigned* ticket;
  float* out;
  int n;
  long long d;
  int k;
  int grid;
  int device;
  cudaStream_t stream;
};

enum class Op { kLaunch, kGrid, kAttributes };

bool shape_ok(int n, long long d, int k) {
  return n >= 1 && n <= kMaxN && k >= 1 && k <= n && n * k <= kMaxPairs &&
         d >= 1;
}

template <typename T, bool STATS, class TIER, int V>
cudaError_t reg_op(Op op, const Pass& p, int* grid, cudaFuncAttributes* attr) {
  const auto kernel = reg_sq_dists<T, STATS, TIER, V>;
  switch (op) {
    case Op::kAttributes:
      return cudaFuncGetAttributes(attr, kernel);
    case Op::kGrid:
      return sweep_grid<TIER, V>(kernel, p.device, p.d, grid);
    case Op::kLaunch:
      if (!tier_fits<TIER>(p.n, p.k) ||
          !cols_aligned(V, sizeof(T), p.w, p.d) || p.ticket == nullptr ||
          p.grid > TIER::threads) {
        return cudaErrorInvalidValue;
      }
      kernel<<<p.grid, TIER::threads, 0, p.stream>>>(
          static_cast<const T*>(p.w), p.mix, p.b, p.theta, p.partials,
          p.ticket, p.out, p.n, p.d, p.k);
      return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool STATS>
cudaError_t tile_op(Op op, const Pass& p, int* grid, cudaFuncAttributes* attr) {
  const auto kernel = tile_sq_dists<T, STATS>;
  if (op == Op::kAttributes) return cudaFuncGetAttributes(attr, kernel);
  const size_t smem = smem_bytes(p.n, p.k);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (op == Op::kGrid) {
    return fill_grid(kernel, kThreads, smem, p.device,
                     (p.d + kTile - 1) / kTile, grid);
  }
  kernel<<<p.grid, kThreads, smem, p.stream>>>(
      static_cast<const T*>(p.w), p.mix, p.b, p.theta, p.partials, p.n, p.d,
      p.k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<p.n * p.k, kThreads, 0, p.stream>>>(p.partials, p.out,
                                                        p.grid);
  return cudaGetLastError();
}

template <typename T, bool STATS>
cudaError_t by_route(int route, Op op, const Pass& p, int* grid,
                     cudaFuncAttributes* attr) {
  switch (route) {
    case kRouteTile: return tile_op<T, STATS>(op, p, grid, attr);
    case kRouteRegs1: return reg_op<T, STATS, RegsTier, 1>(op, p, grid, attr);
    case kRouteRegs2: return reg_op<T, STATS, RegsTier, 2>(op, p, grid, attr);
    case kRouteExact1:
      return reg_op<T, STATS, ExactTier, 1>(op, p, grid, attr);
    case kRouteExact2:
      return reg_op<T, STATS, ExactTier, 2>(op, p, grid, attr);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(int stats, int bf16, int route, Op op, const Pass& p,
                int* grid = nullptr, cudaFuncAttributes* attr = nullptr) {
  cudaError_t err = cudaSetDevice(p.device);
  if (err != cudaSuccess) return err;
  if (bf16) {
    return stats ? by_route<__nv_bfloat16, true>(route, op, p, grid, attr)
                 : by_route<__nv_bfloat16, false>(route, op, p, grid, attr);
  }
  return stats ? by_route<float, true>(route, op, p, grid, attr)
               : by_route<float, false>(route, op, p, grid, attr);
}

}  // namespace

extern "C" {

// The largest N and N*K the kernels take, the register tier's N and K caps,
// and the (N, K) of the exact tier.
void fr_limits(int* max_n, int* max_pairs, int* reg_n, int* reg_k,
               int* exact_n, int* exact_k) {
  *max_n = kMaxN;
  *max_pairs = kMaxPairs;
  *reg_n = kRegN;
  *reg_k = kRegK;
  *exact_n = kExactN;
  *exact_k = kExactK;
}

// Number of CTAs a pass launches for this shape and route, and the floats of
// scratch (`partials`) the launch needs: a row of N*K sums a CTA on the tile
// route, of the tier's NC*KC on a register route.  stats = 0 for pass 1, 1
// for pass 2; bf16 = 1 when W is bfloat16; route one of kRoute*.
int fr_grid(int stats, int bf16, int route, int n, long long d, int k,
            int device, int* grid, long long* scratch) {
  if (!shape_ok(n, d, k)) return cudaErrorInvalidValue;
  Pass p{};
  p.n = n;
  p.d = d;
  p.k = k;
  p.device = device;
  const cudaError_t err = run(stats, bf16, route, Op::kGrid, p, grid);
  if (err != cudaSuccess) return err;
  const bool exact = route == kRouteExact1 || route == kRouteExact2;
  const int pairs = route == kRouteTile ? n * k
                    : exact             ? kExactN * kExactK
                                        : kRegN * kRegK;
  *scratch = static_cast<long long>(*grid) * pairs;
  return cudaSuccess;
}

// The compiled kernel of (pass, dtype, route): registers a thread and local
// memory a thread (bytes: spills).
int fr_kernel_attributes(int stats, int bf16, int route, int device,
                         int* regs, int* local_bytes) {
  Pass p{};
  p.device = device;
  cudaFuncAttributes attr{};
  const cudaError_t err = run(stats, bf16, route, Op::kAttributes, p, nullptr,
                              &attr);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// Pass 1.  w (n, d) row-major f32 or bf16; conehot (k, n) f32; partials
// f32 scratch of the length fr_grid gives; ticket one zeroed 32-bit counter
// (register routes); out (n, k) f32.
int fr_center_sq_dists(const void* w, int bf16, int route,
                       const float* conehot, float* partials, void* ticket,
                       float* out, int n, long long d, int k, int grid,
                       int device, void* stream) {
  if (!shape_ok(n, d, k) || grid < 1) return cudaErrorInvalidValue;
  const Pass p{w, conehot, nullptr, nullptr, partials,
               static_cast<unsigned*>(ticket), out, n, d, k, grid, device,
               static_cast<cudaStream_t>(stream)};
  return run(0, bf16, route, Op::kLaunch, p);
}

// Pass 2.  w (n, d) row-major f32 or bf16; m (k, n) f32; b (k, d) f32;
// theta (d,) f32; partials, ticket as in pass 1; med_d2 (n, k) f32.
int fr_fused_coalition_stats(const void* w, int bf16, int route,
                             const float* m, float* b, float* theta,
                             float* partials, void* ticket, float* med_d2,
                             int n, long long d, int k, int grid, int device,
                             void* stream) {
  if (!shape_ok(n, d, k) || grid < 1) return cudaErrorInvalidValue;
  const Pass p{w, m, b, theta, partials, static_cast<unsigned*>(ticket),
               med_d2, n, d, k, grid, device,
               static_cast<cudaStream_t>(stream)};
  return run(1, bf16, route, Op::kLaunch, p);
}

}  // extern "C"
