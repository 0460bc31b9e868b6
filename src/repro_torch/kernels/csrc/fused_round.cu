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
// each element once.
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

#include <cstdint>

#include "common.cuh"

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

// A register tier: N and K caps; whether N and K equal the caps (no row or
// pair is padding); the columns a thread takes a step (at least one vector
// of V); whether the next step's loads are issued before this step's
// arithmetic (two steps of W in registers); and the threads of a CTA, one
// CTA a SM, which set the registers a thread may take (65,536 / threads:
// 128 at 512, 168 at 384) without spilling.
template <int N_, int K_, bool EXACT_, int COLS_, bool PIPE_, int THREADS_>
struct Tier {
  static constexpr int n = N_;
  static constexpr int k = K_;
  static constexpr bool exact = EXACT_;
  static constexpr bool pipe = PIPE_;
  static constexpr int threads = THREADS_;
  static constexpr int warps = THREADS_ / 32;
  // column groups of v columns a thread takes a step
  __host__ __device__ static constexpr int groups(int v) {
    return COLS_ > v ? COLS_ / v : 1;
  }
};
using RegsTier = Tier<kRegN, kRegK, false, 1, false, 384>;
using ExactTier = Tier<kExactN, kExactK, true, 2, true, 512>;

// ------------------------------------------------------------ register route

// V adjacent columns of one row of W at p, as f32.  Streaming loads: W is
// read once.  bf16 -> f32 is exact: a bf16 value is the top half of an f32.
__device__ __forceinline__ void load_cols(const float* p, float (&x)[1]) {
  x[0] = __ldcs(p);
}
__device__ __forceinline__ void load_cols(const float* p, float (&x)[2]) {
  const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
  x[0] = v.x;
  x[1] = v.y;
}
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&x)[1]) {
  x[0] = bf16_lo(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&x)[2]) {
  const unsigned u = __ldcs(reinterpret_cast<const unsigned*>(p));
  x[0] = bf16_lo(u);
  x[1] = bf16_hi(u);
}

__device__ __forceinline__ void store_cols(float* p, const float (&x)[1]) {
  p[0] = x[0];
}
__device__ __forceinline__ void store_cols(float* p, const float (&x)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

// Sums acc over the CTA's threads in a fixed order (a __shfl_xor tree in each
// warp, then the warps in index order).  FINAL: writes the sum of pair (i, j),
// clamped at 0, to dst[i * k + j] for i < n, j < k.  Else writes every pair
// below the caps to dst[i * KC + j] (a row of partials: compile-time offsets,
// so the last CTA reads a row from one pointer).  red holds THREADS / 32 * NC
// * KC floats.  No branch stands between acc and a register.  Ends with
// every thread at a barrier.
template <bool FINAL, int THREADS, int NC, int KC>
__device__ __forceinline__ void cta_sum(const float (&acc)[NC][KC],
                                        float* red, float* dst, int n, int k) {
  constexpr int kPairs = NC * KC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      float v = acc[i][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == 0) red[warp * kPairs + i * KC + j] = v;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kPairs; q += THREADS) {
    const int i = q / KC;
    const int j = q % KC;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < THREADS / 32; ++wp) s += red[wp * kPairs + q];
    if (!FINAL) {
      dst[q] = s;
    } else if (i < n && j < k) {
      dst[i * k + j] = fmaxf(s, 0.f);
    }
  }
  __syncthreads();
}

// One step of a thread: U groups of V columns, THREADS groups apart from
// group g0, of all NC rows, as f32.  In a tier that is not exact, rows past n
// read row n - 1 again (the mix is zero there, so they add nothing to any row
// r, and their sums are dropped at the end).  Groups past the end are zeros.
template <int THREADS, typename T, int NC, int U, int V>
__device__ __forceinline__ void load_step(float (&x)[U][NC][V],
                                          const T* __restrict__ w,
                                          long long g0, long long groups,
                                          int n, long long d) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long g = g0 + u * THREADS;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const long long row = i < n ? i : n - 1;
      if (g < groups) {
        load_cols(w + row * d + g * V, x[u][i]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) x[u][i][v] = 0.f;
      }
    }
  }
}

// The arithmetic of one step: each of the KC rows r = sum_i mix[j, i] w[i]
// in registers (mix from shared memory, 4 values a broadcast), then
// (w[i] - r)^2 into acc[i][j].  Pass 2 (STATS) writes r to b[j] for j < k and
// the mean of the k rows to theta.
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
#pragma unroll
      for (int v = 0; v < V; ++v) r[v] = 0.f;
#pragma unroll
      for (int i = 0; i < NC4; i += 4) {
        const float4 m4 = *reinterpret_cast<const float4*>(&ms[j * NC4 + i]);
        const float m[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int t = 0; t < 4 && i + t < NC; ++t) {
#pragma unroll
          for (int v = 0; v < V; ++v) r[v] = fmaf(m[t], x[u][i + t][v], r[v]);
        }
      }
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
  __shared__ bool last;

  const int tid = threadIdx.x;
  for (int q = tid; q < KC * NC4; q += kT) {
    const int j = q / NC4;
    const int i = q % NC4;
    ms[q] = j < k && i < n ? mix[j * n + i] : 0.f;
  }
  __syncthreads();

  float acc[NC][KC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[i][j] = 0.f;
  }

  // every CTA sweeps D together: a step of the grid covers gridDim.x * U * kT
  // adjacent groups of V columns, U * kT of them a CTA
  const long long groups = d / V;
  const long long stride = static_cast<long long>(gridDim.x) * U * kT;
  long long g0 = static_cast<long long>(blockIdx.x) * U * kT + tid;
  float x[U][NC][V];
  if (TIER::pipe) load_step<kT>(x, w, g0, groups, n, d);
  for (; g0 < groups; g0 += stride) {
    if (TIER::pipe) {
      float next[U][NC][V];
      load_step<kT>(next, w, g0 + stride, groups, n, d);
      step_sums<STATS, kT>(x, ms, acc, b, theta, g0, groups, k, d);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
#pragma unroll
          for (int v = 0; v < V; ++v) x[u][i][v] = next[u][i][v];
        }
      }
    } else {
      load_step<kT>(x, w, g0, groups, n, d);
      step_sums<STATS, kT>(x, ms, acc, b, theta, g0, groups, k, d);
    }
  }

  // this CTA's row of partials, then the ticket (the pattern of a grid-wide
  // barrier: the CTA's barrier, then one thread's fence and atomic)
  constexpr int kPairs = NC * KC;
  cta_sum<false, kT>(acc, red,
                     partials + static_cast<long long>(kPairs) * blockIdx.x, n,
                     k);
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[i][j] = 0.f;
  }
  // one row of partials a thread (the wrapper keeps gridDim.x <= kT): all
  // loads in one round
  for (int c = tid; c < static_cast<int>(gridDim.x); c += kT) {
    const float* row = partials + static_cast<long long>(kPairs) * c;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[i][j] += __ldcg(row + i * KC + j);
    }
  }
  cta_sum<true, kT>(acc, red, out, n, k);
  if (tid == 0) *ticket = 0u;  // ready for the next launch on this stream
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

// Whether a register tier with vector width v takes this W.
template <class TIER>
bool reg_ok(int v, size_t elem, const void* w, int n, long long d, int k) {
  const bool fits = TIER::exact ? n == TIER::n && k == TIER::k
                                : n <= TIER::n && k <= TIER::k;
  return fits && d % v == 0 &&
         reinterpret_cast<uintptr_t>(w) % (v * elem) == 0;
}

template <typename T, bool STATS, class TIER, int V>
cudaError_t reg_op(Op op, const Pass& p, int* grid, cudaFuncAttributes* attr) {
  const auto kernel = reg_sq_dists<T, STATS, TIER, V>;
  constexpr long long kStep =
      static_cast<long long>(TIER::groups(V)) * V * TIER::threads;
  switch (op) {
    case Op::kAttributes:
      return cudaFuncGetAttributes(attr, kernel);
    case Op::kGrid: {
      // at most one row of partials a thread of the last CTA
      const long long work = (p.d + kStep - 1) / kStep;
      return fill_grid(kernel, TIER::threads, 0, p.device,
                       work < TIER::threads ? work : TIER::threads, grid);
    }
    case Op::kLaunch:
      if (!reg_ok<TIER>(V, sizeof(T), p.w, p.n, p.d, p.k) ||
          p.ticket == nullptr || p.grid > TIER::threads) {
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
