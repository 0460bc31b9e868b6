// Distance kernels of the coalition engine: CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pairwise_dist.py:
//   sq_dists_to_points  out[i, j] = max(sum_d (w[i, d] - p[j, d])^2, 0)  (N, K)
//   pairwise_sq_dists   out[i, j] = max(sum_d (w[i, d] - w[j, d])^2, 0)  (N, N),
//                       symmetric, with the diagonal exactly 0.
// W and P may each be float32 or bfloat16; both are cast to f32 on load and
// every sum is taken in f32.
//
// Bound.  Each element of W costs about 3K (or 3(N-1)/2) floating-point
// operations per 4 bytes read, far below the fp32 ridge: both kernels are
// bound by device-memory bytes, N*D*sizeof(W) (+ K*D*sizeof(P)) read once
// (pairwise at N = 10: 23.3 MB, 6.95 us at 3.35 TB/s, at D = 582,026 f32;
// 320 MB, 95.5 us, at D = 8M).  At the sketch widths (D = S = 64..2048) the
// whole input is a few KB (13 KB at N = 10, K = 3, S = 256 f32: 0.004 us at
// 3.35 TB/s) and a call is bound by its launch.
//
// Design, full width, sq_dists_to_points on a register tier (reg_dists,
// N <= kRegN, K <= kRegK; D > kSmallD).  The register sweep of
// fused_round.cu's pass 1 (reg_sweep.cuh), with the K rows read from P
// instead of built from a mix: one CTA a SM, all CTAs sweeping D together;
// each thread takes V adjacent columns of all N rows of W and all K rows of P
// a step, straight from device memory into registers with streaming loads,
// and sums (w_i - p_j)^2 in N*K f32 registers (the diff form: no Gram
// cancellation).  One launch: each CTA writes a row of partials padded to
// the tier's caps, and the last CTA (integer ticket) sums the rows in a fixed
// tree, clamps at 0 and writes out.  No float atomics; the grid depends only
// on the shape and the card, so repeats are bit-identical.  Tiers: ExactTier
// compiled for (N, K) = (kExactN, kExactK), the composed round's shape at the
// CLI's defaults, with the next step's loads issued before this step's
// arithmetic (13 rows x 2 columns in flight a step, 30 sums: ~100 registers
// at 512 threads); RegsTier for every other N <= kRegN, K <= kRegK, with no
// predicate in the sweep (rows past N or K read the last row again, and their
// sums are dropped), 384 threads.  V = 2 where D is even and both bases are
// 2-element aligned, else 1 (rows of D = 582,026 f32 are 8-byte aligned).
// W and P each template on their dtype: 4 mixes.
//
// Design, full width, pairwise_sq_dists on the register tier (reg_pairwise,
// N <= kPairRegN, D > kSmallD).  reg_dists with P = W and only the pairs
// a < b: each thread takes V adjacent columns of all N rows a step
// (streaming loads, every element of W read once) and sums (w_a - w_b)^2 in
// N(N-1)/2 f32 registers (45 at N = 10; the diff form, not the Gram form of
// the Pallas body, which loses ~1e-7 of |w|^2 to cancellation).  Pair
// q = b (b - 1) / 2 + a, so the pairs of the first N rows come first: a
// tier compiled for the cap runs a smaller N with no arithmetic for the
// rows past it (one branch on b < N a row, the same in every thread), and
// its tail sums and writes only the N(N-1)/2 pairs of N.  The sums sit in
// rows of kPairRegN / 2 pairs, and the tail branches once a row: a branch a
// pair serialised the pairs' shuffle trees and cost ~5 us at N = 10.  One
// launch: each CTA writes a row of partials, the last CTA (integer ticket)
// sums the rows in a fixed order, clamps at 0 and writes both halves of the
// matrix from one value (symmetric bit for bit); CTA 0 writes the zero
// diagonal.  No float atomics; the grid depends only on the shape and the
// card, so repeats are bit-identical.  V = 4 where D % 4 == 0 and the base
// is 4-element aligned (16 bytes in f32, as at D = 8M), else 2 where D is
// even and the base 2-element aligned (D = 582,026), else 1.  One tier, PairTier, for every
// N <= kPairRegN, 384 threads (168 registers a thread).  The cap is the
// largest N at which ptxas spills at no V in f32 or bf16
// (scripts/pairwise_cap_probe.py on the H100, CUDA 12.9): N = 13 takes 168
// registers at every V with no local memory; N = 14 spills 8 bytes at V = 4
// in f32, N = 16 40 and 192 bytes at V = 2 and 4 (f32); N = 12 takes
// 148-160.  512 threads (128 a thread) spill at N = 12 (V = 4, f32).  256
// threads (255 a thread) hold N = 16 at 255 registers, but keep fewer loads
// in flight: N = 10 at D = 582,026 takes 25.3 us there (24.9 clean)
// against 24.3 (22.7) at 384.  A tier compiled for exactly N = 10 was
// 5.5-7.2% faster at D = 582,026 (22.9 against 24.3 us; 23.5 against 25.2
// in another call) and 1.7-1.8% at D = 8M; it is not kept, since no round
// path launches this kernel.
//
// Why the first full-width design (tile_dists) reached 22-23% of the bound:
// each CTA staged a 256-column tile of all N (+ K) rows in shared memory and
// read it back once per (pair, column), with two barriers a tile and a
// second launch for the partials (the faults fused_round.cu's source note
// gives for its own first design).
//
// Design, tile_dists: pairwise_sq_dists above the pairwise cap
// (kPairRegN < N <= kMaxPairwiseN) and at D <= kSmallD, and
// sq_dists_to_points above the register tiers' caps (N > kRegN or
// K > kRegK, D > kSmallD).
// Every CTA takes a strided set of kTile-column tiles:
//   1. stage the tile of W (and of P) in shared memory as f32, zero past the
//      ragged edge of D (zero columns add nothing to any sum);
//   2. accumulate sum (x - y)^2 per (row pair, lane) item in registers, in the
//      diff form; when there are fewer pairs than threads, several lanes of
//      threads split the tile's columns.  pairwise_sq_dists takes only the
//      N(N-1)/2 pairs i < j.
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
// Routes of sq_dists_to_points (the wrapper's route(); the entry points
// refuse a route the shape does not fit): warp_dists at D <= kSmallD;
// reg_dists<ExactTier> at (kExactN, kExactK), reg_dists<RegsTier> at other
// N <= kRegN, K <= kRegK, each with V = 2 or 1; tile_dists above the caps.
// Routes of pairwise_sq_dists (the wrapper's pairwise_route(); the entry
// points refuse a route the shape or the base does not fit):
// reg_pairwise<PairTier> at N <= kPairRegN, D > kSmallD, with V = 4, 2 or
// 1; tile_dists above the cap and at D <= kSmallD.
//
// Limits (the entry points return cudaErrorInvalidValue beyond them):
//   sq_dists_to_points  1 <= N <= kMaxN, 1 <= K <= kMaxK, N*K <= kMaxPairs;
//   pairwise_sq_dists   1 <= N <= kMaxPairwiseN (N(N-1)/2 <= kMaxPairs);
//   D >= 1.

#include "reg_sweep.cuh"

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

constexpr int kRegN = 16;                 // N and K caps of the register route
constexpr int kRegK = 4;
constexpr int kExactN = 10;               // the shape with a kernel of its own
constexpr int kExactK = 3;
constexpr int kPairRegN = 13;             // N cap of the pairwise register route
constexpr int kPairThreads = 384;         // threads of its CTA

// Routes of sq_dists_to_points (the entry points' `route`): the tile kernel,
// a register tier loading 1 or 2 columns of a row at a time, or the warp
// kernel of the sketch widths.
constexpr int kRouteTile = 0;
constexpr int kRouteRegs1 = 1;
constexpr int kRouteRegs2 = 2;
constexpr int kRouteExact1 = 3;
constexpr int kRouteExact2 = 4;
constexpr int kRouteWarp = 5;
// Routes of pairwise_sq_dists: the tile kernel (kRouteTile), or the register
// tier loading 1, 2 or 4 columns of a row at a time.
constexpr int kRoutePregs1 = 6;
constexpr int kRoutePregs2 = 7;
constexpr int kRoutePregs4 = 8;

using RegsTier = Tier<kRegN, kRegK, false, 1, false, 384>;
using ExactTier = Tier<kExactN, kExactK, true, 2, true, 512>;
using PairTier = Tier<kPairRegN, 1, false, 1, false, kPairThreads>;

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

// sq_dists_to_points at full width on a register tier: each thread sums
// (w[i] - p[j])^2 over its columns for every (i, j) below the caps in
// registers; grid_tail sums the CTAs' rows.  V: columns a load takes
// (d % V == 0, both bases V-element aligned).  partials (gridDim.x,
// TIER::n * TIER::k) scratch; ticket a zeroed counter; out (n, k).
template <typename TW, typename TP, class TIER, int V>
__global__ void __launch_bounds__(TIER::threads, 1)
    reg_dists(const TW* __restrict__ w, const TP* __restrict__ p,
              float* __restrict__ partials, unsigned* __restrict__ ticket,
              float* __restrict__ out, int n_in, long long d, int k_in) {
  constexpr int NC = TIER::n;
  constexpr int KC = TIER::k;
  constexpr int U = TIER::groups(V);
  constexpr int kT = TIER::threads;
  const int n = TIER::exact ? NC : n_in;
  const int k = TIER::exact ? KC : k_in;
  __shared__ float red[TIER::warps * NC * KC];

  float acc[NC][KC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[i][j] = 0.f;
  }
  const long long groups = d / V;
  struct Step {
    float x[U][NC][V];
    float y[U][KC][V];
  };
  // groups past the end load zeros in both operands: they add nothing
  sweep<TIER, V, Step>(
      groups,
      [&](Step& s, long long g0) {
        load_step<kT>(s.x, w, g0, groups, n, d);
        load_step<kT>(s.y, p, g0, groups, k, d);
      },
      [&](const Step& s, long long) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int i = 0; i < NC; ++i) {
#pragma unroll
            for (int j = 0; j < KC; ++j) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                const float diff = s.x[u][i][v] - s.y[u][j][v];
                acc[i][j] = fmaf(diff, diff, acc[i][j]);
              }
            }
          }
        }
      });
  grid_tail<kT>(acc, red, partials, ticket, out, n, k);
}

// pairwise_sq_dists at full width on a register tier: each thread sums
// (w[a] - w[b])^2 over its columns for every pair a < b below the cap in
// registers, pair q = b (b - 1) / 2 + a at acc[q / G][q % G] (rows of G
// pairs), so that the n (n - 1) / 2 pairs of the first n rows come first:
// the arithmetic of the pairs past them is skipped (a branch on b < n, the
// same in every thread), and grid_tail sums and writes only the rows that
// hold them.  The last CTA writes each pair's sum, clamped at 0, to both
// halves of out; CTA 0 writes the zero diagonal.  V: columns a load takes (d % V == 0,
// the base V-element aligned).  partials (gridDim.x, the tier's pairs)
// scratch; ticket a zeroed counter; out (n, n).
template <typename T, class TIER, int V>
__global__ void __launch_bounds__(TIER::threads, 1)
    reg_pairwise(const T* __restrict__ w, float* __restrict__ partials,
                 unsigned* __restrict__ ticket, float* __restrict__ out,
                 int n_in, long long d) {
  constexpr int NC = TIER::n;
  constexpr int NP = NC * (NC - 1) / 2;
  constexpr int G = NC / 2;                  // pairs a row of acc
  constexpr int R = NP / G;                  // NC - 1 or NC rows
  static_assert(NC >= 2 && R * G == NP, "rows of G pairs hold every pair");
  constexpr int U = TIER::groups(V);
  constexpr int kT = TIER::threads;
  const int n = TIER::exact ? NC : n_in;
  __shared__ float red[TIER::warps * NP];
  if (blockIdx.x == 0 && threadIdx.x < n) out[threadIdx.x * (n + 1)] = 0.f;

  float acc[R][G];
#pragma unroll
  for (int q = 0; q < NP; ++q) acc[q / G][q % G] = 0.f;
  const long long groups = d / V;
  struct Step {
    float x[U][NC][V];
  };
  // groups past the end load zeros: they add nothing
  sweep<TIER, V, Step>(
      groups,
      [&](Step& s, long long g0) {
        load_step<kT>(s.x, w, g0, groups, n, d);
      },
      [&](const Step& s, long long) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int b = 1; b < NC; ++b) {
            if (TIER::exact || b < n) {
#pragma unroll
              for (int a = 0; a < b; ++a) {
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  const float diff = s.x[u][a][v] - s.x[u][b][v];
                  float& r = acc[(b * (b - 1) / 2 + a) / G]
                                [(b * (b - 1) / 2 + a) % G];
                  r = fmaf(diff, diff, r);
                }
              }
            }
          }
        }
      });
  grid_tail<kT>(acc, red, partials, ticket, n * (n - 1) / 2,
                [&](int q, float sum) {
                  int b = 1;
                  while (q >= b * (b + 1) / 2) ++b;
                  const int a = q - b * (b - 1) / 2;
                  const float v = fmaxf(sum, 0.f);
                  out[a * n + b] = v;
                  out[b * n + a] = v;
                });
}

// ---------------------------------------------------------------- dispatch

// Everything a sq_dists_to_points launch needs; ticket is used by the
// register routes only, partials by the register and tile routes.
struct Dists {
  const void* w;
  const void* p;
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

bool shape_ok(bool pairwise, int n, long long d, int k) {
  if (d < 1 || n < 1) return false;
  if (pairwise) return n <= kMaxPairwiseN;
  return n <= kMaxN && k >= 1 && k <= kMaxK && n * k <= kMaxPairs;
}

template <typename TW, typename TP, class TIER, int V>
cudaError_t reg_op(Op op, const Dists& a, int* grid,
                   cudaFuncAttributes* attr) {
  const auto kernel = reg_dists<TW, TP, TIER, V>;
  switch (op) {
    case Op::kAttributes:
      return cudaFuncGetAttributes(attr, kernel);
    case Op::kGrid:
      return sweep_grid<TIER, V>(kernel, a.device, a.d, grid);
    case Op::kLaunch:
      if (!tier_fits<TIER>(a.n, a.k) ||
          !cols_aligned(V, sizeof(TW), a.w, a.d) ||
          !cols_aligned(V, sizeof(TP), a.p, a.d) || a.ticket == nullptr ||
          a.grid > TIER::threads) {
        return cudaErrorInvalidValue;
      }
      kernel<<<a.grid, TIER::threads, 0, a.stream>>>(
          static_cast<const TW*>(a.w), static_cast<const TP*>(a.p),
          a.partials, a.ticket, a.out, a.n, a.d, a.k);
      return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <typename TW, typename TP>
cudaError_t warp_op(Op op, const Dists& a, int* grid,
                    cudaFuncAttributes* attr) {
  const auto kernel = warp_dists<TW, TP>;
  switch (op) {
    case Op::kAttributes:
      return cudaFuncGetAttributes(attr, kernel);
    case Op::kGrid:
      *grid = 1;  // the launch sizes itself; no partials
      return cudaSuccess;
    case Op::kLaunch: {
      if (a.d > kSmallD) return cudaErrorInvalidValue;
      const int vec = a.d % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(a.w) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.p) % 16 == 0;
      const int ctas = (a.n * a.k + kSmallWarps - 1) / kSmallWarps;
      kernel<<<ctas, kSmallWarps * 32, 0, a.stream>>>(
          static_cast<const TW*>(a.w), static_cast<const TP*>(a.p), a.out,
          a.n, static_cast<int>(a.d), a.k, vec);
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

template <typename TW, typename TP, bool PAIRWISE>
cudaError_t prepare(int n, int k, size_t* smem) {
  *smem = smem_bytes(PAIRWISE, n, k);
  return cudaFuncSetAttribute(tile_dists<TW, TP, PAIRWISE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename TW, typename TP, bool PAIRWISE>
cudaError_t tile_grid(int n, long long d, int k, int device, int* grid) {
  if (d <= kSmallD || num_pairs(PAIRWISE, n, k) == 0) {
    *grid = 1;
    return cudaSuccess;
  }
  size_t smem = 0;
  cudaError_t err = prepare<TW, TP, PAIRWISE>(n, k, &smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = (d + kTile - 1) / kTile;
  return fill_grid(tile_dists<TW, TP, PAIRWISE>, kThreads, smem, device,
                   ntiles, grid);
}

template <typename TW, typename TP, bool PAIRWISE>
cudaError_t tile_launch(const void* w, const void* p, float* partials,
                        float* out, int n, long long d, int k, int grid,
                        cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare<TW, TP, PAIRWISE>(n, k, &smem);
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

template <typename TW, typename TP, bool PAIRWISE>
cudaError_t tile_op(Op op, const Dists& a, int* grid,
                    cudaFuncAttributes* attr) {
  switch (op) {
    case Op::kAttributes:
      return cudaFuncGetAttributes(attr, tile_dists<TW, TP, PAIRWISE>);
    case Op::kGrid:
      return tile_grid<TW, TP, PAIRWISE>(a.n, a.d, a.k, a.device, grid);
    case Op::kLaunch:
      return tile_launch<TW, TP, PAIRWISE>(a.w, a.p, a.partials, a.out, a.n,
                                           a.d, a.k, a.grid, a.stream);
  }
  return cudaErrorInvalidValue;
}

// pairwise_sq_dists on the register tier, loading V columns a time.
template <typename T, int V>
cudaError_t pair_op(Op op, const Dists& a, int* grid,
                    cudaFuncAttributes* attr) {
  const auto kernel = reg_pairwise<T, PairTier, V>;
  switch (op) {
    case Op::kAttributes:
      return cudaFuncGetAttributes(attr, kernel);
    case Op::kGrid:
      return sweep_grid<PairTier, V>(kernel, a.device, a.d, grid);
    case Op::kLaunch:
      if (!tier_fits<PairTier>(a.n, 1) ||
          !cols_aligned(V, sizeof(T), a.w, a.d) || a.ticket == nullptr ||
          a.grid > PairTier::threads) {
        return cudaErrorInvalidValue;
      }
      kernel<<<a.grid, PairTier::threads, 0, a.stream>>>(
          static_cast<const T*>(a.w), a.partials, a.ticket, a.out, a.n, a.d);
      return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

bool pair_route(int route) {
  return route == kRoutePregs1 || route == kRoutePregs2 ||
         route == kRoutePregs4;
}

template <typename T>
cudaError_t pair_by_route(int route, Op op, const Dists& a, int* grid,
                          cudaFuncAttributes* attr) {
  switch (route) {
    case kRouteTile: return tile_op<T, T, true>(op, a, grid, attr);
    case kRoutePregs1: return pair_op<T, 1>(op, a, grid, attr);
    case kRoutePregs2: return pair_op<T, 2>(op, a, grid, attr);
    case kRoutePregs4: return pair_op<T, 4>(op, a, grid, attr);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TW, typename TP>
cudaError_t by_route(int route, Op op, const Dists& a, int* grid,
                     cudaFuncAttributes* attr) {
  switch (route) {
    case kRouteTile: return tile_op<TW, TP, false>(op, a, grid, attr);
    case kRouteRegs1: return reg_op<TW, TP, RegsTier, 1>(op, a, grid, attr);
    case kRouteRegs2: return reg_op<TW, TP, RegsTier, 2>(op, a, grid, attr);
    case kRouteExact1: return reg_op<TW, TP, ExactTier, 1>(op, a, grid, attr);
    case kRouteExact2: return reg_op<TW, TP, ExactTier, 2>(op, a, grid, attr);
    case kRouteWarp: return warp_op<TW, TP>(op, a, grid, attr);
    default: return cudaErrorInvalidValue;
  }
}

using bf16 = __nv_bfloat16;

// pairwise = 1 for pairwise_sq_dists (P is W; p_bf16 ignored).
cudaError_t run(int pairwise, int w_bf16, int p_bf16, int route, Op op,
                const Dists& a, int* grid = nullptr,
                cudaFuncAttributes* attr = nullptr) {
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return err;
  if (pairwise) {
    return w_bf16 ? pair_by_route<bf16>(route, op, a, grid, attr)
                  : pair_by_route<float>(route, op, a, grid, attr);
  }
  if (w_bf16) {
    return p_bf16 ? by_route<bf16, bf16>(route, op, a, grid, attr)
                  : by_route<bf16, float>(route, op, a, grid, attr);
  }
  return p_bf16 ? by_route<float, bf16>(route, op, a, grid, attr)
                : by_route<float, float>(route, op, a, grid, attr);
}

}  // namespace

extern "C" {

// The shape limits (sq_dists_to_points takes N <= max_n, K <= max_k,
// N*K <= max_pairs; pairwise_sq_dists takes N <= max_pairwise_n), the
// largest D of the warp route, the register tiers' N and K caps, the
// (N, K) of the exact tier, and the N cap of the pairwise register tier.
void pd_limits(int* max_n, int* max_k, int* max_pairs, int* max_pairwise_n,
               int* small_d, int* reg_n, int* reg_k, int* exact_n,
               int* exact_k, int* pair_reg_n) {
  *max_n = kMaxN;
  *max_k = kMaxK;
  *max_pairs = kMaxPairs;
  *max_pairwise_n = kMaxPairwiseN;
  *small_d = static_cast<int>(kSmallD);
  *reg_n = kRegN;
  *reg_k = kRegK;
  *exact_n = kExactN;
  *exact_k = kExactK;
  *pair_reg_n = kPairRegN;
}

// Number of CTAs a launch uses for this shape and route, and the floats of
// scratch (`partials`) it needs: (npairs, grid) on the tile route when grid
// > 1 (1 means the kernel writes the output itself), a row of the tier's
// caps a CTA on a register route, none on the warp route.  pairwise = 1 for
// pairwise_sq_dists (k ignored; route the tile route or a pairwise register
// route); w_bf16 / p_bf16 = 1 when W / P is bfloat16.
int pd_grid(int pairwise, int w_bf16, int p_bf16, int route, int n,
            long long d, int k, int device, int* grid, long long* scratch) {
  if (!shape_ok(pairwise, n, d, k)) return cudaErrorInvalidValue;
  Dists a{};
  a.n = n;
  a.d = d;
  a.k = k;
  a.device = device;
  const cudaError_t err = run(pairwise, w_bf16, p_bf16, route, Op::kGrid, a,
                              grid);
  if (err != cudaSuccess) return err;
  const bool exact = route == kRouteExact1 || route == kRouteExact2;
  const bool regs = exact || route == kRouteRegs1 || route == kRouteRegs2;
  long long rows = 0;
  if (pair_route(route)) {
    rows = kPairRegN * (kPairRegN - 1) / 2;
  } else if (regs) {
    rows = exact ? kExactN * kExactK : kRegN * kRegK;
  } else if (route == kRouteTile && *grid > 1) {
    rows = num_pairs(pairwise, n, k);
  }
  *scratch = rows * *grid;
  return cudaSuccess;
}

// The compiled kernel of (pairwise?, W dtype, P dtype, route): registers a
// thread and local memory a thread (bytes: spills).
int pd_kernel_attributes(int pairwise, int w_bf16, int p_bf16, int route,
                         int device, int* regs, int* local_bytes) {
  Dists a{};
  a.device = device;
  cudaFuncAttributes attr{};
  const cudaError_t err = run(pairwise, w_bf16, p_bf16, route,
                              Op::kAttributes, a, nullptr, &attr);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// w (n, d) and p (k, d) row-major, each f32 or bf16; partials f32 scratch of
// the length pd_grid gives; ticket one zeroed 32-bit counter (register
// routes); out (n, k) f32.
int pd_sq_dists_to_points(const void* w, int w_bf16, const void* p,
                          int p_bf16, int route, float* partials,
                          void* ticket, float* out, int n, long long d, int k,
                          int grid, int device, void* stream) {
  if (!shape_ok(false, n, d, k) || grid < 1) return cudaErrorInvalidValue;
  const Dists a{w, p, partials, static_cast<unsigned*>(ticket), out, n, d, k,
                grid, device, static_cast<cudaStream_t>(stream)};
  return run(0, w_bf16, p_bf16, route, Op::kLaunch, a);
}

// w (n, d) row-major f32 or bf16; route the tile route or a pairwise
// register route; partials f32 scratch of the length pd_grid gives; ticket
// one zeroed 32-bit counter (register routes); out (n, n) f32.
int pd_pairwise_sq_dists(const void* w, int bf16_in, int route,
                         float* partials, void* ticket, float* out, int n,
                         long long d, int grid, int device, void* stream) {
  if (!shape_ok(true, n, d, 0) || grid < 1) return cudaErrorInvalidValue;
  const Dists a{w, w, partials, static_cast<unsigned*>(ticket), out, n, d, 0,
                grid, device, static_cast<cudaStream_t>(stream)};
  return run(1, bf16_in, bf16_in, route, Op::kLaunch, a);
}

}  // extern "C"
