// Coalition barycenter segment sum: CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/segment_mean.py:
//   segment_sum  out[j, c] = sum_i mix[j, i] * w[i, c]        (K, N) @ (N, D)
// with mix (K, N) f32 (the coalition one-hot, or the aggregation matrix with
// client weights and the empty-coalition fallback folded in) and W (N, D) f32
// or bf16, cast to f32 on load; the sums are f32.
//
// Bound.  2K floating-point operations per element of W read: device-memory
// bytes bound it, N*D*sizeof(W) read + K*D*4 written, each once (at N = 10,
// K = 3, D = 582,026 f32, 30.3 MB: 9.03 us at 3.35 TB/s; at D = 8M, 416 MB:
// 124.2 us).
//
// Design, register tier (reg_segment_sum, N <= kRegN, K <= kRegK): pass 2
// of fused_round.cu without the distances (the register sweep of
// reg_sweep.cuh).  One CTA of 384 threads a SM, all CTAs sweeping D
// together; each thread takes V adjacent columns of all N rows a step,
// straight from device memory into registers with streaming loads.  Each of
// the K rows sum_i mix[j, i] * w[i] is built in registers with fmaf in the
// order of i (the mix in shared memory, read 4 values a warp-uniform
// broadcast) and written once with the load's vector width through
// streaming stores.  Every output has one writer: no partials, no ticket, no
// second launch, no atomics, and repeats are bit-identical.  One tier,
// RegsTier, takes every N <= kRegN, K <= kRegK (rows past N read row N - 1
// again against a zero mix; rows past K are not written).  A tier compiled
// for exactly (N, K) = (10, 3), with the next step's loads issued before
// this step's arithmetic at 512 threads, as the fused round and the
// distances have, was timed against it on the H100 and was no faster (3%
// slower at D = 582,026, under 1% faster at D = 8M): the segment sum keeps
// no N*K sums in registers, so the general tier already holds enough loads
// in flight.
// V = 4 where D % 4 == 0 and the base of W is 4-element aligned (16 bytes in
// f32, as at D = 8M), else 2 where D is even and the base 2-element aligned
// (D = 582,026), else 1; the output, allocated by the wrapper, then has rows
// aligned alike.
//
// Why the first design (segment_sum_cols) reached 40% of the bound at the
// main shape: one thread a column, scalar 4-byte loads, a runtime N with an
// unroll of 4 (about 4 loads in flight a thread), and K = 3 summed as a
// predicated group of 4.
//
// Design, segment_sum_cols (N > kRegN or K > kRegK).  Each thread owns
// columns: the (K, N) mix sits in shared memory (every lane of a warp reads
// the same word, a broadcast), a thread reads the N values of its column
// (neighbouring threads on neighbouring addresses), keeps KG sums in
// registers and writes each of its K outputs once.  KG, the rows summed per
// read of the column, is a compile-time 4, 8 or 16, the least that holds K
// (16 beyond).  A grid that fills the card walks the columns with a grid
// stride.  K > 16 re-reads the column once per further group of 16 rows.
//
// Routes (the wrapper's route(); the entry points refuse a route the shape
// does not fit): reg_segment_sum<RegsTier> at N <= kRegN, K <= kRegK, with
// V = 4, 2 or 1; segment_sum_cols above the caps.
//
// Limits (the entry points return cudaErrorInvalidValue beyond them):
//   N >= 1, K >= 1, K*N <= kMaxMix (the mix in 48 KB of shared memory), D >= 1.

#include "reg_sweep.cuh"

namespace {

constexpr int kThreads = 256;    // threads per segment_sum_cols CTA
constexpr int kMaxMix = 12288;   // K*N floats of shared memory: 48 KB

constexpr int kRegN = 16;        // N and K caps of the register route
constexpr int kRegK = 4;

// Routes (the entry points' `route`): the column kernel, or the register
// tier loading 1, 2 or 4 columns of a row at a time.
constexpr int kRouteCols = 0;
constexpr int kRouteRegs1 = 1;
constexpr int kRouteRegs2 = 2;
constexpr int kRouteRegs4 = 3;

using RegsTier = Tier<kRegN, kRegK, false, 1, false, 384>;

// ------------------------------------------------------------ register route

// V: columns a load and a store take (d % V == 0, the bases of w and out
// V-element aligned).  out (k, d).
template <typename T, class TIER, int V>
__global__ void __launch_bounds__(TIER::threads, 1)
    reg_segment_sum(const T* __restrict__ w, const float* __restrict__ mix,
                    float* __restrict__ out, int n_in, long long d, int k_in) {
  constexpr int NC = TIER::n;
  constexpr int KC = TIER::k;
  constexpr int NC4 = (NC + 3) / 4 * 4;  // mix rows padded for float4 reads
  constexpr int U = TIER::groups(V);
  constexpr int kT = TIER::threads;
  const int n = TIER::exact ? NC : n_in;
  const int k = TIER::exact ? KC : k_in;
  __shared__ __align__(16) float ms[KC * NC4];   // mix, zero-padded
  stage_mix<kT, NC, KC>(ms, mix, n, k);

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
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long g = g0 + u * kT;
          if (g >= groups) continue;
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            if (j < k) {
              float r[V];
              mix_row(s.x[u], ms + j * NC4, r);
              store_cols_cs(out + static_cast<long long>(j) * d + g * V, r);
            }
          }
        }
      });
}

// -------------------------------------------------------------- column route

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

// ---------------------------------------------------------------- dispatch

// Everything a launch needs.
struct Sum {
  const void* w;
  const float* mix;
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
  return n >= 1 && k >= 1 && d >= 1 &&
         static_cast<long long>(k) * n <= kMaxMix;
}

template <typename T, class TIER, int V>
cudaError_t reg_op(Op op, const Sum& a, int* grid, cudaFuncAttributes* attr) {
  const auto kernel = reg_segment_sum<T, TIER, V>;
  switch (op) {
    case Op::kAttributes:
      return cudaFuncGetAttributes(attr, kernel);
    case Op::kGrid:
      return sweep_grid<TIER, V>(kernel, a.device, a.d, grid);
    case Op::kLaunch:
      if (!tier_fits<TIER>(a.n, a.k) ||
          !cols_aligned(V, sizeof(T), a.w, a.d) ||
          !cols_aligned(V, sizeof(float), a.out, a.d)) {
        return cudaErrorInvalidValue;
      }
      kernel<<<a.grid, TIER::threads, 0, a.stream>>>(
          static_cast<const T*>(a.w), a.mix, a.out, a.n, a.d, a.k);
      return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <typename T, int KG>
cudaError_t cols_kg(Op op, const Sum& a, int* grid, cudaFuncAttributes* attr) {
  const auto kernel = segment_sum_cols<T, KG>;
  const size_t smem = sizeof(float) * static_cast<size_t>(a.k) * a.n;
  switch (op) {
    case Op::kAttributes:
      return cudaFuncGetAttributes(attr, kernel);
    case Op::kGrid:
      return fill_grid(kernel, kThreads, smem, a.device,
                       (a.d + kThreads - 1) / kThreads, grid);
    case Op::kLaunch:
      kernel<<<a.grid, kThreads, smem, a.stream>>>(
          static_cast<const T*>(a.w), a.mix, a.out, a.n, a.d, a.k);
      return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t cols_op(Op op, const Sum& a, int* grid, cudaFuncAttributes* attr) {
  if (a.k <= 4) return cols_kg<T, 4>(op, a, grid, attr);
  if (a.k <= 8) return cols_kg<T, 8>(op, a, grid, attr);
  return cols_kg<T, 16>(op, a, grid, attr);
}

template <typename T>
cudaError_t by_route(int route, Op op, const Sum& a, int* grid,
                     cudaFuncAttributes* attr) {
  switch (route) {
    case kRouteCols: return cols_op<T>(op, a, grid, attr);
    case kRouteRegs1: return reg_op<T, RegsTier, 1>(op, a, grid, attr);
    case kRouteRegs2: return reg_op<T, RegsTier, 2>(op, a, grid, attr);
    case kRouteRegs4: return reg_op<T, RegsTier, 4>(op, a, grid, attr);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(int bf16, int route, Op op, const Sum& a, int* grid = nullptr,
                cudaFuncAttributes* attr = nullptr) {
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return err;
  return bf16 ? by_route<__nv_bfloat16>(route, op, a, grid, attr)
              : by_route<float>(route, op, a, grid, attr);
}

}  // namespace

extern "C" {

// The largest K*N the kernels take and the register tier's N and K caps.
void sm_limits(int* max_mix, int* reg_n, int* reg_k) {
  *max_mix = kMaxMix;
  *reg_n = kRegN;
  *reg_k = kRegK;
}

// Number of CTAs a launch uses for this shape and route; bf16 = 1 when W is
// bfloat16.
int sm_grid(int bf16, int route, int n, long long d, int k, int device,
            int* grid) {
  if (!shape_ok(n, d, k)) return cudaErrorInvalidValue;
  Sum a{};
  a.n = n;
  a.d = d;
  a.k = k;
  a.device = device;
  return run(bf16, route, Op::kGrid, a, grid);
}

// The compiled kernel of (dtype, route): registers a thread and local
// memory a thread (bytes: spills).  The column route answers for K <= 4.
int sm_kernel_attributes(int bf16, int route, int device, int* regs,
                         int* local_bytes) {
  Sum a{};
  a.k = 1;
  a.device = device;
  cudaFuncAttributes attr{};
  const cudaError_t err = run(bf16, route, Op::kAttributes, a, nullptr, &attr);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// w (n, d) row-major f32 or bf16; mix (k, n) f32; out (k, d) f32.
int sm_segment_sum(const void* w, int bf16, int route, const float* mix,
                   float* out, int n, long long d, int k, int grid,
                   int device, void* stream) {
  if (!shape_ok(n, d, k) || grid < 1) return cudaErrorInvalidValue;
  const Sum a{w, mix, out, n, d, k, grid, device,
              static_cast<cudaStream_t>(stream)};
  return run(bf16, route, Op::kLaunch, a);
}

}  // extern "C"
