// The register sweep of the fused round's kernels (fused_round.cu,
// reg_sq_dists), the full-width distance kernels (pairwise_dist.cu,
// reg_dists and reg_pairwise) and the segment sum (segment_mean.cu,
// reg_segment_sum), which share it.  Each source is a library of its own
// and compiles its own copy of what is here.
//
// A sweep streams the (N, D) client matrix W (and, for the distances, the
// (K, D) points P) from device memory straight into registers, each element
// once: one CTA a SM, all CTAs stepping over D together (a step of the grid
// covers adjacent columns, so the DRAM pages of a row are read in order), each
// thread taking U groups of V adjacent columns of every row a step.  In a
// pipelined tier the next step's loads are issued before this step's
// arithmetic.  Sums over D that every CTA holds a part of end in one launch:
// each CTA writes a row of partials, and the last CTA, found by an integer
// ticket, sums the rows in a fixed order and writes the output (grid_tail,
// which takes the final write as a function: the (n, k) block, or the
// pairwise kernel's two triangles).  The source notes of fused_round.cu,
// pairwise_dist.cu and segment_mean.cu say what each kernel builds in the
// sweep and why.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace {

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

// V adjacent columns of one row at p, as f32.  Streaming loads: every input
// is read once.  bf16 -> f32 is exact: a bf16 value is the top half of an f32.
__device__ __forceinline__ void load_cols(const float* p, float (&x)[1]) {
  x[0] = __ldcs(p);
}
__device__ __forceinline__ void load_cols(const float* p, float (&x)[2]) {
  const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
  x[0] = v.x;
  x[1] = v.y;
}
__device__ __forceinline__ void load_cols(const float* p, float (&x)[4]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
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
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&x)[4]) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  x[0] = bf16_lo(u.x);
  x[1] = bf16_hi(u.x);
  x[2] = bf16_lo(u.y);
  x[3] = bf16_hi(u.y);
}

// V adjacent f32 columns to p.  store_cols: plain stores; store_cols_cs:
// streaming stores, for outputs no later kernel of the call reads.
__device__ __forceinline__ void store_cols(float* p, const float (&x)[1]) {
  p[0] = x[0];
}
__device__ __forceinline__ void store_cols(float* p, const float (&x)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void store_cols_cs(float* p, const float (&x)[1]) {
  __stcs(p, x[0]);
}
__device__ __forceinline__ void store_cols_cs(float* p, const float (&x)[2]) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
}
__device__ __forceinline__ void store_cols_cs(float* p, const float (&x)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
}

// One step of a thread: U groups of V columns, THREADS groups apart from
// group g0, of all NC rows of the (n, d) matrix at w, as f32.  In a tier
// that is not exact, rows past n read row n - 1 again (a zero mix, or sums
// dropped at the end, keep them out of every result).  Groups past the end
// are zeros.
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

// r = sum_i mix[i] * x[i] over the NC rows, in order of i with fmaf; mix is
// one row of the (K, NC4) mix in shared memory, zero-padded to NC4 = NC
// rounded up to 4, read 4 values a (warp-uniform) broadcast.
template <int NC, int V>
__device__ __forceinline__ void mix_row(const float (&x)[NC][V],
                                        const float* mix, float (&r)[V]) {
  constexpr int NC4 = (NC + 3) / 4 * 4;
#pragma unroll
  for (int v = 0; v < V; ++v) r[v] = 0.f;
#pragma unroll
  for (int i = 0; i < NC4; i += 4) {
    const float4 m4 = *reinterpret_cast<const float4*>(&mix[i]);
    const float m[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int t = 0; t < 4 && i + t < NC; ++t) {
#pragma unroll
      for (int v = 0; v < V; ++v) r[v] = fmaf(m[t], x[i + t][v], r[v]);
    }
  }
}

// The (K, N) mix into shared memory as (KC, NC4) rows, zero past (k, n).
template <int THREADS, int NC, int KC>
__device__ __forceinline__ void stage_mix(float* ms,
                                          const float* __restrict__ mix,
                                          int n, int k) {
  constexpr int NC4 = (NC + 3) / 4 * 4;
  for (int q = threadIdx.x; q < KC * NC4; q += THREADS) {
    const int j = q / NC4;
    const int i = q % NC4;
    ms[q] = j < k && i < n ? mix[j * n + i] : 0.f;
  }
  __syncthreads();
}

// The grid-wide sweep of one thread over `groups` groups of V columns, in
// steps of U = TIER::groups(V) groups: load(buf, g0) fills a Buf with the
// step at group g0 (load_step), use(buf, g0) does its arithmetic.  In a
// pipelined tier the next step's loads are issued before this step's
// arithmetic.
template <class TIER, int V, class Buf, class Load, class Use>
__device__ __forceinline__ void sweep(long long groups, Load&& load,
                                      Use&& use) {
  constexpr int U = TIER::groups(V);
  constexpr int kT = TIER::threads;
  const int tid = threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * U * kT;
  long long g0 = static_cast<long long>(blockIdx.x) * U * kT + tid;
  Buf x;
  if (TIER::pipe) load(x, g0);
  for (; g0 < groups; g0 += stride) {
    if (TIER::pipe) {
      Buf next;
      load(next, g0 + stride);
      use(x, g0);
      x = next;
    } else {
      load(x, g0);
      use(x, g0);
    }
  }
}

// Sums acc over the CTA's threads in a fixed order (a __shfl_xor tree in each
// warp, then the warps in index order) and calls put(q, s) with the sum s of
// pair q = i * KC + j, for every pair q < active, from thread q % THREADS.
// A row i of acc whose first pair is at or past active is skipped: one
// branch a row, so the KC shuffle trees of a row stay independent and
// interleave (a branch a pair would serialise them).  active = NC * KC in
// the kernels that sum every pair below the caps, and the branch folds
// away.  red holds THREADS / 32 * NC * KC floats.  acc is indexed by
// compile-time constants only, so it stays in registers.  Ends with every
// thread at a barrier.
template <int THREADS, int NC, int KC, class Put>
__device__ __forceinline__ void cta_sum(const float (&acc)[NC][KC],
                                        float* red, int active, Put&& put) {
  constexpr int kPairs = NC * KC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (i * KC < active) {
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
  }
  __syncthreads();
  for (int q = threadIdx.x; q < active; q += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < THREADS / 32; ++wp) s += red[wp * kPairs + q];
    put(q, s);
  }
  __syncthreads();
}

// The end of a sweep whose (NC, KC) sums every CTA holds a part of: the CTA's
// row of partials (pair q at offset q of a row of NC * KC, compile-time
// offsets, so the last CTA reads a row from one pointer), then the ticket
// (the pattern of a grid-wide barrier: the CTA's barrier, then one thread's
// fence and atomic); the last CTA sums the rows of all CTAs, one row a
// thread (the launch keeps gridDim.x <= THREADS: all loads in one round), in
// the same fixed tree, hands each pair's sum to write(q, s) (as cta_sum's
// put) and sets the ticket back to 0 for the next launch on the stream.
// Only the rows of acc that hold a pair q < active are summed, and only
// those pairs written (as in cta_sum).  Which CTA is last changes nothing
// in the order of the sums.
template <int THREADS, int NC, int KC, class Write>
__device__ __forceinline__ void grid_tail(float (&acc)[NC][KC], float* red,
                                          float* __restrict__ partials,
                                          unsigned* __restrict__ ticket,
                                          int active, Write&& write) {
  __shared__ bool last;
  constexpr int kPairs = NC * KC;
  const int tid = threadIdx.x;
  float* row = partials + static_cast<long long>(kPairs) * blockIdx.x;
  cta_sum<THREADS>(acc, red, active, [&](int q, float s) { row[q] = s; });
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
  for (int c = tid; c < static_cast<int>(gridDim.x); c += THREADS) {
    const float* rc = partials + static_cast<long long>(kPairs) * c;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i * KC < active) {
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[i][j] += __ldcg(rc + i * KC + j);
      }
    }
  }
  cta_sum<THREADS>(acc, red, active, write);
  if (tid == 0) *ticket = 0u;
}

// grid_tail writing the (n, k) output: the sum of pair (i, j), clamped at 0,
// to out[i * k + j] for i < n, j < k.
template <int THREADS, int NC, int KC>
__device__ __forceinline__ void grid_tail(float (&acc)[NC][KC], float* red,
                                          float* __restrict__ partials,
                                          unsigned* __restrict__ ticket,
                                          float* __restrict__ out, int n,
                                          int k) {
  grid_tail<THREADS>(acc, red, partials, ticket, NC * KC, [&](int q, float s) {
    const int i = q / KC;
    const int j = q % KC;
    if (i < n && j < k) out[i * k + j] = fmaxf(s, 0.f);
  });
}

// Whether a tier takes (n, k): exactly its caps, or at most them.
template <class TIER>
bool tier_fits(int n, int k) {
  return TIER::exact ? n == TIER::n && k == TIER::k
                     : n <= TIER::n && k <= TIER::k;
}

// Whether a (rows, d) matrix at ptr of elem-byte values loads v columns at a
// time: d % v == 0 and the base v-element aligned (so is every row then).
inline bool cols_aligned(int v, size_t elem, const void* ptr, long long d) {
  return d % v == 0 && reinterpret_cast<uintptr_t>(ptr) % (v * elem) == 0;
}

// CTAs of a sweep over d columns: one a SM where the card holds one (at most
// the steps of the grid that d needs, and at most TIER::threads, so that the
// last CTA of grid_tail reads one row of partials a thread).
template <class TIER, int V, typename Kernel>
cudaError_t sweep_grid(Kernel kernel, int device, long long d, int* grid) {
  constexpr long long kStep =
      static_cast<long long>(TIER::groups(V)) * V * TIER::threads;
  const long long work = (d + kStep - 1) / kStep;
  return fill_grid(kernel, TIER::threads, 0, device,
                   work < TIER::threads ? work : TIER::threads, grid);
}

}  // namespace
