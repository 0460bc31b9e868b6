// Online-softmax attention forward (GQA, causal, sliding window): CUDA for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py (def :73, pallas_call :107):
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / G, j]) @ v[b, h / G]
// q (B, Hq, Sq, Dh), k and v (B, Hkv, Skv, Dh), G = Hq / Hkv, all bf16 or all
// f32; out (B, Hq, Sq, Dh) contiguous, in q's dtype.  Query row i sits at
// absolute position Skv - Sq + i (the end of the K/V timeline).  Key j is
// visible to query position p if j <= p (causal) and j > p - window (sliding
// window).  m and l are f32 with a -1e30 sentinel, so a tile that the mask
// hides entirely yields no NaN; a row that sees no key writes 0, as the TPU
// kernel does.
//
// Bound.  Per (query, key) pair the mask keeps, 2 Dh multiply-adds (4 Dh
// operations) against the tensor cores' bf16 rate, or the bytes of q, k, v
// read once and out written once, whichever is larger: the bytes at the
// pretrain path's (10, 25 / 5, 129, 64) (9.91 MB, 2.96 us at 3.35 TB/s), the
// operations at S = 4096 with window 1024 (23.8 us at 989 TFLOP/s).
//
// Design, bf16 (flash_fwd_mma; the pretrain path).  The TPU kernel walks
// (B, Hq, Sq / 128, Skv / 128) in order on one core, carrying m, l and the
// accumulator in VMEM scratch, with Dh padded to the 128-lane width and both
// products on the MXU in f32.  Here, in the FlashAttention-2 shape, a CTA of
// 4 warps takes 4 work items, a warp each; an item is 16 query rows of one
// head.  The items of one (b, KV head) are ordered row block major (all G
// heads of rows 0..15, then of rows 16..31, ...), so a CTA's warps are the G
// heads that share its K/V tiles at nearly the same rows: each K/V tile is
// loaded once for them, and the CTA's rows span at most ceil(4 / G) + 1
// adjacent row blocks (G = 1: one 64-row q-tile of one head).
// (A CTA per (64-row q-tile, head) read each K/V tile once per head, and at
// S = 129 spent a CTA of 4 warps on the one-row remainder.)
//   - Q is copied once into shared memory and each warp keeps its 16 x Dh
//     A fragments in registers (ldmatrix).
//   - K and V tiles of 64 keys stay bf16 in shared memory, in a ring of two
//     stages filled by 16-byte cp.async copies, so tile t + 1 is in flight
//     while tile t is multiplied.  Rows are padded by 16 bytes: 8 rows of an
//     ldmatrix start 4 words apart modulo 32 banks, so the reads (plain for
//     K, .trans for V) have no bank conflicts.  Rows past Skv are
//     zero-filled by the copy itself.
//   - Both products are mma.sync.m16n8k16 bf16 with f32 accumulators:
//     S = Q K^T, then O += P V.  The softmax works on the S fragments where
//     they are: a row's max and sum reduce over the 4 threads of a quad by
//     shuffles, P = 2^(s c - m c) (c = scale log2 e, one FFMA and one ex2)
//     is rounded to bf16 in registers and used as the A operand of P V
//     directly (the m16n8k16 C layout of two adjacent n-tiles is the A
//     layout), so P never goes to shared memory.  l sums the f32 P.
//   - Tiles wholly under the causal mask or outside the window are never
//     loaded; the elementwise mask (each row's visible keys as one int
//     range) runs only on tiles that straddle the diagonal, the window's
//     edge or Skv, decided per warp.  A warp with no item, or whose rows see
//     nothing of a tile, issues no mma for it.
//   - The item blocks run in reverse order (the grid's slowest axis, counted
//     down), so the rows that see the most keys under the causal mask start
//     first and the short ones fill the tail.
// Numerics: the TPU kernel multiplies in f32; this one rounds P to bf16 before
// P V (at most 2^-9 relative a term) and sums in f32, well inside the bf16
// tolerance of 2e-2.  The row max is taken on the unscaled scores, so the
// scale must be positive.  cp.async needs 16-byte-aligned rows: the entry
// point refuses pointers or outer strides that are not (the wrapper raises
// first).
//
// Design, f32 (flash_fwd; off the pretrain path, which runs in bf16).  The
// tensor cores take f32 only as TF32 (a 10-bit mantissa, ~1e-3 relative),
// which breaks the reference's 2e-4 f32 tolerance, so f32 keeps a CUDA-core
// kernel: one CTA of 256 threads per (64-query tile, head, batch), K and V
// staged in shared memory as f32, a 16 x 16 thread grid holding 4 query rows
// x Dh / 16 output columns each in registers, P through shared memory, f32
// FMAs.
//
// Each output row is written by one CTA: no atomics, the result is
// deterministic.  Dh is a template parameter (64, 80, 96, 128: no padding to
// 128).  Limits (the entry point returns cudaErrorInvalidValue beyond them):
//   Dh in {64, 80, 96, 128}; B, Hq <= 65535; Hq % Hkv == 0; Sq, Skv >= 1;
//   bf16: every pointer and outer stride 16-byte aligned, scale > 0,
//   (Hq / Hkv) * ceil(Sq / 16) <= 4 * 65535.

#include <cstdint>

#include "common.cuh"

namespace {

// ---- f32: the CUDA-core kernel ---------------------------------------------

constexpr int kBQ = 64;               // query rows of a CTA
constexpr int kBK = 64;               // keys of a tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kRows = kBQ / 16;       // query rows of a thread
constexpr int kKeys = kBK / 16;       // keys of a thread per tile
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;                  // in elements; the Dh stride is 1
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }


template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH +
                          kBQ * (kBK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int hq, int group,
              int sq, int skv, int causal, long long window, float scale,
              Strides qs, Strides ks, Strides vs) {
  constexpr int kCols = DH / 16;      // output columns of a thread
  extern __shared__ float smem[];
  float* q_s = smem;                          // (BQ, DH + 1)
  float* k_s = q_s + kBQ * (DH + 1);          // (BK, DH + 1)
  float* v_s = k_s + kBK * (DH + 1);          // (BK, DH)
  float* p_s = v_s + kBK * DH;                // (BQ, BK + 1)

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long off = static_cast<long long>(skv) - sq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / group) * ks.h;
  const T* vb = v + b * vs.b + (h / group) * vs.h;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH;
    const int d = e % DH;
    q_s[r * (DH + 1) + d] =
        q0 + r < sq ? to_f32(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  // the keys that some query of this tile can see: [kmin, kmax]
  const int rows_here = min(kBQ, sq - q0);
  long long kmin = 0;
  long long kmax = skv - 1;
  if (causal) kmax = min(kmax, q0 + rows_here - 1 + off);
  if (window > 0) kmin = max(kmin, q0 + off - window + 1);

  long long qpos[kRows];
  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    qpos[i] = q0 + kRows * ty + i + off;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (long long k0 = kmin / kBK * kBK; k0 <= kmax; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int r = e / DH;
      const int d = e % DH;
      const bool in = k0 + r < skv;
      k_s[r * (DH + 1) + d] = in ? to_f32(kb[(k0 + r) * ks.s + d]) : 0.f;
      v_s[r * DH + d] = in ? to_f32(vb[(k0 + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(kRows * ty + i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = k_s[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      bool ok[kKeys];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const long long kpos = k0 + tx + 16 * j;
        ok[j] = kpos < skv && (!causal || kpos <= qpos[i]) &&
                (window <= 0 || kpos > qpos[i] - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      }
      const float m_new = fmaxf(m[i], tmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = ok[j] ? __expf(s[i][j] - m_new) : 0.f;
        p_s[(kRows * ty + i) * (kBK + 1) + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      }
      const float alpha = __expf(m[i] - m_new);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(kRows * ty + i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = v_s[j * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + kRows * ty + i;
    if (row >= sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    T* o = out + ((static_cast<long long>(b) * hq + h) * sq + row) * DH;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}


// ---- bf16: the tensor-core kernel ------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;                  // 16 query rows a warp
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;        // query rows of a CTA
constexpr int kMmaBK = 64;                    // keys of a tile
constexpr int kStages = 2;                    // K/V tiles in the ring
constexpr int kPad = 8;                       // bf16 padding of a row: 16 bytes

// CTAs along the grid's item axis: kMmaWarps items of 16 rows a CTA.
inline long long mma_item_blocks(int group, int sq) {
  return (static_cast<long long>(group) * ((sq + 15) / 16) + kMmaWarps - 1) /
         kMmaWarps;
}

template <int DH>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (DH + kPad) * (kMmaBQ + 2 * kStages * kMmaBK);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst; 16 zero bytes when !in (src unread).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as a bf16 pair, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ROWS rows of DH bf16 into shared dst (row stride DH + kPad) by cp.async;
// row_src(r) is row r's first element, or nullptr for a row to zero-fill
// (the copy then reads nothing; `base` stands in as its source address).
template <int DH, int ROWS, typename RowSrc>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          RowSrc row_src) {
  constexpr int kChunks = DH / 8;             // 16-byte chunks of a row
#pragma unroll
  for (int i = 0; i < (ROWS * kChunks + kMmaThreads - 1) / kMmaThreads; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    if (ROWS * kChunks % kMmaThreads != 0 && c >= ROWS * kChunks) break;
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const bf16* src = row_src(r);
    cp_async16(smem_addr(dst + r * (DH + kPad) + ch * 8),
               src != nullptr ? src + ch * 8 : base, src != nullptr);
  }
}

// Work items: the 16-row blocks of the G query heads that share one KV
// head, row block major (item i = row block i / G of head i % G).  A CTA
// takes kMmaWarps consecutive items, a warp each, so the heads of a group
// share each K/V tile that the CTA loads, and the CTA's rows span at most
// ceil(kMmaWarps / G) + 1 adjacent row blocks.  Grid: (Hkv, B, item blocks),
// the item blocks counted down.
template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int hq,
                  int group, int sq, int skv, int causal, int window,
                  float scale_log2, Strides qs, Strides ks, Strides vs) {
  constexpr int kRow = DH + kPad;             // shared row stride, elements
  constexpr int kKSteps = DH / 16;            // k-steps of Q K^T
  constexpr int kSTiles = kMmaBK / 8;         // 8-key n-tiles of S
  constexpr int kOTiles = DH / 8;             // 8-column n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // (BQ, kRow): 16 a warp
  bf16* kv_s = q_s + kMmaBQ * kRow;           // stage s: K, then V, (BK, kRow)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                     // the fragment's row (and + 8)
  const int tq = lane % 4;                    // its column pair
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int items = group * ((sq + 15) / 16);
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kMmaWarps;
  const int i1 = min(i0 + kMmaWarps, items) - 1;      // the CTA's last item
  const int off = skv - sq;
  const bf16* qb = q + b * qs.b + kvh * group * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  // the keys that some query of this CTA can see: [kmin, kmax]
  const int p_first = 16 * (i0 / group) + off;
  const int p_last = min(16 * (i1 / group) + 15, sq - 1) + off;
  int kmin = 0;
  int kmax = skv - 1;
  if (causal) kmax = min(kmax, p_last);
  if (window > 0) kmin = max(kmin, p_first - window + 1);
  const int t0 = kmin / kMmaBK;
  const int ntiles = kmax < kmin ? 0 : kmax / kMmaBK - t0 + 1;

  auto load_kv = [&](int t, int stage) {
    bf16* kst = kv_s + stage * 2 * kMmaBK * kRow;
    const int key0 = (t0 + t) * kMmaBK;
    load_rows<DH, kMmaBK>(kst, kb, [&](int r) {
      return key0 + r < skv ? kb + (key0 + r) * ks.s : nullptr;
    });
    load_rows<DH, kMmaBK>(kst + kMmaBK * kRow, vb, [&](int r) {
      return key0 + r < skv ? vb + (key0 + r) * vs.s : nullptr;
    });
  };
  load_rows<DH, kMmaBQ>(q_s, qb, [&](int r) {
    const int item = i0 + r / 16;
    const int row = 16 * (item / group) + r % 16;
    return item < items && row < sq
               ? qb + (item % group) * qs.h + static_cast<long long>(row) * qs.s
               : nullptr;
  });
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();

  // this warp's item: 16 rows of one head; a row past Sq is never written
  const int item = i0 + warp;
  const bool live = item < items;
  const int h = kvh * group + item % group;
  const int wrow = 16 * (item / group);
  const int p_lo = wrow + off;                          // first row's position
  const int p_hi = min(wrow + 15, sq - 1) + off;        // last written row's
  // the keys each of this thread's two rows sees: [lo, hi]
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = wrow + g + 8 * r + off;
    hi[r] = causal ? min(pos, skv - 1) : skv - 1;
    lo[r] = window > 0 ? pos - window + 1 : 0;
  }

  uint32_t qf[kKSteps][4];
  float o[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};            // rows g and g + 8, unscaled
  float l[2] = {0.f, 0.f};                    // this thread's share of l

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv(t + 1, (t + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();                       // tile t (and Q) have landed
    __syncthreads();
    const bf16* kst = kv_s + (t % kStages) * 2 * kMmaBK * kRow;
    const bf16* vst = kst + kMmaBK * kRow;
    const int k0 = (t0 + t) * kMmaBK;
    if (live && t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        ldmatrix_x4(qf[kk], smem_addr(q_s + (16 * warp + lane % 16) * kRow +
                                      16 * kk + 8 * (lane / 16)));
      }
    }
    const bool seen = live && !(causal && k0 > p_hi) &&
                      !(window > 0 && k0 + kMmaBK - 1 <= p_lo - window);
    if (seen) {
      const bool full = k0 + kMmaBK <= skv &&
                        (!causal || k0 + kMmaBK - 1 <= p_lo) &&
                        (window <= 0 || k0 > p_hi - window);
      float s[kSTiles][4];
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
      // S = Q K^T: 16 keys (two n-tiles) per ldmatrix.x4 of K
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
        for (int j2 = 0; j2 < kSTiles / 2; ++j2) {
          uint32_t kf[4];
          ldmatrix_x4(kf, smem_addr(kst +
                                    (16 * j2 + lane % 8 + 8 * (lane / 16)) *
                                        kRow +
                                    16 * kk + 8 * ((lane / 8) % 2)));
          mma_bf16(s[2 * j2], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * j2 + 1], qf[kk], kf[2], kf[3]);
        }
      }
      // the elementwise mask only on a straddling tile; the row max
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!full) {
            const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
            const int r = e / 2;
            s[j][e] = kpos >= lo[r] && kpos <= hi[r] ? s[j][e] : kNegInf;
          }
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      }
      float alpha[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        alpha[r] = exp2_approx((m[r] - mn) * scale_log2);
        m[r] = mn;
        ms[r] = mn * scale_log2;
      }
      // P = 2^(s scale_log2 - m scale_log2); a masked key is 0 (also for a
      // row that has seen nothing yet, where s == m)
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(fmaf(s[j][e], scale_log2, -ms[e / 2]));
          if (!full) p = s[j][e] <= kNegInf ? 0.f : p;
          s[j][e] = p;
          rs[e / 2] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int j = 0; j < kOTiles; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // O += P V: P's C fragments of n-tiles 2c, 2c + 1 are the A fragment
      // of keys 16c .. 16c + 15
#pragma unroll
      for (int c = 0; c < kMmaBK / 16; ++c) {
        const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                                pack_bf16(s[2 * c][2], s[2 * c][3]),
                                pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                                pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, smem_addr(vst +
                                          (16 * c + lane % 8 +
                                           8 * ((lane / 8) % 2)) * kRow +
                                          16 * dp + 8 * (lane / 16)));
          mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                          // the stage may be refilled
  }
  cp_async_wait<0>();
  if (!live) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
  const int row0 = wrow + g;
  bf16* o0 = out + ((static_cast<long long>(b) * hq + h) * sq + row0) * DH;
  bf16* o1 = o0 + 8 * DH;
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const int col = 8 * j + 2 * tq;
    if (row0 < sq) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(o[j][0] * l[0], o[j][1] * l[0]);
    }
    if (row0 + 8 < sq) {
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
          __floats2bfloat162_rn(o[j][2] * l[1], o[j][3] * l[1]);
    }
  }
}

// ---- launchers ---------------------------------------------------------------

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int b, int hq, int hkv, int sq, int skv, int causal,
                       long long window, float scale, Strides qs, Strides ks,
                       Strides vs, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<float, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd<float, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), hq, hq / hkv,
      sq, skv, causal, window, scale, qs, ks, vs);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int b, int hq, int hkv, int sq, int skv, int causal,
                       long long window, float scale, Strides qs, Strides ks,
                       Strides vs, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // the item blocks are the slowest axis, counted down by the kernel; a
  // window longer than the timeline hides nothing
  const int group = hq / hkv;
  const dim3 grid(hkv, b, mma_item_blocks(group, sq));
  const int win = static_cast<int>(window < skv ? window : 0);
  flash_fwd_mma<DH><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), hq, group, sq,
      skv, causal, win, scale * 1.4426950408889634f, qs, ks, vs);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(bool bf16_in, const void* q, const void* k,
                      const void* v, void* out, int b, int hq, int hkv, int sq,
                      int skv, int causal, long long window, float scale,
                      Strides qs, Strides ks, Strides vs,
                      cudaStream_t stream) {
  return bf16_in ? launch_mma<DH>(q, k, v, out, b, hq, hkv, sq, skv, causal,
                                  window, scale, qs, ks, vs, stream)
                 : launch_f32<DH>(q, k, v, out, b, hq, hkv, sq, skv, causal,
                                  window, scale, qs, ks, vs, stream);
}

template <int DH>
cudaError_t attributes_dh(bool bf16_in, cudaFuncAttributes* attr,
                          size_t* dynamic_smem) {
  *dynamic_smem = bf16_in ? mma_smem_bytes<DH>() : smem_bytes<DH>();
  return bf16_in ? cudaFuncGetAttributes(attr, flash_fwd_mma<DH>)
                 : cudaFuncGetAttributes(attr, flash_fwd<float, DH>);
}

bool aligned16(const void* p, long long elems_b, long long elems_h,
               long long elems_s) {
  const long long bytes = static_cast<long long>(sizeof(bf16));
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         elems_b * bytes % 16 == 0 && elems_h * bytes % 16 == 0 &&
         elems_s * bytes % 16 == 0;
}

}  // namespace

extern "C" {

// q (b, hq, sq, dh), k and v (b, hkv, skv, dh), each with the given element
// strides for its first three axes and stride 1 along dh; all f32, or all
// bf16 when is_bf16 = 1 (then every pointer and outer stride 16-byte aligned).
// out (b, hq, sq, dh) contiguous, q's dtype.  causal = 1 applies the causal
// mask; window > 0 the sliding window.
int fa_forward(const void* q, const void* k, const void* v, void* out,
               int is_bf16, int b, int hq, int hkv, int sq, int skv, int dh,
               int causal, long long window, float scale, long long q_sb,
               long long q_sh, long long q_ss, long long k_sb, long long k_sh,
               long long k_ss, long long v_sb, long long v_sh, long long v_ss,
               int device, void* stream) {
  if (b < 1 || b > 65535 || hq < 1 || hq > 65535 || hkv < 1 ||
      hq % hkv != 0 || sq < 1 || skv < 1 || window < 0 ||
      (is_bf16 && (mma_item_blocks(hq / hkv, sq) > 65535 || !(scale > 0)))) {
    return cudaErrorInvalidValue;
  }
  if (is_bf16 && !(aligned16(q, q_sb, q_sh, q_ss) &&
                aligned16(k, k_sb, k_sh, k_ss) &&
                aligned16(v, v_sb, v_sh, v_ss))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return launch_dh<64>(is_bf16, q, k, v, out, b, hq, hkv, sq, skv, causal,
                           window, scale, qs, ks, vs, s);
    case 80:
      return launch_dh<80>(is_bf16, q, k, v, out, b, hq, hkv, sq, skv, causal,
                           window, scale, qs, ks, vs, s);
    case 96:
      return launch_dh<96>(is_bf16, q, k, v, out, b, hq, hkv, sq, skv, causal,
                           window, scale, qs, ks, vs, s);
    case 128:
      return launch_dh<128>(is_bf16, q, k, v, out, b, hq, hkv, sq, skv, causal,
                            window, scale, qs, ks, vs, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The compiled kernel for (dtype, dh): registers a thread, static and dynamic
// shared memory a CTA, local memory a thread (spills), threads a CTA.
int fa_kernel_attributes(int is_bf16, int dh, int* regs, int* static_smem,
                         int* dynamic_smem, int* local_bytes, int* threads) {
  cudaFuncAttributes attr{};
  size_t dyn = 0;
  cudaError_t err;
  switch (dh) {
    case 64: err = attributes_dh<64>(is_bf16, &attr, &dyn); break;
    case 80: err = attributes_dh<80>(is_bf16, &attr, &dyn); break;
    case 96: err = attributes_dh<96>(is_bf16, &attr, &dyn); break;
    case 128: err = attributes_dh<128>(is_bf16, &attr, &dyn); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *static_smem = static_cast<int>(attr.sharedSizeBytes);
  *dynamic_smem = static_cast<int>(dyn);
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *threads = is_bf16 ? kMmaThreads : kThreads;
  return cudaSuccess;
}

}  // extern "C"
