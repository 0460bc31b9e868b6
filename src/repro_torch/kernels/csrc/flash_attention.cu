// Online-softmax attention forward (GQA, causal, sliding window): CUDA for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / G, j]) @ v[b, h / G]
// q (B, Hq, Sq, Dh), k and v (B, Hkv, Skv, Dh), G = Hq / Hkv, all f32 or all
// bf16 (cast to f32 on load); out (B, Hq, Sq, Dh) contiguous, in q's dtype.
// Query row i sits at absolute position Skv - Sq + i (the end of the K/V
// timeline).  Key j is visible to query position p if j <= p (causal) and
// j > p - window (sliding window).  m and l are f32 with a -1e30 sentinel, so
// a tile that the mask hides entirely yields no NaN; a row that sees no key
// writes 0, as the TPU kernel does.
//
// Bound.  Per (query, key) pair the mask keeps, 2 Dh FMAs (4 Dh operations)
// against the tensor cores' bf16 rate, or the bytes of q, k, v read once and
// out written once, whichever is larger: the bytes at the pretrain path's
// S = 129, the operations at S = 4096.  This kernel does the products in
// f32 FMAs on the CUDA cores, so it sits far above that bound; tensor cores
// (wgmma) and TMA are later work.
//
// Design.  The TPU kernel walks (B, Hq, Sq / 128, Skv / 128) in order on one
// core, carrying m, l and the accumulator in VMEM buffers, with Dh padded to
// the 128-lane width.  Here one CTA owns one (64-query tile, head, batch): it
// stages its Q tile in shared memory once, then walks only the 64-key tiles
// that its queries can see (tiles wholly under the causal mask or outside
// the window are never loaded), staging K and V in shared memory as f32.
// Its 256 threads form a 16 x 16 grid: thread (ty, tx) holds the scores of
// query rows 4 ty .. 4 ty + 3 against keys tx + 16 j (j < 4) and the output
// columns tx + 16 c (c < Dh / 16) of those rows, all in registers, so m, l
// and the accumulator never leave registers.  Row max and row sum reduce
// over the 16 lanes of a half-warp by shuffles; P goes through shared memory
// to the P V product.  Q and K rows are padded by one float, so the
// column-wise reads of both products hit 32 distinct banks.  Dh is a
// template parameter (64, 80, 96, 128: no padding to 128).  Each output row
// is written by one CTA: no atomics, the result is deterministic.
//
// Limits (the entry point returns cudaErrorInvalidValue beyond them):
//   Dh in {64, 80, 96, 128}; B, Hq <= 65535; Hq % Hkv == 0; Sq, Skv >= 1.

#include "common.cuh"

namespace {

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

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* out,
                      int b, int hq, int hkv, int sq, int skv, int causal,
                      long long window, float scale, Strides qs, Strides ks,
                      Strides vs, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hq / hkv, sq, skv,
      causal, window, scale, qs, ks, vs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int hq, int hkv, int sq, int skv, int dh, int causal,
                   long long window, float scale, Strides qs, Strides ks,
                   Strides vs, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch_dh<T, 64>(q, k, v, out, b, hq, hkv, sq, skv, causal,
                              window, scale, qs, ks, vs, stream);
    case 80:
      return launch_dh<T, 80>(q, k, v, out, b, hq, hkv, sq, skv, causal,
                              window, scale, qs, ks, vs, stream);
    case 96:
      return launch_dh<T, 96>(q, k, v, out, b, hq, hkv, sq, skv, causal,
                              window, scale, qs, ks, vs, stream);
    case 128:
      return launch_dh<T, 128>(q, k, v, out, b, hq, hkv, sq, skv, causal,
                               window, scale, qs, ks, vs, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (b, hq, sq, dh), k and v (b, hkv, skv, dh), each with the given element
// strides for its first three axes and stride 1 along dh; all f32, or all
// bf16 when bf16 = 1.  out (b, hq, sq, dh) contiguous, q's dtype.
// causal = 1 applies the causal mask; window > 0 the sliding window.
int fa_forward(const void* q, const void* k, const void* v, void* out,
               int bf16, int b, int hq, int hkv, int sq, int skv, int dh,
               int causal, long long window, float scale, long long q_sb,
               long long q_sh, long long q_ss, long long k_sb, long long k_sh,
               long long k_ss, long long v_sb, long long v_sh, long long v_ss,
               int device, void* stream) {
  if (b < 1 || b > 65535 || hq < 1 || hq > 65535 || hkv < 1 ||
      hq % hkv != 0 || sq < 1 || skv < 1 || window < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, skv, dh,
                                      causal, window, scale, qs, ks, vs, s)
              : launch<float>(q, k, v, out, b, hq, hkv, sq, skv, dh, causal,
                              window, scale, qs, ks, vs, s);
}

}  // extern "C"
