// The paper CNN's first block and its weight gradient: CUDA for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: XLA ran the block there.  On the card, under
// torch.func.vmap with per-client weights, ATen ran conv1 (1 input channel,
// 32 filters of 5x5) as a grouped convolution with groups == channels ==
// clients through its native depthwise kernels, at 2.9 TFLOP/s forward and
// 1.4 TFLOP/s for the weight gradient, with the ReLU and the 2x2 max-pool
// as separate passes over the 24x24x32 maps.
//
//   conv_relu_pool_fwd    y[b, c, f, p] = max over the 2x2 window of p of
//                         relu(sum_taps w[c, f, tap] x[c, b, ...] + b[c, f])
//                         and argmax[b, c, f, p], the window index 2 dy + dx
//                         of the first maximum after the ReLU (ATen's
//                         max-pool: a later value wins only if greater, or
//                         NaN)
//   conv_relu_pool_wgrad  dW[c, f, tap] = sum_b sum_p e * x[c, b, at the
//                         window's argmax + tap], db[c, f] = sum_b sum_p e,
//                         e = g[b, c, f, p] where y > 0 (the ReLU's mask:
//                         y = relu(max)), else 0
//
// x (C, B, 784) f32 with any client and image strides (0 shares one batch
// between clients); w (C, 800) and b (C, 32) with any client stride; y,
// argmax (B, C, 32 * 144) contiguous, the layout in which conv2's grouped
// call under vmap reads y, (B, C * 32, 12, 12); g (B, C, 32 * 144) with any
// image and client strides.  Valid padding: 28 -> 24 -> 12.
//
// Bound, at the FL local phase's step of C = 100 clients x B = 50 images:
// the forward is 4.6 GFLOP (69 us at 67 TFLOP/s f32) and moves 131 MB (39
// us at 3.35 TB/s); the weight gradient needs 1.15 GFLOP, only the argmax
// positions carrying gradient (17 us), and reads the same 131 MB (39 us).
// Both compute in f32 on the CUDA cores: no TF32.
//
// Layout in shared memory.  An image is staged with the columns of each row
// split by parity, (r, col) at r * kRow + (col & 1) * 14 + col / 2, rows
// kRow = 38 floats apart (2 kRow = 76 = 12 mod 32) and images kImg = 1072
// floats apart (16 mod 32).  A thread owns pooled position p = 12 py + px
// and reads the 6x6 patch at (2 py + i, 2 px + j): for a given (i, j) the
// word is p plus a constant modulo 32, so the 32 lanes of a warp (32
// consecutive positions, across two images in the forward's one straddling
// warp) hit 32 banks.
//
// Design, forward.  A CTA of 288 threads takes one client's pair of images:
// it stages the client's 800 weights as ws[tap][filter] (float4 reads give
// one tap of four filters, a broadcast), its 32 biases and the two images,
// then each thread loads its 6x6 patch into registers once and, for each
// group of four filters, sums the window's four pre-activations over the
// 25 taps: 16 FMAs per float4 of weights, the patch reused across all 32
// filters.  The epilogue adds the bias, applies the ReLU, takes the
// window's maximum and its index, and stores y and the argmax byte: a warp
// writes 32 consecutive positions of one filter.
//
// Design, weight gradient.  A lane owns a filter: a CTA of eight warps takes
// one client and one of `splits` runs of its images, and each warp takes
// every eighth pooled position p of an image.  The CTA stages an image,
// and the image's masked gradient e and argmax bytes transposed to [p][f]
// (the loads coalesced along p).  For its position a lane then adds e
// times the 5x5 window at its filter's argmax offset into 25 sums in
// registers, and e into the bias sum: 25 loads and 25 FMAs, only the
// window's maximum counted.  The lanes' windows start at one of four words
// (offsets 0, 1, 28, 29), which lie in four banks, so each load is one
// shared-memory wavefront.  The eight warps' sums are added in warp order.
// With one split (the clients fill the card) each output has one writer;
// with more (the wrapper splits the images until C x splits CTAs fill the
// card once) each CTA writes its sums to scratch, and the last CTA of its
// client to arrive, found by a ticket, adds the splits' sums in their
// order and sets the ticket back to 0.  No atomics on the sums: repeats
// are bit-identical.
//
// Limits (the entry points return cudaErrorInvalidValue beyond them):
// C >= 1, B >= 1 (the weight gradient takes B = 0 and writes zeros), and
// C * ceil(B / 2) < 2^31, C * splits < 2^31 CTAs.

#include "common.cuh"

namespace {

constexpr int kHW = 28;                      // input side
constexpr int kF = 32;                       // filters
constexpr int kK = 5;                        // filter side
constexpr int kTaps = kK * kK;
constexpr int kP = 12;                       // pooled side
constexpr int kNP = kP * kP;                 // pooled positions
constexpr int kMap = kF * kNP;               // y values of one image
constexpr int kPix = kHW * kHW;
constexpr int kHalf = kHW / 2;               // columns of one parity
constexpr int kRow = 38;                     // 2 kRow = 12 (mod 32)
constexpr int kImg = 1072;                   // = 16 (mod 32), >= kHW * kRow
static_assert(kImg >= kHW * kRow, "an image fits its slot");
static_assert((2 * kRow) % 32 == 12 && kImg % 32 == 16, "bank layout");

constexpr int kFwdImgs = 2;                  // images a forward CTA
constexpr int kFwdThreads = kFwdImgs * kNP;  // 288
constexpr int kGroup = 4;                    // filters summed together

constexpr int kWgWarps = 8;                  // warps a weight-gradient CTA
constexpr int kWgThreads = kWgWarps * 32;    // 256
constexpr int kEPitch = kF + 1;              // e and argmax rows [p][f]
constexpr int kAcc = kTaps + 1;              // 25 taps and the bias
constexpr int kOut = kF * kAcc;              // a client's outputs
static_assert(kF == 32, "a lane a filter");

__device__ __forceinline__ int at(int r, int col) {
  return r * kRow + (col & 1) * kHalf + (col >> 1);
}

__device__ __forceinline__ float relu(float v) {
  return (v > 0.f || v != v) ? v : 0.f;    // NaN passes, as torch.relu
}

// Stage `count` images of x, from image `first`, into the slots of xs.
__device__ __forceinline__ void stage_images(float* xs, const float* x,
                                             long long sxb, int first,
                                             int count, int tid,
                                             int threads) {
  for (int i = tid; i < count * kPix; i += threads) {
    const int img = i / kPix;
    const int e = i - img * kPix;
    xs[img * kImg + at(e / kHW, e % kHW)] =
        x[static_cast<long long>(first + img) * sxb + e];
  }
}

__device__ __forceinline__ void load_patch(const float* xs, int p,
                                           float (&v)[kK + 1][kK + 1]) {
  const float* base = xs + at(2 * (p / kP), 2 * (p % kP));
#pragma unroll
  for (int i = 0; i <= kK; ++i) {
#pragma unroll
    for (int j = 0; j <= kK; ++j) {
      v[i][j] = base[i * kRow + (j & 1) * kHalf + (j >> 1)];
    }
  }
}

// ------------------------------------------------------------------ forward

__global__ void __launch_bounds__(kFwdThreads, 3)
    conv_relu_pool_fwd(const float* __restrict__ x, long long sxc,
                       long long sxb, const float* __restrict__ w,
                       long long swc, const float* __restrict__ bias,
                       long long sbc, float* __restrict__ y,
                       unsigned char* __restrict__ amax, int clients, int n) {
  __shared__ __align__(16) float ws[kTaps * kF];   // [tap][filter]
  __shared__ float bs[kF];
  __shared__ float xs[kFwdImgs * kImg];
  const int pairs = (n + kFwdImgs - 1) / kFwdImgs;
  const int c = blockIdx.x / pairs;
  const int b0 = (blockIdx.x - c * pairs) * kFwdImgs;
  const int tid = threadIdx.x;
  const float* wc = w + c * swc;
  for (int i = tid; i < kF * kTaps; i += kFwdThreads) {
    ws[(i % kTaps) * kF + i / kTaps] = wc[i];
  }
  if (tid < kF) bs[tid] = bias[c * sbc + tid];
  stage_images(xs, x + c * sxc, sxb, b0, min(kFwdImgs, n - b0), tid,
               kFwdThreads);
  __syncthreads();

  const int img = tid / kNP;
  const int p = tid - img * kNP;
  if (b0 + img >= n) return;
  float v[kK + 1][kK + 1];
  load_patch(xs + img * kImg, p, v);
  const long long out =
      (static_cast<long long>(b0 + img) * clients + c) * kMap + p;
  const float4* ws4 = reinterpret_cast<const float4*>(ws);
#pragma unroll 1
  for (int g = 0; g < kF / kGroup; ++g) {
    float acc[kGroup][4] = {};
#pragma unroll
    for (int i = 0; i < kK; ++i) {
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        const float4 q = ws4[(i * kK + j) * (kF / kGroup) + g];
        const float wf[kGroup] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int f = 0; f < kGroup; ++f) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[f][k] = fmaf(wf[f], v[i + (k >> 1)][j + (k & 1)], acc[f][k]);
          }
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kGroup; ++f) {
      const int filter = g * kGroup + f;
      const float b = bs[filter];
      float best = relu(acc[f][0] + b);
      int arg = 0;
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        const float r = relu(acc[f][k] + b);
        if (r > best || r != r) {
          best = r;
          arg = k;
        }
      }
      y[out + filter * kNP] = best;
      amax[out + filter * kNP] = static_cast<unsigned char>(arg);
    }
  }
}

// ---------------------------------------------------------- weight gradient

// CTA (c, split) of `splits`: its run of the client's images, one at a time.
__global__ void __launch_bounds__(kWgThreads, 4)
    conv_relu_pool_wgrad(const float* __restrict__ g, long long sgc,
                         long long sgb, const unsigned char* __restrict__ amax,
                         const float* __restrict__ y,
                         const float* __restrict__ x, long long sxc,
                         long long sxb, float* __restrict__ dw,
                         float* __restrict__ db, float* __restrict__ partials,
                         unsigned* __restrict__ tickets, int clients, int n,
                         int splits) {
  __shared__ float xs[kPix];                     // the image, row-major
  __shared__ float es[kNP * kEPitch];            // masked gradient [p][f]
  __shared__ unsigned char ks[kNP * kEPitch];    // argmax [p][f]
  __shared__ bool last;
  const int c = blockIdx.x / splits;
  const int split = blockIdx.x - c * splits;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;                     // the filter
  const float* xc = x + c * sxc;
  const float* gc = g + c * sgc;
  const int per = (n + splits - 1) / splits;
  const int first = min(n, split * per);
  const int end = min(n, first + per);

  float acc[kAcc] = {};
  for (int b = first; b < end; ++b) {
    __syncthreads();   // the last image is read
    const float* xb = xc + static_cast<long long>(b) * sxb;
    for (int i = tid; i < kPix; i += kWgThreads) xs[i] = xb[i];
    const float* gb = gc + static_cast<long long>(b) * sgb;
    const long long at_y = (static_cast<long long>(b) * clients + c) * kMap;
    static_assert(kMap % kWgThreads == 0, "whole rounds");
#pragma unroll 6
    for (int r = 0; r < kMap / kWgThreads; ++r) {
      const int q = tid + r * kWgThreads;        // f * 144 + p
      const int f = q / kNP;
      const int p = q - f * kNP;
      const float gv = gb[q];
      es[p * kEPitch + f] = y[at_y + q] > 0.f ? gv : 0.f;
      ks[p * kEPitch + f] = amax[at_y + q];
    }
    __syncthreads();
    for (int p = warp; p < kNP; p += kWgWarps) {
      const float e = es[p * kEPitch + lane];
      const int k = ks[p * kEPitch + lane];
      const int py = p / kP;
      const int px = p - py * kP;
      // the lanes' windows start at one of four words, in four banks
      const float* win = xs + (2 * py + (k >> 1)) * kHW + 2 * px + (k & 1);
#pragma unroll
      for (int i = 0; i < kK; ++i) {
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          acc[i * kK + j] = fmaf(e, win[i * kHW + j], acc[i * kK + j]);
        }
      }
      acc[kTaps] += e;
    }
  }

  // The warps' sums in warp order in shared memory ([a][f] in es).
  float* red = es;
  static_assert(kOut <= kNP * kEPitch, "the sums fit");
  for (int w = 0; w < kWgWarps; ++w) {
    __syncthreads();
    if (warp == w) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        red[a * kF + lane] = w == 0 ? acc[a] : red[a * kF + lane] + acc[a];
      }
    }
  }
  __syncthreads();
  if (splits > 1) {
    // Each split's sums to the partials; the last CTA of the client to
    // arrive, found by its ticket, adds them in the order of the splits
    // and sets the ticket back to 0 for the next launch.
    float* mine = partials + (static_cast<long long>(c) * splits + split) *
                                 kOut;
    for (int q = tid; q < kOut; q += kWgThreads) mine[q] = red[q];
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(tickets + c, 1u) == splits - 1u;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* all = partials + static_cast<long long>(c) * splits * kOut;
    for (int q = tid; q < kOut; q += kWgThreads) {
      float s = 0.f;
      for (int sp = 0; sp < splits; ++sp) s += __ldcg(all + sp * kOut + q);
      red[q] = s;
    }
    if (tid == 0) tickets[c] = 0u;
    __syncthreads();
  }
  for (int q = tid; q < kOut; q += kWgThreads) {
    const int a = q / kF;                        // red is [a][f]
    const int f = q - a * kF;
    if (a < kTaps) {
      dw[(static_cast<long long>(c) * kF + f) * kTaps + a] = red[q];
    } else {
      db[static_cast<long long>(c) * kF + f] = red[q];
    }
  }
}

bool shape_ok(int clients, int n, int min_n) {
  return clients >= 1 && n >= min_n &&
         static_cast<long long>(clients) * ((n + kFwdImgs - 1) / kFwdImgs) <
             (1LL << 31);
}

}  // namespace

extern "C" {

// The compiled kernel `which` (0: forward, 1: weight gradient): registers a
// thread and local memory a thread (bytes: spills).
int cp_kernel_attributes(int which, int device, int* regs, int* local_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr{};
  if (which == 0) {
    err = cudaFuncGetAttributes(&attr, conv_relu_pool_fwd);
  } else if (which == 1) {
    err = cudaFuncGetAttributes(&attr, conv_relu_pool_wgrad);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// x (clients, n, 784) with strides (sxc, sxb, 1); w (clients, 800) and b
// (clients, 32) with client strides swc, sbc; y and argmax (n, clients,
// 4608) contiguous.
int cp_forward(const float* x, long long sxc, long long sxb, const float* w,
               long long swc, const float* b, long long sbc, float* y,
               unsigned char* argmax, int clients, int n, int device,
               void* stream) {
  if (!shape_ok(clients, n, 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = clients * ((n + kFwdImgs - 1) / kFwdImgs);
  conv_relu_pool_fwd<<<grid, kFwdThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, sxc, sxb, w, swc, b, sbc, y, argmax, clients, n);
  return cudaGetLastError();
}

// CTAs of the weight gradient that the card holds at once (its SMs times
// the CTAs a SM takes), for the wrapper's choice of splits.
int cp_wgrad_slots(int device, int* slots) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, conv_relu_pool_wgrad, kWgThreads, 0);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *slots = per_sm * sms;
  return cudaSuccess;
}

// g (n, clients, 4608) with strides (sgb, sgc, 1); argmax and y (n, clients,
// 4608) contiguous; x as cp_forward's; dw (clients, 800), db (clients, 32).
// The images split `splits` ways: partials (clients * splits * 832 floats)
// and tickets (clients, zero at the launch; left zero) are scratch, unread
// with one split.
int cp_weight_grad(const float* g, long long sgc, long long sgb,
                   const unsigned char* argmax, const float* y,
                   const float* x, long long sxc, long long sxb, float* dw,
                   float* db, float* partials, unsigned* tickets, int clients,
                   int n, int splits, int device, void* stream) {
  if (!shape_ok(clients, n, 0) || splits < 1 ||
      static_cast<long long>(clients) * splits >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = clients * splits;
  conv_relu_pool_wgrad<<<grid, kWgThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      g, sgc, sgb, argmax, y, x, sxc, sxb, dw, db, partials, tickets, clients,
      n, splits);
  return cudaGetLastError();
}

}  // extern "C"
