// Fused loss tail: pool -> flatten -> FC -> numerically stable softmax
// cross-entropy, written for Hopper (sm_90a) and bound to Python through
// ctypes.
//
// Replaces the Pallas TPU kernel `_tail_kernel`
// (parallel_cnn_tpu/ops/pallas_tail.py:152, launched from `_kernel_forward`
// at pallas_tail.py:236). Forward only, as there: the mean over the batch
// and the backward stay plain tensor code (pallas_tail.py:270-300).
//
// What it computes, for x (B,H,W,C) NHWC, w (D,K), b (K,), labels (B,):
//
//   pooled = max2: the 2x2/stride-2 VALID max pool, flattened (y, x, c)
//                  (D = H/2 * W/2 * C), each window as
//                  max(max(x00, x01), max(x10, x11));
//            gap:  the mean over the H*W positions (D = C);
//            none: x flattened (D = H*W*C).
//   logits[k] = b[k] + sum_d pooled[d] * w[d,k]
//   m = max_k logits; e_k = exp(logits[k] - m); se = sum_k e_k
//   loss[n] = (log(se) + m) - logits[label]
//   dl[n,k] = e_k / se - (k == label)
//
// A label outside [0, K) has an all-zero one-hot row, as jax.nn.one_hot
// gives.
//
// Design. A block an image, one kernel a pool mode (so each holds only its
// mode's code) with its own threads a block and w values loaded first
// (TAIL_GAP_*, and TAIL_MAX2_* for max2 and none). The time of so small a
// kernel is its chain of dependent round trips to memory (the parent's: x,
// then w once per class, then b, then the label), so every load that waits
// for nothing goes out first:
// 0. a thread's first WREG values of w, the bias its lane sums and the
//    image's label, beside
// 1. its x loads, all issued before it adds or compares: float4s over
//    channels where x starts on a 16-byte boundary and C % 4 == 0, else
//    4-byte loads. gap gives a thread a channel quad and sums its H*W
//    positions, TAIL_SEG loads at once (ResNet-18's 4x4x512 at 128
//    threads: 16 float4 loads a thread); max2 takes TAIL_UNROLL windows a
//    thread, their four taps as float4s; none copies. The pooled row goes
//    to shared memory; one barrier.
// 2. The FC, K classes a pass (all of them where K <= the threads): thread
//    t owns class t % K and every `rows`-th feature from t / K, so a warp
//    reads w as consecutive floats (the parent read a column of w at a
//    stride of K floats, once per class); its partial logit in a register,
//    the pooled value from shared memory. Past the WREG values loaded
//    first, w comes in batches of TAIL_WBATCH loads. One barrier.
// 3. Warp 0 sums the logits, lane j class j: b[j] + scale * (the `rows`
//    partials of class j in feature order), scale 1/(H*W) in gap and 1
//    otherwise; then, with no barrier, it runs the softmax over its lanes:
//    max and sum by xor butterflies (every lane ends with the same value),
//    the loss from lane 0, dlogits stored by the lanes. (The parent ran K
//    block reductions, 2K barriers, and the softmax on one thread.)
// An image's loss and dlogits depend only on its data and the shapes,
// never on B or its position in the batch; no atomics, so a relaunch is
// bit-identical. The Pallas kernel's parity phase views and batch blocks
// sized to VMEM answered Mosaic's constraints and have no counterpart here.
//
// Bound on an H100 SXM. Each input element is read once and feeds about K
// multiply-adds (10 for CIFAR), so the kernel is bound by its bytes: x at
// 3.35 TB/s (4.2 MB, 1.25 us for ResNet-18's (128,4,4,512) at batch 128).
// In a training step x was just written by the last conv and is warm in the
// 50 MB L2; w (20 KB for gap, 80 KB for max2) is read by every block (two
// or four images a block, sharing that read, were slower on an H100).
// Unrolled code costs here too: a variant whose registers spilled, or whose
// w array outgrew what its threads needed, ran 1.5-4x slower (PERF.md).
//
// The bf16 form (pallas_tail.py:152 on bf16 x, w and b: f32 dots, f32
// softmax-CE, the gap mean stored in x's dtype before the dot, :180). The
// element type is a template argument: x, w and b are loaded as bf16 (x
// 8 bytes, 4 values, at a time where the f32 form loads a float4) and
// widened exactly, the gap sum runs in f32 and its mean (sum · 1/P) is
// rounded to bf16 before the FC, the max2 maxima are exact in bf16, and
// the FC, the logits and the softmax-CE are the f32 form's. Bound by its
// bytes, half of them the f32 form's for x.
//
// The kernel launches on the caller's stream, synchronises nothing and
// allocates nothing.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

enum Pool { kMax2 = 0, kGap = 1, kNone = 2 };

constexpr int TAIL_GAP_THREADS = 128;   // gap: threads a block
constexpr int TAIL_GAP_WREG = 48;       // gap: w values a thread loads first
constexpr int TAIL_MAX2_THREADS = 256;  // max2 and none: threads a block
constexpr int TAIL_MAX2_WREG = 96;      // max2 and none: w values a thread loads first
constexpr int TAIL_UNROLL = 2;          // max2 / none: units a thread loads at once
constexpr int TAIL_SEG = 16;            // gap: position loads a thread issues at once
constexpr int TAIL_WBATCH = 8;          // FC: loads of w at once past the first WREG
constexpr int DEFAULT_SMEM = 48 * 1024;

template <int POOL> struct Cfg {
  static constexpr int threads = POOL == kGap ? TAIL_GAP_THREADS : TAIL_MAX2_THREADS;
  static constexpr int wreg = POOL == kGap ? TAIL_GAP_WREG : TAIL_MAX2_WREG;
  static_assert(threads % 32 == 0, "whole warps");
};

int threads_of(int pool) { return pool == kGap ? TAIL_GAP_THREADS : TAIL_MAX2_THREADS; }

template <int VEC> struct VecOf { using type = float; };
template <> struct VecOf<4> { using type = float4; };

__device__ __forceinline__ float vzero(float) { return 0.0f; }
__device__ __forceinline__ float4 vzero(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float4 vmax(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

// Loads of x (VEC values as V), w and b, widened to f32: a bf16 value is
// the high half of the f32 it equals, so the widening is exact.
__device__ __forceinline__ float widen(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return widen(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ float ldv(const float* p, float) { return __ldg(p); }
__device__ __forceinline__ float4 ldv(const float* p, float4) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float ldv(const __nv_bfloat16* p, float) { return ld1(p); }
__device__ __forceinline__ float4 ldv(const __nv_bfloat16* p, float4) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));  // 8-byte aligned
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// The bf16 gap mean: the f32 sum times 1/P, rounded to bf16 (as f32).
__device__ __forceinline__ float mean_bf16(float s, float inv) {
  return __bfloat162float(__float2bfloat16_rn(s * inv));
}
__device__ __forceinline__ float4 mean_bf16(float4 s, float inv) {
  return make_float4(mean_bf16(s.x, inv), mean_bf16(s.y, inv), mean_bf16(s.z, inv),
                     mean_bf16(s.w, inv));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// E is the element type of x, w and b: float, or __nv_bfloat16 (the bf16
// form: values widened at the load, the gap mean rounded to bf16 before
// the FC as pallas_tail.py:180 rounds it, the rest f32).
template <int POOL, int VEC, class E>
__global__ void __launch_bounds__(Cfg<POOL>::threads, 1)
tail_ce_kernel(const E* __restrict__ x, const E* __restrict__ w,
               const E* __restrict__ b,
               const long long* __restrict__ labels,
               float* __restrict__ loss, float* __restrict__ dl,
               int h, int wd, int c, int d, int k) {
  constexpr bool BF16 = std::is_same<E, __nv_bfloat16>::value;
  constexpr int THREADS = Cfg<POOL>::threads;
  constexpr int WREG = Cfg<POOL>::wreg;
  using V = typename VecOf<VEC>::type;
  extern __shared__ float4 smem4[];
  const int positions = h * wd;
  float* pooled = reinterpret_cast<float*>(smem4);  // d floats
  float* part = pooled + d;                         // THREADS
  float* logits = part + THREADS;                   // k

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const long long n = blockIdx.x;
  const E* xi = x + n * positions * c;

  // 0. The loads that wait for nothing go out first, beside x's: the
  // first WREG of this thread's w values of the first class pass, the bias
  // its lane sums first, and the label.
  const int kch = k < THREADS ? k : THREADS;
  float wpre[WREG];
  {
    const int rows = THREADS / kch;
    const E* wj = w + tid % kch;
#pragma unroll
    for (int m = 0; m < WREG; ++m) {
      const int f = tid / kch + m * rows;
      wpre[m] = tid < rows * kch && f < d ? ld1(wj + static_cast<long long>(f) * k) : 0.0f;
    }
  }
  const float b_lane = tid < 32 && lane < k ? ld1(b + lane) : 0.0f;
  const long long y = __ldg(labels + n);

  // 1. Pool into shared memory.
  if constexpr (POOL == kGap) {
    const int units = c / VEC;
    for (int u = tid; u < units; u += THREADS) {
      V sum = vzero(V());
      for (int p = 0; p < positions; p += TAIL_SEG) {
        V v[TAIL_SEG];
#pragma unroll
        for (int q = 0; q < TAIL_SEG; ++q)
          if (p + q < positions)
            v[q] = ldv(xi + static_cast<long long>(p + q) * c + u * VEC, V());
#pragma unroll
        for (int q = 0; q < TAIL_SEG; ++q)
          if (p + q < positions) sum = vadd(sum, v[q]);
      }
      if constexpr (BF16) sum = mean_bf16(sum, 1.0f / static_cast<float>(positions));
      *reinterpret_cast<V*>(pooled + u * VEC) = sum;
    }
  } else {
    constexpr int TAPS = POOL == kMax2 ? 4 : 1;
    const int units = d / VEC;
    const int pw = wd / 2;
    const long long tap_off[4] = {0, c, static_cast<long long>(wd) * c,
                                  static_cast<long long>(wd) * c + c};
    for (int base = tid; base < units; base += THREADS * TAIL_UNROLL) {
      V v[TAIL_UNROLL][TAPS];
#pragma unroll
      for (int r = 0; r < TAIL_UNROLL; ++r) {
        const int e = (base + r * THREADS) * VEC;  // the unit's first feature
        if (e >= d) continue;
        long long q = e;
        if (POOL == kMax2) {
          const int ch = e % c;
          const int p = e / c;
          const int py = p / pw;
          const int px = p - py * pw;
          q = (static_cast<long long>(2 * py) * wd + 2 * px) * c + ch;
        }
#pragma unroll
        for (int t = 0; t < TAPS; ++t)
          v[r][t] = ldv(xi + q + tap_off[t], V());
      }
#pragma unroll
      for (int r = 0; r < TAIL_UNROLL; ++r) {
        const int e = (base + r * THREADS) * VEC;
        if (e >= d) continue;
        V o = v[r][0];
        if constexpr (TAPS == 4) o = vmax(vmax(v[r][0], v[r][1]), vmax(v[r][2], v[r][3]));
        *reinterpret_cast<V*>(pooled + e) = o;
      }
    }
  }
  __syncthreads();

  // 2-3. The FC and the logits, kch classes a pass (bf16 gap: the pooled
  // row already is the mean).
  const float scale = POOL == kGap && !BF16 ? 1.0f / static_cast<float>(positions) : 1.0f;
  for (int k0 = 0; k0 < k; k0 += kch) {
    const int kc = k - k0 < kch ? k - k0 : kch;
    const int rows = THREADS / kc;
    float acc = 0.0f;
    if (tid < rows * kc) {
      const E* wj = w + k0 + tid % kc;
      int f = tid / kc;
      if (k0 == 0) {
#pragma unroll
        for (int m = 0; m < WREG; ++m)
          if (f + m * rows < d) acc = fmaf(pooled[f + m * rows], wpre[m], acc);
        f += WREG * rows;
      }
      for (; f < d; f += rows * TAIL_WBATCH) {
        float wv[TAIL_WBATCH];
#pragma unroll
        for (int u = 0; u < TAIL_WBATCH; ++u) {
          const int fu = f + u * rows;
          wv[u] = fu < d ? ld1(wj + static_cast<long long>(fu) * k) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < TAIL_WBATCH; ++u)
          if (f + u * rows < d) acc = fmaf(pooled[f + u * rows], wv[u], acc);
      }
    }
    part[tid] = acc;
    __syncthreads();
    // Warp 0 sums the classes, lane j class j (and j + 32, ...).
    if (tid < 32) {
      for (int j = lane; j < kc; j += 32) {
        float s = part[j];
        for (int r = 1; r < rows; ++r) s += part[r * kc + j];
        const float bj = k0 == 0 && j == lane ? b_lane : ld1(b + k0 + j);
        logits[k0 + j] = bj + scale * s;
      }
    }
    if (k0 + kc < k) __syncthreads();  // the next pass rewrites part
  }

  // The softmax, on warp 0, from the logits it wrote.
  if (tid < 32) {
    __syncwarp();
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < k; j += 32) m = fmaxf(m, logits[j]);
    m = warp_max(m);
    float se = 0.0f;
    float ly = 0.0f;
    for (int j = lane; j < k; j += 32) {
      const float z = logits[j];
      if (j == y) ly = z;
      const float e = expf(z - m);
      logits[j] = e;
      se += e;
    }
    se = warp_sum(se);
    ly = warp_sum(ly);  // at most one lane holds the label's logit
    if (lane == 0) loss[n] = (logf(se) + m) - ly;
    float* dln = dl + n * k;
    for (int j = lane; j < k; j += 32) dln[j] = logits[j] / se - (j == y ? 1.0f : 0.0f);
  }
}

// The pooled row, one partial logit a thread and the logits.
long long smem_bytes(int pool, int d, int k) {
  return (static_cast<long long>(d) + threads_of(pool) + k) * sizeof(float);
}

template <int POOL, int VEC, class E>
int launch(const E* x, const E* w, const E* b, const long long* labels,
           float* loss, float* dl, int batch, int h, int wd, int c, int d, int k,
           long long smem, cudaStream_t stream) {
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        tail_ce_kernel<POOL, VEC, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tail_ce_kernel<POOL, VEC, E><<<static_cast<unsigned>(batch), Cfg<POOL>::threads,
                                 static_cast<size_t>(smem), stream>>>(
      x, w, b, labels, loss, dl, h, wd, c, d, k);
  return static_cast<int>(cudaGetLastError());
}

// The kernel of one pool mode: vector loads of x (4 values: a float4, or
// 8 bytes of bf16) where x starts on a 16-byte boundary and C % 4 == 0,
// else one value at a time.
template <int POOL, class E>
int launch_pool(bool vec, const E* x, const E* w, const E* b,
                const long long* labels, float* loss, float* dl, int batch, int h, int wd,
                int c, int d, int k, long long smem, cudaStream_t stream) {
  return vec ? launch<POOL, 4>(x, w, b, labels, loss, dl, batch, h, wd, c, d, k, smem, stream)
             : launch<POOL, 1>(x, w, b, labels, loss, dl, batch, h, wd, c, d, k, smem, stream);
}

bool valid(int pool, int h, int wd, int c, int d, int k) {
  return h > 0 && wd > 0 && c > 0 && d > 0 && k > 0 && pool >= kMax2 && pool <= kNone;
}

template <class E>
int forward_entry(const E* x, const E* w, const E* b, const long long* labels, float* loss,
                  float* dl, int batch, int h, int wd, int c, int d, int k, int pool,
                  void* stream) {
  if (batch <= 0 || !valid(pool, h, wd, c, d, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = smem_bytes(pool, d, k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<std::uintptr_t>(x) & 15u) == 0 && c % 4 == 0;
  if (pool == kGap)
    return launch_pool<kGap>(vec, x, w, b, labels, loss, dl, batch, h, wd, c, d, k, smem, s);
  if (pool == kMax2)
    return launch_pool<kMax2>(vec, x, w, b, labels, loss, dl, batch, h, wd, c, d, k, smem, s);
  return launch_pool<kNone>(vec, x, w, b, labels, loss, dl, batch, h, wd, c, d, k, smem, s);
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers: x
// (B,H,W,C), w (D,K), b (K,), labels (B,) int64; loss (B,) and dl (B,K) are
// written in full. pool: 0 max2, 1 gap, 2 none. The wrapper keeps the
// pooled row and the logits within the 48 KB a block gets by default; the
// partial logits of the block's threads can take the block past it (by at
// most 1 KB), and the launch then opts in (cudaFuncSetAttribute). Returns 0
// on a launch that was accepted, else the cudaError_t.
extern "C" int tail_ce_forward(const float* x, const float* w, const float* b,
                               const long long* labels, float* loss,
                               float* dl, int batch, int h, int wd, int c,
                               int d, int k, int pool, void* stream) {
  return forward_entry(x, w, b, labels, loss, dl, batch, h, wd, c, d, k, pool, stream);
}

// The bf16 form: x, w and b bf16; loss and dl f32, as the TPU kernel writes
// them.
extern "C" int tail_ce_forward_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                    const __nv_bfloat16* b, const long long* labels,
                                    float* loss, float* dl, int batch, int h, int wd, int c,
                                    int d, int k, int pool, void* stream) {
  return forward_entry(x, w, b, labels, loss, dl, batch, h, wd, c, d, k, pool, stream);
}
