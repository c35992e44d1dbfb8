// Fused loss tail: pool -> flatten -> FC -> numerically stable softmax
// cross-entropy, written for Hopper (sm_90a) and bound to Python through
// ctypes.
//
// Replaces the Pallas TPU kernel `_tail_kernel`
// (parallel_cnn_tpu/ops/pallas_tail.py:152, launched from `_kernel_forward`
// at pallas_tail.py:192). Forward only, as there: the mean over the batch
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
// Two forms of one function; the wrapper's shape-only plan (ops/tail.py
// `tail_plan`) picks one, never from B, so a row's bits never depend on the
// batch it came in.
//
// The per-image form (`tail_ce_forward`): one launch, a block an image, one
// kernel a pool mode with its own threads a block and w values loaded first
// (TAIL_GAP_*, and TAIL_MAX2_* for max2 and none). Its time is its chain of
// dependent round trips to memory, so every load that waits for nothing
// goes out first:
// 0. a thread's first WREG values of w, the bias its lane sums and the
//    image's label, beside
// 1. its x loads, all issued before it adds or compares: units of 4 values
//    (16 bytes of f32, 8 of bf16; 8 bf16 values for max2 and none) over
//    channels where x starts on a 16-byte boundary and C is a multiple of
//    the unit, else one value. gap gives a thread a channel unit and sums
//    its H*W positions, TAIL_SEG loads at once; max2 takes TAIL_UNROLL
//    windows a thread, their four taps; none copies. The pooled row goes
//    to shared memory; one barrier.
// 2. The FC, K classes a pass (all of them where K <= the threads): thread
//    t owns class t % K and every `rows`-th feature from t / K, so a warp
//    reads w as consecutive values; its partial logit in a register (bf16:
//    the w values loaded first in two chains, odd and even).
// 3. Warp 0 sums the logits, lane j class j: b[j] + scale * (the `rows`
//    partials of class j in feature order), scale 1/(H*W) in f32 gap and 1
//    otherwise, then the softmax over its lanes: max and sum by xor
//    butterflies, the loss from lane 0, dlogits stored by the lanes.
// bf16 w and b stay raw until the FC: ptxas placed each value's widening
// shortly after its load and waited for that load there, a few loads at a
// time, before the first x load went out (the bf16 form took 1.4x the f32
// form's time at ResNet-18's head, PERF.md); so the widening shift is read
// from shared memory after the first barrier.
// Every block reads all of w: right for 10 classes (20-80 KB, L2-resident),
// wrong for many (8.2 MB a block at 2,048 x 1,000). The wrapper keeps the
// pooled row and the logits within the 48 KB a block gets by default.
//
// The tiled form (`tail_ce_forward_tiled`), JAX's batch-block form for many
// classes or features: three short passes on the caller's stream, the
// second and third programmatic dependent launches (each scheduled while
// the one before runs, each waiting in griddepcontrol.wait for its end;
// every kernel of the form asks for the SM's largest shared-memory split,
// so that the next pass's blocks fit beside the running one's):
// 1. Pool (gap, max2; none has none): blocks of (image, channel range)
//    write the pooled rows (B, D) in x's dtype into the caller's scratch.
//    gap splits a channel unit's H*W positions into `pos_groups` (1, 2, 4
//    or 8) ranges summed at once by threads of one block, then added in
//    range order; the f32 form stores the sum (the 1/(H*W) goes with the
//    bias, in pass 3), the bf16 form the mean rounded to bf16, as
//    pallas_tail.py:180 rounds it. x is read once.
// 2. FC: a block a (64-class tile, feature chunk, 32-image group), 128
//    threads of 4 classes x 4 images. Its w tile and its images' pooled
//    values come through a ring of FC_STAGES slots of STAGE_F features by
//    16-byte cp.async copies, FC_STAGES - 1 slots in flight (a chunk of the
//    plan's 4 slots asked for at once), zero-filled past the edges (one
//    value at a time for unaligned operands); w's first slots go out
//    before the wait for pass 1, so w's read overlaps the pool. bf16 slots
//    land raw and each thread widens its own copies into f32 rows before
//    the slot's barrier. Each w tile serves 32 images: w comes from memory
//    ceil(B/32) times a call, not B times. Each partial logit sums its
//    chunk's features in ascending order, one fmaf each (the TPU's f32
//    dot), and goes to the scratch (chunks, B, K).
// 3. Finish: a block a row, a class a thread (FIN_THREADS of them). Class
//    j's logit is b[j] + scale * (its chunk partials, loaded FIN_LOADS at
//    once, summed in chunk order); the softmax-CE runs over K with a fixed
//    tree (each thread's classes in order, an xor butterfly, then the
//    warps' values by the same butterfly); loss and dlogits written.
// Chunks and position groups come from the shapes alone (the plan), so
// every sum has an order fixed by (H, W, C, K), a relaunch is bit-identical
// and a row is the same at any B. No atomics.
//
// Bound on an H100 SXM. Each input element is read once and feeds K
// multiply-adds: bytes bound the CIFAR heads (x at 3.35 TB/s: 4.2 MB, 1.25
// us for ResNet-18's (128,4,4,512) f32) and the ImageNet head too (x 12.85
// MB and w 8.2 MB at b32, 6.3 us, against 131 MFLOP at the 67 TFLOP/s f32
// peak, 2.0 us): about 6 operations a byte, far below the ~295 at which
// tensor cores would pay, so the FC runs on FFMA. At 4 x 4 a thread the
// FC reads 2 bytes of shared memory a multiply-add, twice what an SM's
// 128 bytes a cycle feed at its full FFMA rate.
//
// bf16 (pallas_tail.py:152 on bf16 x, w and b): values widened exactly to
// f32 (a bf16 value is the high half of the f32 it equals), f32 dots, the
// gap mean rounded to bf16 before the FC, f32 softmax-CE; loss and dlogits
// f32.
//
// The kernels launch on the caller's stream, synchronise nothing and
// allocate nothing: the tiled form's scratch comes from the caller.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "ffma_tile.cuh"  // ftile::smem_u32, cp_async_commit, cp_async_wait

namespace {

enum Pool { kMax2 = 0, kGap = 1, kNone = 2 };

// -- the per-image form ----------------------------------------------------
constexpr int TAIL_GAP_THREADS = 128;   // gap: threads a block
constexpr int TAIL_GAP_WREG = 48;       // gap: w values a thread loads first
constexpr int TAIL_MAX2_THREADS = 256;  // max2 and none: threads a block
constexpr int TAIL_MAX2_WREG = 96;      // max2 and none: w values a thread loads first
constexpr int TAIL_UNROLL = 2;          // max2 / none: units a thread loads at once
constexpr int TAIL_SEG = 16;            // gap: position loads a thread issues at once
constexpr int TAIL_WBATCH = 8;          // FC: loads of w at once past the first WREG
constexpr int DEFAULT_SMEM = 48 * 1024;

// -- the tiled form (ops/tail.py mirrors TILE_K, STAGE_F, MAX_POS_GROUPS) --
constexpr int TILE_K = 64;          // classes an FC block
constexpr int TILE_B = 32;          // images an FC block (an image group)
constexpr int STAGE_F = 32;         // features a ring slot
constexpr int MAX_POS_GROUPS = 8;   // gap pass: position ranges a channel unit
constexpr int FC_STAGES = 5;        // slots of the FC's cp.async ring (4 in flight)
constexpr int FC_THREADS = 128;     // 16 class quads x 8 image quads
constexpr int POOL_THREADS = 128;   // pool pass: threads a block
constexpr int FIN_THREADS = 1024;   // finish: threads a block (a row)
constexpr int FIN_SMEM_CLASSES = 8192;  // finish: logits kept in shared memory up to this K
constexpr int FIN_LOADS = 16;       // finish: chunk partials a thread loads at once
static_assert(TILE_K == 16 * 4 && TILE_B == 8 * 4 && FC_THREADS == 16 * 8, "4x4 a thread");

template <int POOL> struct Cfg {
  static constexpr int threads = POOL == kGap ? TAIL_GAP_THREADS : TAIL_MAX2_THREADS;
  static constexpr int wreg = POOL == kGap ? TAIL_GAP_WREG : TAIL_MAX2_WREG;
  static_assert(threads % 32 == 0, "whole warps");
};

int threads_of(int pool) { return pool == kGap ? TAIL_GAP_THREADS : TAIL_MAX2_THREADS; }

// The per-image form's unit of x where it loads vectors: 4 values (16
// bytes of f32, 8 of bf16), and 8 bf16 values (16 bytes) for max2 and
// none; the best of both in turns on an H100 (ResNet-18's gap head gives
// 4-value units a thread each; the CIFAR CNN's max2 head, 8-value ones).
template <int POOL, class E> struct ImageUnit {
  static constexpr int value = std::is_same<E, __nv_bfloat16>::value && POOL != kGap ? 8 : 4;
};

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; }

// A unit of x or w as loaded: V values (16 bytes: 4 f32 or 8 bf16; 8
// bytes: 4 bf16; or one value), kept as its raw bits until used. A bf16
// value is the high half of the f32 it equals, so widening is exact.
template <class E, int V> struct Unit;
template <> struct Unit<float, 4> { using Raw = uint4; };
template <> struct Unit<float, 1> { using Raw = unsigned; };
template <> struct Unit<__nv_bfloat16, 8> { using Raw = uint4; };
template <> struct Unit<__nv_bfloat16, 4> { using Raw = uint2; };
template <> struct Unit<__nv_bfloat16, 1> { using Raw = unsigned short; };

template <class E, int V>
__device__ __forceinline__ typename Unit<E, V>::Raw ld_raw(const E* p) {
  return __ldg(reinterpret_cast<const typename Unit<E, V>::Raw*>(p));
}

__device__ __forceinline__ float lo16(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi16(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

template <class E, int V>
__device__ __forceinline__ void widen(typename Unit<E, V>::Raw r, float (&v)[V]) {
  if constexpr (std::is_same<E, float>::value) {
    if constexpr (V == 4) {
      v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
      v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
    } else {
      v[0] = __uint_as_float(r);
    }
  } else if constexpr (V == 8) {
    v[0] = lo16(r.x); v[1] = hi16(r.x); v[2] = lo16(r.y); v[3] = hi16(r.y);
    v[4] = lo16(r.z); v[5] = hi16(r.z); v[6] = lo16(r.w); v[7] = hi16(r.w);
  } else if constexpr (V == 4) {
    v[0] = lo16(r.x); v[1] = hi16(r.x); v[2] = lo16(r.y); v[3] = hi16(r.y);
  } else {
    v[0] = lo16(r);
  }
}

// The raw bits of f32 values in E: f32 as they are; bf16 rounded to
// nearest even (exact for a value that already is a bf16).
__device__ __forceinline__ unsigned bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// The inverse of widen for the tiled form's units (16 bytes, or one value).
template <class E, int V>
__device__ __forceinline__ typename Unit<E, V>::Raw pack(const float (&v)[V]) {
  if constexpr (std::is_same<E, float>::value) {
    if constexpr (V == 4) {
      return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                        __float_as_uint(v[3]));
    } else {
      return __float_as_uint(v[0]);
    }
  } else if constexpr (V == 8) {
    uint4 r;
    r.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
    r.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
    r.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
    r.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
    return r;
  } else {
    static_assert(V == 1, "the tiled form's bf16 units are 8 values or one");
    return static_cast<unsigned short>(bf16_bits(v[0]));
  }
}

// A unit's N widened values into shared memory (16-byte stores for N >= 4;
// dst on a 16-byte boundary then).
template <int N>
__device__ __forceinline__ void sts_unit(float* dst, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = v[i];
  }
}

// One value of w or b, widened (the per-image form's FC and the finish).
// `sh` is 16: the per-image form reads it from shared memory after its
// first barrier, so that the compiler cannot move a widening, and its wait
// for the load, ahead of the x loads.
__device__ __forceinline__ float raw1(float v, unsigned = 16) { return v; }
__device__ __forceinline__ float raw1(unsigned short u, unsigned sh = 16) {
  return __uint_as_float(static_cast<unsigned>(u) << sh);
}
template <class E> struct Raw1 { using type = float; };
template <> struct Raw1<__nv_bfloat16> { using type = unsigned short; };
__device__ __forceinline__ float ld_raw1(const float* p) { return __ldg(p); }
__device__ __forceinline__ unsigned short ld_raw1(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
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

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The per-image form
// ---------------------------------------------------------------------------

// E is the element type of x, w and b: float, or __nv_bfloat16 (the bf16
// form: values widened at use, the gap mean rounded to bf16 before the FC
// as pallas_tail.py:180 rounds it, the rest f32).
template <int POOL, bool VEC, class E>
__global__ void __launch_bounds__(Cfg<POOL>::threads, 1)
tail_ce_kernel(const E* __restrict__ x, const E* __restrict__ w,
               const E* __restrict__ b,
               const long long* __restrict__ labels,
               float* __restrict__ loss, float* __restrict__ dl,
               int h, int wd, int c, int d, int k) {
  constexpr bool BF16 = std::is_same<E, __nv_bfloat16>::value;
  constexpr int THREADS = Cfg<POOL>::threads;
  constexpr int WREG = Cfg<POOL>::wreg;
  constexpr int N = VEC ? ImageUnit<POOL, E>::value : 1;
  using Raw = typename Unit<E, N>::Raw;
  extern __shared__ float4 smem4[];
  const int positions = h * wd;
  float* pooled = reinterpret_cast<float*>(smem4);  // d floats
  float* part = pooled + d;                         // THREADS
  float* logits = part + THREADS;                   // k
  unsigned* shift = reinterpret_cast<unsigned*>(logits + k);  // 16, for raw1

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const long long n = blockIdx.x;
  const E* xi = x + n * positions * c;

  // 0. The loads that wait for nothing go out first, beside x's, and stay
  // raw until used: the first WREG of this thread's w values of the first
  // class pass, the bias its lane sums first, and the label.
  const int kch = k < THREADS ? k : THREADS;
  typename Raw1<E>::type wpre[WREG];
  {
    const int rows = THREADS / kch;
    const E* wj = w + tid % kch;
#pragma unroll
    for (int m = 0; m < WREG; ++m) {
      const int f = tid / kch + m * rows;
      wpre[m] = tid < rows * kch && f < d ? ld_raw1(wj + static_cast<long long>(f) * k)
                                          : typename Raw1<E>::type(0);
    }
  }
  const typename Raw1<E>::type b_lane =
      tid < 32 && lane < k ? ld_raw1(b + lane) : typename Raw1<E>::type(0);
  const long long y = __ldg(labels + n);
  if (tid == 0) *shift = 16;

  // 1. Pool into shared memory.
  if constexpr (POOL == kGap) {
    const int units = c / N;
    for (int u = tid; u < units; u += THREADS) {
      float sum[N];
#pragma unroll
      for (int i = 0; i < N; ++i) sum[i] = 0.0f;
      for (int p = 0; p < positions; p += TAIL_SEG) {
        Raw v[TAIL_SEG];
#pragma unroll
        for (int q = 0; q < TAIL_SEG; ++q)
          if (p + q < positions)
            v[q] = ld_raw<E, N>(xi + static_cast<long long>(p + q) * c + u * N);
#pragma unroll
        for (int q = 0; q < TAIL_SEG; ++q) {
          if (p + q < positions) {
            float f[N];
            widen<E, N>(v[q], f);
#pragma unroll
            for (int i = 0; i < N; ++i) sum[i] += f[i];
          }
        }
      }
      if constexpr (BF16) {  // the mean (sum times 1/P) rounded to bf16
        const float inv = 1.0f / static_cast<float>(positions);
#pragma unroll
        for (int i = 0; i < N; ++i) sum[i] = __bfloat162float(__float2bfloat16_rn(sum[i] * inv));
      }
      sts_unit(pooled + u * N, sum);
    }
  } else {
    constexpr int TAPS = POOL == kMax2 ? 4 : 1;
    const int units = d / N;
    const int pw = wd / 2;
    const long long tap_off[4] = {0, c, static_cast<long long>(wd) * c,
                                  static_cast<long long>(wd) * c + c};
    for (int base = tid; base < units; base += THREADS * TAIL_UNROLL) {
      Raw v[TAIL_UNROLL][TAPS];
#pragma unroll
      for (int r = 0; r < TAIL_UNROLL; ++r) {
        const int e = (base + r * THREADS) * N;  // the unit's first feature
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
        for (int t = 0; t < TAPS; ++t) v[r][t] = ld_raw<E, N>(xi + q + tap_off[t]);
      }
#pragma unroll
      for (int r = 0; r < TAIL_UNROLL; ++r) {
        const int e = (base + r * THREADS) * N;
        if (e >= d) continue;
        float o[N];
        widen<E, N>(v[r][0], o);
        if constexpr (TAPS == 4) {
          float t1[N], t2[N], t3[N];
          widen<E, N>(v[r][1], t1);
          widen<E, N>(v[r][2], t2);
          widen<E, N>(v[r][3], t3);
#pragma unroll
          for (int i = 0; i < N; ++i) o[i] = fmaxf(fmaxf(o[i], t1[i]), fmaxf(t2[i], t3[i]));
        }
        sts_unit(pooled + e, o);
      }
    }
  }
  __syncthreads();
  // raw1's shift, unknown to the compiler until here (see the header).
  const unsigned sh = *shift;

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
        float acc2 = 0.0f;  // bf16: the odd ones of the values loaded first, a second chain
#pragma unroll
        for (int m = 0; m < WREG; ++m) {
          if (f + m * rows < d) {
            float& a = BF16 && m % 2 == 1 ? acc2 : acc;
            a = fmaf(pooled[f + m * rows], raw1(wpre[m], sh), a);
          }
        }
        if constexpr (BF16) acc += acc2;
        f += WREG * rows;
      }
      for (; f < d; f += rows * TAIL_WBATCH) {
        typename Raw1<E>::type wv[TAIL_WBATCH];
#pragma unroll
        for (int u = 0; u < TAIL_WBATCH; ++u) {
          const int fu = f + u * rows;
          wv[u] = fu < d ? ld_raw1(wj + static_cast<long long>(fu) * k) : typename Raw1<E>::type(0);
        }
#pragma unroll
        for (int u = 0; u < TAIL_WBATCH; ++u)
          if (f + u * rows < d) acc = fmaf(pooled[f + u * rows], raw1(wv[u], sh), acc);
      }
    }
    part[tid] = acc;
    __syncthreads();
    // Warp 0 sums the classes, lane j class j (and j + 32, ...).
    if (tid < 32) {
      for (int j = lane; j < kc; j += 32) {
        float s = part[j];
        for (int r = 1; r < rows; ++r) s += part[r * kc + j];
        const float bj = k0 == 0 && j == lane ? raw1(b_lane, sh) : raw1(ld_raw1(b + k0 + j), sh);
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

// The pooled row, one partial logit a thread, the logits and the shift.
long long smem_bytes(int pool, int d, int k) {
  return (static_cast<long long>(d) + threads_of(pool) + k + 1) * sizeof(float);
}

template <int POOL, bool VEC, class E>
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

// The kernel of one pool mode: 16-byte loads of x where x starts on a
// 16-byte boundary and C is a multiple of the unit, else one value at a
// time.
template <int POOL, class E>
int launch_pool(bool vec, const E* x, const E* w, const E* b,
                const long long* labels, float* loss, float* dl, int batch, int h, int wd,
                int c, int d, int k, long long smem, cudaStream_t stream) {
  return vec ? launch<POOL, true>(x, w, b, labels, loss, dl, batch, h, wd, c, d, k, smem, stream)
             : launch<POOL, false>(x, w, b, labels, loss, dl, batch, h, wd, c, d, k, smem, stream);
}

int flat_dim(int pool, int h, int wd, int c) {
  if (pool == kMax2) return (h / 2) * (wd / 2) * c;
  return pool == kGap ? c : h * wd * c;
}

bool valid(int batch, int pool, int h, int wd, int c, int d, int k) {
  return batch > 0 && h > 0 && wd > 0 && c > 0 && d > 0 && k > 0 && pool >= kMax2 &&
         pool <= kNone && d == flat_dim(pool, h, wd, c);
}

template <class E>
int forward_entry(const E* x, const E* w, const E* b, const long long* labels, float* loss,
                  float* dl, int batch, int h, int wd, int c, int d, int k, int pool,
                  void* stream) {
  if (!valid(batch, pool, h, wd, c, d, k)) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(pool, d, k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && c % (pool == kGap ? ImageUnit<kGap, E>::value
                                                   : ImageUnit<kMax2, E>::value) == 0;
  if (pool == kGap)
    return launch_pool<kGap>(vec, x, w, b, labels, loss, dl, batch, h, wd, c, d, k, smem, s);
  if (pool == kMax2)
    return launch_pool<kMax2>(vec, x, w, b, labels, loss, dl, batch, h, wd, c, d, k, smem, s);
  return launch_pool<kNone>(vec, x, w, b, labels, loss, dl, batch, h, wd, c, d, k, smem, s);
}

// ---------------------------------------------------------------------------
// The tiled form
// ---------------------------------------------------------------------------

// Pass 1, gap: block (image, range of channel units). A thread sums one
// unit over one of `groups` position ranges (of ceil(P / groups)
// positions), its loads issued TAIL_SEG at once; the ranges' sums are added
// in range order. f32 stores the sum, bf16 the mean rounded to bf16.
template <bool VEC, class E>
__global__ void __launch_bounds__(POOL_THREADS)
tail_gap_pass(const E* __restrict__ x, E* __restrict__ pooled, int positions, int c,
              int groups) {
  griddep_launch_dependents();  // the FC may be scheduled; it waits for this grid
  constexpr int N = VEC ? 16 / sizeof(E) : 1;
  using Raw = typename Unit<E, N>::Raw;
  __shared__ float part[POOL_THREADS * N];
  const int per_block = POOL_THREADS / groups;  // units a block
  const int g = threadIdx.x / per_block;
  const int ul = threadIdx.x - g * per_block;
  const int u = blockIdx.y * per_block + ul;
  const int units = c / N;
  const long long n = blockIdx.x;
  const int span = (positions + groups - 1) / groups;
  const int p_begin = g * span;
  const int p_end = min(positions, p_begin + span);
  float sum[N];
#pragma unroll
  for (int i = 0; i < N; ++i) sum[i] = 0.0f;
  if (u < units) {
    const E* xu = x + n * positions * c + u * N;
    for (int p = p_begin; p < p_end; p += TAIL_SEG) {
      Raw v[TAIL_SEG];
#pragma unroll
      for (int q = 0; q < TAIL_SEG; ++q)
        if (p + q < p_end) v[q] = ld_raw<E, N>(xu + static_cast<long long>(p + q) * c);
#pragma unroll
      for (int q = 0; q < TAIL_SEG; ++q) {
        if (p + q < p_end) {
          float f[N];
          widen<E, N>(v[q], f);
#pragma unroll
          for (int i = 0; i < N; ++i) sum[i] += f[i];
        }
      }
    }
  }
  if (groups > 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) part[threadIdx.x * N + i] = sum[i];
    __syncthreads();
    if (g != 0) return;
    for (int r = 1; r < groups; ++r) {
#pragma unroll
      for (int i = 0; i < N; ++i) sum[i] += part[(r * per_block + ul) * N + i];
    }
  }
  if (u >= units) return;
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    const float inv = 1.0f / static_cast<float>(positions);
#pragma unroll
    for (int i = 0; i < N; ++i) sum[i] *= inv;
  }
  *reinterpret_cast<Raw*>(pooled + n * c + u * N) = pack<E, N>(sum);
}

// Pass 1, max2: a thread an output unit (N channels of one window), its
// four taps loaded first; maxima are exact in either dtype.
template <bool VEC, class E>
__global__ void __launch_bounds__(POOL_THREADS)
tail_max2_pass(const E* __restrict__ x, E* __restrict__ pooled, int h, int wd, int c, int d) {
  griddep_launch_dependents();
  constexpr int N = VEC ? 16 / sizeof(E) : 1;
  using Raw = typename Unit<E, N>::Raw;
  const int u = blockIdx.y * POOL_THREADS + threadIdx.x;
  if (u >= d / N) return;
  const long long n = blockIdx.x;
  const int e = u * N;
  const int ch = e % c;
  const int p = e / c;
  const int pw = wd / 2;
  const int py = p / pw;
  const int px = p - py * pw;
  const E* xq = x + n * h * wd * c + (static_cast<long long>(2 * py) * wd + 2 * px) * c + ch;
  const long long row = static_cast<long long>(wd) * c;
  const Raw r0 = ld_raw<E, N>(xq), r1 = ld_raw<E, N>(xq + c);
  const Raw r2 = ld_raw<E, N>(xq + row), r3 = ld_raw<E, N>(xq + row + c);
  float v0[N], v1[N], v2[N], v3[N];
  widen<E, N>(r0, v0);
  widen<E, N>(r1, v1);
  widen<E, N>(r2, v2);
  widen<E, N>(r3, v3);
#pragma unroll
  for (int i = 0; i < N; ++i) v0[i] = fmaxf(fmaxf(v0[i], v1[i]), fmaxf(v2[i], v3[i]));
  *reinterpret_cast<Raw*>(pooled + n * d + e) = pack<E, N>(v0);
}

// A ring slot of the FC: STAGE_F rows of the w tile (TILE_K classes) and
// TILE_B rows of pooled values (STAGE_F features, padded by 4 floats so a
// warp's two image quads read distinct banks), in f32 whatever the dtype;
// for bf16 also the raw rows as they arrive.
constexpr int W_LD = TILE_K;
constexpr int P_LD = STAGE_F + 4;
constexpr int W_FLOATS = STAGE_F * W_LD;
constexpr int SLOT_FLOATS = W_FLOATS + TILE_B * P_LD;

template <class E> struct FcRing {
  static constexpr bool RAW = std::is_same<E, __nv_bfloat16>::value;
  static constexpr int W_RAW = RAW ? STAGE_F * TILE_K : 0;  // bf16 values
  static constexpr int P_RAW = RAW ? TILE_B * STAGE_F : 0;
  static constexpr int SLOT_BYTES = SLOT_FLOATS * 4 + (W_RAW + P_RAW) * 2;
  static constexpr int BYTES = FC_STAGES * SLOT_BYTES;
  static_assert(SLOT_BYTES % 16 == 0, "16-byte slots");
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(ftile::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// One operand's share of a ring slot: ROWS x COLS values of a row-major
// global matrix (row stride `ld`), rows from r0 valid below r_end, columns
// from c0 valid below c_end, into the slot's f32 rows of stride DST_LD;
// zero where not valid. VEC (c_end, ld and c0 multiples of 16 bytes' worth
// and src on a 16-byte boundary): 16-byte cp.async copies, straight into
// the f32 rows for f32; for bf16 into the raw rows, which `land` widens
// into the f32 rows once the copies arrived (cp.async cannot widen, and
// widening once here spares each of the slot's readers a conversion).
// Else one value at a time, loaded, widened and stored by `issue`.
template <int ROWS, int COLS, int DST_LD, bool VEC, class E>
struct SlotCopy {
  static constexpr int EPV = 16 / sizeof(E);
  static constexpr int PER_ROW = COLS / EPV;
  static constexpr int CHUNKS = ROWS * PER_ROW / FC_THREADS;  // a thread's 16-byte copies
  static constexpr bool RAW = VEC && std::is_same<E, __nv_bfloat16>::value;
  static_assert(ROWS * PER_ROW % FC_THREADS == 0, "whole copies a thread");

  __device__ __forceinline__ static void issue(float* dst, E* raw, const E* src, long long ld,
                                               int r0, int r_end, int c0, int c_end) {
    const int tid = threadIdx.x;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int idx = tid + i * FC_THREADS;
        const int r = idx / PER_ROW;
        const int q = idx - r * PER_ROW;
        const bool ok = r0 + r < r_end && c0 + q * EPV < c_end;
        const E* at = ok ? src + (r0 + r) * ld + c0 + q * EPV : src;
        if constexpr (RAW) {
          cp16(raw + r * COLS + q * EPV, at, ok);
        } else {
          cp16(dst + r * DST_LD + q * EPV, at, ok);
        }
      }
    } else {
      for (int idx = tid; idx < ROWS * COLS; idx += FC_THREADS) {
        const int r = idx / COLS;
        const int q = idx - r * COLS;
        float v = 0.0f;
        if (r0 + r < r_end && c0 + q < c_end) {
          float f[1];
          widen<E, 1>(ld_raw<E, 1>(src + (r0 + r) * ld + c0 + q), f);
          v = f[0];
        }
        dst[r * DST_LD + q] = v;
      }
    }
  }

  // bf16: this thread's copies of the slot, arrived, widened into its f32
  // rows (the barrier after shows them to the other threads).
  __device__ __forceinline__ static void land(float* dst, const E* raw) {
    if constexpr (RAW) {
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int idx = threadIdx.x + i * FC_THREADS;
        const int r = idx / PER_ROW;
        const int q = idx - r * PER_ROW;
        float v[8];
        widen<E, 8>(*reinterpret_cast<const uint4*>(raw + r * COLS + q * EPV), v);
        sts_unit(dst + r * DST_LD + q * EPV, v);
      }
    }
  }
};

// Pass 2: partial[chunk, n, j] = sum over the chunk's features f, in
// ascending order, of p[n, f] * w[f, j], for a TILE_K x TILE_B tile of
// (j, n). p is pass 1's pooled rows, or x itself for none. VEC: 16-byte
// copies (K and D multiples of 16 bytes' worth, w and p on 16-byte
// boundaries); else one value at a time. The ring holds FC_STAGES - 1
// slots in flight: a chunk of up to that many slots is asked for at once.
template <bool VEC, class E>
__global__ void __launch_bounds__(FC_THREADS)
tail_fc_kernel(const E* __restrict__ w, const E* __restrict__ p, float* __restrict__ partial,
               int batch, int d, int k, int chunk_features) {
  using R = FcRing<E>;
  using WCopy = SlotCopy<STAGE_F, TILE_K, W_LD, VEC, E>;  // w: rows f, columns j
  using PCopy = SlotCopy<TILE_B, STAGE_F, P_LD, VEC, E>;  // p: rows n, columns f
  extern __shared__ float4 ring4[];
  char* ring = reinterpret_cast<char*>(ring4);
  const int tid = threadIdx.x;
  const int cq = tid % 16;  // classes k0 + 4 cq ...
  const int iq = tid / 16;  // images n0 + 4 iq ...
  const int k0 = blockIdx.x * TILE_K;
  const int chunk = blockIdx.y;
  const int n0 = blockIdx.z * TILE_B;
  const int f_begin = chunk * chunk_features;
  const int f_end = min(d, f_begin + chunk_features);
  const int stages = (f_end - f_begin + STAGE_F - 1) / STAGE_F;
  // Slot s: its f32 w rows, then its f32 p rows, then (bf16) the raw ones.
  auto w32 = [&](int s) {
    return reinterpret_cast<float*>(ring + (s % FC_STAGES) * R::SLOT_BYTES);
  };
  auto wraw = [&](int s) { return reinterpret_cast<E*>(w32(s) + SLOT_FLOATS); };
  auto issue_w = [&](int s) {
    WCopy::issue(w32(s), wraw(s), w, k, f_begin + s * STAGE_F, f_end, k0, k);
  };
  auto issue_p = [&](int s) {
    const int f0 = f_begin + s * STAGE_F;
    PCopy::issue(w32(s) + W_FLOATS, wraw(s) + R::W_RAW, p + f0, d, n0, batch, 0, f_end - f0);
  };

  // w needs nothing of pass 1: its first slots go out before the wait.
  for (int s = 0; s < FC_STAGES - 1 && s < stages; ++s) issue_w(s);
  griddep_wait();
  for (int s = 0; s < FC_STAGES - 1; ++s) {
    if (s < stages) issue_p(s);
    ftile::cp_async_commit();  // group s: slot s (group 0 also every early w slot)
  }
  griddep_launch_dependents();  // the finish may be scheduled; it waits for this grid

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.0f;

  for (int s = 0; s < stages; ++s) {
    ftile::cp_async_wait<FC_STAGES - 2>();  // this thread's copies of slot s arrived
    WCopy::land(w32(s), wraw(s));
    PCopy::land(w32(s) + W_FLOATS, wraw(s) + R::W_RAW);
    __syncthreads();  // slot s ready for all; slot s - 1 is free
    const int next = s + FC_STAGES - 1;
    if (next < stages) {
      issue_w(next);
      issue_p(next);
    }
    ftile::cp_async_commit();
    const float* ws = w32(s);
    const float* ps = ws + W_FLOATS;
#pragma unroll
    for (int f4 = 0; f4 < STAGE_F; f4 += 4) {
      float pv[4][4];  // [image][feature]
      float wv[4][4];  // [feature][class]
#pragma unroll
      for (int r = 0; r < 4; ++r) lds4(ps + (4 * iq + r) * P_LD + f4, pv[r]);
#pragma unroll
      for (int ff = 0; ff < 4; ++ff) lds4(ws + (f4 + ff) * W_LD + 4 * cq, wv[ff]);
#pragma unroll
      for (int ff = 0; ff < 4; ++ff)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(pv[r][ff], wv[ff][cc], acc[r][cc]);
    }
  }

  const long long plane = static_cast<long long>(batch) * k;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int nn = n0 + 4 * iq + r;
    if (nn >= batch) continue;
    float* out = partial + chunk * plane + static_cast<long long>(nn) * k;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = k0 + 4 * cq + cc;
      if (j < k) out[j] = acc[r][cc];
    }
  }
}

// Block-wide max or sums in a fixed order: each warp's xor butterfly, the
// warps' values to shared memory, then every warp runs the same butterfly
// over them (lane i holding warp i's), so each thread gets the result with
// one barrier. V values at once; `red` holds 32 a value.
template <bool MAX, int V>
__device__ __forceinline__ void block_reduce(float (&v)[V], float* red) {
  constexpr int WARPS = FIN_THREADS / 32;
  static_assert(WARPS <= 32, "one value a lane");
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] = MAX ? warp_max(v[i]) : warp_sum(v[i]);
    if (lane == 0) red[i * 32 + threadIdx.x / 32] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float idle = MAX ? __int_as_float(0xff800000) : 0.0f;  // -inf, or 0
    const float r = lane < WARPS ? red[i * 32 + lane] : idle;
    v[i] = MAX ? warp_max(r) : warp_sum(r);
  }
  __syncthreads();  // red is written again by the next reduction
}

// Pass 3: a block a row, a class a thread (K <= FIN_THREADS; past that,
// every FIN_THREADS-th). A class's chunk partials are loaded at once and
// summed in chunk order. The row's logits wait for the softmax in shared
// memory (`zrow`, when K <= FIN_SMEM_CLASSES) or in its dlogits row
// (each value read back by the thread that wrote it).
template <class E>
__global__ void __launch_bounds__(FIN_THREADS)
tail_finish_kernel(const float* __restrict__ partial, const E* __restrict__ b,
                   const long long* __restrict__ labels, float* __restrict__ loss,
                   float* __restrict__ dl, int batch, int k, int chunks, float scale) {
  extern __shared__ float zrow[];
  __shared__ float red[2 * 32];
  const int tid = threadIdx.x;
  const long long n = blockIdx.x;
  const long long y = __ldg(labels + n);
  const float b0 = tid < k ? raw1(ld_raw1(b + tid)) : 0.0f;  // needs nothing of pass 2
  griddep_wait();
  const long long plane = static_cast<long long>(batch) * k;
  float* dln = dl + n * k;
  float* z = k <= FIN_SMEM_CLASSES ? zrow : dln;
  float m = __int_as_float(0xff800000);  // -inf
  for (int j = tid; j < k; j += FIN_THREADS) {
    const float* pj = partial + n * k + j;
    float s = -0.0f;  // -0 + v is v: the sum is v0 + v1 + ... in chunk order
    for (int c0 = 0; c0 < chunks; c0 += FIN_LOADS) {
      float v[FIN_LOADS];
#pragma unroll
      for (int i = 0; i < FIN_LOADS; ++i)
        if (c0 + i < chunks) v[i] = pj[(c0 + i) * plane];
#pragma unroll
      for (int i = 0; i < FIN_LOADS; ++i)
        if (c0 + i < chunks) s += v[i];
    }
    const float zj = (j == tid ? b0 : raw1(ld_raw1(b + j))) + scale * s;
    z[j] = zj;
    m = fmaxf(m, zj);
  }
  float top[1] = {m};
  block_reduce<true>(top, red);
  m = top[0];
  float sums[2] = {0.0f, 0.0f};  // the sum of the e_k, the label's logit
  float& se = sums[0];
  float& ly = sums[1];
  for (int j = tid; j < k; j += FIN_THREADS) {
    const float zj = z[j];
    if (j == y) ly = zj;
    const float e = expf(zj - m);
    z[j] = e;
    se += e;
  }
  block_reduce<false>(sums, red);  // at most one thread holds the label's logit
  if (tid == 0) loss[n] = (logf(se) + m) - ly;
  for (int j = tid; j < k; j += FIN_THREADS) dln[j] = z[j] / se - (j == y ? 1.0f : 0.0f);
}

// A launch of KERNEL on `s`, as a programmatic dependent of the kernel
// before it when `dependent` (it then waits for that kernel in
// griddepcontrol.wait). Once per kernel, it asks for the SM's largest
// shared-memory split: an SM still running one pass then has room for the
// next pass's blocks, which otherwise waited for it to drain and change
// its split.
template <auto KERNEL, class... Args>
cudaError_t launch_on(dim3 grid, dim3 block, size_t smem, cudaStream_t s, bool dependent,
                      Args... args) {
  static const cudaError_t split = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (split != cudaSuccess) return split;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = dependent ? attr : nullptr;
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, KERNEL, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The FC's ring is dynamic shared memory past the 48 KB a block gets
// unasked: asked for once a kernel.
template <auto KERNEL, int BYTES>
cudaError_t opt_in() {
  static const cudaError_t e =
      cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  return e;
}

template <class E>
int tiled_entry(const E* x, const E* w, const E* b, const long long* labels, E* pooled,
                float* partial, float* loss, float* dl, int batch, int h, int wd, int c, int d,
                int k, int pool, int chunk_features, int pos_groups, void* stream) {
  constexpr int EPV = 16 / sizeof(E);
  const bool groups_ok = pos_groups == 1 || pos_groups == 2 || pos_groups == 4 ||
                         pos_groups == MAX_POS_GROUPS;
  if (!valid(batch, pool, h, wd, c, d, k) || chunk_features <= 0 ||
      chunk_features % STAGE_F != 0 || !groups_ok || (pool != kNone && pooled == nullptr) ||
      !aligned16(partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (d + chunk_features - 1) / chunk_features;
  cudaError_t e = cudaSuccess;
  if (pool != kNone) {
    const bool vec = aligned16(x) && aligned16(pooled) && c % EPV == 0;
    const int n_unit = vec ? EPV : 1;
    if (pool == kGap) {
      const int per_block = POOL_THREADS / pos_groups;
      const dim3 grid(batch, (c / n_unit + per_block - 1) / per_block);
      e = vec ? launch_on<tail_gap_pass<true, E>>(grid, POOL_THREADS, 0, s, false, x, pooled,
                                                  h * wd, c, pos_groups)
              : launch_on<tail_gap_pass<false, E>>(grid, POOL_THREADS, 0, s, false, x, pooled,
                                                   h * wd, c, pos_groups);
    } else {
      const dim3 grid(batch, (d / n_unit + POOL_THREADS - 1) / POOL_THREADS);
      e = vec ? launch_on<tail_max2_pass<true, E>>(grid, POOL_THREADS, 0, s, false, x, pooled, h,
                                                   wd, c, d)
              : launch_on<tail_max2_pass<false, E>>(grid, POOL_THREADS, 0, s, false, x, pooled,
                                                    h, wd, c, d);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const E* src = pool == kNone ? x : pooled;
  const bool fvec = aligned16(w) && aligned16(src) && k % EPV == 0 && d % EPV == 0;
  const dim3 fgrid((k + TILE_K - 1) / TILE_K, chunks, (batch + TILE_B - 1) / TILE_B);
  const bool after_pool = pool != kNone;
  constexpr int ring = FcRing<E>::BYTES;
  e = fvec ? opt_in<tail_fc_kernel<true, E>, ring>() : opt_in<tail_fc_kernel<false, E>, ring>();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = fvec ? launch_on<tail_fc_kernel<true, E>>(fgrid, FC_THREADS, ring, s, after_pool, w,
                                                src, partial, batch, d, k, chunk_features)
           : launch_on<tail_fc_kernel<false, E>>(fgrid, FC_THREADS, ring, s, after_pool, w,
                                                 src, partial, batch, d, k, chunk_features);
  if (e != cudaSuccess) return static_cast<int>(e);
  // f32 gap: pass 1 stored the sum; the mean's 1/(H*W) scales the logits.
  const float scale =
      pool == kGap && std::is_same<E, float>::value ? 1.0f / static_cast<float>(h * wd) : 1.0f;
  const size_t zbytes = k <= FIN_SMEM_CLASSES ? static_cast<size_t>(k) * sizeof(float) : 0;
  e = launch_on<tail_finish_kernel<E>>(dim3(batch), FIN_THREADS, zbytes, s, true, partial, b,
                                       labels, loss, dl, batch, k, chunks, scale);
  return static_cast<int>(e);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers: x
// (B,H,W,C), w (D,K), b (K,), labels (B,) int64; loss (B,) and dl (B,K) are
// written in full. pool: 0 max2, 1 gap, 2 none. Each returns 0 when every
// launch was accepted, else the cudaError_t.
//
// The per-image form. The wrapper keeps the pooled row and the logits
// within the 48 KB a block gets by default; the partial logits of the
// block's threads can take the block past it (by at most 1 KB), and the
// launch then opts in (cudaFuncSetAttribute).
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

// The tiled form, three launches. Scratch from the caller: pooled (B, D)
// in x's dtype (unused, and may be null, for none) and partial (chunks, B,
// K) f32 on a 16-byte boundary, chunks = ceil(D / chunk_features);
// chunk_features a multiple of 32, pos_groups 1, 2, 4 or 8 (the plan's).
extern "C" int tail_ce_forward_tiled(const float* x, const float* w, const float* b,
                                     const long long* labels, float* pooled, float* partial,
                                     float* loss, float* dl, int batch, int h, int wd, int c,
                                     int d, int k, int pool, int chunk_features, int pos_groups,
                                     void* stream) {
  return tiled_entry(x, w, b, labels, pooled, partial, loss, dl, batch, h, wd, c, d, k, pool,
                     chunk_features, pos_groups, stream);
}

extern "C" int tail_ce_forward_tiled_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                          const __nv_bfloat16* b, const long long* labels,
                                          __nv_bfloat16* pooled, float* partial, float* loss,
                                          float* dl, int batch, int h, int wd, int c, int d,
                                          int k, int pool, int chunk_features, int pos_groups,
                                          void* stream) {
  return tiled_entry(x, w, b, labels, pooled, partial, loss, dl, batch, h, wd, c, d, k, pool,
                     chunk_features, pos_groups, stream);
}
