// The eight Mosaic probes of benches/mosaic_probe.py, written for Hopper
// (sm_90a) and bound to Python through ctypes. On the TPU each probe was a
// small Pallas kernel that asked whether Mosaic lowers one form of a
// production kernel, and how fast that form ran; here each is a kernel that
// computes what the TPU kernel computes, on row-major CUDA memory, so the
// card can time the same forms against each other.
//
//   entry point            replaces (benches/mosaic_probe.py)
//   probe_rank3_dot        :62  probe_rank3_dot.kernel (call :72)
//   probe_lane_merge       :79  probe_lane_merge.kernel (call :83)
//   probe_lane_split       :90  probe_lane_split.kernel (call :94)
//   probe_mxu_conv_L       :100 _mxu_conv_L_kernel (probe_mxu_conv_L :141)
//   probe_vpu_conv         :107 _vpu_conv_kernel (probe_vpu_conv_baseline :153)
//   probe_mxu_conv_3d      :116 _mxu_conv_3d_kernel (probe_mxu_conv_3d :129)
//   probe_pair_dot         :168 _pair_dot_kernel (probe_pair_dot_laneslice :180)
//   probe_two_dot          :189 _two_dot_kernel (probe_two_dot_baseline :202)
//
// Probes that differed on the TPU are one computation on row-major memory,
// and share one __global__ through separate entry points (the wrappers
// count each entry point's launches on its own):
//
// - lane-merge (25,bb,576) -> (25,bb*576) and lane-split (1,L) -> (bb,576)
//   are both a flat copy of contiguous f32: copy_kernel.
// - mxu-conv-L (6,25)x(25,L) and mxu-conv-3d (6,25)x(25,bb,576) contract the
//   same bytes: conv_contract_kernel, with L = bb*576.
//
// vpu-conv keeps its own per-filter form (per_filter_conv_kernel): one pass
// of 25 multiply-adds for each filter, each op rounded on its own
// (__fmul_rn/__fadd_rn), as _vpu_conv_kernel loops `acc += w[m,t]*x[t]`.
// conv_contract_kernel reads each x column once, CONTRACT_COLS columns a
// thread in one wide load a tap, and keeps all 6 filters' sums in
// registers, one fma per tap. The pair is the probe's question on
// this card: B1's conv form against the one-contraction form.
//
// Types follow JAX's promotion: in the three conv probes w is f32 and x is
// bf16, widened exactly (__bfloat162float) and multiplied in f32; in the
// pair and two-dot probes x and w are bf16 with f32 products and sums
// (preferred_element_type=f32), which is what bf16 wgmma computes: a bf16
// product is exact in f32. Every sum is taken in a fixed order per output,
// with no atomics: a relaunch is bit-identical.
//
// Bounds on an H100 SXM (3.35 TB/s; f32 67 TFLOP/s outside the tensor
// cores; bf16 989 TFLOP/s), at the probes' shapes, every one set by bytes:
//   rank3-dot  327,680 B (4.2 MFLOP f32)          0.098 us
//   lane-merge 14,745,600 B                        4.40 us
//   lane-split 589,824 B                           0.18 us
//   the convs  5,456,472 B (22.1 MFLOP f32)        1.63 us
//   the dots   409,600 B (16.8 MFLOP bf16)         0.122 us
// lane-merge's bound is its bytes at the HBM rate, which describes a cold
// copy: the probe's repeated call finds its 14.7 MB warm in the 50 MB L2.
// Every probe but lane-merge moves so little that a launch's latency sets
// its time. B14-B19 run on the CUDA cores.
//
// B20 (pair-dot, _pair_dot_kernel) and B21 (two-dot, _two_dot_kernel) run
// on the tensor cores, through csrc/wgmma_tile.cuh. Their time is launch
// and latency, not bytes (0.122 us) or operations (0.017 us): one
// (rows, 64) . (64, 128) product is 16.8 MFLOP. So the design keeps a
// block's critical path short: one warpgroup per 64-row tile of x
// (16 blocks at 1,024 rows; the fewest threads wgmma takes, and no
// split of N, which would part B20's halves), one TMA round trip that
// brings x's tile (8 KB, one 128-byte swizzle row per row of x, ragged
// rows zero-filled) and all of w (two 64 x 64 boxes, its column halves,
// 16 KB) onto one mbarrier, then 4 or 8 wgmmas and the stores. The
// forms differ as they did on the TPU:
// - B20: one chain of four m64n128k16 (K = 4 x 16), w's two halves side
//   by side along N, so each thread holds both halves of its columns
//   (registers i and i + 32) and adds them in registers.
// - B21: two chains of four m64n64k16, one per half (the descriptor based
//   at that half's box), into two accumulators that are then added.
// Each output takes the same four k16 steps for each half in both forms.
// w is N-contiguous (MN-major for wgmma's B). It stays so in shared
// memory and wgmma reads it with its transpose-B flag: a K-major copy would
// cost a pass of all 128 threads through shared memory and a barrier on
// the critical path, for nothing the flag does not give. The stores go
// straight from the fragment: each thread writes float2 pairs, a warp's
// store fills 8 rows x 32 bytes (whole 32-byte sectors), rows past the
// end masked. The tensor maps hold the pointers, so the host encodes them
// on every call (cuTensorMapEncodeTiled, reached through the runtime; no
// -lcuda) and passes them as __grid_constant__ parameters.
//
// The kernels launch on the caller's stream, synchronise nothing and
// allocate nothing: the Python wrapper (ops/mosaic_probe.py) allocates the
// outputs and checks devices, dtypes, shapes and contiguity first. Each
// entry point returns 0 for a launch that was accepted, else the
// cudaError_t (cudaErrorInvalidValue for sizes it refuses).

#include <atomic>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_tile.cuh"

namespace {

constexpr int TAPS = 25;      // 5x5 conv taps
constexpr int FILTERS = 6;    // conv output channels
constexpr int PAIR_K = 64;    // depth of the pair and two-dot products
constexpr int PAIR_N = 64;    // width of each half of their w (2*PAIR_N)

// ---------------------------------------------------------------------------
// rank3-dot: out[b] = a[b] @ b[b] over a leading batch dim, f32.
// One 16x16 block per (batch, output tile); both operands' K slabs staged
// in shared memory, one fma per product in k order.
// ---------------------------------------------------------------------------

constexpr int TILE = 16;

__global__ void __launch_bounds__(TILE * TILE)
batched_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int m, int k, int n) {
  __shared__ float as[TILE][TILE + 1];
  __shared__ float bs[TILE][TILE + 1];
  const long long batch = blockIdx.z;
  const int row = blockIdx.y * TILE + threadIdx.y;
  const int col = blockIdx.x * TILE + threadIdx.x;
  const float* ab = a + batch * m * k;
  const float* bb = b + batch * k * n;
  float acc = 0.f;
  for (int k0 = 0; k0 < k; k0 += TILE) {
    const int ka = k0 + threadIdx.x;
    const int kb = k0 + threadIdx.y;
    as[threadIdx.y][threadIdx.x] =
        (row < m && ka < k) ? ab[static_cast<long long>(row) * k + ka] : 0.f;
    bs[threadIdx.y][threadIdx.x] =
        (kb < k && col < n) ? bb[static_cast<long long>(kb) * n + col] : 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      acc = fmaf(as[threadIdx.y][j], bs[j][threadIdx.x], acc);
    }
    __syncthreads();
  }
  if (row < m && col < n) {
    out[(batch * m + row) * n + col] = acc;
  }
}

// ---------------------------------------------------------------------------
// lane-merge, lane-split: a flat copy of n contiguous f32 values.
// The copy is a block's chunk of COPY_THREADS * COPY_UNROLL float4s at a
// time: each thread issues its COPY_UNROLL 16-byte loads, COPY_THREADS
// apart, before it stores any, so their latencies overlap and a warp's
// accesses stay 512 contiguous bytes; a block reads 4 KB in one run. The
// grid is one block a chunk, capped at one wave (from the SM count and the
// occupancy API, once per device): the probes' sizes fit exactly, B16's
// 18,432 float4s in 72 blocks, B15's 460,800 in 1,800 (of 2,112 resident).
// (A sweep on an H100 against copy_ in turns found 2 loads in flight a
// thread faster than 1, 4 or 8 at these sizes, and Hopper's bulk copy
// engine through shared memory, and streaming-store hints, slower.)
// With VEC, src + head and dst + head lie on a 16-byte boundary (the host
// found both equally misaligned, head < 4): the first `head` values and
// the last (n - head) % 4 go by scalar copies, the rest as float4s.
// Without VEC (src and dst misaligned differently) the same chunks move
// one float a load.
// ---------------------------------------------------------------------------

constexpr int COPY_THREADS = 128;
constexpr int COPY_UNROLL = 2;
constexpr int COPY_CHUNK = COPY_THREADS * COPY_UNROLL;

template <bool VEC>
__global__ void __launch_bounds__(COPY_THREADS)
copy_kernel(const float* __restrict__ src, float* __restrict__ dst, long long n, int head) {
  const int t = threadIdx.x;
  if (VEC && blockIdx.x == 0 && t < head) dst[t] = src[t];
  using V = typename std::conditional<VEC, float4, float>::type;
  const long long items = VEC ? (n - head) >> 2 : n;
  const V* s = reinterpret_cast<const V*>(src + head);
  V* d = reinterpret_cast<V*>(dst + head);
  for (long long base = static_cast<long long>(blockIdx.x) * COPY_CHUNK; base < items;
       base += static_cast<long long>(gridDim.x) * COPY_CHUNK) {
    V v[COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u)
      if (base + u * COPY_THREADS + t < items) v[u] = __ldg(s + base + u * COPY_THREADS + t);
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u)
      if (base + u * COPY_THREADS + t < items) d[base + u * COPY_THREADS + t] = v[u];
  }
  if (VEC && blockIdx.x == 0) {
    const long long tail = head + (items << 2);
    if (t < n - tail) dst[tail + t] = src[tail + t];
  }
}

// ---------------------------------------------------------------------------
// The convs. x is (25, l) tap-major bf16 (l = bb*576 for the 3-D probes),
// w (6, 25) f32, out (6, l) f32.
// ---------------------------------------------------------------------------

constexpr int CONV_THREADS = 256;

// mxu-conv-L and mxu-conv-3d: a thread takes CONTRACT_COLS consecutive
// columns, blocks of CONTRACT_THREADS. Its 25 taps' loads go out before
// w is staged and before the first fma, so the kernel waits on one round
// trip to memory (the parent's thread staged w, waited at the barrier,
// then loaded x: two): in the wide body one CONTRACT_COLS * 2-byte load a
// tap (8 bytes at 4 columns: a warp's request is 256 contiguous bytes of a
// row, where one thread a column made it 64), and each filter's outputs
// leave as float4 stores. The wide body needs every row of x and of out on
// its boundary: l a multiple of CONTRACT_COLS, x on a CONTRACT_COLS * 2-byte
// boundary and out on a 16-byte one, which the host checks; otherwise (an
// odd l such as 1003, a view of x at an odd offset) the narrow body reads
// and writes one value at a time, with the ragged last columns masked.
// Every output is acc = fmaf(w[m,t], x[t,col], acc) over t = 0..24 from 0,
// so both bodies, and every CONTRACT_COLS, give the parent kernel's bits
// (one thread a column, the same fmas).
constexpr int CONTRACT_THREADS = 64;
constexpr int CONTRACT_COLS = 4;
static_assert(CONTRACT_COLS == 4 || CONTRACT_COLS == 8, "float4 stores of whole quads");

// CONTRACT_COLS bf16 values in one load.
template <int COLS> struct Bf16Run;
template <> struct Bf16Run<4> { using type = uint2; };
template <> struct Bf16Run<8> { using type = uint4; };

// The two bf16 values of a 32-bit word, widened exactly (bf16 is the top
// half of an f32), the lower address first.
__device__ __forceinline__ void widen2(unsigned v, float* f) {
  f[0] = __uint_as_float(v << 16);
  f[1] = __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ void widen(uint2 v, float* f) { widen2(v.x, f); widen2(v.y, f + 2); }
__device__ __forceinline__ void widen(uint4 v, float* f) {
  widen2(v.x, f);
  widen2(v.y, f + 2);
  widen2(v.z, f + 4);
  widen2(v.w, f + 6);
}

template <bool WIDE>
__global__ void __launch_bounds__(CONTRACT_THREADS)
conv_contract_kernel(const float* __restrict__ w,
                     const __nv_bfloat16* __restrict__ x,
                     float* __restrict__ out, long long l) {
  const long long c0 =
      (static_cast<long long>(blockIdx.x) * CONTRACT_THREADS + threadIdx.x) * CONTRACT_COLS;
  using Run = typename Bf16Run<CONTRACT_COLS>::type;
  Run raw[TAPS];
  if (WIDE && c0 < l) {
#pragma unroll
    for (int t = 0; t < TAPS; ++t) raw[t] = __ldg(reinterpret_cast<const Run*>(x + t * l + c0));
  }
  __shared__ float ws[FILTERS * TAPS];
  for (int i = threadIdx.x; i < FILTERS * TAPS; i += CONTRACT_THREADS) ws[i] = w[i];
  __syncthreads();
  if (c0 >= l) return;
  float acc[FILTERS][CONTRACT_COLS];
#pragma unroll
  for (int m = 0; m < FILTERS; ++m)
#pragma unroll
    for (int q = 0; q < CONTRACT_COLS; ++q) acc[m][q] = 0.f;
  if (WIDE) {
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      float xv[CONTRACT_COLS];
      widen(raw[t], xv);
#pragma unroll
      for (int m = 0; m < FILTERS; ++m)
#pragma unroll
        for (int q = 0; q < CONTRACT_COLS; ++q)
          acc[m][q] = fmaf(ws[m * TAPS + t], xv[q], acc[m][q]);
    }
#pragma unroll
    for (int m = 0; m < FILTERS; ++m)
#pragma unroll
      for (int q = 0; q < CONTRACT_COLS; q += 4)
        *reinterpret_cast<float4*>(out + m * l + c0 + q) =
            make_float4(acc[m][q], acc[m][q + 1], acc[m][q + 2], acc[m][q + 3]);
    return;
  }
  const int cols = l - c0 < CONTRACT_COLS ? static_cast<int>(l - c0) : CONTRACT_COLS;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    float xv[CONTRACT_COLS];
#pragma unroll
    for (int q = 0; q < CONTRACT_COLS; ++q)
      xv[q] = q < cols ? __bfloat162float(x[t * l + c0 + q]) : 0.f;
#pragma unroll
    for (int m = 0; m < FILTERS; ++m)
#pragma unroll
      for (int q = 0; q < CONTRACT_COLS; ++q)
        acc[m][q] = fmaf(ws[m * TAPS + t], xv[q], acc[m][q]);
  }
#pragma unroll
  for (int m = 0; m < FILTERS; ++m)
#pragma unroll
    for (int q = 0; q < CONTRACT_COLS; ++q)
      if (q < cols) out[m * l + c0 + q] = acc[m][q];
}

// vpu-conv: blockIdx.y is the filter; one pass of 25 multiply-adds over the
// taps per (filter, column), each product and each sum rounded on its own,
// so the result is the plain version's bit for bit.
__global__ void __launch_bounds__(CONV_THREADS)
per_filter_conv_kernel(const float* __restrict__ w,
                       const __nv_bfloat16* __restrict__ x,
                       float* __restrict__ out, long long l) {
  __shared__ float ws[TAPS];
  const int m = blockIdx.y;
  if (threadIdx.x < TAPS) ws[threadIdx.x] = w[m * TAPS + threadIdx.x];
  __syncthreads();
  const long long col =
      static_cast<long long>(blockIdx.x) * CONV_THREADS + threadIdx.x;
  if (col >= l) return;
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    acc = __fadd_rn(acc, __fmul_rn(ws[t], __bfloat162float(x[t * l + col])));
  }
  out[m * l + col] = acc;
}

// ---------------------------------------------------------------------------
// pair-dot and two-dot: out[r,n] = sum_k x[r,k] w[k,n] + sum_k x[r,k] w[k,64+n]
// for x (rows, 64) and w (64, 128) bf16, out (rows, 64) f32, on the tensor
// cores (see the header). PAIRED picks the form: one m64n128 chain with the
// halves added in registers (B20), or two m64n64 chains (B21).
// ---------------------------------------------------------------------------

constexpr int X_TILE_BYTES = wgtile::M * PAIR_K * 2;   // 8 KB
constexpr int W_HALF_BYTES = PAIR_K * PAIR_N * 2;      // 8 KB: one 64 x 64 box
constexpr int PAIR_STEPS = PAIR_K / wgtile::K_STEP;    // 4

template <bool PAIRED>
__global__ void __launch_bounds__(wgtile::THREADS)
pair_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, float* __restrict__ out,
                  int rows) {
  // x's tile, then w's two halves, from a 1,024-byte aligned base.
  __shared__ __align__(1024) uint8_t smem[wgtile::ATOM_BYTES + X_TILE_BYTES +
                                          2 * W_HALF_BYTES];
  __shared__ __align__(8) uint64_t full;
  const uint32_t xs = wgtile::align_atom(smem);
  const uint32_t ws = xs + X_TILE_BYTES;
  const uint32_t bar = wgtile::smem_addr(&full);
  const int t = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * wgtile::M;

  if (t == 0) wgtile::mbar_init(bar, 1);
  __syncthreads();
  if (t == 0) {
    wgtile::mbar_arrive_expect_tx(bar, X_TILE_BYTES + 2 * W_HALF_BYTES);
    wgtile::tma_load_2d(xs, &xmap, bar, 0, static_cast<int>(row0));
    wgtile::tma_load_2d(ws, &wmap, bar, 0, 0);
    wgtile::tma_load_2d(ws + W_HALF_BYTES, &wmap, bar, PAIR_N, 0);
  }
  wgtile::mbar_wait(bar, 0);

  float sum[PAIR_N / 2];
  if constexpr (PAIRED) {
    float acc[PAIR_N];  // m64n128: both halves of each column
    wgtile::wgmma_fence();
#pragma unroll
    for (int s = 0; s < PAIR_STEPS; ++s) {
      wgtile::wgmma_m64n128k16_bf16(acc, wgtile::k_major_desc(xs, s),
                                    wgtile::mn_major_desc(ws, s, W_HALF_BYTES), s > 0);
    }
    wgtile::wgmma_commit();
    wgtile::wgmma_wait_all();
    wgtile::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < PAIR_N / 2; ++i) {
      sum[i] = acc[i] + acc[wgtile::upper_half<2 * PAIR_N>(i)];
    }
  } else {
    float lo[PAIR_N / 2];  // m64n64 each: w[:, :64] and w[:, 64:]
    float hi[PAIR_N / 2];
    wgtile::wgmma_fence();
#pragma unroll
    for (int s = 0; s < PAIR_STEPS; ++s) {
      wgtile::wgmma_m64n64k16_bf16(lo, wgtile::k_major_desc(xs, s),
                                   wgtile::mn_major_desc(ws, s, W_HALF_BYTES), s > 0);
    }
#pragma unroll
    for (int s = 0; s < PAIR_STEPS; ++s) {
      wgtile::wgmma_m64n64k16_bf16(
          hi, wgtile::k_major_desc(xs, s),
          wgtile::mn_major_desc(ws + W_HALF_BYTES, s, W_HALF_BYTES), s > 0);
    }
    wgtile::wgmma_commit();
    wgtile::wgmma_wait_all();
    wgtile::fence_regs(lo);
    wgtile::fence_regs(hi);
#pragma unroll
    for (int i = 0; i < PAIR_N / 2; ++i) sum[i] = lo[i] + hi[i];
  }

#pragma unroll
  for (int i = 0; i < PAIR_N / 2; i += 2) {
    const long long r = row0 + wgtile::frag_row(i, t);
    if (r < rows) {
      *reinterpret_cast<float2*>(out + r * PAIR_N + wgtile::frag_col(i, t)) =
          make_float2(sum[i], sum[i + 1]);
    }
  }
}

int status() { return static_cast<int>(cudaGetLastError()); }

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15u) == 0;
}

// Blocks of `kernel` resident on the current device in one wave (SMs x
// blocks an SM at `threads` and `smem`), found once per device.
template <class Kernel>
int one_wave(Kernel kernel, int threads, int smem, std::atomic<int>* cache, cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < 64 && cache[dev].load() > 0) return cache[dev].load();
  int sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (*err != cudaSuccess) return 0;
  if (dev < 64) cache[dev].store(sms * per_sm);
  return sms * per_sm;
}

int launch_copy(const float* src, float* dst, long long n, void* stream) {
  if (n <= 0) return invalid();
  // src and dst equally far from a 16-byte boundary: a scalar head brings
  // both onto one, and the body moves float4s.
  const unsigned so = reinterpret_cast<std::uintptr_t>(src) & 15u;
  const bool vec = so == (reinterpret_cast<std::uintptr_t>(dst) & 15u);
  const long long lead = (16 - so) % 16 / 4;
  const int head = vec ? static_cast<int>(lead < n ? lead : n) : 0;
  static std::atomic<int> wave[2][64];
  cudaError_t err;
  const int resident = vec ? one_wave(copy_kernel<true>, COPY_THREADS, 0, wave[1], &err)
                           : one_wave(copy_kernel<false>, COPY_THREADS, 0, wave[0], &err);
  if (resident <= 0) return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  const long long items = vec ? (n - head) / 4 : n;
  long long blocks = (items + COPY_CHUNK - 1) / COPY_CHUNK;
  blocks = blocks < 1 ? 1 : blocks > resident ? resident : blocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    copy_kernel<true><<<static_cast<unsigned>(blocks), COPY_THREADS, 0, s>>>(src, dst, n, head);
  } else {
    copy_kernel<false><<<static_cast<unsigned>(blocks), COPY_THREADS, 0, s>>>(src, dst, n, 0);
  }
  return status();
}

int launch_contract(const float* w, const void* x, float* out, long long l,
                    void* stream) {
  const long long threads = (l + CONTRACT_COLS - 1) / CONTRACT_COLS;
  const long long blocks = (threads + CONTRACT_THREADS - 1) / CONTRACT_THREADS;
  if (l <= 0 || blocks > 0x7fffffffLL) return invalid();
  // Every row of x and out on the wide body's boundary, or the narrow body.
  const bool wide = l % CONTRACT_COLS == 0 && aligned16(out) &&
                    (reinterpret_cast<std::uintptr_t>(x) & (CONTRACT_COLS * 2 - 1)) == 0;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    conv_contract_kernel<true><<<static_cast<unsigned>(blocks), CONTRACT_THREADS, 0, s>>>(
        w, xb, out, l);
  } else {
    conv_contract_kernel<false><<<static_cast<unsigned>(blocks), CONTRACT_THREADS, 0, s>>>(
        w, xb, out, l);
  }
  return status();
}

// The tensor maps of x (rows, 64) and w (64, 128), then the launch:
// ceil(rows / 64) warpgroups. Both bases must be 16-byte aligned (TMA's
// rule; the wrapper checks it too).
template <bool PAIRED>
int launch_pair(const void* x, const void* w, float* out, int rows, void* stream) {
  if (rows <= 0 || !aligned16(x) || !aligned16(w)) return invalid();
  CUtensorMap xmap;
  CUtensorMap wmap;
  if (!wgtile::encode_bf16_sw128(&xmap, x, PAIR_K, static_cast<uint64_t>(rows),
                                 PAIR_K * 2, wgtile::M) ||
      !wgtile::encode_bf16_sw128(&wmap, w, 2 * PAIR_N, PAIR_K, 2 * PAIR_N * 2,
                                 PAIR_K)) {
    return invalid();
  }
  const unsigned blocks = (static_cast<unsigned>(rows) + wgtile::M - 1) / wgtile::M;
  pair_wgmma_kernel<PAIRED><<<blocks, wgtile::THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(xmap, wmap, out,
                                                                   rows);
  return status();
}

}  // namespace

// The sizes the kernels index by, for the wrapper to check against its own:
// 0 taps, 1 filters, 2 the dots' depth K, 3 the width of each half of w.
extern "C" int mosaic_probe_dim(int i) {
  const int dims[] = {TAPS, FILTERS, PAIR_K, PAIR_N};
  return (i >= 0 && i < 4) ? dims[i] : -1;
}

// a (batch, m, k), b (batch, k, n), out (batch, m, n): f32 device pointers.
extern "C" int probe_rank3_dot(const float* a, const float* b, float* out,
                               int batch, int m, int k, int n, void* stream) {
  if (batch <= 0 || batch > 65535 || m <= 0 || k <= 0 || n <= 0) return invalid();
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE, batch);
  if (grid.y > 65535) return invalid();
  batched_matmul_kernel<<<grid, dim3(TILE, TILE), 0,
                          static_cast<cudaStream_t>(stream)>>>(a, b, out, m, k, n);
  return status();
}

// x and out: n contiguous f32 values each.
extern "C" int probe_lane_merge(const float* x, float* out, long long n,
                                void* stream) {
  return launch_copy(x, out, n, stream);
}

extern "C" int probe_lane_split(const float* x, float* out, long long n,
                                void* stream) {
  return launch_copy(x, out, n, stream);
}

// w (6, 25) f32, x (25, l) bf16, out (6, l) f32.
extern "C" int probe_mxu_conv_L(const float* w, const void* x, float* out,
                                long long l, void* stream) {
  return launch_contract(w, x, out, l, stream);
}

// w (6, 25) f32, x (25, bb, c) bf16, out (6, bb, c) f32; l = bb*c.
extern "C" int probe_mxu_conv_3d(const float* w, const void* x, float* out,
                                 long long l, void* stream) {
  return launch_contract(w, x, out, l, stream);
}

extern "C" int probe_vpu_conv(const float* w, const void* x, float* out,
                              long long l, void* stream) {
  const long long blocks = (l + CONV_THREADS - 1) / CONV_THREADS;
  if (l <= 0 || blocks > 0x7fffffffLL) return invalid();
  per_filter_conv_kernel<<<dim3(static_cast<unsigned>(blocks), FILTERS),
                           CONV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const __nv_bfloat16*>(x), out, l);
  return status();
}

// x (rows, 64) bf16, w (64, 128) bf16, out (rows, 64) f32.
extern "C" int probe_pair_dot(const void* x, const void* w, float* out, int rows,
                              void* stream) {
  return launch_pair<true>(x, w, out, rows, stream);
}

extern "C" int probe_two_dot(const void* x, const void* w, float* out, int rows,
                             void* stream) {
  return launch_pair<false>(x, w, out, rows, stream);
}
