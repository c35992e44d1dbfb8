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
//   same bytes: conv_contract_kernel<WIDE, false>, with L = bb*576.
// - vpu-conv computes the same sums with B1's rounding: for each filter 25
//   multiply-adds over the taps in order, each product and each sum rounded
//   on its own (__fmul_rn/__fadd_rn), as _vpu_conv_kernel loops
//   `acc += w[m,t]*x[t]`: conv_contract_kernel<WIDE, true>.
// The contraction reads each x column once, CONTRACT_COLS columns a thread
// in one wide load a tap, and keeps all 6 filters' sums in registers; its
// ROUNDED parameter picks one fma a tap or the separate multiply and add.
// The pair is the probe's question on this card: B1's conv form against
// the one-contraction form, which now differ in their rounding alone.
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

#include "ffma_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int TAPS = 25;      // 5x5 conv taps
constexpr int FILTERS = 6;    // conv output channels
constexpr int PAIR_K = 64;    // depth of the pair and two-dot products
constexpr int PAIR_N = 64;    // width of each half of their w (2*PAIR_N)

// ---------------------------------------------------------------------------
// rank3-dot: out[b] = a[b] @ b[b] over a leading batch dim, f32.
//
// At the probe's (4,64,128) @ (4,128,64) the work (327,680 bytes, 4.2
// MFLOP) is far below a launch, so the time is latency: the round trips a
// block waits on and its longest chain of dependent fmas (a K staged 16 at
// a time behind barriers is 8 round trips, one output a thread a chain of
// 128). A block of RANK3_THREADS computes a RANK3_TM x RANK3_TN output tile
// of one batch entry: every thread issues its share of the A row panel
// (RANK3_TM x RANK3_KC) and the B column panel (RANK3_KC x RANK3_TN) as
// cp.async copies before it waits, then meets one barrier, so a K of up to
// RANK3_KC costs one round trip (longer K: one round trip a chunk). Then a
// thread takes RANK3_OUTS consecutive columns of one row over one of
// RANK3_KSPLIT slices of each chunk's depth, from shared memory (A as
// float4 along k, B's columns as one run), and the slices' partial sums
// are added in slice order by the slice-0 thread after one more barrier.
// Each partial sums its k in ascending order, one fmaf each; the split is
// a build constant, so the order depends on the shape alone and a
// relaunch is bit-identical. At the probe's shape that is 128 blocks (one
// wave) of 256 threads, each thread 2 outputs over 32 of the 128 k, a
// chain of 32 fmas. (A sweep on an H100, benches/lenet_sweep.py rank3_dot,
// found 8x16 tiles faster than 16x16 and larger ones, whose fewer blocks
// each do more, and 2 outputs over a quarter of K as fast as any other
// split: 3.16-3.18 us against the first kernel's 4.74-4.77.)
//
// Operands are copied 16 bytes at a time where an operand's base lies on
// a 16-byte boundary and its rows hold whole quads (k % 4 == 0 for A,
// n % 4 == 0 for B), else 4 bytes at a time; past m, n or k the copies
// zero-fill, so a ragged tile and a ragged last chunk add exact zeros, and
// stores past m or n are masked. The grid is one dimension (batch x row
// tiles x column tiles), so the batch is not limited to grid.z's 65,535.
// ---------------------------------------------------------------------------

constexpr int RANK3_TM = 8;        // output rows a block
constexpr int RANK3_TN = 16;       // output columns a block
constexpr int RANK3_OUTS = 2;      // consecutive columns a thread
constexpr int RANK3_KSPLIT = 4;    // slices of the depth, a thread each
constexpr int RANK3_KC = 128;      // depth staged at once
constexpr int RANK3_GROUPS = RANK3_TM * RANK3_TN / RANK3_OUTS;  // threads a slice
constexpr int RANK3_THREADS = RANK3_GROUPS * RANK3_KSPLIT;
constexpr int RANK3_SLICE = RANK3_KC / RANK3_KSPLIT;
constexpr int RANK3_A_LD = RANK3_KC + 4;  // A's padded panel row: rows on distinct banks
static_assert(RANK3_TN % RANK3_OUTS == 0 && RANK3_TN % 4 == 0, "whole column runs and quads");
static_assert(RANK3_SLICE % 4 == 0, "float4 reads of A along k");
static_assert(RANK3_THREADS <= 1024, "one block");

__global__ void __launch_bounds__(RANK3_THREADS)
batched_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int m, int k, int n) {
  __shared__ __align__(16) float as[RANK3_TM * RANK3_A_LD];
  __shared__ __align__(16) float bs[RANK3_KC * RANK3_TN];
  __shared__ float red[RANK3_KSPLIT > 1 ? (RANK3_KSPLIT - 1) * RANK3_TM * RANK3_TN : 1];
  const int tid = threadIdx.x;
  const int tiles_n = (n + RANK3_TN - 1) / RANK3_TN;
  const int tiles_m = (m + RANK3_TM - 1) / RANK3_TM;
  const int tn = static_cast<int>(blockIdx.x % tiles_n);
  const int tm = static_cast<int>(blockIdx.x / tiles_n % tiles_m);
  const long long batch = blockIdx.x / tiles_n / tiles_m;
  const int row0 = tm * RANK3_TM;
  const int col0 = tn * RANK3_TN;
  const float* ab = a + batch * m * k;
  const float* bb = b + batch * k * n;
  const bool vec_a = (reinterpret_cast<std::uintptr_t>(a) & 15u) == 0 && k % 4 == 0;
  const bool vec_b = (reinterpret_cast<std::uintptr_t>(b) & 15u) == 0 && n % 4 == 0;
  // This thread's output run and depth slice.
  const int ks = tid / RANK3_GROUPS;
  const int g = tid - ks * RANK3_GROUPS;
  const int r = g / (RANK3_TN / RANK3_OUTS);
  const int c = (g - r * (RANK3_TN / RANK3_OUTS)) * RANK3_OUTS;
  float acc[RANK3_OUTS];
#pragma unroll
  for (int o = 0; o < RANK3_OUTS; ++o) acc[o] = 0.f;
  for (int k0 = 0; k0 < k; k0 += RANK3_KC) {
    if (k0 > 0) __syncthreads();  // the last chunk's reads are done
    if (vec_a) {
      for (int q = tid; q < RANK3_TM * RANK3_KC / 4; q += RANK3_THREADS) {
        const int i = q / (RANK3_KC / 4);
        const int kq = (q - i * (RANK3_KC / 4)) * 4;
        const bool in = row0 + i < m && k0 + kq < k;
        ftile::cp_async16(as + i * RANK3_A_LD + kq,
                          in ? ab + static_cast<long long>(row0 + i) * k + k0 + kq : a, in);
      }
    } else {
      for (int e = tid; e < RANK3_TM * RANK3_KC; e += RANK3_THREADS) {
        const int i = e / RANK3_KC;
        const int kk = e - i * RANK3_KC;
        const bool in = row0 + i < m && k0 + kk < k;
        ftile::cp_async4(as + i * RANK3_A_LD + kk,
                         in ? ab + static_cast<long long>(row0 + i) * k + k0 + kk : a, in);
      }
    }
    if (vec_b) {
      for (int q = tid; q < RANK3_KC * RANK3_TN / 4; q += RANK3_THREADS) {
        const int kk = q / (RANK3_TN / 4);
        const int cq = (q - kk * (RANK3_TN / 4)) * 4;
        const bool in = k0 + kk < k && col0 + cq < n;
        ftile::cp_async16(bs + kk * RANK3_TN + cq,
                          in ? bb + static_cast<long long>(k0 + kk) * n + col0 + cq : b, in);
      }
    } else {
      for (int e = tid; e < RANK3_KC * RANK3_TN; e += RANK3_THREADS) {
        const int kk = e / RANK3_TN;
        const int cc = e - kk * RANK3_TN;
        const bool in = k0 + kk < k && col0 + cc < n;
        ftile::cp_async4(bs + e, in ? bb + static_cast<long long>(k0 + kk) * n + col0 + cc : b,
                         in);
      }
    }
    ftile::cp_async_commit();
    ftile::cp_async_wait<0>();
    __syncthreads();
    const float* ar = as + r * RANK3_A_LD + ks * RANK3_SLICE;
    const float* br = bs + ks * RANK3_SLICE * RANK3_TN + c;
#pragma unroll
    for (int kk = 0; kk < RANK3_SLICE; kk += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(ar + kk);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float bv[RANK3_OUTS];
        if constexpr (RANK3_OUTS == 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(br + (kk + j) * RANK3_TN);
          bv[0] = b4.x, bv[1] = b4.y, bv[2] = b4.z, bv[3] = b4.w;
        } else if constexpr (RANK3_OUTS == 2) {
          const float2 b2 = *reinterpret_cast<const float2*>(br + (kk + j) * RANK3_TN);
          bv[0] = b2.x, bv[1] = b2.y;
        } else {
          bv[0] = br[(kk + j) * RANK3_TN];
        }
#pragma unroll
        for (int o = 0; o < RANK3_OUTS; ++o) acc[o] = fmaf(av[j], bv[o], acc[o]);
      }
    }
  }
  if constexpr (RANK3_KSPLIT > 1) {
    if (ks > 0) {
#pragma unroll
      for (int o = 0; o < RANK3_OUTS; ++o)
        red[((ks - 1) * RANK3_GROUPS + g) * RANK3_OUTS + o] = acc[o];
    }
    __syncthreads();
    if (ks > 0) return;
#pragma unroll
    for (int s = 1; s < RANK3_KSPLIT; ++s)
#pragma unroll
      for (int o = 0; o < RANK3_OUTS; ++o)
        acc[o] += red[((s - 1) * RANK3_GROUPS + g) * RANK3_OUTS + o];
  }
  const int row = row0 + r;
  if (row >= m) return;
  float* orow = out + (batch * m + row) * n + col0 + c;
#pragma unroll
  for (int o = 0; o < RANK3_OUTS; ++o)
    if (col0 + c + o < n) orow[o] = acc[o];
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

// The contraction: a thread takes CONTRACT_COLS consecutive columns and all
// 6 filters, blocks of CONTRACT_THREADS, so x is read once. Its 25 taps'
// loads go out before w is staged and before the first multiply-add, so
// the kernel waits on one round trip to memory, not two (w's, then x's):
// in the wide body one CONTRACT_COLS * 2-byte load a
// tap (4 bytes at 2 columns: a warp's request is 128 contiguous bytes of a
// row, where one thread a column made it 64), and each filter's outputs
// leave as one float2 store (float4s at 4 or 8 columns). At the probes'
// 73,728 columns that is 288 blocks of 128 threads. (A sweep on an H100,
// benches/lenet_sweep.py conv_contract and vpu_conv, found 2 columns in
// blocks of 128 the fastest for both roundings, one column as fast, 4 and
// 8 slower: vpu-conv does two rounded operations a product, and at 4
// columns the card's schedulers held too few warps to issue its 1,200 a
// thread evenly.) The wide body needs every row of x and of out on
// its boundary: l a multiple of CONTRACT_COLS, x on a CONTRACT_COLS * 2-byte
// boundary and out on a 16-byte one, which the host checks; otherwise (an
// odd l such as 1003, a view of x at an odd offset) the narrow body reads
// and writes one value at a time, with the ragged last columns masked.
// Every output is acc = madd<ROUNDED>(w[m,t], x[t,col], acc) over t =
// 0..24 from 0, so both bodies, and every CONTRACT_COLS, give the first
// designs' bits (one thread a column, the same operations in the same
// order): mxu-conv's fmas, and vpu-conv's rounded products and sums, which
// are its plain twin's.
constexpr int CONTRACT_THREADS = 128;
constexpr int CONTRACT_COLS = 2;
static_assert(CONTRACT_COLS == 2 || CONTRACT_COLS == 4 || CONTRACT_COLS == 8,
              "a float2 or whole float4 stores");

// CONTRACT_COLS bf16 values in one load.
template <int COLS> struct Bf16Run;
template <> struct Bf16Run<2> { using type = unsigned; };
template <> struct Bf16Run<4> { using type = uint2; };
template <> struct Bf16Run<8> { using type = uint4; };

// The two bf16 values of a 32-bit word, widened exactly (bf16 is the top
// half of an f32), the lower address first.
__device__ __forceinline__ void widen2(unsigned v, float* f) {
  f[0] = __uint_as_float(v << 16);
  f[1] = __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ void widen(unsigned v, float* f) { widen2(v, f); }
__device__ __forceinline__ void widen(uint2 v, float* f) { widen2(v.x, f); widen2(v.y, f + 2); }
__device__ __forceinline__ void widen(uint4 v, float* f) {
  widen2(v.x, f);
  widen2(v.y, f + 2);
  widen2(v.z, f + 4);
  widen2(v.w, f + 6);
}

// acc + w * x: one fma, or (ROUNDED) the product and the sum each rounded on
// its own, which nvcc may not contract into an fma.
template <bool ROUNDED>
__device__ __forceinline__ float madd(float w, float x, float acc) {
  return ROUNDED ? __fadd_rn(acc, __fmul_rn(w, x)) : fmaf(w, x, acc);
}

template <bool WIDE, bool ROUNDED>
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
          acc[m][q] = madd<ROUNDED>(ws[m * TAPS + t], xv[q], acc[m][q]);
    }
#pragma unroll
    for (int m = 0; m < FILTERS; ++m)
#pragma unroll
      for (int q = 0; q < CONTRACT_COLS; q += 4) {
        if constexpr (CONTRACT_COLS == 2) {
          *reinterpret_cast<float2*>(out + m * l + c0) = make_float2(acc[m][0], acc[m][1]);
        } else {
          *reinterpret_cast<float4*>(out + m * l + c0 + q) =
              make_float4(acc[m][q], acc[m][q + 1], acc[m][q + 2], acc[m][q + 3]);
        }
      }
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
        acc[m][q] = madd<ROUNDED>(ws[m * TAPS + t], xv[q], acc[m][q]);
  }
#pragma unroll
  for (int m = 0; m < FILTERS; ++m)
#pragma unroll
    for (int q = 0; q < CONTRACT_COLS; ++q)
      if (q < cols) out[m * l + c0 + q] = acc[m][q];
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

template <bool ROUNDED>
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
    conv_contract_kernel<true, ROUNDED>
        <<<static_cast<unsigned>(blocks), CONTRACT_THREADS, 0, s>>>(w, xb, out, l);
  } else {
    conv_contract_kernel<false, ROUNDED>
        <<<static_cast<unsigned>(blocks), CONTRACT_THREADS, 0, s>>>(w, xb, out, l);
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
  if (batch <= 0 || m <= 0 || k <= 0 || n <= 0) return invalid();
  const long long blocks = static_cast<long long>(batch) * ((m + RANK3_TM - 1) / RANK3_TM) *
                           ((n + RANK3_TN - 1) / RANK3_TN);
  if (blocks > 0x7fffffffLL) return invalid();
  batched_matmul_kernel<<<static_cast<unsigned>(blocks), RANK3_THREADS, 0,
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
  return launch_contract<false>(w, x, out, l, stream);
}

// w (6, 25) f32, x (25, bb, c) bf16, out (6, bb, c) f32; l = bb*c.
extern "C" int probe_mxu_conv_3d(const float* w, const void* x, float* out,
                                 long long l, void* stream) {
  return launch_contract<false>(w, x, out, l, stream);
}

extern "C" int probe_vpu_conv(const float* w, const void* x, float* out,
                              long long l, void* stream) {
  return launch_contract<true>(w, x, out, l, stream);
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
