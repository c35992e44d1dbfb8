// The staged LeNet-ref kernel library: one kernel per stage of the train
// step, with the activations and gradients passing through device memory
// between launches. Written for Hopper (sm_90a), bound to Python through
// ctypes (ops/lenet_staged.py).
//
// Replaces the seven Pallas TPU kernels of the per-op tier of
// parallel_cnn_tpu/ops/pallas.py, one launcher each:
//
//   B3 lenet_conv_fwd     <- `_conv_fwd_kernel`     (pallas.py:141, conv_fwd :158)
//   B4 lenet_pool_fwd     <- `_pool_fwd_kernel`     (pallas.py:201, pool_fwd :214)
//   B5 lenet_fc_fwd       <- `_fc_fwd_kernel`       (pallas.py:238, fc_fwd :250)
//   B6 lenet_fc_bwd       <- `_fc_bwd_kernel`       (pallas.py:279, fc_bwd :303)
//   B7 lenet_pool_bwd     <- `_pool_bwd_kernel`     (pallas.py:333, pool_bwd :345)
//   B8 lenet_sigma_prime  <- `_sigma_prime_kernel`  (pallas.py:413, conv_bwd_dpre :419)
//   B9 lenet_accum_matmul <- `_accum_matmul_kernel` (pallas.py:371, _accum_matmul :384;
//                            called by pool_wgrad :402 and conv_wgrad :436)
//
// Layouts are the TPU tier's: x (n,28,28); pre/out of the conv (n,6,24,24);
// the packed pool windows xw (n,16,216), tap t = 4i+j, lane m*36 + x*6 + y;
// pool and FC activations (n,216) and (n,10); w_c1 (6,5,5), w_s1 (4,4) as 16
// taps, w_f (10,216). The window packing, the im2col of conv_wgrad, the
// error vector and the bias sums stay PyTorch ops, as they were XLA ops
// outside every TPU kernel.
//
// Design. B4 gives one thread one output and walks its sum in the TPU
// kernel's order: it starts from the bias and adds the 16 taps in t
// order, each product and sum rounded on its own (__fmul_rn/__fadd_rn) as
// the plain PyTorch version rounds them. B8 (below) gives a thread
// SIGMA_VEC float4 quads, all loaded before its first sigma. B7 (below) gives a thread two
// neighbouring lanes of one image and half of their 16 rows. B3 (below)
// keeps B4's order and rounding for each of its outputs (the bias, then
// the 25 taps in (i, j) order) but gives a thread a register tile of
// outputs from an image staged in shared memory. B5 (below) is a warp an
// image, k split over the lanes and a fixed shuffle tree. B6 (below) sums
// its weight and bias grads over the batch in shards and a fixed tree, and
// its input grad over o upward.
// B9 (below) reduces up to 576n rows in one launch: row shards a block,
// register tiles a warp, a shuffle tree, and the blocks' partials summed by
// the last block to take an integer ticket. No float atomics anywhere: a
// relaunch on the same inputs is bit-identical.
//
// sigma(v) = 1 / (1 + expf(-v)) with IEEE expf and division (build without
// --use_fast_math): the expression torch.sigmoid evaluates on a CUDA
// tensor. B7 and B8 recompute sigma from the preactivation, as the TPU
// kernels do (pallas.py:338, :415), and form d * s * (1 - s) left to right.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32), at batch 64, each input
// read once and each output written once: B3 moves 1.97 MB (0.59 us) for
// 11.1 MFLOP (0.17 us), B4 1.0 MB (0.30 us), B5 69 kB, B6 130 kB, B7 1.05 MB
// (0.31 us), B8 2.65 MB (0.79 us), B9 at conv_wgrad 4.6 MB (1.37 us) for
// 11.1 MFLOP: every one is bound by bytes, and every one sits below a
// launch's few microseconds. At batch 1000 B4 moves 15.6 MB (4.64 us) for
// 6.9 MFLOP, B7 16.4 MB (4.90 us) and B8 41.5 MB (12.4 us) for 10.4 MFLOP:
// there the bytes set the bound. B8's 41.5 MB fit in the 50 MB L2, so
// back-to-back calls on the same inputs can read faster than the bound.
// B9's bytes are those of the im2col-fed product; the weight gradient it
// serves needs only x and d_pre_c1, 1.09 MB (0.32 us), so a B9 that read x
// directly would drop the host-side im2col and three quarters of its bound.
// The fused kernel (csrc/lenet_fused.cu) is the fast path.
//
// B3 replaces `_conv_fwd_kernel`'s batch-block grid of (Bb, 24, 24) tap
// multiply-adds on the TPU's vector unit, first ported as one thread an
// output (two loads through L1 a tap, 64-bit index math), with a block an
// (image, CONV_MAPS maps):
//   - the block stages its image (3,136 bytes, rows of 112: whole float4s)
//     in shared memory with cp.async, 16 bytes a copy where x starts on a
//     16-byte boundary (then every image does) and 4 bytes where it does
//     not, while each thread loads its map's 25 weights and bias into
//     registers;
//   - a thread owns CONV_ROWS rows x 4 neighbouring columns of one map, and
//     slides a 5 x 8 window of x down its rows: one new row (two float4
//     shared loads) a row of 4 outputs, 100 products, where one thread an
//     output made 50 loads through L1 for 25;
//   - each output keeps its order and rounding, so B3 is bit for bit the
//     plain version (and every partition of it); pre and out are stored as
//     float4s. The grid is n * 6 / CONV_MAPS blocks, from n alone. At batch
//     64 the bound is the 1.97 MB it moves (0.59 us) and sigma's IEEE expf
//     and division cost about as many instructions as the 25 taps: the
//     launch, one staged round trip and the instructions set its time.
//
// B5 replaces one thread an output (a chain of 216 dependent fmas, each
// waiting on two loads, 640 threads in 3 blocks at batch 64) with a warp an
// image, FC_FWD_WARPS warps a block, the grid from n alone capped at
// FC_FWD_WAVE warps (each then walks images gridDim * FC_FWD_WARPS apart):
//   - lane l < 27 owns k = 8l .. 8l + 7: it holds w[o, 8l .. 8l + 7] for
//     the 10 classes in 80 registers (loaded once a warp) and reads its 8
//     values of x as two float4s, so a warp reads a row of x (864 bytes)
//     in one coalesced sweep; 4-byte loads where x or w is off the 16-byte
//     boundary (every row is then);
//   - each lane sums its 8 terms k upward with fmaf from 0 (lanes 27..31
//     hold 0), a butterfly over the 32 lanes (xor 16, 8, 4, 2, 1) adds the
//     10 sums, and lane o adds b[o] and writes pre and out. The order
//     depends on the layout alone: ops/lenet_staged.py's fc_fwd_order is it
//     in numpy, fma by fma. The bound is 69 kB at batch 64 (0.02 us): the
//     launch and one round trip set its time.
//
// B9 replaces `_accum_matmul_kernel`'s sequential row grid (a VMEM
// accumulator carried from one grid step to the next) with one launch of
// at most ACCUM_BLOCKS blocks, one an SM of an H100, each a shard of rows:
//   - the grid comes from (rows, ka, kb) alone (accum_plan), so the order
//     of every sum does too;
//   - a block stages its rows in shared memory with 16-byte cp.async
//     copies, two stages of up to 24 KB of a and b in flight, so all 132
//     SMs pull from device memory at once: at the conv site at batch 64
//     each moves 35 KB, one round trip;
//   - a warp owns an ACCUM_TA x ACCUM_TB tile of the output, 32 registers
//     a lane (8 + 4 shared loads a row for 32 fmas, against 2 a fma one
//     output a thread), and its lanes take interleaved rows;
//   - ftile::warp_sum32 finishes the tile in 31 shuffles;
//   - the last block to take a ticket (an integer atomicInc that wraps to
//     0, so nothing resets it between launches) stages the blocks'
//     partials in shared memory and sums them, its threads split over
//     outputs and block shards, then the shards in order. At batch 64 the
//     bound of each site sits below a launch's latency (1.37 us and 0.28
//     us): the launch and two dependent round trips set its time.
//
// B7 replaces `_pool_bwd_kernel`, first ported as one thread an output of
// one image (16 scalar 4-byte stores a thread, strided by a row of 216
// floats, in blocks of 256), with a thread POOL_BWD_VEC neighbouring lanes
// and TAPS / POOL_BWD_SPLIT rows of one image, in blocks of
// POOL_BWD_THREADS:
//   - its taps are loaded first, as float4s; then d and pre as one access
//     a lane group (4-byte loads off the boundary, as a view one value in);
//   - each part recomputes sigma and dpre (d * s * (1 - s) left to right)
//     and stores its rows w[t] * dpre as float2s; part 0 stores dpre. Every
//     row is 864 bytes, so where dxw starts on a 16-byte boundary every
//     row does; the C entry refuses dpre or dxw off it (the wrapper
//     allocates them);
//   - each output is the plain version's one product, so B7 is bit for bit
//     its plain version at every partition.
// B8 replaces `_sigma_prime_kernel`, first ported as one thread an element
// (a 4-byte load of d and of pre and a 4-byte store a thread, 864 blocks
// of 256 at batch 64), with a thread SIGMA_VEC float4 quads, blocks of
// SIGMA_THREADS, the grid from n alone capped at SIGMA_WAVE blocks (past
// it the grid strides):
//   - a thread loads all its quads of d and pre before its first
//     sigma, as B7 loads its taps first, the quads SIGMA_THREADS
//     apart so a warp's loads are 512 contiguous bytes;
//   - an image is 864 quads, so n * 864 quads cover the tensors exactly
//     and where d or pre starts on a 16-byte boundary every quad does; a
//     view off the boundary takes four 4-byte loads a quad (load_quad),
//     and the C entry refuses an out off it (the wrapper allocates out);
//   - each element is sigma's IEEE expf and division, then d * s * (1 - s)
//     left to right, the plain version's expression: B8 is bit for bit
//     its plain version at every partition. At batch 64 its 2.65 MB sit
//     below a launch; at batch 1000 its 41.5 MB set the bound.
// B4 stays one thread an output: giving a thread 2 or 4 lanes (float2 or
// float4 loads, taps first, blocks of 32-256), staging a block's rows in
// shared memory with cp.async, or bringing an image's window block in by
// one bulk copy (cp.async.bulk on an mbarrier) each lost to it at batch 64
// or 1000 on an H100 (benches/lenet_sweep.py pool_fwd keeps them as
// candidates). At batch 64 both bounds (0.30, 0.31 us) sit far below a
// launch; at batch 1000 the bytes do (4.64, 4.90 us).
//
// B6 replaces `_fc_bwd_kernel` with two kinds of blocks in one launch (one
// pallas_call in JAX):
//   - FC_SLAB_BLOCKS gw/gb blocks, each owning a slab of FC_SLAB of the 216
//     feature columns. A block stages all of d (n x 10) and its slab of s
//     into shared memory with cp.async, 16 bytes a copy where the operand
//     is 16-byte aligned, every copy issued before the first multiply-add
//     (batches past FC_ROWS rows stage in chunks of FC_ROWS). Its 8 warps
//     x 4 lane groups are 32 batch shards of ceil(min(n, FC_ROWS) / 32)
//     rows of each chunk; a thread sums its shard for 10 classes x
//     FC_SLAB/8 columns (and block 0 the bias grad from the same staged
//     d), fixed-order warp shuffles add the warp's four shards, and shared
//     memory the eight warps in warp order. So gw and gb sum the batch in
//     shard-then-tree order, which depends on n alone: no atomics, and a
//     relaunch is bit-identical.
//   - ceil(54n / 256) dout blocks: w (8.6 KB) in shared memory, each thread
//     four neighbouring features of one image (a float4 store) from its
//     image's 10 values of d, the 10 fmas in o order from 0, as one thread
//     per output sums them.
// One thread per output gives each of the 2,160 gw threads a chain of n
// dependent load-then-fma steps through device memory (5.36 us at n = 64
// on an H100 80GB HBM3 at 700 W, against 1.78 us for an empty launch);
// here a gw thread's chain is one staged round trip and ceil(n / 32) rows
// of fmas. The bound at n = 64 is the 130 kB B6 must move, 0.039 us: a
// launch and one round trip set its time.
//
// The kernels launch on the caller's stream, synchronise nothing and
// allocate nothing: the wrapper allocates outputs and B9's scratch and
// checks devices, dtypes, shapes and contiguity first; the launchers refuse
// an empty batch, B3's misaligned pre or out, B6's misaligned dout, B7's
// misaligned dpre or dxw, B8's misaligned out and B9's operands past its
// limits.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "ffma_tile.cuh"  // the cp.async helpers

namespace {

constexpr int THREADS = 256;
constexpr int IMG = 784;        // 28 x 28 input pixels
constexpr int CONV = 3456;      // 6 maps x 24 x 24
constexpr int LANES = 216;      // 6 maps x 6 x 6 pool outputs
constexpr int TAPS = 16;        // 4 x 4 pool window
constexpr int CLASSES = 10;
// B9: a warp's tile of ACCUM_TA x ACCUM_TB outputs (one register each, 32
// a lane), at most ACCUM_BLOCKS blocks (one an SM of an H100 SXM), a
// block's rows a multiple of ACCUM_ROW_ALIGN (so a block's a and b start
// on a 16-byte boundary where the tensors do) and at least ACCUM_ROWS (one
// a lane).
constexpr int ACCUM_TA = 8;
constexpr int ACCUM_TB = 4;
constexpr int ACCUM_BLOCKS = 132;
constexpr int ACCUM_ROW_ALIGN = 4;
constexpr int ACCUM_ROWS = 32;
constexpr int ACCUM_MAX_OUTS = 256;
constexpr int ACCUM_MAX_COLS = 48;
constexpr int ACCUM_SMEM_FLOATS = 48 * 1024 / 4;
constexpr int ACCUM_MAX_THREADS = 512;  // 14 tiles at most within the limits
// The last block's copy of every block's partial, and its shard sums.
constexpr int ACCUM_MAX_SMEM_BYTES = 4 * (ACCUM_BLOCKS * ACCUM_MAX_OUTS + ACCUM_MAX_THREADS);
static_assert(ACCUM_TA * ACCUM_TB == 32, "a lane a tile output after warp_sum32");
static_assert(ACCUM_SMEM_FLOATS / (2 * ACCUM_MAX_COLS) >= 128, "two stages of 128 rows");

// B6's gw/gb blocks: FC_SLAB feature columns a block (8 lanes across the
// slab, FC_SLAB / 8 columns a lane; 8 beat 24 by 11-13% at batch 64 on an
// H100, 27 blocks of 62 registers against 9 of 80), FC_SHARDS batch shards
// (8 warps x 4 lane groups), FC_ROWS batch rows staged at a time.
constexpr int FC_SLAB = 8;
constexpr int FC_COLS = FC_SLAB / 8;
constexpr int FC_SLAB_BLOCKS = LANES / FC_SLAB;
constexpr int FC_SHARDS = THREADS / 8;
constexpr int FC_WARPS = THREADS / 32;
constexpr int FC_ROWS = 256;
constexpr int FC_QUADS = LANES / 4;  // float4s in a row of dout
constexpr int FC_GRAD_FLOATS =
    FC_ROWS * CLASSES + FC_ROWS * FC_SLAB + FC_WARPS * CLASSES * (FC_SLAB + 1);
constexpr int FC_SMEM_FLOATS =
    FC_GRAD_FLOATS > CLASSES * LANES ? FC_GRAD_FLOATS : CLASSES * LANES;
static_assert(FC_SLAB % 8 == 0 && LANES % FC_SLAB == 0, "a slab is whole float4 runs");
static_assert(FC_SMEM_FLOATS * 4 <= 48 * 1024, "static shared memory");

// B3: a block is one image and CONV_MAPS of its 6 maps; a thread owns
// CONV_ROWS rows x 4 columns of one map (CONV_STRIPS strips of 4 a row).
// 3 maps x 2 rows, from 24 partitions timed on an H100 (benches/
// lenet_sweep.py): 3.47 us at batch 64, 17.88 at 1000; 1 row was 3.7%
// faster at 64 and 8% slower at 1000, 6 maps x 6 rows the fastest at 1000
// (14.78) and 43% slower at 64.
constexpr int CONV_MAPS = 3;
constexpr int CONV_ROWS = 2;
constexpr int CONV_STRIPS = 6;
constexpr int CONV_ROW_GROUPS = 24 / CONV_ROWS;
constexpr int CONV_MAP_THREADS = CONV_STRIPS * CONV_ROW_GROUPS;
constexpr int CONV_GROUPS = 6 / CONV_MAPS;  // blocks an image
constexpr int CONV_THREADS = CONV_MAPS * CONV_MAP_THREADS;
static_assert(6 % CONV_MAPS == 0 && 24 % CONV_ROWS == 0, "whole maps and row groups");
static_assert(CONV_THREADS <= 1024, "one block");

// B5: a warp an image, FC_FWD_WARPS warps a block, at most FC_FWD_WAVE
// warps (16 an SM of an H100 SXM); lane l < FC_FWD_LANES owns FC_K
// consecutive k. 2 warps a block matched 1 at batch 64 and 128 and beat
// 4 and 8 (3.06 us at batch 64 against 3.23 and 3.88, on an H100).
constexpr int FC_FWD_WARPS = 2;
constexpr int FC_K = 8;
constexpr int FC_FWD_LANES = LANES / FC_K;
constexpr int FC_FWD_WAVE = 2112;  // 132 SMs x 16 warps
static_assert(FC_FWD_LANES * FC_K == LANES && FC_FWD_LANES <= 32 && CLASSES <= 32,
              "a lane a k slice, a lane a class");
static_assert(FC_K == 8, "two float4s a lane");

// B7: a thread owns POOL_BWD_VEC neighbouring lanes of one image (one
// float2 access a row; POOL_BWD_GROUPS lane groups an image) and TAPS /
// POOL_BWD_SPLIT rows of its dxw, POOL_BWD_SPLIT threads sharing a lane
// group; POOL_BWD_THREADS threads a block, the grid from n alone. Two lanes
// x 8 rows in blocks of 64, from 28 partitions timed on an H100
// (benches/lenet_sweep.py pool_bwd): the fastest of the two that beat one
// thread an output at batch 64, 128 and 1000; 4 lanes (float4 stores) were
// slower at 64 and 128.
constexpr int POOL_BWD_VEC = 2;
constexpr int POOL_BWD_THREADS = 64;
constexpr int POOL_BWD_SPLIT = 2;
constexpr int POOL_BWD_GROUPS = LANES / POOL_BWD_VEC;
static_assert(LANES % POOL_BWD_VEC == 0, "whole lane groups");
static_assert(TAPS % (4 * POOL_BWD_SPLIT) == 0, "whole float4s of taps a part");

// B8: a thread SIGMA_VEC float4 quads, SIGMA_THREADS apart, in blocks of
// SIGMA_THREADS; at most SIGMA_WAVE blocks (16 of 128 threads an SM of an
// H100 SXM), which then stride over the rest. One quad a thread in blocks
// of 128, from 18 partitions timed on an H100 (benches/lenet_sweep.py
// sigma_prime; PERF.md): level with one thread an element at batch 64 and
// the fastest at 128; 2 and 4 quads a thread were slower at 64 and 128
// (more sigmas in a row a thread, fewer threads). The strided wave beat
// one pass at batch 1000 (fewer blocks to schedule).
constexpr int SIGMA_VEC = 1;
constexpr int SIGMA_THREADS = 128;
constexpr int SIGMA_WAVE = 2112;
constexpr int CONV_QUADS = CONV / 4;  // float4 quads an image
static_assert(CONV % 4 == 0, "an image is whole quads");

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ long long global_index() {
  return static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
}

int blocks_for(long long total) {
  return static_cast<int>((total + THREADS - 1) / THREADS);
}

__host__ __device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15u) == 0;
}

// V floats (1, 2 or 4) as one access of 4V bytes: p must lie on a 4V-byte
// boundary.
template <int V>
__device__ __forceinline__ bool aligned_vec(const float* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & (4u * V - 1)) == 0;
}

template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V], const float* __restrict__ p) {
  static_assert(V == 1 || V == 2 || V == 4, "a float, float2 or float4");
  if constexpr (V == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// K weights from p (K a multiple of 4): float4 loads where p lies on a
// 16-byte boundary, else K 4-byte loads. B7 loads its taps first, before
// its data: placed at their use, ptxas issued them after the data's
// loads, each batch waiting on its own round trip.
template <int K>
__device__ __forceinline__ void load_taps(float (&v)[K], const float* __restrict__ p) {
  static_assert(K % 4 == 0, "whole float4s");
  if (aligned16(p)) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = __ldg(p + k);
  }
}

// V floats from p: one access where p lies on a 4V-byte boundary, else V
// 4-byte loads.
template <int V>
__device__ __forceinline__ void load_lanes(float (&v)[V], const float* __restrict__ p) {
  if (aligned_vec<V>(p)) {
    load_vec<V>(v, p);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __ldg(p + k);
  }
}

// Eight floats from p: two float4 loads where p is 16-byte aligned, else
// eight 4-byte loads.
__device__ __forceinline__ void load8(float (&v)[8], const float* __restrict__ p, bool vec) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldg(p + k);
  }
}

// B3: pre[b,m,r,c] = b_c1[m] + sum_{i,j} w[m,i,j] * x[b,r+i,c+j]; out = sigma(pre).
// Block blk is image blk / CONV_GROUPS, maps (blk % CONV_GROUPS) *
// CONV_MAPS on; thread t is map t / CONV_MAP_THREADS of those, rows
// r0 .. r0 + CONV_ROWS - 1 (r0 = CONV_ROWS * row group) and columns c0 ..
// c0 + 3 (c0 = 4 * strip).
__global__ void __launch_bounds__(CONV_THREADS)
conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ pre,
                float* __restrict__ out) {
  __shared__ __align__(16) float xs[IMG];
  const int tid = threadIdx.x;
  const int blk = static_cast<int>(blockIdx.x);
  const long long img = blk / CONV_GROUPS;
  const int m = (blk - static_cast<int>(img) * CONV_GROUPS) * CONV_MAPS + tid / CONV_MAP_THREADS;
  const int t = tid % CONV_MAP_THREADS;
  const int r0 = (t / CONV_STRIPS) * CONV_ROWS;
  const int c0 = (t % CONV_STRIPS) * 4;
  const float* xi = x + img * IMG;
  if (aligned16(x)) {
    for (int i = tid; i < IMG / 4; i += CONV_THREADS) ftile::cp_async16(xs + 4 * i, xi + 4 * i, true);
  } else {
    for (int i = tid; i < IMG; i += CONV_THREADS) ftile::cp_async4(xs + i, xi + i, true);
  }
  ftile::cp_async_commit();
  float wr[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) wr[k] = __ldg(w + m * 25 + k);
  const float b = __ldg(bias + m);
  ftile::cp_async_wait<0>();
  __syncthreads();

  // win[i] holds x row r + i, columns c0 .. c0 + 7, for output row r.
  float win[5][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 lo = *reinterpret_cast<const float4*>(xs + (r0 + i) * 28 + c0);
    const float4 hi = *reinterpret_cast<const float4*>(xs + (r0 + i) * 28 + c0 + 4);
    win[i + 1][0] = lo.x, win[i + 1][1] = lo.y, win[i + 1][2] = lo.z, win[i + 1][3] = lo.w;
    win[i + 1][4] = hi.x, win[i + 1][5] = hi.y, win[i + 1][6] = hi.z, win[i + 1][7] = hi.w;
  }
  const long long base = ((img * 6 + m) * 24 + r0) * 24 + c0;
#pragma unroll
  for (int rr = 0; rr < CONV_ROWS; ++rr) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) win[i][c] = win[i + 1][c];
    const float* row = xs + (r0 + rr + 4) * 28 + c0;
    const float4 lo = *reinterpret_cast<const float4*>(row);
    const float4 hi = *reinterpret_cast<const float4*>(row + 4);
    win[4][0] = lo.x, win[4][1] = lo.y, win[4][2] = lo.z, win[4][3] = lo.w;
    win[4][4] = hi.x, win[4][5] = hi.y, win[4][6] = hi.z, win[4][7] = hi.w;
    float acc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = b;
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(wr[i * 5 + j], win[i][q + j]));
    const long long o = base + rr * 24;
    *reinterpret_cast<float4*>(pre + o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(out + o) =
        make_float4(sigmoid(acc[0]), sigmoid(acc[1]), sigmoid(acc[2]), sigmoid(acc[3]));
  }
}

// B4: pre[b,l] = b_s1 + sum_t w[t] * xw[b,t,l]; out = sigma(pre).
__global__ void __launch_bounds__(THREADS)
pool_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ pre,
                float* __restrict__ out, long long total) {
  const long long idx = global_index();
  if (idx >= total) return;
  const long long img = idx / LANES;
  const int lane = static_cast<int>(idx - img * LANES);
  const float* xi = xw + img * (TAPS * LANES) + lane;
  float acc = bias[0];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) acc = __fadd_rn(acc, __fmul_rn(w[t], xi[t * LANES]));
  pre[idx] = acc;
  out[idx] = sigmoid(acc);
}

// B5: pre[b,o] = (sum_k x[b,k] * w[o,k]) + b_f[o]; out = sigma(pre).
// Warp v of the grid takes images v, v + warps, ...; lane l < FC_FWD_LANES
// sums k = FC_K * l .. FC_K * l + FC_K - 1 upward by fmaf from 0 for each
// class (the other lanes hold 0), the xor butterfly (16, 8, 4, 2, 1) adds
// the lanes, and lane o < CLASSES adds b[o].
__global__ void __launch_bounds__(32 * FC_FWD_WARPS)
fc_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ pre,
              float* __restrict__ out, int n) {
  const int lane = threadIdx.x & 31;
  const int warps = static_cast<int>(gridDim.x) * FC_FWD_WARPS;
  const bool live = lane < FC_FWD_LANES;
  const int k0 = (live ? lane : 0) * FC_K;  // dead lanes read lane 0's slice, then drop it
  const bool xvec = aligned16(x);
  float wr[CLASSES][FC_K];
#pragma unroll
  for (int o = 0; o < CLASSES; ++o) {
    load8(wr[o], w + o * LANES + k0, aligned16(w));
#pragma unroll
    for (int k = 0; k < FC_K; ++k) wr[o][k] = live ? wr[o][k] : 0.0f;
  }
  const float bo = __ldg(bias + (lane < CLASSES ? lane : 0));
  for (int img = static_cast<int>(blockIdx.x) * FC_FWD_WARPS + (threadIdx.x >> 5); img < n;
       img += warps) {
    float xr[FC_K];
    load8(xr, x + static_cast<long long>(img) * LANES + k0, xvec);
    float acc[CLASSES];
#pragma unroll
    for (int o = 0; o < CLASSES; ++o) {
      acc[o] = 0.0f;
#pragma unroll
      for (int k = 0; k < FC_K; ++k) acc[o] = fmaf(live ? xr[k] : 0.0f, wr[o][k], acc[o]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int o = 0; o < CLASSES; ++o) acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], off);
    float v = acc[0];
#pragma unroll
    for (int o = 1; o < CLASSES; ++o) v = lane == o ? acc[o] : v;
    if (lane < CLASSES) {
      const float p = v + bo;
      const long long i = static_cast<long long>(img) * CLASSES + lane;
      pre[i] = p;
      out[i] = sigmoid(p);
    }
  }
}

// B6's gw/gb block `slab`: gw[o, c0 + c] = sum_b d[b,o] * s[b, c0 + c] for
// its FC_SLAB columns c0.., and (block 0) gb[o] = sum_b d[b,o].
__device__ __forceinline__ void fc_bwd_grads(const float* __restrict__ d,
                                             const float* __restrict__ s,
                                             float* __restrict__ gw, float* __restrict__ gb,
                                             int n, int slab, float* smem) {
  float* ds = smem;                                // FC_ROWS x CLASSES
  float* ss = ds + FC_ROWS * CLASSES;              // FC_ROWS x FC_SLAB
  float* red = ss + FC_ROWS * FC_SLAB;             // FC_WARPS x CLASSES x FC_SLAB
  float* redb = red + FC_WARPS * CLASSES * FC_SLAB;  // FC_WARPS x CLASSES
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = lane & 7;
  const int shard = warp * 4 + (lane >> 3);
  const int c0 = slab * FC_SLAB;
  const bool bias = slab == 0;
  const int sh = (min(n, FC_ROWS) + FC_SHARDS - 1) / FC_SHARDS;
  const float* sg = s + c0;
  const bool dvec = aligned16(d);
  const bool svec = aligned16(sg);  // rows are 864 bytes: all aligned or none
  float acc[CLASSES][FC_COLS];
  float accb[CLASSES];
#pragma unroll
  for (int o = 0; o < CLASSES; ++o) {
    accb[o] = 0.0f;
#pragma unroll
    for (int c = 0; c < FC_COLS; ++c) acc[o][c] = 0.0f;
  }
  for (int r0 = 0; r0 < n; r0 += FC_ROWS) {
    const int nr = min(FC_ROWS, n - r0);
    const float* dg = d + static_cast<long long>(r0) * CLASSES;
    const int dn = nr * CLASSES;
    const int dq = dvec ? dn / 4 : 0;
    for (int i = tid; i < dq; i += THREADS) ftile::cp_async16(ds + 4 * i, dg + 4 * i, true);
    for (int i = 4 * dq + tid; i < dn; i += THREADS) ftile::cp_async4(ds + i, dg + i, true);
    const float* sr = sg + static_cast<long long>(r0) * LANES;
    if (svec) {
      for (int i = tid; i < nr * (FC_SLAB / 4); i += THREADS) {
        const int r = i / (FC_SLAB / 4);
        const int q = i - r * (FC_SLAB / 4);
        ftile::cp_async16(ss + r * FC_SLAB + 4 * q,
                          sr + static_cast<long long>(r) * LANES + 4 * q, true);
      }
    } else {
      for (int i = tid; i < nr * FC_SLAB; i += THREADS) {
        const int r = i / FC_SLAB;
        ftile::cp_async4(ss + i, sr + static_cast<long long>(r) * LANES + (i - r * FC_SLAB),
                         true);
      }
    }
    ftile::cp_async_commit();
    ftile::cp_async_wait<0>();
    __syncthreads();
    const int lo = shard * sh;
    const int hi = min(lo + sh, nr);
    for (int b = lo; b < hi; ++b) {
      float dv[CLASSES];
#pragma unroll
      for (int o = 0; o < CLASSES; ++o) dv[o] = ds[b * CLASSES + o];
#pragma unroll
      for (int c = 0; c < FC_COLS; ++c) {
        const float sv = ss[b * FC_SLAB + col + 8 * c];
#pragma unroll
        for (int o = 0; o < CLASSES; ++o) acc[o][c] = fmaf(dv[o], sv, acc[o][c]);
      }
      if (bias) {
#pragma unroll
        for (int o = 0; o < CLASSES; ++o) accb[o] += dv[o];
      }
    }
    __syncthreads();  // the next chunk overwrites the stage
  }
  // The warp's four shards (lanes col, col+8, col+16, col+24), then the
  // eight warps in order.
#pragma unroll
  for (int o = 0; o < CLASSES; ++o) {
#pragma unroll
    for (int c = 0; c < FC_COLS; ++c) {
      float v = acc[o][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 8) red[(warp * CLASSES + o) * FC_SLAB + col + 8 * c] = v;
    }
    if (bias) {
      float v = accb[o];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane == 0) redb[warp * CLASSES + o] = v;
    }
  }
  __syncthreads();
  for (int i = tid; i < CLASSES * FC_SLAB; i += THREADS) {
    float v = red[i];
    for (int w = 1; w < FC_WARPS; ++w) v += red[w * CLASSES * FC_SLAB + i];
    const int o = i / FC_SLAB;
    gw[o * LANES + c0 + (i - o * FC_SLAB)] = v;
  }
  if (bias && tid < CLASSES) {
    float v = redb[tid];
    for (int w = 1; w < FC_WARPS; ++w) v += redb[w * CLASSES + tid];
    gb[tid] = v;
  }
}

// B6's dout block `blk`: dout[b, 4q..4q+3] = sum_o d[b,o] * w[o, 4q..4q+3],
// one float4 a thread, w staged in shared memory.
__device__ __forceinline__ void fc_bwd_dout(const float* __restrict__ d,
                                            const float* __restrict__ w,
                                            float* __restrict__ dout, int n, int blk,
                                            float* ws) {
  const int tid = threadIdx.x;
  const int wq = aligned16(w) ? CLASSES * LANES / 4 : 0;
  for (int i = tid; i < wq; i += THREADS) ftile::cp_async16(ws + 4 * i, w + 4 * i, true);
  for (int i = 4 * wq + tid; i < CLASSES * LANES; i += THREADS)
    ftile::cp_async4(ws + i, w + i, true);
  ftile::cp_async_commit();
  const long long e = static_cast<long long>(blk) * THREADS + tid;
  const bool live = e < static_cast<long long>(n) * FC_QUADS;
  const long long img = live ? e / FC_QUADS : 0;
  const int q = static_cast<int>(e - img * FC_QUADS);
  float dv[CLASSES];
#pragma unroll
  for (int o = 0; o < CLASSES; ++o) dv[o] = live ? __ldg(d + img * CLASSES + o) : 0.0f;
  ftile::cp_async_wait<0>();
  __syncthreads();
  if (!live) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int o = 0; o < CLASSES; ++o) {
    const float4 wv = *reinterpret_cast<const float4*>(ws + o * LANES + 4 * q);
    acc.x = fmaf(dv[o], wv.x, acc.x);
    acc.y = fmaf(dv[o], wv.y, acc.y);
    acc.z = fmaf(dv[o], wv.z, acc.z);
    acc.w = fmaf(dv[o], wv.w, acc.w);
  }
  *reinterpret_cast<float4*>(dout + img * LANES + 4 * q) = acc;
}

// B6: blocks [0, FC_SLAB_BLOCKS) are gw/gb blocks, the rest dout blocks.
__global__ void __launch_bounds__(THREADS)
fc_bwd_kernel(const float* __restrict__ d, const float* __restrict__ s,
              const float* __restrict__ w, float* __restrict__ gw,
              float* __restrict__ gb, float* __restrict__ dout, int n) {
  __shared__ __align__(16) float smem[FC_SMEM_FLOATS];
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < FC_SLAB_BLOCKS)
    fc_bwd_grads(d, s, gw, gb, n, blk, smem);
  else
    fc_bwd_dout(d, w, dout, n, blk - FC_SLAB_BLOCKS, smem);
}

// B7: dpre = dout * s * (1 - s) with s = sigma(pre); dxw[b,t,l] = w[t] * dpre[b,l].
// Thread g of the grid (g < threads = n * POOL_BWD_SPLIT * POOL_BWD_GROUPS)
// owns lanes l0 .. l0 + POOL_BWD_VEC - 1 of image g / (POOL_BWD_SPLIT *
// POOL_BWD_GROUPS) and rows part * ROWS .. part * ROWS + ROWS - 1 of its
// dxw, part = (g / POOL_BWD_GROUPS) % POOL_BWD_SPLIT; part 0 also stores
// dpre.
__global__ void __launch_bounds__(POOL_BWD_THREADS)
pool_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ pre,
                const float* __restrict__ w, float* __restrict__ dpre,
                float* __restrict__ dxw, long long threads) {
  constexpr int V = POOL_BWD_VEC;
  constexpr int ROWS = TAPS / POOL_BWD_SPLIT;
  const long long g = static_cast<long long>(blockIdx.x) * POOL_BWD_THREADS + threadIdx.x;
  if (g >= threads) return;
  const long long row = g / POOL_BWD_GROUPS;  // (image, part)
  const int l0 = static_cast<int>(g - row * POOL_BWD_GROUPS) * V;
  const long long img = row / POOL_BWD_SPLIT;
  const int part = static_cast<int>(row - img * POOL_BWD_SPLIT);
  const long long o = img * LANES + l0;
  float wr[ROWS];
  load_taps<ROWS>(wr, w + part * ROWS);
  float d[V], p[V], dp[V];
  load_lanes<V>(d, dout + o);
  load_lanes<V>(p, pre + o);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float s = sigmoid(p[k]);
    dp[k] = d[k] * s * (1.0f - s);
  }
  if (part == 0) store_vec<V>(dpre + o, dp);
  float* di = dxw + img * (TAPS * LANES) + part * ROWS * LANES + l0;
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    float r[V];
#pragma unroll
    for (int k = 0; k < V; ++k) r[k] = wr[t] * dp[k];
    store_vec<V>(di + t * LANES, r);
  }
}

// Four floats from p: one float4 load where p lies on a 16-byte boundary
// (vec), else four 4-byte loads.
__device__ __forceinline__ void load_quad(float (&v)[4], const float* __restrict__ p,
                                          bool vec) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    v[0] = __ldg(p), v[1] = __ldg(p + 1), v[2] = __ldg(p + 2), v[3] = __ldg(p + 3);
  }
}

// B8: out = d * s * (1 - s) with s = sigma(pre), elementwise over `quads`
// float4 quads. Pass k of block b covers quads (b + k * gridDim.x) * SPAN
// onward, SPAN = SIGMA_THREADS * SIGMA_VEC; its thread t holds quads
// t + u * SIGMA_THREADS of them, u < SIGMA_VEC.
__global__ void __launch_bounds__(SIGMA_THREADS)
sigma_prime_kernel(const float* __restrict__ d, const float* __restrict__ pre,
                   float* __restrict__ out, long long quads) {
  constexpr long long SPAN = static_cast<long long>(SIGMA_THREADS) * SIGMA_VEC;
  const bool dvec = aligned16(d);
  const bool pvec = aligned16(pre);
  for (long long q0 = blockIdx.x * SPAN + threadIdx.x; q0 < quads; q0 += gridDim.x * SPAN) {
    float dv[SIGMA_VEC][4] = {}, pv[SIGMA_VEC][4] = {};
#pragma unroll
    for (int u = 0; u < SIGMA_VEC; ++u) {
      const long long q = q0 + u * SIGMA_THREADS;
      if (q < quads) {
        load_quad(dv[u], d + 4 * q, dvec);
        load_quad(pv[u], pre + 4 * q, pvec);
      }
    }
#pragma unroll
    for (int u = 0; u < SIGMA_VEC; ++u) {
      const long long q = q0 + u * SIGMA_THREADS;
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float s = sigmoid(pv[u][k]);
        o[k] = dv[u][k] * s * (1.0f - s);
      }
      if (q < quads) store_vec<4>(out + 4 * q, o);
    }
  }
}

// B9: out[p,q] = sum_r a[r,p] * b[r,q], one launch (accum_plan gives the
// grid; dynamic shared memory holds the row stages, then the finish). Block g owns rows [g*shard, (g+1)*shard) and one warp a tile of
// ACCUM_TA x ACCUM_TB outputs (tile w covers rows p0 = (w / tiles_b) *
// ACCUM_TA and columns q0 = (w % tiles_b) * ACCUM_TB of out; a tile's
// columns past ka or kb read column ka-1 or kb-1 and are dropped). The
// block stages its rows into shared memory, stage_rows at a time, two
// stages in flight, with cp.async (16-byte copies where a and b start on a
// 16-byte boundary; a block's rows always do then). Lane l of a warp sums
// rows g*shard + l + 32k, k ascending, one fmaf a term from 0;
// ftile::warp_sum32 adds the 32 lanes. So block g's partial of (p, q) is
// written by one lane. Then each block takes a ticket; the last block
// copies every partial into shared memory and sums them: thread t < S*outs (S = blockDim / outs) sums partial g =
// t / outs, + S, + 2S, ... of output t % outs in g order, and thread o adds
// the S shard sums in shard order. Every order depends on (rows, ka, kb)
// alone. The ticket is an integer atomicInc that wraps to 0 at the last
// block, so it is 0 again for the next launch.
__global__ void __launch_bounds__(ACCUM_MAX_THREADS)
accum_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b, int rows,
                    int ka, int kb, int shard, int stage_rows,
                    float* __restrict__ partials, unsigned* __restrict__ ticket,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];  // 2 row stages; then the finish's
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles_b = (kb + ACCUM_TB - 1) / ACCUM_TB;
  const int p0 = (warp / tiles_b) * ACCUM_TA;
  const int q0 = (warp % tiles_b) * ACCUM_TB;
  const int r0 = blockIdx.x * shard;
  const int nrows = min(shard, rows - r0);
  const int outs = ka * kb;
  const bool avec = aligned16(a);
  const bool bvec = aligned16(b);

  int pc[ACCUM_TA], qc[ACCUM_TB];
#pragma unroll
  for (int p = 0; p < ACCUM_TA; ++p) pc[p] = min(p0 + p, ka - 1);
#pragma unroll
  for (int q = 0; q < ACCUM_TB; ++q) qc[q] = min(q0 + q, kb - 1);

  const int stage_floats = stage_rows * (ka + kb);
  const int stages = (nrows + stage_rows - 1) / stage_rows;
  auto copy = [&](float* dst, const float* src, int count, bool vec) {
    const int quads = vec ? count / 4 : 0;
    for (int i = tid; i < quads; i += blockDim.x) ftile::cp_async16(dst + 4 * i, src + 4 * i, true);
    for (int i = 4 * quads + tid; i < count; i += blockDim.x) ftile::cp_async4(dst + i, src + i, true);
  };
  auto stage = [&](int st) {
    const int base = r0 + st * stage_rows;
    const int nr = min(stage_rows, r0 + nrows - base);
    float* as = smem + (st & 1) * stage_floats;
    copy(as, a + static_cast<long long>(base) * ka, nr * ka, avec);
    copy(as + stage_rows * ka, b + static_cast<long long>(base) * kb, nr * kb, bvec);
    ftile::cp_async_commit();
  };

  float acc[ACCUM_TA * ACCUM_TB];
#pragma unroll
  for (int k = 0; k < ACCUM_TA * ACCUM_TB; ++k) acc[k] = 0.0f;
  stage(0);
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      stage(st + 1);
      ftile::cp_async_wait<1>();
    } else {
      ftile::cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = smem + (st & 1) * stage_floats;
    const float* bs = as + stage_rows * ka;
    const int nr = min(stage_rows, nrows - st * stage_rows);
    for (int r = lane; r < nr; r += 32) {
      float av[ACCUM_TA], bv[ACCUM_TB];
#pragma unroll
      for (int p = 0; p < ACCUM_TA; ++p) av[p] = as[r * ka + pc[p]];
#pragma unroll
      for (int q = 0; q < ACCUM_TB; ++q) bv[q] = bs[r * kb + qc[q]];
#pragma unroll
      for (int p = 0; p < ACCUM_TA; ++p)
#pragma unroll
        for (int q = 0; q < ACCUM_TB; ++q)
          acc[p * ACCUM_TB + q] = fmaf(av[p], bv[q], acc[p * ACCUM_TB + q]);
    }
    __syncthreads();  // the stage after next overwrites this one
  }

  const float v = ftile::warp_sum32(acc);
  const int p = p0 + lane / ACCUM_TB;
  const int q = q0 + lane % ACCUM_TB;
  if (p < ka && q < kb) partials[static_cast<long long>(blockIdx.x) * outs + p * kb + q] = v;
  __syncthreads();  // the block's partial is written; thread 0's fence then
  if (tid == 0) {   // makes it visible at device scope before the ticket
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // Every block's partial into shared memory at once (one round trip; a
  // thread summing them from L2 one after another waits a round trip
  // each), then the sums from there.
  const int total = static_cast<int>(gridDim.x) * outs;
  float* parts = smem;
  const int quads = aligned16(partials) ? total / 4 : 0;
  for (int i = tid; i < quads; i += blockDim.x)
    ftile::cp_async16(parts + 4 * i, partials + 4 * i, true);
  for (int i = 4 * quads + tid; i < total; i += blockDim.x) parts[i] = __ldcg(partials + i);
  ftile::cp_async_commit();
  ftile::cp_async_wait<0>();
  __syncthreads();
  const int shards = blockDim.x / outs;
  if (shards <= 1) {
    for (int o = tid; o < outs; o += blockDim.x) {
      float sum = parts[o];
      for (int g = 1; g < static_cast<int>(gridDim.x); ++g) sum += parts[g * outs + o];
      out[o] = sum;
    }
    return;
  }
  float* red = parts + total;  // shards x outs <= blockDim floats
  if (tid < shards * outs) {
    const int o = tid % outs;
    const int s = tid / outs;
    float sum = 0.0f;
    for (int g = s; g < static_cast<int>(gridDim.x); g += shards)
      sum = g == s ? parts[g * outs + o] : sum + parts[g * outs + o];
    red[tid] = sum;
  }
  __syncthreads();
  if (tid < outs) {
    float sum = red[tid];
    for (int s = 1; s < shards; ++s) sum += red[s * outs + tid];
    out[tid] = sum;
  }
}

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers to
// contiguous f32 arrays of the shapes above; n >= 1 is the batch. Each
// returns 0 when its launches were accepted, else the cudaError_t.

// B3 also refuses a pre or out that does not start on a 16-byte boundary
// (its float4 stores; the wrapper allocates them).
extern "C" int lenet_conv_fwd(const float* x, const float* w, const float* b,
                              float* pre, float* out, int n, void* stream) {
  const long long blocks = static_cast<long long>(n) * CONV_GROUPS;
  if (n <= 0 || blocks > INT_MAX || !aligned16(pre) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  conv_fwd_kernel<<<static_cast<int>(blocks), CONV_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, w, b, pre, out);
  return launched();
}

extern "C" int lenet_pool_fwd(const float* xw, const float* w, const float* b,
                              float* pre, float* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * LANES;
  pool_fwd_kernel<<<blocks_for(total), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xw, w, b, pre, out, total);
  return launched();
}

extern "C" int lenet_fc_fwd(const float* x, const float* w, const float* b,
                            float* pre, float* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = n < FC_FWD_WAVE ? n : FC_FWD_WAVE;
  fc_fwd_kernel<<<(warps + FC_FWD_WARPS - 1) / FC_FWD_WARPS, 32 * FC_FWD_WARPS, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, w, b, pre, out, n);
  return launched();
}

// B6 also refuses a dout that does not start on a 16-byte boundary (its
// float4 stores; the wrapper allocates it).
extern "C" int lenet_fc_bwd(const float* d, const float* s, const float* w,
                            float* gw, float* gb, float* dout, int n, void* stream) {
  if (n <= 0 || !aligned16(dout)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = FC_SLAB_BLOCKS + blocks_for(static_cast<long long>(n) * FC_QUADS);
  fc_bwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      d, s, w, gw, gb, dout, n);
  return launched();
}

// B7 also refuses a dpre or dxw that does not start on a 16-byte boundary
// (its vector stores; the wrapper allocates them).
extern "C" int lenet_pool_bwd(const float* dout, const float* pre, const float* w,
                              float* dpre, float* dxw, int n, void* stream) {
  const long long threads = static_cast<long long>(n) * POOL_BWD_SPLIT * POOL_BWD_GROUPS;
  const long long blocks = (threads + POOL_BWD_THREADS - 1) / POOL_BWD_THREADS;
  if (n <= 0 || blocks > INT_MAX || !aligned16(dpre) || !aligned16(dxw))
    return static_cast<int>(cudaErrorInvalidValue);
  pool_bwd_kernel<<<static_cast<int>(blocks), POOL_BWD_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(dout, pre, w, dpre, dxw, threads);
  return launched();
}

// B8 also refuses an out that does not start on a 16-byte boundary (its
// float4 stores; the wrapper allocates it).
extern "C" int lenet_sigma_prime(const float* d, const float* pre, float* out,
                                 int n, void* stream) {
  if (n <= 0 || !aligned16(out)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr long long SPAN = static_cast<long long>(SIGMA_THREADS) * SIGMA_VEC;
  const long long quads = static_cast<long long>(n) * CONV_QUADS;
  const long long blocks = (quads + SPAN - 1) / SPAN;
  sigma_prime_kernel<<<static_cast<int>(blocks < SIGMA_WAVE ? blocks : SIGMA_WAVE),
                       SIGMA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(d, pre, out,
                                                                              quads);
  return launched();
}

// B9's grid from the shape alone: shard rows a block (a multiple of
// ACCUM_ROW_ALIGN, at least ACCUM_ROWS, so that at most ACCUM_BLOCKS blocks
// cover the rows), the blocks, and the rows a stage (two stages of a and b
// in the 48 KB of shared memory a launch gets unasked, a multiple of 32).
// ops/lenet_staged.py's accum_plan is the same function.
static void accum_plan(int rows, int ka, int kb, int* shard, int* blocks, int* stage_rows) {
  long long s = (static_cast<long long>(rows) + ACCUM_BLOCKS - 1) / ACCUM_BLOCKS;
  s = (s + ACCUM_ROW_ALIGN - 1) / ACCUM_ROW_ALIGN * ACCUM_ROW_ALIGN;
  *shard = static_cast<int>(s < ACCUM_ROWS ? ACCUM_ROWS : s);
  *blocks = static_cast<int>((static_cast<long long>(rows) + *shard - 1) / *shard);
  *stage_rows = ACCUM_SMEM_FLOATS / (2 * (ka + kb)) / 32 * 32;
}

// a (rows, ka), b (rows, kb), partials (blocks, ka*kb) f32, ticket one
// unsigned int that is 0 (the launch leaves it 0), out (ka, kb). The one
// place B9's limits are kept: 1 <= rows <= INT_MAX, ka, kb >= 1, ka*kb <=
// 256 and ka + kb <= 48 (two stages of 128 rows in 48 KB of shared
// memory). Anything else is refused with cudaErrorInvalidValue.
extern "C" int lenet_accum_matmul(const float* a, const float* b, long long rows,
                                  long long ka, long long kb, float* partials,
                                  unsigned* ticket, float* out, void* stream) {
  if (rows <= 0 || rows > INT_MAX || ka <= 0 || kb <= 0 || ka * kb > ACCUM_MAX_OUTS ||
      ka + kb > ACCUM_MAX_COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  int shard, blocks, stage_rows;
  accum_plan(static_cast<int>(rows), static_cast<int>(ka), static_cast<int>(kb), &shard,
             &blocks, &stage_rows);
  const int tiles = static_cast<int>((ka + ACCUM_TA - 1) / ACCUM_TA * ((kb + ACCUM_TB - 1) / ACCUM_TB));
  // Shared memory: the row stages, or the last block's copy of every
  // partial with the shard sums after it, whichever is larger.
  const long long finish = static_cast<long long>(blocks) * ka * kb + 32 * tiles;
  const long long staged = 2LL * stage_rows * (ka + kb);
  const size_t smem = sizeof(float) * (finish > staged ? finish : staged);
  static bool smem_ok = false;
  const cudaError_t err = ftile::allow_smem(accum_matmul_kernel, ACCUM_MAX_SMEM_BYTES, smem_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  accum_matmul_kernel<<<blocks, 32 * tiles, smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, static_cast<int>(rows), static_cast<int>(ka), static_cast<int>(kb), shard,
      stage_rows, partials, ticket, out);
  return launched();
}

// B9's grid for (rows, ka, kb), for the wrapper's check of its own plan:
// out = {shard, blocks, stage_rows, threads}. Returns 0, or
// cudaErrorInvalidValue for a shape lenet_accum_matmul refuses.
extern "C" int lenet_accum_plan(long long rows, long long ka, long long kb, int* out) {
  if (rows <= 0 || rows > INT_MAX || ka <= 0 || kb <= 0 || ka * kb > ACCUM_MAX_OUTS ||
      ka + kb > ACCUM_MAX_COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  accum_plan(static_cast<int>(rows), static_cast<int>(ka), static_cast<int>(kb), &out[0],
             &out[1], &out[2]);
  out[3] = static_cast<int>(32 * ((ka + ACCUM_TA - 1) / ACCUM_TA) * ((kb + ACCUM_TB - 1) / ACCUM_TB));
  return 0;
}

// The layout constants the wrapper sizes its tensors by, for its check:
// i = 0..5 gives IMG, CONV, LANES, TAPS, CLASSES, ACCUM_ROWS, 6..10 B9's
// plan constants ACCUM_TA, ACCUM_TB, ACCUM_BLOCKS, ACCUM_ROW_ALIGN,
// ACCUM_SMEM_FLOATS, and 11 B5's k a lane FC_K (fc_fwd_order's); else -1.
extern "C" int lenet_staged_dim(int i) {
  const int dims[] = {IMG, CONV, LANES, TAPS, CLASSES, ACCUM_ROWS, ACCUM_TA, ACCUM_TB,
                      ACCUM_BLOCKS, ACCUM_ROW_ALIGN, ACCUM_SMEM_FLOATS, FC_K};
  return (i >= 0 && i < 12) ? dims[i] : -1;
}
