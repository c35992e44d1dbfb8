// The whole LeNet-ref train step's math in one kernel: forward, error and
// the hand-written reference backward, with the batch mean of the grads.
// Written for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel `_fused_kernel`
// (parallel_cnn_tpu/ops/pallas.py:589, launched by `_fused_call` at
// pallas.py:712 from `fused_value_and_ref_grads` at pallas.py:762).
//
// What it computes, for n images x (n,28,28) and labels y (n,):
//   per image: conv 6x5x5 valid + bias -> sigmoid -> one shared 4x4 kernel
//   at stride 4 per map + scalar bias -> sigmoid -> dense 216->10 -> sigmoid;
//   d_pre_f = onehot(y) - out_f (no sigmoid' factor), err = ||d_pre_f||_2;
//   then the backward of ops/reference.py:129-183.
//   out = [grads of the batch, MEAN over the n images, in the params tree's
//   flatten order c1/b, c1/w, f/b, f/w, s1/b, s1/w; then the mean err].
//   Conv w and b grads carry the reference's /576, the pool bias /216, the
//   FC grads none. The pool->FC flatten is C-order: lane m*36 + x*6 + y;
//   window (x, y) covers rows 4x..4x+3 and columns 4y..4y+3, tap 4i+j.
//
// Bound on an H100 SXM. Per image: forward conv 86,400 multiply-adds, pool
// 3,456, FC 2,160; backward FC wgrad 2,160, FC dX 2,160, pool wgrad 3,456,
// pool scatter 3,456, conv wgrad 86,400: 189,648 MAC, 379 kFLOP. At batch
// 64 that is 24.3 MFLOP, 0.36 us at the f32 peak of 67 TFLOP/s, against
// ~0.22 MB moved (images, labels, params, grads), 0.07 us at 3.35 TB/s. The
// step is bound by operations, and at batch 64 both bounds sit below a
// launch's latency: what sets the time is how long one warp's chain of
// dependent instructions takes, and the round trips to device memory.
//
// Design. Everything of one image but the FC forward and d_pre_f splits by
// conv map: the forward conv, the pool, sigma', the pool scatter and the
// conv weight and bias grads of map m touch only map m. Pass 1 gives each
// image one block and each map WARPS_PER_MAP warps (benches/lenet_sweep.py
// times the choices on the card; PERF.md has its readings).
//   - Register tiles. A lane owns a BR x 3 block of its map's 24x24
//     outputs. The forward conv slides a 7-wide x row through registers
//     (BR + 4 rows of the image: 49 shared loads for 225 fmas, against 2
//     loads a fma one output a thread); the map's 25 weights are in
//     registers. The conv's outputs stay in registers for sigma' and the
//     weight grad; shared memory holds them only for the pool's 4x4
//     windows. The conv weight grad walks the same x rows against the
//     lane's d_pre_c1 values, keeping all 25 tap sums (and the bias sum) in
//     registers. x's row stride in shared memory (XS) puts the 32 lanes'
//     loads of a row on 32 banks.
//   - Fixed trees. A warp's per-lane sums (the FC partial, the pool grads,
//     the 26 conv grads) finish in ftile::warp_sum32 (csrc/ffma_tile.cuh):
//     a transposing shuffle tree, 31 shuffles for 32 values, whose pairing
//     is the xor butterfly's; then the warps add in warp order through
//     shared memory. Every warp adds the 12 FC partials itself, in the same
//     order, so all hold the same d_pre_f.
//   - What crosses to the batch sum is small: per image s1 (216), d_pre_f
//     (10), err, the 156 conv and 17 pool grads, a row of ROW_PASS1 floats,
//     instead of the 2,160-float outer product df x s1. Pass 2 forms g_w_f
//     = d_pre_f^T . s1 over the batch.
// Pass 2 is a second short launch of 33 blocks, a programmatic dependent
// of pass 1 (scheduled while pass 1 runs, it waits for pass 1's end before
// it reads, so the second launch's latency overlaps the first). It stages
// the rows it reads into shared memory with 16-byte cp.async copies,
// FIN_ROWS rows a stage and two stages in flight, where a thread that read
// rows from device memory one after another would wait a round trip each.
// 27 blocks own 8 of s1's 216
// columns each: the 80 g_w_f values over 32 interleaved batch shards, then
// two shuffles and the 8 warps in order. 6 blocks own 32 of the other
// columns each: 8 shards, then the shards in order. The TPU kernel's
// layout answers (the tap-major (25,B,576) im2col, the Mp (576,36) pool
// scatter matrix, the channel-major FC weight, the row accumulators
// finished in XLA and its bf16 store of the input) have no counterpart:
// the pool is a direct indexed 4x4 sum and the port is f32 end to end.
//
// Determinism. No atomics: every value is summed in one fixed order that
// depends on n alone (the lane blocks, the shuffle trees, the warps in
// order, the batch shards and the trees over them), so the same batch
// gives bit-identical grads on every run. f32 with IEEE expf/sqrtf/
// division; build without --use_fast_math.
//
// The kernels launch on the caller's stream, synchronise nothing and
// allocate nothing: the Python wrapper allocates the (n, ROW_PASS1)
// workspace and the output and checks devices, dtypes, shapes and
// contiguity first.

#include <cstdint>

#include <cuda_runtime.h>

#include "ffma_tile.cuh"  // ftile::warp_sum32, the cp.async helpers

namespace {

constexpr int MAPS = 6;
constexpr int WINDOWS = 36;          // pool windows (lanes of s1) a map
constexpr int CLASSES = 10;
constexpr int S1 = MAPS * WINDOWS;   // 216
// Warps a conv map; the winner of benches/lenet_sweep.py on the card.
constexpr int WARPS_PER_MAP = 2;
constexpr int IMG_WARPS = MAPS * WARPS_PER_MAP;
constexpr int IMG_THREADS = 32 * IMG_WARPS;
// A lane's block of its map's 24x24 outputs: BR rows x 3 columns, 4 row
// blocks x 8 column blocks a warp.
constexpr int BR = 6 / WARPS_PER_MAP;
// x's row stride in shared memory: the 32 lanes' loads of one x row fall
// on 32 banks (rows 4 x BR x XS floats apart, columns 3 apart).
constexpr int XS = WARPS_PER_MAP == 2 ? 40 : 28;
static_assert(6 % WARPS_PER_MAP == 0 && XS % 4 == 0, "whole blocks; float4 rows");
// Pool windows a lane takes: two where a map has one warp (36 windows).
constexpr int WIN_SLOTS = WARPS_PER_MAP == 1 ? 2 : 1;

// One row of the output: grads in the params tree's flatten order, then err.
constexpr int OFF_C1B = 0;     // 6
constexpr int OFF_C1W = 6;     // 150: m*25 + i*5 + j
constexpr int OFF_FB = 156;    // 10
constexpr int OFF_FW = 166;    // 2160: o*216 + k
constexpr int OFF_S1B = 2326;  // 1
constexpr int OFF_S1W = 2327;  // 16: i*4 + j
constexpr int OFF_ERR = 2343;
constexpr int ROW = 2344;

// One image's row of pass 1 (pass 2's input), un-normalised; every segment
// pass 2 stages starts on a 16-byte boundary.
constexpr int P_S1 = 0;        // 216: out_s1, lane m*36 + x*6 + y
constexpr int P_DF = 216;      // 10: d_pre_f
constexpr int P_ERR = 226;     // then one pad
constexpr int P_C1W = 228;     // 150: m*25 + i*5 + j
constexpr int P_C1B = 378;     // 6
constexpr int P_S1W = 384;     // 16: i*4 + j
constexpr int P_S1B = 400;     // then three pads
constexpr int ROW_PASS1 = 404;
constexpr int P_DIRECT = P_DF;                 // the columns summed as they are
constexpr int DIRECT = ROW_PASS1 - P_DIRECT;   // 188

// Pass 2: FW_BLOCKS blocks of FW_COLS s1 columns (and d_pre_f), then
// DIRECT_BLOCKS of DIRECT_COLS raw columns; rows staged FIN_ROWS at a time.
constexpr int FIN_THREADS = 256;
constexpr int FIN_WARPS = FIN_THREADS / 32;
constexpr int FIN_ROWS = 128;
constexpr int FW_COLS = 8;
constexpr int FW_BLOCKS = S1 / FW_COLS;             // 27
constexpr int FW_SHARDS = FIN_THREADS / FW_COLS;    // 32
constexpr int FW_LD = 24;      // a staged row: 8 s1 columns, 12 of d_pre_f, err, pad
constexpr int DIRECT_COLS = 32;
constexpr int DIRECT_SHARDS = FIN_THREADS / DIRECT_COLS;  // 8
constexpr int DIRECT_BLOCKS = (DIRECT + DIRECT_COLS - 1) / DIRECT_COLS;  // 6
constexpr int FIN_SMEM_FLOATS = 2 * FIN_ROWS * (FW_LD > DIRECT_COLS ? FW_LD : DIRECT_COLS);
static_assert(S1 % FW_COLS == 0 && P_DIRECT % 4 == 0 && ROW_PASS1 % 4 == 0 &&
              P_C1W % 4 == 0, "16-byte segments");
static_assert(FIN_SMEM_FLOATS * 4 <= 40 * 1024, "static shared memory");

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Pass 1: one image a block of IMG_WARPS warps, WARPS_PER_MAP a map.
// Writes the image's row of pass-1 values to rows[img].
__global__ void __launch_bounds__(IMG_THREADS)
lenet_step_image(const float* __restrict__ xs, const int* __restrict__ ys,
                 const float* __restrict__ w_c1, const float* __restrict__ b_c1,
                 const float* __restrict__ w_s1, const float* __restrict__ b_s1,
                 const float* __restrict__ w_f, const float* __restrict__ b_f,
                 float* __restrict__ rows, bool x_vec) {
  __shared__ __align__(16) float x[28 * XS];
  __shared__ float c1[MAPS][576];     // out_c1, r*24 + c
  __shared__ float ds1[MAPS][WINDOWS];
  __shared__ float ws_s[16];
  __shared__ float fc_part[IMG_WARPS][CLASSES];
  __shared__ float pool_part[IMG_WARPS][17];
  __shared__ float conv_part[IMG_WARPS][26];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m = warp / WARPS_PER_MAP;
  const int wm = warp - m * WARPS_PER_MAP;  // the warp within its map
  const int img = blockIdx.x;
  float* row = rows + static_cast<size_t>(img) * ROW_PASS1;
  // Pass 2 may be scheduled now: it waits for this grid's end before it
  // reads (griddepcontrol.wait), so its launch overlaps this pass.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const float* xg = xs + static_cast<size_t>(img) * 784;
  if (x_vec) {
    for (int i = tid; i < 196; i += IMG_THREADS) {
      const int r = i / 7;
      *reinterpret_cast<float4*>(x + r * XS + 4 * (i - 7 * r)) =
          __ldg(reinterpret_cast<const float4*>(xg) + i);
    }
  } else {
    for (int i = tid; i < 784; i += IMG_THREADS) {
      const int r = i / 28;
      x[r * XS + i - 28 * r] = __ldg(xg + i);
    }
  }
  if (tid < 16) ws_s[tid] = __ldg(w_s1 + tid);
  float wc[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) wc[k] = __ldg(w_c1 + m * 25 + k);
  const float bc = __ldg(b_c1 + m);
  float ws[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) ws[t] = __ldg(w_s1 + t);
  const float bs = __ldg(b_s1);
  const int label = __ldg(ys + img);
  const float bf = __ldg(b_f + (lane < CLASSES ? lane : 0));
  __syncthreads();

  // The lane's block: rows r0..r0+BR-1, columns c0..c0+2 of map m.
  const int r0 = BR * (4 * wm + (lane >> 3));
  const int c0 = 3 * (lane & 7);

  // Forward conv: each output sums its 25 taps in (i, j) order from 0.
  float cv[BR][3];
#pragma unroll
  for (int a = 0; a < BR; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) cv[a][c] = 0.0f;
#pragma unroll
  for (int R = 0; R < BR + 4; ++R) {
    float xr[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) xr[k] = x[(r0 + R) * XS + c0 + k];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int a = R - i;
      if (a < 0 || a >= BR) continue;
#pragma unroll
      for (int j = 0; j < 5; ++j)
#pragma unroll
        for (int c = 0; c < 3; ++c) cv[a][c] = fmaf(wc[i * 5 + j], xr[c + j], cv[a][c]);
    }
  }
  float* c1m = c1[m];
#pragma unroll
  for (int a = 0; a < BR; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      cv[a][c] = sigmoid(cv[a][c] + bc);
      c1m[(r0 + a) * 24 + c0 + c] = cv[a][c];
    }
  __syncthreads();  // the map's outputs, from all of its warps

  // Forward pool: the map's lane ml takes window ml, and (one warp a map)
  // lanes 0..3 also window 32 + ml.
  const int ml = wm * 32 + lane;
  bool has[2] = {false, false};
  int win[2] = {0, 0};
  float s1v[2] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < WIN_SLOTS; ++k) {
    const int w = ml + 32 * WARPS_PER_MAP * k;
    has[k] = w < WINDOWS;
    win[k] = has[k] ? w : 0;
    const int px = win[k] / 6;
    const float* base = c1m + (4 * px) * 24 + 4 * (win[k] - 6 * px);
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) acc = fmaf(ws[t], base[(t >> 2) * 24 + (t & 3)], acc);
    s1v[k] = has[k] ? sigmoid(acc + bs) : 0.0f;
  }

  // FC forward, this warp's share of the 10 dot products.
  float wfv[2][CLASSES];
  float part[32];
#pragma unroll
  for (int o = 0; o < CLASSES; ++o) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      wfv[k][o] = has[k] ? __ldg(w_f + o * S1 + m * WINDOWS + win[k]) : 0.0f;
    part[o] = WIN_SLOTS == 2 ? fmaf(wfv[1][o], s1v[1], wfv[0][o] * s1v[0])
                             : wfv[0][o] * s1v[0];
  }
#pragma unroll
  for (int o = CLASSES; o < 32; ++o) part[o] = 0.0f;
  const float fc_sum = ftile::warp_sum32(part);
  if (lane < CLASSES) fc_part[warp][lane] = fc_sum;
  __syncthreads();

  // Every warp adds the warps' partials in warp order: the same d_pre_f.
  float df = 0.0f;
  if (lane < CLASSES) {
    float z = fc_part[0][lane];
#pragma unroll
    for (int w = 1; w < IMG_WARPS; ++w) z += fc_part[w][lane];
    df = (lane == label ? 1.0f : 0.0f) - sigmoid(z + bf);
  }
  float dfa[CLASSES];
#pragma unroll
  for (int o = 0; o < CLASSES; ++o) dfa[o] = __shfl_sync(FULL, df, o);
  if (warp == 0) {
    if (lane < CLASSES) row[P_DF + lane] = df;
    if (lane == 0) {
      float ss = 0.0f;
#pragma unroll
      for (int o = 0; o < CLASSES; ++o) ss = fmaf(dfa[o], dfa[o], ss);
      row[P_ERR] = sqrtf(ss);
    }
  }

  // d_pre_s1 of the lane's windows, (sum_o w_f[o,k] d_pre_f[o]) * s(1-s),
  // and this warp's share of the pool grads: g_w_s1[t] = sum over windows
  // of d_pre_s1 * out_c1[window tap t], g_b_s1 = sum of d_pre_s1.
  float pg[32];
#pragma unroll
  for (int t = 0; t < 32; ++t) pg[t] = 0.0f;
#pragma unroll
  for (int k = 0; k < WIN_SLOTS; ++k) {
    float acc = 0.0f;
#pragma unroll
    for (int o = 0; o < CLASSES; ++o) acc = fmaf(wfv[k][o], dfa[o], acc);
    const float d = has[k] ? acc * (s1v[k] * (1.0f - s1v[k])) : 0.0f;
    if (has[k]) {
      ds1[m][win[k]] = d;
      row[P_S1 + m * WINDOWS + win[k]] = s1v[k];
    }
    const int px = win[k] / 6;
    const float* base = c1m + (4 * px) * 24 + 4 * (win[k] - 6 * px);
#pragma unroll
    for (int t = 0; t < 16; ++t) pg[t] = fmaf(d, base[(t >> 2) * 24 + (t & 3)], pg[t]);
    pg[16] += d;
  }
  const float pool_sum = ftile::warp_sum32(pg);
  if (lane < 17) pool_part[warp][lane] = pool_sum;
  __syncthreads();  // d_pre_s1 of every window; every warp's pool share
  if (warp == 0 && lane < 17) {
    float v = pool_part[0][lane];
#pragma unroll
    for (int w = 1; w < IMG_WARPS; ++w) v += pool_part[w][lane];
    row[lane < 16 ? P_S1W + lane : P_S1B] = v;
  }

  // Pool scatter and sigma': d_pre_c1[r,c] = d_pre_s1[r/4, c/4] *
  // w_s1[r%4, c%4] * s(1-s), for the lane's block, in registers.
#pragma unroll
  for (int a = 0; a < BR; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int r = r0 + a;
      const int cc = c0 + c;
      const float d = ds1[m][(r >> 2) * 6 + (cc >> 2)] * ws_s[(r & 3) * 4 + (cc & 3)];
      const float s = cv[a][c];
      cv[a][c] = d * (s * (1.0f - s));
    }

  // Conv grads: g[i*5+j] = sum over the block of d_pre_c1[r,c] x[r+i,c+j],
  // in (row, column) order; g[25] the bias sum.
  float g[32];
#pragma unroll
  for (int t = 0; t < 32; ++t) g[t] = 0.0f;
#pragma unroll
  for (int R = 0; R < BR + 4; ++R) {
    float xr[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) xr[k] = x[(r0 + R) * XS + c0 + k];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int a = R - i;
      if (a < 0 || a >= BR) continue;
#pragma unroll
      for (int j = 0; j < 5; ++j)
#pragma unroll
        for (int c = 0; c < 3; ++c) g[i * 5 + j] = fmaf(cv[a][c], xr[c + j], g[i * 5 + j]);
    }
  }
#pragma unroll
  for (int a = 0; a < BR; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) g[25] += cv[a][c];
  const float conv_sum = ftile::warp_sum32(g);
  if (lane < 26) conv_part[warp][lane] = conv_sum;
  __syncthreads();
  if (tid < MAPS * 26) {
    const int mm = tid / 26;
    const int k = tid - mm * 26;
    float v = conv_part[mm * WARPS_PER_MAP][k];
#pragma unroll
    for (int w = 1; w < WARPS_PER_MAP; ++w) v += conv_part[mm * WARPS_PER_MAP + w][k];
    row[k < 25 ? P_C1W + mm * 25 + k : P_C1B + mm] = v;
  }
}

__device__ __forceinline__ float normalised(int j, float acc, float inv_n) {
  if (j < OFF_FB) {
    acc = acc / 576.0f;   // conv w and b: CONV_NORM
  } else if (j == OFF_S1B) {
    acc = acc / 216.0f;   // pool bias: POOL_BIAS_NORM
  }
  return acc * inv_n;
}

// Pass 2 stages rows [r0, r0 + nr) of `floats` columns from column `col`
// of the pass-1 rows into a stage of row stride `ld`: 16-byte cp.async
// copies (every segment starts on a 16-byte boundary).
__device__ __forceinline__ void stage_rows(float* stage, const float* __restrict__ rows,
                                           int r0, int nr, int col, int floats, int ld) {
  const int quads = floats / 4;
  for (int i = threadIdx.x; i < nr * quads; i += FIN_THREADS) {
    const int r = i / quads;
    const int q = i - r * quads;
    ftile::cp_async16(stage + r * ld + 4 * q,
                      rows + static_cast<size_t>(r0 + r) * ROW_PASS1 + col + 4 * q, true);
  }
}

// Pass 2, an s1-column block: g_w_f[o, k0 + c] = sum_b d_pre_f[b,o] s1[b, k0 + c].
// Thread (shard, c) sums rows shard, shard + FW_SHARDS, ... (8 columns x 4
// shards a warp); then two shuffles and the warps in order. A staged row
// holds the block's 8 s1 columns, then d_pre_f.
__device__ __forceinline__ void finish_fw(const float* __restrict__ rows, int n,
                                          float inv_n, float* smem,
                                          float* __restrict__ out) {
  __shared__ float red[FIN_WARPS][CLASSES][FW_COLS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = lane & 7;
  const int shard = warp * 4 + (lane >> 3);
  const int k0 = blockIdx.x * FW_COLS;
  const int chunks = (n + FIN_ROWS - 1) / FIN_ROWS;
  auto load = [&](int ch) {
    float* st = smem + (ch & 1) * FIN_ROWS * FW_LD;
    const int nr = min(FIN_ROWS, n - ch * FIN_ROWS);
    stage_rows(st, rows, ch * FIN_ROWS, nr, P_S1 + k0, FW_COLS, FW_LD);
    stage_rows(st + FW_COLS, rows, ch * FIN_ROWS, nr, P_DF, 12, FW_LD);
    ftile::cp_async_commit();
  };
  float acc[CLASSES];
#pragma unroll
  for (int o = 0; o < CLASSES; ++o) acc[o] = 0.0f;
  load(0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load(ch + 1);
      ftile::cp_async_wait<1>();
    } else {
      ftile::cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = smem + (ch & 1) * FIN_ROWS * FW_LD;
    const int nr = min(FIN_ROWS, n - ch * FIN_ROWS);
    for (int r = shard; r < nr; r += FW_SHARDS) {
      const float* sr = st + r * FW_LD;
      const float s = sr[col];
#pragma unroll
      for (int o = 0; o < CLASSES; ++o) acc[o] = fmaf(sr[FW_COLS + o], s, acc[o]);
    }
    __syncthreads();  // the stage after next overwrites this one
  }
#pragma unroll
  for (int o = 0; o < CLASSES; ++o) {
    float v = acc[o];
    v += __shfl_xor_sync(FULL, v, 8);
    v += __shfl_xor_sync(FULL, v, 16);
    if (lane < FW_COLS) red[warp][o][col] = v;
  }
  __syncthreads();
  if (tid < CLASSES * FW_COLS) {
    const int o = tid / FW_COLS;
    const int c = tid - o * FW_COLS;
    float v = red[0][o][c];
#pragma unroll
    for (int w = 1; w < FIN_WARPS; ++w) v += red[w][o][c];
    const int j = OFF_FW + o * S1 + k0 + c;
    out[j] = normalised(j, v, inv_n);
  }
}

// The output column of pass-1 column `p` of the directly summed ones, or
// -1 for a pad.
__device__ __forceinline__ int direct_out(int p) {
  if (p < P_DF + CLASSES) return OFF_FB + p - P_DF;
  if (p == P_ERR) return OFF_ERR;
  if (p < P_C1W) return -1;
  if (p < P_C1B) return OFF_C1W + p - P_C1W;
  if (p < P_S1W) return OFF_C1B + p - P_C1B;
  if (p < P_S1B) return OFF_S1W + p - P_S1W;
  return p == P_S1B ? OFF_S1B : -1;
}

// Pass 2, a direct block: DIRECT_COLS pass-1 columns from P_DIRECT + 32 *
// block, each summed over the batch by DIRECT_SHARDS interleaved shards (a
// warp a shard), then the shards in order.
__device__ __forceinline__ void finish_direct(const float* __restrict__ rows, int n,
                                              float inv_n, float* smem,
                                              float* __restrict__ out) {
  __shared__ float red[DIRECT_SHARDS][DIRECT_COLS];
  const int tid = threadIdx.x;
  const int col = tid & (DIRECT_COLS - 1);
  const int shard = tid / DIRECT_COLS;
  const int p0 = P_DIRECT + (blockIdx.x - FW_BLOCKS) * DIRECT_COLS;
  const int floats = min(DIRECT_COLS, ROW_PASS1 - p0);
  const int chunks = (n + FIN_ROWS - 1) / FIN_ROWS;
  auto load = [&](int ch) {
    stage_rows(smem + (ch & 1) * FIN_ROWS * DIRECT_COLS, rows, ch * FIN_ROWS,
               min(FIN_ROWS, n - ch * FIN_ROWS), p0, floats, DIRECT_COLS);
    ftile::cp_async_commit();
  };
  float acc = 0.0f;
  load(0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load(ch + 1);
      ftile::cp_async_wait<1>();
    } else {
      ftile::cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = smem + (ch & 1) * FIN_ROWS * DIRECT_COLS;
    const int nr = min(FIN_ROWS, n - ch * FIN_ROWS);
    if (col < floats)
      for (int r = shard; r < nr; r += DIRECT_SHARDS) acc += st[r * DIRECT_COLS + col];
    __syncthreads();
  }
  red[shard][col] = acc;
  __syncthreads();
  const int j = col < floats ? direct_out(p0 + col) : -1;
  if (tid < DIRECT_COLS && j >= 0) {
    float v = red[0][col];
#pragma unroll
    for (int s = 1; s < DIRECT_SHARDS; ++s) v += red[s][col];
    out[j] = normalised(j, v, inv_n);
  }
}

__global__ void __launch_bounds__(FIN_THREADS)
lenet_step_finish(const float* __restrict__ rows, int n, float* __restrict__ out) {
  __shared__ __align__(16) float smem[FIN_SMEM_FLOATS];
  // Launched as pass 1's programmatic dependent: wait for pass 1's rows.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float inv_n = 1.0f / static_cast<float>(n);
  if (blockIdx.x < FW_BLOCKS) {
    finish_fw(rows, n, inv_n, smem, out);
  } else {
    finish_direct(rows, n, inv_n, smem, out);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers: xs (n,784)
// f32, ys (n,) int32, the six parameter leaves f32, workspace (n,
// ROW_PASS1) f32 on a 16-byte boundary, out (2344,) f32. Returns 0 when
// both launches were accepted, else the cudaError_t; refuses n < 1 and a
// misaligned workspace with cudaErrorInvalidValue.
extern "C" int lenet_fused_step(const float* xs, const int* ys,
                                const float* w_c1, const float* b_c1,
                                const float* w_s1, const float* b_s1,
                                const float* w_f, const float* b_f,
                                float* workspace, float* out, int n,
                                void* stream) {
  if (n <= 0 || !aligned16(workspace)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  lenet_step_image<<<n, IMG_THREADS, 0, s>>>(xs, ys, w_c1, b_c1, w_s1, b_s1, w_f, b_f,
                                             workspace, aligned16(xs));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // Pass 2 as a programmatic dependent launch: scheduled while pass 1
  // runs, it waits in griddepcontrol.wait for pass 1's end and memory.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(FW_BLOCKS + DIRECT_BLOCKS);
  cfg.blockDim = dim3(FIN_THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, lenet_step_finish, static_cast<const float*>(workspace), n,
                         out);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The layout the wrapper sizes its tensors by, for its check: i = 0 the
// output row (grads + err), 1 pass 1's row an image; else -1.
extern "C" int lenet_fused_dim(int i) {
  return i == 0 ? ROW : i == 1 ? ROW_PASS1 : -1;
}
