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
// Design. Pass 1 runs one 256-thread block per image. The image (3 KB), the
// conv and pool weights, the conv output (6x24x24) and its backward
// (d_pre_c1) live in 33 KB of static shared memory. Elementwise stages give
// each thread a strided set of outputs; every reduction (the FC dot products,
// the 16 pool-weight grads, the 150 conv-weight grads, the bias sums) is one
// warp per output with a fixed lane split and a shuffle tree. Each block
// writes its image's un-normalised grads and err to its own row of a
// workspace. Pass 2 sums the rows in image order, one thread per value,
// then applies /576, /216 and the 1/n mean. The TPU kernel's layout answers
// (the tap-major (25,B,576) im2col, the Mp (576,36) pool scatter matrix, the
// channel-major FC weight, the row accumulators finished in XLA and its
// bf16 store of the input) have no counterpart: the pool is a direct
// indexed 4x4 sum and the port is f32 end to end.
//
// Determinism. No atomics: every value is summed in one fixed order (a
// fixed lane split and shuffle tree within an image, image order across
// the batch), so the same batch gives bit-identical grads on every run.
// f32 with IEEE expf/sqrtf/division; build without --use_fast_math.
//
// Bound on an H100 SXM. Per image: forward conv 86,400 multiply-adds, pool
// 3,456, FC 2,160; backward FC wgrad 2,160, FC dX 2,160, pool wgrad 3,456,
// pool scatter 3,456, conv wgrad 86,400: 189,648 MAC, 379 kFLOP. At batch
// 64 that is 24.3 MFLOP, 0.36 us at the f32 peak of 67 TFLOP/s, against
// ~0.22 MB moved (images, labels, params, grads), 0.07 us at 3.35 TB/s. The
// step is bound by operations, and both bounds sit far below a launch's
// latency: this first kernel aims at right and deterministic, and its time
// is set by the per-image block's serial stages and pass 2's loop over n.
//
// The kernels launch on the caller's stream, synchronise nothing and
// allocate nothing: the Python wrapper allocates the (n, 2344) workspace and
// the output and checks devices, dtypes, shapes and contiguity first.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// One row of the workspace (and the output): grads in the params tree's
// flatten order, then err.
constexpr int OFF_C1B = 0;     // 6
constexpr int OFF_C1W = 6;     // 150: m*25 + i*5 + j
constexpr int OFF_FB = 156;    // 10
constexpr int OFF_FW = 166;    // 2160: o*216 + k
constexpr int OFF_S1B = 2326;  // 1
constexpr int OFF_S1W = 2327;  // 16: i*4 + j
constexpr int OFF_ERR = 2343;
constexpr int ROW = 2344;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Sum over the warp in a fixed shuffle tree; lane 0 holds the result.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
lenet_step_partials(const float* __restrict__ xs, const int* __restrict__ ys,
                    const float* __restrict__ w_c1,
                    const float* __restrict__ b_c1,
                    const float* __restrict__ w_s1,
                    const float* __restrict__ b_s1,
                    const float* __restrict__ w_f,
                    const float* __restrict__ b_f,
                    float* __restrict__ partials) {
  __shared__ float x[784];
  __shared__ float wc[150];
  __shared__ float ws[16];
  __shared__ float c1[3456];   // out_c1[m*576 + r*24 + c]
  __shared__ float dc1[3456];  // d_pre_c1, same layout
  __shared__ float s1[216];    // out_s1[m*36 + x*6 + y]
  __shared__ float ds1[216];   // d_pre_s1, same layout
  __shared__ float df[10];     // d_pre_f

  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* row = partials + static_cast<size_t>(img) * ROW;

  const float* xg = xs + static_cast<size_t>(img) * 784;
  for (int i = tid; i < 784; i += THREADS) x[i] = xg[i];
  for (int i = tid; i < 150; i += THREADS) wc[i] = w_c1[i];
  if (tid < 16) ws[tid] = w_s1[tid];
  __syncthreads();

  // Forward conv: pre_c1[m,r,c] = sum_{i,j} x[r+i, c+j] * w_c1[m,i,j] + b_c1[m].
  for (int idx = tid; idx < 3456; idx += THREADS) {
    const int m = idx / 576;
    const int p = idx - m * 576;
    const int r = p / 24;
    const int c = p - r * 24;
    const float* wm = wc + m * 25;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) acc += x[(r + i) * 28 + c + j] * wm[i * 5 + j];
    c1[idx] = sigmoid(acc + b_c1[m]);
  }
  __syncthreads();

  // Forward pool: pre_s1[m,x,y] = sum_{i,j} w_s1[i,j] out_c1[m,4x+i,4y+j] + b_s1.
  const float bs = b_s1[0];
  for (int idx = tid; idx < 216; idx += THREADS) {
    const int m = idx / 36;
    const int q = idx - m * 36;
    const int px = q / 6;
    const int py = q - px * 6;
    const float* base = c1 + m * 576 + (4 * px) * 24 + 4 * py;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc += ws[i * 4 + j] * base[i * 24 + j];
    s1[idx] = sigmoid(acc + bs);
  }
  __syncthreads();

  // Forward FC and the error: one warp per output.
  const int label = ys[img];
  for (int o = warp; o < 10; o += WARPS) {
    float acc = 0.0f;
    for (int k = lane; k < 216; k += 32) acc += w_f[o * 216 + k] * s1[k];
    acc = warp_sum(acc);
    if (lane == 0) df[o] = (o == label ? 1.0f : 0.0f) - sigmoid(acc + b_f[o]);
  }
  __syncthreads();

  if (tid == 0) {
    float ss = 0.0f;
    for (int o = 0; o < 10; ++o) ss += df[o] * df[o];
    row[OFF_ERR] = sqrtf(ss);
  }
  // FC grads: g_w_f[o,k] = d_pre_f[o] * out_s1[k]; g_b_f = d_pre_f.
  for (int idx = tid; idx < 2160; idx += THREADS) {
    const int o = idx / 216;
    row[OFF_FW + idx] = df[o] * s1[idx - o * 216];
  }
  if (tid < 10) row[OFF_FB + tid] = df[tid];
  // d_pre_s1[k] = (sum_o w_f[o,k] d_pre_f[o]) * s(1-s).
  for (int k = tid; k < 216; k += THREADS) {
    float acc = 0.0f;
#pragma unroll
    for (int o = 0; o < 10; ++o) acc += w_f[o * 216 + k] * df[o];
    const float s = s1[k];
    ds1[k] = acc * (s * (1.0f - s));
  }
  __syncthreads();

  // Pool grads, one warp per value: t < 16 is g_w_s1[i,j] =
  // sum_{m,x,y} d_pre_s1[m,x,y] out_c1[m,4x+i,4y+j]; t = 16 the bias sum.
  for (int t = warp; t < 17; t += WARPS) {
    float acc = 0.0f;
    if (t < 16) {
      const int i = t >> 2;
      const int j = t & 3;
      for (int k = lane; k < 216; k += 32) {
        const int m = k / 36;
        const int q = k - m * 36;
        const int px = q / 6;
        const int py = q - px * 6;
        acc += ds1[k] * c1[m * 576 + (4 * px + i) * 24 + 4 * py + j];
      }
    } else {
      for (int k = lane; k < 216; k += 32) acc += ds1[k];
    }
    acc = warp_sum(acc);
    if (lane == 0) row[t < 16 ? OFF_S1W + t : OFF_S1B] = acc;
  }
  // Pool scatter back and sigmoid': d_pre_c1[m,r,c] =
  // d_pre_s1[m,r/4,c/4] * w_s1[r%4,c%4] * s(1-s).
  for (int idx = tid; idx < 3456; idx += THREADS) {
    const int m = idx / 576;
    const int p = idx - m * 576;
    const int r = p / 24;
    const int c = p - r * 24;
    const float d = ds1[m * 36 + (r >> 2) * 6 + (c >> 2)] * ws[(r & 3) * 4 + (c & 3)];
    const float s = c1[idx];
    dc1[idx] = d * (s * (1.0f - s));
  }
  __syncthreads();

  // Conv grads, one warp per value: t < 150 is g_w_c1[m,i,j] =
  // sum_{r,c} d_pre_c1[m,r,c] x[r+i,c+j]; t >= 150 the bias sum of map m.
  for (int t = warp; t < 156; t += WARPS) {
    float acc = 0.0f;
    if (t < 150) {
      const int m = t / 25;
      const int ij = t - m * 25;
      const int i = ij / 5;
      const int j = ij - i * 5;
      const float* d = dc1 + m * 576;
      for (int p = lane; p < 576; p += 32) {
        const int r = p / 24;
        acc += d[p] * x[(r + i) * 28 + (p - r * 24) + j];
      }
    } else {
      const float* d = dc1 + (t - 150) * 576;
      for (int p = lane; p < 576; p += 32) acc += d[p];
    }
    acc = warp_sum(acc);
    if (lane == 0) row[t < 150 ? OFF_C1W + t : OFF_C1B + t - 150] = acc;
  }
}

// Pass 2: out[j] = (sum over images, in image order, of partials[., j])
// with the reference's normalisation, times 1/n.
__global__ void __launch_bounds__(THREADS)
lenet_step_finish(const float* __restrict__ partials, int n,
                  float* __restrict__ out) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= ROW) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int b = 0; b < n; ++b) acc += partials[static_cast<size_t>(b) * ROW + j];
  if (j < OFF_FB) {
    acc = acc / 576.0f;   // conv w and b: CONV_NORM
  } else if (j == OFF_S1B) {
    acc = acc / 216.0f;   // pool bias: POOL_BIAS_NORM
  }
  out[j] = acc * (1.0f / static_cast<float>(n));
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers: xs (n,784)
// f32, ys (n,) int32, the six parameter leaves f32, workspace (n, 2344) f32,
// out (2344,) f32. Returns 0 when both launches were accepted, else the
// cudaError_t.
extern "C" int lenet_fused_step(const float* xs, const int* ys,
                                const float* w_c1, const float* b_c1,
                                const float* w_s1, const float* b_s1,
                                const float* w_f, const float* b_f,
                                float* workspace, float* out, int n,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  lenet_step_partials<<<n, THREADS, 0, s>>>(xs, ys, w_c1, b_c1, w_s1, b_s1,
                                            w_f, b_f, workspace);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lenet_step_finish<<<(ROW + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      workspace, n, out);
  return static_cast<int>(cudaGetLastError());
}

// The row width the wrapper allocates (grads + err), for its check.
extern "C" int lenet_fused_row() { return ROW; }
