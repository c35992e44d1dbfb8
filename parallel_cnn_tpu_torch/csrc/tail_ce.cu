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
//            gap:  (sum over the H*W positions in order) * (1 / (H*W))
//                  (D = C);
//            none: x flattened (D = H*W*C).
//   logits[k] = b[k] + sum_d pooled[d] * w[d,k]
//   m = max_k logits; e_k = exp(logits[k] - m); se = sum_k e_k
//   loss[n] = (log(se) + m) - logits[label]
//   dl[n,k] = e_k / se - (k == label)
//
// A label outside [0, K) has an all-zero one-hot row, as jax.nn.one_hot
// gives.
//
// Design. One block of 256 threads per image: the pooled row is built in
// shared memory, each logit is a block reduction with a fixed lane split
// and shuffle tree, and one thread runs the softmax over the K logits. No
// atomics, so relaunches are bit-identical. The Pallas kernel's parity
// phase views and batch blocks sized to VMEM answered Mosaic's constraints
// and have no counterpart here.
//
// Bound on an H100 SXM. Each input element is read once and feeds about K
// multiply-adds (10 for CIFAR), so the kernel is bound by its bytes: x at
// 3.35 TB/s (4.2 MB, 1.25 us for ResNet-18's (128,4,4,512) at batch 128).
//
// The kernel launches on the caller's stream, synchronises nothing and
// allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

enum Pool { kMax2 = 0, kGap = 1, kNone = 2 };

// Sum of v over the block, returned to thread 0: warp shuffle trees, then
// the warps' sums in warp order. Every call site reaches it with all
// threads, and ends with the barrier that frees `red`.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
    s = red[0];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) s += red[i];
  }
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(THREADS)
tail_ce_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b,
               const long long* __restrict__ labels,
               float* __restrict__ loss, float* __restrict__ dl, int pool,
               int h, int wd, int c, int d, int k) {
  extern __shared__ float smem[];
  float* pooled = smem;          // d
  float* logits = smem + d;      // k
  float* red = logits + k;       // WARPS

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xi = x + static_cast<long long>(n) * h * wd * c;

  if (pool == kMax2) {
    const int pw = wd / 2;
    for (int e = tid; e < d; e += THREADS) {
      const int ch = e % c;
      const int p = e / c;
      const int py = p / pw;
      const int px = p - py * pw;
      const float* q = xi + ((2 * py) * wd + 2 * px) * c + ch;
      const float v00 = q[0], v01 = q[c];
      const float v10 = q[wd * c], v11 = q[wd * c + c];
      pooled[e] = fmaxf(fmaxf(v00, v01), fmaxf(v10, v11));
    }
  } else if (pool == kGap) {
    const int positions = h * wd;
    const float inv = 1.0f / static_cast<float>(positions);
    for (int ch = tid; ch < c; ch += THREADS) {
      float s = xi[ch];
      for (int p = 1; p < positions; ++p) s += xi[p * c + ch];
      pooled[ch] = s * inv;
    }
  } else {
    for (int e = tid; e < d; e += THREADS) pooled[e] = xi[e];
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    float s = 0.0f;
    for (int e = tid; e < d; e += THREADS) s = fmaf(pooled[e], w[e * k + j], s);
    s = block_sum(s, red);
    if (tid == 0) logits[j] = b[j] + s;
  }

  if (tid == 0) {
    const long long y = labels[n];
    float m = logits[0];
    for (int j = 1; j < k; ++j) m = fmaxf(m, logits[j]);
    float se = 0.0f;
    float ly = 0.0f;
    for (int j = 0; j < k; ++j) {
      if (j == y) ly = logits[j];
      const float e = expf(logits[j] - m);
      logits[j] = e;
      se += e;
    }
    loss[n] = (logf(se) + m) - ly;
    float* dln = dl + static_cast<long long>(n) * k;
    for (int j = 0; j < k; ++j) {
      dln[j] = logits[j] / se - (j == y ? 1.0f : 0.0f);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers: x
// (B,H,W,C), w (D,K), b (K,), labels (B,) int64; loss (B,) and dl (B,K) are
// written in full. pool: 0 max2, 1 gap, 2 none. The wrapper keeps the
// (D + K + 8) floats of shared memory within the 48 KB a block gets by
// default. Returns 0 on a launch that was accepted, else the cudaError_t.
extern "C" int tail_ce_forward(const float* x, const float* w, const float* b,
                               const long long* labels, float* loss,
                               float* dl, int batch, int h, int wd, int c,
                               int d, int k, int pool, void* stream) {
  if (batch <= 0 || h <= 0 || wd <= 0 || c <= 0 || d <= 0 || k <= 0 ||
      pool < kMax2 || pool > kNone) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(d + k + WARPS) * sizeof(float);
  tail_ce_kernel<<<batch, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, labels, loss, dl, pool, h, wd, c, d, k);
  return static_cast<int>(cudaGetLastError());
}
