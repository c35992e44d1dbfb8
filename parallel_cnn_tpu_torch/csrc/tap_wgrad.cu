// Weight gradient of the SAME-padded NHWC float32 convolution, written for
// Hopper (sm_90a) and bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel `_wgrad_tap_kernel`
// (parallel_cnn_tpu/ops/pallas_conv.py:321, launched from `_tapped_wgrad`
// at pallas_conv.py:644 for `_wgrad_s1`, `_wgrad_s2_even` and `_wgrad_1x1`).
//
// What it computes, for x (N,H,W,Cin), the output gradient g (N,OH,OW,Cout),
// stride s and XLA's SAME split (pad_top = pad_total_h // 2, likewise left):
//
//   gw[dy,dx,ci,co] = sum_{n,oy,ox} x[n, oy*s - pad_top + dy,
//                                        ox*s - pad_left + dx, ci]
//                                   * g[n,oy,ox,co]     (zero outside x)
//
// into f32 (k,k,Cin,Cout). As a matrix product the result is R x Cout with
// R = k*k*Cin rows in HWIO order, and the reduction runs over the
// M = N*OH*OW output pixels: 131,072 terms for a 64-channel ResNet-18 conv
// at batch 128.
//
// Design. The TPU summed that axis along its sequential grid, carrying the
// sum in VMEM (pallas_conv.py:330-347); Hopper's blocks run in no order and
// share nothing. So the M axis is cut into fixed chunks of CHUNK pixels.
// Pass one: a block of 256 threads owns a 64-row x 64-column tile of one
// chunk, gathers 16-pixel slabs of the (never materialised) im2col matrix
// with bounds-checked indices -- padding and stride are index arithmetic
// -- and of g, into shared memory, and keeps a 4x4 register tile of sums
// (the forward kernel's tiling, csrc/tap_conv.cu, with pixels as depth).
// Each block writes its chunk's partial tile to scratch the wrapper
// allocated. Pass two sums the partials of each element in chunk order.
// No float atomics: every element is summed in one fixed order for a given
// shape, so relaunches are bit-identical. (The order depends on the batch
// size, since the batch is what is reduced; the serving forward's rule
// against batch-dependent split-K is about its padded buckets, which a
// gradient never sees.) With one chunk, pass one writes gw directly.
//
// Bound on an H100 SXM. The same multiply-adds as the conv's forward
// (k*k*Cin*Cout per output pixel), so a 3x3 conv is bound by operations on
// the f32 CUDA cores (67 TFLOP/s); only the stem (Cin 3) is bound by its
// bytes. Scratch traffic: with CHUNK = 2048, a 64-channel conv at batch 128
// writes and rereads 64 partial tiles of 147 KB, 19 MB in all, which the
// 50 MB L2 holds. This first kernel does not use tensor cores.
//
// The kernels launch on the caller's stream, synchronise nothing and
// allocate nothing.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int BM = 64;        // rows (tap, ci) per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // pixels per stage
constexpr int CHUNK = 2048;   // pixels per partial sum (a multiple of BK)
constexpr int THREADS = 256;
constexpr int PAD = 4;        // keeps float4 rows aligned, eases bank conflicts

struct Geometry {
  int n, h, w, cin, oh, ow, cout, k, stride, pad_top, pad_left;
};

__global__ void __launch_bounds__(THREADS)
wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ out, Geometry geo) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int chunk = blockIdx.z;
  const int R = geo.k * geo.k * geo.cin;
  const int M = geo.n * geo.oh * geo.ow;
  const int m_begin = chunk * CHUNK;
  const int m_end = min(M, m_begin + CHUNK);

  // Load role: column `col` of both slabs for pixel rows `prow + 4*i`. The
  // column's tap and input channel are fixed for the whole reduction.
  const int col = tid % 64;
  const int prow = tid / 64;
  const int r = r0 + col;
  const bool r_ok = r < R;
  int dy = 0, dxx = 0, ci = 0;
  if (r_ok) {
    const int tap = r / geo.cin;
    ci = r - tap * geo.cin;
    dy = tap / geo.k;
    dxx = tap - dy * geo.k;
  }
  const int co_load = n0 + col;
  const bool co_ok = co_load < geo.cout;

  // Compute role: a 4x4 tile of rows ty*4.. and channels tx*4..
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  float ra[4], rb[4];

  auto load_stage = [&](int p0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = p0 + prow + 4 * i;
      float a = 0.0f, b = 0.0f;
      if (m < m_end) {
        const int img = m / (geo.oh * geo.ow);
        const int rem = m - img * geo.oh * geo.ow;
        const int oy = rem / geo.ow;
        const int ox = rem - oy * geo.ow;
        const int iy = oy * geo.stride - geo.pad_top + dy;
        const int ix = ox * geo.stride - geo.pad_left + dxx;
        if (r_ok && (unsigned)iy < (unsigned)geo.h &&
            (unsigned)ix < (unsigned)geo.w) {
          a = __ldg(x + ((img * geo.h + iy) * geo.w + ix) * geo.cin + ci);
        }
        if (co_ok) b = __ldg(g + m * geo.cout + co_load);
      }
      ra[i] = a;
      rb[i] = b;
    }
  };

  load_stage(m_begin);
  for (int p0 = m_begin; p0 < m_end; p0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[prow + 4 * i][col] = ra[i];
      Bs[prow + 4 * i][col] = rb[i];
    }
    __syncthreads();
    if (p0 + BK < m_end) load_stage(p0 + BK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* tile = out + static_cast<long long>(chunk) * R * geo.cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co < geo.cout) tile[row * geo.cout + co] = acc[i][j];
    }
  }
}

// gw[e] = sum over chunks c = 0, 1, ... of partial[c][e], in that order.
__global__ void __launch_bounds__(THREADS)
wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ gw,
                 int elems, int chunks) {
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < elems;
       e += gridDim.x * THREADS) {
    float s = partial[e];
    for (int c = 1; c < chunks; ++c) {
      s += partial[static_cast<long long>(c) * elems + e];
    }
    gw[e] = s;
  }
}

}  // namespace

// Pixels per partial sum: the wrapper sizes `partial` as
// (ceil(N*OH*OW / chunk), k*k*Cin, Cout) floats when that is above one.
extern "C" int tap_wgrad_chunk() { return CHUNK; }

// Plain C entry point for ctypes. Pointers are device pointers; `partial`
// may be null when the reduction fits one chunk. `gw` (k,k,Cin,Cout) is
// written in full. Returns 0 on launches that were accepted, else the
// cudaError_t.
extern "C" int tap_conv_wgrad(const float* x, const float* g, float* partial,
                              float* gw, int n, int h, int w_in, int cin,
                              int oh, int ow, int cout, int k, int stride,
                              int pad_top, int pad_left, void* stream) {
  if (n <= 0 || h <= 0 || w_in <= 0 || cin <= 0 || oh <= 0 || ow <= 0 ||
      cout <= 0 || k <= 0 || stride <= 0 || pad_top < 0 || pad_left < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long m = static_cast<long long>(n) * oh * ow;
  const int chunks = static_cast<int>((m + CHUNK - 1) / CHUNK);
  if (chunks > 1 && partial == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = k * k * cin;
  const Geometry geo{n, h, w_in, cin, oh, ow, cout, k, stride, pad_top, pad_left};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + BM - 1) / BM, (cout + BN - 1) / BN, chunks);
  wgrad_partial_kernel<<<grid, THREADS, 0, s>>>(
      x, g, chunks > 1 ? partial : gw, geo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const int elems = rows * cout;
  const int blocks = std::min((elems + THREADS - 1) / THREADS, 132 * 8);
  wgrad_sum_kernel<<<blocks, THREADS, 0, s>>>(partial, gw, elems, chunks);
  return static_cast<int>(cudaGetLastError());
}
