// SAME-padded NHWC float32 convolution with a fused per-channel epilogue,
// written for Hopper (sm_90a) and bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel `_tap_kernel`
// (parallel_cnn_tpu/ops/pallas_conv.py:228, launched from `_tapped_matmul`
// at pallas_conv.py:588), which serves `conv2d` and `conv2d_fused`.
//
// What it computes, for x (N,H,W,Cin), w (k,k,Cin,Cout) HWIO, stride s and
// XLA's SAME split (pad_top = pad_total_h // 2, pad_left likewise):
//
//   acc[n,oy,ox,co] = sum_{dy,dx,ci} x[n, oy*s - pad_top + dy,
//                                         ox*s - pad_left + dx, ci]
//                                    * w[dy,dx,ci,co]      (zero outside x)
//   z = acc * scale[co] + shift[co]   (skipped when scale is null)
//   z = z + residual[n,oy,ox,co]      (when residual is not null)
//   z = max(z, 0)                     (when relu)
//   out[n,oy,ox,co] = z               (the only store)
//
// Design. The conv is run as an implicit GEMM on the CUDA cores in f32:
// rows M = N*OH*OW output pixels, columns Cout, depth K = k*k*Cin in HWIO
// order, so the weight tensor already is the (K, Cout) matrix. A block of
// 256 threads owns a 64-pixel x 64-channel output tile; each stage gathers a
// 64x16 slab of the (never materialised) im2col matrix with bounds-checked
// input indices -- the zero padding, the stride and the asymmetric SAME
// split are plain index arithmetic -- and a 16x64 slab of weights into
// shared memory. Each thread keeps a 4x4 register tile of accumulators and
// prefetches the next stage's slabs into registers while it multiplies the
// current ones. The Pallas kernel's flat pad-H layout, column masks, N-pairing,
// cout-tile weight streaming, row bands and 4-phase stride-2 split were
// answers to Mosaic's constraints and have no counterpart here.
//
// Determinism. Every output element sums its K products in the same order
// (k = 0..K-1, one fma each) whatever its tile, its batch position or the
// batch size, and no block shares a reduction with another: no atomics, no
// split-K. A padded serving bucket therefore gives bit-identical rows.
//
// Bound on an H100 SXM. The 20 convs of ResNet-18 at 32x32 do 555,417,600
// multiply-adds per image (stem 1.77 M; stage 1 four 37.7 M convs; stages
// 2-4 each a 18.9 M stride-2 head, three 37.7 M convs and a 2.1 M 1x1
// projection). Each 3x3 conv does 9*Cin multiply-adds per 4-byte output, so
// a batch-64 forward (71.1 GFLOP, 1.06 ms at the f32 CUDA cores' 67 TFLOP/s)
// is bound by operations; only the stem, with 27 multiply-adds per output,
// is bound by its bytes at 3.35 TB/s. (A 1x1/s2 projection reads a quarter
// of its input, since the stride steps over every other row and column.)
// This first kernel does not use tensor cores (wgmma/TMA); a later implicit
// GEMM on them is the way past the f32 bound.
//
// The kernel launches on the caller's stream, synchronises nothing and
// allocates nothing: the Python wrapper allocates `out` and checks shapes,
// dtypes, devices and contiguity before calling in.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 16;       // reduction depth per stage
constexpr int THREADS = 256;
constexpr int A_PAD = 4;     // keeps float4 rows aligned, eases bank conflicts

struct Geometry {
  int n, h, w, cin, oh, ow, cout, k, stride, pad_top, pad_left;
};

__global__ void __launch_bounds__(THREADS)
tap_conv_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                const float* __restrict__ scale,
                const float* __restrict__ shift,
                const float* __restrict__ residual, float* __restrict__ out,
                Geometry g, int relu) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int M = g.n * g.oh * g.ow;
  const int K = g.k * g.k * g.cin;

  // Gather role: this thread loads depth column a_kk of the im2col slab for
  // the four pixel rows a_row + 16*i. Their input origins are fixed for the
  // whole reduction, so they are decoded once.
  const int a_kk = tid % BK;
  const int a_row = tid / BK;
  int a_img[4], a_iy[4], a_ix[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_row + 16 * i;
    if (m < M) {
      const int img = m / (g.oh * g.ow);
      const int r = m - img * g.oh * g.ow;
      const int oy = r / g.ow;
      const int ox = r - oy * g.ow;
      a_img[i] = img * g.h * g.w * g.cin;
      a_iy[i] = oy * g.stride - g.pad_top;
      a_ix[i] = ox * g.stride - g.pad_left;
    } else {
      a_img[i] = 0;
      a_iy[i] = -(1 << 29);  // never inside the image: loads read zero
      a_ix[i] = 0;
    }
  }

  // Compute role: a 4x4 tile of pixels ty*4.. and channels tx*4..
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  float ra[4], rb[4];

  auto load_stage = [&](int k0) {
    const int kidx = k0 + a_kk;
    if (kidx < K) {
      const int tap = kidx / g.cin;
      const int ci = kidx - tap * g.cin;
      const int dy = tap / g.k;
      const int dx = tap - dy * g.k;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int iy = a_iy[i] + dy;
        const int ix = a_ix[i] + dx;
        const bool inside =
            (unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w;
        ra[i] = inside ? __ldg(x + a_img[i] + (iy * g.w + ix) * g.cin + ci)
                       : 0.0f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + THREADS * i;
      const int kk = idx / BN;
      const int co = n0 + idx % BN;
      const int kr = k0 + kk;
      rb[i] = (kr < K && co < g.cout) ? __ldg(wt + kr * g.cout + co) : 0.0f;
    }
  };

  load_stage(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_kk][a_row + 16 * i] = ra[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + THREADS * i;
      Bs[idx / BN][idx % BN] = rb[i];
    }
    __syncthreads();
    if (k0 + BK < K) load_stage(k0 + BK);  // in flight during the products
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

  // Epilogue on the f32 accumulator, then the single store.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co >= g.cout) continue;
      float z = acc[i][j];
      if (scale != nullptr) z = z * scale[co] + shift[co];
      const int o = m * g.cout + co;
      if (residual != nullptr) z += residual[o];
      if (relu) z = fmaxf(z, 0.0f);
      out[o] = z;
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; `scale` and
// `shift` are both null (no affine step) or both set; `residual` may be
// null. Returns 0 on a launch that was accepted, else the cudaError_t.
extern "C" int tap_conv_forward(const float* x, const float* w,
                                const float* scale, const float* shift,
                                const float* residual, float* out, int n,
                                int h, int w_in, int cin, int oh, int ow,
                                int cout, int k, int stride, int pad_top,
                                int pad_left, int relu, void* stream) {
  if (n <= 0 || h <= 0 || w_in <= 0 || cin <= 0 || oh <= 0 || ow <= 0 ||
      cout <= 0 || k <= 0 || stride <= 0 || pad_top < 0 || pad_left < 0 ||
      (scale == nullptr) != (shift == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long m = static_cast<long long>(n) * oh * ow;
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM),
                  static_cast<unsigned>((cout + BN - 1) / BN));
  const Geometry g{n, h, w_in, cin, oh, ow, cout, k, stride, pad_top, pad_left};
  tap_conv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, scale, shift, residual, out, g, relu);
  return static_cast<int>(cudaGetLastError());
}
