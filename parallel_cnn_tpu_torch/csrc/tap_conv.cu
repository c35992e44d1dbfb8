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
// The same file holds the conv's input gradient (dgrad), which the Pallas
// package computes with this kernel too (`_dgrad_s1` / `_dgrad_s2_even`,
// pallas_conv.py:869/:913, negated tap offsets and transposed tap weights):
//
//   dx[n,iy,ix,ci] = sum_{dy,dx,co} g[n,oy,ox,co] * w[dy,dx,ci,co]
//   over the taps with iy = oy*s - pad_top + dy, ix = ox*s - pad_left + dx
//   for some output position (oy, ox) inside g.
//
// It is the same implicit GEMM in gather form: rows M = N*H*W input pixels,
// columns Cin, depth K = k*k*Cout in (tap, co) order. A slab element is the
// g value the tap sends to the pixel, or zero where the tap's output
// position falls between stride steps or outside g -- so a 1x1/s2 conv's
// skipped pixels get exact zeros, and XLA's asymmetric SAME split is the
// forward's index arithmetic run backwards. The weights are read as W^T per
// tap, by threads that walk along Cout (the contiguous axis). Each dx value
// is summed by one thread over k = 0..K-1 in order, as the forward sums its
// outputs: relaunches are bit-identical and nothing is shared between
// blocks. At stride 2 three of four (tap, pixel) pairs are zero for a 3x3
// conv; the kernel multiplies them anyway (the Pallas phase split avoids
// that, at the cost of four output layouts) -- a later kernel can skip them.
// Bound: the same multiply-adds as the forward of the conv, so operations
// on the f32 CUDA cores, as for the forward.
//
// The kernels launch on the caller's stream, synchronise nothing and
// allocate nothing: the Python wrapper allocates the output and checks
// shapes, dtypes, devices and contiguity before calling in.

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

constexpr int B_PAD = 4;     // dgrad's weight slab: aligned rows, few conflicts

__global__ void __launch_bounds__(THREADS)
tap_dgrad_kernel(const float* __restrict__ g, const float* __restrict__ wt,
                 float* __restrict__ dx, Geometry geo) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN + B_PAD];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;   // input pixels
  const int n0 = blockIdx.y * BN;   // input channels
  const int M = geo.n * geo.h * geo.w;
  const int K = geo.k * geo.k * geo.cout;

  // Gather role: depth column a_kk of the slab for the four pixel rows
  // a_row + 16*i. A pixel's image offset into g and its padded coordinates
  // are fixed for the whole reduction.
  const int a_kk = tid % BK;
  const int a_row = tid / BK;
  int a_img[4], a_py[4], a_px[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_row + 16 * i;
    if (m < M) {
      const int img = m / (geo.h * geo.w);
      const int r = m - img * geo.h * geo.w;
      const int iy = r / geo.w;
      const int ix = r - iy * geo.w;
      a_img[i] = img * geo.oh * geo.ow * geo.cout;
      a_py[i] = iy + geo.pad_top;
      a_px[i] = ix + geo.pad_left;
    } else {
      a_img[i] = 0;
      a_py[i] = -(1 << 29);  // never a tap's output row: loads read zero
      a_px[i] = 0;
    }
  }

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
      const int tap = kidx / geo.cout;
      const int co = kidx - tap * geo.cout;
      const int dy = tap / geo.k;
      const int dxx = tap - dy * geo.k;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // Output position whose tap (dy, dxx) reads this pixel, if any.
        const int sy = a_py[i] - dy;
        const int sx = a_px[i] - dxx;
        const int oy = sy / geo.stride;
        const int ox = sx / geo.stride;
        const bool hit = sy >= 0 && sx >= 0 && oy * geo.stride == sy &&
                         ox * geo.stride == sx && oy < geo.oh && ox < geo.ow;
        ra[i] = hit ? __ldg(g + a_img[i] + (oy * geo.ow + ox) * geo.cout + co)
                    : 0.0f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = 0.0f;
    }
    // W^T slab: element (kk, col) is w[dy, dx, n0 + col, co]; consecutive
    // threads take consecutive kk, that is consecutive co in memory.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + THREADS * i;
      const int kk = idx % BK;
      const int ci = n0 + idx / BK;
      const int kr = k0 + kk;
      float v = 0.0f;
      if (kr < K && ci < geo.cin) {
        const int tap = kr / geo.cout;
        const int co = kr - tap * geo.cout;
        v = __ldg(wt + (tap * geo.cin + ci) * geo.cout + co);
      }
      rb[i] = v;
    }
  };

  load_stage(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_kk][a_row + 16 * i] = ra[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + THREADS * i;
      Bs[idx % BK][idx / BK] = rb[i];
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + tx * 4 + j;
      if (ci < geo.cin) dx[m * geo.cin + ci] = acc[i][j];
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

// Input gradient of the conv above: `g` is (N,OH,OW,Cout), `w` the forward's
// (k,k,Cin,Cout) weights, `dx` (N,H,W,Cin) is written in full. Returns 0 on
// a launch that was accepted, else the cudaError_t.
extern "C" int tap_conv_dgrad(const float* g, const float* w, float* dx, int n,
                              int h, int w_in, int cin, int oh, int ow,
                              int cout, int k, int stride, int pad_top,
                              int pad_left, void* stream) {
  if (n <= 0 || h <= 0 || w_in <= 0 || cin <= 0 || oh <= 0 || ow <= 0 ||
      cout <= 0 || k <= 0 || stride <= 0 || pad_top < 0 || pad_left < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long m = static_cast<long long>(n) * h * w_in;
  const dim3 grid(static_cast<unsigned>((m + BM - 1) / BM),
                  static_cast<unsigned>((cin + BN - 1) / BN));
  const Geometry geo{n, h, w_in, cin, oh, ow, cout, k, stride, pad_top, pad_left};
  tap_dgrad_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      g, w, dx, geo);
  return static_cast<int>(cudaGetLastError());
}
