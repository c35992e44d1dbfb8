// SAME-padded NHWC float32 (and bfloat16) convolution with a fused
// per-channel epilogue, written for Hopper (sm_90a) and bound to Python
// through ctypes.
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
// Design (`tap_conv_kernel`, on the f32 tile core of csrc/ffma_tile.cuh,
// which the dgrad kernel below shares). The conv is an implicit GEMM on
// the CUDA cores in f32: rows M = N*OH*OW output pixels, columns Cout,
// depth K = k*k*Cin in HWIO order (dy, dx, ci), so the weight tensor
// already is the (K, Cout) matrix and a pixel's depth run at one tap is
// Cin contiguous floats of NHWC x. A block owns a BM x BN output tile and
// walks the depth in stages of 32, through a 3-slot ring of shared memory
// filled ahead of use by `cp.async`:
//   - A [m][kk], the (never materialised) im2col slab: each copy moves 4
//     depth values of one pixel at one tap (16 bytes; 4 bytes a copy, for
//     A and B, when Cin or Cout is no multiple of 4 or x or w is off the
//     16-byte boundary, as for the CIFAR stem's Cin 3). The source size
//     is 0 where the tap falls in the SAME
//     padding or the pixel lies past M, which zero-fills. A pixel's image
//     offset and input origin (oy*s - pad_top, ox*s - pad_left: the
//     stride and the asymmetric SAME split) are decoded once a block, and
//     each thread steps its (dy, dx, ci) depth cursor without divides.
//   - B [kk][co], a slab of w's rows, copied as 16-byte runs along Cout.
// Each thread keeps an 8x8 or 8x4 register tile of accumulators (0.25 or
// 0.375 floats of shared memory read a fma; the first forward kernel's
// 4x4 needed 0.5) with one barrier a stage. The block tile comes from the
// shape (ops/tap_conv.py `forward_tile`): 128x128 (256 threads), or 64x64
// (128) or 32x64 (64) where the grid of a larger tile would leave SMs
// empty (the deep convs of stage 4, the small serving buckets); a depth of
// one stage (the CIFAR stem's K = 27, bound by its gather and its stores)
// takes 64x64 at 4x4 a thread, twice the threads for the copies. The Pallas
// kernel's flat pad-H layout, column masks, N-pairing, cout-tile weight
// streaming, row bands and 4-phase stride-2 split were answers to
// Mosaic's constraints and have no counterpart here.
//
// Determinism. Every output element sums its K products in the same
// order (k = 0..K-1, one fmaf each, from 0) whatever its tile, its batch
// position or the batch size -- the order the first forward kernel summed
// in, so the two agree bit for bit -- and no block shares a reduction with
// another: no atomics, no split-K. A padded serving bucket therefore gives
// bit-identical rows, and the tile may follow the batch.
//
// Bound on an H100 SXM. The 20 convs of ResNet-18 at 32x32 do 555,417,600
// multiply-adds per image (stem 1.77 M; stage 1 four 37.7 M convs; stages
// 2-4 each a 18.9 M stride-2 head, three 37.7 M convs and a 2.1 M 1x1
// projection). Each 3x3 conv does 9*Cin multiply-adds per 4-byte output, so
// a batch-64 forward (71.1 GFLOP, 1.06 ms at the f32 CUDA cores' 67 TFLOP/s)
// is bound by operations; only the stem, with 27 multiply-adds per output,
// is bound by its bytes at 3.35 TB/s. (A 1x1/s2 projection reads a quarter
// of its input, since the stride steps over every other row and column.)
// The path's contract is f32 with TF32 off, so no tensor cores here.
//
// The same file holds the conv's input gradient (dgrad), which the Pallas
// package computes with this kernel too (`_dgrad_s1` / `_dgrad_s2_even`,
// pallas_conv.py:869/:913, negated tap offsets and transposed tap weights):
//
//   dx[n,iy,ix,ci] = sum_{dy,dx,co} g[n,oy,ox,co] * w[dy,dx,ci,co]
//   over the taps with iy = oy*s - pad_top + dy, ix = ox*s - pad_left + dx
//   for some output position (oy, ox) inside g.
//
// Bound on an H100 SXM: the same multiply-adds as the conv's forward, so
// operations on the f32 CUDA cores (67 TFLOP/s), as for the forward; no
// tensor cores, since the zoo path's contract is f32 with TF32 off.
//
// Design (its own kernel, `tap_dgrad_kernel`, on the f32 tile core of
// csrc/ffma_tile.cuh, as the forward). It is an
// implicit GEMM in gather form, cut into the stride's parity phases as
// the Pallas package's `_dgrad_s2_even` cuts it: at stride 2 the input
// pixels (iy, ix) fall into 4 phases by (iy % 2, ix % 2), and a tap sends
// a phase's pixels a g value only if its output position lands on a
// stride step, the same for the whole phase. So each phase is its own
// GEMM -- rows its N*ceil(H/2)*ceil(W/2) pixels, columns Cin, depth its
// taps x Cout -- with only its own taps: 9 taps across the 4 phases of a
// 3x3/s2 conv where the first dgrad kernel multiplied 36, three quarters
// of them by gathered zeros (its stride-2 heads ran at 6% of the bound).
// The wrapper builds the phase tables on the host from XLA's SAME split,
// odd sizes too (ops/tap_conv.py `dgrad_phase_taps`), and passes them in
// a __grid_constant__ DgradPlan; all phases run as blocks of one grid,
// those with most taps first. A phase with no tap (a 1x1/s2 conv's odd
// rows and columns) runs no stage and writes exact zeros. Stride 1 is the
// one-phase case. Per stage a block gathers its pixels' g rows, a run of
// Cout channels each, with 16-byte cp.async (source size 0 outside g,
// which zero-fills) into a 3-slot ring, a pixel's image offset and phase
// coordinates decoded once per block and the (tap, co) depth stepped
// without divides; W^T per tap is loaded as 16 bytes along co and stored
// transposed through registers as [depth][ci] while the products run (no
// transposed copy of w). Each thread keeps an 8x8 (128x128 tile) or 8x4
// (128x64, for Cin 64, stride 2 and the 4x4 images) register tile, and a
// stage is 32 depth values deep: one barrier per 32 depth steps.
//
// Determinism. Each dx value is summed by one thread over its nonzero
// (tap, co) terms in ascending (tap, co) order, one fmaf each, as the
// first dgrad kernel summed all of k = 0..K-1: the terms dropped are exact
// zeros, so the result equals that kernel's bit for bit, relaunches are
// bit-identical, and nothing is shared between blocks.
//
// The bf16 forms (JAX's bf16 activations: the TPU kernel takes bf16
// operands, accumulates in f32 through preferred_element_type and stores
// in x's dtype, pallas_conv.py:285-306). Two kernels serve the bf16
// forward and two the bf16 dgrad, chosen by shape in Python
// (ops/tap_conv.py `wgmma_form`).
//
// The bf16 forward on the tensor cores (`tap_conv_wgmma_kernel`, on
// csrc/wgmma_tile.cuh and csrc/wgmma_conv.cuh) replaces `_tap_kernel`
// (pallas_conv.py:228) on bf16 operands for every conv whose Cin and Cout
// are multiples of 64 and whose k is 1 or 3: every conv of
// ResNet-18, ResNet-50 and VGG-16 but the stems. Bound on an H100 SXM: its
// multiply-adds at the dense bf16 tensor-core peak (989 TFLOP/s) or its
// bytes (2 a value: the pixels it reads, w, y) at 3.35 TB/s, the longer
// of the two (chip_smoke.py `bf16_bound_ms`): 0.157 ms for ResNet-18's 20
// convs at b128, mostly operations, with the 64-channel 3x3s and the
// 1x1s at the line between the two. Only wgmma reaches that rate. Design:
// an implicit GEMM, rows the output pixels, columns Cout, depth (dy, dx,
// ci) in HWIO order in steps of 64 channels. A block is one warpgroup
// (128 threads) owning 64 pixels x 64 output channels; its pixels are a
// rectangle of bn images x bh rows x bw columns chosen from (OH, OW)
// (csrc/wgmma_conv.cuh), so that one 4-D TMA box of x at the tap's
// offset is the A tile, K-major under the 128-byte swizzle, with XLA's
// SAME padding done by TMA's zero fill and stride 2 by the map's element
// strides; the step's 64 rows of w arrive as one MN-major 64 x 64 box, as
// B20 reads its w. Thread 0 keeps a 4-slot ring (x box + w box, 16 KB a
// slot) filled ahead on mbarriers; the four warps issue 4 m64n64k16
// wgmmas a step into an f32 accumulator (32 registers a thread) and free
// a slot once wait_group<1> and a barrier show its products done. 64 KB a
// block lets three blocks share an SM, so one block's TMA waits hide
// behind another's wgmmas. The epilogue rounds each sum once
// (__floats2bfloat162_rn) and stores column pairs through the fragment
// map, rows past N, OH or OW masked. Sum order: every output sums its k16
// steps in (dy, dx, ci block, k16) order from 0, whatever its rectangle,
// its place in it or the batch, and no block shares a sum (no split-K):
// a padded bucket's rows equal the batch's bit for bit and relaunches
// are bit-identical. ResNet-18's stage 4 at b128 (2,048 rows x 512
// columns) makes 32 x 8 = 256 blocks of 64 x 64, about two an SM with a
// third slot free, so no depth split is needed there.
//
// The bf16 dgrad on the tensor cores (`tap_dgrad_wgmma_kernel`) replaces
// the dgrad's use of `_tap_kernel` (`_dgrad_s1` / `_dgrad_s2_even`,
// pallas_conv.py:869/:913) on bf16 operands at the same shapes as the
// forward's tensor-core form: every dgrad of ResNet-18, ResNet-50 and
// VGG-16 (the stems have none). Bound: the forward's multiply-adds at the
// bf16 peak, or its bytes (g, w, dx), the longer: 0.159 ms for ResNet-18's
// 19 dgrads at b128. Design: the FFMA dgrad's parity phases on the
// forward's ring (`wg_ring`). dx[p, ci] = sum over the phase's taps and co
// of g[p + a(tap), co] * w[tap, ci, co], so each phase is an implicit GEMM
// with rows its pixels, columns Cin and depth (tap, co): A is g's 4-D TMA
// box of 64 channels x the rectangle at the tap's shift (ay, ax) -- the
// forward's x box, K-major, with signed coordinates and zero fill where
// the shift leaves g -- and B is a 64 x 64 box of the forward's 2-D map of
// w, read at row slot * Cin + ci0 and column co0: 64 rows of ci, each a run
// of 64 contiguous co, a K-major B (wgmma's tnspB = 0). A block is one
// warpgroup owning a rectangle of 64 pixels of one phase (bn images x bh
// phase rows x bw phase columns, `conv_rect` of the largest phase, one map
// for all phases) x 64 input channels; all phases' blocks form one grid,
// the phases with most taps first, and each thread stores its fragment's
// column pairs straight to dx at (j * s + py, i * s + px): no interleave
// pass, no staging. A phase with no tap (a 1x1/s2 conv's odd rows and
// columns) runs no step and stores zeros. The host builds the phase table
// (ops/tap_conv.py `wgmma_dgrad_plan`, cached per shape) into the FFMA
// form's DgradPlan, passed with the two maps as a __grid_constant__
// struct. Sum order: every dx value sums its phase's taps in ascending
// slot, then co blocks, then k16 steps, from 0, fixed by the shape; one
// rounding at the store; no block shares a sum, so relaunches are bit for
// bit and an image's rows do not depend on the batch.
//
// The FFMA forms: the bf16 forward and dgrad at every other shape (the
// stems, Cin 3, which are bound by their bytes). Both FFMA kernels take the
// element type as a template argument. A bf16 form loads its operands as
// bf16 (8 bytes, 4 values, where the f32 form's cp.async moves 16), widens
// them into the f32 slabs of the same ring (csrc/ffma_tile.cuh: fetch
// before the stage's products, deposit after), multiplies and adds in f32
// in the f32 form's order, and rounds each output once at the store
// (__float2bfloat16_rn). The tile and the depth split are the f32 form's,
// chosen from the shape only, so a padded bucket's real rows stay
// bit-identical. Bound: the same operations as the tensor-core form's,
// against which they reach at most the f32 CUDA cores' 67 TFLOP/s.
//
// The kernels launch on the caller's stream, synchronise nothing and
// allocate nothing: the Python wrapper allocates the output and checks
// shapes, dtypes, devices and contiguity before calling in.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "ffma_tile.cuh"
#include "wgmma_conv.cuh"

namespace {

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// The forward's block tiles, by the wrapper's tile id (ops/tap_conv.py
// FORWARD_TILES): BM x BN outputs, TM x TN a thread, 32 depth values a
// stage.
using FTile0 = ftile::Tile<128, 128, 8, 8, 32, 1>;  // 256 threads
using FTile1 = ftile::Tile<64, 64, 8, 4, 32, 2>;    // 128 threads
using FTile2 = ftile::Tile<32, 64, 8, 4, 32, 4>;    // 64 threads
using FTile3 = ftile::Tile<64, 64, 4, 4, 32, 2>;    // 256 threads
constexpr int FORWARD_TILES = 4;

struct ForwardGeo {
  int n, h, w, cin, oh, ow, cout, k, stride, pad_top, pad_left, relu, vec_out;
};

// Depth index d = (dy, dx, ci) of HWIO, stepped without divides.
struct TapCursor {
  int dy, dx, ci;
  __device__ void start(int d, int cin, int k) {
    const int t = d / cin;
    ci = d - t * cin;
    dy = t / k;
    dx = t - dy * k;
  }
  __device__ void advance(int by, int cin, int k) {
    ci += by;
    while (ci >= cin) {
      ci -= cin;
      if (++dx == k) {
        dx = 0;
        ++dy;
      }
    }
  }
};

// E is the element type of x, w and out: float, or __nv_bfloat16 (the
// bf16 form, which takes no epilogue: scale, shift and residual are null).
template <class T, int VEC, class E>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
tap_conv_kernel(const E* __restrict__ x, const E* __restrict__ wt,
                const float* __restrict__ scale, const float* __restrict__ shift,
                const float* __restrict__ residual, E* __restrict__ out,
                ForwardGeo geo) {
  using L = ftile::Layout<T, false>;
  using ftile::STAGES;
  constexpr int BK = T::BK;
  constexpr bool BF16 = ftile::is_bf16<E>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp % T::WARPS_M;
  const int warp_n = warp / T::WARPS_M;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int M = geo.n * geo.oh * geo.ow;
  const int K = geo.k * geo.k * geo.cin;
  const int stages = (K + BK - 1) / BK;

  // A = x gathered, [m][kk]: depth group `dk` (VEC depth values, one tap)
  // of pixels pm + A_STEP*c, whose image offset and input origin are
  // fixed for the whole reduction.
  constexpr int GROUPS = BK / VEC;
  static_assert(T::THREADS % GROUPS == 0, "copy roles");
  constexpr int A_STEP = T::THREADS / GROUPS;
  constexpr int A_COPIES = T::BM / A_STEP;
  static_assert(A_COPIES * A_STEP == T::BM, "copy roles");
  const int dk = tid % GROUPS;
  const int pm = tid / GROUPS;
  int a_img[A_COPIES], a_iy[A_COPIES], a_ix[A_COPIES];
#pragma unroll
  for (int c = 0; c < A_COPIES; ++c) {
    const int m = m0 + pm + A_STEP * c;
    if (m < M) {
      const int img = m / (geo.oh * geo.ow);
      const int r = m - img * geo.oh * geo.ow;
      const int oy = r / geo.ow;
      a_img[c] = img * geo.h * geo.w * geo.cin;
      a_iy[c] = oy * geo.stride - geo.pad_top;
      a_ix[c] = (r - oy * geo.ow) * geo.stride - geo.pad_left;
    } else {
      a_img[c] = 0;
      a_iy[c] = -(1 << 29);  // never a row of x: the copy zero-fills
      a_ix[c] = 0;
    }
  }
  // B = w, [kk][co]: VEC values along co of slab row b_row + B_ROWS*c.
  constexpr int B_GROUPS = T::BN / VEC;
  static_assert(T::THREADS % B_GROUPS == 0, "copy roles");
  constexpr int B_ROWS = T::THREADS / B_GROUPS;
  constexpr int B_COPIES = BK / B_ROWS;
  static_assert(B_COPIES * B_ROWS == BK, "copy roles");
  const int b_col = (tid % B_GROUPS) * VEC;
  const int b_row = tid / B_GROUPS;

  TapCursor tc;
  tc.start(dk * VEC, geo.cin, geo.k);
  int next = 0;  // the next stage to copy
  // The bf16 form's fetched values, between load and deposit.
  ftile::Bf16Pack<VEC> a_held[BF16 ? A_COPIES : 1], b_held[BF16 ? B_COPIES : 1];

  auto load = [&]() {
    float* As = smem + (next % STAGES) * L::STAGE_FLOATS;
    float* Bs = As + L::A_FLOATS;
    const bool d_ok = next * BK + dk * VEC < K;
#pragma unroll
    for (int c = 0; c < A_COPIES; ++c) {
      const int iy = a_iy[c] + tc.dy;
      const int ix = a_ix[c] + tc.dx;
      const bool ok = d_ok && (unsigned)iy < (unsigned)geo.h && (unsigned)ix < (unsigned)geo.w;
      const E* src = ok ? x + a_img[c] + (iy * geo.w + ix) * geo.cin + tc.ci : x;
      float* dst = As + (pm + A_STEP * c) * L::A_LD + dk * VEC;
      if constexpr (BF16) a_held[c] = ftile::fetch_bf16<VEC>(src, ok);
      else if constexpr (VEC == 4) ftile::cp_async16(dst, src, ok);
      else ftile::cp_async4(dst, src, ok);
    }
#pragma unroll
    for (int c = 0; c < B_COPIES; ++c) {
      const int kk = b_row + B_ROWS * c;
      const int r = next * BK + kk;
      const int co = n0 + b_col;
      const bool ok = r < K && co < geo.cout;
      const E* src = ok ? wt + r * geo.cout + co : wt;
      float* dst = Bs + kk * T::B_LD + b_col;
      if constexpr (BF16) b_held[c] = ftile::fetch_bf16<VEC>(src, ok);
      else if constexpr (VEC == 4) ftile::cp_async16(dst, src, ok);
      else ftile::cp_async4(dst, src, ok);
    }
    ++next;
    tc.advance(BK, geo.cin, geo.k);
  };
  // bf16: the values load fetched, widened into the slot of stage next - 1.
  auto deposit = [&]() {
    if constexpr (BF16) {
      float* As = smem + ((next - 1) % STAGES) * L::STAGE_FLOATS;
      float* Bs = As + L::A_FLOATS;
#pragma unroll
      for (int c = 0; c < A_COPIES; ++c)
        ftile::deposit_bf16<VEC>(As + (pm + A_STEP * c) * L::A_LD + dk * VEC, a_held[c]);
#pragma unroll
      for (int c = 0; c < B_COPIES; ++c)
        ftile::deposit_bf16<VEC>(Bs + (b_row + B_ROWS * c) * T::B_LD + b_col, b_held[c]);
    }
  };

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (next < stages) {
      load();
      deposit();
    }
    ftile::cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    ftile::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed for all; slot (s-1) % STAGES is free
    const bool more = next < stages;
    if (more) load();  // bf16: its global loads are in flight during the products
    ftile::cp_async_commit();
    const float* As = smem + (s % STAGES) * L::STAGE_FLOATS;
    ftile::compute_stage<T, false>(As, As + L::A_FLOATS, warp_m, warp_n, lane, acc);
    if (more) deposit();
  }

  // Epilogue on the f32 accumulator, then the single store (bf16: rounded
  // once, here).
  float sc[T::TN], sh[T::TN];
#pragma unroll
  for (int j = 0; j < T::TN; ++j) {
    const int co = n0 + ftile::col_of<T>(warp_n, lane, j);
    sc[j] = scale != nullptr && co < geo.cout ? scale[co] : 0.0f;
    sh[j] = scale != nullptr && co < geo.cout ? shift[co] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = m0 + ftile::row_of<T, false>(warp_m, lane, i);
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < T::TN; jj += 4) {
      const int co = n0 + ftile::col_of<T>(warp_n, lane, jj);
      const int o = m * geo.cout + co;
      float res[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (geo.vec_out) {  // Cout % 4 == 0: a run of 4 is all in or all out
        if (co >= geo.cout) continue;
        if (residual != nullptr) {
          const float4 r4 = *reinterpret_cast<const float4*>(residual + o);
          res[0] = r4.x;
          res[1] = r4.y;
          res[2] = r4.z;
          res[3] = r4.w;
        }
      } else if (residual != nullptr) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (co + q < geo.cout) res[q] = residual[o + q];
      }
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        z[q] = acc[i][jj + q];
        if (scale != nullptr) z[q] = z[q] * sc[jj + q] + sh[jj + q];
        if (residual != nullptr) z[q] += res[q];
        if (geo.relu) z[q] = fmaxf(z[q], 0.0f);
      }
      if (geo.vec_out) {
        ftile::store4(out + o, z[0], z[1], z[2], z[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (co + q < geo.cout) ftile::store1(out + o + q, z[q]);
      }
    }
  }
}

template <class T, int VEC, class E>
cudaError_t launch_forward(const E* x, const E* w, const float* scale,
                           const float* shift, const float* residual, E* out,
                           const ForwardGeo& geo, cudaStream_t s) {
  using L = ftile::Layout<T, false>;
  static bool smem_ok = false;
  auto kernel = tap_conv_kernel<T, VEC, E>;
  cudaError_t err = ftile::allow_smem(kernel, L::SMEM_BYTES, smem_ok);
  if (err != cudaSuccess) return err;
  const long long m = static_cast<long long>(geo.n) * geo.oh * geo.ow;
  const dim3 grid(static_cast<unsigned>((m + T::BM - 1) / T::BM),
                  static_cast<unsigned>((geo.cout + T::BN - 1) / T::BN));
  kernel<<<grid, T::THREADS, L::SMEM_BYTES, s>>>(x, w, scale, shift, residual, out, geo);
  return cudaGetLastError();
}

template <class T, class E>
cudaError_t launch_forward_tile(bool vec4, const E* x, const E* w,
                                const float* scale, const float* shift,
                                const float* residual, E* out, const ForwardGeo& geo,
                                cudaStream_t s) {
  return vec4 ? launch_forward<T, 4, E>(x, w, scale, shift, residual, out, geo, s)
              : launch_forward<T, 1, E>(x, w, scale, shift, residual, out, geo, s);
}

// ---------------------------------------------------------------------------
// The input gradient (dgrad): its own kernel on the same f32 tile core.
// ---------------------------------------------------------------------------

constexpr int MAX_PHASES = 4;   // stride 2: the 4 parities of (iy, ix)
constexpr int MAX_TAPS = 49;    // every tap of a 7x7 conv lies in one phase

// The phase table, built by the wrapper (ops/tap_conv.py
// `dgrad_phase_taps` and `_dgrad_table`) as this many int32s in this order.
struct DgradPlan {
  int phases;                        // phases with pixels, heaviest first
  int n_tiles;                       // ceil(Cin / BN)
  int block_begin[MAX_PHASES + 1];   // first block of each phase; [phases] = grid
  int py[MAX_PHASES], px[MAX_PHASES];  // parity of the phase's (iy, ix)
  int hp[MAX_PHASES], wp[MAX_PHASES];  // its rows and columns
  int tap_begin[MAX_PHASES + 1];     // its taps: tap_begin[p] .. tap_begin[p+1]-1
  int slot[MAX_TAPS];                // tap dy*k + dx, ascending within a phase
  int ay[MAX_TAPS], ax[MAX_TAPS];    // g row = phase row + ay, column + ax
};

// The block tiles, by the wrapper's tile id: 256 threads, 32 depth values
// a stage, and the registers of one block an SM (which a sweep on the
// H100 found faster than two blocks' worth).
using DTile0 = ftile::Tile<128, 128, 8, 8, 32, 1>;
using DTile1 = ftile::Tile<128, 64, 8, 4, 32, 1>;

struct DgradGeo {
  int n, h, w, cin, oh, ow, cout, stride, vec_dx;
};

// Depth index d = (tap t of the phase, co), stepped without divides.
struct DepthCursor {
  int t, co;
  __device__ void start(int d, int cout) {
    t = d / cout;
    co = d - t * cout;
  }
  __device__ void advance(int by, int cout) {
    co += by;
    while (co >= cout) {
      co -= cout;
      ++t;
    }
  }
};

// E is the element type of g, w and dx: float, or __nv_bfloat16.
template <class T, int VEC, class E>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
tap_dgrad_kernel(const E* __restrict__ g, const E* __restrict__ wt,
                 E* __restrict__ dx, DgradGeo geo,
                 const __grid_constant__ DgradPlan plan) {
  using L = ftile::Layout<T, false>;
  using ftile::STAGES;
  constexpr int BK = T::BK;
  constexpr bool BF16 = ftile::is_bf16<E>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_ay[MAX_TAPS], s_ax[MAX_TAPS], s_w[MAX_TAPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp % T::WARPS_M;
  const int warp_n = warp / T::WARPS_M;

  int p = 0;
  while (p + 1 < plan.phases && static_cast<int>(blockIdx.x) >= plan.block_begin[p + 1]) ++p;
  const int local = blockIdx.x - plan.block_begin[p];
  const int m0 = (local / plan.n_tiles) * T::BM;   // phase pixels
  const int n0 = (local % plan.n_tiles) * T::BN;   // input channels
  const int hp = plan.hp[p], wp = plan.wp[p];
  const int Mp = geo.n * hp * wp;
  const int tb = plan.tap_begin[p];
  const int taps = plan.tap_begin[p + 1] - tb;
  const int K = taps * geo.cout;
  const int stages = (K + BK - 1) / BK;
  for (int t = tid; t < taps; t += T::THREADS) {
    s_ay[t] = plan.ay[tb + t];
    s_ax[t] = plan.ax[tb + t];
    s_w[t] = plan.slot[tb + t] * geo.cin;
  }
  __syncthreads();

  // A = g gathered, [m][kk]: depth group `dk` (VEC depth values, one tap)
  // of pixels pm + A_STEP*c. A pixel's image offset into g and its phase
  // row and column are fixed for the whole reduction.
  constexpr int GROUPS = BK / VEC;
  static_assert(T::THREADS % GROUPS == 0, "copy roles");
  constexpr int A_STEP = T::THREADS / GROUPS;
  constexpr int A_COPIES = T::BM / A_STEP;
  const int dk = tid % GROUPS;
  const int pm = tid / GROUPS;
  int a_img[A_COPIES], a_j[A_COPIES], a_i[A_COPIES];
#pragma unroll
  for (int c = 0; c < A_COPIES; ++c) {
    const int m = m0 + pm + A_STEP * c;
    if (m < Mp) {
      const int img = m / (hp * wp);
      const int r = m - img * hp * wp;
      a_img[c] = img * geo.oh * geo.ow * geo.cout;
      a_j[c] = r / wp;
      a_i[c] = r - a_j[c] * wp;
    } else {
      a_img[c] = 0;
      a_j[c] = -(1 << 29);  // never a row of g: the copy zero-fills
      a_i[c] = 0;
    }
  }
  // B = W^T, [kk][ci]: the same depth group for channels ci + B_STEP*c,
  // loaded as VEC values along co and stored transposed.
  constexpr int B_STEP = T::THREADS / GROUPS;
  constexpr int B_COPIES = T::BN / B_STEP;
  float breg[BF16 ? 1 : B_COPIES][VEC];
  // The bf16 form's fetched values, between load and store_b.
  ftile::Bf16Pack<VEC> a_held[BF16 ? A_COPIES : 1], b_held[BF16 ? B_COPIES : 1];

  DepthCursor dc;
  dc.start(dk * VEC, geo.cout);
  int next = 0;  // the next stage to copy

  auto load = [&]() {  // A by cp.async (bf16: into registers), B into registers
    float* As = smem + (next % STAGES) * L::STAGE_FLOATS;
    const bool d_ok = next * BK + dk * VEC < K;
    int ay = 0, ax = 0, wrow = 0;
    if (d_ok) {
      ay = s_ay[dc.t];
      ax = s_ax[dc.t];
      wrow = s_w[dc.t];
    }
#pragma unroll
    for (int c = 0; c < A_COPIES; ++c) {
      const int oy = a_j[c] + ay;
      const int ox = a_i[c] + ax;
      const bool ok = d_ok && (unsigned)oy < (unsigned)geo.oh && (unsigned)ox < (unsigned)geo.ow;
      const E* src = ok ? g + a_img[c] + (oy * geo.ow + ox) * geo.cout + dc.co : g;
      float* dst = As + (pm + A_STEP * c) * L::A_LD + dk * VEC;
      if constexpr (BF16) a_held[c] = ftile::fetch_bf16<VEC>(src, ok);
      else if constexpr (VEC == 4) ftile::cp_async16(dst, src, ok);
      else ftile::cp_async4(dst, src, ok);
    }
#pragma unroll
    for (int c = 0; c < B_COPIES; ++c) {
      const int ci = n0 + pm + B_STEP * c;
      const bool ok = d_ok && ci < geo.cin;
      if constexpr (BF16) {
        b_held[c] = ftile::fetch_bf16<VEC>(wt + (ok ? (wrow + ci) * geo.cout + dc.co : 0), ok);
      } else if constexpr (VEC == 4) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (ok) v = __ldg(reinterpret_cast<const float4*>(wt + (wrow + ci) * geo.cout + dc.co));
        breg[c][0] = v.x;
        breg[c][1] = v.y;
        breg[c][2] = v.z;
        breg[c][3] = v.w;
      } else {
        breg[c][0] = ok ? __ldg(wt + (wrow + ci) * geo.cout + dc.co) : 0.0f;
      }
    }
  };
  auto store_b = [&]() {  // bf16: A widened into its slot too
    float* As = smem + (next % STAGES) * L::STAGE_FLOATS;
    float* Bs = As + L::A_FLOATS;
    if constexpr (BF16) {
#pragma unroll
      for (int c = 0; c < A_COPIES; ++c)
        ftile::deposit_bf16<VEC>(As + (pm + A_STEP * c) * L::A_LD + dk * VEC, a_held[c]);
#pragma unroll
      for (int c = 0; c < B_COPIES; ++c) {
        float v[VEC];
        if constexpr (VEC == 4) {
          v[0] = ftile::bf16_lo(b_held[c].x);
          v[1] = ftile::bf16_hi(b_held[c].x);
          v[2] = ftile::bf16_lo(b_held[c].y);
          v[3] = ftile::bf16_hi(b_held[c].y);
        } else {
          v[0] = ftile::bf16_lo(b_held[c]);
        }
#pragma unroll
        for (int q = 0; q < VEC; ++q) Bs[(dk * VEC + q) * T::B_LD + pm + B_STEP * c] = v[q];
      }
    } else {
#pragma unroll
      for (int c = 0; c < B_COPIES; ++c)
#pragma unroll
        for (int q = 0; q < VEC; ++q) Bs[(dk * VEC + q) * T::B_LD + pm + B_STEP * c] = breg[c][q];
    }
    ++next;
    dc.advance(BK, geo.cout);
  };

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (next < stages) {
      load();
      store_b();
    }
    ftile::cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    ftile::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed for all; slot (s-1) % STAGES is free
    const bool more = next < stages;
    if (more) load();  // B's loads are in flight during the products
    ftile::cp_async_commit();
    const float* As = smem + (s % STAGES) * L::STAGE_FLOATS;
    ftile::compute_stage<T, false>(As, As + L::A_FLOATS, warp_m, warp_n, lane, acc);
    if (more) store_b();
  }

  // A phase with no tap (stages == 0) writes its exact zeros here.
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = m0 + ftile::row_of<T, false>(warp_m, lane, i);
    if (m >= Mp) continue;
    const int img = m / (hp * wp);
    const int r = m - img * hp * wp;
    const int j = r / wp;
    const int iy = j * geo.stride + plan.py[p];
    const int ix = (r - j * wp) * geo.stride + plan.px[p];
    E* dst = dx + ((img * geo.h + iy) * geo.w + ix) * geo.cin;
#pragma unroll
    for (int jj = 0; jj < T::TN; jj += 4) {
      const int ci = n0 + ftile::col_of<T>(warp_n, lane, jj);
      if (geo.vec_dx) {  // Cin % 4 == 0: a run of 4 is all in or all out
        if (ci < geo.cin)
          ftile::store4(dst + ci, acc[i][jj], acc[i][jj + 1], acc[i][jj + 2], acc[i][jj + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (ci + q < geo.cin) ftile::store1(dst + ci + q, acc[i][jj + q]);
      }
    }
  }
}

template <class T, int VEC, class E>
cudaError_t launch_dgrad(const E* g, const E* w, E* dx, const DgradGeo& geo,
                         const DgradPlan& plan, cudaStream_t s) {
  using L = ftile::Layout<T, false>;
  static bool smem_ok = false;
  auto kernel = tap_dgrad_kernel<T, VEC, E>;
  cudaError_t err = ftile::allow_smem(kernel, L::SMEM_BYTES, smem_ok);
  if (err != cudaSuccess) return err;
  kernel<<<plan.block_begin[plan.phases], T::THREADS, L::SMEM_BYTES, s>>>(g, w, dx, geo, plan);
  return cudaGetLastError();
}

template <class T, class E>
cudaError_t launch_dgrad_tile(bool vec4, const E* g, const E* w, E* dx,
                              const DgradGeo& geo, const DgradPlan& plan, cudaStream_t s) {
  return vec4 ? launch_dgrad<T, 4, E>(g, w, dx, geo, plan, s)
              : launch_dgrad<T, 1, E>(g, w, dx, geo, plan, s);
}

// The forward's launch for either element type; the bf16 form's copies
// take 8 bytes (4 values) where the f32 form's take 16.
template <class E>
int forward_entry(const E* x, const E* w, const float* scale, const float* shift,
                  const float* residual, E* out, int n, int h, int w_in, int cin, int oh,
                  int ow, int cout, int k, int stride, int pad_top, int pad_left, int relu,
                  int tile, void* stream) {
  if (n <= 0 || h <= 0 || w_in <= 0 || cin <= 0 || oh <= 0 || ow <= 0 ||
      cout <= 0 || k <= 0 || stride <= 0 || pad_top < 0 || pad_left < 0 ||
      tile < 0 || tile >= FORWARD_TILES || (scale == nullptr) != (shift == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_out = cout % 4 == 0 && aligned16(out) &&
                       (residual == nullptr || aligned16(residual));
  const ForwardGeo geo{n, h, w_in, cin, oh, ow, cout, k, stride, pad_top, pad_left,
                       relu, vec_out};
  const bool vec4 = cin % 4 == 0 && cout % 4 == 0 && aligned16(x) && aligned16(w);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile) {
    case 0: err = launch_forward_tile<FTile0>(vec4, x, w, scale, shift, residual, out, geo, s); break;
    case 1: err = launch_forward_tile<FTile1>(vec4, x, w, scale, shift, residual, out, geo, s); break;
    case 2: err = launch_forward_tile<FTile2>(vec4, x, w, scale, shift, residual, out, geo, s); break;
    default: err = launch_forward_tile<FTile3>(vec4, x, w, scale, shift, residual, out, geo, s); break;
  }
  return static_cast<int>(err);
}

template <class E>
int dgrad_entry(const E* g, const E* w, E* dx, int n, int h, int w_in, int cin, int oh,
                int ow, int cout, int stride, const int* table, int table_len, int tile,
                void* stream) {
  if (n <= 0 || h <= 0 || w_in <= 0 || cin <= 0 || oh <= 0 || ow <= 0 ||
      cout <= 0 || stride <= 0 || table == nullptr || tile < 0 || tile > 1 ||
      table_len != static_cast<int>(sizeof(DgradPlan) / sizeof(int))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DgradPlan plan;
  std::memcpy(&plan, table, sizeof(plan));
  if (plan.phases < 1 || plan.phases > MAX_PHASES || plan.n_tiles < 1 ||
      plan.tap_begin[plan.phases] > MAX_TAPS || plan.block_begin[plan.phases] < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DgradGeo geo{n, h, w_in, cin, oh, ow, cout, stride,
                     cin % 4 == 0 && aligned16(dx)};
  const bool vec4 = cout % 4 == 0 && aligned16(g) && aligned16(w);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile) {
    case 0: err = launch_dgrad_tile<DTile0>(vec4, g, w, dx, geo, plan, s); break;
    default: err = launch_dgrad_tile<DTile1>(vec4, g, w, dx, geo, plan, s); break;
  }
  return static_cast<int>(err);
}


// ---------------------------------------------------------------------------
// The bf16 forward and dgrad on the tensor cores (see the header: "The bf16
// forward on the tensor cores", "The bf16 dgrad on the tensor cores").
// ---------------------------------------------------------------------------

constexpr int WG_STAGES = 4;  // the ring: 4 x (A box + B box) = 64 KB
constexpr int WG_SMEM_BYTES = wgtile::ATOM_BYTES + WG_STAGES * 2 * wgconv::BOX_BYTES;

// The ring both tensor-core kernels of this file run. Depth step j of
// `steps` lands in slot j % WG_STAGES as an A box (64 pixels x 64 depth
// values, K-major) and a B box (64 depth values x 64 columns: MN-major with
// TRANS_B = 1, the forward's w; K-major with TRANS_B = 0, the dgrad's),
// which thread 0 requests with `issue(j, slot address, slot mbarrier)`
// after telling the barrier to expect both boxes. The warpgroup adds each
// step's 4 m64n64k16 products into `acc` from 0, steps in order, and thread
// 0 refills a slot once wait_group<1> and a barrier show its products
// done. With no step, acc stays 0.
template <int TRANS_B, class Issue>
__device__ __forceinline__ void wg_ring(int steps, const Issue& issue, float (&acc)[32]) {
  using namespace wgconv;
  extern __shared__ uint8_t wg_smem[];  // aligned to 1,024 bytes below
  __shared__ __align__(8) uint64_t full[WG_STAGES];
  const uint32_t ring = wgtile::align_atom(wg_smem);
  const int t = threadIdx.x;
  if (t == 0) {
    for (int i = 0; i < WG_STAGES; ++i) wgtile::mbar_init(wgtile::smem_addr(&full[i]), 1);
  }
  __syncthreads();
  auto request = [&](int j) {
    const int slot = j % WG_STAGES;
    const uint32_t bar = wgtile::smem_addr(&full[slot]);
    wgtile::mbar_arrive_expect_tx(bar, 2 * BOX_BYTES);
    issue(j, ring + slot * 2 * BOX_BYTES, bar);
  };
  if (t == 0) {
    for (int j = 0; j < WG_STAGES && j < steps; ++j) request(j);
  }

#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int s = 0; s < steps; ++s) {
    const int slot = s % WG_STAGES;
    wgtile::mbar_wait(wgtile::smem_addr(&full[slot]), (s / WG_STAGES) & 1);
    const uint32_t a = ring + slot * 2 * BOX_BYTES;
    wgtile::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K16_STEPS; ++kk) {
      const uint64_t b = TRANS_B ? wgtile::mn_major_desc(a + BOX_BYTES, kk, BOX_BYTES)
                                 : wgtile::k_major_desc(a + BOX_BYTES, kk);
      wgtile::wgmma_m64n64k16_bf16<0, TRANS_B>(acc, wgtile::k_major_desc(a, kk), b, 1);
    }
    wgtile::wgmma_commit();
    wgtile::wgmma_wait<1>();  // step s - 1's products are done in this warp ...
    __syncthreads();          // ... and in every warp: its slot is free
    if (t == 0 && s >= 1 && s - 1 + WG_STAGES < steps) request(s - 1 + WG_STAGES);
  }
  wgtile::wgmma_wait_all();
  wgtile::fence_regs(acc);
}

struct WgmmaForward {
  CUtensorMap xmap;   // x (C, W, H, N), boxes of 64 channels x the rectangle
  CUtensorMap wmap;   // w as (k*k*Cin, Cout), boxes of 64 rows x 64 columns
  wgconv::Rect rect;
  int n, oh, ow, cin, cout, k, stride, pad_top, pad_left;
};

// One thread's two fragment rows (frag_row(i, t) for i % 4 < 2 and >= 2)
// as offsets from the rectangle's origin, and whether each lies inside
// (N, OH, OW): `at[h]` is the pixel's index (img * OH + oy) * OW + ox.
struct FragRows {
  long long at[2];
  bool in[2];

  __device__ __forceinline__ FragRows(const wgconv::Rect& rect, int n0, int oy0, int ox0, int n,
                                      int oh, int ow, int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int di, dy, dx;
      rect.pixel(wgtile::frag_row(2 * h, t), di, dy, dx);
      const int img = n0 + di, oy = oy0 + dy, ox = ox0 + dx;
      in[h] = img < n && oy < oh && ox < ow;
      at[h] = (static_cast<long long>(img) * oh + oy) * ow + ox;
    }
  }
};

__global__ void __launch_bounds__(wgtile::THREADS)
tap_conv_wgmma_kernel(const __grid_constant__ WgmmaForward p,
                      __nv_bfloat16* __restrict__ out) {
  using namespace wgconv;
  const int t = threadIdx.x;
  int n0, oy0, ox0;
  p.rect.origin(blockIdx.x, n0, oy0, ox0);
  const int co0 = blockIdx.y * CH;
  const int cblocks = p.cin / CH;

  // Depth step j = (tap, channel block): x's box at the tap, w's 64 rows.
  auto issue = [&](int j, uint32_t a, uint32_t bar) {
    const int tap = j / cblocks;
    const int c0 = (j - tap * cblocks) * CH;
    const int dy = tap / p.k;
    const int dx = tap - dy * p.k;
    wgtile::tma_load_4d(a, &p.xmap, bar, c0, ox0 * p.stride + dx - p.pad_left,
                        oy0 * p.stride + dy - p.pad_top, n0);
    wgtile::tma_load_2d(a + BOX_BYTES, &p.wmap, bar, co0, tap * p.cin + c0);
  };
  float acc[32];
  wg_ring<1>(p.k * p.k * cblocks, issue, acc);

  // Each thread rounds its fragment once and stores column pairs.
  const FragRows rows(p.rect, n0, oy0, ox0, p.n, p.oh, p.ow, t);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int h = (i / 2) % 2;
    if (!rows.in[h]) continue;
    const int co = co0 + wgtile::frag_col(i, t);
    *reinterpret_cast<__nv_bfloat162*>(out + rows.at[h] * p.cout + co) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

struct WgmmaDgrad {
  CUtensorMap gmap;   // g (Cout, OW, OH, N), boxes of 64 channels x the rectangle
  CUtensorMap wmap;   // w as (k*k*Cin, Cout), boxes of 64 rows x 64 columns
  DgradPlan plan;     // n_tiles = Cin / 64; a phase's blocks: its rectangles x n_tiles
  int n, h, w, cin, cout, stride, bn, bh, bw;
};

__global__ void __launch_bounds__(wgtile::THREADS)
tap_dgrad_wgmma_kernel(const __grid_constant__ WgmmaDgrad p,
                       __nv_bfloat16* __restrict__ dx) {
  using namespace wgconv;
  const DgradPlan& plan = p.plan;
  const int t = threadIdx.x;
  int ph = 0;
  while (ph + 1 < plan.phases && static_cast<int>(blockIdx.x) >= plan.block_begin[ph + 1]) ++ph;
  const int local = blockIdx.x - plan.block_begin[ph];
  const int ci0 = (local % plan.n_tiles) * CH;
  const int hp = plan.hp[ph], wp = plan.wp[ph];
  const Rect rect{p.bn, p.bh, p.bw, (hp + p.bh - 1) / p.bh, (wp + p.bw - 1) / p.bw};
  int n0, j0, i0;  // the rectangle's origin in the phase's (N, hp, wp)
  rect.origin(local / plan.n_tiles, n0, j0, i0);
  const int tb = plan.tap_begin[ph];
  const int cblocks = p.cout / CH;

  // Depth step j = (the phase's tap, g's channel block): g's box at the
  // tap's shift (ay, ax), and 64 rows of w (the tap's slot, ci0 ..) read at
  // the same 64 output channels.
  auto issue = [&](int j, uint32_t a, uint32_t bar) {
    const int tap = tb + j / cblocks;
    const int c0 = (j - (tap - tb) * cblocks) * CH;
    wgtile::tma_load_4d(a, &p.gmap, bar, c0, i0 + plan.ax[tap], j0 + plan.ay[tap], n0);
    wgtile::tma_load_2d(a + BOX_BYTES, &p.wmap, bar, c0, plan.slot[tap] * p.cin + ci0);
  };
  float acc[32];
  wg_ring<0>((plan.tap_begin[ph + 1] - tb) * cblocks, issue, acc);

  // Each thread rounds its fragment once and stores column pairs at its
  // rows' pixels (j * s + py, i * s + px) of dx; a tapless phase stores 0.
  long long at[2];
  bool in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int di, dj, dii;
    rect.pixel(wgtile::frag_row(2 * h, t), di, dj, dii);
    const int img = n0 + di, j = j0 + dj, i = i0 + dii;
    in[h] = img < p.n && j < hp && i < wp;
    at[h] = (static_cast<long long>(img) * p.h + j * p.stride + plan.py[ph]) * p.w +
            i * p.stride + plan.px[ph];
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int h = (i / 2) % 2;
    if (!in[h]) continue;
    const int ci = ci0 + wgtile::frag_col(i, t);
    *reinterpret_cast<__nv_bfloat162*>(dx + at[h] * p.cin + ci) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

int forward_wgmma_entry(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* out,
                        int n, int h, int w_in, int cin, int oh, int ow, int cout, int k,
                        int stride, int pad_top, int pad_left, int bn, int bh, int bw,
                        void* stream) {
  if (n <= 0 || h <= 0 || w_in <= 0 || oh <= 0 || ow <= 0 || k <= 0 || stride <= 0 ||
      pad_top < 0 || pad_left < 0 || cin <= 0 || cin % wgconv::CH != 0 || cout <= 0 ||
      cout % wgconv::CH != 0 || !wgconv::rect_ok(bn, bh, bw) || !aligned16(x) ||
      !aligned16(w) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WgmmaForward p;
  if (!wgconv::encode_activation(&p.xmap, x, n, h, w_in, cin, bn, bh, bw, stride) ||
      !wgtile::encode_bf16_sw128(&p.wmap, w, cout, static_cast<uint64_t>(k) * k * cin,
                                 static_cast<uint64_t>(cout) * 2, wgconv::CH)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.rect = wgconv::Rect{bn, bh, bw, (oh + bh - 1) / bh, (ow + bw - 1) / bw};
  p.n = n;
  p.oh = oh;
  p.ow = ow;
  p.cin = cin;
  p.cout = cout;
  p.k = k;
  p.stride = stride;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  static bool smem_ok = false;
  cudaError_t err = ftile::allow_smem(tap_conv_wgmma_kernel, WG_SMEM_BYTES, smem_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rects = static_cast<long long>((n + bn - 1) / bn) * p.rect.tiles_h *
                          p.rect.tiles_w;
  if (rects > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rects), static_cast<unsigned>(cout / wgconv::CH));
  tap_conv_wgmma_kernel<<<grid, wgtile::THREADS, WG_SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}

int dgrad_wgmma_entry(const __nv_bfloat16* g, const __nv_bfloat16* w, __nv_bfloat16* dx, int n,
                      int h, int w_in, int cin, int oh, int ow, int cout, int k, int stride,
                      const int* table, int table_len, int bn, int bh, int bw, void* stream) {
  if (n <= 0 || h <= 0 || w_in <= 0 || oh <= 0 || ow <= 0 || k <= 0 || stride <= 0 ||
      cin <= 0 || cin % wgconv::CH != 0 || cout <= 0 || cout % wgconv::CH != 0 ||
      !wgconv::rect_ok(bn, bh, bw) || !aligned16(g) || !aligned16(w) || !aligned16(dx) ||
      table == nullptr || table_len != static_cast<int>(sizeof(DgradPlan) / sizeof(int))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WgmmaDgrad p;
  std::memcpy(&p.plan, table, sizeof(p.plan));
  const DgradPlan& plan = p.plan;
  if (plan.phases < 1 || plan.phases > MAX_PHASES || plan.n_tiles != cin / wgconv::CH ||
      plan.tap_begin[plan.phases] > MAX_TAPS || plan.block_begin[plan.phases] < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < plan.tap_begin[plan.phases]; ++i) {
    if (plan.slot[i] < 0 || plan.slot[i] >= k * k) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!wgconv::encode_activation(&p.gmap, g, n, oh, ow, cout, bn, bh, bw, 1) ||
      !wgtile::encode_bf16_sw128(&p.wmap, w, cout, static_cast<uint64_t>(k) * k * cin,
                                 static_cast<uint64_t>(cout) * 2, wgconv::CH)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.n = n;
  p.h = h;
  p.w = w_in;
  p.cin = cin;
  p.cout = cout;
  p.stride = stride;
  p.bn = bn;
  p.bh = bh;
  p.bw = bw;
  static bool smem_ok = false;
  cudaError_t err = ftile::allow_smem(tap_dgrad_wgmma_kernel, WG_SMEM_BYTES, smem_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  tap_dgrad_wgmma_kernel<<<plan.block_begin[plan.phases], wgtile::THREADS, WG_SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(p, dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; `scale` and
// `shift` are both null (no affine step) or both set; `residual` may be
// null. `tile` is the block tile (ops/tap_conv.py FORWARD_TILES, by id).
// Returns 0 on a launch that was accepted, else the cudaError_t.
extern "C" int tap_conv_forward(const float* x, const float* w,
                                const float* scale, const float* shift,
                                const float* residual, float* out, int n,
                                int h, int w_in, int cin, int oh, int ow,
                                int cout, int k, int stride, int pad_top,
                                int pad_left, int relu, int tile, void* stream) {
  return forward_entry(x, w, scale, shift, residual, out, n, h, w_in, cin, oh, ow, cout, k,
                       stride, pad_top, pad_left, relu, tile, stream);
}

// The bf16 form (JAX's bf16 activations): x, w and out bf16, the sums f32,
// each output rounded once; no epilogue (the eval path that has one is
// f32). Returns as tap_conv_forward.
extern "C" int tap_conv_forward_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                     __nv_bfloat16* out, int n, int h, int w_in, int cin,
                                     int oh, int ow, int cout, int k, int stride,
                                     int pad_top, int pad_left, int tile, void* stream) {
  return forward_entry<__nv_bfloat16>(x, w, nullptr, nullptr, nullptr, out, n, h, w_in, cin,
                                      oh, ow, cout, k, stride, pad_top, pad_left, 0, tile,
                                      stream);
}

// The bf16 forward on the tensor cores: x, w and out bf16, Cin and Cout
// multiples of 64, every pointer 16-byte aligned; (bn, bh, bw) the
// rectangle of output pixels a block covers (ops/tap_conv.py `conv_rect`,
// bn * bh * bw = 64). Returns as tap_conv_forward.
extern "C" int tap_conv_forward_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                      __nv_bfloat16* out, int n, int h, int w_in, int cin,
                                      int oh, int ow, int cout, int k, int stride, int pad_top,
                                      int pad_left, int bn, int bh, int bw, void* stream) {
  return forward_wgmma_entry(x, w, out, n, h, w_in, cin, oh, ow, cout, k, stride, pad_top,
                             pad_left, bn, bh, bw, stream);
}

// Input gradient of the conv above: `g` is (N,OH,OW,Cout), `w` the forward's
// (k,k,Cin,Cout) weights, `dx` (N,H,W,Cin) is written in full. `table`
// holds `table_len` int32s, the DgradPlan the wrapper built for this
// shape (phases, their taps and the grid) on the host; `tile` is the
// block tile (0: 128x128, 1: 128x64). Returns 0 on a launch
// that was accepted, else the cudaError_t.
extern "C" int tap_conv_dgrad(const float* g, const float* w, float* dx, int n,
                              int h, int w_in, int cin, int oh, int ow,
                              int cout, int stride, const int* table,
                              int table_len, int tile, void* stream) {
  return dgrad_entry(g, w, dx, n, h, w_in, cin, oh, ow, cout, stride, table, table_len, tile,
                     stream);
}

// The bf16 form: g, w and dx bf16, the sums f32, each dx rounded once.
extern "C" int tap_conv_dgrad_bf16(const __nv_bfloat16* g, const __nv_bfloat16* w,
                                   __nv_bfloat16* dx, int n, int h, int w_in, int cin,
                                   int oh, int ow, int cout, int stride, const int* table,
                                   int table_len, int tile, void* stream) {
  return dgrad_entry(g, w, dx, n, h, w_in, cin, oh, ow, cout, stride, table, table_len, tile,
                     stream);
}

// The bf16 dgrad on the tensor cores: g, w and dx bf16, Cin and Cout
// multiples of 64, every pointer 16-byte aligned; `table` the DgradPlan of
// ops/tap_conv.py `wgmma_dgrad_plan` (n_tiles = Cin / 64, each phase's
// blocks its rectangles x n_tiles) and (bn, bh, bw) the rectangle of phase
// pixels a block covers. Returns as tap_conv_forward.
extern "C" int tap_conv_dgrad_wgmma(const __nv_bfloat16* g, const __nv_bfloat16* w,
                                    __nv_bfloat16* dx, int n, int h, int w_in, int cin,
                                    int oh, int ow, int cout, int k, int stride,
                                    const int* table, int table_len, int bn, int bh, int bw,
                                    void* stream) {
  return dgrad_wgmma_entry(g, w, dx, n, h, w_in, cin, oh, ow, cout, k, stride, table,
                           table_len, bn, bh, bw, stream);
}
