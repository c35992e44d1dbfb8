// Weight gradient of the SAME-padded NHWC float32 (and bfloat16)
// convolution, written for Hopper (sm_90a) and bound to Python through
// ctypes.
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
// Bound on an H100 SXM. The same multiply-adds as the conv's forward
// (k*k*Cin*Cout per output pixel), so a 3x3 conv is bound by operations on
// the f32 CUDA cores (67 TFLOP/s); only the stem (Cin 3) is bound by its
// bytes. No tensor cores: the zoo path's contract is f32 with TF32 off.
//
// Design (csrc/ffma_tile.cuh holds the core it shares with dgrad). The
// TPU summed the pixel axis along its sequential grid, carrying the sum in
// VMEM (pallas_conv.py:330-347); Hopper's blocks run in no order and share
// nothing. So the pixel axis is cut into chunks, one per blockIdx.z, whose
// size the wrapper chooses from the shape (ops/tap_wgrad.py `wgrad_plan`)
// so the grid holds about 1,152 blocks: the 1x1/s2 projections get 256 to
// 512 blocks where a fixed 2,048-pixel chunk gave them 32, and the stem
// 512 chunks of 256 pixels where it had 64 of 2,048. Pass one: a block of
// 128 threads owns a 64 x 64 tile (R rows x Cout columns) of one chunk
// and keeps an 8x4 register tile a thread (0.375 floats from shared
// memory per fma where the first kernel's 4x4 tile needed 0.5; a sweep on
// the H100 found this tile, with finer chunks, faster at every ResNet-18
// wgrad than 128x128 tiles of 8x8). A stage is 16 pixels: for each, the A
// slab row is the run of channels of x under each of the block's taps
// and the B slab row the run of g's channels, both copied with 16-byte
// cp.async straight into a 3-slot ring, two stages in flight behind the
// products and one barrier a stage (4-byte copies where Cin or Cout is
// not a multiple of 4 or a pointer is not 16-byte aligned, as for the
// stem's Cin 3). Padding pixels and pixels past the chunk are zero-filled
// by the copy itself (source size 0). Each thread walks its pixels'
// (image, row, column) forward by 16 a stage, with no divide per element.
// Each block writes its chunk's partial tile to scratch the wrapper
// allocated (at most 32 MiB, so the 50 MB L2 holds it); pass two sums the
// partials of each element in chunk order. No float atomics: every
// element is summed in one fixed order for a given shape, so relaunches
// are bit-identical. (The order depends on the batch size, since the
// batch is what is reduced; the serving forward's rule against
// batch-dependent split-K is about its padded buckets, which a gradient
// never sees.) With one chunk, pass one writes gw directly.
//
// The bf16 forms (the TPU kernel takes bf16 x and g and writes f32, which
// _conv2d_bwd rounds to w's dtype, pallas_conv.py:663/:1047). Two kernels
// serve them, chosen by shape in Python (ops/tap_conv.py `wgmma_form`).
// Both write f32 partials, one tile a chunk of the pixel axis, and pass
// two (`wgrad_sum_kernel`) sums them in chunk order in f32 and rounds each
// sum to bf16 once, one chunk too: the order is fixed by the shape, and
// relaunches are bit-identical.
//
// The bf16 form on the tensor cores (`wgrad_wgmma_kernel`, on
// csrc/wgmma_tile.cuh and csrc/wgmma_conv.cuh) replaces
// `_wgrad_tap_kernel` (pallas_conv.py:321) on bf16 operands for every
// conv whose Cin and Cout are multiples of 64 and whose k is 1 or 3:
// every wgrad of
// ResNet-18, ResNet-50 and VGG-16 but the stems'. Bound on an H100 SXM:
// the forward's multiply-adds at the dense bf16 peak (989 TFLOP/s) or
// its bytes (the pixels it reads, g, gw) at 3.35 TB/s, the longer
// (chip_smoke.py `bf16_bound_ms`): 0.157 ms for ResNet-18's 20 wgrads at
// b128. Only wgmma reaches that rate. Design: a GEMM over pixels, rows the
// 64 channels of x at one tap, columns 64 of Cout, depth the output
// pixels of one chunk, 64 at a time: a rectangle of bn images x bh rows x
// bw columns (csrc/wgmma_conv.cuh). One 4-D TMA box of g over the
// rectangle is B (pixels as rows of 64 channels: MN-major), and one box of
// x a tap, at that tap's offset with SAME zero fill and stride-2 element
// strides, is A, which lands with the channels (M) contiguous: an MN-major
// A, which wgmma takes from shared memory with its transpose-A flag
// (wgtile::wgmma_m64n64k16_bf16<1>). A block (one warpgroup) owns a row of
// a 3x3 conv's taps (three accumulator tiles, 96 registers a thread: one g
// box serves three x boxes) or a 1x1 conv's one tap, so a ring slot is g's
// box and one x box a tap: 3 slots of 32 KB (two blocks an SM) or 4 of 16
// KB (three). Thread 0 fills the ring ahead on mbarriers; the warps run 4
// m64n64k16 wgmmas a tap a rectangle and free a slot once wait_group<1>
// and a barrier show its products done. The first k16 step of a chunk
// writes its product alone (scale_d = 0), so no other instruction defines
// the accumulators (zeroing them made ptxas serialize the wgmmas). The
// chunks (ops/tap_wgrad.py `wgmma_plan`, from the shape alone: about 264
// blocks, one wave of two an SM, chunks of at least 4 rectangles, the 32
// MiB scratch cap) replace the FFMA form's 1,152-block target, which was
// set for a slower core. Each block writes its chunk's partial tiles with
// float2 stores through the fragment map. No float atomics.
//
// The FFMA form (every other shape: the stems, Cin 3, bound by their
// bytes). The element type is a template argument: bf16 x and g are
// loaded as 8-byte runs into registers and widened into the f32 ring
// (csrc/ffma_tile.cuh), then multiplied and added on the CUDA cores in
// the f32 form's order (at most the f32 cores' 67 TFLOP/s).
//
// The kernels launch on the caller's stream, synchronise nothing and
// allocate nothing.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "ffma_tile.cuh"
#include "wgmma_conv.cuh"

namespace {

using ftile::STAGES;
// The one block tile: 64 rows x 64 channels, 8x4 sums a thread, 128
// threads, 16 pixels a stage, up to 4 blocks an SM.
using WTile = ftile::Tile<64, 64, 8, 4, 16, 4>;
constexpr int BK = WTile::BK;

constexpr int SUM_THREADS = 256;

struct Geometry {
  int n, h, w, cin, oh, ow, cout, k, stride, pad_top, pad_left, chunk;
};

// (image, output row, output column) of one pixel of the reduction,
// stepped forward without divides.
struct Cursor {
  int img, oy, ox;
  __device__ void start(int m, const Geometry& g) {
    img = m / (g.oh * g.ow);
    const int r = m - img * g.oh * g.ow;
    oy = r / g.ow;
    ox = r - oy * g.ow;
  }
  __device__ void advance(int by, const Geometry& g) {
    ox += by;
    while (ox >= g.ow) {
      ox -= g.ow;
      if (++oy == g.oh) {
        oy = 0;
        ++img;
      }
    }
  }
};

// E is the element type of x and g: float, or __nv_bfloat16. The partial
// sums are f32 either way.
template <class T, int AVEC, int BVEC, class E>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
wgrad_partial_kernel(const E* __restrict__ x, const E* __restrict__ g,
                     float* __restrict__ out, Geometry geo) {
  using L = ftile::Layout<T, true>;
  constexpr bool BF16 = ftile::is_bf16<E>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp % T::WARPS_M;
  const int warp_n = warp / T::WARPS_M;
  const int R = geo.k * geo.k * geo.cin;
  const int M = geo.n * geo.oh * geo.ow;
  const int r0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int m_begin = blockIdx.z * geo.chunk;
  const int m_end = min(M, m_begin + geo.chunk);
  const int stages = (m_end - m_begin + BK - 1) / BK;

  // A copies: row group `a_rg` (AVEC rows of one tap) for the pixels
  // a_kk + A_STEP*c of each stage. The group's tap and channel are fixed.
  constexpr int A_GROUPS = T::BM / AVEC;
  static_assert(T::THREADS % A_GROUPS == 0, "A copy roles");
  constexpr int A_STEP = T::THREADS / A_GROUPS;
  constexpr int A_COPIES = BK / A_STEP;
  const int a_rg = tid % A_GROUPS;
  const int a_kk = tid / A_GROUPS;
  const int a_row = r0 + a_rg * AVEC;
  const bool a_row_ok = a_row < R;
  int a_dy = 0, a_dx = 0, a_ci = 0;
  if (a_row_ok) {
    const int tap = a_row / geo.cin;
    a_ci = a_row - tap * geo.cin;
    a_dy = tap / geo.k - geo.pad_top;
    a_dx = tap - (tap / geo.k) * geo.k - geo.pad_left;
  }
  Cursor cur[A_COPIES];
#pragma unroll
  for (int c = 0; c < A_COPIES; ++c) cur[c].start(m_begin + a_kk + A_STEP * c, geo);

  // B copies: channel group `b_cg` of g's rows for pixels b_kk + B_STEP*c.
  constexpr int B_GROUPS = T::BN / BVEC;
  static_assert(T::THREADS % B_GROUPS == 0, "B copy roles");
  constexpr int B_STEP = T::THREADS / B_GROUPS;
  constexpr int B_COPIES = BK / B_STEP;
  const int b_cg = tid % B_GROUPS;
  const int b_kk = tid / B_GROUPS;
  const int b_co = n0 + b_cg * BVEC;
  const bool b_co_ok = b_co < geo.cout;

  int next = 0;  // the next stage to copy
  // The bf16 form's fetched values, between load_stage and deposit.
  ftile::Bf16Pack<AVEC> a_held[BF16 ? A_COPIES : 1];
  ftile::Bf16Pack<BVEC> b_held[BF16 ? B_COPIES : 1];
  auto load_stage = [&]() {
    float* As = smem + (next % STAGES) * L::STAGE_FLOATS;
    float* Bs = As + L::A_FLOATS;
    const int p0 = m_begin + next * BK;
#pragma unroll
    for (int c = 0; c < A_COPIES; ++c) {
      const int kk = a_kk + A_STEP * c;
      const int iy = cur[c].oy * geo.stride + a_dy;
      const int ix = cur[c].ox * geo.stride + a_dx;
      const bool ok = a_row_ok && p0 + kk < m_end && (unsigned)iy < (unsigned)geo.h &&
                      (unsigned)ix < (unsigned)geo.w;
      const E* src =
          ok ? x + ((static_cast<long long>(cur[c].img) * geo.h + iy) * geo.w + ix) * geo.cin +
                   a_ci
             : x;
      float* dst = As + kk * L::A_LD + a_rg * AVEC;
      if constexpr (BF16) a_held[c] = ftile::fetch_bf16<AVEC>(src, ok);
      else if constexpr (AVEC == 4) ftile::cp_async16(dst, src, ok);
      else ftile::cp_async4(dst, src, ok);
      cur[c].advance(BK, geo);
    }
#pragma unroll
    for (int c = 0; c < B_COPIES; ++c) {
      const int kk = b_kk + B_STEP * c;
      const bool ok = b_co_ok && p0 + kk < m_end;
      const E* src = ok ? g + static_cast<long long>(p0 + kk) * geo.cout + b_co : g;
      float* dst = Bs + kk * T::B_LD + b_cg * BVEC;
      if constexpr (BF16) b_held[c] = ftile::fetch_bf16<BVEC>(src, ok);
      else if constexpr (BVEC == 4) ftile::cp_async16(dst, src, ok);
      else ftile::cp_async4(dst, src, ok);
    }
    ++next;
  };
  // bf16: the values load_stage fetched, widened into the slot of stage
  // next - 1.
  auto deposit = [&]() {
    if constexpr (BF16) {
      float* As = smem + ((next - 1) % STAGES) * L::STAGE_FLOATS;
      float* Bs = As + L::A_FLOATS;
#pragma unroll
      for (int c = 0; c < A_COPIES; ++c)
        ftile::deposit_bf16<AVEC>(As + (a_kk + A_STEP * c) * L::A_LD + a_rg * AVEC, a_held[c]);
#pragma unroll
      for (int c = 0; c < B_COPIES; ++c)
        ftile::deposit_bf16<BVEC>(Bs + (b_kk + B_STEP * c) * T::B_LD + b_cg * BVEC, b_held[c]);
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
      load_stage();
      deposit();
    }
    ftile::cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    ftile::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed for all; slot (s-1) % STAGES is free
    const bool more = next < stages;
    if (more) load_stage();  // bf16: its global loads are in flight during the products
    ftile::cp_async_commit();
    const float* As = smem + (s % STAGES) * L::STAGE_FLOATS;
    ftile::compute_stage<T, true>(As, As + L::A_FLOATS, warp_m, warp_n, lane, acc);
    if (more) deposit();
  }

  float* tile = out + static_cast<long long>(blockIdx.z) * R * geo.cout;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int row = r0 + ftile::row_of<T, true>(warp_m, lane, i);
    if (row >= R) continue;
    float* dst = tile + static_cast<long long>(row) * geo.cout;
#pragma unroll
    for (int j = 0; j < T::TN; j += 4) {
      const int co = n0 + ftile::col_of<T>(warp_n, lane, j);
      if constexpr (BVEC == 4) {  // Cout % 4 == 0: a run of 4 is all in or all out
        if (co < geo.cout)
          *reinterpret_cast<float4*>(dst + co) =
              make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (co + q < geo.cout) dst[co + q] = acc[i][j + q];
      }
    }
  }
}

// gw[e] = sum over chunks c = 0, 1, ... of partial[c][e], in that order,
// in f32; a bf16 gw rounds the sum once.
template <class O>
__global__ void __launch_bounds__(SUM_THREADS)
wgrad_sum_kernel(const float* __restrict__ partial, O* __restrict__ gw,
                 int elems, int chunks) {
  for (int e = blockIdx.x * SUM_THREADS + threadIdx.x; e < elems;
       e += gridDim.x * SUM_THREADS) {
    float s = partial[e];
#pragma unroll 8
    for (int c = 1; c < chunks; ++c) {
      s += partial[static_cast<long long>(c) * elems + e];
    }
    ftile::store1(gw + e, s);
  }
}

template <class T, int AVEC, int BVEC, class E>
cudaError_t launch_partial(const E* x, const E* g, float* out, const Geometry& geo,
                           int rows, int chunks, cudaStream_t s) {
  using L = ftile::Layout<T, true>;
  static bool smem_ok = false;
  auto kernel = wgrad_partial_kernel<T, AVEC, BVEC, E>;
  cudaError_t err = ftile::allow_smem(kernel, L::SMEM_BYTES, smem_ok);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + T::BM - 1) / T::BM, (geo.cout + T::BN - 1) / T::BN, chunks);
  kernel<<<grid, T::THREADS, L::SMEM_BYTES, s>>>(x, g, out, geo);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// Both passes for either element type. f32 with one chunk writes gw from
// pass one; a bf16 gw always takes pass two, which rounds each sum once.
template <class E>
int wgrad_entry(const E* x, const E* g, float* partial, E* gw, int n, int h, int w_in,
                int cin, int oh, int ow, int cout, int k, int stride, int pad_top,
                int pad_left, int chunk, void* stream) {
  constexpr bool BF16 = ftile::is_bf16<E>;
  if (n <= 0 || h <= 0 || w_in <= 0 || cin <= 0 || oh <= 0 || ow <= 0 ||
      cout <= 0 || k <= 0 || stride <= 0 || pad_top < 0 || pad_left < 0 ||
      chunk <= 0 || chunk % BK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long m = static_cast<long long>(n) * oh * ow;
  const long long chunks_ll = (m + chunk - 1) / chunk;
  if (chunks_ll > 65535 || ((BF16 || chunks_ll > 1) && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = static_cast<int>(chunks_ll);
  const int rows = k * k * cin;
  const Geometry geo{n, h, w_in, cin, oh, ow, cout, k, stride, pad_top, pad_left, chunk};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool avec4 = cin % 4 == 0 && aligned16(x);
  const bool bvec4 = cout % 4 == 0 && aligned16(g);
  const bool direct = !BF16 && chunks == 1;
  float* out = direct ? reinterpret_cast<float*>(gw) : partial;
  cudaError_t err;
  if (avec4 && bvec4) err = launch_partial<WTile, 4, 4>(x, g, out, geo, rows, chunks, s);
  else if (avec4) err = launch_partial<WTile, 4, 1>(x, g, out, geo, rows, chunks, s);
  else if (bvec4) err = launch_partial<WTile, 1, 4>(x, g, out, geo, rows, chunks, s);
  else err = launch_partial<WTile, 1, 1>(x, g, out, geo, rows, chunks, s);
  if (err != cudaSuccess || direct) return static_cast<int>(err);
  const int elems = rows * cout;
  const int blocks = std::min((elems + SUM_THREADS - 1) / SUM_THREADS, 132 * 8);
  wgrad_sum_kernel<E><<<blocks, SUM_THREADS, 0, s>>>(partial, gw, elems, chunks);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The bf16 weight gradient on the tensor cores (see the header: "The bf16
// form on the tensor cores").
// ---------------------------------------------------------------------------

// A block owns TAPS taps (a row of a 3x3 conv's taps, or a 1x1 conv's one)
// x 64 input channels x 64 output channels of one chunk; a stage is one
// rectangle of 64 output pixels: g's box and one x box a tap. The ring has
// WG_STAGES<TAPS> slots: 3 x 32 KB (two blocks an SM) or 4 x 16 KB (three).
template <int TAPS>
constexpr int WG_STAGES = TAPS == 1 ? 4 : 3;
template <int TAPS>
constexpr int WG_SLOT_BYTES = (1 + TAPS) * wgconv::BOX_BYTES;
template <int TAPS>
constexpr int WG_SMEM_BYTES = wgtile::ATOM_BYTES + WG_STAGES<TAPS> * WG_SLOT_BYTES<TAPS>;

struct WgmmaWgrad {
  CUtensorMap xmap;   // x (C, W, H, N), boxes of 64 channels x the rectangle
  CUtensorMap gmap;   // g (Cout, OW, OH, N), the same boxes
  wgconv::Rect rect;
  int n, oh, ow, cin, cout, k, stride, pad_top, pad_left, rects, chunk_rects;
};

template <int TAPS>
__global__ void __launch_bounds__(wgtile::THREADS)
wgrad_wgmma_kernel(const __grid_constant__ WgmmaWgrad p, float* __restrict__ partial) {
  using namespace wgconv;
  constexpr int SLOTS = WG_STAGES<TAPS>;
  constexpr int SLOT = WG_SLOT_BYTES<TAPS>;
  extern __shared__ uint8_t wg_smem[];  // aligned to 1,024 bytes below
  __shared__ __align__(8) uint64_t full[SLOTS];
  const uint32_t ring = wgtile::align_atom(wg_smem);
  const int t = threadIdx.x;
  const int cblocks = p.cin / CH;
  const int tap0 = (blockIdx.x / cblocks) * TAPS;
  const int c0 = (blockIdx.x % cblocks) * CH;
  const int co0 = blockIdx.y * CH;
  const int r0 = blockIdx.z * p.chunk_rects;
  const int steps = min(p.rects - r0, p.chunk_rects);

  if (t == 0) {
    for (int i = 0; i < SLOTS; ++i) wgtile::mbar_init(wgtile::smem_addr(&full[i]), 1);
  }
  __syncthreads();
  // Thread 0: rectangle r0 + j (g's box, then each tap's x box) into slot
  // j % SLOTS.
  auto issue = [&](int j) {
    int n0, oy0, ox0;
    p.rect.origin(r0 + j, n0, oy0, ox0);
    const uint32_t slot = ring + (j % SLOTS) * SLOT;
    const uint32_t bar = wgtile::smem_addr(&full[j % SLOTS]);
    wgtile::mbar_arrive_expect_tx(bar, SLOT);
    wgtile::tma_load_4d(slot, &p.gmap, bar, co0, ox0, oy0, n0);
#pragma unroll
    for (int q = 0; q < TAPS; ++q) {
      const int dy = (tap0 + q) / p.k;
      const int dx = tap0 + q - dy * p.k;
      wgtile::tma_load_4d(slot + (1 + q) * BOX_BYTES, &p.xmap, bar, c0,
                          ox0 * p.stride + dx - p.pad_left, oy0 * p.stride + dy - p.pad_top,
                          n0);
    }
  };
  if (t == 0) {
    for (int j = 0; j < SLOTS && j < steps; ++j) issue(j);
  }

  // No instruction but wgmma defines the accumulators (a zeroing pass
  // makes ptxas serialize the wgmmas of three tiles): the first k16 step
  // of a chunk writes A . B alone (scale_d = 0), so every chunk sums its
  // pixels from 0 in (rectangle, k16) order. A chunk has a rectangle at
  // least.
  float acc[TAPS][32];
  for (int s = 0; s < steps; ++s) {
    const uint32_t slot = ring + (s % SLOTS) * SLOT;
    wgtile::mbar_wait(wgtile::smem_addr(&full[s % SLOTS]), (s / SLOTS) & 1);
    wgtile::wgmma_fence();
#pragma unroll
    for (int q = 0; q < TAPS; ++q) {
#pragma unroll
      for (int kk = 0; kk < K16_STEPS; ++kk) {
        // A = x's box, MN-major (channels contiguous, pixels the depth);
        // B = g's box, MN-major.
        wgtile::wgmma_m64n64k16_bf16<1>(
            acc[q], wgtile::mn_major_desc(slot + (1 + q) * BOX_BYTES, kk, BOX_BYTES),
            wgtile::mn_major_desc(slot, kk, BOX_BYTES), s > 0 || kk > 0);
      }
    }
    wgtile::wgmma_commit();
    wgtile::wgmma_wait<1>();  // step s - 1's products are done in this warp ...
    __syncthreads();          // ... and in every warp: its slot is free
    if (t == 0 && s >= 1 && s - 1 + SLOTS < steps) issue(s - 1 + SLOTS);
  }
  wgtile::wgmma_wait_all();

  // The chunk's f32 partial tile of each tap: rows tap*Cin + ci, columns co.
  float* tile = partial + static_cast<long long>(blockIdx.z) * p.k * p.k * p.cin * p.cout;
#pragma unroll
  for (int q = 0; q < TAPS; ++q) {
    wgtile::fence_regs(acc[q]);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const long long row = static_cast<long long>(tap0 + q) * p.cin + c0 + wgtile::frag_row(i, t);
      *reinterpret_cast<float2*>(tile + row * p.cout + co0 + wgtile::frag_col(i, t)) =
          make_float2(acc[q][i], acc[q][i + 1]);
    }
  }
}

template <int TAPS>
cudaError_t launch_wgrad_wgmma(const WgmmaWgrad& p, float* partial, int chunks,
                               cudaStream_t s) {
  static bool smem_ok = false;
  cudaError_t err = ftile::allow_smem(wgrad_wgmma_kernel<TAPS>, WG_SMEM_BYTES<TAPS>, smem_ok);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.k * p.k / TAPS * (p.cin / wgconv::CH)),
                  static_cast<unsigned>(p.cout / wgconv::CH), static_cast<unsigned>(chunks));
  wgrad_wgmma_kernel<TAPS><<<grid, wgtile::THREADS, WG_SMEM_BYTES<TAPS>, s>>>(p, partial);
  return cudaGetLastError();
}

// Pass one on the tensor cores into `partial` (one f32 tile a chunk), then
// pass two (wgrad_sum_kernel) rounds each chunk-ordered sum once into gw.
int wgrad_wgmma_entry(const __nv_bfloat16* x, const __nv_bfloat16* g, float* partial,
                      __nv_bfloat16* gw, int n, int h, int w_in, int cin, int oh, int ow,
                      int cout, int k, int stride, int pad_top, int pad_left, int bn, int bh,
                      int bw, int chunk_rects, void* stream) {
  if (n <= 0 || h <= 0 || w_in <= 0 || oh <= 0 || ow <= 0 || stride <= 0 || pad_top < 0 ||
      pad_left < 0 || (k != 1 && k != 3) || cin <= 0 || cin % wgconv::CH != 0 || cout <= 0 ||
      cout % wgconv::CH != 0 || !wgconv::rect_ok(bn, bh, bw) || chunk_rects <= 0 ||
      partial == nullptr || !aligned16(x) || !aligned16(g) || !aligned16(partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WgmmaWgrad p;
  p.rect = wgconv::Rect{bn, bh, bw, (oh + bh - 1) / bh, (ow + bw - 1) / bw};
  const long long rects = static_cast<long long>((n + bn - 1) / bn) * p.rect.tiles_h *
                          p.rect.tiles_w;
  const long long chunks = (rects + chunk_rects - 1) / chunk_rects;
  if (rects > 0x7fffffffLL || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (!wgconv::encode_activation(&p.xmap, x, n, h, w_in, cin, bn, bh, bw, stride) ||
      !wgconv::encode_activation(&p.gmap, g, n, oh, ow, cout, bn, bh, bw, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.n = n;
  p.oh = oh;
  p.ow = ow;
  p.cin = cin;
  p.cout = cout;
  p.k = k;
  p.stride = stride;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.rects = static_cast<int>(rects);
  p.chunk_rects = chunk_rects;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = k == 3 ? launch_wgrad_wgmma<3>(p, partial, static_cast<int>(chunks), s)
                           : launch_wgrad_wgmma<1>(p, partial, static_cast<int>(chunks), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int elems = k * k * cin * cout;
  const int blocks = std::min((elems + SUM_THREADS - 1) / SUM_THREADS, 132 * 8);
  wgrad_sum_kernel<__nv_bfloat16><<<blocks, SUM_THREADS, 0, s>>>(partial, gw, elems,
                                                                 static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pixels per stage: the wrapper's chunk must be a multiple of it.
extern "C" int tap_wgrad_stage_pixels() { return BK; }

// Plain C entry point for ctypes. Pointers are device pointers. `chunk`
// is the pixels per partial sum (a positive multiple of the stage depth,
// 16), from the wrapper's plan; `partial` holds ceil(N*OH*OW / chunk) partial
// (k*k*Cin, Cout) tiles and may be null when that is one. `gw`
// (k,k,Cin,Cout) is written in full. Returns 0 on launches that were
// accepted, else the cudaError_t.
extern "C" int tap_conv_wgrad(const float* x, const float* g, float* partial,
                              float* gw, int n, int h, int w_in, int cin,
                              int oh, int ow, int cout, int k, int stride,
                              int pad_top, int pad_left, int chunk, void* stream) {
  return wgrad_entry(x, g, partial, gw, n, h, w_in, cin, oh, ow, cout, k, stride, pad_top,
                     pad_left, chunk, stream);
}

// The bf16 form: x and g bf16, f32 partials (never null here, one tile
// at least), their f32 chunk sum rounded once into the bf16 gw, as the TPU
// kernel's f32 output is rounded to w's dtype (pallas_conv.py:1047).
extern "C" int tap_conv_wgrad_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                   float* partial, __nv_bfloat16* gw, int n, int h, int w_in,
                                   int cin, int oh, int ow, int cout, int k, int stride,
                                   int pad_top, int pad_left, int chunk, void* stream) {
  return wgrad_entry(x, g, partial, gw, n, h, w_in, cin, oh, ow, cout, k, stride, pad_top,
                     pad_left, chunk, stream);
}

// The bf16 form on the tensor cores: x and g bf16 with Cin and Cout
// multiples of 64, k 1 or 3, every pointer 16-byte aligned; (bn, bh, bw)
// the rectangle of output pixels a depth step covers (ops/tap_conv.py
// `conv_rect`), `chunk_rects` rectangles a chunk (ops/tap_wgrad.py
// `wgmma_plan`); `partial` holds one f32 (k*k*Cin, Cout) tile a chunk.
// Returns as tap_conv_wgrad.
extern "C" int tap_conv_wgrad_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                    float* partial, __nv_bfloat16* gw, int n, int h, int w_in,
                                    int cin, int oh, int ow, int cout, int k, int stride,
                                    int pad_top, int pad_left, int bn, int bh, int bw,
                                    int chunk_rects, void* stream) {
  return wgrad_wgmma_entry(x, g, partial, gw, n, h, w_in, cin, oh, ow, cout, k, stride, pad_top,
                           pad_left, bn, bh, bw, chunk_rects, stream);
}
