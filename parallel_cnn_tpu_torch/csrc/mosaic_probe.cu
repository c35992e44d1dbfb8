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
//   same bytes: conv_contract_kernel, with L = bb*576.
// - pair-dot (x.w over N = 128, then out[:, :64] + out[:, 64:]) and two-dot
//   (x.w[:, :64] + x.w[:, 64:]) are the same sum of two products:
//   pair_sum_kernel.
//
// vpu-conv keeps its own per-filter form (per_filter_conv_kernel): one pass
// of 25 multiply-adds for each filter, each op rounded on its own
// (__fmul_rn/__fadd_rn), as _vpu_conv_kernel loops `acc += w[m,t]*x[t]`.
// conv_contract_kernel reads each x column once and keeps all 6 filters'
// sums in registers, one fma per tap. The pair is the probe's question on
// this card: B1's conv form against the one-contraction form.
//
// Types follow JAX's promotion: in the three conv probes w is f32 and x is
// bf16, widened exactly (__bfloat162float) and multiplied in f32; in the
// pair and two-dot probes x and w are bf16, widened exactly, with f32
// products and sums (preferred_element_type=f32). Every sum is taken in a
// fixed order per output, with no atomics: a relaunch is bit-identical.
//
// Bounds on an H100 SXM (3.35 TB/s; f32 67 TFLOP/s outside the tensor
// cores; bf16 989 TFLOP/s), at the probes' shapes, every one set by bytes:
//   rank3-dot  327,680 B (4.2 MFLOP f32)          0.098 us
//   lane-merge 14,745,600 B                        4.40 us
//   lane-split 589,824 B                           0.18 us
//   the convs  5,456,472 B (22.1 MFLOP f32)        1.63 us
//   the dots   409,600 B (16.8 MFLOP bf16)         0.12 us
// Every probe but lane-merge moves so little that a launch's latency sets
// its time. These first kernels run on the CUDA cores; mma.sync, wgmma and
// TMA are for later work.
//
// The kernels launch on the caller's stream, synchronise nothing and
// allocate nothing: the Python wrapper (ops/mosaic_probe.py) allocates the
// outputs and checks devices, dtypes, shapes and contiguity first. Each
// entry point returns 0 for a launch that was accepted, else the
// cudaError_t (cudaErrorInvalidValue for sizes it refuses).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TAPS = 25;      // 5x5 conv taps
constexpr int FILTERS = 6;    // conv output channels
constexpr int PAIR_K = 64;    // depth of the pair and two-dot products
constexpr int PAIR_N = 64;    // width of each half of their w (2*PAIR_N)

// ---------------------------------------------------------------------------
// rank3-dot: out[b] = a[b] @ b[b] over a leading batch dim, f32.
// One 16x16 block per (batch, output tile); both operands' K slabs staged
// in shared memory, one fma per product in k order.
// ---------------------------------------------------------------------------

constexpr int TILE = 16;

__global__ void __launch_bounds__(TILE * TILE)
batched_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int m, int k, int n) {
  __shared__ float as[TILE][TILE + 1];
  __shared__ float bs[TILE][TILE + 1];
  const long long batch = blockIdx.z;
  const int row = blockIdx.y * TILE + threadIdx.y;
  const int col = blockIdx.x * TILE + threadIdx.x;
  const float* ab = a + batch * m * k;
  const float* bb = b + batch * k * n;
  float acc = 0.f;
  for (int k0 = 0; k0 < k; k0 += TILE) {
    const int ka = k0 + threadIdx.x;
    const int kb = k0 + threadIdx.y;
    as[threadIdx.y][threadIdx.x] =
        (row < m && ka < k) ? ab[static_cast<long long>(row) * k + ka] : 0.f;
    bs[threadIdx.y][threadIdx.x] =
        (kb < k && col < n) ? bb[static_cast<long long>(kb) * n + col] : 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      acc = fmaf(as[threadIdx.y][j], bs[j][threadIdx.x], acc);
    }
    __syncthreads();
  }
  if (row < m && col < n) {
    out[(batch * m + row) * n + col] = acc;
  }
}

// ---------------------------------------------------------------------------
// lane-merge, lane-split: a flat copy of n contiguous f32 values.
// Grid-stride; 16-byte loads and stores when both buffers are 16-byte
// aligned, then a scalar tail of n % 4 values.
// ---------------------------------------------------------------------------

constexpr int COPY_THREADS = 256;
constexpr long long COPY_MAX_BLOCKS = 132 * 16;

__global__ void __launch_bounds__(COPY_THREADS)
copy_kernel(const float* __restrict__ src, float* __restrict__ dst,
            long long n, int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * COPY_THREADS;
  const long long i = static_cast<long long>(blockIdx.x) * COPY_THREADS +
                      threadIdx.x;
  long long scalar_from = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (long long j = i; j < n4; j += stride) d4[j] = s4[j];
    scalar_from = n4 * 4;
  }
  for (long long j = scalar_from + i; j < n; j += stride) dst[j] = src[j];
}

// ---------------------------------------------------------------------------
// The convs. x is (25, l) tap-major bf16 (l = bb*576 for the 3-D probes),
// w (6, 25) f32, out (6, l) f32.
// ---------------------------------------------------------------------------

constexpr int CONV_THREADS = 256;

// mxu-conv-L and mxu-conv-3d: one thread per column reads its 25 taps once
// and keeps the 6 filters' sums in registers.
__global__ void __launch_bounds__(CONV_THREADS)
conv_contract_kernel(const float* __restrict__ w,
                     const __nv_bfloat16* __restrict__ x,
                     float* __restrict__ out, long long l) {
  __shared__ float ws[FILTERS * TAPS];
  for (int i = threadIdx.x; i < FILTERS * TAPS; i += CONV_THREADS) ws[i] = w[i];
  __syncthreads();
  const long long col =
      static_cast<long long>(blockIdx.x) * CONV_THREADS + threadIdx.x;
  if (col >= l) return;
  float acc[FILTERS];
#pragma unroll
  for (int m = 0; m < FILTERS; ++m) acc[m] = 0.f;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    const float xv = __bfloat162float(x[t * l + col]);
#pragma unroll
    for (int m = 0; m < FILTERS; ++m) acc[m] = fmaf(ws[m * TAPS + t], xv, acc[m]);
  }
#pragma unroll
  for (int m = 0; m < FILTERS; ++m) out[m * l + col] = acc[m];
}

// vpu-conv: blockIdx.y is the filter; one pass of 25 multiply-adds over the
// taps per (filter, column), each product and each sum rounded on its own,
// so the result is the plain version's bit for bit.
__global__ void __launch_bounds__(CONV_THREADS)
per_filter_conv_kernel(const float* __restrict__ w,
                       const __nv_bfloat16* __restrict__ x,
                       float* __restrict__ out, long long l) {
  __shared__ float ws[TAPS];
  const int m = blockIdx.y;
  if (threadIdx.x < TAPS) ws[threadIdx.x] = w[m * TAPS + threadIdx.x];
  __syncthreads();
  const long long col =
      static_cast<long long>(blockIdx.x) * CONV_THREADS + threadIdx.x;
  if (col >= l) return;
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    acc = __fadd_rn(acc, __fmul_rn(ws[t], __bfloat162float(x[t * l + col])));
  }
  out[m * l + col] = acc;
}

// ---------------------------------------------------------------------------
// pair-dot and two-dot: out[r,n] = sum_k x[r,k] w[k,n] + sum_k x[r,k] w[k,64+n]
// for x (rows, 64) and w (64, 128) bf16, out (rows, 64) f32. A block of
// 64x4 threads owns 32 rows: all of w and its 32 rows of x widened into
// shared memory; each thread finishes both 64-term sums of its column
// (fma in k order), then adds them.
// ---------------------------------------------------------------------------

constexpr int PAIR_ROWS = 32;
constexpr int PAIR_TY = 4;

__global__ void __launch_bounds__(PAIR_N * PAIR_TY)
pair_sum_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                int rows) {
  __shared__ float ws[PAIR_K][2 * PAIR_N];
  __shared__ float xs[PAIR_ROWS][PAIR_K + 1];
  const int tid = threadIdx.y * PAIR_N + threadIdx.x;
  for (int i = tid; i < PAIR_K * 2 * PAIR_N; i += PAIR_N * PAIR_TY) {
    ws[i / (2 * PAIR_N)][i % (2 * PAIR_N)] = __bfloat162float(w[i]);
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * PAIR_ROWS;
  for (int i = tid; i < PAIR_ROWS * PAIR_K; i += PAIR_N * PAIR_TY) {
    const long long r = r0 + i / PAIR_K;
    xs[i / PAIR_K][i % PAIR_K] =
        r < rows ? __bfloat162float(x[r * PAIR_K + i % PAIR_K]) : 0.f;
  }
  __syncthreads();
  const int n = threadIdx.x;
  for (int rr = threadIdx.y; rr < PAIR_ROWS && r0 + rr < rows; rr += PAIR_TY) {
    float lo = 0.f;
    float hi = 0.f;
#pragma unroll 16
    for (int k = 0; k < PAIR_K; ++k) {
      const float xv = xs[rr][k];
      lo = fmaf(xv, ws[k][n], lo);
      hi = fmaf(xv, ws[k][PAIR_N + n], hi);
    }
    out[(r0 + rr) * PAIR_N + n] = lo + hi;
  }
}

int status() { return static_cast<int>(cudaGetLastError()); }

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15u) == 0;
}

int launch_copy(const float* src, float* dst, long long n, void* stream) {
  if (n <= 0) return invalid();
  const long long quads = (n + 3) / 4;
  long long blocks = (quads + COPY_THREADS - 1) / COPY_THREADS;
  if (blocks > COPY_MAX_BLOCKS) blocks = COPY_MAX_BLOCKS;
  const int vec = aligned16(src) && aligned16(dst);
  copy_kernel<<<static_cast<unsigned>(blocks), COPY_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(src, dst, n, vec);
  return status();
}

int launch_contract(const float* w, const void* x, float* out, long long l,
                    void* stream) {
  const long long blocks = (l + CONV_THREADS - 1) / CONV_THREADS;
  if (l <= 0 || blocks > 0x7fffffffLL) return invalid();
  conv_contract_kernel<<<static_cast<unsigned>(blocks), CONV_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const __nv_bfloat16*>(x), out, l);
  return status();
}

int launch_pair_sum(const void* x, const void* w, float* out, int rows,
                    void* stream) {
  if (rows <= 0) return invalid();
  const unsigned blocks = (static_cast<unsigned>(rows) + PAIR_ROWS - 1) / PAIR_ROWS;
  pair_sum_kernel<<<blocks, dim3(PAIR_N, PAIR_TY), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      out, rows);
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
  if (batch <= 0 || batch > 65535 || m <= 0 || k <= 0 || n <= 0) return invalid();
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE, batch);
  if (grid.y > 65535) return invalid();
  batched_matmul_kernel<<<grid, dim3(TILE, TILE), 0,
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
  return launch_contract(w, x, out, l, stream);
}

// w (6, 25) f32, x (25, bb, c) bf16, out (6, bb, c) f32; l = bb*c.
extern "C" int probe_mxu_conv_3d(const float* w, const void* x, float* out,
                                 long long l, void* stream) {
  return launch_contract(w, x, out, l, stream);
}

extern "C" int probe_vpu_conv(const float* w, const void* x, float* out,
                              long long l, void* stream) {
  const long long blocks = (l + CONV_THREADS - 1) / CONV_THREADS;
  if (l <= 0 || blocks > 0x7fffffffLL) return invalid();
  per_filter_conv_kernel<<<dim3(static_cast<unsigned>(blocks), FILTERS),
                           CONV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const __nv_bfloat16*>(x), out, l);
  return status();
}

// x (rows, 64) bf16, w (64, 128) bf16, out (rows, 64) f32.
extern "C" int probe_pair_dot(const void* x, const void* w, float* out, int rows,
                              void* stream) {
  return launch_pair_sum(x, w, out, rows, stream);
}

extern "C" int probe_two_dot(const void* x, const void* w, float* out, int rows,
                             void* stream) {
  return launch_pair_sum(x, w, out, rows, stream);
}
