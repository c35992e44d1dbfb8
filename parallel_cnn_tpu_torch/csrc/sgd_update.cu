// Fused SGD update over one 1-D f32 gradient bucket, written for Hopper
// (sm_90a) and bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel `_sgd_kernel`
// (parallel_cnn_tpu/ops/pallas_update.py:54, launched by `fused_sgd` at
// pallas_update.py:105; `tree_sgd` runs one launch per bucket).
//
//   out[i] = p[i] - lr * (g[i] * scale)
//
// rounded after each of the three operations, as the plain PyTorch version
// (three separate elementwise ops) rounds them: __fmul_rn/__fsub_rn keep
// nvcc from contracting the expression into an FMA, so kernel and plain
// version agree bit for bit on the card. The LeNet trainer's ascent
// convention p += dt * mean(g) is lr = -dt, scale = 1/n.
//
// Design. Each thread updates four neighbouring elements, with one 16-byte
// load of p and of g and one 16-byte store when the three buffers are
// 16-byte aligned and all four elements are in range; the ragged tail and
// unaligned buffers take scalar loads.
//
// Bound on an H100 SXM: 12 bytes per element (read p and g, write out) at
// 3.35 TB/s, no arithmetic to speak of. LeNet's one bucket of 2,343
// values is 28.1 KB, 8 ns at that rate, so a launch's latency sets its
// time; at 2^20 elements the bound is 3.8 us.
//
// The kernel launches on the caller's stream, synchronises nothing and
// allocates nothing: the Python wrapper allocates `out` and checks devices,
// dtypes, shapes and contiguity first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float sgd(float p, float g, float lr, float scale) {
  return __fsub_rn(p, __fmul_rn(lr, __fmul_rn(g, scale)));
}

__global__ void __launch_bounds__(THREADS)
sgd_kernel(const float* __restrict__ p, const float* __restrict__ g,
           float* __restrict__ out, long long n, float lr, float scale,
           int vec) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * 4;
  if (i0 >= n) return;
  if (vec && i0 + 3 < n) {
    const float4 pv = *reinterpret_cast<const float4*>(p + i0);
    const float4 gv = *reinterpret_cast<const float4*>(g + i0);
    float4 o;
    o.x = sgd(pv.x, gv.x, lr, scale);
    o.y = sgd(pv.y, gv.y, lr, scale);
    o.z = sgd(pv.z, gv.z, lr, scale);
    o.w = sgd(pv.w, gv.w, lr, scale);
    *reinterpret_cast<float4*>(out + i0) = o;
  } else {
    for (long long i = i0; i < n && i < i0 + 4; ++i) {
      out[i] = sgd(p[i], g[i], lr, scale);
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// Plain C entry point for ctypes. `p`, `g` and `out` are device pointers to
// n f32 values. Returns 0 on a launch that was accepted, else the
// cudaError_t.
extern "C" int sgd_update(const float* p, const float* g, float* out,
                          long long n, float lr, float scale, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = (n + 3) / 4;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned16(p) && aligned16(g) && aligned16(out);
  sgd_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(p, g, out, n, lr, scale,
                                                    vec);
  return static_cast<int>(cudaGetLastError());
}
