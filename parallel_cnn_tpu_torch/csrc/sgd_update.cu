// Fused SGD updates over one 1-D f32 gradient bucket, written for Hopper
// (sm_90a) and bound to Python through ctypes. Two kernels:
//
// sgd_kernel replaces the Pallas TPU kernel `_sgd_kernel`
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
// sgd_momentum_kernel replaces the Pallas TPU kernel `_sgd_momentum_kernel`
// (pallas_update.py:58, launched by `fused_sgd_momentum` at :134): the
// update-on-arrival step's per-bucket-shard update, out of place.
//
//   m_out[i] = momentum * m[i] + g[i] * scale
//   p_out[i] = p[i] - lr * m_out[i]
//
// each of the five operations rounded on its own, as the plain version's
// five elementwise ops are. `scale` is read from device memory (one f32):
// the step computes it on the device (1 / (loss scale * accum * world)) and
// never syncs the host for it, as JAX passes it traced (pallas_update.py:91).
// Bound on an H100 SXM: 20 bytes per element (read p, m, g; write p', m'),
// 5 flops; ResNet-18's 11,173,962 params are 223.5 MB a step, ~67 us at
// 3.35 TB/s. Design: the same four-elements-a-thread float4 pass as
// sgd_kernel, three 16-byte loads and two 16-byte stores per thread.
//
// The kernels launch on the caller's stream, synchronise nothing and
// allocate nothing: the Python wrapper allocates the outputs and checks
// devices, dtypes, shapes and contiguity first. In the data-parallel step
// the caller has already waited on the ring's transfers, which orders its
// current stream behind NCCL's.

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

struct PM {
  float p, m;
};

__device__ __forceinline__ PM sgd_momentum(float p, float m, float g, float lr,
                                           float momentum, float scale) {
  const float m2 = __fadd_rn(__fmul_rn(momentum, m), __fmul_rn(g, scale));
  return {__fsub_rn(p, __fmul_rn(lr, m2)), m2};
}

__global__ void __launch_bounds__(THREADS)
sgd_momentum_kernel(const float* __restrict__ p, const float* __restrict__ m,
                    const float* __restrict__ g,
                    const float* __restrict__ scale_ptr,
                    float* __restrict__ p_out, float* __restrict__ m_out,
                    long long n, float lr, float momentum, int vec) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * 4;
  if (i0 >= n) return;
  const float scale = __ldg(scale_ptr);
  if (vec && i0 + 3 < n) {
    const float4 pv = *reinterpret_cast<const float4*>(p + i0);
    const float4 mv = *reinterpret_cast<const float4*>(m + i0);
    const float4 gv = *reinterpret_cast<const float4*>(g + i0);
    const PM x = sgd_momentum(pv.x, mv.x, gv.x, lr, momentum, scale);
    const PM y = sgd_momentum(pv.y, mv.y, gv.y, lr, momentum, scale);
    const PM z = sgd_momentum(pv.z, mv.z, gv.z, lr, momentum, scale);
    const PM w = sgd_momentum(pv.w, mv.w, gv.w, lr, momentum, scale);
    *reinterpret_cast<float4*>(p_out + i0) = make_float4(x.p, y.p, z.p, w.p);
    *reinterpret_cast<float4*>(m_out + i0) = make_float4(x.m, y.m, z.m, w.m);
  } else {
    for (long long i = i0; i < n && i < i0 + 4; ++i) {
      const PM r = sgd_momentum(p[i], m[i], g[i], lr, momentum, scale);
      p_out[i] = r.p;
      m_out[i] = r.m;
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

// Plain C entry point for ctypes. `p`, `m`, `g`, `p_out` and `m_out` are
// device pointers to n f32 values, `scale` a device pointer to one f32.
// Returns 0 on a launch that was accepted, else the cudaError_t.
extern "C" int sgd_momentum_update(const float* p, const float* m,
                                   const float* g, const float* scale,
                                   float* p_out, float* m_out, long long n,
                                   float lr, float momentum, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = (n + 3) / 4;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned16(p) && aligned16(m) && aligned16(g) &&
                  aligned16(p_out) && aligned16(m_out);
  sgd_momentum_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      p, m, g, scale, p_out, m_out, n, lr, momentum, vec);
  return static_cast<int>(cudaGetLastError());
}
