// Fused SGD updates over 1-D f32 gradient buckets, written for Hopper
// (sm_90a) and bound to Python through ctypes. Two kernels:
//
// sgd_leaves_kernel replaces the Pallas TPU kernel `_sgd_kernel`
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
// Design. JAX's `tree_sgd` packs the params and the grads into a bucket
// (two concatenations in XLA) before each launch. Here one launch reads a
// bucket's leaves where they lie and writes the packed bucket: the C entry
// takes a list of up to MAX_LEAVES leaves, (p, g, length) each, passed by
// value in the kernel's parameters with their prefix offsets into the
// output (the wrapper cuts a longer list into launches of MAX_LEAVES, in
// order, each writing its span of the bucket). So a step's update is one
// device op where it was three. Every leaf gets whole blocks (the prefix
// sum of blocks per leaf; a block finds its leaf in at most MAX_LEAVES
// compares), a thread SGD_UNITS accesses of p and of g, all loaded before
// its first store. An access is the widest (float4, float2, a float) that
// the leaf's p, g and its span of the output all allow: after a step
// LeNet's param leaves are views of the last bucket at element offsets 0,
// 6, 156, 166, 2,326 and 2,327, so most lie off the 16-byte boundary.
// `fused_sgd` on one bucket is the list of one.
//
// Bound on an H100 SXM: 12 bytes per element (read p and g, write out) at
// 3.35 TB/s, no arithmetic to speak of. LeNet's one bucket of 2,343
// values is 28.1 KB, 8 ns at that rate, so a launch's latency sets its
// time; at 2^20 elements the bound is 3.8 us.
//
// sgd_momentum_kernel replaces the Pallas TPU kernel `_sgd_momentum_kernel`
// (pallas_update.py:58, launched by `fused_sgd_momentum` at :134, once per
// bucket): the update-on-arrival step's update of its bucket shards, out
// of place.
//
//   m_out[i] = momentum * m[i] + g[i] * scale
//   p_out[i] = p[i] - lr * m_out[i]
//
// each of the five operations rounded on its own, as the plain version's
// five elementwise ops are. `scale` is read from device memory (one f32):
// the step computes it on the device (1 / (loss scale * accum * world)) and
// never syncs the host for it, as JAX passes it traced (pallas_update.py:91).
//
// Bound on an H100 SXM: 20 bytes per element (read p, m, g; write p', m'),
// 5 flops; ResNet-18's 11,173,962 params are 223.5 MB a step, 66.7 us at
// 3.35 TB/s. One launch per bucket shard, as JAX launches, cost 101.0 us
// for ResNet-18's 12 buckets on an H100 80GB HBM3 at 700 W: each launch
// of ~0.93 M values is under one wave of blocks and ramps up and drains on
// its own. So one launch takes a list of up to MAX_ENTRIES shards, passed
// by value in the kernel's parameters (a longer list is cut into launches
// of MAX_ENTRIES, in order). The grid is one wave of resident blocks over
// all entries: every block of an entry holds the same count of float4
// quads (a multiple of THREADS * UNROLL, sized from the list's total), and
// finds its entry from the prefix sum of blocks per entry. A thread loads
// UNROLL float4s of each of p, m and g, all before its first store, with
// streaming hints (the step's bytes pass through the 50 MB L2 once). An
// entry whose five buffers are 16-byte aligned takes float4s, its ragged
// tail and unaligned entries take scalars, entry by entry.
//
// The kernels launch on the caller's stream, synchronise nothing and
// allocate nothing: the Python wrapper allocates the outputs and checks
// devices, dtypes, shapes and contiguity first. In the data-parallel step
// the caller has already waited on the ring's transfers, which orders its
// current stream behind NCCL's.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float sgd(float p, float g, float lr, float scale) {
  return __fsub_rn(p, __fmul_rn(lr, __fmul_rn(g, scale)));
}

// One access a thread in blocks of 128, from 9 partitions timed on an H100
// (benches/lenet_sweep.py sgd_update; PERF.md) at LeNet's 6 leaves: 2 and
// 4 accesses a thread were slower there, faster only at 2^20 values, off
// the main path. A per-element leaf lookup was slower at both sizes; 8 or
// 32 leaves a launch were level with 16.
constexpr int MAX_LEAVES = 16;    // bucket leaves one sgd_update_leaves launch takes
constexpr int SGD_THREADS = 128;  // threads a block
constexpr int SGD_UNITS = 1;      // accesses of p and of g a thread keeps in flight
constexpr int SGD_SPAN = SGD_THREADS * SGD_UNITS;

// A launch's span of the bucket holds at most MAX_SPAN elements (the
// entry refuses more), so offsets, lengths and access indices are 32-bit:
// fewer bytes of parameters a launch.
constexpr long long MAX_SPAN = 1LL << 30;
struct SgdLeaf {
  const float* p;
  const float* g;
  int off;    // the leaf's first element in the output span
  int n;
  int width;  // floats an access: 4, 2 or 1
};

// The kernel's parameters: ~0.6 KB, well under the 4 KB limit.
struct SgdLeafList {
  SgdLeaf e[MAX_LEAVES];
  int first_block[MAX_LEAVES + 1];  // prefix sum of blocks per leaf
  int count;
};

// W floats of a (1, 2 or 4) as one access; a must lie on a 4W-byte boundary.
template <int W>
__device__ __forceinline__ void load_w(float (&v)[W], const float* __restrict__ a) {
  if constexpr (W == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(a));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (W == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(a));
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = __ldg(a);
  }
}

template <int W>
__device__ __forceinline__ void store_w(float* __restrict__ a, const float (&v)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(a) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(a) = make_float2(v[0], v[1]);
  } else {
    a[0] = v[0];
  }
}

// Thread `unit0` of a leaf's block: accesses unit0 + k * SGD_THREADS,
// k < SGD_UNITS, access u covering the leaf's elements W*u .. W*u + W-1
// (the leaf's last access may be ragged: one float at a time).
template <int W>
__device__ __forceinline__ void update_leaf(const SgdLeaf& x, float* __restrict__ out,
                                            int unit0, float lr, float scale) {
  const int n = x.n;
  float pv[SGD_UNITS][W] = {}, gv[SGD_UNITS][W] = {};
#pragma unroll
  for (int k = 0; k < SGD_UNITS; ++k) {
    const int i = W * (unit0 + k * SGD_THREADS);
    if (i + W <= n) {
      load_w<W>(pv[k], x.p + i);
      load_w<W>(gv[k], x.g + i);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (i + j < n) pv[k][j] = __ldg(x.p + i + j), gv[k][j] = __ldg(x.g + i + j);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < SGD_UNITS; ++k) {
    const int i = W * (unit0 + k * SGD_THREADS);
    float o[W];
#pragma unroll
    for (int j = 0; j < W; ++j) o[j] = sgd(pv[k][j], gv[k][j], lr, scale);
    if (i + W <= n) {
      store_w<W>(out + x.off + i, o);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (i + j < n) out[x.off + i + j] = o[j];
      }
    }
  }
}

// Block b updates SGD_SPAN accesses of leaf e, the last leaf whose first
// block is at most b.
__global__ void __launch_bounds__(SGD_THREADS)
sgd_leaves_kernel(const __grid_constant__ SgdLeafList list, float* __restrict__ out,
                  float lr, float scale) {
  const int blk = static_cast<int>(blockIdx.x);
  int e = list.count - 1;
  while (e > 0 && blk < list.first_block[e]) --e;
  const SgdLeaf& x = list.e[e];
  const int unit0 = (blk - list.first_block[e]) * SGD_SPAN + static_cast<int>(threadIdx.x);
  if (x.width == 4) {
    update_leaf<4>(x, out, unit0, lr, scale);
  } else if (x.width == 2) {
    update_leaf<2>(x, out, unit0, lr, scale);
  } else {
    update_leaf<1>(x, out, unit0, lr, scale);
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

constexpr int MAX_ENTRIES = 32;  // bucket shards one launch takes
// UNROLL: float4s of each input a thread keeps in flight (2 and 8 timed
// within -1% and +2% of 4 on an H100, inside run-to-run spread).
constexpr int UNROLL = 4;

struct MomentumEntry {
  const float* p;
  const float* m;
  const float* g;
  float* p_out;
  float* m_out;
  long long n;
  int vec;  // all five buffers 16-byte aligned
};

// The kernel's parameters: ~1.9 KB, well under the 4 KB limit.
struct MomentumList {
  MomentumEntry e[MAX_ENTRIES];
  int first_block[MAX_ENTRIES + 1];  // prefix sum of blocks per entry
  long long quads_per_block;
  int count;
};

// Values i..i+3 of a (those below n), as one streaming float4 load where
// the entry is aligned and all four lie below n.
__device__ __forceinline__ float4 load4(const float* a, long long i, long long n,
                                        bool vec) {
  if (vec && i + 4 <= n) return __ldcs(reinterpret_cast<const float4*>(a + i));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < n) v.x = __ldcs(a + i);
  if (i + 1 < n) v.y = __ldcs(a + i + 1);
  if (i + 2 < n) v.z = __ldcs(a + i + 2);
  if (i + 3 < n) v.w = __ldcs(a + i + 3);
  return v;
}

__device__ __forceinline__ void store4(float* a, long long i, long long n, bool vec,
                                       float4 v) {
  if (vec && i + 4 <= n) {
    __stcs(reinterpret_cast<float4*>(a + i), v);
    return;
  }
  if (i < n) __stcs(a + i, v.x);
  if (i + 1 < n) __stcs(a + i + 1, v.y);
  if (i + 2 < n) __stcs(a + i + 2, v.z);
  if (i + 3 < n) __stcs(a + i + 3, v.w);
}

__global__ void __launch_bounds__(THREADS)
sgd_momentum_kernel(const __grid_constant__ MomentumList list,
                    const float* __restrict__ scale_ptr, float lr, float momentum) {
  const int blk = static_cast<int>(blockIdx.x);
  int e = 0;
  while (e + 1 < list.count && blk >= list.first_block[e + 1]) ++e;
  const MomentumEntry& x = list.e[e];
  const long long n = x.n;
  const bool vec = x.vec != 0;
  const long long quads = (n + 3) >> 2;
  const long long q0 =
      static_cast<long long>(blk - list.first_block[e]) * list.quads_per_block;
  const long long q1 = min(q0 + list.quads_per_block, quads);
  const float scale = __ldg(scale_ptr);
  for (long long base = q0 + threadIdx.x; base < q1;
       base += static_cast<long long>(THREADS) * UNROLL) {
    float4 pv[UNROLL], mv[UNROLL], gv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = 4 * (base + static_cast<long long>(u) * THREADS);
      if (i < 4 * q1) {
        pv[u] = load4(x.p, i, n, vec);
        mv[u] = load4(x.m, i, n, vec);
        gv[u] = load4(x.g, i, n, vec);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = 4 * (base + static_cast<long long>(u) * THREADS);
      if (i < 4 * q1) {
        const PM a = sgd_momentum(pv[u].x, mv[u].x, gv[u].x, lr, momentum, scale);
        const PM b = sgd_momentum(pv[u].y, mv[u].y, gv[u].y, lr, momentum, scale);
        const PM c = sgd_momentum(pv[u].z, mv[u].z, gv[u].z, lr, momentum, scale);
        const PM d = sgd_momentum(pv[u].w, mv[u].w, gv[u].w, lr, momentum, scale);
        store4(x.p_out, i, n, vec, make_float4(a.p, b.p, c.p, d.p));
        store4(x.m_out, i, n, vec, make_float4(a.m, b.m, c.m, d.m));
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15u) == 0;
}

// The widest access (floats) that all three buffers allow.
int access_width(const void* a, const void* b, const void* c) {
  const std::uintptr_t bits = reinterpret_cast<std::uintptr_t>(a) |
                              reinterpret_cast<std::uintptr_t>(b) |
                              reinterpret_cast<std::uintptr_t>(c);
  return (bits & 15u) == 0 ? 4 : (bits & 7u) == 0 ? 2 : 1;
}

// The blocks of sgd_momentum_kernel the card holds at once (SMs x blocks
// per SM at its registers), per device, or 0 with the error in *err.
int resident_blocks(cudaError_t* err) {
  static std::atomic<int> cached[64];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < 64 && cached[dev].load() > 0) return cached[dev].load();
  int sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sgd_momentum_kernel,
                                                         THREADS, 0);
  if (*err != cudaSuccess) return 0;
  if (dev < 64) cached[dev].store(sms * per_sm);
  return sms * per_sm;
}

}  // namespace

// The most leaves one sgd_update_leaves launch takes: the wrapper checks
// its own MAX_LEAVES against it when it loads the library.
extern "C" int sgd_update_max_leaves() { return MAX_LEAVES; }

// Plain C entry point for ctypes: one launch over `count` leaves, 1 <=
// count <= MAX_LEAVES. `ptrs` holds two device pointers per leaf (p, g),
// `lens` its length (>= 1); the leaves are packed in order into `out`, a
// device pointer to the sum of the lengths (at most 2^30) in f32, on any
// 4-byte boundary. Returns 0 on a launch that was accepted, else the
// cudaError_t (cudaErrorInvalidValue for a count or length it refuses, or
// a null out).
extern "C" int sgd_update_leaves(void* const* ptrs, const long long* lens, int count,
                                 float* out, float lr, float scale, void* stream) {
  if (count <= 0 || count > MAX_LEAVES || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  SgdLeafList list{};
  long long off = 0, blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (lens[i] <= 0 || off + lens[i] > MAX_SPAN) return static_cast<int>(cudaErrorInvalidValue);
    SgdLeaf& x = list.e[i];
    x.p = static_cast<const float*>(ptrs[2 * i]);
    x.g = static_cast<const float*>(ptrs[2 * i + 1]);
    x.off = static_cast<int>(off);
    x.n = static_cast<int>(lens[i]);
    x.width = access_width(x.p, x.g, out + off);
    list.first_block[i] = static_cast<int>(blocks);
    blocks += ((x.n + x.width - 1) / x.width + SGD_SPAN - 1) / SGD_SPAN;
    off += x.n;
  }
  list.first_block[count] = static_cast<int>(blocks);
  list.count = count;
  sgd_leaves_kernel<<<static_cast<int>(blocks), SGD_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(list, out, lr, scale);
  return static_cast<int>(cudaGetLastError());
}

// The most bucket shards one sgd_momentum_update launch takes: the wrapper
// checks its own MAX_ENTRIES against it when it loads the library.
extern "C" int sgd_momentum_max_entries() { return MAX_ENTRIES; }

// Plain C entry point for ctypes: one launch over `count` bucket shards,
// 1 <= count <= MAX_ENTRIES. `ptrs` holds five device pointers per shard
// (p, m, g, p_out, m_out), `lens` its length (>= 1); `scale` is a device
// pointer to one f32. Returns 0 on a launch that was accepted, else the
// cudaError_t (cudaErrorInvalidValue for a count or length it refuses).
extern "C" int sgd_momentum_update(void* const* ptrs, const long long* lens, int count,
                                   const float* scale, float lr, float momentum,
                                   void* stream) {
  if (count <= 0 || count > MAX_ENTRIES) return static_cast<int>(cudaErrorInvalidValue);
  MomentumList list{};
  long long total = 0;  // float4 quads over all entries
  for (int i = 0; i < count; ++i) {
    if (lens[i] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    MomentumEntry& x = list.e[i];
    x.p = static_cast<const float*>(ptrs[5 * i]);
    x.m = static_cast<const float*>(ptrs[5 * i + 1]);
    x.g = static_cast<const float*>(ptrs[5 * i + 2]);
    x.p_out = static_cast<float*>(ptrs[5 * i + 3]);
    x.m_out = static_cast<float*>(ptrs[5 * i + 4]);
    x.n = lens[i];
    x.vec = aligned16(x.p) && aligned16(x.m) && aligned16(x.g) && aligned16(x.p_out) &&
            aligned16(x.m_out);
    total += (lens[i] + 3) / 4;
  }
  cudaError_t err;
  const int resident = resident_blocks(&err);
  if (resident <= count) return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  // Each entry's blocks round up to whole blocks: sized over resident -
  // count blocks, all entries together fit in one wave.
  constexpr long long STEP = static_cast<long long>(THREADS) * UNROLL;
  const long long per = (total + resident - count - 1) / (resident - count);
  list.quads_per_block = (per + STEP - 1) / STEP * STEP;
  int blocks = 0;
  for (int i = 0; i < count; ++i) {
    list.first_block[i] = blocks;
    blocks += static_cast<int>(((lens[i] + 3) / 4 + list.quads_per_block - 1) /
                               list.quads_per_block);
  }
  list.first_block[count] = blocks;
  list.count = count;
  sgd_momentum_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      list, scale, lr, momentum);
  return static_cast<int>(cudaGetLastError());
}
