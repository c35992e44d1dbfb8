// The f32 register-tile core shared by the conv's kernels (csrc/tap_wgrad.cu,
// and the forward and dgrad kernels of csrc/tap_conv.cu), written for
// Hopper (sm_90a).
//
// A block computes a BM x BN tile of C = A . B on the f32 CUDA cores, as
// an implicit GEMM whose depth runs in stages of BK. Each thread keeps a
// TM x TN accumulator tile: per depth step it reads TM A values and TN B
// values from shared memory for TM*TN fmas, 0.25 floats a fma at 8x8 and
// 0.375 at 8x4 (the first 4x4 kernels needed 0.5, which capped them near
// half the SM's fma rate). Operand slabs live in a ring of STAGES slots
// of dynamic shared memory, filled ahead of use by 16-byte (or, for
// narrow or unaligned operands, 4-byte) `cp.async` copies whose source
// size is 0 where the element lies in the padding or past the end, which
// zero-fills it; one barrier a stage.
//
// Warps tile the block as (BM/(4*TM)) x (BN/(8*TN)); inside a warp the
// lanes form 4 rows x 8 columns. B is always stored [kk][n] (a slab row is
// one depth step); a thread's columns are float4 runs 32 apart, so 8 lanes
// read 128 contiguous bytes. A is stored either
//   - [kk][m] (A_KMAJOR, wgrad: a depth step is a pixel, its row a run of
//     channels), a thread's rows float4 runs 16 apart; or
//   - [m][kk] (forward and dgrad: the depth is (tap, ci) contiguous in x,
//     or (tap, co) contiguous in g), a row
//     padded to BK+4 floats; a thread reads float4 along kk for rows
//     lane/8 + 4i, which land on distinct banks.
// Every accumulator sums its depth terms in ascending depth order, one
// fmaf each: the tile shape and the ring never change a result.
//
// bf16 operands (the bf16 forms of the three conv kernels). A bf16 value
// widens to f32 exactly (its 16 bits are the f32's high half), so a bf16
// kernel's slabs in shared memory hold f32 and it runs compute_stage as
// the f32 form does: the product of two bf16 values is exact in f32 and
// every sum is f32, the TPU's preferred_element_type=f32 contract, in the
// f32 form's order. cp.async moves bytes and cannot widen, so a bf16 slab
// goes through registers: `fetch_bf16` loads VEC values (8 bytes for 4,
// 2 for 1) before the stage's products, `deposit_bf16` widens them and
// stores them after, into the slot the stage's barrier freed. Results are
// rounded once, at the store (`store4`, `store1`: __float2bfloat16_rn).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace ftile {

constexpr int STAGES = 3;   // slots of the cp.async ring

// A block tile: BM x BN outputs, TM x TN of them a thread, BK depth steps
// a stage, and the blocks per SM its launch bounds ask registers for.
template <int BM_, int BN_, int TM_, int TN_, int BK_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int TM = TM_;
  static constexpr int TN = TN_;
  static constexpr int BK = BK_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WARPS_M = BM_ / (4 * TM_);
  static constexpr int WARPS_N = BN_ / (8 * TN_);
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int B_LD = BN_ + 4;
};

template <class T, bool A_KMAJOR>
struct Layout {
  static constexpr int A_LD = A_KMAJOR ? T::BM + 4 : T::BK + 4;
  static constexpr int A_FLOATS = A_KMAJOR ? T::BK * A_LD : T::BM * A_LD;
  static constexpr int B_FLOATS = T::BK * T::B_LD;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled when !pred (src is then not
// read, but must still be a valid address: callers pass the tensor base).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One level of warp_sum32: the lanes whose bit OFF is set keep values
// [OFF, 2*OFF) and send [0, OFF) to lane ^ OFF; the others the reverse.
// OFF is a template argument so that every index is a constant and v stays
// in registers (with a loop over the levels, ptxas put v on the stack).
template <int OFF>
__device__ __forceinline__ void warp_sum_level(float (&v)[32], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Sums v[k] over the warp's 32 lanes, for every k < 32; lane k returns the
// sum of value k. Each level halves the values a lane carries and adds
// what it receives to what it kept (kept + received). 31 shuffles, where a
// butterfly over all 32 values takes 160; each sum pairs the lanes as the
// xor butterfly does (16, 8, 4, 2, 1), and f32 addition commutes, so value
// k's sum is bit for bit the butterfly's. The LeNet kernels' fixed warp
// trees (csrc/lenet_fused.cu, B9 in csrc/lenet_staged.cu).
__device__ __forceinline__ float warp_sum32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  warp_sum_level<16>(v, lane);
  warp_sum_level<8>(v, lane);
  warp_sum_level<4>(v, lane);
  warp_sum_level<2>(v, lane);
  warp_sum_level<1>(v, lane);
  return v[0];
}

// Row (within the block tile) of a thread's i-th accumulator row.
template <class T, bool A_KMAJOR>
__device__ __forceinline__ int row_of(int warp_m, int lane, int i) {
  return A_KMAJOR ? warp_m * 4 * T::TM + (lane >> 3) * 4 + (i & 3) + 16 * (i >> 2)
                  : warp_m * 4 * T::TM + (lane >> 3) + 4 * i;
}

// Column (within the block tile) of a thread's j-th accumulator column.
template <class T>
__device__ __forceinline__ int col_of(int warp_n, int lane, int j) {
  return warp_n * 8 * T::TN + (lane & 7) * 4 + (j & 3) + 32 * (j >> 2);
}

template <class T>
__device__ __forceinline__ void load_b(const float* Bs, int kk, int warp_n, int lane,
                                       float (&b)[T::TN]) {
  const float* p = Bs + kk * T::B_LD + warp_n * 8 * T::TN + (lane & 7) * 4;
#pragma unroll
  for (int h = 0; h < T::TN / 4; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(p + 32 * h);
    b[4 * h] = v.x;
    b[4 * h + 1] = v.y;
    b[4 * h + 2] = v.z;
    b[4 * h + 3] = v.w;
  }
}

// acc += A_slab . B_slab over one stage (T::BK depth steps, ascending).
template <class T, bool A_KMAJOR>
__device__ __forceinline__ void compute_stage(const float* As, const float* Bs,
                                              int warp_m, int warp_n, int lane,
                                              float (&acc)[T::TM][T::TN]) {
  using L = Layout<T, A_KMAJOR>;
  if constexpr (A_KMAJOR) {
#pragma unroll
    for (int kk = 0; kk < T::BK; ++kk) {
      float a[T::TM], b[T::TN];
      const float* pa = As + kk * L::A_LD + warp_m * 4 * T::TM + (lane >> 3) * 4;
#pragma unroll
      for (int h = 0; h < T::TM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(pa + 16 * h);
        a[4 * h] = v.x;
        a[4 * h + 1] = v.y;
        a[4 * h + 2] = v.z;
        a[4 * h + 3] = v.w;
      }
      load_b<T>(Bs, kk, warp_n, lane, b);
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  } else {
    const float* pa = As + (warp_m * 4 * T::TM + (lane >> 3)) * L::A_LD;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 4) {
      float4 a[T::TM];
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(pa + 4 * i * L::A_LD + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[T::TN];
        load_b<T>(Bs, kk + q, warp_n, lane, b);
#pragma unroll
        for (int i = 0; i < T::TM; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
}

// VEC bf16 values held in registers between fetch_bf16 and deposit_bf16:
// 4 as a uint2, 1 in the low half of an unsigned.
template <int VEC>
using Bf16Pack = typename std::conditional<VEC == 4, uint2, unsigned>::type;

template <class E>
constexpr bool is_bf16 = std::is_same<E, __nv_bfloat16>::value;

// VEC bf16 values from global memory (8-byte aligned for 4), or zeros
// when !ok (src is then not read).
template <int VEC>
__device__ __forceinline__ Bf16Pack<VEC> fetch_bf16(const __nv_bfloat16* src, bool ok) {
  if constexpr (VEC == 4) {
    return ok ? __ldg(reinterpret_cast<const uint2*>(src)) : make_uint2(0u, 0u);
  } else {
    return ok ? static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(src)))
              : 0u;
  }
}

// The bf16 in the low (first) or high (second) half of a 32-bit word, as
// the f32 it is exactly.
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// Widen VEC fetched values into f32 shared memory (16-byte aligned for 4).
template <int VEC>
__device__ __forceinline__ void deposit_bf16(float* dst, Bf16Pack<VEC> v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
  } else {
    *dst = bf16_lo(v);
  }
}

__device__ __forceinline__ unsigned bf16_bits(float f) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

// Four f32 results stored as a run of 4 (16-byte aligned for f32, 8 for
// bf16), and one result alone; bf16 rounds to nearest even, once.
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_bits(a) | (bf16_bits(b) << 16), bf16_bits(c) | (bf16_bits(d) << 16));
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

// Raise a kernel's dynamic shared-memory limit to what it needs (above the
// 48 KB default), once per kernel; returns the error of the call.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace ftile
