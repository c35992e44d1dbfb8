// The warpgroup tile core of the port's tensor-core kernels, written for
// Hopper (sm_90a): TMA loads onto an mbarrier, shared-memory matrix
// descriptors for the 128-byte swizzle, bf16 wgmma with f32 accumulators,
// and the accumulator's fragment index map. csrc/mosaic_probe.cu's pair
// and two-dot kernels (B20, B21) use it, and the bf16 conv forward, input
// gradient and weight gradient on the tensor cores (csrc/wgmma_conv.cuh,
// with csrc/tap_conv.cu and csrc/tap_wgrad.cu).
//
// Shared-memory layout (the 128-byte swizzle, CU_TENSOR_MAP_SWIZZLE_128B).
// TMA writes a box whose inner extent is 128 bytes (64 bf16) as rows of
// 128 bytes, in atoms of 8 rows (1,024 bytes); inside an atom the 16-byte
// chunk c of row r lands at chunk c ^ (r % 8). The pattern is a function
// of the address bits, so every tile base here is 1,024-byte aligned and
// a descriptor's base-offset field stays 0. wgmma reads the same pattern
// when its descriptor says "128B swizzle" (layout type 1):
//
// - K-major operand (K contiguous, e.g. A = x with rows of 64 depth
//   values): an M x 64 tile is M rows of 128 bytes. SBO = 1,024 bytes
//   (from one 8-row atom to the next along M); LBO is unused (the depth
//   of one atom covers K = 64) and is set to 16 bytes, as CUTLASS does.
//   The k16 step s starts 32*s bytes into the tile: the hardware applies
//   the swizzle to the address it forms, so an in-atom start works. A
//   K-major B (the dgrad's w: N = 64 input channels as rows of 64 output
//   channels of depth) is the same tile with N for M, the same descriptor,
//   and wgmma's transpose-B flag 0.
// - MN-major operand (N contiguous, e.g. B = w stored [k][n]): a box of
//   64 columns x K rows is K rows of 128 bytes. SBO = 1,024 bytes (from one
//   8-row group of K to the next); LBO = the bytes from one 64-column atom
//   to the next along N (a B wider than 64 columns spans several boxes).
//   The k16 step s starts 16 rows = 2,048*s bytes into the box. wgmma's
//   transpose-B flag (tnspB = 1, allowed for 16-bit types) says B is
//   MN-major. (CUTLASS's make_gmma_desc assigns these two offsets the same
//   way: cute/atom/mma_traits_sm90_gmma.hpp.)
// - An MN-major A (M contiguous: the weight gradient's x box, pixels as K
//   rows of 64 channels) has the same layout and the same descriptor as
//   an MN-major B; wgmma's transpose-A flag (tnspA = 1, also allowed for
//   16-bit types with A from shared memory) says so.
//
// The accumulator fragment of wgmma .m64nNk16 with an f32 D (the PTX ISA's
// "WGMMA .m64nNk16 register fragment layout for accumulator matrix D"):
// thread t of the warpgroup holds N/2 floats d[i]; with warp = t / 32 and
// lane = t % 32,
//     row(i) = 16*warp + lane/4 + 8*((i/2) % 2)
//     col(i) = 8*(i/4) + 2*(lane % 4) + i % 2
// so d[4j..4j+3] lie in n8 tile j. Column c + N/2 of the same row is in
// tile j + N/16, i.e. register i + N/4 of the same thread: the two halves
// of an N = 128 accumulator pair up register by register (i and i + 32),
// and their sum has the m64n64 fragment layout.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace wgtile {

constexpr int M = 64;                 // rows of a warpgroup tile
constexpr int THREADS = 128;          // one warpgroup
constexpr int K_STEP = 16;            // depth of one bf16 wgmma
constexpr int ATOM_BYTES = 1024;      // 8 rows of 128 bytes
constexpr int ROW_BYTES = 128;        // a swizzled row: 64 bf16

// ---------------------------------------------------------------------------
// The fragment index map (see the header comment).
// ---------------------------------------------------------------------------

__device__ __forceinline__ int frag_row(int i, int t) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}

__device__ __forceinline__ int frag_col(int i, int t) {
  return 8 * (i / 4) + 2 * (t % 4) + i % 2;
}

// The register that holds column col(i) + N/2 of row(i) in an m64nN
// accumulator.
template <int N>
__host__ __device__ constexpr int upper_half(int i) {
  return i + N / 4;
}

// ---------------------------------------------------------------------------
// Shared memory, mbarriers, TMA.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1,024-byte aligned shared address at or after p's.
__device__ __forceinline__ uint32_t align_atom(const void* p) {
  return (smem_addr(p) + ATOM_BYTES - 1) & ~static_cast<uint32_t>(ATOM_BYTES - 1);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also tells the barrier to expect `bytes` from TMA.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase with parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// TMA: the box of `map` at (c0 inner, c1 outer) into shared memory at
// `dst`, completing `bar`'s expected bytes. Rows past the tensor's end
// arrive as zeros and still count towards the bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a 4-D map: the box at (c0 innermost, ..., c3 outermost).
// Coordinates are signed: a box that starts before 0 or runs past a
// dimension's end is filled with zeros there (FLOAT_OOB_FILL_NONE), and
// the zeros count towards the bytes. Emits
//   cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes
//       [dst], [map, {c0, c1, c2, c3}], [bar];
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// Descriptors and wgmma.
// ---------------------------------------------------------------------------

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, LBO and SBO in 16-byte units (14 bits each), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// k16 step s of a K-major tile of 128-byte rows based at `tile`.
__device__ __forceinline__ uint64_t k_major_desc(uint32_t tile, int s) {
  return sw128_desc(tile + 2 * K_STEP * s, 16, ATOM_BYTES);
}

// k16 step s of an MN-major operand whose 64-column boxes start at `box`
// and lie `atom_stride` bytes apart along N.
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t box, int s,
                                                  uint32_t atom_stride) {
  return sw128_desc(box + K_STEP * ROW_BYTES * s, atom_stride, ATOM_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed wgmma groups are
// still running (wgmma.wait_group.sync.aligned N).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmmas that own them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A . B + (scale_d ? d : 0) over one k16 step, m64n64, bf16 in, f32
// accumulate; A K-major (TRANS_A = 0, the default) or MN-major (TRANS_A =
// 1), B MN-major (TRANS_B = 1, the default) or K-major (TRANS_B = 0, the
// conv dgrad's w), both from shared memory. Emits
//   wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16
//       {d0..d31}, a-desc, b-desc, p, 1, 1, TRANS_A, TRANS_B;
// (scale-a 1, scale-b 1, tnspA, tnspB), p = scale_d != 0.
template <int TRANS_A = 0, int TRANS_B = 1>
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32], uint64_t a,
                                                     uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31},\n"
      " %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// The same at m64n128: 64 accumulators a thread. Emits
//   wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16
//       {d0..d63}, a-desc, b-desc, p, 1, 1, TRANS_A, 1;
template <int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t a,
                                                      uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, p, 1, 1, %67, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A));
}

// ---------------------------------------------------------------------------
// Host: tensor maps. cuTensorMapEncodeTiled is a driver function; it is
// reached through the runtime's cudaGetDriverEntryPoint, so a library
// built with nvcc alone (no -lcuda) can encode maps.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of a row-major (outer, inner) bf16 matrix whose rows lie
// `row_bytes` apart, read in boxes of (box_outer, 64) under the 128-byte
// swizzle, rows past `outer` filled with zeros. False if the driver
// refuses it (base not 16-byte aligned, row_bytes not a multiple of 16).
inline bool encode_bf16_sw128(CUtensorMap* map, const void* base, uint64_t inner,
                              uint64_t outer, uint64_t row_bytes, uint32_t box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {ROW_BYTES / 2, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D bf16 map (dims[0] innermost, contiguous; strides_bytes[i] the
// step of dims[i + 1]) read in boxes of box[0] = 64 values (128 bytes)
// by box[1] x box[2] x box[3] under the 128-byte swizzle, with zero fill
// out of bounds (coordinates are signed: tma_load_4d). `step` is the
// element stride of dims 1 and 2 (1, or 2 for a stride-2 conv): the box
// then spans step * box[i] elements of dims i = 1, 2 and lands only every
// step-th (cuTensorMapEncodeTiled's elementStrides; dim 0 takes none).
// False if the encode refuses the map (base not 16-byte aligned, a stride
// not a multiple of 16).
inline bool encode_bf16_sw128_4d(CUtensorMap* map, const void* base, const uint64_t dims[4],
                                 const uint64_t strides_bytes[3], const uint32_t box[4],
                                 uint32_t step) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || box[0] * 2 != ROW_BYTES) return false;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {strides_bytes[0], strides_bytes[1], strides_bytes[2]};
  const cuuint32_t b[4] = {box[0], box[1] * step, box[2] * step, box[3]};
  const cuuint32_t unit[4] = {1, step, step, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), d, st, b, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wgtile
