// What the bf16 conv forward and input gradient (csrc/tap_conv.cu
// `tap_conv_wgmma_kernel`, `tap_dgrad_wgmma_kernel`) and the bf16 weight
// gradient (csrc/tap_wgrad.cu `wgrad_wgmma_kernel`) share on the tensor
// cores, on top of csrc/wgmma_tile.cuh: the pixel rectangle a block's 64
// rows cover, and the TMA maps of the NHWC activations. (The dgrad's
// rectangles cover the pixels of one stride phase of dx, and its A is g
// read through the same map at element stride 1.)
//
// The rectangle. 64 output pixels of one block (the M rows of the
// forward's tile, the K depth of one wgrad step) are bn images x bh rows x
// bw columns, with bn * bh * bw = 64, chosen by the wrapper from (OH, OW)
// alone (ops/tap_conv.py `conv_rect`: 1 x 2 x 32 at 32x32, 1 x 4 x 16 at
// 16x16, 1 x 8 x 8 at 8x8, 4 x 4 x 4 at 4x4, 16 x 2 x 2 at 2x2). The
// rectangles tile (N, OH, OW) in the order (image group, row group, column
// group); those at the edges reach past N, OH or OW, where TMA fills the
// loads with zeros and the stores are masked.
//
// The maps. An NHWC activation is a 4-D map (C, W, H, N), C innermost,
// read in boxes of 64 channels x the rectangle: TMA lands a box as 64 rows
// of 128 bytes (one pixel's 64 channels a row, pixel p = (i * bh + r) * bw
// + c), the 128-byte-swizzled tile that wgmma reads K-major (the forward's
// A: pixels are rows, channels depth) or MN-major (the wgrad's A and B:
// pixels are depth). The input x of a conv with stride s is read at
// tap (dy, dx) from the box origin (c0, ox0*s + dx - pad_left,
// oy0*s + dy - pad_top, n0): coordinates below 0 or past W and H arrive as
// zeros, which is XLA's SAME padding with no padded copy of x. Stride 2
// reads every other column and row through the map's element strides
// (elementStrides = (1, 2, 2, 1), the box spanning 2*bw x 2*bh elements of
// which TMA lands every second): one map and one encode for both strides,
// with the stride-1 coordinates scaled by s. (The other route, four
// parity-phase views of x with doubled W and H strides, needs four maps
// and four encodes a launch for the same boxes.)

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

#include "wgmma_tile.cuh"

namespace wgconv {

constexpr int CH = 64;                              // channels a box holds
constexpr int BOX_BYTES = wgtile::M * CH * 2;       // 8 KB: 64 rows of 128 bytes
constexpr int K16_STEPS = CH / wgtile::K_STEP;      // 4 wgmmas a 64-deep box

// bn images x bh rows x bw columns of output pixels, and how many
// rectangles tile OH and OW.
struct Rect {
  int bn, bh, bw, tiles_h, tiles_w;

  // The origin (image, row, column) of rectangle r.
  __device__ __forceinline__ void origin(int r, int& n0, int& oy0, int& ox0) const {
    const int tw = r % tiles_w;
    r /= tiles_w;
    const int th = r % tiles_h;
    n0 = (r / tiles_h) * bn;
    oy0 = th * bh;
    ox0 = tw * bw;
  }

  // Pixel p of a rectangle as (image, row, column) offsets from its origin.
  __device__ __forceinline__ void pixel(int p, int& di, int& dy, int& dx) const {
    dx = p % bw;
    p /= bw;
    dy = p % bh;
    di = p / bh;
  }
};

// True for a rectangle of 64 pixels whose box TMA takes (each side at most
// 128 elements, 256 with stride 2).
inline bool rect_ok(int bn, int bh, int bw) {
  return bn > 0 && bh > 0 && bw > 0 && bn * bh * bw == wgtile::M && bw <= 128 && bh <= 128 &&
         bn <= 256;
}

// x (N, H, W, C) bf16 as a 4-D map, boxes of 64 channels x the rectangle,
// read with element stride `stride` along W and H.
inline bool encode_activation(CUtensorMap* map, const void* x, int n, int h, int w, int c,
                              int bn, int bh, int bw, int stride) {
  const uint64_t dims[4] = {static_cast<uint64_t>(c), static_cast<uint64_t>(w),
                            static_cast<uint64_t>(h), static_cast<uint64_t>(n)};
  const uint64_t row = static_cast<uint64_t>(c) * 2;
  const uint64_t strides[3] = {row, row * w, row * w * h};
  const uint32_t box[4] = {CH, static_cast<uint32_t>(bw), static_cast<uint32_t>(bh),
                           static_cast<uint32_t>(bn)};
  return wgtile::encode_bf16_sw128_4d(map, x, dims, strides, box,
                                      static_cast<uint32_t>(stride));
}

}  // namespace wgconv
