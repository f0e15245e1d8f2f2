// The sampling geometry of the DCNv2 kernels (dcn_fwd.cu, dcn_bwd.cu,
// dcn_narrow.cu): where a (pixel, deformable group, tap) samples the input,
// with its four bilinear corners, their weights and validity, the mask, and
// the gates of the offset gradient.  The gathers below (GroupCorners) are
// those of dcn_fwd.cu and dcn_bwd.cu, whose widths are template parameters:
// C input channels a pixel, of which a thread reads N contiguous ones at a
// corner, N a whole number of 16-byte vectors (a group of 8 channels at
// C = 64 in 8 groups: 16 bytes of bf16 or 32 of f32; a group of 16 at C =
// 128 in 8 groups: 32 or 64 bytes).  dcn_narrow.cu (any C <= 64) gathers
// its own.
//
// Offsets and mask are read through a pixel stride and a channel base, so
// one code reads either layout the wrappers pass:
//   * separate: offset (P, dg * 18) and mask (P, dg * 9), the mask after the
//     sigmoid;
//   * in place: DCNPack's conv_offset_mask output om (P, dg * 27), offsets in
//     channels [0, dg * 18), mask logits after them; the sigmoid is taken
//     here and rounded to T, as torch.sigmoid of a T tensor rounds it.
// Offsets of (g, tap) are the pair (dy, dx) at channel g * 18 + 2 * tap, the
// mask at g * 9 + tap from the mask's base.
//
// Positions are exact f32; a corner is valid when it lies in the image
// (zero padding per corner), tested in float so that any offset, however
// large, is safe.  Index math is 32-bit: a pixel index (b * H + y) * W + x
// is an int (the wrappers check P < 2^31); element offsets are widened only
// where a pointer is formed.
#pragma once

#include "common.cuh"

namespace rvsr {

template <typename T>
struct OffMask {
  const T* off;    // offset channel 0 of pixel 0
  const T* msk;    // mask channel 0 of pixel 0
  int off_stride;  // elements from one pixel's row to the next
  int msk_stride;
  int logits;      // != 0: msk holds logits, the mask is their sigmoid
};

// (dy, dx) and the mask of (pixel p, group g, tap): one 4- or 8-byte load
// for the pair, one for the mask.
template <typename T>
__device__ __forceinline__ void load_off_mask(const OffMask<T>& om, int p,
                                              int g, int tap, float& dy,
                                              float& dx, float& m) {
  using Tr = Traits<T>;
  const size_t o = (size_t)p * om.off_stride + g * 18 + 2 * tap;
  if constexpr (std::is_same<T, float>::value) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(om.off + o));
    dy = v.x, dx = v.y;
  } else {
    const __nv_bfloat162 v =
        __ldg(reinterpret_cast<const __nv_bfloat162*>(om.off + o));
    dy = __low2float(v), dx = __high2float(v);
  }
  const float raw = Tr::to_f(__ldg(om.msk + (size_t)p * om.msk_stride +
                                   g * 9 + tap));
  m = om.logits ? Tr::to_f(Tr::from_f(1.f / (1.f + expf(-raw)))) : raw;
}

struct Corners {
  float ty, tx;   // fractional position within the corner square
  float cw[4];    // bilinear weights, corners (y0,x0) (y0,x0+1) (y0+1,x0)
                  // (y0+1,x0+1)
  int pix[4];     // pixel index of each valid corner
  bool valid[4];  // inside the image
  int y0, x0;     // the top-left corner (meaningful where a corner is valid)
  bool pass_y, pass_x;  // the clamp's gates: the raw offset in [-R, R]
};

// Geometry of the pixel at (y, x), pixel index p = (b * H + y) * W + x,
// for tap (ky, kx) = (tap / 3, tap % 3) with raw offsets (dy, dx);
// clamp != 0 clips them to [-max_off, max_off] first.
__device__ __forceinline__ Corners corners(float dy, float dx, int p, int y,
                                           int x, int tap, int H, int W,
                                           float max_off, int clamp) {
  Corners c;
  c.pass_y = !clamp || (dy >= -max_off && dy <= max_off);
  c.pass_x = !clamp || (dx >= -max_off && dx <= max_off);
  if (clamp) {
    dy = fminf(fmaxf(dy, -max_off), max_off);
    dx = fminf(fmaxf(dx, -max_off), max_off);
  }
  const int ky = tap / 3;
  const float py = (float)(y - 1 + ky) + dy;
  const float px = (float)(x - 1 + (tap - 3 * ky)) + dx;
  const float fy = floorf(py), fx = floorf(px);
  c.ty = py - fy;
  c.tx = px - fx;
  c.cw[0] = (1.f - c.ty) * (1.f - c.tx);
  c.cw[1] = (1.f - c.ty) * c.tx;
  c.cw[2] = c.ty * (1.f - c.tx);
  c.cw[3] = c.ty * c.tx;
  const bool vy0 = fy >= 0.f && fy <= (float)(H - 1);
  const bool vy1 = fy + 1.f >= 0.f && fy + 1.f <= (float)(H - 1);
  const bool vx0 = fx >= 0.f && fx <= (float)(W - 1);
  const bool vx1 = fx + 1.f >= 0.f && fx + 1.f <= (float)(W - 1);
  c.valid[0] = vy0 && vx0;
  c.valid[1] = vy0 && vx1;
  c.valid[2] = vy1 && vx0;
  c.valid[3] = vy1 && vx1;
  // in int range wherever some corner is valid: fy in [-1, H - 1]
  const bool any = (vy0 || vy1) && (vx0 || vx1);
  c.y0 = any ? (int)fy : 0;
  c.x0 = any ? (int)fx : 0;
  const int row0 = p + (c.y0 - y) * W + (c.x0 - x);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    c.pix[k] = c.valid[k] ? row0 + (k >> 1) * W + (k & 1) : 0;
  return c;
}

// N channels of the four corners, 16 bytes a vector (N * sizeof(T) / 16 of
// them), zero where a corner is invalid.  All loads are issued before any
// is used.
template <typename T, int N>
struct GroupCorners {
  static constexpr int kVecs = N * (int)sizeof(T) / 16;
  static_assert(kVecs * 16 == N * (int)sizeof(T), "whole 16-byte vectors");
  uint4 v[4][kVecs];
};

// Channels [ch0, ch0 + N) of each corner of a pixel row of C channels.
template <typename T, int C, int N>
__device__ __forceinline__ void gather(GroupCorners<T, N>& e, const T* x,
                                       const Corners& c, int ch0) {
  constexpr int NV = GroupCorners<T, N>::kVecs;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4* src =
        reinterpret_cast<const uint4*>(x + (size_t)c.pix[k] * C + ch0);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      e.v[k][j] = c.valid[k] ? __ldg(src + j) : make_uint4(0, 0, 0, 0);
  }
}

// Element i (0 .. N - 1) of corner k, as f32.
template <typename T, int N>
__device__ __forceinline__ float corner_value(const GroupCorners<T, N>& e,
                                              int k, int i) {
  constexpr int per = 16 / sizeof(T);
  const T* v = reinterpret_cast<const T*>(&e.v[k][i / per]);
  return Traits<T>::to_f(v[i % per]);
}

// The bilinear sample of the N channels (zero-padded corners), in the
// corner order of the plain op.
template <typename T, int N>
__device__ __forceinline__ void blend(float (&val)[N],
                                      const GroupCorners<T, N>& e,
                                      const Corners& c) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = corner_value(e, 0, i) * c.cw[0];
    v += corner_value(e, 1, i) * c.cw[1];
    v += corner_value(e, 2, i) * c.cw[2];
    v += corner_value(e, 3, i) * c.cw[3];
    val[i] = v;
  }
}

}  // namespace rvsr
