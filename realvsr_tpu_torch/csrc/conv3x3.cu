// NHWC 3x3 / stride 1 / SAME convolution with a fused epilogue:
// f32 accumulator + bias, then relu or lrelu(0.1) or nothing, then the cast to
// the output type, then + residual (added after the activation, as in
// ResidualBlockNoBN).  The input may come as two tensors whose channels are
// concatenated (PCD's concat(nbr, ref) offset convs) without a copy.
//
// Replaces the TPU kernel realvsr_tpu/ops/pallas/conv3x3_kernel.py
// `_packed_pallas` (public `conv3x3_packed`, with `splits` for concat inputs).
// Its pair-packed (W/2, 2C) layout exists only for the TPU's 128-lane DMA
// rule; here the kernel takes plain NHWC.
//
// Bound on the H100: the 64->64 front conv at (3, 512, 1024) is 116 GFLOP
// against 0.4-0.6 GB (about 0.12-0.18 ms, close to the ridge); 128->64 is
// 232 GFLOP, compute-bound at about 0.23 ms at 989 TFLOP/s.
//
// Design: implicit GEMM.  One block computes a 4 x 32 pixel output tile for
// all 64 output channels with 8 warps, one 16-pixel row strip each.  The
// (4+2) x (32+2) input halo is loaded once into shared memory (zeros outside
// the image), so each input byte is read ~1.6x instead of 9x; the 9 taps then
// read their A fragments straight from the halo at a shifted row, against
// that tap's 64 x C weight slice staged beside it, with mma.sync into f32
// accumulators.  No double buffering or TMA yet.
#include "common.cuh"

namespace rvsr {

constexpr int kTH = 4, kTW = 32;
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x1, int c1, const T* __restrict__ x2,
                   int c2, const T* __restrict__ weight,
                   const T* __restrict__ bias, const T* __restrict__ residual,
                   T* __restrict__ out, int B, int H, int W, int act) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = c1 + c2;
  const int ld = C + Tr::kPad;
  T* sH = reinterpret_cast<T*>(smem_raw);  // [kHaloH * kHaloW][ld] input halo
  T* sB = sH + kHaloH * kHaloW * ld;       // [kCout][ld] weight of one tap

  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kTH - 1) / kTH;
  const int bx = blockIdx.x % tiles_x;
  const int by = (blockIdx.x / tiles_x) % tiles_y;
  const long long b = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = by * kTH, x0 = bx * kTW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int nv = C / V;
  for (int it = threadIdx.x; it < kHaloH * kHaloW * nv; it += kThreads) {
    const int hp = it / nv, ch = (it - hp * nv) * V;
    const int gy = y0 + hp / kHaloW - 1, gx = x0 + hp % kHaloW - 1;
    float v[V];
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const long long pix = (b * H + gy) * W + gx;
      if (ch < c1)
        load_vec<T>(x1 + pix * c1 + ch, v);
      else
        load_vec<T>(x2 + pix * c2 + (ch - c1), v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
    store_vec_mma<T>(sH + hp * ld + ch, v);
  }

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;

  // this lane's two fragment rows: tile pixels q and q + 8 of the warp strip
  const int q = warp * 16 + (lane >> 2);
  const int r_lo = q / kTW, c_lo = q % kTW;
  const int r_hi = (q + 8) / kTW, c_hi = (q + 8) % kTW;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap - 3 * (tap / 3);
    stage_weight_tap<T>(sB, weight, tap, C, ld);
    __syncthreads();
    warp_mma<T>(acc, sH + ((r_lo + dy) * kHaloW + c_lo + dx) * ld,
                sH + ((r_hi + dy) * kHaloW + c_hi + dx) * ld, sB, ld, C, lane);
    __syncthreads();
  }

  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qq = q + half * 8;
    const int gy = y0 + qq / kTW, gx = x0 + qq % kTW;
    if (gy >= H || gx >= W) continue;
    const long long pix = (b * H + gy) * W + gx;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = acc[nt][half * 2 + j];
        if (bias != nullptr) v += Tr::to_f(bias[col + j]);
        T o = Tr::from_f(apply_act(v, act));
        if (residual != nullptr)
          o = Tr::from_f(Tr::to_f(o) + Tr::to_f(residual[pix * kCout + col + j]));
        out[pix * kCout + col + j] = o;
      }
    }
  }
}

template <typename T>
int launch(const void* x1, int c1, const void* x2, int c2, const void* weight,
           const void* bias, const void* residual, void* out, int B, int H,
           int W, int act, void* stream) {
  const size_t smem =
      (size_t)(kHaloH * kHaloW + kCout) * (c1 + c2 + Traits<T>::kPad) * sizeof(T);
  cudaFuncSetAttribute(conv3x3_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long long blocks =
      (long long)B * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  if (blocks > 0) {
    conv3x3_kernel<T><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)x1, c1, (const T*)x2, c2, (const T*)weight, (const T*)bias,
        (const T*)residual, (T*)out, B, H, W, act);
  }
  return (int)cudaGetLastError();
}

}  // namespace rvsr

// x1 (B,H,W,c1) and optional x2 (B,H,W,c2): the input is their channel
// concat; weight (64, 9, c1 + c2), i.e. (cout, tap, cin); bias (64) or null;
// residual (B,H,W,64) or null; out (B,H,W,64).  act: 0 none, 1 relu,
// 2 lrelu(0.1).  Returns cudaGetLastError().
extern "C" int conv3x3_bf16(const void* x1, int c1, const void* x2, int c2,
                            const void* weight, const void* bias,
                            const void* residual, void* out, int B, int H,
                            int W, int act, void* stream) {
  return rvsr::launch<__nv_bfloat16>(x1, c1, x2, c2, weight, bias, residual,
                                     out, B, H, W, act, stream);
}

extern "C" int conv3x3_f32(const void* x1, int c1, const void* x2, int c2,
                           const void* weight, const void* bias,
                           const void* residual, void* out, int B, int H,
                           int W, int act, void* stream) {
  return rvsr::launch<float>(x1, c1, x2, c2, weight, bias, residual, out, B, H,
                             W, act, stream);
}
