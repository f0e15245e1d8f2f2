// The mma.sync form of the NHWC 3x3 / stride 1 / SAME convolution with a
// fused epilogue (conv3x3.cu holds the wgmma form and the function's full
// statement).  It takes the inputs the wgmma kernel does not: input widths
// c1 or c2 that are multiples of 16 but not of one 128-byte channel chunk
// (64 bf16 / 32 f32 channels), at any number of outputs.  The nf 16 debug
// configs (debug_EDVR_woTSA_Split_synthetic.yml, debug_EDVR-GAN_Split_
// synthetic.yml) run every conv of their trunk here, 23 a step (all but
// conv_last, whose input is HRconv's 64 channels); no conv of the nf 64 or
// 128 models does.  ops/kernels/conv3x3.py chooses this kernel up front, by
// shape, never after a failure.
//
// Design: implicit GEMM.  One block computes a 4 x 32 pixel output tile with
// 8 warps, one 16-pixel row strip each.  The (4+2) x (32+2) input halo is
// loaded once into shared memory (zeros outside the image).  The block then
// walks over the output channels in tiles of 8 * NT columns (NT = 1, 2, 4 or
// 8 n-tiles of the mma): per tile and tap it stages that tap's weight slice
// beside the halo (the wrapper pads the weight with zero rows to whole
// tiles), and the warps read their A fragments straight from the halo at a
// shifted row, with mma.sync into f32 accumulators.  The stores past cout
// are predicated off.
#include "common.cuh"

namespace rvsr {

constexpr int kTH = 4, kTW = 32;
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;
constexpr int kThreads = 256;

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const T* __restrict__ x1, int c1, const T* __restrict__ x2,
                   int c2, const T* __restrict__ weight,
                   const T* __restrict__ bias, const T* __restrict__ residual,
                   T* __restrict__ out, int B, int H, int W, int cout,
                   int act) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = c1 + c2;
  const int ld = C + Tr::kPad;
  T* sH = reinterpret_cast<T*>(smem_raw);  // [kHaloH * kHaloW][ld] input halo
  T* sB = sH + kHaloH * kHaloW * ld;       // [8 * NT][ld] weight of one tap

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

  // this lane's two fragment rows: tile pixels q and q + 8 of the warp strip
  const int q = warp * 16 + (lane >> 2);
  const int r_lo = q / kTW, c_lo = q % kTW;
  const int r_hi = (q + 8) / kTW, c_hi = (q + 8) % kTW;
  const int t = lane & 3;
  for (int n0 = 0; n0 < cout; n0 += NT * 8) {
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * (tap / 3);
      stage_weight_tap<T, NT * 8>(sB, weight + (size_t)n0 * 9 * C, tap, C,
                                  ld);
      __syncthreads();
      warp_mma<T, NT>(acc, sH + ((r_lo + dy) * kHaloW + c_lo + dx) * ld,
                      sH + ((r_hi + dy) * kHaloW + c_hi + dx) * ld, sB, ld, C,
                      lane);
      __syncthreads();
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qq = q + half * 8;
      const int gy = y0 + qq / kTW, gx = x0 + qq % kTW;
      if (gy >= H || gx >= W) continue;
      const long long pix = (b * H + gy) * W + gx;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + nt * 8 + 2 * t;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (col + j >= cout) continue;
          float v = acc[nt][half * 2 + j];
          if (bias != nullptr) v += Tr::to_f(bias[col + j]);
          T o = Tr::from_f(apply_act(v, act));
          if (residual != nullptr)
            o = Tr::from_f(Tr::to_f(o) +
                           Tr::to_f(residual[pix * cout + col + j]));
          out[pix * cout + col + j] = o;
        }
      }
    }
  }
}

template <typename T, int NT>
int launch_nt(const void* x1, int c1, const void* x2, int c2,
              const void* weight, const void* bias, const void* residual,
              void* out, int B, int H, int W, int cout, int act,
              void* stream) {
  const size_t smem = (size_t)(kHaloH * kHaloW + NT * 8) *
                      (c1 + c2 + Traits<T>::kPad) * sizeof(T);
  cudaFuncSetAttribute(conv3x3_kernel<T, NT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long long blocks =
      (long long)B * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  if (blocks > 0) {
    conv3x3_kernel<T, NT>
        <<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
            (const T*)x1, c1, (const T*)x2, c2, (const T*)weight,
            (const T*)bias, (const T*)residual, (T*)out, B, H, W, cout, act);
  }
  return (int)cudaGetLastError();
}

// tile: the output columns of one channel tile (8, 16, 32 or 64: 1, 2, 4 or
// 8 mma n-tiles), chosen by the wrapper, which pads the weight to it.
template <typename T>
int launch(const void* x1, int c1, const void* x2, int c2, const void* weight,
           const void* bias, const void* residual, void* out, int B, int H,
           int W, int cout, int tile, int act, void* stream) {
  switch (tile) {
    case 64:
      return launch_nt<T, 8>(x1, c1, x2, c2, weight, bias, residual, out, B,
                             H, W, cout, act, stream);
    case 32:
      return launch_nt<T, 4>(x1, c1, x2, c2, weight, bias, residual, out, B,
                             H, W, cout, act, stream);
    case 16:
      return launch_nt<T, 2>(x1, c1, x2, c2, weight, bias, residual, out, B,
                             H, W, cout, act, stream);
    case 8:
      return launch_nt<T, 1>(x1, c1, x2, c2, weight, bias, residual, out, B,
                             H, W, cout, act, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rvsr

// x1 (B,H,W,c1) and optional x2 (B,H,W,c2): the input is their channel
// concat; weight (rows, 9, c1 + c2), i.e. (cout, tap, cin), with rows = cout
// rounded up to a whole number of channel tiles of `tile` columns (8, 16,
// 32 or 64) and zeros past cout; bias (cout) or null; residual (B,H,W,cout)
// or null; out (B,H,W,cout).  act: 0 none, 1 relu, 2 lrelu(0.1).  Returns
// cudaGetLastError().
extern "C" int conv3x3_sync_bf16(const void* x1, int c1, const void* x2,
                                 int c2, const void* weight, const void* bias,
                                 const void* residual, void* out, int B,
                                 int H, int W, int cout, int tile, int act,
                                 void* stream) {
  return rvsr::launch<__nv_bfloat16>(x1, c1, x2, c2, weight, bias, residual,
                                     out, B, H, W, cout, tile, act, stream);
}

extern "C" int conv3x3_sync_f32(const void* x1, int c1, const void* x2,
                                int c2, const void* weight, const void* bias,
                                const void* residual, void* out, int B, int H,
                                int W, int cout, int tile, int act,
                                void* stream) {
  return rvsr::launch<float>(x1, c1, x2, c2, weight, bias, residual, out, B, H,
                             W, cout, tile, act, stream);
}
