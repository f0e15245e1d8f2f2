// Modulated deformable convolution (DCNv2) forward, 3x3 / stride 1 / pad 1,
// NHWC, with dg deformable groups, fused bias, optional LeakyReLU(0.1) and an
// optional +-max_offset clamp of the offsets.
//
// Replaces the TPU kernel realvsr_tpu/ops/pallas/dcn_frame_kernel.py
// `dcn_frame_fused` (with its input prep deform_conv_block.py `_frame_prep`).
// That kernel keeps int16 fixed-point positions and 128-lane column panels,
// which exist only for the TPU's lane and DMA rules; here positions are exact
// f32 and the input is read in place.
//
// Bound on the H100: at the L1 shape (3, 512, 1024, 64), 116 GFLOP against
// ~1.1 GB of x / offset / mask / out, so memory-bound (~0.32 ms at 3.35 TB/s).
// The sampling itself is gather traffic that hits L1/L2 (four 16-byte
// corners per pixel, group and tap).
//
// Design: one block per 128 consecutive output pixels, 8 warps.  For each of
// the 9 taps, the block samples the 128 x C modulated columns (bilinear in
// f32, zero outside the image per corner, times the mask) into shared memory
// as the tensor-core operand, stages that tap's 64 x C weight slice beside
// it, and each warp multiplies its 16 rows into f32 accumulators with
// mma.sync.  The columns never reach device memory: each input byte is read
// from memory about once and the output written once.  Sampling and the
// product are not overlapped yet.
#include "common.cuh"

namespace rvsr {

constexpr int kTileM = 128;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dcn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                   const T* __restrict__ mask, const T* __restrict__ weight,
                   const T* __restrict__ bias, T* __restrict__ out, int B,
                   int H, int W, int C, int dg, int act, float max_off,
                   int clamp) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = C + Tr::kPad;
  T* sA = reinterpret_cast<T*>(smem_raw);  // [kTileM][ld] sampled columns
  T* sB = sA + kTileM * ld;                // [kCout][ld] weight of one tap

  const int cpg = C / dg;
  const int nv = cpg / V;
  const long long P = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * kTileM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int items = kTileM * dg * nv;

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap - 3 * (tap / 3);
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int v = it % nv;
      const int g = (it / nv) % dg;
      const int pl = it / (nv * dg);
      const long long p = p0 + pl;
      float vals[V];
#pragma unroll
      for (int j = 0; j < V; ++j) vals[j] = 0.f;
      if (p < P) {
        const int xo = (int)(p % W);
        const long long q = p / W;
        const int yo = (int)(q % H);
        const long long b = q / H;
        const T* op = offset + p * (dg * 18) + g * 18 + tap * 2;
        float dy = Tr::to_f(op[0]), dx = Tr::to_f(op[1]);
        if (clamp) {
          dy = fminf(fmaxf(dy, -max_off), max_off);
          dx = fminf(fmaxf(dx, -max_off), max_off);
        }
        const float m = Tr::to_f(mask[p * (dg * 9) + g * 9 + tap]);
        const float py = (float)(yo - 1 + ky) + dy;
        const float px = (float)(xo - 1 + kx) + dx;
        const float y0 = floorf(py), x0 = floorf(px);
        const float ty = py - y0, tx = px - x0;
        const float cw[4] = {(1.f - ty) * (1.f - tx), (1.f - ty) * tx,
                             ty * (1.f - tx), ty * tx};
        const float cy[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
        const float cx[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (cy[c] >= 0.f && cy[c] <= (float)(H - 1) && cx[c] >= 0.f &&
              cx[c] <= (float)(W - 1)) {
            const T* src = x + ((b * H + (int)cy[c]) * W + (int)cx[c]) * C +
                           g * cpg + v * V;
            float e[V];
            load_vec<T>(src, e);
#pragma unroll
            for (int j = 0; j < V; ++j) vals[j] += e[j] * cw[c];
          }
        }
#pragma unroll
        for (int j = 0; j < V; ++j) vals[j] *= m;
      }
      store_vec_mma<T>(sA + pl * ld + g * cpg + v * V, vals);
    }
    stage_weight_tap<T>(sB, weight, tap, C, ld);
    __syncthreads();
    const int r = warp * 16 + (lane >> 2);
    warp_mma<T>(acc, sA + r * ld, sA + (r + 8) * ld, sB, ld, C, lane);
    __syncthreads();
  }

  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long p = p0 + warp * 16 + (lane >> 2) + half * 8;
    if (p >= P) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = acc[nt][half * 2 + j];
        if (bias != nullptr) v += Tr::to_f(bias[col + j]);
        out[p * kCout + col + j] = Tr::from_f(apply_act(v, act));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask,
           const void* weight, const void* bias, void* out, int B, int H,
           int W, int C, int dg, int act, float max_off, int clamp,
           void* stream) {
  const size_t smem = (size_t)(kTileM + kCout) * (C + Traits<T>::kPad) * sizeof(T);
  cudaFuncSetAttribute(dcn_fwd_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long long P = (long long)B * H * W;
  const long long blocks = (P + kTileM - 1) / kTileM;
  if (blocks > 0) {
    dcn_fwd_kernel<T><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)offset, (const T*)mask, (const T*)weight,
        (const T*)bias, (T*)out, B, H, W, C, dg, act, max_off, clamp);
  }
  return (int)cudaGetLastError();
}

}  // namespace rvsr

// x (B,H,W,C); offset (B,H,W,dg*9*2) laid out (dg, tap, (dy,dx)); mask
// (B,H,W,dg*9) laid out (dg, tap), already through the sigmoid; weight
// (64, 9, C) i.e. (cout, tap, group, channel); bias (64) or null; out
// (B,H,W,64).  act: 0 none, 1 relu, 2 lrelu(0.1).  clamp != 0 clips every
// offset to [-max_off, max_off].  Returns cudaGetLastError().
extern "C" int dcn_fwd_bf16(const void* x, const void* offset, const void* mask,
                            const void* weight, const void* bias, void* out,
                            int B, int H, int W, int C, int dg, int act,
                            float max_off, int clamp, void* stream) {
  return rvsr::launch<__nv_bfloat16>(x, offset, mask, weight, bias, out, B, H,
                                     W, C, dg, act, max_off, clamp, stream);
}

extern "C" int dcn_fwd_f32(const void* x, const void* offset, const void* mask,
                           const void* weight, const void* bias, void* out,
                           int B, int H, int W, int C, int dg, int act,
                           float max_off, int clamp, void* stream) {
  return rvsr::launch<float>(x, offset, mask, weight, bias, out, B, H, W, C,
                             dg, act, max_off, clamp, stream);
}
