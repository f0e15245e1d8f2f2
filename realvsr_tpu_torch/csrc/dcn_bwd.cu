// Modulated deformable convolution (DCNv2) backward, 3x3 / stride 1 / pad 1,
// NHWC, 64 input and 64 output channels, dg deformable groups, optional
// +-max_offset clamp of the offsets.  Given the output cotangent g (before
// bias and activation: the wrapper undoes those), it computes
//   dS[p, tap, ci] = sum_co g[p, co] W[co, ci, tap]
//   dx             = the transpose of the bilinear sampling of dS * mask
//   doffset        = dS * mask . d(sample)/d(position), zero where the clamp
//                    cut the offset (the gate passes on [-R, R] inclusive)
//   dmask          = dS . (unmasked sample)
//   dW[co, ci, tap] = sum_p g[p, co] S[p, tap, ci]   (S the masked sample)
//
// Replaces the TPU kernel realvsr_tpu/ops/pallas/dcn_frame_kernel.py
// `dcn_frame_fused_bwd` (with its XLA epilogues deform_conv_block.py
// `_fold_dpg` and `_fold_dcoord`).  As there, the sampling is recomputed from
// the inputs and no columns are saved.  Positions are exact f32 (the TPU
// kernel's int16 positions, 128-lane panels and halo overlap-add exist for its
// DMA rules and are not carried over): dx is scattered with f32 atomics
// instead, as the reference CUDA col2im does.
//
// Bound on the H100: per pixel it reads x, offset, mask and g (64 + 144 + 72 +
// 64 elements) and writes dx, doffset and dmask (64 + 144 + 72): ~1.25 KB in
// bf16, so memory-bound (the two tap GEMMs are 4 * 576 * 64 flop per pixel).
//
// Design: two launches.
//  (a) inputs: one block per 128 consecutive pixels, 8 warps.  The block stages
//      its 128 x 64 tile of g once; for each tap it forms dS = g . W_tap^T on
//      the tensor cores (mma.sync) into shared memory, then one thread per
//      (pixel, group) re-samples the four corners, writes dmask and the two
//      offset gradients, and adds dS * mask * corner weight into an f32 dx
//      with 16-byte atomics (four channels each).
//  (b) weights: a grid of (blocks, 9 taps); each block walks a strided set of
//      pixel tiles, re-samples that tap's masked columns S into shared memory
//      (transposed) beside the transposed g tile and accumulates g^T S in
//      registers on the tensor cores; at the end one f32 atomic per dW
//      element per warp.  dW sums over all pixels, so per-tile atomics would
//      put ~27,600 tiles on the same 36,864 addresses at the training shape.
#include "common.cuh"

namespace rvsr {

constexpr int kTileM = 128;
constexpr int kThreads = 256;
constexpr int kC = 64;  // input channels of the backward kernel (= kCout)

struct Corners {
  float ty, tx, m;
  float cw[4];
  long long idx[4];  // element offset of the corner pixel's row of x
  bool valid[4];
};

// Sampling geometry of pixel p for group g and tap (ky, kx), as dcn_fwd.cu.
template <typename T>
__device__ __forceinline__ Corners corners(const T* __restrict__ offset,
                                           const T* __restrict__ mask,
                                           long long p, int g, int tap, int H,
                                           int W, int dg, float max_off,
                                           int clamp, float* raw_dy,
                                           float* raw_dx) {
  using Tr = Traits<T>;
  Corners c;
  const int xo = (int)(p % W);
  const long long q = p / W;
  const int yo = (int)(q % H);
  const long long b = q / H;
  const T* op = offset + p * (dg * 18) + g * 18 + tap * 2;
  float dy = Tr::to_f(op[0]), dx = Tr::to_f(op[1]);
  *raw_dy = dy;
  *raw_dx = dx;
  if (clamp) {
    dy = fminf(fmaxf(dy, -max_off), max_off);
    dx = fminf(fmaxf(dx, -max_off), max_off);
  }
  c.m = Tr::to_f(mask[p * (dg * 9) + g * 9 + tap]);
  const float py = (float)(yo - 1 + tap / 3) + dy;
  const float px = (float)(xo - 1 + tap % 3) + dx;
  const float y0 = floorf(py), x0 = floorf(px);
  c.ty = py - y0;
  c.tx = px - x0;
  c.cw[0] = (1.f - c.ty) * (1.f - c.tx);
  c.cw[1] = (1.f - c.ty) * c.tx;
  c.cw[2] = c.ty * (1.f - c.tx);
  c.cw[3] = c.ty * c.tx;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float cy = y0 + (float)(k >> 1), cx = x0 + (float)(k & 1);
    c.valid[k] = cy >= 0.f && cy <= (float)(H - 1) && cx >= 0.f &&
                 cx <= (float)(W - 1);
    c.idx[k] = c.valid[k] ? ((b * H + (int)cy) * W + (int)cx) * kC : 0;
  }
  return c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dcn_bwd_input_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                         const T* __restrict__ mask, const T* __restrict__ wt,
                         const T* __restrict__ gout, float* __restrict__ dx,
                         T* __restrict__ doffset, T* __restrict__ dmask, int B,
                         int H, int W, int dg, float max_off, int clamp) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  constexpr int ld = kC + Tr::kPad;
  constexpr int ldd = kC + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sG = reinterpret_cast<T*>(smem_raw);  // [kTileM][ld] g tile (p, co)
  T* sW = sG + kTileM * ld;                // [kC][ld] W_tap^T (ci, co)
  float* sD = reinterpret_cast<float*>(sW + kC * ld);  // [kTileM][ldd] dS

  const int cpg = kC / dg;
  const int nv = cpg / V;
  const long long P = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * kTileM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int it = threadIdx.x; it < kTileM * (kC / V); it += kThreads) {
    const int pl = it / (kC / V), kv = it % (kC / V);
    float v[V];
    if (p0 + pl < P) {
      load_vec<T>(gout + (p0 + pl) * kC + kv * V, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
    store_vec_mma<T>(sG + pl * ld + kv * V, v);
  }

  const int r = warp * 16 + (lane >> 2), t = lane & 3;
  for (int tap = 0; tap < 9; ++tap) {
    stage_weight_tap<T>(sW, wt, tap, kC, ld);
    // also orders the previous tap's reads of sD before this tap's writes
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
    warp_mma<T>(acc, sG + r * ld, sG + (r + 8) * ld, sW, ld, kC, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j)  // dS rounded to T, as autograd of the
        // plain op rounds it through the cast of the columns
        sD[(r + (j >> 1) * 8) * ldd + nt * 8 + 2 * t + (j & 1)] =
            Tr::to_f(Tr::from_f(acc[nt][j]));
    __syncthreads();

    for (int it = threadIdx.x; it < kTileM * dg; it += kThreads) {
      const int g = it % dg, pl = it / dg;
      const long long p = p0 + pl;
      if (p >= P) continue;
      float raw_dy, raw_dx;
      const Corners c = corners<T>(offset, mask, p, g, tap, H, W, dg, max_off,
                                   clamp, &raw_dy, &raw_dx);
      float dm = 0.f, dty = 0.f, dtx = 0.f;
      for (int v = 0; v < nv; ++v) {
        const int ch = g * cpg + v * V;
        float e[4][V];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c.valid[k]) {
            load_vec<T>(x + c.idx[k] + ch, e[k]);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j) e[k][j] = 0.f;
          }
        }
        const float* ds = sD + pl * ldd + ch;
        float dv[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float val = e[0][j] * c.cw[0] + e[1][j] * c.cw[1] +
                            e[2][j] * c.cw[2] + e[3][j] * c.cw[3];
          const float dsj = ds[j];
          dm += dsj * val;
          dv[j] = dsj * c.m;
          // one-sided at integer positions (ty = 0): v(y0 + 1) - v(y0)
          dty += dv[j] * ((1.f - c.tx) * (e[2][j] - e[0][j]) +
                          c.tx * (e[3][j] - e[1][j]));
          dtx += dv[j] * ((1.f - c.ty) * (e[1][j] - e[0][j]) +
                          c.ty * (e[3][j] - e[2][j]));
        }
        // one 16-byte atomic per four channels (sm_90), each element
        // added atomically on its own
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!c.valid[k]) continue;
          float4* dst = reinterpret_cast<float4*>(dx + c.idx[k] + ch);
          const float w = c.cw[k];
#pragma unroll
          for (int q = 0; q < V / 4; ++q)
            atomicAdd(dst + q, make_float4(dv[4 * q] * w, dv[4 * q + 1] * w,
                                           dv[4 * q + 2] * w,
                                           dv[4 * q + 3] * w));
        }
      }
      const bool pass_y = !clamp || (raw_dy >= -max_off && raw_dy <= max_off);
      const bool pass_x = !clamp || (raw_dx >= -max_off && raw_dx <= max_off);
      T* od = doffset + p * (dg * 18) + g * 18 + tap * 2;
      od[0] = Tr::from_f(pass_y ? dty : 0.f);
      od[1] = Tr::from_f(pass_x ? dtx : 0.f);
      dmask[p * (dg * 9) + g * 9 + tap] = Tr::from_f(dm);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dcn_bwd_weight_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                          const T* __restrict__ mask,
                          const T* __restrict__ gout, float* __restrict__ dw,
                          int B, int H, int W, int dg, float max_off,
                          int clamp) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  constexpr int ldp = kTileM + Tr::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sGt = reinterpret_cast<T*>(smem_raw);  // [kC][ldp] g^T (co, p)
  T* sSt = sGt + kC * ldp;                  // [kC][ldp] S^T (ci, p)

  const int tap = blockIdx.y;
  const int cpg = kC / dg;
  const int nv = cpg / V;
  const long long P = (long long)B * H * W;
  const long long ntiles = (P + kTileM - 1) / kTileM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warp -> 16 output-channel rows x all 64 input channels, over one half
  // of the tile's pixels (the K dimension of g^T S)
  const int mrow = (warp & 3) * 16 + (lane >> 2);
  const int khalf = (warp >> 2) * (kTileM / 2);

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = tile * kTileM;
    for (int it = threadIdx.x; it < kTileM * (kC / V); it += kThreads) {
      const int pl = it % kTileM, kv = it / kTileM;
      float v[V];
      if (p0 + pl < P) {
        load_vec<T>(gout + (p0 + pl) * kC + kv * V, v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) sGt[(kv * V + j) * ldp + pl] = Tr::to_mma(v[j]);
    }
    for (int it = threadIdx.x; it < kTileM * dg * nv; it += kThreads) {
      const int pl = it % kTileM, gv = it / kTileM;
      const int g = gv / nv, ch = g * cpg + (gv % nv) * V;
      const long long p = p0 + pl;
      float vals[V];
#pragma unroll
      for (int j = 0; j < V; ++j) vals[j] = 0.f;
      if (p < P) {
        float raw_dy, raw_dx;
        const Corners c = corners<T>(offset, mask, p, g, tap, H, W, dg,
                                     max_off, clamp, &raw_dy, &raw_dx);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c.valid[k]) {
            float e[V];
            load_vec<T>(x + c.idx[k] + ch, e);
#pragma unroll
            for (int j = 0; j < V; ++j) vals[j] += e[j] * c.cw[k];
          }
        }
#pragma unroll
        for (int j = 0; j < V; ++j) vals[j] *= c.m;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) sSt[(ch + j) * ldp + pl] = Tr::to_mma(vals[j]);
    }
    __syncthreads();
    warp_mma<T>(acc, sGt + mrow * ldp + khalf, sGt + (mrow + 8) * ldp + khalf,
                sSt + khalf, ldp, kTileM / 2, lane);
    __syncthreads();
  }

  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = mrow + (j >> 1) * 8, ci = nt * 8 + 2 * t + (j & 1);
      atomicAdd(dw + ((size_t)co * 9 + tap) * kC + ci, acc[nt][j]);
    }
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask,
           const void* wt, const void* gout, void* dx, void* doffset,
           void* dmask, void* dw, int B, int H, int W, int dg, float max_off,
           int clamp, void* stream) {
  using Tr = Traits<T>;
  const size_t smem_a = (size_t)(kTileM + kC) * (kC + Tr::kPad) * sizeof(T) +
                        (size_t)kTileM * (kC + 4) * sizeof(float);
  const size_t smem_b = (size_t)2 * kC * (kTileM + Tr::kPad) * sizeof(T);
  cudaFuncSetAttribute(dcn_bwd_input_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_a);
  cudaFuncSetAttribute(dcn_bwd_weight_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_b);
  const long long P = (long long)B * H * W;
  const long long tiles = (P + kTileM - 1) / kTileM;
  if (tiles > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    dcn_bwd_input_kernel<T><<<(unsigned)tiles, kThreads, smem_a, s>>>(
        (const T*)x, (const T*)offset, (const T*)mask, (const T*)wt,
        (const T*)gout, (float*)dx, (T*)doffset, (T*)dmask, B, H, W, dg,
        max_off, clamp);
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // about 4 blocks per SM over the 9 taps
    const long long per_tap = (4LL * sms + 8) / 9;
    const unsigned nbx = (unsigned)(tiles < per_tap ? tiles : per_tap);
    dcn_bwd_weight_kernel<T><<<dim3(nbx, 9), kThreads, smem_b, s>>>(
        (const T*)x, (const T*)offset, (const T*)mask, (const T*)gout,
        (float*)dw, B, H, W, dg, max_off, clamp);
  }
  return (int)cudaGetLastError();
}

}  // namespace rvsr

// x (B,H,W,64); offset (B,H,W,dg*18) laid out (dg, tap, (dy,dx)); mask
// (B,H,W,dg*9) after the sigmoid; wt (64, 9, 64) = (cin, tap, cout); gout
// (B,H,W,64) the cotangent of the output before bias and activation.
// Outputs: dx (B,H,W,64) f32 and dw (64, 9, 64) = (cout, tap, cin) f32, both
// accumulated with atomics and so zeroed by the caller; doffset and dmask in
// the input layouts and type.  clamp != 0 clips every offset to
// [-max_off, max_off] and zeroes the offset gradient beyond it.  Returns
// cudaGetLastError().
extern "C" int dcn_bwd_bf16(const void* x, const void* offset, const void* mask,
                            const void* wt, const void* gout, void* dx,
                            void* doffset, void* dmask, void* dw, int B, int H,
                            int W, int dg, float max_off, int clamp,
                            void* stream) {
  return rvsr::launch<__nv_bfloat16>(x, offset, mask, wt, gout, dx, doffset,
                                     dmask, dw, B, H, W, dg, max_off, clamp,
                                     stream);
}

extern "C" int dcn_bwd_f32(const void* x, const void* offset, const void* mask,
                           const void* wt, const void* gout, void* dx,
                           void* doffset, void* dmask, void* dw, int B, int H,
                           int W, int dg, float max_off, int clamp,
                           void* stream) {
  return rvsr::launch<float>(x, offset, mask, wt, gout, dx, doffset, dmask, dw,
                             B, H, W, dg, max_off, clamp, stream);
}
