// Modulated deformable convolution (DCNv2), 3x3 / stride 1 / pad 1, NHWC, at
// the width of the repo's debug configs: 16 input and 16 output channels in 4
// deformable groups of 4 channels.  Forward (fused bias, optional relu or
// LeakyReLU(0.1), optional +-max_offset clamp) and backward, each reading the
// offsets and mask either as separate tensors or in place from DCNPack's
// 108-channel conv_offset_mask output (sigmoid of the mask logits taken
// here), through the sampling geometry of dcn_sample.cuh.
//
// Replaces, at this width, the TPU kernels realvsr_tpu/ops/pallas/
// dcn_frame_kernel.py `dcn_frame_fused` and `dcn_frame_fused_bwd` (with its
// XLA epilogues `_fold_dpg` / `_fold_dcoord`), as dcn_fwd.cu and dcn_bwd.cu
// do at 64 channels in 8 groups.  Their layouts do not carry over: the
// forward's resident weight is cut into 128-byte channel chunks (a 16-channel
// bf16 pixel is 32 bytes), and the backward's dx footprint holds the 8
// channels of one group in int32 fixed point.  So this file is a simple
// design of its own, with no fixed point: every sum is f32.
//
// Bound on the H100: as much by the f32 cores as by memory.  A pixel reads x
// (16), the offsets and mask (108) and writes 16 outputs, ~280 bytes in
// bf16; its tap products, 2 x 144 x 16 flop, run on the f32 cores (a 4 x 16
// product a (group, tap) is far below an mma tile, and the f32 cores do it
// exactly), with ~9 more a sampled element.  At the debug config's L1 (12,
// 64, 64, 16) either is ~4 us in bf16: what the call costs beyond that is
// its launch and the latency of the gathers.
//
// Forward: one thread per output pixel, 256 a block.  The weight (as f32
// [tap][ci][co], 9 KB) and bias sit in shared memory.  Per (group, tap) the
// thread loads its (dy, dx) pair and mask, gathers the group's 4 channels of
// the 4 corners (8 bytes each in bf16, 16 in f32; all four loads in flight),
// blends and masks them, rounds them to T as the tensor cores and the plain
// op take them, and adds their products with that tap's 4 x 16 weights to 16
// f32 sums.  Epilogue: bias, activation, cast, 16-byte stores.
//
// Backward, for the output cotangent g before bias and activation:
//   dS[p, tap, ci] = sum_co g[p, co] W[co, ci, tap]   (rounded to T)
//   dx             = the transpose of the bilinear sampling of dS * mask
//   doffset        = dS * mask . d(sample)/d(position), zero where the clamp
//                    cut the offset (the gate passes on [-R, R] inclusive)
//   dmask          = dS . (unmasked sample), times s (1 - s) in place
//   dW[co, ci, tap] = sum_p g[p, co] S[p, tap, ci]   (S the masked sample)
// Persistent blocks of 256 threads walk runs of 256 consecutive pixels
// (block i takes runs i, i + gridDim.x, ...), one pixel a thread, all four
// groups.  Per run, the pixel's g (16 values) is read into registers and
// shared memory; per tap and group the thread forms dS from its registers
// and the shared weight, samples its corners again, writes its offset and
// mask gradients, adds dS * mask * (corner weight) to dx with one 16-byte
// f32 atomic per valid corner (a corner's 4 channels are contiguous), and
// puts its masked sample S in shared memory.  After the four groups of a tap,
// thread (co, ci) adds sum_p g[p, co] S[p, ci] over the run to its register
// of dW[co, tap, ci]; the 9 registers go to dW with f32 atomics at the end.
// Atomics make the order of the f32 sums of dx and dW vary from run to run.
#include "dcn_sample.cuh"
#include "sm90.cuh"

namespace rvsr {
namespace narrow {

constexpr int kC = 16;       // input and output channels
constexpr int kG = 4;        // deformable groups
constexpr int kCpg = kC / kG;
constexpr int kThreads = 256;  // pixels of a forward block, of a backward run
constexpr int kBwdBlocksPerSm = 4;  // 43 KB of shared memory each
constexpr int kLd = kC + 1;    // shared rows of g and S (+1: no bank conflicts)

// The OIHW weight as f32 [tap][ci][co] in shared memory.
template <typename T>
__device__ __forceinline__ void stage_weight(float* sW, const T* w) {
  for (int i = threadIdx.x; i < 9 * kC * kC; i += blockDim.x) {
    const int co = i % kC, ci = (i / kC) % kC, tap = i / (kC * kC);
    sW[i] = Traits<T>::to_f(w[(co * kC + ci) * 9 + tap]);
  }
}

// The group's 4 channels of one corner, as f32 (0 where it is invalid).
template <typename T>
__device__ __forceinline__ void corner4(float (&v)[kCpg], const T* x, int pix,
                                        int g, bool valid) {
  const T* src = x + (size_t)pix * kC + g * kCpg;
  if constexpr (std::is_same<T, float>::value) {
    const float4 q = valid ? __ldg(reinterpret_cast<const float4*>(src))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const uint2 q = valid ? __ldg(reinterpret_cast<const uint2*>(src))
                          : make_uint2(0u, 0u);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(a), v[1] = __high2float(a);
    v[2] = __low2float(b), v[3] = __high2float(b);
  }
}

// One (pixel, group, tap): its geometry, the mask and the corners' channels.
struct Sample {
  Corners c;
  float m;
  float e[4][kCpg];
};

template <typename T>
__device__ __forceinline__ void sample(Sample& s, const T* x,
                                       const OffMask<T>& om, int p, int y,
                                       int xx, int g, int tap, int H, int W,
                                       float max_off, int clamp) {
  float dy, dx;
  load_off_mask(om, p, g, tap, dy, dx, s.m);
  s.c = corners(dy, dx, p, y, xx, tap, H, W, max_off, clamp);
#pragma unroll
  for (int k = 0; k < 4; ++k) corner4<T>(s.e[k], x, s.c.pix[k], g,
                                         s.c.valid[k]);
}

// The masked bilinear sample of the group's channels, corners in the plain
// op's order, rounded to T.
template <typename T>
__device__ __forceinline__ void masked(float (&v)[kCpg], const Sample& s) {
#pragma unroll
  for (int i = 0; i < kCpg; ++i) {
    float a = s.e[0][i] * s.c.cw[0];
    a += s.e[1][i] * s.c.cw[1];
    a += s.e[2][i] * s.c.cw[2];
    a += s.e[3][i] * s.c.cw[3];
    v[i] = Traits<T>::to_f(Traits<T>::from_f(a * s.m));
  }
}

template <typename T>
struct FwdParams {
  const T* x;
  OffMask<T> om;
  const T* weight;  // (16, 16, 3, 3) OIHW
  const T* bias;
  T* out;
  int P, H, W, act, clamp;
  float max_off;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const __grid_constant__ FwdParams<T> p) {
  using Tr = Traits<T>;
  __shared__ float sW[9 * kC * kC];
  __shared__ float sB[kC];
  stage_weight(sW, p.weight);
  if (threadIdx.x < kC)
    sB[threadIdx.x] =
        p.bias != nullptr ? Tr::to_f(p.bias[threadIdx.x]) : 0.f;
  __syncthreads();
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= p.P) return;
  const int xx = pix % p.W, y = (pix / p.W) % p.H;
  float acc[kC];
#pragma unroll
  for (int co = 0; co < kC; ++co) acc[co] = 0.f;
#pragma unroll 1
  for (int g = 0; g < kG; ++g) {
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      Sample s;
      sample(s, p.x, p.om, pix, y, xx, g, tap, p.H, p.W, p.max_off, p.clamp);
      float v[kCpg];
      masked<T>(v, s);
      const float* w = sW + (tap * kC + g * kCpg) * kC;
#pragma unroll
      for (int i = 0; i < kCpg; ++i)
#pragma unroll
        for (int co = 0; co < kC; ++co)
          acc[co] = fmaf(v[i], w[i * kC + co], acc[co]);
    }
  }
  constexpr int kUnits = kC * (int)sizeof(T) / 16;
  uint4 raw[kUnits];
  T* e = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int co = 0; co < kC; ++co)
    e[co] = Tr::from_f(apply_act(acc[co] + sB[co], p.act));
  uint4* dst = reinterpret_cast<uint4*>(p.out + (size_t)pix * kC);
#pragma unroll
  for (int u = 0; u < kUnits; ++u) dst[u] = raw[u];
}

template <typename T>
struct BwdParams {
  const T* x;
  OffMask<T> om;
  const T* weight;  // (16, 16, 3, 3) OIHW
  const T* gout;
  float* dx;
  T* doff;  // offset gradient of pixel 0, rows of doff_stride
  T* dmsk;  // mask (or logit) gradient of pixel 0, rows of dmsk_stride
  int doff_stride, dmsk_stride;
  float* dw;  // (16, 9, 16) = (cout, tap, cin)
  int P, H, W, clamp, nruns;
  float max_off;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const __grid_constant__ BwdParams<T> p) {
  using Tr = Traits<T>;
  __shared__ float sW[9 * kC * kC];      // [tap][ci][co]
  __shared__ float sG[kThreads * kLd];   // [pixel][co]
  __shared__ float sS[kThreads * kLd];   // [pixel][ci], one tap
  stage_weight(sW, p.weight);
  const int tid = threadIdx.x;
  const int wco = tid / kC, wci = tid % kC;  // this thread's dW entries
  float accw[9];  // dW[wco, tap, wci], rotated per tap (below)
#pragma unroll
  for (int t = 0; t < 9; ++t) accw[t] = 0.f;

  for (int run = blockIdx.x; run < p.nruns; run += gridDim.x) {
    const int pix = run * kThreads + tid;
    const bool ok = pix < p.P;
    const int xx = ok ? pix % p.W : 0, y = ok ? (pix / p.W) % p.H : 0;
    float g[kC];
#pragma unroll
    for (int v = 0; v < kC; v += Tr::kVec) {
      if (ok) {
        load_vec<T>(p.gout + (size_t)pix * kC + v, g + v);
      } else {
#pragma unroll
        for (int j = 0; j < Tr::kVec; ++j) g[v + j] = 0.f;
      }
    }
    __syncthreads();  // the weight staged; the last run's reads of sG done
#pragma unroll
    for (int co = 0; co < kC; ++co) sG[tid * kLd + co] = g[co];

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll 1
      for (int grp = 0; grp < kG; ++grp) {
        float S[kCpg] = {0.f, 0.f, 0.f, 0.f};
        if (ok) {
          const float* w = sW + (tap * kC + grp * kCpg) * kC;
          float ds[kCpg];
#pragma unroll
          for (int i = 0; i < kCpg; ++i) {
            float a = 0.f;
#pragma unroll
            for (int co = 0; co < kC; ++co) a = fmaf(g[co], w[i * kC + co], a);
            // rounded to T, as autograd of the plain op rounds it through
            // the cast of the columns
            ds[i] = Tr::to_f(Tr::from_f(a));
          }
          Sample s;
          sample(s, p.x, p.om, pix, y, xx, grp, tap, p.H, p.W, p.max_off,
                 p.clamp);
          masked<T>(S, s);
          // E_k = dS . (corner k): dmask = sum_k w_k E_k, and the position
          // gradients are m times differences of the E_k
          float E[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            E[k] = 0.f;
#pragma unroll
            for (int i = 0; i < kCpg; ++i) E[k] += ds[i] * s.e[k][i];
          }
          const Corners& c = s.c;
          const float m = s.m;
          const float dm = c.cw[0] * E[0] + c.cw[1] * E[1] + c.cw[2] * E[2] +
                           c.cw[3] * E[3];
          const float dty =
              m * ((1.f - c.tx) * (E[2] - E[0]) + c.tx * (E[3] - E[1]));
          const float dtx =
              m * ((1.f - c.ty) * (E[1] - E[0]) + c.ty * (E[3] - E[2]));
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!c.valid[k]) continue;
            const float wk = c.cw[k] * m;
            atomicAdd(reinterpret_cast<float4*>(p.dx + (size_t)c.pix[k] * kC +
                                                grp * kCpg),
                      make_float4(ds[0] * wk, ds[1] * wk, ds[2] * wk,
                                  ds[3] * wk));
          }
          const float gy = c.pass_y ? dty : 0.f, gx = c.pass_x ? dtx : 0.f;
          T* od = p.doff + (size_t)pix * p.doff_stride + grp * 18 + 2 * tap;
          od[0] = Tr::from_f(gy);
          od[1] = Tr::from_f(gx);
          float gm = Tr::to_f(Tr::from_f(dm));
          if (p.om.logits) gm = gm * (1.f - m) * m;
          p.dmsk[(size_t)pix * p.dmsk_stride + grp * 9 + tap] =
              Tr::from_f(gm);
        }
#pragma unroll
        for (int i = 0; i < kCpg; ++i) sS[tid * kLd + grp * kCpg + i] = S[i];
      }
      __syncthreads();  // the tap's S (and this run's g) in shared memory
      float a = 0.f;
#pragma unroll 8
      for (int q = 0; q < kThreads; ++q)
        a = fmaf(sG[q * kLd + wco], sS[q * kLd + wci], a);
      // accw[0] is this tap's: add, then rotate by one, so that the 9 taps
      // of a run come back to tap 0 and accw stays in registers (an index
      // by the loop's tap would put it on the stack)
      const float head = accw[0] + a;
#pragma unroll
      for (int t = 0; t < 8; ++t) accw[t] = accw[t + 1];
      accw[8] = head;
      __syncthreads();  // every read of S done before the next tap's
    }
  }
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
    atomicAdd(p.dw + (wco * 9 + tap) * kC + wci, accw[tap]);
}

template <typename T>
int fwd_entry(const void* x, const void* off, int off_stride,
              const void* msk, int msk_stride, int logits,
              const void* weight, const void* bias, void* out, int B, int H,
              int W, int act, float max_off, int clamp, void* stream) {
  FwdParams<T> p;
  p.x = (const T*)x;
  p.om = OffMask<T>{(const T*)off, (const T*)msk, off_stride, msk_stride,
                    logits};
  p.weight = (const T*)weight;
  p.bias = (const T*)bias;
  p.out = (T*)out;
  p.P = B * H * W, p.H = H, p.W = W, p.act = act, p.clamp = clamp;
  p.max_off = max_off;
  const int grid = (p.P + kThreads - 1) / kThreads;
  if (grid > 0)
    fwd_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_entry(const void* x, const void* off, int off_stride,
              const void* msk, int msk_stride, int logits,
              const void* weight, const void* gout, void* dx, void* doff,
              int doff_stride, void* dmsk, int dmsk_stride, void* dw, int B,
              int H, int W, float max_off, int clamp, void* stream) {
  BwdParams<T> p;
  p.x = (const T*)x;
  p.om = OffMask<T>{(const T*)off, (const T*)msk, off_stride, msk_stride,
                    logits};
  p.weight = (const T*)weight;
  p.gout = (const T*)gout;
  p.dx = (float*)dx;
  p.doff = (T*)doff;
  p.dmsk = (T*)dmsk;
  p.doff_stride = doff_stride;
  p.dmsk_stride = dmsk_stride;
  p.dw = (float*)dw;
  p.P = B * H * W, p.H = H, p.W = W, p.clamp = clamp, p.max_off = max_off;
  p.nruns = (p.P + kThreads - 1) / kThreads;
  const int cap = kBwdBlocksPerSm * sm_count();
  const int grid = p.nruns < cap ? p.nruns : cap;
  if (grid > 0)
    bwd_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace narrow
}  // namespace rvsr

// Forward.  x (B,H,W,16); offsets of pixel p at off + p * off_stride, laid
// out (group, tap, (dy, dx)); the mask at msk + p * msk_stride, (group, tap),
// through the sigmoid already (logits == 0) or logits (logits != 0); weight
// (16, 16, 3, 3) OIHW; bias (16) or null; out (B,H,W,16).  act: 0 none, 1
// relu, 2 lrelu(0.1).  clamp != 0 clips every offset to [-max_off, max_off].
// Returns cudaGetLastError().
extern "C" int dcn_narrow_fwd_bf16(const void* x, const void* off,
                                   int off_stride, const void* msk,
                                   int msk_stride, int logits,
                                   const void* weight, const void* bias,
                                   void* out, int B, int H, int W, int act,
                                   float max_off, int clamp, void* stream) {
  return rvsr::narrow::fwd_entry<__nv_bfloat16>(
      x, off, off_stride, msk, msk_stride, logits, weight, bias, out, B, H, W,
      act, max_off, clamp, stream);
}

extern "C" int dcn_narrow_fwd_f32(const void* x, const void* off,
                                  int off_stride, const void* msk,
                                  int msk_stride, int logits,
                                  const void* weight, const void* bias,
                                  void* out, int B, int H, int W, int act,
                                  float max_off, int clamp, void* stream) {
  return rvsr::narrow::fwd_entry<float>(x, off, off_stride, msk, msk_stride,
                                        logits, weight, bias, out, B, H, W,
                                        act, max_off, clamp, stream);
}

// Backward.  Inputs as the forward's, plus gout (B,H,W,16), the cotangent of
// the output before bias and activation.  Outputs: dx (B,H,W,16) f32 and dw
// (16, 9, 16) = (cout, tap, cin) f32, both summed with atomics and so zeroed
// by the caller; the offset gradient at doff + p * doff_stride and the mask
// gradient (the logits' where logits != 0) at dmsk + p * dmsk_stride, in the
// input type.  Returns cudaGetLastError().
extern "C" int dcn_narrow_bwd_bf16(const void* x, const void* off,
                                   int off_stride, const void* msk,
                                   int msk_stride, int logits,
                                   const void* weight, const void* gout,
                                   void* dx, void* doff, int doff_stride,
                                   void* dmsk, int dmsk_stride, void* dw,
                                   int B, int H, int W, float max_off,
                                   int clamp, void* stream) {
  return rvsr::narrow::bwd_entry<__nv_bfloat16>(
      x, off, off_stride, msk, msk_stride, logits, weight, gout, dx, doff,
      doff_stride, dmsk, dmsk_stride, dw, B, H, W, max_off, clamp, stream);
}

extern "C" int dcn_narrow_bwd_f32(const void* x, const void* off,
                                  int off_stride, const void* msk,
                                  int msk_stride, int logits,
                                  const void* weight, const void* gout,
                                  void* dx, void* doff, int doff_stride,
                                  void* dmsk, int dmsk_stride, void* dw,
                                  int B, int H, int W, float max_off,
                                  int clamp, void* stream) {
  return rvsr::narrow::bwd_entry<float>(
      x, off, off_stride, msk, msk_stride, logits, weight, gout, dx, doff,
      doff_stride, dmsk, dmsk_stride, dw, B, H, W, max_off, clamp, stream);
}
