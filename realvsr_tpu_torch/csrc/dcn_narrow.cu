// Modulated deformable convolution (DCNv2), 3x3 / stride 1 / pad 1, NHWC, at
// every width the wgmma pair (dcn_fwd.cu, dcn_bwd.cu: 64 or 128 channels in 8
// deformable groups) does not take with C <= 64: C input and C output
// channels in any number of deformable groups G dividing C (16 in 4 groups,
// the repo's debug configs; 32 in 4 or 8, 48 in 8, 64 in 4, ...).  Forward
// (fused bias, optional relu or LeakyReLU(0.1), optional +-max_offset
// clamp) and backward, each reading the offsets and mask either as separate
// tensors or in place from DCNPack's (G * 27)-channel conv_offset_mask
// output (sigmoid of the mask logits taken here), through the sampling
// geometry of dcn_sample.cuh.
//
// Replaces, at these widths, the TPU kernels realvsr_tpu/ops/pallas/
// dcn_frame_kernel.py `dcn_frame_fused` and `dcn_frame_fused_bwd` (with its
// XLA epilogues `_fold_dpg` / `_fold_dcoord`), which are generic in the
// group width.  The wgmma pair's layouts do not carry over (128-byte weight
// chunks, 8- or 16-channel dx footprints), so this file is a simple design
// of its own, with no fixed point: every sum is f32.
//
// Widths: C and G are run-time values; the one template parameter is CH,
// the channels of a group read at once (1, 2, 4 or 8: the largest power of
// two up to 8 dividing C / G), so a corner's load is one vector of CH
// elements (CH x 2 or 4 bytes, aligned: C and the group's start are
// multiples of CH) and a group whose channels are not whole 8-byte units
// (C / G = 6: CH = 2) takes narrower loads, down to scalars.  A group is
// walked CH channels at a time, so no register array grows with C / G.
//
// Bound on the H100: as much by the f32 cores as by memory.  A pixel reads x
// (C), the offsets and mask (27 G) and writes C outputs; its tap products,
// 2 x 9 C x C flop, run on the f32 cores (a CH x 16 product a (group, tap)
// is far below an mma tile, and the f32 cores do it exactly), with ~9 more
// a sampled element.  At the debug config's L1 (12, 64, 64, 16) either is
// ~4 us in bf16: what the call costs beyond that is its launch and the
// latency of the gathers.
//
// Forward: one thread per output pixel, 256 a block.  The weight (as f32
// [tap][ci][co], co padded to a multiple of 16: 9 KB at C = 16, 144 KB at
// 64, so dynamic shared memory) and bias sit in shared memory.  A thread
// holds 16 f32 output sums at a time and walks the outputs in chunks of 16
// (one chunk at C <= 16, four at 64, each sampling the taps again rather
// than holding C sums).  Per (group, tap) it loads its (dy, dx) pair and
// mask, gathers CH channels of the 4 corners at a time (all four loads in
// flight), blends and masks them, rounds them to T as the tensor cores and
// the plain op take them, and adds their products with that tap's weights
// to the 16 sums.  Epilogue: bias, activation, cast, 16-byte stores where a
// chunk is whole 16-byte units, else element by element.
//
// Backward, for the output cotangent g before bias and activation:
//   dS[p, tap, ci] = sum_co g[p, co] W[co, ci, tap]   (rounded to T)
//   dx             = the transpose of the bilinear sampling of dS * mask
//   doffset        = dS * mask . d(sample)/d(position), zero where the clamp
//                    cut the offset (the gate passes on [-R, R] inclusive)
//   dmask          = dS . (unmasked sample), times s (1 - s) in place
//   dW[co, ci, tap] = sum_p g[p, co] S[p, tap, ci]   (S the masked sample)
// Persistent blocks of 256 threads walk runs of 256 consecutive pixels
// (block i takes runs i, i + gridDim.x, ...), one pixel a thread, all
// groups.  Per run the pixels' g (C values each) is staged in shared memory
// with coalesced loads; per tap the tap's weight [ci][co] is staged, and per
// group and CH channels the thread forms dS from its g row and the weight,
// samples its corners, adds dS * mask * (corner weight) to dx with one f32
// vector atomic per valid corner (CH contiguous channels), puts its masked
// sample S in shared memory and sums dS . corner for the position and mask
// gradients, written once the group's channels are done.  After every group
// of a tap, each thread adds sum_p g[p, co] S[p, ci] over the run for its
// (co, ci) pairs (C x C of them over the block's threads) into dW with f32
// atomics.  Shared memory: (C x C + 2 x 256 x (C + 1)) x 4 bytes, 35 KB at
// C = 16 (4 blocks an SM), 146 KB at 64 (one).  Atomics make the order of
// the f32 sums of dx and dW vary from run to run.
#include <algorithm>

#include "dcn_sample.cuh"
#include "sm90.cuh"

namespace rvsr {
namespace narrow {

constexpr int kThreads = 256;  // pixels of a forward block, of a backward run
constexpr int kCo = 16;        // output sums a forward thread holds at once
constexpr int kCMax = 64;      // widest C
constexpr int kBwdBlocksPerSm = 4;  // at most, as shared memory allows
constexpr int kSmemSm = 228 * 1024;  // shared memory of an SM
constexpr int kErrWidth = 9102;

// Shared memory of a forward / backward block at C channels.
inline int fwd_smem(int C) {
  const int cp = (C + kCo - 1) / kCo * kCo;
  return (9 * C * cp + cp) * 4;
}
inline int bwd_smem(int C) { return (C * C + 2 * kThreads * (C + 1)) * 4; }

// CH contiguous elements at src (aligned to CH elements), as f32; zeros
// where the corner is invalid.
template <typename T, int CH>
__device__ __forceinline__ void load_chunk(float (&v)[CH], const T* src,
                                           bool valid) {
  constexpr int kBytes = CH * (int)sizeof(T);
  if (!valid) {
#pragma unroll
    for (int i = 0; i < CH; ++i) v[i] = 0.f;
    return;
  }
  if constexpr (kBytes >= 16) {
    constexpr int E = 16 / (int)sizeof(T);
#pragma unroll
    for (int u = 0; u < kBytes / 16; ++u) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src) + u);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < E; ++i) v[u * E + i] = Traits<T>::to_f(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < CH; ++i) v[i] = Traits<T>::to_f(e[i]);
  } else if constexpr (kBytes == 4) {
    const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(src));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < CH; ++i) v[i] = Traits<T>::to_f(e[i]);
  } else {
    v[0] = Traits<T>::to_f(src[0]);
  }
}

// dx[0 .. CH) += v * w with one f32 vector atomic per 4 (or 2, or 1)
// channels; dx is aligned to CH floats.
template <int CH>
__device__ __forceinline__ void add_dx(float* dx, const float (&v)[CH],
                                       float w) {
  if constexpr (CH % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CH; i += 4)
      atomicAdd(reinterpret_cast<float4*>(dx + i),
                make_float4(v[i] * w, v[i + 1] * w, v[i + 2] * w,
                            v[i + 3] * w));
  } else if constexpr (CH == 2) {
    atomicAdd(reinterpret_cast<float2*>(dx), make_float2(v[0] * w, v[1] * w));
  } else {
    atomicAdd(dx, v[0] * w);
  }
}

// One (pixel, group, tap): its geometry and mask.
template <typename T>
__device__ __forceinline__ Corners geometry(const OffMask<T>& om, int p,
                                            int y, int xx, int g, int tap,
                                            int H, int W, float max_off,
                                            int clamp, float& m) {
  float dy, dx;
  load_off_mask(om, p, g, tap, dy, dx, m);
  return corners(dy, dx, p, y, xx, tap, H, W, max_off, clamp);
}

// CH channels from ch0 of the 4 corners.
template <typename T, int CH>
__device__ __forceinline__ void corner_chunk(float (&e)[4][CH], const T* x,
                                             const Corners& c, int C,
                                             int ch0) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    load_chunk<T, CH>(e[k], x + (size_t)c.pix[k] * C + ch0, c.valid[k]);
}

// The masked bilinear sample of CH channels, corners in the plain op's
// order, rounded to T.
template <typename T, int CH>
__device__ __forceinline__ void masked(float (&v)[CH],
                                       const float (&e)[4][CH],
                                       const Corners& c, float m) {
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    float a = e[0][i] * c.cw[0];
    a += e[1][i] * c.cw[1];
    a += e[2][i] * c.cw[2];
    a += e[3][i] * c.cw[3];
    v[i] = Traits<T>::to_f(Traits<T>::from_f(a * m));
  }
}

template <typename T>
struct FwdParams {
  const T* x;
  OffMask<T> om;
  const T* weight;  // (C, C, 3, 3) OIHW
  const T* bias;
  T* out;
  int P, H, W, C, G, act, clamp;
  float max_off;
};

template <typename T, int CH>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ FwdParams<T> p) {
  using Tr = Traits<T>;
  extern __shared__ float sf[];
  const int C = p.C, cpg = C / p.G, cp = (C + kCo - 1) / kCo * kCo;
  float* sW = sf;                // [tap][ci][cp], zero past C
  float* sB = sf + 9 * C * cp;   // [cp]
  for (int i = threadIdx.x; i < 9 * C * cp; i += kThreads) {
    const int co = i % cp, ci = (i / cp) % C, tap = i / (cp * C);
    sW[i] = co < C ? Tr::to_f(p.weight[(co * C + ci) * 9 + tap]) : 0.f;
  }
  for (int i = threadIdx.x; i < cp; i += kThreads)
    sB[i] = p.bias != nullptr && i < C ? Tr::to_f(p.bias[i]) : 0.f;
  __syncthreads();
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= p.P) return;
  const int xx = pix % p.W, y = (pix / p.W) % p.H;
#pragma unroll 1
  for (int co0 = 0; co0 < C; co0 += kCo) {
    float acc[kCo];
#pragma unroll
    for (int j = 0; j < kCo; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int g = 0; g < p.G; ++g) {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        float m;
        const Corners c = geometry(p.om, pix, y, xx, g, tap, p.H, p.W,
                                   p.max_off, p.clamp, m);
#pragma unroll 1
        for (int c0 = 0; c0 < cpg; c0 += CH) {
          float e[4][CH], v[CH];
          corner_chunk<T, CH>(e, p.x, c, C, g * cpg + c0);
          masked<T, CH>(v, e, c, m);
          const float* w = sW + (tap * C + g * cpg + c0) * cp + co0;
#pragma unroll
          for (int i = 0; i < CH; ++i)
#pragma unroll
            for (int j = 0; j < kCo; ++j)
              acc[j] = fmaf(v[i], w[i * cp + j], acc[j]);
        }
      }
    }
    T* dst = p.out + (size_t)pix * C + co0;
    if (co0 + kCo <= C) {  // whole 16-byte units (C a multiple of 16 here)
      constexpr int kUnits = kCo * (int)sizeof(T) / 16;
      uint4 raw[kUnits];
      T* e = reinterpret_cast<T*>(raw);
#pragma unroll
      for (int j = 0; j < kCo; ++j)
        e[j] = Tr::from_f(apply_act(acc[j] + sB[co0 + j], p.act));
      if (C % kCo == 0) {
#pragma unroll
        for (int u = 0; u < kUnits; ++u)
          reinterpret_cast<uint4*>(dst)[u] = raw[u];
        continue;
      }
#pragma unroll
      for (int j = 0; j < kCo; ++j) dst[j] = e[j];
    } else {
#pragma unroll
      for (int j = 0; j < kCo; ++j)
        if (co0 + j < C)
          dst[j] = Tr::from_f(apply_act(acc[j] + sB[co0 + j], p.act));
    }
  }
}

template <typename T>
struct BwdParams {
  const T* x;
  OffMask<T> om;
  const T* weight;  // (C, C, 3, 3) OIHW
  const T* gout;
  float* dx;
  T* doff;  // offset gradient of pixel 0, rows of doff_stride
  T* dmsk;  // mask (or logit) gradient of pixel 0, rows of dmsk_stride
  int doff_stride, dmsk_stride;
  float* dw;  // (C, 9, C) = (cout, tap, cin)
  int P, H, W, C, G, clamp, nruns;
  float max_off;
};

template <typename T, int CH>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_kernel(const __grid_constant__ BwdParams<T> p) {
  using Tr = Traits<T>;
  extern __shared__ float sf[];
  const int C = p.C, cpg = C / p.G, ld = C + 1;  // +1: no bank conflicts
  float* sWt = sf;                  // [ci][co], one tap
  float* sG = sf + C * C;           // [pixel][ld]
  float* sS = sG + kThreads * ld;   // [pixel][ld], one tap
  const int tid = threadIdx.x;

  for (int run = blockIdx.x; run < p.nruns; run += gridDim.x) {
    const int pix = run * kThreads + tid;
    const bool ok = pix < p.P;
    const int xx = ok ? pix % p.W : 0, y = ok ? (pix / p.W) % p.H : 0;
    // the run's g, coalesced (its pixels are consecutive); the last run's
    // reads of sG ended at its last barrier
    const T* grun = p.gout + (size_t)run * kThreads * C;
    for (int i = tid; i < kThreads * C; i += kThreads) {
      const int r = i / C, co = i - r * C;
      sG[r * ld + co] =
          run * kThreads + r < p.P ? Tr::to_f(grun[i]) : 0.f;
    }
    const float* grow = sG + tid * ld;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      for (int i = tid; i < C * C; i += kThreads) {
        const int ci = i / C, co = i - ci * C;
        sWt[i] = Tr::to_f(p.weight[(co * C + ci) * 9 + tap]);
      }
      __syncthreads();  // the tap's weight (and the run's g) staged
#pragma unroll 1
      for (int grp = 0; grp < p.G; ++grp) {
        if (!ok) {
          for (int i = 0; i < cpg; ++i) sS[tid * ld + grp * cpg + i] = 0.f;
          continue;
        }
        float m;
        const Corners c = geometry(p.om, pix, y, xx, grp, tap, p.H, p.W,
                                   p.max_off, p.clamp, m);
        float E[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
        for (int c0 = 0; c0 < cpg; c0 += CH) {
          const int ci0 = grp * cpg + c0;
          float ds[CH];
#pragma unroll
          for (int i = 0; i < CH; ++i) {
            const float* w = sWt + (ci0 + i) * C;
            float a = 0.f;
#pragma unroll 4
            for (int co = 0; co < C; ++co) a = fmaf(grow[co], w[co], a);
            // rounded to T, as autograd of the plain op rounds it through
            // the cast of the columns
            ds[i] = Tr::to_f(Tr::from_f(a));
          }
          float e[4][CH], S[CH];
          corner_chunk<T, CH>(e, p.x, c, C, ci0);
          masked<T, CH>(S, e, c, m);
#pragma unroll
          for (int i = 0; i < CH; ++i) sS[tid * ld + ci0 + i] = S[i];
          // E_k = dS . (corner k): dmask = sum_k w_k E_k, and the position
          // gradients are m times differences of the E_k
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int i = 0; i < CH; ++i) E[k] += ds[i] * e[k][i];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (c.valid[k])
              add_dx<CH>(p.dx + (size_t)c.pix[k] * C + ci0, ds, c.cw[k] * m);
        }
        const float dm = c.cw[0] * E[0] + c.cw[1] * E[1] + c.cw[2] * E[2] +
                         c.cw[3] * E[3];
        const float dty =
            m * ((1.f - c.tx) * (E[2] - E[0]) + c.tx * (E[3] - E[1]));
        const float dtx =
            m * ((1.f - c.ty) * (E[1] - E[0]) + c.ty * (E[3] - E[2]));
        const float gy = c.pass_y ? dty : 0.f, gx = c.pass_x ? dtx : 0.f;
        T* od = p.doff + (size_t)pix * p.doff_stride + grp * 18 + 2 * tap;
        od[0] = Tr::from_f(gy);
        od[1] = Tr::from_f(gx);
        float gm = Tr::to_f(Tr::from_f(dm));
        if (p.om.logits) gm = gm * (1.f - m) * m;
        p.dmsk[(size_t)pix * p.dmsk_stride + grp * 9 + tap] = Tr::from_f(gm);
      }
      __syncthreads();  // the tap's S in shared memory
      // dW[co, tap, ci] += sum over the run of g[p, co] S[p, ci]
      for (int q = tid; q < C * C; q += kThreads) {
        const int co = q / C, ci = q - co * C;
        float a = 0.f;
#pragma unroll 8
        for (int r = 0; r < kThreads; ++r)
          a = fmaf(sG[r * ld + co], sS[r * ld + ci], a);
        atomicAdd(p.dw + (co * 9 + tap) * C + ci, a);
      }
      __syncthreads();  // every read of S and the weight done
    }
  }
}

// The channels of a group read at once: the largest power of two up to 8
// dividing C / G.
inline int chunk_of(int cpg) {
  return cpg % 8 == 0 ? 8 : cpg % 4 == 0 ? 4 : cpg % 2 == 0 ? 2 : 1;
}

inline bool width_ok(int C, int G) {
  return C >= 1 && C <= kCMax && G >= 1 && C % G == 0;
}

template <typename T, int CH>
int fwd_launch(const FwdParams<T>& p, void* stream) {
  const int smem = fwd_smem(p.C);
  static int attribute = 0;  // the largest shared memory allowed so far
  if (smem > attribute) {
    cudaFuncSetAttribute(fwd_kernel<T, CH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attribute = smem;
  }
  const int grid = (p.P + kThreads - 1) / kThreads;
  if (grid > 0)
    fwd_kernel<T, CH><<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int CH>
int bwd_launch(const BwdParams<T>& p, void* stream) {
  const int smem = bwd_smem(p.C);
  static int attribute = 0;
  if (smem > attribute) {
    cudaFuncSetAttribute(bwd_kernel<T, CH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attribute = smem;
  }
  const int per_sm = std::min(kBwdBlocksPerSm, kSmemSm / (smem + 1024));
  const int cap = per_sm * sm_count();
  const int grid = p.nruns < cap ? p.nruns : cap;
  if (grid > 0)
    bwd_kernel<T, CH><<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_entry(const void* x, const void* off, int off_stride,
              const void* msk, int msk_stride, int logits,
              const void* weight, const void* bias, void* out, int B, int H,
              int W, int C, int G, int act, float max_off, int clamp,
              void* stream) {
  if (!width_ok(C, G)) return kErrWidth;
  FwdParams<T> p;
  p.x = (const T*)x;
  p.om = OffMask<T>{(const T*)off, (const T*)msk, off_stride, msk_stride,
                    logits};
  p.weight = (const T*)weight;
  p.bias = (const T*)bias;
  p.out = (T*)out;
  p.P = B * H * W, p.H = H, p.W = W, p.C = C, p.G = G, p.act = act;
  p.clamp = clamp, p.max_off = max_off;
  switch (chunk_of(C / G)) {
    case 8:
      return fwd_launch<T, 8>(p, stream);
    case 4:
      return fwd_launch<T, 4>(p, stream);
    case 2:
      return fwd_launch<T, 2>(p, stream);
    default:
      return fwd_launch<T, 1>(p, stream);
  }
}

template <typename T>
int bwd_entry(const void* x, const void* off, int off_stride,
              const void* msk, int msk_stride, int logits,
              const void* weight, const void* gout, void* dx, void* doff,
              int doff_stride, void* dmsk, int dmsk_stride, void* dw, int B,
              int H, int W, int C, int G, float max_off, int clamp,
              void* stream) {
  if (!width_ok(C, G)) return kErrWidth;
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
  p.P = B * H * W, p.H = H, p.W = W, p.C = C, p.G = G, p.clamp = clamp;
  p.max_off = max_off;
  p.nruns = (p.P + kThreads - 1) / kThreads;
  switch (chunk_of(C / G)) {
    case 8:
      return bwd_launch<T, 8>(p, stream);
    case 4:
      return bwd_launch<T, 4>(p, stream);
    case 2:
      return bwd_launch<T, 2>(p, stream);
    default:
      return bwd_launch<T, 1>(p, stream);
  }
}

}  // namespace narrow
}  // namespace rvsr

// Forward.  x (B,H,W,C), C <= 64 in G deformable groups (G | C); offsets of
// pixel p at off + p * off_stride, laid out (group, tap, (dy, dx)); the mask
// at msk + p * msk_stride, (group, tap), through the sigmoid already
// (logits == 0) or logits (logits != 0); weight (C, C, 3, 3) OIHW; bias (C)
// or null; out (B,H,W,C).  act: 0 none, 1 relu, 2 lrelu(0.1).  clamp != 0
// clips every offset to [-max_off, max_off].  Returns cudaGetLastError(), or
// 9102 (C, G outside those).
extern "C" int dcn_narrow_fwd_bf16(const void* x, const void* off,
                                   int off_stride, const void* msk,
                                   int msk_stride, int logits,
                                   const void* weight, const void* bias,
                                   void* out, int B, int H, int W, int C,
                                   int G, int act, float max_off, int clamp,
                                   void* stream) {
  return rvsr::narrow::fwd_entry<__nv_bfloat16>(
      x, off, off_stride, msk, msk_stride, logits, weight, bias, out, B, H, W,
      C, G, act, max_off, clamp, stream);
}

extern "C" int dcn_narrow_fwd_f32(const void* x, const void* off,
                                  int off_stride, const void* msk,
                                  int msk_stride, int logits,
                                  const void* weight, const void* bias,
                                  void* out, int B, int H, int W, int C, int G,
                                  int act, float max_off, int clamp,
                                  void* stream) {
  return rvsr::narrow::fwd_entry<float>(x, off, off_stride, msk, msk_stride,
                                        logits, weight, bias, out, B, H, W, C,
                                        G, act, max_off, clamp, stream);
}

// Backward.  Inputs as the forward's, plus gout (B,H,W,C), the cotangent of
// the output before bias and activation.  Outputs: dx (B,H,W,C) f32 and dw
// (C, 9, C) = (cout, tap, cin) f32, both summed with atomics and so zeroed
// by the caller; the offset gradient at doff + p * doff_stride and the mask
// gradient (the logits' where logits != 0) at dmsk + p * dmsk_stride, in the
// input type.  Returns cudaGetLastError(), or 9102.
extern "C" int dcn_narrow_bwd_bf16(const void* x, const void* off,
                                   int off_stride, const void* msk,
                                   int msk_stride, int logits,
                                   const void* weight, const void* gout,
                                   void* dx, void* doff, int doff_stride,
                                   void* dmsk, int dmsk_stride, void* dw,
                                   int B, int H, int W, int C, int G,
                                   float max_off, int clamp, void* stream) {
  return rvsr::narrow::bwd_entry<__nv_bfloat16>(
      x, off, off_stride, msk, msk_stride, logits, weight, gout, dx, doff,
      doff_stride, dmsk, dmsk_stride, dw, B, H, W, C, G, max_off, clamp,
      stream);
}

extern "C" int dcn_narrow_bwd_f32(const void* x, const void* off,
                                  int off_stride, const void* msk,
                                  int msk_stride, int logits,
                                  const void* weight, const void* gout,
                                  void* dx, void* doff, int doff_stride,
                                  void* dmsk, int dmsk_stride, void* dw,
                                  int B, int H, int W, int C, int G,
                                  float max_off, int clamp, void* stream) {
  return rvsr::narrow::bwd_entry<float>(
      x, off, off_stride, msk, msk_stride, logits, weight, gout, dx, doff,
      doff_stride, dmsk, dmsk_stride, dw, B, H, W, C, G, max_off, clamp,
      stream);
}
