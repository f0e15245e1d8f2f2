// Deformable convolution, 3x3 / stride 1 / pad 1, NHWC, at every shape the
// wgmma pair (dcn_fwd.cu, dcn_bwd.cu: 64 -> 64 or 128 -> 128 channels in 8
// deformable groups, with a mask) does not take: Ci input and Co output
// channels, independent of each other and of any width, in any number of
// deformable groups G dividing Ci (16 in 4 groups, the repo's debug configs;
// 64 -> 32, 96 in 4, 256 in 8, ...), with a mask (DCNv2) or without one
// (DCNv1: no mask is read, no mask gradient written).  Forward (fused bias,
// optional relu or LeakyReLU(0.1), optional +-max_offset clamp) and
// backward, each reading the offsets and mask either as separate tensors or
// in place from DCNPack's (G * 27)-channel conv_offset_mask output (sigmoid
// of the mask logits taken here), through the sampling geometry of
// dcn_sample.cuh.
//
// Replaces, at these shapes, the TPU kernels realvsr_tpu/ops/pallas/
// dcn_frame_kernel.py `dcn_frame_fused` and `dcn_frame_fused_bwd` (with its
// XLA epilogues `_fold_dpg` / `_fold_dcoord`), which take any group width
// and any number of outputs, and a mask or none.  The wgmma pair's layouts
// do not carry over (128-byte weight chunks, 8- or 16-channel dx
// footprints), so this file is a simple design of its own, with no fixed
// point: every sum is f32.
//
// Widths: Ci, Co and G are run-time values; the template parameter CH is
// the channels of a group read at once (1, 2, 4 or 8: the largest power of
// two up to 8 dividing Ci / G), so a corner's load is one vector of CH
// elements (CH x 2 or 4 bytes, aligned: Ci and the group's start are
// multiples of CH) and a group whose channels are not whole 8-byte units
// (Ci / G = 6: CH = 2) takes narrower loads, down to scalars.  A group is
// walked CH channels at a time, so no register array grows with Ci / G.
//
// Bound on the H100: at Ci = Co <= 64 as much by the f32 cores as by
// memory.  A pixel reads x (Ci), the offsets and mask (27 G) and writes Co
// outputs; its tap products, 2 x 9 Ci x Co flop, run on the f32 cores (a
// CH x 16 product a (group, tap) is far below an mma tile, and the f32
// cores do it exactly), with ~9 more a sampled element.  At the debug
// config's L1 (12, 64, 64, 16) either is ~4 us in bf16: what the call costs
// beyond that is its launch and the latency of the gathers.  At the wider
// shapes the products on the f32 cores (9 Ci Co a pixel, against the tensor
// cores' 15x higher rate in bf16) and the resampling bound it: the forward
// samples every tap again for each 16 outputs (Co / 16 times), and the
// backward's dW takes one f32 atomic per (co, ci, tap) and run; at 256 ->
// 256 both are products-bound, 10-100x what the tensor cores would take.
//
// Forward: one thread per output pixel, 256 a block; the grid's second
// dimension tiles the outputs (cot of them a block, a multiple of 16).  The
// block's weight (as f32 [tap][ci][co], co of its tile, zero past Co) and
// bias sit in shared memory: all 9 taps where they fit kFwdBudget (cot = all
// of Co, 9 KB at 16 -> 16, 144 KB at 64 -> 64, as the design has had since
// it took C <= 64; at wider shapes the largest tile of whole 16-output
// chunks that fits, 32 at 128 -> 64 or 96 -> 96, 16 at 256 -> 256), else
// (Ci above ~355) one tap at a time, staged between two barriers (cot 16).
// The mask (or none) is a template parameter and the two ways of holding
// the weight two kernels, so the resident form with a mask compiles to the
// loop it had at C <= 64 (run-time branches there cost the forward 25-58%).
// A thread holds 16 f32 output sums at a time and walks the tile's outputs
// in chunks of 16, each sampling the taps again rather than holding more
// sums.  Per (group, tap) it loads its (dy, dx) pair and mask, gathers CH
// channels of the 4 corners at a time (all four loads in flight), blends and
// masks them, rounds them to T as the tensor cores and the plain op take
// them, and adds their products with that tap's weights to the 16 sums.
// Epilogue: bias, activation, cast, 16-byte stores where a chunk is whole
// 16-byte units, else element by element.
//
// Backward, for the output cotangent g before bias and activation:
//   dS[p, tap, ci] = sum_co g[p, co] W[co, ci, tap]   (rounded to T)
//   dx             = the transpose of the bilinear sampling of dS * mask
//   doffset        = dS * mask . d(sample)/d(position), zero where the clamp
//                    cut the offset (the gate passes on [-R, R] inclusive)
//   dmask          = dS . (unmasked sample), times s (1 - s) in place
//   dW[co, ci, tap] = sum_p g[p, co] S[p, tap, ci]   (S the masked sample)
// (with no mask, m = 1 and no dmask).  Persistent blocks of 256 threads walk
// runs of 256 consecutive pixels (block i takes runs i, i + gridDim.x, ...),
// one pixel a thread, all groups.  Per tap the input channels go in chunks
// of KC (whole groups, or an equal part of one group wider than KC).  Where
// a run's g (Co values a pixel) fits in shared memory beside a chunk's
// weight and S (the "whole-row" form, kOneCo; KC = Ci at Ci = Co <= 64, as
// before), it is staged once a run with coalesced loads; per chunk the
// tap's weight [ci][co] is staged, and per group and CH channels the thread
// forms dS from its g row and the weight.  Wider (Co above ~130), g and the
// weight are staged in chunks of KO = 32 outputs and dS summed over them
// in shared memory, then the run's g chunks are staged again for dW.  The
// thread then samples its corners, adds dS * mask * (corner weight) to dx
// with one f32 vector atomic per valid corner (CH contiguous channels), puts
// its masked sample S in shared memory and sums dS . corner for the
// position and mask gradients, written once the group's channels are done.
// After each chunk, each thread adds sum_p g[p, co] S[p, ci] over the run
// for its (co, ci) pairs into dW with f32 atomics.  Shared memory (f32):
// KC x KO + 256 x (KO + 1) + 256 x (KC + 1), plus 256 x (KC + 1) for dS in
// the chunked form: 35 KB at 16 -> 16 (4 blocks an SM), 146 KB at 64 -> 64
// (one), 105 KB at 256 -> 256 (two).  Atomics make the order of the f32
// sums of dx and dW vary from run to run.
#include <algorithm>

#include "dcn_sample.cuh"
#include "sm90.cuh"

namespace rvsr {
namespace narrow {

constexpr int kThreads = 256;  // pixels of a forward block, of a backward run
constexpr int kCo = 16;        // output sums a forward thread holds at once
constexpr int kBwdBlocksPerSm = 4;  // at most, as shared memory allows
constexpr int kSmemSm = 228 * 1024;  // shared memory of an SM
constexpr int kSmemMax = 227 * 1024;  // dynamic shared memory of a block
constexpr int kFwdBudget = 160 * 1024;  // the forward's resident weight tile
constexpr int kBwdBudget = 160 * 1024;  // the backward's whole-row form
constexpr int kChunkCo = 32;   // KO of the backward's chunked form
constexpr int kErrWidth = 9102;

// The channels of a group read at once: the largest power of two up to 8
// dividing Ci / G.
inline int chunk_of(int cpg) {
  return cpg % 8 == 0 ? 8 : cpg % 4 == 0 ? 4 : cpg % 2 == 0 ? 2 : 1;
}

// Shared memory of a forward block: ntap taps of the weight for cot
// outputs, and the bias.
inline int fwd_smem(int Ci, int cot, int ntap) {
  return (ntap * Ci * cot + cot) * 4;
}

// The forward's output tile and resident taps: all 9 taps of the widest
// tile of whole 16-output chunks (all of Co where it fits) within
// kFwdBudget, else 16 outputs a tap at a time.
struct FwdPlan {
  int cot, ntap;
};
inline FwdPlan fwd_plan(int Ci, int Co) {
  int cot = (Co + kCo - 1) / kCo * kCo;
  while (cot > kCo && fwd_smem(Ci, cot, 9) > kFwdBudget) cot -= kCo;
  if (fwd_smem(Ci, cot, 9) <= kFwdBudget) return {cot, 9};
  return {kCo, 1};
}

// Shared memory of a backward block: a chunk's weight (kc x ko), the run's
// g (ko + 1 a pixel), S (kc + 1 a pixel) and, chunked, dS (kc + 1).
inline int bwd_smem(int kc, int ko, int one_co) {
  return (kc * ko + kThreads * (ko + 1) +
          (one_co ? 1 : 2) * kThreads * (kc + 1)) * 4;
}

// Input channels of a backward chunk, at most `most`: whole groups where a
// group fits (never more than Ci), else the largest multiple of ch dividing
// the group.
inline int chunk_ci(int Ci, int cpg, int ch, int most) {
  if (cpg <= most) return std::min(most / cpg * cpg, Ci);
  int k = most / ch * ch;
  while (cpg % k) k -= ch;
  return k;
}

// The backward's form: whole-row (one_co, ko = Co) with the largest chunk
// of Ci, 64, 32, 16 or 8 input channels within kBwdBudget; else chunked,
// ko = kChunkCo and chunks of at most kChunkCo input channels.
struct BwdPlan {
  int kc, ko, one_co;
};
inline BwdPlan bwd_plan(int Ci, int Co, int cpg) {
  const int ch = chunk_of(cpg);
  for (int most : {Ci, 64, 32, 16, 8}) {
    const int kc = chunk_ci(Ci, cpg, ch, most);
    if (bwd_smem(kc, Co, 1) <= kBwdBudget) return {kc, Co, 1};
  }
  return {chunk_ci(Ci, cpg, ch, kChunkCo), kChunkCo, 0};
}

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

// One (pixel, group, tap): its geometry and mask (kMask), or with no mask
// (DCNv1) its geometry alone, m = 1 and no mask read.  The (dy, dx) pair is
// one vector load: the wrappers pass offset rows an even number of elements
// apart (DCNPack's om in an odd number of groups has its offsets copied).
template <typename T, bool kMask>
__device__ __forceinline__ Corners geometry(const OffMask<T>& om, int p,
                                            int y, int xx, int g, int tap,
                                            int H, int W, float max_off,
                                            int clamp, float& m) {
  float dy, dx;
  if constexpr (kMask) {
    load_off_mask(om, p, g, tap, dy, dx, m);
  } else {
    const size_t o = (size_t)p * om.off_stride + g * 18 + 2 * tap;
    if constexpr (std::is_same<T, float>::value) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(om.off + o));
      dy = v.x, dx = v.y;
    } else {
      const __nv_bfloat162 v =
          __ldg(reinterpret_cast<const __nv_bfloat162*>(om.off + o));
      dy = __low2float(v), dx = __high2float(v);
    }
    m = 1.f;
  }
  return corners(dy, dx, p, y, xx, tap, H, W, max_off, clamp);
}

// CH channels from ch0 of the 4 corners, pixel rows of C channels.
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
  OffMask<T> om;    // om.msk null: no mask
  const T* weight;  // (Co, Ci, 3, 3) OIHW
  const T* bias;
  T* out;
  int P, H, W, Ci, Co, G, act, clamp;
  int cot, ntap;  // fwd_plan
  float max_off;
};

// Epilogue of one 16-output chunk (outputs o0 = cb + co0 ..): bias,
// activation, cast, 16-byte stores where the chunk is whole 16-byte units.
template <typename T>
__device__ __forceinline__ void store_chunk(const FwdParams<T>& p,
                                            const float* sB,
                                            const float (&acc)[kCo], int pix,
                                            int o0, int co0) {
  using Tr = Traits<T>;
  const int Co = p.Co;
  T* dst = p.out + (size_t)pix * Co + o0;
  if (o0 + kCo <= Co) {  // whole 16-byte units where Co % 16 == 0
    constexpr int kUnits = kCo * (int)sizeof(T) / 16;
    uint4 raw[kUnits];
    T* e = reinterpret_cast<T*>(raw);
#pragma unroll
    for (int j = 0; j < kCo; ++j)
      e[j] = Tr::from_f(apply_act(acc[j] + sB[co0 + j], p.act));
    if (Co % kCo == 0) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
        reinterpret_cast<uint4*>(dst)[u] = raw[u];
      return;
    }
#pragma unroll
    for (int j = 0; j < kCo; ++j) dst[j] = e[j];
  } else {
#pragma unroll
    for (int j = 0; j < kCo; ++j)
      if (o0 + j < Co)
        dst[j] = Tr::from_f(apply_act(acc[j] + sB[co0 + j], p.act));
  }
}

// The forward, the tile's 9 taps resident (staged once): each thread walks
// groups, then taps, then CH-channel chunks, the loop this design has had
// since it took C <= 64.
template <typename T, int CH, bool kMask>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ FwdParams<T> p) {
  using Tr = Traits<T>;
  extern __shared__ float sf[];
  // cot a multiple of 16 as the compiler sees it: each 16-output row of
  // the weight is then read as four 16-byte shared-memory loads
  const int Ci = p.Ci, Co = p.Co, cpg = Ci / p.G, cot = p.cot / kCo * kCo;
  const int cb = blockIdx.y * cot;   // the tile's first output
  float* sW = sf;                    // [tap][ci][cot], zero past Co
  float* sB = sf + 9 * Ci * cot;     // [cot]
  for (int i = threadIdx.x; i < 9 * Ci * cot; i += kThreads) {
    const int co = i % cot, ci = (i / cot) % Ci, tap = i / (cot * Ci);
    sW[i] = cb + co < Co
                ? Tr::to_f(p.weight[((size_t)(cb + co) * Ci + ci) * 9 + tap])
                : 0.f;
  }
  for (int i = threadIdx.x; i < cot; i += kThreads)
    sB[i] = p.bias != nullptr && cb + i < Co ? Tr::to_f(p.bias[cb + i]) : 0.f;
  __syncthreads();
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= p.P) return;
  const int xx = pix % p.W, y = (pix / p.W) % p.H;
#pragma unroll 1
  for (int co0 = 0; co0 < cot && cb + co0 < Co; co0 += kCo) {
    float acc[kCo];
#pragma unroll
    for (int j = 0; j < kCo; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int g = 0; g < p.G; ++g) {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        float m;
        const Corners c = geometry<T, kMask>(p.om, pix, y, xx, g, tap, p.H,
                                             p.W, p.max_off, p.clamp, m);
#pragma unroll 1
        for (int c0 = 0; c0 < cpg; c0 += CH) {
          float e[4][CH], v[CH];
          corner_chunk<T, CH>(e, p.x, c, Ci, g * cpg + c0);
          masked<T, CH>(v, e, c, m);
          const float* w = sW + (tap * Ci + g * cpg + c0) * cot + co0;
#pragma unroll
          for (int i = 0; i < CH; ++i)
#pragma unroll
            for (int j = 0; j < kCo; ++j)
              acc[j] = fmaf(v[i], w[i * cot + j], acc[j]);
        }
      }
    }
    store_chunk(p, sB, acc, pix, cb + co0, co0);
  }
}

// The forward with the weight streamed (the input too wide for a tile's 9
// taps): one 16-output tile a block, each tap's [ci][16] slice staged
// between two barriers that every thread reaches; taps, then groups.
template <typename T, int CH, bool kMask>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_stream_kernel(const __grid_constant__ FwdParams<T> p) {
  using Tr = Traits<T>;
  extern __shared__ float sf[];
  const int Ci = p.Ci, Co = p.Co, cpg = Ci / p.G;
  const int cb = blockIdx.y * kCo;   // the tile's first output
  float* sW = sf;                    // [ci][kCo] of one tap, zero past Co
  float* sB = sf + Ci * kCo;         // [kCo]
  for (int i = threadIdx.x; i < kCo; i += kThreads)
    sB[i] = p.bias != nullptr && cb + i < Co ? Tr::to_f(p.bias[cb + i]) : 0.f;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  const bool ok = pix < p.P;
  const int xx = ok ? pix % p.W : 0, y = ok ? (pix / p.W) % p.H : 0;
  float acc[kCo];
#pragma unroll
  for (int j = 0; j < kCo; ++j) acc[j] = 0.f;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // every read of the last tap's slice done
    for (int i = threadIdx.x; i < Ci * kCo; i += kThreads) {
      const int co = i % kCo, ci = i / kCo;
      sW[i] = cb + co < Co
                  ? Tr::to_f(p.weight[((size_t)(cb + co) * Ci + ci) * 9 + tap])
                  : 0.f;
    }
    __syncthreads();
    if (!ok) continue;
#pragma unroll 1
    for (int g = 0; g < p.G; ++g) {
      float m;
      const Corners c = geometry<T, kMask>(p.om, pix, y, xx, g, tap, p.H,
                                           p.W, p.max_off, p.clamp, m);
#pragma unroll 1
      for (int c0 = 0; c0 < cpg; c0 += CH) {
        float e[4][CH], v[CH];
        corner_chunk<T, CH>(e, p.x, c, Ci, g * cpg + c0);
        masked<T, CH>(v, e, c, m);
        const float* w = sW + (g * cpg + c0) * kCo;
#pragma unroll
        for (int i = 0; i < CH; ++i)
#pragma unroll
          for (int j = 0; j < kCo; ++j)
            acc[j] = fmaf(v[i], w[i * kCo + j], acc[j]);
      }
    }
  }
  if (ok) store_chunk(p, sB, acc, pix, cb, 0);
}

template <typename T>
struct BwdParams {
  const T* x;
  OffMask<T> om;    // om.msk null: no mask
  const T* weight;  // (Co, Ci, 3, 3) OIHW
  const T* gout;
  float* dx;
  T* doff;  // offset gradient of pixel 0, rows of doff_stride
  T* dmsk;  // mask (or logit) gradient of pixel 0, rows of dmsk_stride;
            // null with no mask
  int doff_stride, dmsk_stride;
  float* dw;  // (Co, 9, Ci) = (cout, tap, cin)
  int P, H, W, Ci, Co, G, clamp, nruns;
  int kc, ko;  // bwd_plan (ko = Co in the whole-row form)
  float max_off;
};

template <typename T, int CH, bool kOneCo>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_kernel(const __grid_constant__ BwdParams<T> p) {
  using Tr = Traits<T>;
  extern __shared__ float sf[];
  const int Ci = p.Ci, Co = p.Co, cpg = Ci / p.G, KC = p.kc;
  const int KO = kOneCo ? Co : p.ko;
  const int ldg = KO + 1, lds = KC + 1;  // +1: no bank conflicts
  float* sWt = sf;                  // [ci of the chunk][KO], one tap
  float* sG = sWt + KC * KO;        // [pixel][ldg]
  float* sS = sG + kThreads * ldg;  // [pixel][lds]
  float* sD = sS + kThreads * lds;  // [pixel][lds], dS (chunked form)
  const int tid = threadIdx.x;

  // outputs [co0, co0 + n) of the run's g, coalesced along each row
  auto stage_g = [&](int run, int co0, int n) {
    const T* grun = p.gout + (size_t)run * kThreads * Co + co0;
    for (int i = tid; i < kThreads * n; i += kThreads) {
      const int r = i / n, co = i - r * n;
      sG[r * ldg + co] = run * kThreads + r < p.P
                             ? Tr::to_f(grun[(size_t)r * Co + co])
                             : 0.f;
    }
  };
  // the tap's weight [ci][co], inputs [ci0, ci0 + nc), outputs [co0, co0 + n)
  auto stage_w = [&](int tap, int ci0, int nc, int co0, int n) {
    for (int i = tid; i < nc * n; i += kThreads) {
      const int ci = i / n, co = i - ci * n;
      sWt[ci * KO + co] =
          Tr::to_f(p.weight[((size_t)(co0 + co) * Ci + ci0 + ci) * 9 + tap]);
    }
  };

  for (int run = blockIdx.x; run < p.nruns; run += gridDim.x) {
    const int pix = run * kThreads + tid;
    const bool ok = pix < p.P;
    const int xx = ok ? pix % p.W : 0, y = ok ? (pix / p.W) % p.H : 0;
    // the last run's reads of sG ended at its last barrier
    if (kOneCo) stage_g(run, 0, Co);
    const float* grow = sG + tid * ldg;
    float E[4] = {0.f, 0.f, 0.f, 0.f};  // a group's dS . corner k

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll 1
      for (int kc0 = 0; kc0 < Ci; kc0 += KC) {
        const int nc = min(KC, Ci - kc0);
        if (kOneCo) {
          stage_w(tap, kc0, nc, 0, Co);
          __syncthreads();  // the chunk's weight (and the run's g) staged
        } else {
          float* drow = sD + tid * lds;
          for (int i = 0; i < nc; ++i) drow[i] = 0.f;
#pragma unroll 1
          for (int ko0 = 0; ko0 < Co; ko0 += KO) {
            const int n = min(KO, Co - ko0);
            __syncthreads();  // every read of the last g and weight done
            stage_g(run, ko0, n);
            stage_w(tap, kc0, nc, ko0, n);
            __syncthreads();
#pragma unroll 1
            for (int i = 0; i < nc; ++i) {
              const float* w = sWt + i * KO;
              float a = drow[i];
#pragma unroll 4
              for (int co = 0; co < n; ++co) a = fmaf(grow[co], w[co], a);
              drow[i] = a;
            }
          }
        }
        const int g_last = (kc0 + nc - 1) / cpg;
#pragma unroll 1
        for (int grp = kc0 / cpg; grp <= g_last; ++grp) {
          const int c_lo = max(grp * cpg, kc0);
          const int c_hi = min(grp * cpg + cpg, kc0 + nc);
          if (!ok) {
            for (int i = c_lo; i < c_hi; ++i) sS[tid * lds + i - kc0] = 0.f;
            continue;
          }
          if (c_lo == grp * cpg)
#pragma unroll
            for (int k = 0; k < 4; ++k) E[k] = 0.f;
          float m;
          const Corners c =
              p.om.msk != nullptr
                  ? geometry<T, true>(p.om, pix, y, xx, grp, tap, p.H, p.W,
                                      p.max_off, p.clamp, m)
                  : geometry<T, false>(p.om, pix, y, xx, grp, tap, p.H, p.W,
                                       p.max_off, p.clamp, m);
#pragma unroll 1
          for (int ci0 = c_lo; ci0 < c_hi; ci0 += CH) {
            const int j = ci0 - kc0;  // the channel's place in the chunk
            float ds[CH];
#pragma unroll
            for (int i = 0; i < CH; ++i) {
              float a;
              if (kOneCo) {
                const float* w = sWt + (j + i) * KO;
                a = 0.f;
#pragma unroll 4
                for (int co = 0; co < Co; ++co) a = fmaf(grow[co], w[co], a);
              } else {
                a = sD[tid * lds + j + i];
              }
              // rounded to T, as autograd of the plain op rounds it through
              // the cast of the columns
              ds[i] = Tr::to_f(Tr::from_f(a));
            }
            float e[4][CH], S[CH];
            corner_chunk<T, CH>(e, p.x, c, Ci, ci0);
            masked<T, CH>(S, e, c, m);
#pragma unroll
            for (int i = 0; i < CH; ++i) sS[tid * lds + j + i] = S[i];
            // E_k = dS . (corner k): dmask = sum_k w_k E_k, and the position
            // gradients are m times differences of the E_k
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int i = 0; i < CH; ++i) E[k] += ds[i] * e[k][i];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (c.valid[k])
                add_dx<CH>(p.dx + (size_t)c.pix[k] * Ci + ci0, ds,
                           c.cw[k] * m);
          }
          if (c_hi < grp * cpg + cpg) continue;  // more of it in a later chunk
          const float dty =
              m * ((1.f - c.tx) * (E[2] - E[0]) + c.tx * (E[3] - E[1]));
          const float dtx =
              m * ((1.f - c.ty) * (E[1] - E[0]) + c.ty * (E[3] - E[2]));
          const float gy = c.pass_y ? dty : 0.f, gx = c.pass_x ? dtx : 0.f;
          T* od = p.doff + (size_t)pix * p.doff_stride + grp * 18 + 2 * tap;
          od[0] = Tr::from_f(gy);
          od[1] = Tr::from_f(gx);
          if (p.dmsk != nullptr) {
            const float dm = c.cw[0] * E[0] + c.cw[1] * E[1] +
                             c.cw[2] * E[2] + c.cw[3] * E[3];
            float gm = Tr::to_f(Tr::from_f(dm));
            if (p.om.logits) gm = gm * (1.f - m) * m;
            p.dmsk[(size_t)pix * p.dmsk_stride + grp * 9 + tap] =
                Tr::from_f(gm);
          }
        }
        __syncthreads();  // the chunk's S in shared memory
        // dW[co, tap, kc0 + ci] += sum over the run of g[p, co] S[p, ci]
#pragma unroll 1
        for (int ko0 = 0; ko0 < Co; ko0 += KO) {
          const int n = min(KO, Co - ko0);
          if (!kOneCo) {
            stage_g(run, ko0, n);
            __syncthreads();
          }
          for (int q = tid; q < n * nc; q += kThreads) {
            const int co = q / nc, ci = q - co * nc;
            float a = 0.f;
#pragma unroll 8
            for (int r = 0; r < kThreads; ++r)
              a = fmaf(sG[r * ldg + co], sS[r * lds + ci], a);
            atomicAdd(p.dw + ((size_t)(ko0 + co) * 9 + tap) * Ci + kc0 + ci,
                      a);
          }
          __syncthreads();  // every read of S, g and the weight done
        }
      }
    }
  }
}

inline bool width_ok(int Ci, int Co, int G) {
  return Ci >= 1 && Co >= 1 && G >= 1 && Ci % G == 0;
}

template <typename T, int CH, bool kMask, bool kStream>
int fwd_launch_form(const FwdParams<T>& p, void* stream) {
  const int smem = fwd_smem(p.Ci, p.cot, p.ntap);
  if (smem > kSmemMax) return kErrWidth;
  static int attribute = 0;  // the largest shared memory allowed so far
  if (smem > attribute) {
    if constexpr (kStream)
      cudaFuncSetAttribute(fwd_stream_kernel<T, CH, kMask>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    else
      cudaFuncSetAttribute(fwd_kernel<T, CH, kMask>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attribute = smem;
  }
  const dim3 grid((p.P + kThreads - 1) / kThreads,
                  (p.Co + p.cot - 1) / p.cot);
  if (grid.x > 0) {
    if constexpr (kStream)
      fwd_stream_kernel<T, CH, kMask>
          <<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
    else
      fwd_kernel<T, CH, kMask>
          <<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T, int CH>
int fwd_launch(const FwdParams<T>& p, void* stream) {
  const bool mask = p.om.msk != nullptr, streamed = p.ntap != 9;
  if (mask)
    return streamed ? fwd_launch_form<T, CH, true, true>(p, stream)
                    : fwd_launch_form<T, CH, true, false>(p, stream);
  return streamed ? fwd_launch_form<T, CH, false, true>(p, stream)
                  : fwd_launch_form<T, CH, false, false>(p, stream);
}

template <typename T, int CH, bool kOneCo>
int bwd_launch_form(const BwdParams<T>& p, void* stream) {
  const int smem = bwd_smem(p.kc, p.ko, kOneCo);
  if (smem > kSmemMax) return kErrWidth;
  static int attribute = 0;
  if (smem > attribute) {
    cudaFuncSetAttribute(bwd_kernel<T, CH, kOneCo>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attribute = smem;
  }
  const int per_sm = std::min(kBwdBlocksPerSm, kSmemSm / (smem + 1024));
  const int cap = per_sm * sm_count();
  const int grid = p.nruns < cap ? p.nruns : cap;
  if (grid > 0)
    bwd_kernel<T, CH, kOneCo>
        <<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int CH>
int bwd_launch(const BwdParams<T>& p, int one_co, void* stream) {
  return one_co ? bwd_launch_form<T, CH, true>(p, stream)
                : bwd_launch_form<T, CH, false>(p, stream);
}

template <typename T>
int fwd_entry(const void* x, const void* off, int off_stride,
              const void* msk, int msk_stride, int logits,
              const void* weight, const void* bias, void* out, int B, int H,
              int W, int Ci, int Co, int G, int act, float max_off, int clamp,
              void* stream) {
  if (!width_ok(Ci, Co, G)) return kErrWidth;
  FwdParams<T> p;
  p.x = (const T*)x;
  p.om = OffMask<T>{(const T*)off, (const T*)msk, off_stride, msk_stride,
                    logits};
  p.weight = (const T*)weight;
  p.bias = (const T*)bias;
  p.out = (T*)out;
  p.P = B * H * W, p.H = H, p.W = W, p.Ci = Ci, p.Co = Co, p.G = G;
  p.act = act, p.clamp = clamp, p.max_off = max_off;
  const FwdPlan plan = fwd_plan(Ci, Co);
  p.cot = plan.cot, p.ntap = plan.ntap;
  switch (chunk_of(Ci / G)) {
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
              int H, int W, int Ci, int Co, int G, float max_off, int clamp,
              void* stream) {
  if (!width_ok(Ci, Co, G)) return kErrWidth;
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
  p.P = B * H * W, p.H = H, p.W = W, p.Ci = Ci, p.Co = Co, p.G = G;
  p.clamp = clamp, p.max_off = max_off;
  p.nruns = (p.P + kThreads - 1) / kThreads;
  const BwdPlan plan = bwd_plan(Ci, Co, Ci / G);
  p.kc = plan.kc, p.ko = plan.ko;
  switch (chunk_of(Ci / G)) {
    case 8:
      return bwd_launch<T, 8>(p, plan.one_co, stream);
    case 4:
      return bwd_launch<T, 4>(p, plan.one_co, stream);
    case 2:
      return bwd_launch<T, 2>(p, plan.one_co, stream);
    default:
      return bwd_launch<T, 1>(p, plan.one_co, stream);
  }
}

}  // namespace narrow
}  // namespace rvsr

// Forward.  x (B,H,W,Ci) in G deformable groups (G | Ci); offsets of pixel
// p at off + p * off_stride, laid out (group, tap, (dy, dx)); the mask at
// msk + p * msk_stride, (group, tap), through the sigmoid already
// (logits == 0) or logits (logits != 0), or msk null for none (DCNv1);
// weight (Co, Ci, 3, 3) OIHW; bias (Co) or null; out (B,H,W,Co).  act: 0
// none, 1 relu, 2 lrelu(0.1).  clamp != 0 clips every offset to [-max_off,
// max_off].  Returns cudaGetLastError(), or 9102 (widths outside those, or
// beyond shared memory).
extern "C" int dcn_narrow_fwd_bf16(const void* x, const void* off,
                                   int off_stride, const void* msk,
                                   int msk_stride, int logits,
                                   const void* weight, const void* bias,
                                   void* out, int B, int H, int W, int Ci,
                                   int Co, int G, int act, float max_off,
                                   int clamp, void* stream) {
  return rvsr::narrow::fwd_entry<__nv_bfloat16>(
      x, off, off_stride, msk, msk_stride, logits, weight, bias, out, B, H, W,
      Ci, Co, G, act, max_off, clamp, stream);
}

extern "C" int dcn_narrow_fwd_f32(const void* x, const void* off,
                                  int off_stride, const void* msk,
                                  int msk_stride, int logits,
                                  const void* weight, const void* bias,
                                  void* out, int B, int H, int W, int Ci,
                                  int Co, int G, int act, float max_off,
                                  int clamp, void* stream) {
  return rvsr::narrow::fwd_entry<float>(x, off, off_stride, msk, msk_stride,
                                        logits, weight, bias, out, B, H, W,
                                        Ci, Co, G, act, max_off, clamp,
                                        stream);
}

// Backward.  Inputs as the forward's, plus gout (B,H,W,Co), the cotangent
// of the output before bias and activation.  Outputs: dx (B,H,W,Ci) f32 and
// dw (Co, 9, Ci) = (cout, tap, cin) f32, both summed with atomics and so
// zeroed by the caller; the offset gradient at doff + p * doff_stride and
// the mask gradient (the logits' where logits != 0) at dmsk + p *
// dmsk_stride, in the input type (dmsk null with no mask).  Returns
// cudaGetLastError(), or 9102.
extern "C" int dcn_narrow_bwd_bf16(const void* x, const void* off,
                                   int off_stride, const void* msk,
                                   int msk_stride, int logits,
                                   const void* weight, const void* gout,
                                   void* dx, void* doff, int doff_stride,
                                   void* dmsk, int dmsk_stride, void* dw,
                                   int B, int H, int W, int Ci, int Co, int G,
                                   float max_off, int clamp, void* stream) {
  return rvsr::narrow::bwd_entry<__nv_bfloat16>(
      x, off, off_stride, msk, msk_stride, logits, weight, gout, dx, doff,
      doff_stride, dmsk, dmsk_stride, dw, B, H, W, Ci, Co, G, max_off, clamp,
      stream);
}

extern "C" int dcn_narrow_bwd_f32(const void* x, const void* off,
                                  int off_stride, const void* msk,
                                  int msk_stride, int logits,
                                  const void* weight, const void* gout,
                                  void* dx, void* doff, int doff_stride,
                                  void* dmsk, int dmsk_stride, void* dw,
                                  int B, int H, int W, int Ci, int Co, int G,
                                  float max_off, int clamp, void* stream) {
  return rvsr::narrow::bwd_entry<float>(
      x, off, off_stride, msk, msk_stride, logits, weight, gout, dx, doff,
      doff_stride, dmsk, dmsk_stride, dw, B, H, W, Ci, Co, G, max_off, clamp,
      stream);
}
