// Modulated deformable convolution (DCNv2) backward, 3x3 / stride 1 / pad 1,
// NHWC, C input and C output channels in 8 deformable groups, C = 64 or 128
// (template parameter; dcn_narrow.cu takes every other C <= 64), optional
// +-max_offset clamp of the offsets.  Given the output cotangent g (before
// bias and activation: the wrapper undoes those), it computes
//   dS[p, tap, ci] = sum_co g[p, co] W[co, ci, tap]   (rounded to T)
//   dx             = the transpose of the bilinear sampling of dS * mask
//   doffset        = dS * mask . d(sample)/d(position), zero where the clamp
//                    cut the offset (the gate passes on [-R, R] inclusive)
//   dmask          = dS . (unmasked sample); in the in-place form (offsets
//                    and mask logits read from DCNPack's 216-channel tensor,
//                    dcn_sample.cuh) times s (1 - s) of the sigmoid s, as
//                    torch's sigmoid backward in T
//   dW[co, ci, tap] = sum_p g[p, co] S[p, tap, ci]   (S the masked sample)
//
// Replaces the TPU kernel realvsr_tpu/ops/pallas/dcn_frame_kernel.py
// `dcn_frame_fused_bwd` (with its XLA epilogues deform_conv_block.py
// `_fold_dpg` and `_fold_dcoord`, and the sigmoid / concat backward of
// DCNPack's split).  As there, the sampling is recomputed from the inputs
// and no columns are saved.  The TPU kernel's int16 positions, 128-lane
// panels and halo overlap-add exist for its DMA rules and are not carried
// over: positions are exact f32.
//
// Bound on the H100: per pixel it reads x, the offsets and mask and g (64 +
// 216 + 64 elements) and writes dx, the offset and mask gradients (64 +
// 216): ~1.25 KB in bf16, 1.32 ms at 3.35 TB/s at (96, 192, 192); the two
// tap GEMMs (2 x 2 x 576 x 64 flop a pixel) are far below the tensor
// cores' peak.  So it is bound by memory, and in practice by the scatter of
// dx: 4 corners x 8 channels of every (pixel, group, tap).
//
// Design: one launch of persistent blocks, one per SM, each for one
// (deformable group g, run of TH x 32 pixel tiles), TH = 16 in bf16 (512
// threads) and 8 in f32 (256): block i takes group i % 8 and the tiles i / 8, i / 8 + gridDim.x / 8,
// ... (each (group, tile) once; the 8 groups of a tile run side by side, so L2
// merges their rows of the gradients).  Per tile:
// 1. the tile's g (pixels x 64) is staged in shared memory; the group's weight
//    slice W[:, g, :] (64 x 8 x 9) stays there for the whole launch;
// 2. per tap, each warp forms dS for its 32 pixels on the tensor cores
//    (mma.sync m16n8k16 / m16n8k8 TF32: a pixels x 8 x 64 product, too narrow
//    for wgmma's 64-row tiles to pay), rounded to T;
// 3. one thread per pixel samples its 4 corners (16 or 32 bytes each; the next
//    tap's offsets and mask already loaded) and forms the masked sample S,
//    dmask and the two offset gradients (from the four dS . corner sums),
//    written straight to the gradient rows (a 4- or 8-byte pair and one mask
//    value; consecutive lanes write consecutive pixels);
// 4. dx: dS * mask * (corner weight) is added with shared-memory atomics into
//    the tile's footprint for group g, 8 channels a pixel (+1 of padding
//    against bank conflicts).  With the +-R clamp every corner of the tile lies
//    in (TH + 2R + 3) x (32 + 2R + 3) pixels, R = ceil(max_off) up to kRfMax; a
//    corner outside it (no clamp, or R beyond kRfMax) goes straight to dx with
//    two 16-byte global atomics, so the exact op stays exact.  The footprint
//    sums in int32 fixed point: an f32 atomicAdd on shared memory is a compare-
//    and-swap loop (ATOMS.CAST.SPIN), each of its round trips paying the bank
//    conflicts of a random scatter, where the integer add is one native
//    instruction.  The unit is 2^-18 of a power of two above the tile's bound
//    on a contribution, 2 max_p sum_co |g[p, co]| max |W| (x2 covers dS's
//    rounding to T); a contribution above the bound (a mask beyond 1, or
//    anything not finite) takes the global f32 path.  A footprint element takes
//    at most 512 x 9 contributions of at most 2^18 units, so the sum cannot
//    overflow, and each is rounded by at most 2^-19 of the bound.  After the 9
//    taps the footprint is flushed into the f32 dx with one 16-byte atomic per
//    4 channels of each touched pixel (at most ~7 a pixel and group at R = 8
//    and TH = 16, against 72 corner atomics before) and zeroed;
// 5. dW: S goes to shared memory transposed, and each warp adds its share of
//    g^T S (a 16-row co tile x 8 ci x 128 pixels, ldmatrix.trans for g^T) into
//    registers; they hold the block's dW[:, g, :] over all its tiles (36 a
//    thread) and are added to dW with one set of f32 atomics at the end.  So no
//    second launch re-samples the taps.
// dx and dW are summed in f32 (the footprint in fixed point); atomics make the
// order of the f32 sums vary from run to run.
//
// At C = 128 (EDVR-L: nf 128, 16 channels a group, 128 outputs) a second
// kernel, dcn_bwd_kernel128, runs the same pass with these changes; the
// C = 64 kernel above is kept as it was, with its own body, as a shared
// one compiled to other code and cost it 3-11% (chip_smoke.py --ab):
// a. Two threads a pixel, each of 8 of the group's 16 channels: the gather,
//    the blend, the footprint atomics and S of 8 channels are those of C =
//    64; the pair adds its dS . corner sums E_k with one shuffle, and the
//    even thread writes the offset and mask gradients.  The dx footprint
//    holds 16 channels a pixel (+1 of padding: stride 17 ints).
// b. Shared memory and registers: the g tile (pixels x 128) and the
//    16-channel footprint do not fit beside a resident weight at 16 x 32
//    pixels (128 KB + 121 KB at R = 8), and at 8 x 32 pixels two threads a
//    pixel make 512 threads, whose 128 registers each spill 256 bytes.  So
//    the tile is 4 x 32 pixels in both types (256 threads, up to 255
//    registers), and the weight is streamed: the group's 16 x 128 slice of
//    one tap (4.3 KB bf16, 8.4 KB f32) in a ring of two, the next tap's
//    loaded while this one runs, from a copy laid out [ci][tap][co]
//    (TF32-rounded for f32) by a small kernel before the launch.  bf16: 9
//    KB ring + 35 KB g + 8 KB dS + 9 KB S + 80 KB footprint at R = 8 = 140
//    KB; f32: 17 + 68 + 8 + 17 + 80 = 189 KB; one block an SM.
// c. dW: 128 co x 16 ci x 9 taps a group is 18432 sums; they stay in
//    registers with no split of K (the pixels): 16 output tiles of 16 co x
//    8 ci, two a warp (72 registers, at 256 threads a block).
// d. The fixed point: the bound is 2 max_p sum_co |g[p, co]| max |W| over
//    the 128 outputs; a footprint element takes at most one contribution a
//    (pixel, tap) of the tile, 128 x 9 < 2^13, of
//    at most 2^18 units, so the int32 sums cannot overflow (as at C = 64,
//    512 x 9 < 2^13), each rounded by at most 2^-19 of the bound.
// Bound at EDVR-L's L1 training shape (224, 64, 64, 128), bf16: 1,632
// bytes a pixel (x, offsets and mask, g read; dx and the offset and mask
// gradients written), 1.50 GB, 0.45 ms; the two tap GEMMs, 4 x 1152 x 128
// flop a pixel, 541 GFLOP, 0.55 ms at 989 TFLOP/s.
#include "dcn_sample.cuh"
#include "sm90.cuh"

namespace rvsr {
namespace bwd {

constexpr int kTW = 32;       // tile width (pixels)
constexpr int kGroups = 8;    // deformable groups at both widths
constexpr int kRfMax = 8;     // footprint radius at most (shared memory)
// Fixed point of the footprint: a contribution of at most the tile's bound
// is at most 2^kFixBits units; a footprint element takes at most one
// contribution per (pixel, tap) of the tile, at most 512 x 9 = 4608 < 2^13,
// so int32 sums cannot overflow.
constexpr int kFixBits = 31 - 13;

// The instantiation at C input and output channels.  A tile is TH rows of
// kTW pixels, kSplit threads a pixel (8 channels of its group each): 16
// rows in bf16, one 512-thread block per SM (one copy of the group's weight
// and ~50 KB of L1 left for the gathers), 8 in f32, whose g tile takes
// twice the room; 4 rows at C = 128 (256 threads).
template <typename T, int C>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kCpg = C / kGroups;
  static constexpr int kSplit = kCpg / 8;
  static constexpr bool kStream = C > 64;  // the weight streamed per tap
  static constexpr int TH = kStream ? 4 : (kF32 ? 8 : 16);
  static constexpr int kTile = TH * kTW, kThreads = kTile * kSplit;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kFpStride = kCpg + 1;  // ints a footprint pixel
  static constexpr int ldw = C + Traits<T>::kPad;      // sW row: co
  static constexpr int ldg = C + Traits<T>::kPad;      // sG row: co
  static constexpr int lds = kTile + Traits<T>::kPad;  // sS row: pixels
  static constexpr int w_bytes =
      (kStream ? 2 : 9) * kCpg * ldw * (int)sizeof(T);
  static constexpr int g_bytes = kTile * ldg * (int)sizeof(T);
  static constexpr int ds_bytes = kTile * kCpg * 4;
  static constexpr int s_bytes = 2 * kCpg * lds * (int)sizeof(T);
  static constexpr int red_bytes = kWarps * 4;
  static constexpr int fixed = w_bytes + g_bytes + ds_bytes + s_bytes +
                               red_bytes;
  // dW = g^T S: output tiles of 16 co x 8 ci, ci fastest; each warp takes
  // kTPW of them over the pixels of its K part (kKSplit parts)
  static constexpr int kNt = kCpg / 8;
  static constexpr int kOutTiles = (C / 16) * kNt;
  static constexpr int kTPW = kOutTiles > kWarps ? kOutTiles / kWarps : 1;
  static constexpr int kKSplit = kWarps > kOutTiles ? kWarps / kOutTiles : 1;
  static constexpr int kKPart = kTile / kKSplit;  // pixels of a warp's K
  // (C = 128) K steps of dW's loop unrolled at once, and dS's 128-deep K
  // in two unrolled halves, so that the loads the compiler hoists fit
  // beside the accumulators
  static constexpr int kDwUnroll = 4, kDsK = 64;
};

template <typename T, int C>
__host__ __device__ constexpr int footprint_pixels(int rf) {
  return (Layout<T, C>::TH + 2 * rf + 3) * (kTW + 2 * rf + 3);
}

template <typename T, int C>
__host__ __device__ constexpr int smem_bytes(int rf) {
  return Layout<T, C>::fixed +
         footprint_pixels<T, C>(rf) * Layout<T, C>::kFpStride * 4;
}

// blocks per SM, as shared memory allows at kRfMax
template <typename T, int C>
__host__ __device__ constexpr int min_blocks() {
  return 2 * (smem_bytes<T, C>(kRfMax) + 1024) <= 228 * 1024 ? 2 : 1;
}

template <typename T>
struct Params {
  const T* x;
  OffMask<T> om;
  const T* weight;  // (C, C, 3, 3) OIHW
  const T* wt;      // C = 128: the weight as [ci][tap][co], T-rounded
  const T* gout;
  float* dx;
  T* doff;  // offset gradient of pixel 0, rows of doff_stride
  T* dmsk;  // mask (or logit) gradient of pixel 0, rows of dmsk_stride
  int doff_stride, dmsk_stride;
  float* dw;  // (C, 9, C) = (cout, tap, cin)
  int H, W, clamp, rf;
  float max_off;
  int tiles_x, tiles_y, ntiles;
};

// The weight as [ci][tap][co], each value rounded as the tensor cores take
// it: one tap of a group is then 16 rows of C contiguous values.
template <typename T>
__global__ void prep_weight_kernel(const T* __restrict__ w,
                                   T* __restrict__ wt, int C) {
  const int total = C * C * 9;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int co = e % C, r = e / C, tap = r % 9, ci = r / 9;
    wt[e] = Traits<T>::to_mma(Traits<T>::to_f(w[(co * C + ci) * 9 + tap]));
  }
}

// round(v) for |v| < 2^22, through the float adder: v + 1.5 * 2^23 has
// exponent 23, so its mantissa holds v rounded to an integer (F2I runs at a
// quarter of the FMA rate).
__device__ __forceinline__ int to_fixed(float v) {
  return __float_as_int(v + 12582912.f) - 0x4B400000;
}

// The largest of each thread's v over the block (v >= 0), through red.
template <int kWarps>
__device__ __forceinline__ float block_max(float v, float* red, int warp,
                                           int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

// The offset and mask gradients of (a pixel, its group, tap) from the
// dS . corner sums E_k of the group's channels.
template <typename T>
__device__ __forceinline__ void grads_of(const Corners& c, const float (&E)[4],
                                         float m, int logits, float& gy,
                                         float& gx, float& gm) {
  using Tr = Traits<T>;
  const float dm = c.cw[0] * E[0] + c.cw[1] * E[1] + c.cw[2] * E[2] +
                   c.cw[3] * E[3];
  const float dty = m * ((1.f - c.tx) * (E[2] - E[0]) + c.tx * (E[3] - E[1]));
  const float dtx = m * ((1.f - c.ty) * (E[1] - E[0]) + c.ty * (E[3] - E[2]));
  gy = c.pass_y ? dty : 0.f;
  gx = c.pass_x ? dtx : 0.f;
  gm = Tr::to_f(Tr::from_f(dm));
  if (logits) gm = gm * (1.f - m) * m;
}

template <typename T>
__device__ __forceinline__ void write_grads(T* od, T* md, float gy, float gx,
                                            float gm) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(od) = make_float2(gy, gx);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(od) = __floats2bfloat162_rn(gy, gx);
  }
  *md = Traits<T>::from_f(gm);
}

// Steps 2-4 for 8 channels [ch0, ch0 + 8) of a pixel at one tap: gather
// and blend its corners, add dS . corner k to E[k], put the masked sample
// in S, and add dS * mask * (corner weight) to the dx footprint (fixed
// point, fp0: this thread's channels of footprint pixel 0) or, outside it
// or above the tile's bound, to dx in f32.
template <typename T, int C>
__device__ __forceinline__ void pixel_tap(const Params<T>& p,
                                          const Corners& c, const float* dsp,
                                          float m, int ch0, int fy0, int fx0,
                                          int fh, int fw, float to_fix,
                                          float lim, int* fp0, int fp_stride,
                                          float (&E)[4], float (&S)[8]) {
  GroupCorners<T, 8> e;
  gather<T, C, 8>(e, p.x, c, ch0);
  const float4 d0 = *reinterpret_cast<const float4*>(dsp);
  const float4 d1 = *reinterpret_cast<const float4*>(dsp + 4);
  const float ds[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
  float val[8];
  blend(val, e, c);
  // E_k = dS . (corner k): dmask = sum_k w_k E_k, and the position
  // gradients are m times differences of the E_k (one-sided at integer
  // positions, ty = 0: v(y0 + 1) - v(y0))
  float dv[8], amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) E[k] += ds[i] * corner_value(e, k, i);
    dv[i] = ds[i] * m;
    amax = fmaxf(amax, fabsf(dv[i]));
    S[i] = val[i] * m;
  }
  float dvq[8];  // dv in the footprint's fixed-point units
#pragma unroll
  for (int i = 0; i < 8; ++i) dvq[i] = dv[i] * to_fix;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!c.valid[k]) continue;
    const float w = c.cw[k];
    const int cy = c.y0 + (k >> 1) - fy0, cx = c.x0 + (k & 1) - fx0;
    if (cy >= 0 && cy < fh && cx >= 0 && cx < fw && amax * w <= lim) {
      int* f = fp0 + (cy * fw + cx) * fp_stride;
#pragma unroll
      for (int i = 0; i < 8; ++i) atomicAdd(f + i, to_fixed(dvq[i] * w));
    } else {
      float4* d = reinterpret_cast<float4*>(p.dx + (size_t)c.pix[k] * C + ch0);
      atomicAdd(d, make_float4(dv[0] * w, dv[1] * w, dv[2] * w, dv[3] * w));
      atomicAdd(d + 1,
                make_float4(dv[4] * w, dv[5] * w, dv[6] * w, dv[7] * w));
    }
  }
}

// C = 128: group g's weight of one tap from wt into a ring slot
// [ci][ldw], 16-byte copies.
template <typename T, int C>
__device__ __forceinline__ void stage_w_tap(T* slot, const T* wt, int g,
                                            int tap) {
  using L = Layout<T, C>;
  constexpr int V = Traits<T>::kVec, NV = C / V;
  for (int i = threadIdx.x; i < L::kCpg * NV; i += L::kThreads) {
    const int ci = i / NV, v = i - ci * NV;
    *reinterpret_cast<uint4*>(slot + ci * L::ldw + v * V) =
        __ldg(reinterpret_cast<const uint4*>(
            wt + ((size_t)(g * L::kCpg + ci) * 9 + tap) * C + v * V));
  }
}

// C = 64: one thread a pixel, the weight resident (the design above).
template <typename T>
__global__ void __launch_bounds__(Layout<T, 64>::kThreads,
                                  (min_blocks<T, 64>()))
    dcn_bwd_kernel64(const __grid_constant__ Params<T> p) {
  using Tr = Traits<T>;
  using L = Layout<T, 64>;
  constexpr int kDcnC = 64, kDcnCpg = L::kCpg, kFpStride = L::kFpStride;
  constexpr int kKPart = L::kKPart;
  constexpr int kTH = L::TH, kTile = L::kTile, kThreads = kTile;
  constexpr int kWarps = L::kWarps;
  constexpr int V = Tr::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sW = reinterpret_cast<T*>(smem);  // [tap][ci][co]
  T* sG = reinterpret_cast<T*>(smem + L::w_bytes);  // [pixel][co]
  float* sDS = reinterpret_cast<float*>(smem + L::w_bytes + L::g_bytes);
  T* sS = reinterpret_cast<T*>(smem + L::w_bytes + L::g_bytes +
                               L::ds_bytes);  // [2][ci][pixel]
  float* sRed = reinterpret_cast<float*>(smem + L::fixed - L::red_bytes);
  int* fp = reinterpret_cast<int*>(smem + L::fixed);  // [fy][fx][9]

  const int g = blockIdx.x % kGroups;
  const int slot = blockIdx.x / kGroups;
  const int nslots = gridDim.x / kGroups;
  const int fh = kTH + 2 * p.rf + 3, fw = kTW + 2 * p.rf + 3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = p.H, W = p.W;

  float wmax = 0.f;
  for (int i = tid; i < 9 * kDcnCpg * kDcnC; i += kThreads) {
    const int co = i % kDcnC, ci = (i / kDcnC) % kDcnCpg,
              tap = i / (kDcnC * kDcnCpg);
    const T v = Tr::to_mma(
        Tr::to_f(p.weight[(co * kDcnC + g * kDcnCpg + ci) * 9 + tap]));
    sW[(tap * kDcnCpg + ci) * L::ldw + co] = v;
    wmax = fmaxf(wmax, fabsf(Tr::to_f(v)));
  }
  for (int i = tid; i < fh * fw * kFpStride; i += kThreads) fp[i] = 0;
  wmax = block_max<kWarps>(wmax, sRed, warp, lane);  // also orders sW, fp

  // dW[co][tap][g * 8 + ci] partial sums: co = 16 (warp & 3) + lane / 4
  // (+ 8), ci = 2 (lane & 3) (+ 1), over pixels of half (warp >> 2)
  float accw[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) accw[t][j] = 0.f;
  const int ly = tid / kTW, lx = tid % kTW;  // this thread's pixel

  for (int tile = slot; tile < p.ntiles; tile += nslots) {
    const int tcol = tile % p.tiles_x, rest = tile / p.tiles_x;
    const int trow = rest % p.tiles_y, b = rest / p.tiles_y;
    const int y = trow * kTH + ly, x = tcol * kTW + lx;
    const bool ok = y < H && x < W;
    const int pix = ok ? (b * H + y) * W + x : 0;
    const int fy0 = trow * kTH - 1 - p.rf, fx0 = tcol * kTW - 1 - p.rf;

    for (int i = tid; i < kTile * (kDcnC / V); i += kThreads) {
      const int r = i / (kDcnC / V), v = i % (kDcnC / V);
      const int yy = trow * kTH + r / kTW, xx = tcol * kTW + r % kTW;
      float e[V];
      if (yy < H && xx < W) {
        load_vec<T>(p.gout + (size_t)((b * H + yy) * W + xx) * kDcnC + v * V,
                    e);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) e[j] = 0.f;
      }
      store_vec_mma<T>(sG + r * L::ldg + v * V, e);
    }
    __syncthreads();
    // The tile's bound on |dS| (rounding to T included: the factor 2):
    // |dS[p, tap, ci]| <= sum_co |g[p, co]| max |W|.  It sets the fixed
    // point's scale, a power of two.
    float gsum = 0.f;
#pragma unroll 8
    for (int co = 0; co < kDcnC; ++co)
      gsum += fabsf(Tr::to_f(sG[tid * L::ldg + co]));
    const float bound =
        2.f * block_max<kWarps>(gsum, sRed, warp, lane) * wmax;
    int ex;
    frexpf(bound, &ex);  // bound <= 2^ex
    const bool fixed_ok = bound > 0.f && bound <= 3.0e38f;
    const float to_fix = fixed_ok ? ldexpf(1.f, kFixBits - ex) : 0.f;
    const float lim = fixed_ok ? bound : -1.f;  // else all go global

    // tap t + 1's offsets and mask are loaded while tap t runs
    float n_dy = 0.f, n_dx = 0.f, n_m = 0.f;
    if (ok) load_off_mask(p.om, pix, g, 0, n_dy, n_dx, n_m);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float dy = n_dy, dx = n_dx, m = n_m;
      if (ok && tap < 8) load_off_mask(p.om, pix, g, tap + 1, n_dy, n_dx, n_m);
      // 1. dS for the warp's 32 pixels (its own threads' pixels)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = warp * 32 + mt * 16 + (lane >> 2);
        float c[1][4] = {{0.f, 0.f, 0.f, 0.f}};
        warp_mma<T, 1>(c, sG + r * L::ldg, sG + (r + 8) * L::ldg,
                       sW + tap * kDcnCpg * L::ldw, L::ldw, kDcnC, lane);
        // rounded to T, as autograd of the plain op rounds it through the
        // cast of the columns
        const int col = 2 * (lane & 3);
        *reinterpret_cast<float2*>(sDS + r * kDcnCpg + col) = make_float2(
            Tr::to_f(Tr::from_f(c[0][0])), Tr::to_f(Tr::from_f(c[0][1])));
        *reinterpret_cast<float2*>(sDS + (r + 8) * kDcnCpg + col) =
            make_float2(Tr::to_f(Tr::from_f(c[0][2])),
                        Tr::to_f(Tr::from_f(c[0][3])));
      }
      __syncwarp();

      // 2.-4. this thread's pixel
      float S[kDcnCpg];
#pragma unroll
      for (int i = 0; i < kDcnCpg; ++i) S[i] = 0.f;
      if (ok) {
        const Corners c =
            corners(dy, dx, pix, y, x, tap, H, W, p.max_off, p.clamp);
        GroupCorners<T, kDcnCpg> e;
        gather<T, kDcnC, kDcnCpg>(e, p.x, c, g * kDcnCpg);
        const float4 d0 = *reinterpret_cast<const float4*>(sDS + tid * 8);
        const float4 d1 = *reinterpret_cast<const float4*>(sDS + tid * 8 + 4);
        const float ds[kDcnCpg] = {d0.x, d0.y, d0.z, d0.w,
                                   d1.x, d1.y, d1.z, d1.w};
        float val[kDcnCpg];
        blend(val, e, c);
        // E_k = dS . (corner k): dmask = sum_k w_k E_k, and the position
        // gradients are m times differences of the E_k (one-sided at
        // integer positions, ty = 0: v(y0 + 1) - v(y0))
        float E[4] = {0.f, 0.f, 0.f, 0.f}, dv[kDcnCpg], amax = 0.f;
#pragma unroll
        for (int i = 0; i < kDcnCpg; ++i) {
#pragma unroll
          for (int k = 0; k < 4; ++k) E[k] += ds[i] * corner_value(e, k, i);
          dv[i] = ds[i] * m;
          amax = fmaxf(amax, fabsf(dv[i]));
          S[i] = val[i] * m;
        }
        const float dm = c.cw[0] * E[0] + c.cw[1] * E[1] + c.cw[2] * E[2] +
                         c.cw[3] * E[3];
        const float dty =
            m * ((1.f - c.tx) * (E[2] - E[0]) + c.tx * (E[3] - E[1]));
        const float dtx =
            m * ((1.f - c.ty) * (E[1] - E[0]) + c.ty * (E[3] - E[2]));
        float dvq[kDcnCpg];  // dv in the footprint's fixed-point units
#pragma unroll
        for (int i = 0; i < kDcnCpg; ++i) dvq[i] = dv[i] * to_fix;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!c.valid[k]) continue;
          const float w = c.cw[k];
          const int cy = c.y0 + (k >> 1) - fy0, cx = c.x0 + (k & 1) - fx0;
          if (cy >= 0 && cy < fh && cx >= 0 && cx < fw && amax * w <= lim) {
            int* f = fp + (cy * fw + cx) * kFpStride;
#pragma unroll
            for (int i = 0; i < kDcnCpg; ++i)
              atomicAdd(f + i, to_fixed(dvq[i] * w));
          } else {
            float4* d = reinterpret_cast<float4*>(
                p.dx + (size_t)c.pix[k] * kDcnC + g * kDcnCpg);
            atomicAdd(d, make_float4(dv[0] * w, dv[1] * w, dv[2] * w,
                                     dv[3] * w));
            atomicAdd(d + 1, make_float4(dv[4] * w, dv[5] * w, dv[6] * w,
                                         dv[7] * w));
          }
        }
        const float gy = c.pass_y ? dty : 0.f, gx = c.pass_x ? dtx : 0.f;
        T* od = p.doff + (size_t)pix * p.doff_stride + g * 18 + 2 * tap;
        if constexpr (std::is_same<T, float>::value) {
          *reinterpret_cast<float2*>(od) = make_float2(gy, gx);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(od) =
              __floats2bfloat162_rn(gy, gx);
        }
        float gm = Tr::to_f(Tr::from_f(dm));
        if (p.om.logits) gm = gm * (1.f - m) * m;
        p.dmsk[(size_t)pix * p.dmsk_stride + g * 9 + tap] = Tr::from_f(gm);
      }
      T* sSb = sS + (tap & 1) * kDcnCpg * L::lds;
#pragma unroll
      for (int i = 0; i < kDcnCpg; ++i)
        sSb[i * L::lds + tid] = Tr::to_mma(S[i]);
      __syncthreads();

      // 5. dW[:, tap] += g^T S over this warp's half of the pixels
      const int m0 = 16 * (warp & 3), k00 = (warp >> 2) * kKPart;
      const int gq = lane >> 2, t4 = lane & 3;
      if constexpr (std::is_same<T, float>::value) {
#pragma unroll
        for (int k0 = k00; k0 < k00 + kKPart; k0 += 8) {
          const float* r0 = sG + (k0 + t4) * L::ldg + m0 + gq;
          const float* r1 = sG + (k0 + t4 + 4) * L::ldg + m0 + gq;
          const float* bs = sSb + gq * L::lds + k0 + t4;
          mma_tf32(accw[tap], __float_as_uint(r0[0]), __float_as_uint(r0[8]),
                   __float_as_uint(r1[0]), __float_as_uint(r1[8]),
                   __float_as_uint(bs[0]), __float_as_uint(bs[4]));
        }
      } else {
        const int mi = lane >> 3;  // which 8 x 8 matrix this lane addresses
#pragma unroll
        for (int k0 = k00; k0 < k00 + kKPart; k0 += 16) {
          uint32_t a[4];
          ldmatrix_x4_trans(
              a, smem_u32(sG + (k0 + (lane & 7) + 8 * (mi >> 1)) * L::ldg +
                          m0 + 8 * (mi & 1)));
          const T* bs = sSb + gq * L::lds + k0 + 2 * t4;
          mma_bf16(accw[tap], a[0], a[1], a[2], a[3], ld32(bs),
                   ld32(bs + 8));
        }
      }
    }
    // every footprint atomic and every read of sG and sS done
    __syncthreads();

    // flush the footprint into dx (only what was touched) and zero it
    const float from_fix = fixed_ok ? ldexpf(1.f, ex - kFixBits) : 0.f;
    for (int i = tid; i < fh * fw * 2; i += kThreads) {
      const int q = i >> 1, h = i & 1;
      int* f = fp + q * kFpStride + 4 * h;
      const int v0 = f[0], v1 = f[1], v2 = f[2], v3 = f[3];
      if (v0 | v1 | v2 | v3) {
        // only corners inside the image were added
        const int yy = fy0 + q / fw, xx = fx0 + q % fw;
        atomicAdd(reinterpret_cast<float4*>(
                      p.dx + (size_t)((b * H + yy) * W + xx) * kDcnC +
                      g * kDcnCpg + 4 * h),
                  make_float4(v0 * from_fix, v1 * from_fix, v2 * from_fix,
                              v3 * from_fix));
        f[0] = f[1] = f[2] = f[3] = 0;
      }
    }
    // the next tile's __syncthreads (after its g tile) orders these zeros
    // before its footprint atomics
  }

  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = 16 * (warp & 3) + gq + 8 * (j >> 1);
      const int ci = 2 * t4 + (j & 1);
      atomicAdd(p.dw + (co * 9 + tap) * kDcnC + g * kDcnCpg + ci,
                accw[tap][j]);
    }
}

// C = 128: two threads a pixel, the weight streamed (a-d above).
template <typename T>
__global__ void __launch_bounds__(Layout<T, 128>::kThreads,
                                  (min_blocks<T, 128>()))
    dcn_bwd_kernel128(const __grid_constant__ Params<T> p) {
  using Tr = Traits<T>;
  constexpr int C = 128;
  using L = Layout<T, C>;
  constexpr int kTH = L::TH, kTile = L::kTile, kThreads = L::kThreads;
  constexpr int kWarps = L::kWarps, CPG = L::kCpg, NSPLIT = L::kSplit;
  constexpr int V = Tr::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sW = reinterpret_cast<T*>(smem);  // [tap or ring slot][ci][co]
  T* sG = reinterpret_cast<T*>(smem + L::w_bytes);  // [pixel][co]
  float* sDS = reinterpret_cast<float*>(smem + L::w_bytes + L::g_bytes);
  T* sS = reinterpret_cast<T*>(smem + L::w_bytes + L::g_bytes +
                               L::ds_bytes);  // [2][ci][pixel]
  float* sRed = reinterpret_cast<float*>(smem + L::fixed - L::red_bytes);
  int* fp = reinterpret_cast<int*>(smem + L::fixed);  // [fy][fx][CPG + 1]

  const int g = blockIdx.x % kGroups;
  const int slot = blockIdx.x / kGroups;
  const int nslots = gridDim.x / kGroups;
  const int fh = kTH + 2 * p.rf + 3, fw = kTW + 2 * p.rf + 3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = p.H, W = p.W;

  float wmax = 0.f;
  const T* wg = p.wt + (size_t)g * CPG * 9 * C;  // the group's rows of wt
  for (int i = tid; i < CPG * 9 * C; i += kThreads)
    wmax = fmaxf(wmax, fabsf(Tr::to_f(wg[i])));
  for (int i = tid; i < fh * fw * L::kFpStride; i += kThreads) fp[i] = 0;
  wmax = block_max<kWarps>(wmax, sRed, warp, lane);  // also orders sW, fp

  // dW[co][tap][g * CPG + ci] partial sums of this warp's output tiles (co
  // = m0 + lane / 4 (+ 8), ci = n0 + 2 (lane & 3) (+ 1)) over the pixels
  // of its K part
  constexpr int kWarpsPerK = L::kOutTiles / L::kTPW;
  const int tile0 = (int)((unsigned)warp % kWarpsPerK) * L::kTPW;
  const int k00 = (int)((unsigned)warp / kWarpsPerK) * L::kKPart;
  float accw[L::kTPW][9][4];
#pragma unroll
  for (int j = 0; j < L::kTPW; ++j)
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) accw[j][t][e] = 0.f;
  // this thread's pixel, and its 8 channels of the group
  const int q = tid / NSPLIT, sub = tid % NSPLIT;
  const int ly = q / kTW, lx = q % kTW;
  const int ch0 = g * CPG + 8 * sub;
  for (int tile = slot; tile < p.ntiles; tile += nslots) {
    const int tcol = tile % p.tiles_x, rest = tile / p.tiles_x;
    const int trow = rest % p.tiles_y, b = rest / p.tiles_y;
    const int y = trow * kTH + ly, x = tcol * kTW + lx;
    const bool ok = y < H && x < W;
    const int pix = ok ? (b * H + y) * W + x : 0;
    const int fy0 = trow * kTH - 1 - p.rf, fx0 = tcol * kTW - 1 - p.rf;

    for (int i = tid; i < kTile * (C / V); i += kThreads) {
      const int r = i / (C / V), v = i % (C / V);
      const int yy = trow * kTH + r / kTW, xx = tcol * kTW + r % kTW;
      float e[V];
      if (yy < H && xx < W) {
        load_vec<T>(p.gout + (size_t)((b * H + yy) * W + xx) * C + v * V, e);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) e[j] = 0.f;
      }
      store_vec_mma<T>(sG + r * L::ldg + v * V, e);
    }
    stage_w_tap<T, C>(sW, p.wt, g, 0);
    __syncthreads();
    // The tile's bound on |dS| (rounding to T included: the factor 2):
    // |dS[p, tap, ci]| <= sum_co |g[p, co]| max |W|.  It sets the fixed
    // point's scale, a power of two.
    float gsum = 0.f;
#pragma unroll 8
    for (int co = 0; co < C; ++co)
      gsum += fabsf(Tr::to_f(sG[q * L::ldg + co]));
    const float bound =
        2.f * block_max<kWarps>(gsum, sRed, warp, lane) * wmax;
    int ex;
    frexpf(bound, &ex);  // bound <= 2^ex
    const bool fixed_ok = bound > 0.f && bound <= 3.0e38f;
    const float to_fix = fixed_ok ? ldexpf(1.f, kFixBits - ex) : 0.f;
    const float lim = fixed_ok ? bound : -1.f;  // else all go global

    // tap t + 1's offsets and mask are loaded while tap t runs
    float n_dy = 0.f, n_dx = 0.f, n_m = 0.f;
    if (ok) load_off_mask(p.om, pix, g, 0, n_dy, n_dx, n_m);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float dy = n_dy, dx = n_dx, m = n_m;
      if (ok && tap < 8) load_off_mask(p.om, pix, g, tap + 1, n_dy, n_dx, n_m);
      // 1. dS for the warp's pixels (its own threads' pixels)
      const T* sWt = sW + (tap & 1) * CPG * L::ldw;
#pragma unroll
      for (int mt = 0; mt < 2 / NSPLIT; ++mt) {
        const int r = warp * (32 / NSPLIT) + mt * 16 + (lane >> 2);
        float c[L::kNt][4];
#pragma unroll
        for (int nt = 0; nt < L::kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll 1
        for (int k0 = 0; k0 < C; k0 += L::kDsK)
          warp_mma<T, L::kNt>(c, sG + r * L::ldg + k0,
                              sG + (r + 8) * L::ldg + k0, sWt + k0, L::ldw,
                              L::kDsK, lane);
        // rounded to T, as autograd of the plain op rounds it through the
        // cast of the columns
#pragma unroll
        for (int nt = 0; nt < L::kNt; ++nt) {
          const int col = 8 * nt + 2 * (lane & 3);
          *reinterpret_cast<float2*>(sDS + r * CPG + col) =
              make_float2(Tr::to_f(Tr::from_f(c[nt][0])),
                          Tr::to_f(Tr::from_f(c[nt][1])));
          *reinterpret_cast<float2*>(sDS + (r + 8) * CPG + col) =
              make_float2(Tr::to_f(Tr::from_f(c[nt][2])),
                          Tr::to_f(Tr::from_f(c[nt][3])));
        }
      }
      __syncwarp();
      // the next tap's weight into the other slot: its last reader, tap
      // - 1's dS, is behind the last __syncthreads
      if (tap < 8)
        stage_w_tap<T, C>(sW + ((tap + 1) & 1) * CPG * L::ldw, p.wt, g,
                          tap + 1);

      // 2.-4. this thread's pixel and 8 channels
      float S[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) S[i] = 0.f;
      {  // the pair of threads of a pixel
        float E[4] = {0.f, 0.f, 0.f, 0.f};
        Corners c;
        if (ok) {
          c = corners(dy, dx, pix, y, x, tap, H, W, p.max_off, p.clamp);
          pixel_tap<T, C>(p, c, sDS + q * CPG + 8 * sub, m, ch0, fy0, fx0,
                          fh, fw, to_fix, lim, fp + 8 * sub, L::kFpStride, E,
                          S);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) E[k] += __shfl_xor_sync(~0u, E[k], 1);
        if (ok && sub == 0) {
          float gy, gx, gm;
          grads_of<T>(c, E, m, p.om.logits, gy, gx, gm);
          write_grads(p.doff + (size_t)pix * p.doff_stride + g * 18 + 2 * tap,
                      p.dmsk + (size_t)pix * p.dmsk_stride + g * 9 + tap, gy,
                      gx, gm);
        }
      }
      T* sSb = sS + (tap & 1) * CPG * L::lds;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sSb[(8 * sub + i) * L::lds + q] = Tr::to_mma(S[i]);
      __syncthreads();

      // 5. dW[:, tap] += g^T S over this warp's K part, for its tiles
      const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
      for (int j = 0; j < L::kTPW; ++j) {
        const int ot = tile0 + j;
        const int m0 = 16 * (ot / L::kNt), n0 = 8 * (ot % L::kNt);
        if constexpr (std::is_same<T, float>::value) {
#pragma unroll(L::kDwUnroll)
          for (int k0 = k00; k0 < k00 + L::kKPart; k0 += 8) {
            const float* r0 = sG + (k0 + t4) * L::ldg + m0 + gq;
            const float* r1 = sG + (k0 + t4 + 4) * L::ldg + m0 + gq;
            const float* bs = sSb + (n0 + gq) * L::lds + k0 + t4;
            mma_tf32(accw[j][tap], __float_as_uint(r0[0]),
                     __float_as_uint(r0[8]), __float_as_uint(r1[0]),
                     __float_as_uint(r1[8]), __float_as_uint(bs[0]),
                     __float_as_uint(bs[4]));
          }
        } else {
          const int mi = lane >> 3;  // which 8 x 8 matrix this lane addresses
#pragma unroll(L::kDwUnroll)
          for (int k0 = k00; k0 < k00 + L::kKPart; k0 += 16) {
            uint32_t a[4];
            ldmatrix_x4_trans(
                a, smem_u32(sG + (k0 + (lane & 7) + 8 * (mi >> 1)) * L::ldg +
                            m0 + 8 * (mi & 1)));
            const T* bs = sSb + (n0 + gq) * L::lds + k0 + 2 * t4;
            mma_bf16(accw[j][tap], a[0], a[1], a[2], a[3], ld32(bs),
                     ld32(bs + 8));
          }
        }
      }
    }
    // every footprint atomic and every read of sG and sS done
    __syncthreads();

    // flush the footprint into dx (only what was touched) and zero it
    constexpr int kQ = CPG / 8;  // log2 of the 4-channel quarters a pixel
    const float from_fix = fixed_ok ? ldexpf(1.f, ex - kFixBits) : 0.f;
    for (int i = tid; i < (fh * fw << kQ); i += kThreads) {
      const int qq = i >> kQ, h = i & ((1 << kQ) - 1);
      int* f = fp + qq * L::kFpStride + 4 * h;
      const int v0 = f[0], v1 = f[1], v2 = f[2], v3 = f[3];
      if (v0 | v1 | v2 | v3) {
        // only corners inside the image were added
        const int yy = fy0 + qq / fw, xx = fx0 + qq % fw;
        atomicAdd(reinterpret_cast<float4*>(
                      p.dx + (size_t)((b * H + yy) * W + xx) * C +
                      g * CPG + 4 * h),
                  make_float4(v0 * from_fix, v1 * from_fix, v2 * from_fix,
                              v3 * from_fix));
        f[0] = f[1] = f[2] = f[3] = 0;
      }
    }
    // the next tile's __syncthreads (after its g tile) orders these zeros
    // before its footprint atomics
  }

  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < L::kTPW; ++j) {
    const int ot = tile0 + j;
    const int m0 = 16 * (ot / L::kNt), n0 = 8 * (ot % L::kNt);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = m0 + gq + 8 * (e >> 1);
        const int ci = n0 + 2 * t4 + (e & 1);
        atomicAdd(p.dw + (co * 9 + tap) * C + g * CPG + ci, accw[j][tap][e]);
      }
  }
}

// Error codes of the host side, beside cudaGetLastError()'s.
constexpr int kErrRadius = 9101;
constexpr int kErrWidth = 9102;

template <typename T, int C>
int launch_c(Params<T> p, int B, int rf, void* stream) {
  using L = Layout<T, C>;
  if constexpr (L::kStream) {
    prep_weight_kernel<T><<<(C * C * 9 + 255) / 256, 256, 0,
                            (cudaStream_t)stream>>>(p.weight, (T*)p.wt, C);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  p.tiles_x = (p.W + kTW - 1) / kTW;
  p.tiles_y = (p.H + L::TH - 1) / L::TH;
  p.ntiles = B * p.tiles_x * p.tiles_y;
  auto kernel = C == 64 ? dcn_bwd_kernel64<T> : dcn_bwd_kernel128<T>;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes<T, C>(kRfMax));
    attribute_set = true;
  }
  const int cap = min_blocks<T, C>() * sm_count() / kGroups;
  const int slots = p.ntiles < cap ? p.ntiles : cap;
  if (slots > 0)
    kernel<<<slots * kGroups, L::kThreads, smem_bytes<T, C>(rf),
             (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int entry(const void* x, const void* off, int off_stride, const void* msk,
          int msk_stride, int logits, const void* weight, void* wt,
          const void* gout, void* dx, void* doff, int doff_stride, void* dmsk,
          int dmsk_stride, void* dw, int B, int H, int W, int C,
          float max_off, int clamp, int rf, void* stream) {
  if (rf < 0 || rf > kRfMax) return kErrRadius;
  if (C != 64 && (C != 128 || wt == nullptr)) return kErrWidth;
  Params<T> p;
  p.x = (const T*)x;
  p.om = OffMask<T>{(const T*)off, (const T*)msk, off_stride, msk_stride,
                    logits};
  p.weight = (const T*)weight;
  p.wt = (const T*)wt;
  p.gout = (const T*)gout;
  p.dx = (float*)dx;
  p.doff = (T*)doff;
  p.dmsk = (T*)dmsk;
  p.doff_stride = doff_stride;
  p.dmsk_stride = dmsk_stride;
  p.dw = (float*)dw;
  p.H = H, p.W = W, p.clamp = clamp, p.rf = rf, p.max_off = max_off;
  return C == 64 ? launch_c<T, 64>(p, B, rf, stream)
                 : launch_c<T, 128>(p, B, rf, stream);
}

}  // namespace bwd
}  // namespace rvsr

// x (B,H,W,C), C = 64 or 128 in 8 deformable groups; offsets and mask as
// dcn_fwd.cu reads them (strides, and logits != 0 for the mask's logits);
// weight (C, C, 3, 3) OIHW; wt: scratch of C * 9 * C elements (C = 128: the
// weight laid out [ci][tap][co] there first; may be null at C = 64); gout
// (B,H,W,C) the cotangent of the output before bias and activation.
// Outputs: dx (B,H,W,C) f32 and dw (C, 9, C) = (cout, tap, cin) f32, both
// summed with atomics and so zeroed by the caller; the offset gradient at
// doff + p * doff_stride and the mask gradient (the logits' where
// logits != 0) at dmsk + p * dmsk_stride, in the input type.  clamp != 0
// clips every offset to [-max_off, max_off] and zeroes the offset gradient
// beyond it.  rf: the dx footprint's radius (0 ... 8; ceil(max_off) where
// that fits).  Returns cudaGetLastError(), or 9101 (rf out of range), 9102
// (another C).
extern "C" int dcn_bwd_bf16(const void* x, const void* off, int off_stride,
                            const void* msk, int msk_stride, int logits,
                            const void* weight, void* wt, const void* gout,
                            void* dx, void* doff, int doff_stride, void* dmsk,
                            int dmsk_stride, void* dw, int B, int H, int W,
                            int C, float max_off, int clamp, int rf,
                            void* stream) {
  return rvsr::bwd::entry<__nv_bfloat16>(
      x, off, off_stride, msk, msk_stride, logits, weight, wt, gout, dx, doff,
      doff_stride, dmsk, dmsk_stride, dw, B, H, W, C, max_off, clamp, rf,
      stream);
}

extern "C" int dcn_bwd_f32(const void* x, const void* off, int off_stride,
                           const void* msk, int msk_stride, int logits,
                           const void* weight, void* wt, const void* gout,
                           void* dx, void* doff, int doff_stride, void* dmsk,
                           int dmsk_stride, void* dw, int B, int H, int W,
                           int C, float max_off, int clamp, int rf,
                           void* stream) {
  return rvsr::bwd::entry<float>(x, off, off_stride, msk, msk_stride, logits,
                                 weight, wt, gout, dx, doff, doff_stride, dmsk,
                                 dmsk_stride, dw, B, H, W, C, max_off, clamp,
                                 rf, stream);
}
