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
// kernel, dcn_bwd_kernel128, runs the same function with another design;
// the C = 64 kernel above keeps its own body, as a shared one compiled to
// other code and cost it 3-11% (chip_smoke.py --ab).  What held the first
// C = 128 design back (inferred from the code: no profiler runs on the
// card's machine): 4 x 32 tiles, whose (4 + 19) x (32 + 19) footprint at
// R = 8 is ~9 pixels a tile pixel to zero and flush; 8 warps an SM, each
// sampling and then running dS and dW on mma.sync between two
// __syncthreads a tap, so little hid the gathers' latency; g staged
// through registers by each of a tile's 8 group blocks; 128 of 132 SMs.
// The redesign:
// a. Warp roles, the registers split by setmaxnreg: TH / 2 sampling
//    warpgroups (two threads a pixel, 8 of its group's 16 channels each:
//    the gather, the blend, E, S and the footprint atomics of C = 64's
//    body) at kSampRegs registers, and one MMA warpgroup at kMmaRegs that
//    holds the block's dW (144 f32 a thread) and computes dS.  They hand
//    dS and S over in rings of two slots on mbarriers (ds_full, s_full,
//    s_empty; every wait with kWatchdog), so the sampling warps wait for a
//    product only when the MMA warpgroup falls behind: dS of tap t + 1 is
//    made while tap t samples, dW of tap t - 1 after its S is in.
// b. Tiles of TH x 32: 6 rows in bf16 (192 pixels, 12 sampling warps;
//    footprint 25 x 51 at R = 8, 6.6 pixels a tile pixel), 4 in f32 (its g
//    tile twice the bytes; 8 sampling warps).
// c. The cotangent tile comes by TMA (a 128-byte channel chunk of TH x 32
//    pixels a copy, swizzled, zeros outside the image): no register round
//    trip, and a tile's re-reads by the other 7 groups cost the memory
//    system only.  One buffer: the next item's tile is copied once this
//    one's dW is done, while the sampling warps flush their footprint; a
//    second buffer would take shared memory that L1 gives the gathers
//    (bf16 with two: 9.07 ms against 8.40 at EDVR-L's L1 training shape,
//    chip run, the H100 at 700 W).
// d. dS = g W_tap on wgmma m64n16 with both operands in shared memory: A
//    the g tile (K-major, a descriptor per chunk and 64-pixel m-tile), B
//    the group's weight tap [ci][co] laid out and swizzled by
//    prep_weight_kernel (4 KB bf16 / 8 KB f32, one bulk copy a tap into a
//    ring of kWs), rounded to T into the dS slot.  In f32 the tensor cores
//    read g as TMA wrote it, i.e. as TF32 with the low 13 bits dropped
//    (relative error <= 2^-10 against rounding's 2^-11; well inside
//    check.py's 5e-3).  dW = g^T S on mma.sync (m16n8k16, m16n8k8 TF32):
//    g^T by ldmatrix.trans from the swizzled tile (f32: four loads,
//    TF32-rounded), S from its slot.  TF32 cannot take a transposed A on
//    wgmma, and a per-tap N of 16 leaves wgmma little to gain over
//    mma.sync in a warpgroup that does nothing else.
// e. The producer is the MMA warpgroup's first thread, not a warp of its
//    own: that warpgroup is the only reader of the weight taps and the
//    last reader of each g tile (the sampling warps read it for the bound
//    before they hand over tap 0's S), and it frees each slot at a known
//    point (a named barrier of its four warps), where the thread issues
//    the next copy (TMA for g, a bulk copy for a weight tap, each
//    completing on its mbarrier), so the weight runs kWs taps ahead.  A
//    producer warp would need a warpgroup of its own for setmaxnreg, whose
//    registers would come out of dW's accumulators or the gathers.
// f. The walk fills every SM: a work item is (group, tile), item j =
//    group * ntiles + tile; block b of min(8 * ntiles, SMs) takes items
//    [b * n / grid, (b + 1) * n / grid) in order, so the work is split to
//    one item and a block's items span at most two groups: its dW stays
//    in registers and goes to dW with f32 atomics when the group changes
//    and at the end.  A tile's 8 groups no longer run side by side; its g
//    tile is read 8 times from device memory (1.9 GB at EDVR-L's L1
//    training shape, ~0.6 ms of the memory's time, overlapped).
// g. The fixed point and the global path are C = 64's: the bound is 2
//    max_p sum_co |g[p, co]| max |W| over the item (the sampling warps sum
//    their pixel's row of the g tile while the MMA warpgroup makes the
//    first two taps' dS); a footprint element takes at most one
//    contribution a (pixel, tap) of the tile, 192 x 9 < 2^13, of at most
//    2^18 units, so the int32 sums cannot overflow.
// Shared memory (bf16 / f32, R = 8): g 48 / 64 KB, weight ring 12 / 24,
// S 12.5 / 16.5, dS 12 / 16, footprint 84.7 / 77.9: 169.4 / 198.5 KB.
// Bound at EDVR-L's L1 training shape (224, 64, 64, 128), bf16: 1,632
// bytes a pixel (x, offsets and mask, g read; dx and the offset and mask
// gradients written), 1.50 GB, 0.45 ms; the two tap GEMMs, 4 x 1152 x 128
// flop a pixel, 541 GFLOP, 0.55 ms at 989 TFLOP/s.
#include "dcn_sample.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace rvsr {
namespace bwd {

constexpr int kTW = 32;       // tile width (pixels)
constexpr int kGroups = 8;    // deformable groups at both widths
constexpr int kRfMax = 8;     // footprint radius at most (shared memory)
// Fixed point of the footprint: a contribution of at most the tile's bound
// is at most 2^kFixBits units; a footprint element takes at most one
// contribution per (pixel, tap) of the tile, at most 512 x 9 = 4608 < 2^13
// (C = 128: 192 x 9), so int32 sums cannot overflow.
constexpr int kFixBits = 31 - 13;

// The layout of dcn_bwd_kernel64 (C = 64).  A tile is TH rows of kTW
// pixels, one thread a pixel (the 8 channels of its group): 16 rows in
// bf16, one 512-thread block per SM (one copy of the group's weight and ~50
// KB of L1 left for the gathers), 8 in f32, whose g tile takes twice the
// room.
template <typename T, int C>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kCpg = C / kGroups;
  static constexpr int kSplit = kCpg / 8;
  static constexpr int TH = kF32 ? 8 : 16;
  static constexpr int kTile = TH * kTW, kThreads = kTile * kSplit;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kFpStride = kCpg + 1;  // ints a footprint pixel
  static constexpr int ldw = C + Traits<T>::kPad;      // sW row: co
  static constexpr int ldg = C + Traits<T>::kPad;      // sG row: co
  static constexpr int lds = kTile + Traits<T>::kPad;  // sS row: pixels
  static constexpr int w_bytes = 9 * kCpg * ldw * (int)sizeof(T);
  static constexpr int g_bytes = kTile * ldg * (int)sizeof(T);
  static constexpr int ds_bytes = kTile * kCpg * 4;
  static constexpr int s_bytes = 2 * kCpg * lds * (int)sizeof(T);
  static constexpr int red_bytes = kWarps * 4;
  static constexpr int fixed = w_bytes + g_bytes + ds_bytes + s_bytes +
                               red_bytes;
  // dW = g^T S: output tiles of 16 co x 8 ci; each warp takes one over
  // the pixels of its K part (kKSplit parts)
  static constexpr int kNt = kCpg / 8;
  static constexpr int kOutTiles = (C / 16) * kNt;
  static constexpr int kKSplit = kWarps > kOutTiles ? kWarps / kOutTiles : 1;
  static constexpr int kKPart = kTile / kKSplit;  // pixels of a warp's K
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
  const T* wt;      // C = 128: the weight laid out by prep_weight_kernel
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
                                          const Corners& c,
                                          const float (&ds)[8], float m,
                                          int ch0, int fy0, int fx0, int fh,
                                          int fw, float to_fix, float lim,
                                          int* fp0, int fp_stride,
                                          float (&E)[4], float (&S)[8]) {
  GroupCorners<T, 8> e;
  gather<T, C, 8>(e, p.x, c, ch0);
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

// C = 128: the layout of dcn_bwd_kernel128 (notes a-g above).
template <typename T>
struct Bwd128 {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int C = 128, kCpg = 16;
  static constexpr int TH = kF32 ? 4 : 6;           // tile rows
  static constexpr int kPx = TH * kTW;              // tile pixels
  static constexpr int kSampThreads = 2 * kPx;      // two a pixel
  static constexpr int kSampWarps = kSampThreads / 32;
  static constexpr int kThreads = kSampThreads + 128;  // + MMA warpgroup
  // registers a thread after setmaxnreg: the launch gives each thread
  // 65536 / kThreads (128 bf16, 168 f32); the sampling warpgroups give some
  // up to the MMA warpgroup's dW accumulators
  static constexpr int kSampRegs = kF32 ? 136 : 104;
  static constexpr int kMmaRegs = kF32 ? 232 : 200;
  static constexpr int kCh = C * (int)sizeof(T) / kLine;  // co chunks
  static constexpr int kE = kLine / (int)sizeof(T);       // co a chunk
  static constexpr int kMt = kPx / 64;                    // dS m-tiles
  static constexpr int kWs = 3;  // weight taps in flight
  static constexpr int g_bytes = kCh * kPx * kLine;
  static constexpr int w_bytes = kCh * kCpg * kLine;  // one tap of a group
  static constexpr int lds = kPx + Traits<T>::kPad;   // sS row: pixels
  static constexpr int s_bytes = kCpg * lds * (int)sizeof(T);
  static constexpr int ds_bytes = kPx * kCpg * (int)sizeof(T);
  // barriers: g_full, w_full[kWs], ds_full[2], s_full[2], s_empty[2]
  static constexpr int kBars = 1 + kWs + 6;
  static constexpr int w_off = g_bytes;
  static constexpr int s_off = w_off + kWs * w_bytes;
  static constexpr int ds_off = s_off + 2 * s_bytes;
  static constexpr int red_off = ds_off + 2 * ds_bytes;
  static constexpr int bar_off = red_off + kSampWarps * 8;
  static constexpr int fixed = (bar_off + kBars * 8 + 15) / 16 * 16;
  static constexpr int kFpStride = kCpg + 1;  // ints a footprint pixel
  static_assert(kSampThreads * kSampRegs + 128 * kMmaRegs <=
                    65536 / kThreads / 8 * 8 * kThreads,
                "setmaxnreg: the warpgroups ask for more than the launch");
  static_assert(kPx * 9 < (1 << (31 - kFixBits)), "fixed-point headroom");
  static __host__ __device__ constexpr int smem(int rf) {
    return fixed + (TH + 2 * rf + 3) * (kTW + 2 * rf + 3) * kFpStride * 4;
  }
};

// The weight of every (group, tap) as the image of its ring slot, each
// value rounded as the tensor cores take it: [g][tap][co chunk][ci 16][kE
// co], the 16-byte units of each 128-byte row swizzled (unit j of row ci at
// j ^ (ci & 7)), so one tap of a group is one contiguous copy.
template <typename T>
__global__ void prep_weight_kernel(const T* __restrict__ w,
                                   T* __restrict__ wt) {
  using L = Bwd128<T>;
  constexpr int C = L::C, V = Traits<T>::kVec;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < C * C * 9;
       e += gridDim.x * blockDim.x) {
    const int kl = e % L::kE, ci = (e / L::kE) % L::kCpg;
    const int r = e / (L::kE * L::kCpg), c = r % L::kCh;
    const int tap = (r / L::kCh) % 9, g = r / (L::kCh * 9);
    const int co = c * L::kE + ((kl / V) ^ (ci & 7)) * V + kl % V;
    wt[e] = Traits<T>::to_mma(
        Traits<T>::to_f(w[(co * C + g * L::kCpg + ci) * 9 + tap]));
  }
}

// 8 values of T (16 or 32 bytes) as f32.
template <typename T>
__device__ __forceinline__ void load8(const T* src, float (&v)[8]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
  }
}

// dS of one tap for the tile (the MMA warpgroup): g (kPx x 128, in its
// buffer at g_s) times the group's weight tap (16 x 128, in its ring slot
// at w_s), on wgmma with both operands in shared memory, rounded to T into
// the dS slot [pixel][16].
template <typename T>
__device__ __forceinline__ void ds_tap(uint32_t g_s, uint32_t w_s, T* ds,
                                       int mw, int lane) {
  using L = Bwd128<T>;
  // opaque to the compiler, so that the 9 taps' descriptors (the same g
  // tile, 3 weight slots) are made at each tap and not hoisted out of the
  // unrolled taps into registers the dW accumulators need
  asm volatile("" : "+r"(g_s), "+r"(w_s));
  float d[L::kMt][8];
  wgmma_fence();
#pragma unroll
  for (int mt = 0; mt < L::kMt; ++mt)
#pragma unroll
    for (int c = 0; c < L::kCh; ++c) {
      const uint64_t da = desc_sw128(g_s + c * L::kPx * kLine + mt * 8192);
      const uint64_t db = desc_sw128(w_s + c * L::kCpg * kLine);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        WgmmaSS<T, 16>::run(d[mt], da + 2 * ks, db + 2 * ks,
                            (c > 0 || ks > 0) ? 1 : 0);
    }
  wgmma_commit();
  wgmma_wait<0>();
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < L::kMt; ++mt)
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      fence_operand(d[mt][i]);
      fence_operand(d[mt][i + 1]);
      const int px = mt * 64 + mw * 16 + gq + 8 * ((i >> 1) & 1);
      T* dst = ds + px * L::kCpg + 8 * (i >> 2) + 2 * t4;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float2*>(dst) = make_float2(d[mt][i], d[mt][i + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(d[mt][i], d[mt][i + 1]);
      }
    }
}

// dW[:, tap, group] += g^T S over the tile (the MMA warpgroup): warp mw
// holds co tiles 32 mw and 32 mw + 16 by ci tiles 0 and 8 (acc[2 jt + nt]),
// mma.sync with g^T from the swizzled g tile and S from its slot
// [ci][lds].
template <typename T>
__device__ __forceinline__ void dw_tap(float (&acc)[4][4],
                                       const unsigned char* g_t, const T* s,
                                       int mw, int lane) {
  using L = Bwd128<T>;
  const int gq = lane >> 2, t4 = lane & 3;
  asm volatile("" : "+l"(g_t), "+l"(s));  // as in ds_tap: no hoisting
  if constexpr (std::is_same<T, float>::value) {
    // element (pixel px, co) of the g tile, TF32-rounded
    auto gv = [&](int px, int co) {
      const float v = *reinterpret_cast<const float*>(
          g_t + (co / L::kE) * L::kPx * kLine + px * kLine +
          ((((co % L::kE) >> 2) ^ (px & 7)) << 4) + (co & 3) * 4);
      return __float_as_uint(Traits<float>::to_mma(v));
    };
#pragma unroll 2
    for (int k0 = 0; k0 < L::kPx; k0 += 8) {
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* bs = s + (8 * nt + gq) * L::lds + k0 + t4;
        b[nt][0] = __float_as_uint(bs[0]);
        b[nt][1] = __float_as_uint(bs[4]);
      }
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const int m0 = 32 * mw + 16 * jt;
        const uint32_t a0 = gv(k0 + t4, m0 + gq);
        const uint32_t a1 = gv(k0 + t4, m0 + gq + 8);
        const uint32_t a2 = gv(k0 + t4 + 4, m0 + gq);
        const uint32_t a3 = gv(k0 + t4 + 4, m0 + gq + 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_tf32(acc[2 * jt + nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
      }
    }
  } else {
    const int mi = lane >> 3;  // which 8 x 8 matrix this lane addresses
    const uint32_t g_s = smem_u32(g_t);
#pragma unroll 4
    for (int k0 = 0; k0 < L::kPx; k0 += 16) {
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const T* bs = s + (8 * nt + gq) * L::lds + k0 + 2 * t4;
        b[nt][0] = ld32(bs);
        b[nt][1] = ld32(bs + 8);
      }
      const int px = k0 + (lane & 7) + 8 * (mi >> 1);
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const int m0 = 32 * mw + 16 * jt;  // within chunk m0 / 64
        const int unit = (m0 % L::kE) / 8 + (mi & 1);
        uint32_t a[4];
        ldmatrix_x4_trans(a, g_s + (m0 / L::kE) * L::kPx * kLine +
                                 px * kLine + ((unit ^ (px & 7)) << 4));
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_bf16(acc[2 * jt + nt], a[0], a[1], a[2], a[3], b[nt][0],
                   b[nt][1]);
      }
    }
  }
}

// C = 128: warp roles, TMA'd cotangent tiles, dS on wgmma (a-g above).
template <typename T>
__global__ void __launch_bounds__(Bwd128<T>::kThreads, 1)
    dcn_bwd_kernel128(const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ Params<T> p) {
  using Tr = Traits<T>;
  using L = Bwd128<T>;
  constexpr int C = L::C, CPG = L::kCpg;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();  // the swizzle needs 1024-byte alignment
  T* sS = reinterpret_cast<T*>(smem + L::s_off);    // [2][ci][lds]
  T* sDS = reinterpret_cast<T*>(smem + L::ds_off);  // [2][pixel][ci]
  float* sRed = reinterpret_cast<float*>(smem + L::red_off);
  int* fp = reinterpret_cast<int*>(smem + L::fixed);  // [fy][fx][CPG + 1]
  const uint32_t bars = base + L::bar_off;
  const uint32_t g_full = bars;
  auto w_full = [&](int i) { return bars + 8 * (1 + i); };
  auto ds_full = [&](int i) { return bars + 8 * (1 + L::kWs + i); };
  auto s_full = [&](int i) { return bars + 8 * (3 + L::kWs + i); };
  auto s_empty = [&](int i) { return bars + 8 * (5 + L::kWs + i); };
  const int fh = L::TH + 2 * p.rf + 3, fw = kTW + 2 * p.rf + 3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this block's items [j0, j1): item j = group * ntiles + tile
  const long long nitems = (long long)kGroups * p.ntiles;
  const int j0 = (int)(nitems * blockIdx.x / gridDim.x);
  const int nmine = (int)(nitems * (blockIdx.x + 1) / gridDim.x) - j0;

  if (tid == 0) {
    mbar_init(g_full, 1);
    for (int i = 0; i < L::kWs; ++i) mbar_init(w_full(i), 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(ds_full(i), 1);
      mbar_init(s_full(i), L::kSampWarps);
      mbar_init(s_empty(i), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < fh * fw * L::kFpStride; i += L::kThreads) fp[i] = 0;
  __syncthreads();

  if (tid >= L::kSampThreads) {  // ------------------- the MMA warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(L::kMmaRegs));
    const int mw = warp - L::kSampWarps;  // 0 ... 3
    const bool leader = tid == L::kSampThreads;
    const CUtensorMap* gm = &gmap;
    const int ntaps = nmine * 9;
    // the leader's copies: item k's g tile, and the weight of tap n = 9 k
    // + t into ring slot n % kWs
    auto load_g = [&](int k) {
      const int tile = (j0 + k) % p.ntiles;
      const int tx = tile % p.tiles_x, ty = (tile / p.tiles_x) % p.tiles_y;
      const int b = tile / (p.tiles_x * p.tiles_y);
      mbar_expect_tx(g_full, L::g_bytes);
#pragma unroll
      for (int c = 0; c < L::kCh; ++c)
        tma_load_4d(base + c * L::kPx * kLine, gm, c * L::kE, tx * kTW,
                    ty * L::TH, b, g_full);
    };
    auto load_w = [&](int n) {
      const int grp = (j0 + n / 9) / p.ntiles, tap = n % 9;
      const uint32_t bar = w_full(n % L::kWs);
      mbar_expect_tx(bar, L::w_bytes);
      bulk_load(base + L::w_off + (n % L::kWs) * L::w_bytes,
                reinterpret_cast<const unsigned char*>(p.wt) +
                    ((size_t)grp * 9 + tap) * L::w_bytes,
                L::w_bytes, bar);
    };
    if (leader) {
      load_g(0);
      for (int n = 0; n < L::kWs && n < ntaps; ++n) load_w(n);
    }
    auto ds_of = [&](uint32_t g_s, int n) {  // dS of tap n into slot n % 2
      mbar_sleep_wait(w_full(n % L::kWs), (n / L::kWs) & 1);
      ds_tap<T>(g_s, base + L::w_off + (n % L::kWs) * L::w_bytes,
                sDS + (n % 2) * L::kPx * CPG, mw, lane);
    };
    // dW[co][tap][group * 16 + ci] partial sums over the block's items of
    // one group: co = 32 mw + 16 jt + lane / 4 (+ 8), ci = 8 nt + 2 (lane &
    // 3) (+ 1), acc[tap][2 jt + nt]
    float acc[9][4][4];
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int o = 0; o < 4; ++o)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][o][e] = 0.f;
    auto flush_dw = [&](int grp) {
      const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int o = 0; o < 4; ++o)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int co = 32 * mw + 16 * (o >> 1) + gq + 8 * (e >> 1);
            const int ci = 8 * (o & 1) + 2 * t4 + (e & 1);
            atomicAdd(p.dw + (co * 9 + t) * C + grp * CPG + ci, acc[t][o][e]);
            acc[t][o][e] = 0.f;
          }
    };
    int grp_now = j0 / p.ntiles;
    for (int k = 0; k < nmine; ++k) {
      const int grp = (j0 + k) / p.ntiles;
      if (grp != grp_now) {
        flush_dw(grp_now);
        grp_now = grp;
      }
      mbar_sleep_wait(g_full, k & 1);
      const uint32_t g_s = base;
      const int n0 = 9 * k;
      ds_of(g_s, n0);
      ds_of(g_s, n0 + 1);
      named_sync(2, 128);  // every warp's dS stored, its weight slots read
      if (leader) {
        mbar_arrive(ds_full(n0 % 2));
        mbar_arrive(ds_full((n0 + 1) % 2));
        if (n0 + L::kWs < ntaps) load_w(n0 + L::kWs);
        if (n0 + 1 + L::kWs < ntaps) load_w(n0 + 1 + L::kWs);
      }
      // step t: dW of tap t - 1 (its S from the sampling warps), then dS of
      // tap t + 1, so dS runs a tap ahead of the sampling
#pragma unroll
      for (int t = 1; t <= 9; ++t) {
        const int n = n0 + t - 1;
        mbar_sleep_wait(s_full(n % 2), (n / 2) & 1);
        dw_tap<T>(acc[t - 1], smem, sS + (n % 2) * CPG * L::lds, mw, lane);
        if (t <= 7) ds_of(g_s, n + 2);
        named_sync(2, 128);
        if (leader) {
          mbar_arrive(s_empty(n % 2));
          if (t <= 7) {
            mbar_arrive(ds_full((n + 2) % 2));
            if (n + 2 + L::kWs < ntaps) load_w(n + 2 + L::kWs);
          }
          if (t == 9 && k + 1 < nmine) {
            fence_proxy_async();  // this item's reads of the tile first
            load_g(k + 1);
          }
        }
      }
    }
    flush_dw(grp_now);
    return;
  }

  // --------------------------------------------------- the sampling warps
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(L::kSampRegs));
  // this thread's pixel, and its 8 channels of the group
  const int q = tid >> 1, sub = tid & 1;
  const int ly = q / kTW, lx = q % kTW;
  const int H = p.H, W = p.W;
  int grp_now = -1;
  float wmax = 0.f;
  for (int k = 0; k < nmine; ++k) {
    const int j = j0 + k, grp = j / p.ntiles, tile = j % p.ntiles;
    const int tcol = tile % p.tiles_x, rest = tile / p.tiles_x;
    const int trow = rest % p.tiles_y, b = rest / p.tiles_y;
    const int y = trow * L::TH + ly, x = tcol * kTW + lx;
    const bool ok = y < H && x < W;
    const int pix = ok ? (b * H + y) * W + x : 0;
    const int fy0 = trow * L::TH - 1 - p.rf, fx0 = tcol * kTW - 1 - p.rf;
    const int ch0 = grp * CPG + 8 * sub;
    // max |W| of the group (its rows of wt), when the group changes
    float wm = 0.f;
    if (grp != grp_now) {
      const T* wg = p.wt + (size_t)grp * 9 * L::w_bytes / sizeof(T);
      for (int i = tid; i < 9 * L::w_bytes / (int)sizeof(T);
           i += L::kSampThreads)
        wm = fmaxf(wm, fabsf(Tr::to_f(wg[i])));
    }
    // The item's bound on |dS| (rounding to T included: the factor 2):
    // |dS[p, tap, ci]| <= sum_co |g[p, co]| max |W|.  It sets the fixed
    // point's scale, a power of two.  Each thread of a pixel sums half its
    // row of the g tile (whole 16-byte units: the swizzle only permutes
    // them).
    mbar_sleep_wait(g_full, k & 1);
    float gsum = 0.f;
    {
      const unsigned char* row = smem + q * kLine;
#pragma unroll
      for (int cc = 0; cc < L::kCh / 2; ++cc)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              row + (sub * L::kCh / 2 + cc) * L::kPx * kLine + u * 16);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < Tr::kVec; ++i) gsum += fabsf(Tr::to_f(e[i]));
        }
    }
    gsum += __shfl_xor_sync(~0u, gsum, 1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      gsum = fmaxf(gsum, __shfl_xor_sync(~0u, gsum, o));
      wm = fmaxf(wm, __shfl_xor_sync(~0u, wm, o));
    }
    if (lane == 0) {
      sRed[2 * warp] = gsum;
      sRed[2 * warp + 1] = wm;
    }
    // also orders the last item's zeroed footprint before this one's sums
    named_sync(1, L::kSampThreads);
    float gmax = 0.f;
    if (grp != grp_now) wmax = 0.f;
#pragma unroll
    for (int w = 0; w < L::kSampWarps; ++w) {
      gmax = fmaxf(gmax, sRed[2 * w]);
      if (grp != grp_now) wmax = fmaxf(wmax, sRed[2 * w + 1]);
    }
    grp_now = grp;
    const float bound = 2.f * gmax * wmax;
    int ex;
    frexpf(bound, &ex);  // bound <= 2^ex
    const bool fixed_ok = bound > 0.f && bound <= 3.0e38f;
    const float to_fix = fixed_ok ? ldexpf(1.f, kFixBits - ex) : 0.f;
    const float lim = fixed_ok ? bound : -1.f;  // else all go global

    // tap t + 1's offsets and mask are loaded while tap t runs
    float n_dy = 0.f, n_dx = 0.f, n_m = 0.f;
    if (ok) load_off_mask(p.om, pix, grp, 0, n_dy, n_dx, n_m);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int n = 9 * k + tap;
      const float dy = n_dy, dx = n_dx, m = n_m;
      if (ok && tap < 8)
        load_off_mask(p.om, pix, grp, tap + 1, n_dy, n_dx, n_m);
      mbar_sleep_wait(ds_full(n % 2), (n / 2) & 1);
      float ds[8];
      load8<T>(sDS + (n % 2) * L::kPx * CPG + q * CPG + 8 * sub, ds);
      float E[4] = {0.f, 0.f, 0.f, 0.f}, S[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) S[i] = 0.f;
      Corners c;
      if (ok) {
        c = corners(dy, dx, pix, y, x, tap, H, W, p.max_off, p.clamp);
        pixel_tap<T, C>(p, c, ds, m, ch0, fy0, fx0, fh, fw, to_fix, lim,
                        fp + 8 * sub, L::kFpStride, E, S);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) E[i] += __shfl_xor_sync(~0u, E[i], 1);
      if (ok && sub == 0) {
        float gy, gx, gm;
        grads_of<T>(c, E, m, p.om.logits, gy, gx, gm);
        write_grads(p.doff + (size_t)pix * p.doff_stride + grp * 18 + 2 * tap,
                    p.dmsk + (size_t)pix * p.dmsk_stride + grp * 9 + tap, gy,
                    gx, gm);
      }
      mbar_sleep_wait(s_empty(n % 2), ((n / 2) & 1) ^ 1);
      T* sSb = sS + (n % 2) * CPG * L::lds;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sSb[(8 * sub + i) * L::lds + q] = Tr::to_mma(S[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(s_full(n % 2));
    }
    named_sync(1, L::kSampThreads);  // every footprint atomic done

    // flush the footprint into dx (only what was touched) and zero it
    const float from_fix = fixed_ok ? ldexpf(1.f, ex - kFixBits) : 0.f;
    for (int i = tid; i < fh * fw * 4; i += L::kSampThreads) {
      const int qq = i >> 2, h = i & 3;
      int* f = fp + qq * L::kFpStride + 4 * h;
      const int v0 = f[0], v1 = f[1], v2 = f[2], v3 = f[3];
      if (v0 | v1 | v2 | v3) {
        // only corners inside the image were added
        const int yy = fy0 + qq / fw, xx = fx0 + qq % fw;
        atomicAdd(reinterpret_cast<float4*>(
                      p.dx + (size_t)((b * H + yy) * W + xx) * C + grp * CPG +
                      4 * h),
                  make_float4(v0 * from_fix, v1 * from_fix, v2 * from_fix,
                              v3 * from_fix));
        f[0] = f[1] = f[2] = f[3] = 0;
      }
    }
  }
}

// Error codes of the host side, beside cudaGetLastError()'s and
// encode_nhwc's (9001, 9002).
constexpr int kErrRadius = 9101;
constexpr int kErrWidth = 9102;

template <typename T>
int launch64(Params<T> p, int B, int rf, void* stream) {
  using L = Layout<T, 64>;
  p.tiles_x = (p.W + kTW - 1) / kTW;
  p.tiles_y = (p.H + L::TH - 1) / L::TH;
  p.ntiles = B * p.tiles_x * p.tiles_y;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaFuncSetAttribute(dcn_bwd_kernel64<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes<T, 64>(kRfMax));
    attribute_set = true;
  }
  const int cap = min_blocks<T, 64>() * sm_count() / kGroups;
  const int slots = p.ntiles < cap ? p.ntiles : cap;
  if (slots > 0)
    dcn_bwd_kernel64<T><<<slots * kGroups, L::kThreads, smem_bytes<T, 64>(rf),
                          (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch128(Params<T> p, int B, int rf, void* stream) {
  using L = Bwd128<T>;
  prep_weight_kernel<T><<<(L::C * L::C * 9 + 255) / 256, 256, 0,
                          (cudaStream_t)stream>>>(p.weight, (T*)p.wt);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  p.tiles_x = (p.W + kTW - 1) / kTW;
  p.tiles_y = (p.H + L::TH - 1) / L::TH;
  p.ntiles = B * p.tiles_x * p.tiles_y;
  CUtensorMap gmap;
  err = encode_nhwc<T>(&gmap, p.gout, B, p.H, p.W, L::C, kTW, L::TH);
  if (err != 0) return err;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaFuncSetAttribute(dcn_bwd_kernel128<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         L::smem(kRfMax));
    attribute_set = true;
  }
  const long long items = (long long)kGroups * p.ntiles;
  const int grid = items < sm_count() ? (int)items : sm_count();
  if (grid > 0)
    dcn_bwd_kernel128<T><<<grid, L::kThreads, L::smem(rf),
                           (cudaStream_t)stream>>>(gmap, p);
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
  return C == 64 ? launch64<T>(p, B, rf, stream)
                 : launch128<T>(p, B, rf, stream);
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
