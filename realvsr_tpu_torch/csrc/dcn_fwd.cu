// Modulated deformable convolution (DCNv2) forward, 3x3 / stride 1 / pad 1,
// NHWC, C -> C channels in 8 deformable groups, C = 64 or 128 (two
// kernels; dcn_narrow.cu takes every other shape), fused bias, optional relu
// or LeakyReLU(0.1) and an optional +-max_offset clamp of the offsets.  The
// offsets and the mask come either as separate tensors or, read in place,
// as DCNPack's 216-channel conv_offset_mask output with the sigmoid of the
// mask taken here (dcn_sample.cuh).
//
// Replaces the TPU kernel realvsr_tpu/ops/pallas/dcn_frame_kernel.py
// `dcn_frame_fused` (with its input prep deform_conv_block.py `_frame_prep`
// and DCNPack's split / concat / sigmoid of the offset-mask tensor); the
// block API (TPU kernel dcn_block_kernel.py `dcn_block_fused`) runs it with
// the clamp.  The TPU kernel's int16 fixed-point positions and 128-lane
// column panels exist only for the TPU's lane and DMA rules; here positions
// are exact f32 and every input is read in place.
//
// Bound on the H100: at the L1 shape (3, 512, 1024, 64) in bf16 it reads x
// (201 MB) and the offsets and mask (340 MB separate, the same elements in
// place) and writes 201 MB: ~0.32 ms at 3.35 TB/s; the 116 GFLOP of tap
// products take 0.12 ms at the bf16 tensor-core peak.  So it is bound by
// memory, and beyond that by the gathers: 4 corners x 16 bytes per (pixel,
// group, tap), 7.2 GB at L1 that L1 and L2 must serve.
//
// Design: one persistent block per SM, walking output tiles of TH x 16
// pixels (TH * 16 rows of the product, one warpgroup per 64), blockIdx.x,
// blockIdx.x + gridDim.x, ...; a flat loop over (tile, tap) steps.  bf16
// takes TH = 16 (512 threads): one copy of the weight per SM and ~90 KB of
// L1 left for the gathers, where two 256-thread blocks of TH = 8 would hold
// two copies and leave ~28 KB.  f32 takes TH = 8 (256 threads), as its
// weight fills 144 KB.
// 1. The weight stays resident: packed once per launch by
//    pack_weight_kernel (sm90.cuh, conv3x3's layout: [chunk][tap][64][128 B]
//    swizzled, TF32-rounded for f32) and copied into shared memory once per
//    block: 72 KB in bf16, 144 KB in f32.  It is wgmma's B operand through
//    128-byte-swizzle descriptors, read once per warpgroup.
// 2. The sampled columns of a step go into one of two A stages in the
//    swizzled K-major layout (each thread writes whole 16-byte units).  At
//    step s each warpgroup loads its 64 rows of stage s & 1 (ldmatrix),
//    issues its wgmma (m64n64k16 bf16, m64n64k8 TF32) on them and, while the
//    tensor cores run, every thread samples step s + 1 into the other stage:
//    wgmma is asynchronous, so the same warps overlap the product of tap t
//    with the gathers of tap t + 1 (and of the next tile's tap 0) without
//    warp roles or mbarriers; one __syncthreads per step hands the stages
//    over.  The product is ~1/20 of a step's time, so a separate MMA warp
//    would idle.
// 3. Sampling: thread i takes group i & 7 of 4 pixels of the tile; the 4
//    (dy, dx) pairs (one 4- or 8-byte load each) and masks are loaded
//    together, then two pixels at a time have their 4 corners' 16- or
//    32-byte loads all in flight; the pixels' coordinates are computed once
//    per tile, in 32 bits.
// 4. The epilogue adds the bias, applies the activation and casts in
//    registers, stages each warp's 16 pixels in its rows of the finished A
//    stage and writes them with 16-byte stores; ragged tiles are predicated.
// f32: the resident weight (144 KB) and two 32 KB stages fit in one block's
// 227 KB, so f32 runs the same code with TH = 8.
//
// At C = 128 (EDVR-L: nf 128, 16 channels a group) a second kernel,
// dcn_fwd_kernel128, runs the same function with another design; the C =
// 64 kernel above keeps its body.  What held the first C = 128 design (the
// loop above with the weight streamed tap by tap, 8 x 16 tiles bf16, 4 x 16
// f32) back, inferred from the code (no profiler runs on the card's
// machine): one __syncthreads a (tile, tap) step, so each step paid its
// whole chain (weight copy, offsets, corners, gathers, blend, st.shared)
// with only ~1/20 of it, the product, overlapped; one (pixel, group) in
// flight a thread; lanes a group apart, so a warp's 16-byte loads touched
// 8 (bf16) or 16 (f32) half- or quarter-used lines; the weight streamed by
// the gathering threads through plain loads, 288 KB bf16 / 576 KB f32 a
// tile, and one 256-thread block in f32 (8 warps) to hide L2.  The
// redesign:
// a. Warp roles, the registers split by setmaxnreg: 16 sampling warps
//    (kSampRegs) and one MMA warpgroup (kMmaRegs), on mbarrier rings with
//    the watchdog (try_wait: waiting warps leave the issue slots to the
//    sampling ones).  A step is (tile, 128-byte chunk of the input
//    channels: 2 bf16, 4 f32, tap), chunk by chunk, so a chunk's 9 taps
//    gather from one footprint (~60 KB at +-4 about an 8 x 16 tile) that L1
//    keeps.  The sampling warps fill a ring of kStages A stages (the chunk
//    of the tile's 128 pixels, 16 KB, in the 128-byte-swizzled K-major
//    layout wgmma reads), each warp arriving on the stage's full barrier
//    after fence.proxy.async; the MMA warpgroup runs m64n128 on both
//    64-row halves of each stage (A and B by shared-memory descriptors,
//    128 accumulators a thread), keeps one group in flight, and frees the
//    stage (empty barrier) once it is read.  No block-wide barrier after
//    the start: a sampling warp waits only for a free stage, so the
//    gathers of several steps of different warps are in flight together.
// b. The weight by bulk copies: the MMA warpgroup's first thread copies
//    the (chunk, tap) slice of the packed weight ([chunk][tap][128
//    rows][128 B], 16 KB) of each step into a ring of kWs slots as soon as
//    the slot's product is done; no thread loads or stores the weight.
//    The L2 reads stay a weight per 128-pixel tile (288 KB bf16, 576 KB
//    f32: half the old f32 kernel's), as 256 rows would need 256 x 128
//    accumulators or a second MMA warpgroup out of the gathers' registers.
// c. Whole lines a load: lane l takes 16-byte unit l % 8 of the chunk (8
//    bf16 / 4 f32 channels of group (chunk * 128 + 16 (l % 8)) / 32 bytes)
//    for pixels 8 w + 4 j + l / 8, j < 2, of warp w, so each 16-byte corner
//    load of a warp reads 4 pixels' full 128-byte chunk rows.  Lanes l and
//    l ^ 1 sample the same (pixel, group) for both items: each finds the
//    corners of one (its offsets and mask, loaded raw a step ahead and
//    converted at their use, in flight beside the previous step's
//    gathers) and takes the other's weights, corner indices and validity
//    by 9 shuffles; the two items' 8 corner loads are issued together.
// d. The epilogue: the MMA warpgroup adds the bias, applies the activation
//    and casts in registers, stages each warp's 16 pixels in 128-byte
//    column chunks in its own rows of shared memory, and stores them with
//    16-byte stores (ragged tiles predicated), while the sampling warps
//    fill the next tile's stages.
// Shared memory: 4 A stages of 16 KB, 3 weight slots of 16 KB, 9 KB of
// epilogue rows, 11 mbarriers: ~121 KB, one 640-thread block an SM, which
// leaves L1 ~124 KB for the gathers.  Built up in that order, on the card
// at EDVR-L's L1 shape: 8 sampling warps of 4 items a step were slower
// than the first design in bf16 (faster in f32); 16 warps of 2 items,
// chunk-major steps, try_wait and the shared corners each took time off;
// 64-pixel tiles and deeper A rings did not.
// Bound at EDVR-L's L1 inference shape (7, 256, 448, 128), bf16: 944 bytes
// a pixel (x, the offsets and mask, out), 0.76 GB, 0.23 ms; the tap
// products 2 x 1152 x 128 flop a pixel, 237 GFLOP, 0.24 ms at 989
// TFLOP/s: at this width the products weigh as much as the bytes.
#include "dcn_sample.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace rvsr {
namespace fwd {

// A tile is TH rows of 16 pixels, TH * 16 rows of the product.
constexpr int kTW = 16;
constexpr int kGroups = 8;  // deformable groups at both widths

// The layout of dcn_fwd_kernel (C = 64).
template <typename T, int C>
struct Shape {
  static_assert(C == 64, "C = 128 runs dcn_fwd_kernel128");
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kCpg = C / kGroups;
  static constexpr int kNC = C * (int)sizeof(T) / kLine;  // chunks of a row
  // tile rows: 16 in bf16 (one 512-thread block per SM: the resident weight
  // once, and L1 left for the gathers), 8 in f32 (the weight takes 144 KB)
  static constexpr int TH = kF32 ? 8 : 16;
  static constexpr int kRows = TH * kTW;
  static constexpr int kThreads = TH * 32;
  static constexpr int kPix = 4;     // (pixel, group) a thread
  static constexpr int kFlight = 2;  // gathered together
  static constexpr int kSlice = C * kLine;  // one tap of one chunk
  static constexpr int kWeightBytes = 9 * kNC * kSlice;
  static constexpr int kStageBytes = kNC * kRows * kLine;
  static constexpr int kSmem = kWeightBytes + 2 * kStageBytes;
  // blocks per SM, as shared memory allows
  static constexpr int kMinBlocks = 2 * kSmem <= 227 * 1024 ? 2 : 1;
};

// C = 128: the layout of dcn_fwd_kernel128 (notes a-d above).
template <typename T>
struct Fwd128 {
  static constexpr int C = 128;
  static constexpr int TH = 8;               // tile rows of kTW pixels
  static constexpr int kSampWarps = 16;      // sampling warps
  static constexpr int kPx = TH * kTW;       // tile pixels: kHalves x 64
  static constexpr int kHalves = kPx / 64;   // 64-row m-tiles of a tile
  static constexpr int kNC = C * (int)sizeof(T) / kLine;  // 2 / 4 chunks
  static constexpr int kE = kLine / (int)sizeof(T);       // channels a chunk
  static constexpr int kSampThreads = kSampWarps * 32;
  static constexpr int kThreads = kSampThreads + 128;  // + MMA warpgroup
  // (pixel, 16-byte unit) items of a step a sampling thread: a warp's
  // load covers 4 pixels' 128-byte chunk rows
  static constexpr int kItems = kPx * (kLine / 16) / kSampThreads;
  static constexpr int kStages = 4;          // A stages
  static constexpr int kWs = 3;              // weight slots
  // registers a thread after setmaxnreg (the launch gives each 96): the
  // MMA warpgroup's 64 kHalves accumulators, the sampling threads' two
  // items of 4 corners in flight
  static constexpr int kSampRegs = 80, kMmaRegs = 160;
  static constexpr int a_bytes = kPx * kLine;  // a stage
  static constexpr int w_bytes = C * kLine;    // a slot: 16 KB
  static constexpr int kEpiLd = kLine + 16;    // a staged row (bytes)
  static constexpr int w_off = kStages * a_bytes;
  static constexpr int epi_off = w_off + kWs * w_bytes;
  static constexpr int bar_off = epi_off + 4 * 16 * kEpiLd;
  // barriers: full[kStages], empty[kStages], wfull[kWs]
  static constexpr int kSmem = bar_off + 8 * (2 * kStages + kWs);
  static_assert(kPx % 64 == 0 && kItems * kSampThreads * 16 == kPx * kLine,
                "whole m-tiles, whole items");
  static_assert(kItems == 2, "a lane pair shares its two items' corners");
  static_assert(kSampThreads * kSampRegs + 128 * kMmaRegs <=
                    65536 / kThreads / 8 * 8 * kThreads,
                "setmaxnreg: the warpgroups ask for more than the launch");
};

template <typename T>
struct Params {
  const T* x;
  OffMask<T> om;
  const unsigned char* weight;  // packed
  const T* bias;
  T* out;
  int H, W, act, clamp;
  float max_off;
  int tiles_x, tiles_y, ntiles;
};

// Byte offset in an A stage of `rows` rows of the 16-byte unit u (of 8 or
// 16 a chunk) of row r: [chunk u / 8][row][128 bytes], unit u % 8 at slot
// (u % 8) ^ (r % 8).
template <int rows>
__device__ __forceinline__ int stage_off(int r, int u) {
  return (u >> 3) * (rows * kLine) + r * kLine + (((u & 7) ^ (r & 7)) << 4);
}

// One pixel a thread samples: its index (b * H + y) * W + x, -1 past the
// image's edge, and its coordinates.
struct Pix {
  int p, y, x;
};

// Thread i samples group i & 7 of the tile's pixels (i >> 3) + k *
// kThreads / 8, k < kPix.
template <typename T, int C>
__device__ __forceinline__ void tile_pixels(Pix (&px)[Shape<T, C>::kPix],
                                            const Params<T>& p, int tile) {
  using S = Shape<T, C>;
  const int tx = tile % p.tiles_x, rest = tile / p.tiles_x;
  const int ty = rest % p.tiles_y, b = rest / p.tiles_y;
#pragma unroll
  for (int k = 0; k < S::kPix; ++k) {
    const int r = (threadIdx.x >> 3) + S::kThreads / 8 * k;
    const int y = ty * S::TH + (r >> 4), x = tx * kTW + (r & 15);
    px[k].y = y;
    px[k].x = x;
    px[k].p = y < p.H && x < p.W ? (b * p.H + y) * p.W + x : -1;
  }
}

// The thread's (pixel, group) columns of one tap, into an A stage.
template <typename T, int C>
__device__ __forceinline__ void sample_tap(unsigned char* stage,
                                           const Params<T>& p,
                                           const Pix (&px)[Shape<T, C>::kPix],
                                           int tap) {
  using S = Shape<T, C>;
  constexpr int CPG = S::kCpg, NP = S::kPix, NF = S::kFlight;
  constexpr int NV = GroupCorners<T, CPG>::kVecs;
  constexpr int V = Traits<T>::kVec;
  const int g = threadIdx.x & 7;
  // every item's offsets and mask first: their loads are in flight together
  float dy[NP], dx[NP], m[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    dy[j] = dx[j] = m[j] = 0.f;
    if (px[j].p >= 0) load_off_mask(p.om, px[j].p, g, tap, dy[j], dx[j], m[j]);
  }
#pragma unroll
  for (int h = 0; h < NP; h += NF) {
    Corners c[NF];
    GroupCorners<T, CPG> e[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const Pix& q = px[h + j];
      c[j] = corners(dy[h + j], dx[h + j], q.p, q.y, q.x, tap, p.H, p.W,
                     p.max_off, p.clamp);
      if (q.p < 0)
#pragma unroll
        for (int k = 0; k < 4; ++k) c[j].valid[k] = false;
      gather<T, C, CPG>(e[j], p.x, c[j], g * CPG);
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      float val[CPG];
      blend(val, e[j], c[j]);
#pragma unroll
      for (int i = 0; i < CPG; ++i) val[i] *= m[h + j];
      const int r = (threadIdx.x >> 3) + S::kThreads / 8 * (h + j);
#pragma unroll
      for (int v = 0; v < NV; ++v)
        store_vec_mma<T>(reinterpret_cast<T*>(
                             stage + stage_off<S::kRows>(r, g * NV + v)),
                         val + v * V);
    }
  }
}

// Bias, activation and cast of one warp's 16 pixels (tile row `trow`) and
// 64 output columns, staged in those rows of a finished A stage, then
// 16-byte stores.
template <typename T, int C>
__device__ __forceinline__ void epilogue(const float* acc, const Params<T>& p,
                                         unsigned char* stage, int tile,
                                         int trow, int lane) {
  using Tr = Traits<T>;
  using S = Shape<T, C>;
  constexpr int UH = 64 * (int)sizeof(T) / 16;  // 16-byte units of a half
  constexpr int rows = S::kRows;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if (p.bias != nullptr) {
      b0 = Tr::to_f(p.bias[col]);
      b1 = Tr::to_f(p.bias[col + 1]);
    }
    const int byte = col * (int)sizeof(T);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = trow * 16 + g + 8 * hh;
      T* d = reinterpret_cast<T*>(stage + stage_off<rows>(r, byte >> 4) +
                                  (byte & 15));
      d[0] = Tr::from_f(apply_act(acc[4 * i + 2 * hh] + b0, p.act));
      d[1] = Tr::from_f(apply_act(acc[4 * i + 2 * hh + 1] + b1, p.act));
    }
  }
  __syncwarp();
  const int tx = tile % p.tiles_x, rest = tile / p.tiles_x;
  const int ty = rest % p.tiles_y, b = rest / p.tiles_y;
  const int y = ty * S::TH + trow;
  if (y < p.H) {
#pragma unroll
    for (int it = lane; it < 16 * UH; it += 32) {
      const int r = it / UH, u = it % UH, x = tx * kTW + r;
      if (x < p.W)
        *reinterpret_cast<uint4*>(p.out +
                                  (size_t)((b * p.H + y) * p.W + x) * C +
                                  u * Tr::kVec) =
            *reinterpret_cast<const uint4*>(
                stage + stage_off<rows>(trow * 16 + r, u));
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(Shape<T, C>::kThreads,
                                  Shape<T, C>::kMinBlocks)
    dcn_fwd_kernel(const __grid_constant__ Params<T> p) {
  using S = Shape<T, C>;
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int NC = S::kNC;
  constexpr int KS = kLine / 32;  // k-steps of 32 bytes in a chunk
  constexpr int rows = S::kRows, SB = S::kStageBytes;
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();  // the swizzle needs 1024-byte alignment
  unsigned char* sA = smem + S::kWeightBytes;
  const uint32_t sA_u32 = base + S::kWeightBytes;
  {
    const uint4* src = reinterpret_cast<const uint4*>(p.weight);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < S::kWeightBytes / 16; i += S::kThreads)
      dst[i] = __ldg(src + i);
    fence_proxy_async();  // the weight, written here, is read by wgmma
  }

  const int my_tiles =
      p.ntiles > (int)blockIdx.x
          ? (p.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;
  const int steps = my_tiles * 9;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int trow = warp;  // the tile row of this warp's 16 rows
  Pix px[S::kPix];
  if (steps > 0) {
    tile_pixels<T, C>(px, p, blockIdx.x);
    sample_tap<T, C>(sA, p, px, 0);
  }
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  // this lane's ldmatrix row: pixel (lane & 7) + 8 * ((lane >> 3) & 1) of
  // the warp's 16
  const int arow = trow * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  for (int s = 0; s < steps; ++s) {
    const int tap = s % 9;
    const uint32_t stage = sA_u32 + (s & 1) * SB;
    uint32_t a[NC][KS][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int col = 2 * ks + (lane >> 4);
        ldmatrix_x4(a[c][ks], stage + c * rows * kLine + arow * kLine +
                                  ((col ^ (arow & 7)) << 4));
      }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        Wgmma<T, 64>::run(acc, a[c][ks],
                          desc_sw128(base + (c * 9 + tap) * S::kSlice) +
                              2 * ks,
                          (tap > 0 || c > 0 || ks > 0) ? 1 : 0);
    wgmma_commit();
    if (s + 1 < steps) {
      const int nt = (s + 1) % 9;
      if (nt == 0)
        tile_pixels<T, C>(px, p, blockIdx.x + (s + 1) / 9 * gridDim.x);
      sample_tap<T, C>(sA + ((s + 1) & 1) * SB, p, px, nt);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(acc[i]);
#pragma unroll
    for (int c = 0; c < NC; ++c)  // A stays live until its wgmma is done
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          asm volatile("" : "+r"(a[c][ks][j])::"memory");
    __syncthreads();
    if (tap == 8) {
      epilogue<T, C>(acc, p, sA + (s & 1) * SB,
                     blockIdx.x + s / 9 * gridDim.x, trow, lane);
      __syncthreads();
    }
  }
}

// ------------------------------------------------ C = 128: dcn_fwd_kernel128

// The raw offsets and mask of one (pixel, group, tap), loaded a step ahead
// of their use and converted there, so that their loads stay in flight
// beside this step's gathers.
template <typename T>
struct RawOffMask;

template <>
struct RawOffMask<__nv_bfloat16> {
  __nv_bfloat162 d;
  __nv_bfloat16 m;
};

template <>
struct RawOffMask<float> {
  float2 d;
  float m;
};

template <typename T>
__device__ __forceinline__ void load_raw(RawOffMask<T>& r, const OffMask<T>& om,
                                         int p, int g, int tap) {
  using Pair =
      typename std::conditional<std::is_same<T, float>::value, float2,
                                __nv_bfloat162>::type;
  r.d = __ldg(reinterpret_cast<const Pair*>(
      om.off + (size_t)p * om.off_stride + g * 18 + 2 * tap));
  r.m = __ldg(om.msk + (size_t)p * om.msk_stride + g * 9 + tap);
}

// load_off_mask's values from the raw ones.
template <typename T>
__device__ __forceinline__ void convert_raw(const RawOffMask<T>& r, int logits,
                                            float& dy, float& dx, float& m) {
  using Tr = Traits<T>;
  if constexpr (std::is_same<T, float>::value) {
    dy = r.d.x, dx = r.d.y;
  } else {
    dy = __low2float(r.d), dx = __high2float(r.d);
  }
  const float raw = Tr::to_f(r.m);
  m = logits ? Tr::to_f(Tr::from_f(1.f / (1.f + expf(-raw)))) : raw;
}

// The epilogue of one MMA warp (mw): the 16 pixels of tile row 4 h + mw
// for each 64-row half h (accumulators acc[64 h ...]), all 128 columns,
// through the warp's staging rows in 128-byte column chunks, 16-byte
// stores.
template <typename T>
__device__ __forceinline__ void epilogue128(const float* acc,
                                            const Params<T>& p,
                                            unsigned char* stage, int tile,
                                            int mw, int lane) {
  using Tr = Traits<T>;
  using L = Fwd128<T>;
  constexpr int V = Tr::kVec, kGroupsOf8 = L::kE / 8;  // a chunk's columns
  const int g = lane >> 2, t = lane & 3;
  const int tx = tile % p.tiles_x, rest = tile / p.tiles_x;
  const int ty = rest % p.tiles_y, b = rest / p.tiles_y;
#pragma unroll
  for (int h = 0; h < L::kHalves; ++h) {
    const int y = ty * L::TH + 4 * h + mw;
#pragma unroll
    for (int cc = 0; cc < L::kNC; ++cc) {
#pragma unroll
      for (int ii = 0; ii < kGroupsOf8; ++ii) {
        const int i = cc * kGroupsOf8 + ii;  // columns 8 i ... 8 i + 7
        const int col = 8 * i + 2 * t;
        float b0 = 0.f, b1 = 0.f;
        if (p.bias != nullptr) {
          b0 = Tr::to_f(p.bias[col]);
          b1 = Tr::to_f(p.bias[col + 1]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          T* d = reinterpret_cast<T*>(stage + (g + 8 * hh) * L::kEpiLd) +
                 8 * ii + 2 * t;
          const float* a = acc + 64 * h + 4 * i + 2 * hh;
          d[0] = Tr::from_f(apply_act(a[0] + b0, p.act));
          d[1] = Tr::from_f(apply_act(a[1] + b1, p.act));
        }
      }
      __syncwarp();
      if (y < p.H) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // 16 pixels x 8 units
          const int it = lane + 32 * k, r = it >> 3, u = it & 7;
          const int x = tx * kTW + r;
          if (x < p.W)
            *reinterpret_cast<uint4*>(
                p.out + (size_t)((b * p.H + y) * p.W + x) * L::C +
                cc * L::kE + u * V) =
                *reinterpret_cast<const uint4*>(stage + r * L::kEpiLd +
                                                u * 16);
        }
      }
      __syncwarp();
    }
  }
}

// C = 128: sampling warps and an MMA warpgroup on mbarrier rings (a-d).
template <typename T>
__global__ void __launch_bounds__(Fwd128<T>::kThreads, 1)
    dcn_fwd_kernel128(const __grid_constant__ Params<T> p) {
  using L = Fwd128<T>;
  constexpr int C = L::C, NC = L::kNC, NI = L::kItems;
  constexpr int V = Traits<T>::kVec;
  constexpr int kSteps = 9 * NC;  // (chunk, tap) steps of a tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();  // the swizzle needs 1024-byte alignment
  const uint32_t bars = base + L::bar_off;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (L::kStages + s); };
  auto wfull = [&](int s) { return bars + 8 * (2 * L::kStages + s); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), L::kSampWarps);
      mbar_init(empty(s), 1);
    }
    for (int s = 0; s < L::kWs; ++s) mbar_init(wfull(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int my_tiles =
      p.ntiles > (int)blockIdx.x
          ? (p.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;
  // step n: tile n / kSteps, chunk (n % kSteps) / 9, tap n % 9 (chunk by
  // chunk: a chunk's 9 taps gather from one footprint, which L1 keeps)
  const int steps = my_tiles * kSteps;

  if (threadIdx.x >= L::kSampThreads) {  // --------- the MMA warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(L::kMmaRegs));
    const int mw = warp - L::kSampWarps;
    const bool leader = threadIdx.x == L::kSampThreads;
    // the weight slice (chunk, tap) of step m, packed at (chunk * 9 + tap)
    // = m % kSteps, into slot m % kWs
    auto load_w = [&](int m) {
      mbar_expect_tx(wfull(m % L::kWs), L::w_bytes);
      bulk_load(base + L::w_off + (m % L::kWs) * L::w_bytes,
                p.weight + (size_t)(m % kSteps) * L::w_bytes, L::w_bytes,
                wfull(m % L::kWs));
    };
    if (leader)
      for (int m = 0; m < L::kWs && m < steps; ++m) load_w(m);
    unsigned char* stage = smem + L::epi_off + mw * 16 * L::kEpiLd;
    // the leader frees step m's A stage and weight slot (its product done)
    // and fills the slot with step m + kWs's weight
    auto release = [&](int m) {
      if (!leader) return;
      mbar_arrive(empty(m % L::kStages));
      if (m + L::kWs < steps) load_w(m + L::kWs);
    };
    float acc[64 * L::kHalves];  // 64-row m-tile h in acc[64 h ...]
    int n = 0;  // the step
    for (int k = 0; k < my_tiles; ++k) {
      for (int local = 0; local < kSteps; ++local, ++n) {
        const int s = n % L::kStages, ws = n % L::kWs;
        mbar_sleep_wait(wfull(ws), (n / L::kWs) & 1);
        mbar_sleep_wait(full(s), (n / L::kStages) & 1);
        const uint32_t a_s = base + s * L::a_bytes;
        const uint32_t w_s = base + L::w_off + ws * L::w_bytes;
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h)
#pragma unroll
          for (int ks = 0; ks < kLine / 32; ++ks)
            WgmmaSS<T, 128>::run(acc + 64 * h,
                                 desc_sw128(a_s + h * 64 * kLine) + 2 * ks,
                                 desc_sw128(w_s) + 2 * ks,
                                 (local > 0 || ks > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();  // step n - 1's product done: its slots are free
        if (local > 0) {
          named_sync(1, 128);  // every warp of the warpgroup past its wait
          release(n - 1);
        }
      }
      wgmma_wait<0>();  // the tile's sums, for the epilogue
#pragma unroll
      for (int i = 0; i < 64 * L::kHalves; ++i) fence_operand(acc[i]);
      named_sync(1, 128);
      release(n - 1);
      epilogue128<T>(acc, p, stage, blockIdx.x + k * (int)gridDim.x, mw,
                     lane);
    }
    return;
  }

  // ------------------------------------------------------ the sampling warps
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(L::kSampRegs));
  // lane: 16-byte unit u of the chunk rows (A stage rows) q(j) = 8 warp +
  // 4 j + q0 of the tile's pixels, j < 2: a warp's load covers 4 pixels'
  // rows.  Lanes u and u ^ 1 (lane ^ 1) sample the same (pixel, group) for
  // each j, so each finds the corners of item jc = lane & 1 and takes the
  // other item's from its partner.
  const int u = lane & 7, q0 = lane >> 3, jc = lane & 1;
  auto q = [&](int j) { return 4 * NI * warp + 4 * j + q0; };
  // the pixel index (-1 past the image) and coordinates of item jc at step n
  auto pixel = [&](int n, int& pix, int& y, int& x) {
    const int tile = blockIdx.x + n / kSteps * (int)gridDim.x;
    const int tx = tile % p.tiles_x, rest = tile / p.tiles_x;
    const int ty = rest % p.tiles_y, b = rest / p.tiles_y;
    y = ty * L::TH + q(jc) / kTW;
    x = tx * kTW + q(jc) % kTW;
    pix = y < p.H && x < p.W ? (b * p.H + y) * p.W + x : -1;
  };
  // the group of this lane's unit in chunk c
  auto group = [&](int c) {
    return (c * kLine + u * 16) / (16 * (int)sizeof(T));
  };
  RawOffMask<T> raw;
  int pix = -1, ys = 0, xs = 0;
  if (steps > 0) {
    pixel(0, pix, ys, xs);
    if (pix >= 0) load_raw(raw, p.om, pix, group(0), 0);
  }
  for (int n = 0; n < steps; ++n) {
    const int s = n % L::kStages, c = n % kSteps / 9, tap = n % 9;
    float dy = 0.f, dx = 0.f, m = 0.f;
    if (pix >= 0) convert_raw(raw, p.om.logits, dy, dx, m);
    // item jc's corners, the other's from the partner lane
    Corners own = corners(dy, dx, pix, ys, xs, tap, p.H, p.W, p.max_off,
                          p.clamp), other;
    int bits = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      own.valid[k] = own.valid[k] && pix >= 0;
      bits |= own.valid[k] << k;
    }
    bits = __shfl_xor_sync(~0u, bits, 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      other.cw[k] = __shfl_xor_sync(~0u, own.cw[k], 1);
      other.pix[k] = __shfl_xor_sync(~0u, own.pix[k], 1);
      other.valid[k] = (bits >> k) & 1;
    }
    const float m_other = __shfl_xor_sync(~0u, m, 1);
    // both items' 8 corner loads in flight together
    const int ch0 = c * L::kE + u * V;
    GroupCorners<T, V> e_own, e_other;
    gather<T, C, V>(e_own, p.x, own, ch0);
    gather<T, C, V>(e_other, p.x, other, ch0);
    // the next step's offsets and mask, in flight beside the gathers
    if (n + 1 < steps) {
      if ((n + 1) % kSteps == 0) pixel(n + 1, pix, ys, xs);
      if (pix >= 0)
        load_raw(raw, p.om, pix, group((n + 1) % kSteps / 9), (n + 1) % 9);
    }
    // each item's 16 bytes of A, rounded as the tensor cores take them
    uint4 a_own, a_other;
    {
      float val[V];
      blend(val, e_own, own);
#pragma unroll
      for (int i = 0; i < V; ++i) val[i] *= m;
      store_vec_mma<T>(reinterpret_cast<T*>(&a_own), val);
      blend(val, e_other, other);
#pragma unroll
      for (int i = 0; i < V; ++i) val[i] *= m_other;
      store_vec_mma<T>(reinterpret_cast<T*>(&a_other), val);
    }
    mbar_sleep_wait(empty(s), ((n / L::kStages) & 1) ^ 1);
    unsigned char* a = smem + s * L::a_bytes;
    const int r_own = q(jc), r_other = q(jc ^ 1);  // the stage rows
    *reinterpret_cast<uint4*>(a + r_own * kLine + ((u ^ (r_own & 7)) << 4)) =
        a_own;
    *reinterpret_cast<uint4*>(a + r_other * kLine +
                              ((u ^ (r_other & 7)) << 4)) = a_other;
    fence_proxy_async();  // wgmma reads the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(full(s));
  }
}

template <typename T, int C>
int launch_c(const Params<T>& p0, int B, void* stream) {
  using S = Shape<T, C>;
  Params<T> p = p0;
  p.tiles_x = (p.W + kTW - 1) / kTW;
  p.tiles_y = (p.H + S::TH - 1) / S::TH;
  p.ntiles = B * p.tiles_x * p.tiles_y;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaFuncSetAttribute(dcn_fwd_kernel<T, C>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         S::kSmem);
    attribute_set = true;
  }
  const int cap = S::kMinBlocks * sm_count();
  const int grid = p.ntiles < cap ? p.ntiles : cap;
  if (grid > 0)
    dcn_fwd_kernel<T, C><<<grid, S::kThreads, S::kSmem,
                           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch128(const Params<T>& p0, int B, void* stream) {
  using L = Fwd128<T>;
  Params<T> p = p0;
  p.tiles_x = (p.W + kTW - 1) / kTW;
  p.tiles_y = (p.H + L::TH - 1) / L::TH;
  p.ntiles = B * p.tiles_x * p.tiles_y;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaFuncSetAttribute(dcn_fwd_kernel128<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         L::kSmem);
    attribute_set = true;
  }
  const int grid = p.ntiles < sm_count() ? p.ntiles : sm_count();
  if (grid > 0)
    dcn_fwd_kernel128<T><<<grid, L::kThreads, L::kSmem,
                           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Error code of the host side, beside cudaGetLastError()'s.
constexpr int kErrWidth = 9102;

template <typename T>
int entry(const void* x, const void* off, int off_stride, const void* msk,
          int msk_stride, int logits, const void* weight, void* packed,
          const void* bias, void* out, int B, int H, int W, int C, int act,
          float max_off, int clamp, void* stream) {
  if (C != 64 && C != 128) return kErrWidth;
  int err = pack_weight<T>(weight, packed, C, C, C, stream);
  if (err != 0) return err;
  Params<T> p;
  p.x = (const T*)x;
  p.om = OffMask<T>{(const T*)off, (const T*)msk, off_stride, msk_stride,
                    logits};
  p.weight = (const unsigned char*)packed;
  p.bias = (const T*)bias;
  p.out = (T*)out;
  p.H = H, p.W = W, p.act = act, p.clamp = clamp, p.max_off = max_off;
  return C == 64 ? launch_c<T, 64>(p, B, stream) : launch128<T>(p, B, stream);
}

}  // namespace fwd
}  // namespace rvsr

// x (B,H,W,C), C = 64 or 128 in 8 deformable groups; offsets of pixel p at
// off + p * off_stride, laid out (group, tap, (dy, dx)); the mask at msk +
// p * msk_stride, (group, tap), through the sigmoid already (logits == 0)
// or logits (logits != 0); weight (C, C, 3, 3) OIHW, packed into `packed`
// (C * 9 * C elements of scratch) first; bias (C) or null; out (B,H,W,C).
// act: 0 none, 1 relu, 2 lrelu(0.1).  clamp != 0 clips every offset to
// [-max_off, max_off].  Returns cudaGetLastError(), or 9102 (another C).
extern "C" int dcn_fwd_bf16(const void* x, const void* off, int off_stride,
                            const void* msk, int msk_stride, int logits,
                            const void* weight, void* packed,
                            const void* bias, void* out, int B, int H, int W,
                            int C, int act, float max_off, int clamp,
                            void* stream) {
  return rvsr::fwd::entry<__nv_bfloat16>(x, off, off_stride, msk, msk_stride,
                                         logits, weight, packed, bias, out, B,
                                         H, W, C, act, max_off, clamp, stream);
}

extern "C" int dcn_fwd_f32(const void* x, const void* off, int off_stride,
                           const void* msk, int msk_stride, int logits,
                           const void* weight, void* packed, const void* bias,
                           void* out, int B, int H, int W, int C, int act,
                           float max_off, int clamp, void* stream) {
  return rvsr::fwd::entry<float>(x, off, off_stride, msk, msk_stride, logits,
                                 weight, packed, bias, out, B, H, W, C, act,
                                 max_off, clamp, stream);
}
