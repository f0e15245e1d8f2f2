// Modulated deformable convolution (DCNv2) forward, 3x3 / stride 1 / pad 1,
// NHWC, C -> C channels in 8 deformable groups, C = 64 or 128 (template
// parameter; dcn_narrow.cu takes every other C <= 64), fused bias, optional relu
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
// At C = 128 (EDVR-L: nf 128, 16 channels a group) the same loop runs with
// three changes, each an `if constexpr` on Shape<T, C> below, so the C = 64
// code is as it was:
// a. The weight does not fit: 128 x 9 x 128 is 288 KB in bf16 (576 in f32)
//    against 227 KB.  It is streamed tap by tap through a ring of two slots
//    (one tap of every chunk: 32 KB bf16, 64 KB f32), copied by the same
//    threads beside their gathers of step s + 1 and handed over by the
//    step's one __syncthreads, as the A stages are; it is re-read from L2
//    (the packed 288 KB stays there) once per tile and tap.  Splitting cout
//    into two 64-wide blocks would keep a resident half (147 KB bf16) but
//    gather every sample twice, and the gathers are the cost; in f32 even
//    a half does not fit.
// b. The output's 128 columns are two wgmma m64n64 halves: a warpgroup
//    takes 64 rows and one half (acc 32 registers, as at C = 64), so a
//    tile of TH x 16 pixels has 2 TH / 4 warpgroups: bf16 TH = 8 (512
//    threads, two 32 KB stages and the 64 KB ring: 128 KB), f32 TH = 4
//    (256 threads, 64 + 128 KB).
// c. A is read by wgmma from the stage through a shared-memory descriptor
//    (the stage is the 128-byte-swizzled K-major layout wgmma reads)
//    instead of ldmatrix into registers: at 2 (bf16) or 4 (f32) chunks a
//    row the register copy of A would take 32 or 64 registers a thread
//    and, beside the accumulators and a 16-channel gather in flight, spill
//    at 512 threads.  Each thread fences its stage writes for the async
//    proxy before the barrier.  A thread gathers one (pixel, group) at a
//    time (4 corners x 32 bytes bf16, 64 f32: as many bytes in flight as
//    two 8-channel ones).
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

// The instantiation at C input (and output) channels.
template <typename T, int C>
struct Shape {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kCpg = C / kGroups;
  static constexpr int kNC = C * (int)sizeof(T) / kLine;  // chunks of a row
  static constexpr int kHalves = C / 64;  // 64-wide output column blocks
  static constexpr bool kStream = C > 64;  // weight streamed (a), A from
                                           // shared memory (c)
  // tile rows: 16 in bf16 (one 512-thread block per SM: the resident weight
  // once, and L1 left for the gathers), 8 in f32 (the weight takes 144 KB);
  // half that at C = 128, where a row of pixels takes two warps
  static constexpr int TH = (kF32 ? 8 : 16) / kHalves;
  static constexpr int kRows = TH * kTW;
  static constexpr int kThreads = TH * 32 * kHalves;
  static constexpr int kPix = 4 / kHalves;    // (pixel, group) a thread
  static constexpr int kFlight = 2 / kHalves;  // gathered together
  static constexpr int kSlice = C * kLine;  // one tap of one chunk
  static constexpr int kTapBytes = kNC * kSlice;
  static constexpr int kWeightBytes = (kStream ? 2 : 9) * kTapBytes;
  static constexpr int kStageBytes = kNC * kRows * kLine;
  static constexpr int kSmem = kWeightBytes + 2 * kStageBytes;
  // blocks per SM, as shared memory allows
  static constexpr int kMinBlocks = 2 * kSmem <= 227 * 1024 ? 2 : 1;
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
  if constexpr (S::kStream) fence_proxy_async();  // wgmma reads the stage
}

// One tap of the packed weight ([chunk][tap][C rows][128 B]) into a ring
// slot ([chunk][C rows][128 B]), for wgmma after the next barrier (a).
template <typename T, int C>
__device__ __forceinline__ void copy_weight_tap(unsigned char* slot,
                                                const unsigned char* packed,
                                                int tap) {
  using S = Shape<T, C>;
  constexpr int kUnits = S::kSlice / 16;
  const uint4* src = reinterpret_cast<const uint4*>(packed);
  uint4* dst = reinterpret_cast<uint4*>(slot);
  for (int i = threadIdx.x; i < S::kNC * kUnits; i += S::kThreads) {
    const int c = i / kUnits;
    dst[i] = __ldg(src + (c * 9 + tap) * kUnits + (i - c * kUnits));
  }
  fence_proxy_async();
}

// Bias, activation and cast of one warp's 16 pixels (tile row `trow`) and
// 64 output columns (block `half`), staged in those rows and columns of a
// finished A stage, then 16-byte stores.
template <typename T, int C>
__device__ __forceinline__ void epilogue(const float* acc, const Params<T>& p,
                                         unsigned char* stage, int tile,
                                         int trow, int half, int lane) {
  using Tr = Traits<T>;
  using S = Shape<T, C>;
  constexpr int UH = 64 * (int)sizeof(T) / 16;  // 16-byte units of a half
  constexpr int rows = S::kRows;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 64 * half + 8 * i + 2 * t;
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
      const int r = it / UH, u = UH * half + it % UH, x = tx * kTW + r;
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
  if constexpr (!S::kStream) {
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
  // this warp's warpgroup: 64 rows (block rb) and 64 output columns
  constexpr int kRowBlocks = rows / 64;
  const int wg = warp >> 2;
  const int rb = S::kHalves > 1 ? wg % kRowBlocks : wg;
  const int half = S::kHalves > 1 ? wg / kRowBlocks : 0;
  const int trow = S::kHalves > 1 ? rb * 4 + (warp & 3) : warp;  // the tile
                                                 // row of its 16 rows
  Pix px[S::kPix];
  if (steps > 0) {
    tile_pixels<T, C>(px, p, blockIdx.x);
    if constexpr (S::kStream) copy_weight_tap<T, C>(smem, p.weight, 0);
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
    if constexpr (S::kStream) {
      const uint32_t slot = base + (s & 1) * S::kTapBytes + half * 64 * kLine;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          WgmmaSS<T, 64>::run(
              acc, desc_sw128(stage + c * rows * kLine + rb * 64 * kLine) +
                       2 * ks,
              desc_sw128(slot + c * S::kSlice) + 2 * ks,
              (tap > 0 || c > 0 || ks > 0) ? 1 : 0);
      wgmma_commit();
      if (s + 1 < steps) {
        const int nt = (s + 1) % 9;
        if (nt == 0)
          tile_pixels<T, C>(px, p, blockIdx.x + (s + 1) / 9 * gridDim.x);
        copy_weight_tap<T, C>(smem + ((s + 1) & 1) * S::kTapBytes, p.weight,
                              nt);
        sample_tap<T, C>(sA + ((s + 1) & 1) * SB, p, px, nt);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(acc[i]);
    } else {
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
    }
    __syncthreads();
    if (tap == 8) {
      epilogue<T, C>(acc, p, sA + (s & 1) * SB,
                     blockIdx.x + s / 9 * gridDim.x, trow, half, lane);
      __syncthreads();
    }
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
  return C == 64 ? launch_c<T, 64>(p, B, stream)
                 : launch_c<T, 128>(p, B, stream);
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
