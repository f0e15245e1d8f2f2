// Modulated deformable convolution (DCNv2) forward, 3x3 / stride 1 / pad 1,
// NHWC, 64 -> 64 channels in 8 deformable groups, fused bias, optional relu
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
#include "dcn_sample.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace rvsr {
namespace fwd {

// A tile is TH rows of 16 pixels, TH * 16 rows of the product, one
// warpgroup per 64; a block has TH * 32 threads (one warp a tile row).
constexpr int kTW = 16;
constexpr int kPixPerThread = 4;  // (pixel, group) columns a thread samples
constexpr int kSlice = kCout * kLine;  // one tap of one chunk of the weight

// 128-byte chunks of a 64-channel row
template <typename T>
__host__ __device__ constexpr int chunks() {
  return kDcnC * (int)sizeof(T) / kLine;
}
template <typename T>
__host__ __device__ constexpr int weight_bytes() {
  return chunks<T>() * 9 * kSlice;
}
template <typename T, int TH>
__host__ __device__ constexpr int stage_bytes() {
  return chunks<T>() * TH * kTW * kLine;
}
template <typename T, int TH>
__host__ __device__ constexpr int smem_bytes() {
  return weight_bytes<T>() + 2 * stage_bytes<T, TH>();
}
// Tile rows: 16 in bf16 (one 512-thread block per SM: the resident weight
// once, and L1 left for the gathers), 8 in f32 (the weight takes 144 KB).
template <typename T>
__host__ __device__ constexpr int kTileRows() {
  return std::is_same<T, float>::value ? 8 : 16;
}
// blocks per SM, as shared memory allows
template <typename T, int TH>
__host__ __device__ constexpr int min_blocks() {
  return 2 * weight_bytes<T>() + 4 * stage_bytes<T, TH>() <= 227 * 1024 ? 2
                                                                          : 1;
}

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
// 16) of row r: [chunk u / 8][row][128 bytes], unit u % 8 at slot
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

template <typename T, int TH>
__device__ __forceinline__ void tile_pixels(Pix (&px)[kPixPerThread],
                                            const Params<T>& p, int tile) {
  const int tx = tile % p.tiles_x, rest = tile / p.tiles_x;
  const int ty = rest % p.tiles_y, b = rest / p.tiles_y;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int r = (threadIdx.x >> 3) + TH * 4 * k;
    const int y = ty * TH + (r >> 4), x = tx * kTW + (r & 15);
    px[k].y = y;
    px[k].x = x;
    px[k].p = y < p.H && x < p.W ? (b * p.H + y) * p.W + x : -1;
  }
}

// The thread's 4 (pixel, group) columns of one tap, into an A stage.
template <typename T, int TH>
__device__ __forceinline__ void sample_tap(unsigned char* stage,
                                           const Params<T>& p,
                                           const Pix (&px)[kPixPerThread],
                                           int tap) {
  constexpr int NV = GroupCorners<T>::kVecs;
  constexpr int V = Traits<T>::kVec;
  const int g = threadIdx.x & 7;
  // every item's offsets and mask first: their loads are in flight together
  float dy[kPixPerThread], dx[kPixPerThread], m[kPixPerThread];
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    dy[j] = dx[j] = m[j] = 0.f;
    if (px[j].p >= 0) load_off_mask(p.om, px[j].p, g, tap, dy[j], dx[j], m[j]);
  }
#pragma unroll
  for (int h = 0; h < kPixPerThread; h += 2) {
    Corners c[2];
    GroupCorners<T> e[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const Pix& q = px[h + j];
      c[j] = corners(dy[h + j], dx[h + j], q.p, q.y, q.x, tap, p.H, p.W,
                     p.max_off, p.clamp);
      if (q.p < 0)
#pragma unroll
        for (int k = 0; k < 4; ++k) c[j].valid[k] = false;
      gather(e[j], p.x, c[j], g);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float val[kDcnCpg];
      blend(val, e[j], c[j]);
#pragma unroll
      for (int i = 0; i < kDcnCpg; ++i) val[i] *= m[h + j];
      const int r = (threadIdx.x >> 3) + TH * 4 * (h + j);
#pragma unroll
      for (int v = 0; v < NV; ++v)
        store_vec_mma<T>(
            reinterpret_cast<T*>(stage + stage_off<TH * kTW>(r, g * NV + v)),
            val + v * V);
    }
  }
}

// Bias, activation and cast of one warp's 16 pixels (tile row `warp`),
// staged in the warp's rows of a finished A stage, then 16-byte stores.
template <typename T, int TH>
__device__ __forceinline__ void epilogue(const float* acc, const Params<T>& p,
                                         unsigned char* stage, int tile,
                                         int warp, int lane) {
  using Tr = Traits<T>;
  constexpr int U = kCout * (int)sizeof(T) / 16;  // 16-byte units a row
  constexpr int rows = TH * kTW;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kCout / 8; ++i) {
    const int col = 8 * i + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if (p.bias != nullptr) {
      b0 = Tr::to_f(p.bias[col]);
      b1 = Tr::to_f(p.bias[col + 1]);
    }
    const int byte = col * (int)sizeof(T);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + 8 * half;
      T* d = reinterpret_cast<T*>(stage + stage_off<rows>(r, byte >> 4) +
                                  (byte & 15));
      d[0] = Tr::from_f(apply_act(acc[4 * i + 2 * half] + b0, p.act));
      d[1] = Tr::from_f(apply_act(acc[4 * i + 2 * half + 1] + b1, p.act));
    }
  }
  __syncwarp();
  const int tx = tile % p.tiles_x, rest = tile / p.tiles_x;
  const int ty = rest % p.tiles_y, b = rest / p.tiles_y;
  const int y = ty * TH + warp;
  if (y < p.H) {
#pragma unroll
    for (int it = lane; it < 16 * U; it += 32) {
      const int r = it / U, u = it % U, x = tx * kTW + r;
      if (x < p.W)
        *reinterpret_cast<uint4*>(
            p.out + (size_t)((b * p.H + y) * p.W + x) * kCout +
            u * Tr::kVec) =
            *reinterpret_cast<const uint4*>(
                stage + stage_off<rows>(warp * 16 + r, u));
    }
  }
}

template <typename T, int TH>
__global__ void __launch_bounds__(TH * 32, (min_blocks<T, TH>()))
    dcn_fwd_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int NC = chunks<T>();
  constexpr int KS = kLine / 32;  // k-steps of 32 bytes in a chunk
  constexpr int kThreads = TH * 32, rows = TH * kTW;
  constexpr int SB = stage_bytes<T, TH>();
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();  // the swizzle needs 1024-byte alignment
  unsigned char* sA = smem + weight_bytes<T>();
  const uint32_t sA_u32 = base + weight_bytes<T>();
  {
    const uint4* src = reinterpret_cast<const uint4*>(p.weight);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < weight_bytes<T>() / 16; i += kThreads)
      dst[i] = __ldg(src + i);
  }
  fence_proxy_async();  // the weight, written here, is read by wgmma

  const int my_tiles =
      p.ntiles > (int)blockIdx.x
          ? (p.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;
  const int steps = my_tiles * 9;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Pix px[kPixPerThread];
  if (steps > 0) {
    tile_pixels<T, TH>(px, p, blockIdx.x);
    sample_tap<T, TH>(sA, p, px, 0);
  }
  __syncthreads();

  float acc[kCout / 2];
#pragma unroll
  for (int i = 0; i < kCout / 2; ++i) acc[i] = 0.f;
  // this lane's ldmatrix row: pixel (lane & 7) + 8 * ((lane >> 3) & 1) of
  // the warp's 16
  const int arow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
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
        Wgmma<T, kCout>::run(acc, a[c][ks],
                             desc_sw128(base + (c * 9 + tap) * kSlice) +
                                 2 * ks,
                             (tap > 0 || c > 0 || ks > 0) ? 1 : 0);
    wgmma_commit();
    if (s + 1 < steps) {
      const int nt = (s + 1) % 9;
      if (nt == 0)
        tile_pixels<T, TH>(px, p, blockIdx.x + (s + 1) / 9 * gridDim.x);
      sample_tap<T, TH>(sA + ((s + 1) & 1) * SB, p, px, nt);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kCout / 2; ++i) fence_operand(acc[i]);
#pragma unroll
    for (int c = 0; c < NC; ++c)  // A stays live until its wgmma is done
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          asm volatile("" : "+r"(a[c][ks][j])::"memory");
    __syncthreads();
    if (tap == 8) {
      epilogue<T, TH>(acc, p, sA + (s & 1) * SB,
                      blockIdx.x + s / 9 * gridDim.x, warp, lane);
      __syncthreads();
    }
  }
}

template <typename T, int TH>
int launch_th(const Params<T>& p0, int B, void* stream) {
  Params<T> p = p0;
  p.tiles_x = (p.W + kTW - 1) / kTW;
  p.tiles_y = (p.H + TH - 1) / TH;
  p.ntiles = B * p.tiles_x * p.tiles_y;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaFuncSetAttribute(dcn_fwd_kernel<T, TH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes<T, TH>());
    attribute_set = true;
  }
  const int cap = min_blocks<T, TH>() * sm_count();
  const int grid = p.ntiles < cap ? p.ntiles : cap;
  if (grid > 0)
    dcn_fwd_kernel<T, TH><<<grid, TH * 32, smem_bytes<T, TH>(),
                            (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, OffMask<T> om, const void* weight, void* packed,
           const void* bias, void* out, int B, int H, int W, int act,
           float max_off, int clamp, void* stream) {
  int err = pack_weight<T>(weight, packed, kCout, kDcnC, kCout, stream);
  if (err != 0) return err;
  Params<T> p;
  p.x = (const T*)x;
  p.om = om;
  p.weight = (const unsigned char*)packed;
  p.bias = (const T*)bias;
  p.out = (T*)out;
  p.H = H, p.W = W, p.act = act, p.clamp = clamp, p.max_off = max_off;
  return launch_th<T, kTileRows<T>()>(p, B, stream);
}

template <typename T>
int entry(const void* x, const void* off, int off_stride, const void* msk,
          int msk_stride, int logits, const void* weight, void* packed,
          const void* bias, void* out, int B, int H, int W, int act,
          float max_off, int clamp, void* stream) {
  const OffMask<T> om{(const T*)off, (const T*)msk, off_stride, msk_stride,
                      logits};
  return launch<T>(x, om, weight, packed, bias, out, B, H, W, act, max_off,
                   clamp, stream);
}

}  // namespace fwd
}  // namespace rvsr

// x (B,H,W,64); offsets of pixel p at off + p * off_stride, laid out
// (group, tap, (dy, dx)); the mask at msk + p * msk_stride, (group, tap),
// through the sigmoid already (logits == 0) or logits (logits != 0); weight
// (64, 64, 3, 3) OIHW, packed into `packed` (64 * 9 * 64 elements of
// scratch) first; bias (64) or null; out (B,H,W,64).  act: 0 none, 1 relu,
// 2 lrelu(0.1).  clamp != 0 clips every offset to [-max_off, max_off].
// Returns cudaGetLastError().
extern "C" int dcn_fwd_bf16(const void* x, const void* off, int off_stride,
                            const void* msk, int msk_stride, int logits,
                            const void* weight, void* packed,
                            const void* bias, void* out, int B, int H, int W,
                            int act, float max_off, int clamp, void* stream) {
  return rvsr::fwd::entry<__nv_bfloat16>(x, off, off_stride, msk, msk_stride,
                                         logits, weight, packed, bias, out, B,
                                         H, W, act, max_off, clamp, stream);
}

extern "C" int dcn_fwd_f32(const void* x, const void* off, int off_stride,
                           const void* msk, int msk_stride, int logits,
                           const void* weight, void* packed, const void* bias,
                           void* out, int B, int H, int W, int act,
                           float max_off, int clamp, void* stream) {
  return rvsr::fwd::entry<float>(x, off, off_stride, msk, msk_stride, logits,
                                 weight, packed, bias, out, B, H, W, act,
                                 max_off, clamp, stream);
}
