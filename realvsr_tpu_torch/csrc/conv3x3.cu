// NHWC 3x3 / stride 1 / SAME convolution with a fused epilogue, on Hopper's
// wgmma and TMA: f32 accumulator + bias (optional), then relu or lrelu(0.1)
// or nothing, then the cast to the output type, then + residual (added after
// the activation, as in ResidualBlockNoBN).  The input may come as two
// tensors whose channels are concatenated (PCD's concat(nbr, ref) convs)
// without a copy.
//
// Replaces two TPU kernels of realvsr_tpu/ops/pallas/conv3x3_kernel.py:
// `_packed_pallas` (public `conv3x3_packed`, with `splits` for concat inputs,
// 64 output channels on the model paths) and `conv3x3_fused` (the plain NHWC
// conv at any output width).  The TPU's pair packing and lane panels exist
// only for its 128-lane DMA rule and are not carried over.
//
// Bound on the H100 (bf16): 64->64 at (3, 512, 1024) is 116 GFLOP against
// 0.4 GB, 0.12 ms either way (at the ridge); 128->64 is 232 GFLOP, 0.23 ms
// of products; 64->216 and 64->256 are bound by their products; 64->3 by
// reading its input.  So the design keeps the tensor cores fed and reads
// each input byte about once.
//
// Design, one persistent block per SM (grid = min(tiles, SMs)), each walking
// the output tiles blockIdx.x, blockIdx.x + gridDim.x, ... of 8 x 16 pixels
// (tile index = (b * tiles_y + ty) * tiles_x + tx).  One thread of warpgroup
// 2 produces (setmaxnreg 40), warpgroups 0 and 1 (setmaxnreg 232; 4 tile
// rows = 64 pixels each) consume:
// 1. Products on wgmma (m64nNk16 bf16, m64nNk8 TF32), N = cout padded to
//    one of gen_wgmma.py's widths (8 ... 256), so 216 and 256 outputs run
//    the 9 taps once and 64->3 runs N = 8.  B, the weight, is K-major in
//    shared memory with the 128-byte swizzle and read through descriptors,
//    once per warpgroup.  A comes from the halo through registers
//    (ldmatrix): each lane gives its own pixel's row address, so the
//    (dy, dx) shift of a tap costs nothing; a shared-memory A descriptor
//    needs its 64 rows in 8-row groups at one stride, which a shifted
//    window of a halo (18 pixels a row) is not.  A for tap t + 1 is loaded
//    while tap t's wgmmas run (two register sets, wgmma.wait_group 1).
// 2. Weights copied (cp.async.bulk, no register round trip) once per block
//    and kept when they fit with the halo ring (64->64 and 128->64 bf16,
//    64->64 f32, every cout <= 128); else (216 and 256 outputs, 128->64
//    f32) streamed tap by tap through a ring of 3 mbarrier stages, re-read
//    from L2 for each tile.  pack_weight_kernel, launched before each
//    conv, lays the weight out as the image shared memory needs:
//    [chunk][tap][N][128 bytes], swizzled, zero rows past cout,
//    TF32-rounded for f32.
// 3. The halo is loaded by TMA, one 128-byte channel chunk (64 bf16 / 32
//    f32 channels) of the (8+2) x (16+2) window per stage, at signed
//    coordinates (x0 - 1, y0 - 1): TMA fills what lies outside the image
//    with zeros, which is the SAME padding.  x2 is a second tensor map
//    whose chunks follow x1's.  A ring of 2-4 stages (as shared memory
//    allows) lets the producer run ahead by whole chunks, so the next
//    tile's loads overlap this tile's products.  The producer polls the
//    halo and weight rings together, so neither waits behind the other.
// 4. The epilogue keeps bias, act and cast in registers, stages each warp's
//    16 pixels x 128 bytes of outputs in shared memory, and stores them
//    (and reads the residual) in 16-byte vectors; element by element only
//    where a row of cout elements is not a whole number of 16-byte vectors
//    (cout 3).  The ragged edges in H, W and cout are predicated.
// 5. Input widths that are not whole chunks, and cout > 256, run the
//    mma.sync kernel of conv3x3_sync.cu (chosen by the wrapper up front);
//    no conv of the model paths does.
#include <cuda.h>

#include "common.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace rvsr {
namespace wg {

constexpr int kTH = 8, kTW = 16;                    // output tile
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;   // its input window
constexpr int kPlaneBytes = kHaloH * kHaloW * kLine;            // 23040
constexpr int kStageBytes = (kPlaneBytes + 1023) / 1024 * 1024;  // 23552
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
// a wait this long (cycles: seconds at the H100's clocks) is a fault: the
// kernel traps, which the next CUDA call reports, rather than hang the card
constexpr long long kWatchdog = 1LL << 33;
constexpr int kEpiRows = 16, kEpiPad = 8;  // per warp: 16 pixels x 128 B

struct Params {
  const unsigned char* weight;  // packed, see the note above
  const void* bias;
  const void* residual;
  void* out;
  int B, H, W, cout, act;
  int nchunk, n1;  // 128-byte chunks in all, of which x1's
  int resident, sh, sw;
  int tiles_x, tiles_y, ntiles;
  int halo_off, epi_off, bar_off;  // shared-memory offsets (bytes)
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_ready(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_ready(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_ready(bar, parity))
    if (clock64() - t0 > kWatchdog) __trap();
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A fragments of one tap for this warp's 16 pixels: 4 k-steps of 32 bytes
// (16 bf16 / 8 TF32 channels) of a 128-byte chunk.  Lane i addresses pixel
// (i & 7) + 8 * ((i >> 3) & 1) of the warp's row at 16-byte column
// 2 * ks + (i >> 4), through the TMA's swizzle (column ^ line & 7).
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t plane,
                                       int hp_base, int tap, int lane) {
  const int dy = tap / 3, dx = tap % 3;
  const int hp = hp_base + dy * kHaloW + dx;
  const uint32_t row = plane + hp * kLine;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int col = 2 * ks + (lane >> 4);
    ldmatrix_x4(a[ks], row + ((col ^ (hp & 7)) << 4));
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        asm("cvt.rna.tf32.f32 %0, %1;"
            : "=r"(a[ks][j])
            : "f"(__uint_as_float(a[ks][j])));
    }
  }
}

// The epilogue of one warp: its 16 pixels (row gy, columns gx0 ... gx0+15)
// by the N accumulator columns, in 128-byte column chunks through the
// warp's staging tile.
template <typename T, int N>
__device__ __forceinline__ void epilogue(const float* acc, const Params& p,
                                         T* stage, long long pix0, int gy,
                                         int gx0, int lane) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;            // elements in 16 bytes
  constexpr int kCols = kLine / sizeof(T);  // columns per chunk
  constexpr int ld = kCols + kEpiPad;
  const int g = lane >> 2, t = lane & 3;
  const T* bias = static_cast<const T*>(p.bias);
  const T* res = static_cast<const T*>(p.residual);
  T* out = static_cast<T*>(p.out);
  const int cout = p.cout;
  const bool vec = cout % V == 0;
  constexpr int kPer = kEpiRows * (kLine / 16) / 32;  // vectors a lane
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += kCols) {
    const int nw = N - n0 < kCols ? N - n0 : kCols;
    const int nv = nw / V;  // vectors a row
    // the residual's loads first, in flight while the tile is staged
    uint4 rr[kPer];
    if (vec && res != nullptr) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int it = lane + 32 * k, r = it / nv, c = n0 + (it % nv) * V;
        if (it < kEpiRows * nv && gy < p.H && gx0 + r < p.W && c < cout)
          rr[k] = __ldg(
              reinterpret_cast<const uint4*>(res + (pix0 + r) * cout + c));
      }
    }
#pragma unroll
    for (int i = n0 / 8; i < (n0 + nw) / 8; ++i) {
      const int col = 8 * i + 2 * t;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        if (col < cout) b0 = Tr::to_f(bias[col]);
        if (col + 1 < cout) b1 = Tr::to_f(bias[col + 1]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        T* s = stage + (g + 8 * half) * ld + col - n0;
        s[0] = Tr::from_f(apply_act(acc[4 * i + 2 * half] + b0, p.act));
        s[1] = Tr::from_f(apply_act(acc[4 * i + 2 * half + 1] + b1, p.act));
      }
    }
    __syncwarp();
    if (vec) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int it = lane + 32 * k, r = it / nv, c = n0 + (it % nv) * V;
        if (it >= kEpiRows * nv || gy >= p.H || gx0 + r >= p.W || c >= cout)
          continue;
        uint4 raw = *reinterpret_cast<const uint4*>(stage + r * ld + c - n0);
        if (res != nullptr) {
          T* e = reinterpret_cast<T*>(&raw);
          const T* re = reinterpret_cast<const T*>(&rr[k]);
#pragma unroll
          for (int j = 0; j < V; ++j)
            e[j] = Tr::from_f(Tr::to_f(e[j]) + Tr::to_f(re[j]));
        }
        *reinterpret_cast<uint4*>(out + (pix0 + r) * cout + c) = raw;
      }
    } else {  // rows of cout elements are not whole 16-byte vectors
      for (int it = lane; it < kEpiRows * nw; it += 32) {
        const int r = it / nw, c = n0 + it % nw;
        if (gy >= p.H || gx0 + r >= p.W || c >= cout) continue;
        const long long o = (pix0 + r) * cout + c;
        T v = stage[r * ld + c - n0];
        if (res != nullptr) v = Tr::from_f(Tr::to_f(v) + Tr::to_f(res[o]));
        out[o] = v;
      }
    }
    __syncwarp();
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_wgmma(const __grid_constant__ CUtensorMap map1,
                  const __grid_constant__ CUtensorMap map2, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr uint32_t kSlice = N * kLine;  // one tap of one chunk
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();  // the swizzle needs 1024-byte alignment
  const uint32_t sW = base, sHalo = base + p.halo_off;
  const uint32_t bars = base + p.bar_off;
  const int sh = p.sh, sw = p.sw;
  // barriers: full_h[sh], empty_h[sh], full_w[sw], empty_w[sw], wres
  auto full_h = [&](int s) { return bars + 8 * s; };
  auto empty_h = [&](int s) { return bars + 8 * (sh + s); };
  auto full_w = [&](int s) { return bars + 8 * (2 * sh + s); };
  auto empty_w = [&](int s) { return bars + 8 * (2 * sh + sw + s); };
  const uint32_t wres = bars + 8 * (2 * sh + 2 * sw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < sh; ++s) {
      mbar_init(full_h(s), 1);
      mbar_init(empty_h(s), kConsumers);
    }
    for (int s = 0; s < sw; ++s) {
      mbar_init(full_w(s), 1);
      mbar_init(empty_w(s), kConsumers);
    }
    mbar_init(wres, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nchunk = p.nchunk;
  const int my_tiles =
      p.ntiles > (int)blockIdx.x
          ? (p.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;
  const int units = my_tiles * nchunk;  // (tile, chunk) pairs, chunk fastest

  if (threadIdx.x >= kConsumers) {  // ---------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != kConsumers) return;
    if (p.resident) {
      mbar_expect_tx(wres, nchunk * 9 * kSlice);
      for (int i = 0; i < nchunk * 9; ++i)
        bulk_load(sW + i * kSlice, p.weight + (size_t)i * kSlice, kSlice,
                  wres);
    }
    const int wtotal = p.resident ? 0 : units * 9;
    int hu = 0, wq = 0;
    long long t0 = clock64();
    while (hu < units || wq < wtotal) {
      if (clock64() - t0 > kWatchdog) __trap();
      if (hu < units &&
          mbar_ready(empty_h(hu % sh), ((hu / sh) & 1) ^ 1)) {
        const int tile = blockIdx.x + (hu / nchunk) * gridDim.x;
        const int ci = hu % nchunk;
        const int tx = tile % p.tiles_x;
        const int ty = (tile / p.tiles_x) % p.tiles_y;
        const int b = tile / (p.tiles_x * p.tiles_y);
        const int s = hu % sh;
        mbar_expect_tx(full_h(s), kPlaneBytes);
        const bool first = ci < p.n1;
        tma_load_4d(sHalo + s * kStageBytes, first ? &map1 : &map2,
                    (first ? ci : ci - p.n1) * (kLine / (int)sizeof(T)),
                    tx * kTW - 1, ty * kTH - 1, b, full_h(s));
        ++hu;
        t0 = clock64();
      }
      if (wq < wtotal && mbar_ready(empty_w(wq % sw), ((wq / sw) & 1) ^ 1)) {
        const int s = wq % sw;
        const int slice = ((wq / 9) % nchunk) * 9 + wq % 9;  // chunk, tap
        mbar_expect_tx(full_w(s), kSlice);
        bulk_load(sW + s * kSlice, p.weight + (size_t)slice * kSlice, kSlice,
                  full_w(s));
        ++wq;
        t0 = clock64();
      }
    }
    return;
  }

  // --------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  // this warp's tile row (warpgroup g, warps 4g ... 4g + 3, takes rows
  // 4g ... 4g + 3: its 64 pixels, 16 a warp)
  const int trow = warp;
  const int hp_base = trow * kHaloW + (lane & 7) + ((lane >> 3) & 1) * 8;
  T* stage = reinterpret_cast<T*>(smem + p.epi_off) +
             warp * kEpiRows * (kLine / sizeof(T) + kEpiPad);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  if (p.resident) mbar_wait(wres, 0);
  int wq = 0;
  for (int u = 0; u < units; ++u) {
    const int ci = u % nchunk, s = u % sh;
    mbar_wait(full_h(s), (u / sh) & 1);
    const uint32_t plane = sHalo + s * kStageBytes;
    // A register sets: two (tap t + 1 loads while tap t runs), or for
    // N <= 16, whose taps are too short to hide a wait, one per tap (no
    // wait inside a resident unit)
    constexpr int KA = N <= 16 ? 9 : 2;
    uint32_t a[KA][4][4];
    load_a<T>(a[0], plane, hp_base, 0, lane);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t slice;
      if (p.resident) {
        slice = sW + (ci * 9 + tap) * kSlice;
      } else {
        mbar_wait(full_w(wq % sw), (wq / sw) & 1);
        slice = sW + (wq % sw) * kSlice;
      }
      const uint64_t desc = desc_sw128(slice);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<T, N>::run(acc, a[tap % KA][ks], desc + 2 * ks,
                         (ci > 0 || tap > 0 || ks > 0) ? 1 : 0);
      wgmma_commit();
      if (tap < 8) {
        if (KA == 2 || !p.resident) {
          wgmma_wait<1>();  // tap - 1 done: its weights and A set are free
          if (!p.resident && tap > 0) mbar_arrive(empty_w((wq - 1) % sw));
        }
        load_a<T>(a[(tap + 1) % KA], plane, hp_base, tap + 1, lane);
      }
      if (!p.resident) ++wq;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
    if (!p.resident) {  // taps 7 and 8
      mbar_arrive(empty_w((wq - 2) % sw));
      mbar_arrive(empty_w((wq - 1) % sw));
    }
    mbar_arrive(empty_h(s));
    if (ci == nchunk - 1) {
      const int tile = blockIdx.x + (u / nchunk) * gridDim.x;
      const int tx = tile % p.tiles_x;
      const int ty = (tile / p.tiles_x) % p.tiles_y;
      const int b = tile / (p.tiles_x * p.tiles_y);
      const int gy = ty * kTH + trow, gx0 = tx * kTW;
      const long long pix0 = ((long long)b * p.H + gy) * p.W + gx0;
      epilogue<T, N>(acc, p, stage, pix0, gy, gx0, lane);
    }
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// Error codes of the host side, beside cudaGetLastError()'s.
constexpr int kErrNoEncode = 9001, kErrEncode = 9002, kErrSmem = 9003,
              kErrWidth = 9004;

// Tensor map of an NHWC tensor (B, H, W, C) with a box of one 128-byte
// channel chunk by the halo window, 128-byte swizzle, zeros outside.
template <typename T>
int encode_halo(CUtensorMap* map, const void* x, int B, int H, int W, int C) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {C * es, (cuuint64_t)W * C * es,
                                 (cuuint64_t)H * W * C * es};
  const cuuint32_t box[4] = {(cuuint32_t)(kLine / es), kHaloW, kHaloH, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map,
         std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         4, const_cast<void*>(x), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <typename T, int N>
int launch_n(const void* x1, int c1, const void* x2, int c2,
             const void* weight, const void* bias, const void* residual,
             void* out, int B, int H, int W, int cout, int act,
             void* stream) {
  constexpr int kCh = kLine / sizeof(T);
  constexpr int kSmemMax = 232448;
  Params p;
  p.weight = static_cast<const unsigned char*>(weight);
  p.bias = bias;
  p.residual = residual;
  p.out = out;
  p.B = B, p.H = H, p.W = W, p.cout = cout, p.act = act;
  p.n1 = c1 / kCh;
  p.nchunk = (c1 + c2) / kCh;
  p.tiles_x = (W + kTW - 1) / kTW;
  p.tiles_y = (H + kTH - 1) / kTH;
  p.ntiles = B * p.tiles_x * p.tiles_y;
  const int slice = N * kLine;
  const int epi = 8 * kEpiRows * (kCh + kEpiPad) * (int)sizeof(T);
  const int bar_bytes = 8 * (2 * 4 + 2 * 3 + 1);
  const int all_w = p.nchunk * 9 * slice;
  p.resident = all_w + 2 * kStageBytes + epi + bar_bytes <= kSmemMax;
  p.sw = p.resident ? 0 : 3;
  const int w_bytes = p.resident ? all_w : p.sw * slice;
  p.sh = (kSmemMax - w_bytes - epi - bar_bytes) / kStageBytes;
  if (p.sh > 4) p.sh = 4;
  if (p.sh < 2) return kErrSmem;
  p.halo_off = w_bytes;
  p.epi_off = p.halo_off + p.sh * kStageBytes;
  p.bar_off = p.epi_off + epi;
  const int smem = p.bar_off + bar_bytes;

  CUtensorMap m1, m2;
  int err = encode_halo<T>(&m1, x1, B, H, W, c1);
  if (err == 0) err = x2 != nullptr ? encode_halo<T>(&m2, x2, B, H, W, c2)
                                    : encode_halo<T>(&m2, x1, B, H, W, c1);
  if (err != 0) return err;
  static bool attribute_set = false;  // once: launches ask for less or equal
  if (!attribute_set) {
    cudaFuncSetAttribute(conv3x3_wgmma<T, N>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemMax);
    attribute_set = true;
  }
  const int grid = p.ntiles < sm_count() ? p.ntiles : sm_count();
  if (grid > 0)
    conv3x3_wgmma<T, N><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        m1, m2, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x1, int c1, const void* x2, int c2, const void* weight,
           const void* bias, const void* residual, void* out, int B, int H,
           int W, int cout, int n, int act, void* stream) {
#define RVSR_N(NN)                                                          \
  case NN:                                                                  \
    return launch_n<T, NN>(x1, c1, x2, c2, weight, bias, residual, out, B, \
                           H, W, cout, act, stream);
  switch (n) {
    RVSR_N(8)
    RVSR_N(16)
    RVSR_N(32)
    RVSR_N(64)
    RVSR_N(128)
    RVSR_N(216)
    RVSR_N(256)
    default:
      return kErrWidth;
  }
#undef RVSR_N
}

}  // namespace wg
}  // namespace rvsr

// weight (cout, cin, 3, 3) OIHW -> packed (cin * 9 * n elements), the image
// conv3x3_bf16 / conv3x3_f32 take.  Returns cudaGetLastError().
extern "C" int conv3x3_pack_bf16(const void* weight, void* packed, int cout,
                                 int cin, int n, void* stream) {
  return rvsr::pack_weight<__nv_bfloat16>(weight, packed, cout, cin, n, stream);
}

extern "C" int conv3x3_pack_f32(const void* weight, void* packed, int cout,
                                int cin, int n, void* stream) {
  return rvsr::pack_weight<float>(weight, packed, cout, cin, n, stream);
}

// x1 (B,H,W,c1) and optional x2 (B,H,W,c2): the input is their channel
// concat, c1 and c2 whole 128-byte chunks (multiples of 64 bf16 / 32 f32);
// weight (cout, c1 + c2, 3, 3) OIHW, laid out by pack_weight_kernel for n
// output columns (n one of gen_wgmma.py's WIDTHS, >= cout) into packed
// (scratch of (c1 + c2) * 9 * n elements) first; bias (cout) or null; residual
// (B,H,W,cout) or null; out (B,H,W,cout).  act: 0 none, 1 relu, 2
// lrelu(0.1).  Returns cudaGetLastError(), or 9001 (no
// cuTensorMapEncodeTiled in the driver), 9002 (a tensor map refused), 9003
// (shared memory), 9004 (n not instantiated).
extern "C" int conv3x3_bf16(const void* x1, int c1, const void* x2, int c2,
                            const void* weight, void* packed,
                            const void* bias, const void* residual, void* out,
                            int B, int H, int W, int cout, int n, int act,
                            void* stream) {
  int err = rvsr::pack_weight<__nv_bfloat16>(weight, packed, cout, c1 + c2, n,
                                          stream);
  if (err != 0) return err;
  return rvsr::wg::launch<__nv_bfloat16>(x1, c1, x2, c2, packed, bias,
                                         residual, out, B, H, W, cout, n, act,
                                         stream);
}

extern "C" int conv3x3_f32(const void* x1, int c1, const void* x2, int c2,
                           const void* weight, void* packed, const void* bias,
                           const void* residual, void* out, int B, int H,
                           int W, int cout, int n, int act, void* stream) {
  int err = rvsr::pack_weight<float>(weight, packed, cout, c1 + c2, n, stream);
  if (err != 0) return err;
  return rvsr::wg::launch<float>(x1, c1, x2, c2, packed, bias, residual, out,
                                 B, H, W, cout, n, act, stream);
}
