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
// of products; 64->216, 64->256 and 128->512 are bound by their products;
// 64->3 by reading its input.  So the design keeps the tensor cores fed and
// reads each input byte about once.
//
// Design, one persistent block per SM (grid = min(tiles, SMs)), each walking
// the output tiles blockIdx.x, blockIdx.x + gridDim.x, ... of 8 x 16 pixels
// (tile index = (b * tiles_y + ty) * tiles_x + tx; past 256 outputs, see
// 5).  One thread of warpgroup
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
//    TF32-rounded for f32 (narrow inputs: 6).
// 3. The halo is loaded by TMA, one 128-byte channel chunk (64 bf16 / 32
//    f32 channels; narrow inputs: 6) of the (8+2) x (16+2) window per
//    stage, at signed coordinates (x0 - 1, y0 - 1): TMA fills what lies
//    outside the image with zeros, which is the SAME padding.  x2 is a
//    second tensor map whose chunks follow x1's.  A ring of 2-4 stages (as
//    shared memory allows) lets the producer run ahead by whole chunks, so
//    the next tile's loads overlap this tile's products.  The producer polls
//    the halo and weight rings together, so neither waits behind the other.
// 4. The epilogue keeps bias, act and cast in registers, stages each warp's
//    16 pixels x 128 bytes of outputs in shared memory, and stores them
//    (and reads the residual) in 16-byte vectors; element by element only
//    where a row of cout elements is not a whole number of 16-byte vectors
//    (cout 3, 300 in bf16).  The ragged edges in H, W and cout are
//    predicated.
// 5. More than 256 outputs (EDVR-L's upconv1, 128 -> 512): one wgmma's N
//    stops at 256, so the outputs split into column blocks of 256, the
//    last padded to one of the widths (512 = 256 + 256; 300 = 256 + 64,
//    whose last block runs m64n64 on the first 32 accumulators).  A work
//    item is (tile, column block), item = tile * ncb + block, walked as the
//    tiles are; its weight is the block's slice of the packed image
//    ([block][chunk][tap][256][128 bytes]; the last block's rows past cout
//    zero, and only its first N rows copied), always streamed (a block's
//    9 taps outgrow shared memory); its epilogue writes columns block * 256
//    onwards of rows cout apart, so bias, residual and output keep their
//    layout and a block offset of 256 keeps the 16-byte alignment.  Items,
//    not column blocks walked over one resident halo: the halo ring and
//    the weight stream stay those of a tile (any input width, the same
//    shared memory as at 256), and the blocks of one tile land on
//    neighbouring SMs at about the same time, so the second halo read is
//    an L2 hit (23 KB a chunk against 295 KB of weight a block and tile).
// 6. Narrow inputs: widths that are multiples of 16 but not whole 128-byte
//    chunks (the nf 16 debug configs' 16- and 32-wide inputs, 48) run the
//    same kernel on 32-byte chunks (CB = 32: 16 bf16 / 8 f32 channels, one
//    wgmma k-step), so every conv of the repo is on this design.  The halo's
//    tensor map, the ldmatrix rows of A (unit j of pixel row r at j ^ ((r
//    >> 2) & 1)) and the B descriptors (layout type 3, 8-row groups 256
//    bytes apart) take the 32-byte swizzle; x2's chunks follow x1's.  A
//    halo stage is then 5.6 KB and the weight small (16 -> 108: 36 KB
//    bf16), so where it is resident the blocks lay it out themselves from
//    the OIHW tensor (16-byte loads, each element to its swizzled slot,
//    TF32-rounded for f32) before the warp roles split: a call is one
//    launch, with no pack_weight_kernel and no copy of the weight.  At
//    these sizes (~0.05 GFLOP a call) the time is the launch and the first
//    tile's latency, not the products.  Where the weight outgrows shared
//    memory (48 -> 128 f32, past 256 outputs) it is packed and streamed as
//    in 2, on 32-byte chunks.  One template: CB = 128 compiles to the code
//    it had before the narrow form was added.
#include "common.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace rvsr {
namespace wg {

constexpr int kTH = 8, kTW = 16;                    // output tile
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;   // its input window
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kEpiRows = 16, kEpiPad = 8;  // per warp: 16 pixels x 128 B

// The halo of one input chunk of CB bytes (128, or 32 for narrow inputs):
// (8+2) x (16+2) pixel rows of CB bytes, a stage rounded up to 1024 bytes.
template <int CB>
struct Halo {
  static constexpr int kPlane = kHaloH * kHaloW * CB;       // 23040 / 5760
  static constexpr int kStage = (kPlane + 1023) / 1024 * 1024;
};

struct Params {
  const unsigned char* weight;  // packed, see the note above
  const void* oihw;  // narrow inputs, resident: the weight as given (6)
  const void* bias;
  const void* residual;
  void* out;
  int B, H, W, cout, act;
  int nchunk, n1;  // CB-byte chunks in all, of which x1's
  int resident, sh, sw;
  int tiles_x, tiles_y, ntiles;
  int ncb, nitems;  // (cout > 256) column blocks, (tile, block) items
  int halo_off, epi_off, bar_off;  // shared-memory offsets (bytes)
};

// A fragments of one tap for this warp's 16 pixels: CB / 32 k-steps of 32
// bytes (16 bf16 / 8 TF32 channels) of a CB-byte chunk.  Lane i addresses
// pixel (i & 7) + 8 * ((i >> 3) & 1) of the warp's row at 16-byte column
// 2 * ks + (i >> 4), through the TMA's swizzle (column ^ swizzle_of(row)).
template <typename T, int CB>
__device__ __forceinline__ void load_a(uint32_t (&a)[CB / 32][4],
                                       uint32_t plane, int hp_base, int tap,
                                       int lane) {
  const int dy = tap / 3, dx = tap % 3;
  const int hp = hp_base + dy * kHaloW + dx;
  const uint32_t row = plane + hp * CB;
#pragma unroll
  for (int ks = 0; ks < CB / 32; ++ks) {
    const int col = 2 * ks + (lane >> 4);
    ldmatrix_x4(a[ks], row + ((col ^ swizzle_of<CB>(hp)) << 4));
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        asm("cvt.rna.tf32.f32 %0, %1;"
            : "=r"(a[ks][j])
            : "f"(__uint_as_float(a[ks][j])));
    }
  }
}

// Narrow inputs, resident weight (6): every thread of the block lays the
// OIHW weight (cout, cin, 3, 3) out as pack_weight_kernel<T, 32> would,
// [chunk][tap][n][32 bytes] swizzled, zero rows from cout to n, each value
// rounded as the tensor cores take it; then fences it for wgmma's reads.
template <typename T>
__device__ __forceinline__ void lay_out_weight(unsigned char* sw,
                                               const T* __restrict__ w,
                                               int cout, int cin, int n) {
  constexpr int ch = 32 / sizeof(T), u = 16 / sizeof(T);
  const int slices = cin / ch * 9;
  for (int i = threadIdx.x; i < slices * (n - cout) * 2; i += kThreads) {
    const int sl = i / ((n - cout) * 2), r = i % ((n - cout) * 2);
    *reinterpret_cast<uint4*>(sw + (sl * n + cout + r / 2) * 32 +
                              (r & 1) * 16) = make_uint4(0, 0, 0, 0);
  }
  const int vecs = cout * cin * 9 / u;  // cin * 9 is a multiple of 16
  for (int v = threadIdx.x; v < vecs; v += kThreads) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(w) + v);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < u; ++j) {
      const int el = v * u + j, tap = el % 9, oi = el / 9;
      const int i = oi % cin, o = oi / cin, k = i % ch;
      T* dst = reinterpret_cast<T*>(
          sw + ((i / ch * 9 + tap) * n + o) * 32 +
          (((k / u) ^ swizzle_of<32>(o)) << 4));
      dst[k % u] = Traits<T>::to_mma(Traits<T>::to_f(e[j]));
    }
  }
  fence_proxy_async();
}

// The epilogue of one warp: its 16 pixels (row gy, columns gx0 ... gx0+15)
// by the first `width` of the N accumulator columns, which are output
// columns c0 ... (of rows cout apart), in 128-byte column chunks through
// the warp's staging tile.
template <typename T, int N>
__device__ __forceinline__ void epilogue(const float* acc, const Params& p,
                                         T* stage, long long pix0, int gy,
                                         int gx0, int lane, int c0,
                                         int width) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;            // elements in 16 bytes
  constexpr int kCols = kLine / sizeof(T);  // columns per chunk
  constexpr int ld = kCols + kEpiPad;
  const int g = lane >> 2, t = lane & 3;
  const T* bias = p.bias ? static_cast<const T*>(p.bias) + c0 : nullptr;
  const T* res = p.residual ? static_cast<const T*>(p.residual) + c0 : nullptr;
  T* out = static_cast<T*>(p.out) + c0;
  const int cout = p.cout;    // the row pitch
  const int lim = cout - c0;  // this block's columns that exist
  const bool vec = cout % V == 0;
  constexpr int kPer = kEpiRows * (kLine / 16) / 32;  // vectors a lane
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += kCols) {
    if (n0 >= width) break;
    const int nw = width - n0 < kCols ? width - n0 : kCols;
    const int nv = nw / V;  // vectors a row
    // the residual's loads first, in flight while the tile is staged
    uint4 rr[kPer];
    if (vec && res != nullptr) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int it = lane + 32 * k, r = it / nv, c = n0 + (it % nv) * V;
        if (it < kEpiRows * nv && gy < p.H && gx0 + r < p.W && c < lim)
          rr[k] = __ldg(
              reinterpret_cast<const uint4*>(res + (pix0 + r) * cout + c));
      }
    }
#pragma unroll
    for (int i = n0 / 8; i < (N - n0 < kCols ? N : n0 + kCols) / 8; ++i) {
      if (8 * i >= n0 + nw) break;  // past a narrower last block
      const int col = 8 * i + 2 * t;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        if (col < lim) b0 = Tr::to_f(bias[col]);
        if (col + 1 < lim) b1 = Tr::to_f(bias[col + 1]);
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
        if (it >= kEpiRows * nv || gy >= p.H || gx0 + r >= p.W || c >= lim)
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
        if (gy >= p.H || gx0 + r >= p.W || c >= lim) continue;
        const long long o = (pix0 + r) * cout + c;
        T v = stage[r * ld + c - n0];
        if (res != nullptr) v = Tr::from_f(Tr::to_f(v) + Tr::to_f(res[o]));
        out[o] = v;
      }
    }
    __syncwarp();
  }
}

// N: the wgmma width.  NL = 0: one column block of N (cout <= 256).  NL >
// 0: cout > 256 in p.ncb column blocks of N = 256, the last of NL; a work
// item is (tile, column block), item = tile * ncb + block.  CB: the bytes
// of an input chunk, 128, or 32 for narrow inputs (6).
template <typename T, int N, int NL, int CB>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_wgmma(const __grid_constant__ CUtensorMap map1,
                  const __grid_constant__ CUtensorMap map2, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr bool kWide = NL > 0;
  constexpr int kNL = kWide ? NL : N;
  constexpr uint32_t kSlice = N * CB;  // one tap of one chunk
  constexpr int kStage = Halo<CB>::kStage;
  // narrow inputs with the weight resident lay it out here, not by copy
  constexpr bool kNarrow = CB != kLine;
  const bool copy_w = p.resident && !kNarrow;
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
  if constexpr (kNarrow) {
    if (p.resident)
      lay_out_weight<T>(smem, static_cast<const T*>(p.oihw), p.cout,
                        p.nchunk * (CB / (int)sizeof(T)), N);
  }
  __syncthreads();

  const int nchunk = p.nchunk;
  const int nitems = kWide ? p.nitems : p.ntiles;
  const int my_items =
      nitems > (int)blockIdx.x
          ? (nitems - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;
  const int units = my_items * nchunk;  // (item, chunk) pairs, chunk fastest

  if (threadIdx.x >= kConsumers) {  // ---------------- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != kConsumers) return;
    if (copy_w) {
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
        const int item = blockIdx.x + (hu / nchunk) * gridDim.x;
        const int tile = kWide ? item / p.ncb : item;
        const int ci = hu % nchunk;
        const int tx = tile % p.tiles_x;
        const int ty = (tile / p.tiles_x) % p.tiles_y;
        const int b = tile / (p.tiles_x * p.tiles_y);
        const int s = hu % sh;
        mbar_expect_tx(full_h(s), Halo<CB>::kPlane);
        const bool first = ci < p.n1;
        tma_load_4d(sHalo + s * kStage, first ? &map1 : &map2,
                    (first ? ci : ci - p.n1) * (CB / (int)sizeof(T)),
                    tx * kTW - 1, ty * kTH - 1, b, full_h(s));
        ++hu;
        t0 = clock64();
      }
      if (wq < wtotal && mbar_ready(empty_w(wq % sw), ((wq / sw) & 1) ^ 1)) {
        const int s = wq % sw;
        int slice = ((wq / 9) % nchunk) * 9 + wq % 9;  // chunk, tap
        uint32_t bytes = kSlice;
        if constexpr (kWide) {  // of the item's column block
          const int cb =
              (blockIdx.x + (wq / 9 / nchunk) * gridDim.x) % p.ncb;
          slice += cb * nchunk * 9;
          if (cb == p.ncb - 1) bytes = kNL * CB;
        }
        mbar_expect_tx(full_w(s), bytes);
        bulk_load(sW + s * kSlice, p.weight + (size_t)slice * kSlice, bytes,
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
  if (copy_w) mbar_wait(wres, 0);
  int wq = 0;
  for (int u = 0; u < units; ++u) {
    const int ci = u % nchunk, s = u % sh;
    const int item = blockIdx.x + (u / nchunk) * gridDim.x;
    // the last column block runs the narrower wgmma (on acc's first kNL / 2)
    const bool last = kWide && item % p.ncb == p.ncb - 1;
    mbar_wait(full_h(s), (u / sh) & 1);
    const uint32_t plane = sHalo + s * kStage;
    // A register sets: two (tap t + 1 loads while tap t runs), or for
    // N <= 16, whose taps are too short to hide a wait, one per tap (no
    // wait inside a resident unit)
    constexpr int KA = N <= 16 ? 9 : 2;
    constexpr int KS = CB / 32;  // k-steps of a chunk
    uint32_t a[KA][KS][4];
    load_a<T, CB>(a[0], plane, hp_base, 0, lane);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t slice;
      if (p.resident) {
        slice = sW + (ci * 9 + tap) * kSlice;
      } else {
        mbar_wait(full_w(wq % sw), (wq / sw) & 1);
        slice = sW + (wq % sw) * kSlice;
      }
      const uint64_t desc = kNarrow ? desc_sw32(slice) : desc_sw128(slice);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int scale = (ci > 0 || tap > 0 || ks > 0) ? 1 : 0;
        if (last)
          Wgmma<T, kNL>::run(acc, a[tap % KA][ks], desc + 2 * ks, scale);
        else
          Wgmma<T, N>::run(acc, a[tap % KA][ks], desc + 2 * ks, scale);
      }
      wgmma_commit();
      if (tap < 8) {
        if (KA == 2 || !p.resident) {
          wgmma_wait<1>();  // tap - 1 done: its weights and A set are free
          if (!p.resident && tap > 0) mbar_arrive(empty_w((wq - 1) % sw));
        }
        load_a<T, CB>(a[(tap + 1) % KA], plane, hp_base, tap + 1, lane);
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
      const int tile = kWide ? item / p.ncb : item;
      const int tx = tile % p.tiles_x;
      const int ty = (tile / p.tiles_x) % p.tiles_y;
      const int b = tile / (p.tiles_x * p.tiles_y);
      const int gy = ty * kTH + trow, gx0 = tx * kTW;
      const long long pix0 = ((long long)b * p.H + gy) * p.W + gx0;
      epilogue<T, N>(acc, p, stage, pix0, gy, gx0, lane,
                     kWide ? item % p.ncb * N : 0, last ? kNL : N);
    }
  }
}

// ------------------------------------------------------------------- host

// Error codes of the host side, beside cudaGetLastError()'s and
// encode_nhwc's (9001, 9002).
constexpr int kErrSmem = 9003, kErrWidth = 9004, kErrScratch = 9005;

// Shared memory of a launch (bytes), and where the weight lives: resident
// (the whole image, 9 taps of every chunk) or streamed (a ring of 3 taps).
// ops/kernels/conv3x3.py::weight_resident mirrors the choice.
template <typename T, int N, int NL, int CB>
int plan(Params& p) {
  constexpr int kSmemMax = 232448;
  constexpr int kStage = Halo<CB>::kStage;
  const int slice = N * CB;
  const int epi = 8 * kEpiRows * (kLine / (int)sizeof(T) + kEpiPad) *
                  (int)sizeof(T);
  const int bar_bytes = 8 * (2 * 4 + 2 * 3 + 1);
  const int all_w = p.nchunk * 9 * slice;
  p.resident = NL == 0 && all_w + 2 * kStage + epi + bar_bytes <= kSmemMax;
  p.sw = p.resident ? 0 : 3;
  const int w_bytes = p.resident ? all_w : p.sw * slice;
  p.halo_off = (w_bytes + 1023) / 1024 * 1024;  // the swizzle's alignment
  p.sh = (kSmemMax - p.halo_off - epi - bar_bytes) / kStage;
  if (p.sh > 4) p.sh = 4;
  if (p.sh < 2) return -1;
  p.epi_off = p.halo_off + p.sh * kStage;
  p.bar_off = p.epi_off + epi;
  return p.bar_off + bar_bytes;
}

// weight: OIHW; packed: scratch for its image (unused by narrow inputs
// whose weight is resident, 6).
template <typename T, int N, int NL, int CB>
int launch_n(const void* x1, int c1, const void* x2, int c2,
             const void* weight, void* packed, const void* bias,
             const void* residual, void* out, int B, int H, int W, int cout,
             int act, void* stream) {
  constexpr int kCh = CB / sizeof(T);
  constexpr int kSmemMax = 232448;
  Params p;
  p.weight = static_cast<const unsigned char*>(packed);
  p.oihw = weight;
  p.bias = bias;
  p.residual = residual;
  p.out = out;
  p.B = B, p.H = H, p.W = W, p.cout = cout, p.act = act;
  p.n1 = c1 / kCh;
  p.nchunk = (c1 + c2) / kCh;
  p.tiles_x = (W + kTW - 1) / kTW;
  p.tiles_y = (H + kTH - 1) / kTH;
  p.ntiles = B * p.tiles_x * p.tiles_y;
  p.ncb = NL > 0 ? (cout + N - 1) / N : 1;
  p.nitems = p.ntiles * p.ncb;
  const int smem = plan<T, N, NL, CB>(p);
  if (smem < 0) return kErrSmem;
  if (CB == kLine || !p.resident) {
    if (packed == nullptr) return kErrScratch;
    const int err = pack_weight<T, CB>(weight, packed, cout, c1 + c2, N,
                                       stream);
    if (err != 0) return err;
  }

  CUtensorMap m1, m2;
  int err = encode_nhwc<T, CB>(&m1, x1, B, H, W, c1, kHaloW, kHaloH);
  if (err == 0)
    err = x2 != nullptr ? encode_nhwc<T, CB>(&m2, x2, B, H, W, c2, kHaloW,
                                             kHaloH)
                        : encode_nhwc<T, CB>(&m2, x1, B, H, W, c1, kHaloW,
                                             kHaloH);
  if (err != 0) return err;
  static bool attribute_set = false;  // once: launches ask for less or equal
  if (!attribute_set) {
    cudaFuncSetAttribute(conv3x3_wgmma<T, N, NL, CB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemMax);
    attribute_set = true;
  }
  const int grid = p.nitems < sm_count() ? p.nitems : sm_count();
  if (grid > 0)
    conv3x3_wgmma<T, N, NL, CB>
        <<<grid, kThreads, smem, (cudaStream_t)stream>>>(m1, m2, p);
  return (int)cudaGetLastError();
}

// n: the wgmma width of the last (at cout <= 256 the only) column block.
template <typename T, int CB>
int launch(const void* x1, int c1, const void* x2, int c2, const void* weight,
           void* packed, const void* bias, const void* residual, void* out,
           int B, int H, int W, int cout, int n, int act, void* stream) {
  constexpr int kN = 256;  // a column block past 256 outputs
#define RVSR_N(NN)                                                            \
  case NN:                                                                    \
    return cout > kN                                                          \
               ? launch_n<T, kN, NN, CB>(x1, c1, x2, c2, weight, packed,      \
                                         bias, residual, out, B, H, W, cout,  \
                                         act, stream)                         \
               : launch_n<T, NN, 0, CB>(x1, c1, x2, c2, weight, packed,       \
                                        bias, residual, out, B, H, W, cout,   \
                                        act, stream);
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

// Inputs of whole 128-byte chunks take CB = 128, every other multiple of
// 16 channels CB = 32 (6).
template <typename T>
int entry(const void* x1, int c1, const void* x2, int c2, const void* weight,
          void* packed, const void* bias, const void* residual, void* out,
          int B, int H, int W, int cout, int n, int act, void* stream) {
  constexpr int kCh = kLine / sizeof(T);
  if (c1 % kCh == 0 && c2 % kCh == 0)
    return launch<T, kLine>(x1, c1, x2, c2, weight, packed, bias, residual,
                            out, B, H, W, cout, n, act, stream);
  return launch<T, 32>(x1, c1, x2, c2, weight, packed, bias, residual, out, B,
                       H, W, cout, n, act, stream);
}

}  // namespace wg
}  // namespace rvsr

// weight (cout, cin, 3, 3) OIHW -> packed (ceil(cout / n) * cin * 9 * n
// elements: column blocks of n outputs) in 128-byte chunks (chunk_bytes
// 128) or 32-byte ones (32), the image the conv's streamed weights take.
// Returns cudaGetLastError().
extern "C" int conv3x3_pack_bf16(const void* weight, void* packed, int cout,
                                 int cin, int n, int chunk_bytes,
                                 void* stream) {
  return chunk_bytes == 32
             ? rvsr::pack_weight<__nv_bfloat16, 32>(weight, packed, cout,
                                                    cin, n, stream)
             : rvsr::pack_weight<__nv_bfloat16>(weight, packed, cout, cin, n,
                                                stream);
}

extern "C" int conv3x3_pack_f32(const void* weight, void* packed, int cout,
                                int cin, int n, int chunk_bytes,
                                void* stream) {
  return chunk_bytes == 32
             ? rvsr::pack_weight<float, 32>(weight, packed, cout, cin, n,
                                            stream)
             : rvsr::pack_weight<float>(weight, packed, cout, cin, n, stream);
}

// x1 (B,H,W,c1) and optional x2 (B,H,W,c2): the input is their channel
// concat, c1 and c2 multiples of 16 (whole 128-byte chunks, or 32-byte ones
// for narrow inputs); weight (cout, c1 + c2, 3, 3) OIHW, laid out by
// pack_weight_kernel into packed first (narrow inputs whose weight fits
// shared memory: laid out by the conv's own blocks, packed unused): for
// cout <= 256 one block of n output columns (n one of gen_wgmma.py's
// WIDTHS, >= cout; scratch of (c1 + c2) * 9 * n elements); past 256,
// ceil(cout / 256) column blocks of 256 (scratch of that many times (c1 +
// c2) * 9 * 256), of which the last runs n (one of WIDTHS, >= its
// columns); bias (cout) or null; residual (B,H,W,cout) or null; out
// (B,H,W,cout).  act: 0 none, 1 relu, 2 lrelu(0.1).  Returns
// cudaGetLastError(), or 9001 (no cuTensorMapEncodeTiled in the driver),
// 9002 (a tensor map refused), 9003 (shared memory), 9004 (n not
// instantiated), 9005 (no scratch where the weight must be packed).
extern "C" int conv3x3_bf16(const void* x1, int c1, const void* x2, int c2,
                            const void* weight, void* packed,
                            const void* bias, const void* residual, void* out,
                            int B, int H, int W, int cout, int n, int act,
                            void* stream) {
  return rvsr::wg::entry<__nv_bfloat16>(x1, c1, x2, c2, weight, packed, bias,
                                        residual, out, B, H, W, cout, n, act,
                                        stream);
}

extern "C" int conv3x3_f32(const void* x1, int c1, const void* x2, int c2,
                           const void* weight, void* packed, const void* bias,
                           const void* residual, void* out, int B, int H,
                           int W, int cout, int n, int act, void* stream) {
  return rvsr::wg::entry<float>(x1, c1, x2, c2, weight, packed, bias,
                                residual, out, B, H, W, cout, n, act, stream);
}
