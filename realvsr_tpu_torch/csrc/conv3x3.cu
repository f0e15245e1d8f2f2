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
// Design, one persistent block per SM (grid = min(tiles, SMs); clusters of
// two for streamed weights up to 128 outputs, 7), each walking the output
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... of 8 x 16 pixels (tile
// index = (b * tiles_y + ty) * tiles_x + tx; past 256 outputs, see 5).
// One thread of warpgroup
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
//    and kept when they fit with two halo stages (64->64, 128->64 and
//    64->128 bf16, 64->64 f32); else streamed tap by tap from L2 a tile:
//    at cout <= 256 on 128-byte chunks as 7 says, past 256 outputs and on
//    32-byte chunks through a ring of 3 mbarrier stages.
//    pack_weight_kernel, launched before each
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
// 7. Streamed weights at cout <= 256 on 128-byte chunks (128 -> 128 and
//    256 -> 128 in either type, 64 / 128 -> 216 / 256, every f32 conv of
//    128 inputs or more).  A slice (one tap of one chunk, N x 128 bytes)
//    feeds the tensor cores for 0.14-0.47 us on an SM; read from L2 once a
//    tile through 3 slots, released one tap late, it took 0.65-1.4 us.  (a)
//    The ring takes the shared memory left beside kPairHalo halo stages and
//    the epilogue (plan_stream): up to kRingMax slots, so the producer keeps
//    about sw - 2 slices in flight.  (b) Up to kPairWidth outputs the blocks
//    run in clusters of kPair on neighbouring SMs, walking neighbouring
//    tiles side by side (item k: the tiles k * kPair + rank), and each slice
//    is read from L2 once a pair: each block's producer bulk-copies its half
//    with .multicast::cluster into the same slot of both blocks, whose
//    "full" barriers expect the whole slice; a slot's "empty" barrier counts
//    one arrive from each consumer warp of both blocks (lanes 0 and 1 arrive
//    on blocks 0 and 1: mapa and a remote arrive, released at CTA scope; at
//    cluster scope the release waits for the warp's global stores).  (c)
//    There the ring is kRingSplit slots and the rest of its shared memory
//    keeps a tile's first nres slices resident, loaded once a launch, so
//    fewer slices are streamed a tile (128 -> 128: 15 of 18; f32 (64+64) ->
//    64: 24 of 36).  (d) The consumers wait in try_wait, which leaves the
//    warp schedulers to the working warps.  Where the tiles are odd in
//    number, the second block of the last cluster takes the last tile
//    again, with every copy and arrive, and stores nothing.  The grid is
//    whole clusters, as many as the occupancy API says fit at once; the
//    launch (cudaLaunchKernelEx with a cluster
//    dimension) returns its error if refused, with no fallback.  The blocks
//    meet on a cluster barrier after the barriers' init and before they
//    exit, so no arrive lands in a block that has left.  A cluster block is
//    the two consumer warpgroups and one producer warp (kPairThreads, no
//    setmaxnreg).  The consumers keep 4's chunk loop (a drain a chunk): one
//    stream of slices across chunks, with three A sets, made ptxas
//    serialize every wgmma.  At 216 and 256 outputs the 108 / 128
//    accumulators and two A sets fill the 168 registers a consumer thread
//    may hold (a block of 9 or 12 warps puts 3 on one SM quarter), and the
//    cluster's bookkeeping spills: these run (a) alone.
// 8. The streamed regime's epilogue (the cluster kernel, and N 216 / 256 on
//    128-byte chunks, always streamed): both consumer warpgroups finish a
//    tile together, so while the epilogue of 4 ran the tensor cores idled
//    (a clock64 profile of the warps: 24% of a 128 -> 128 bf16 conv's
//    time, 57% of 64 -> 216's).  Here each warp stages each 128-byte chunk
//    of its 16 pixels' outputs (bias, act, cast, + residual) in one of two
//    buffers of its own, swizzled as the output's tensor map reads them,
//    and one TMA store writes it (clipped at the ragged edges) while the
//    warp returns to the products; before a buffer is written again its
//    store must have read it (cp.async.bulk.wait_group.read).  Rows of
//    cout elements that are not whole 16-byte vectors take 4's epilogue.
//    Past kPairWidth outputs the 108 / 128 accumulators leave no room for
//    two epilogues or a residual in one kernel (ptxas spills): at 216 in
//    bf16 (the offset / mask convs of inference) an instantiation with this
//    alone (kTmaOut) runs the convs without a residual whose rows are whole
//    16-byte vectors; in f32 and at 256 this one spills too, and 4's runs
//    every conv.  (Stores to its staging through inline-asm st.shared, to
//    spare the 64-bit addresses, made ptxas serialize the loop's wgmmas:
//    the convs ran 4x slower.)
#include "common.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace rvsr {
namespace wg {

constexpr int kTH = 8, kTW = 16;                    // output tile
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;   // its input window
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kEpiRows = 16, kEpiPad = 8;  // per warp: 16 pixels x 128 B
// the streamed regime (7): blocks a cluster, halo stages, most weight
// slots; its block: the consumers and one producer warp (no setmaxnreg:
// every thread may hold 224 registers)
constexpr int kPair = 2, kPairHalo = 2, kRingMax = 16, kRingSplit = 6;
constexpr int kPairThreads = kConsumers + 32;
constexpr int kPairWidth = 128;  // the widest N in clusters
// its epilogue's staging: buffers of 16 pixels x 128 bytes a warp (8), and
// the one width past kPairWidth with that epilogue
constexpr int kEpiBufs = 2, kEpiBuf = kEpiRows * kLine, kTmaOutWidth = 216;

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
  int nres;  // (7) the cluster kernel's resident slices, the first of a tile
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

// The streamed regime's epilogue of one warp (8): its 16 pixels by the N
// accumulator columns, in chunks of 128 bytes of outputs (64 bf16 / 32 f32
// columns), each staged in one of the warp's kEpiBufs buffers (128-byte
// rows, swizzled as the TMA map reads them: unit j of row r at j ^ r & 7)
// and written by one TMA store that runs on while the warp goes back to
// the products; the residual is added in the buffer (up to kPairWidth
// outputs).  ec counts the warp's chunks (its buffer: ec % kEpiBufs).
// Needs rows of whole 16-byte vectors.
template <typename T, int N>
__device__ __forceinline__ void epilogue_tma(const float* acc,
                                             const Params& p,
                                             const CUtensorMap* map_out,
                                             unsigned char* bufs, int b,
                                             long long pix0, int gy, int gx0,
                                             int lane, int& ec) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  constexpr int kCols = kLine / sizeof(T);
  constexpr int kPer = kEpiRows * (kLine / 16) / 32;  // vectors a lane
  const int g = lane >> 2, t = lane & 3;
  const T* bias = static_cast<const T*>(p.bias);
  const T* res = static_cast<const T*>(p.residual);
  const int cout = p.cout;
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += kCols) {
    if (n0 >= cout) break;  // columns past cout: none to store
    unsigned char* buf = bufs + (ec % kEpiBufs) * kEpiBuf;
    // the residual's loads first, in flight while the chunk is staged (past
    // kPairWidth a residual takes epilogue(): its registers would spill)
    constexpr bool kRes = N <= kPairWidth;
    uint4 rr[kPer];
    if (kRes && res != nullptr) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int it = lane + 32 * k, r = it >> 3, c = n0 + (it & 7) * V;
        if (gy < p.H && gx0 + r < p.W && c < cout)
          rr[k] = __ldg(
              reinterpret_cast<const uint4*>(res + (pix0 + r) * cout + c));
      }
    }
    // the store kEpiBufs chunks back has read this buffer
    if (lane == 0) bulk_wait_read<kEpiBufs - 1>();
    __syncwarp();
#pragma unroll
    for (int i = n0 / 8; i < (N - n0 < kCols ? N : n0 + kCols) / 8; ++i) {
      const int col = 8 * i + 2 * t;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        if (col < cout) b0 = Tr::to_f(bias[col]);
        if (col + 1 < cout) b1 = Tr::to_f(bias[col + 1]);
      }
      const int byte = (col - n0) * (int)sizeof(T);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = g + 8 * half;
        T* s = reinterpret_cast<T*>(buf + r * kLine +
                                    ((((byte >> 4) ^ r) & 7) << 4) +
                                    (byte & 15));
        s[0] = Tr::from_f(apply_act(acc[4 * i + 2 * half] + b0, p.act));
        s[1] = Tr::from_f(apply_act(acc[4 * i + 2 * half + 1] + b1, p.act));
      }
    }
    __syncwarp();
    if (kRes && res != nullptr) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int it = lane + 32 * k, r = it >> 3, u = it & 7;
        if (gy >= p.H || gx0 + r >= p.W || n0 + u * V >= cout) continue;
        uint4* sv = reinterpret_cast<uint4*>(buf + r * kLine +
                                             (((u ^ r) & 7) << 4));
        uint4 raw = *sv;
        T* e = reinterpret_cast<T*>(&raw);
        const T* re = reinterpret_cast<const T*>(&rr[k]);
#pragma unroll
        for (int j = 0; j < V; ++j)
          e[j] = Tr::from_f(Tr::to_f(e[j]) + Tr::to_f(re[j]));
        *sv = raw;
      }
    }
    fence_proxy_async();  // the buffer's writes, to the TMA store's reads
    __syncwarp();
    if (lane == 0) {
      tma_store_4d(map_out, smem_u32(buf), n0, gx0, gy, b);
      bulk_commit();
    }
    ++ec;
  }
}

// N: the wgmma width.  NL = 0: one column block of N (cout <= 256).  NL >
// 0: cout > 256 in p.ncb column blocks of N = 256, the last of NL; a work
// item is (tile, column block), item = tile * ncb + block.  CB: the bytes
// of an input chunk, 128, or 32 for narrow inputs (6).  kCluster: the
// streamed regime (7), launched in clusters of kPair blocks (NL = 0, CB =
// 128, the weight not resident).  kTmaOut: the streamed regime at
// kTmaOutWidth in bf16 with 8's epilogue (no residual; rows of whole
// 16-byte vectors).
template <typename T, int N, int NL, int CB, bool kCluster = false,
          bool kTmaOut = false>
__global__ void __launch_bounds__(kCluster ? kPairThreads : kThreads, 1)
    conv3x3_wgmma(const __grid_constant__ CUtensorMap map1,
                  const __grid_constant__ CUtensorMap map2,
                  const __grid_constant__ CUtensorMap map_out,
                  const Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  static_assert(!kCluster || (NL == 0 && CB == kLine), "the streamed regime");
  static_assert(!kTmaOut || (NL == 0 && CB == kLine && N == kTmaOutWidth &&
                             sizeof(T) == 2),
                "the streamed regime at 216 outputs in bf16");
  constexpr bool kWide = NL > 0;
  constexpr int kNL = kWide ? NL : N;
  constexpr uint32_t kSlice = N * CB;  // one tap of one chunk
  constexpr int kStage = Halo<CB>::kStage;
  // narrow inputs with the weight resident lay it out here, not by copy
  constexpr bool kNarrow = CB != kLine;
  const bool resident = !kCluster && p.resident;
  const bool copy_w = resident && !kNarrow;
  // (7) the cluster kernel keeps a tile's first nres slices resident after
  // its ring, and streams the rest
  const int nres = kCluster ? p.nres : 0;
  // (8) the streamed regime's epilogue by TMA stores, where rows are whole
  // 16-byte vectors (kTmaOut: always)
  constexpr bool kTmaEpi = kCluster || kTmaOut;
  const bool tma_epi =
      kTmaOut || (kCluster && p.cout % Traits<T>::kVec == 0);
  const uint32_t base = smem_u32(smem);
  if (base & 1023) __trap();  // the swizzle needs 1024-byte alignment
  const uint32_t sW = base, sHalo = base + p.halo_off;
  const uint32_t bars = base + p.bar_off;
  const int sh = p.sh, sw = p.sw;
  const uint32_t sRes = sW + sw * kSlice;  // (7) after the ring
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
      // streamed regime: one arrive a consumer warp of each block
      mbar_init(empty_w(s), kCluster ? kPair * kConsumers / 32 : kConsumers);
    }
    mbar_init(wres, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (kNarrow) {
    if (p.resident)
      lay_out_weight<T>(smem, static_cast<const T*>(p.oihw), p.cout,
                        p.nchunk * (CB / (int)sizeof(T)), N);
  }
  if constexpr (kCluster)
    cluster_sync();  // the partner's barriers exist before either uses them
  else
    __syncthreads();

  const int nchunk = p.nchunk;
  const int nitems = kWide || kCluster ? p.nitems : p.ntiles;
  // the walkers: blocks, or (7) clusters, whose blocks walk the same items
  const int walker = kCluster ? (int)blockIdx.x / kPair : (int)blockIdx.x;
  const int walkers = kCluster ? (int)gridDim.x / kPair : (int)gridDim.x;
  const int my_items =
      nitems > walker ? (nitems - 1 - walker) / walkers + 1 : 0;
  const int units = my_items * nchunk;  // (item, chunk) pairs, chunk fastest
  // (7) item k of a cluster: the kPair tiles k * kPair ..., one a block
  // (the partner of an odd last tile takes that tile again, unstored)
  const int rank = kCluster ? (int)cluster_rank() : 0;
  auto tile_of = [&](int item) {
    if constexpr (kCluster) return item * kPair + rank;
    return kWide ? item / p.ncb : item;
  };

  if (threadIdx.x >= kConsumers) {  // ---------------- producer warpgroup
    if constexpr (!kCluster)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != kConsumers) return;
    if (copy_w) {
      mbar_expect_tx(wres, nchunk * 9 * kSlice);
      for (int i = 0; i < nchunk * 9; ++i)
        bulk_load(sW + i * kSlice, p.weight + (size_t)i * kSlice, kSlice,
                  wres);
    }
    if constexpr (kCluster) {  // (7) the resident slices, each block's half
      if (nres > 0) {
        constexpr uint32_t kPart = kSlice / kPair;
        const uint32_t off = rank * kPart;
        mbar_expect_tx(wres, nres * kSlice);
        for (int i = 0; i < nres; ++i)
          bulk_load_multicast(sRes + i * kSlice + off,
                              p.weight + (size_t)i * kSlice + off, kPart,
                              wres, (1 << kPair) - 1);
      }
    }
    const int per = 9 * nchunk - nres;  // streamed slices a tile
    const int wtotal = resident ? 0 : my_items * per;
    int hu = 0, wq = 0;
    long long t0 = clock64();
    while (hu < units || wq < wtotal) {
      if (clock64() - t0 > kWatchdog) __trap();
      if (hu < units &&
          mbar_ready(empty_h(hu % sh), ((hu / sh) & 1) ^ 1)) {
        const int item = walker + (hu / nchunk) * walkers;
        int tile = tile_of(item);
        if (kCluster && tile >= p.ntiles) tile = p.ntiles - 1;
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
        int slice = nres + wq % per;  // chunk * 9 + tap
        uint32_t bytes = kSlice;
        if constexpr (kWide) {  // of the item's column block
          const int cb = (walker + (wq / 9 / nchunk) * walkers) % p.ncb;
          slice += cb * nchunk * 9;
          if (cb == p.ncb - 1) bytes = kNL * CB;
        }
        mbar_expect_tx(full_w(s), bytes);
        if constexpr (kCluster) {  // this block's part, to every block
          constexpr uint32_t kPart = kSlice / kPair;
          const uint32_t off = rank * kPart;
          bulk_load_multicast(sW + s * kSlice + off,
                              p.weight + (size_t)slice * kSlice + off, kPart,
                              full_w(s), (1 << kPair) - 1);
        } else {
          bulk_load(sW + s * kSlice, p.weight + (size_t)slice * kSlice,
                    bytes, full_w(s));
        }
        ++wq;
        t0 = clock64();
      }
    }
    // the partner's consumers arrive on this block's barriers to the end
    if constexpr (kCluster) cluster_sync();
    return;
  }

  // --------------------------------------------------------------- consumers
  if constexpr (!kCluster)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  // this warp's tile row (warpgroup g, warps 4g ... 4g + 3, takes rows
  // 4g ... 4g + 3: its 64 pixels, 16 a warp)
  const int trow = warp;
  const int hp_base = trow * kHaloW + (lane & 7) + ((lane >> 3) & 1) * 8;
  T* stage = reinterpret_cast<T*>(smem + p.epi_off) +
             warp * kEpiRows * (kLine / sizeof(T) + kEpiPad);
  unsigned char* bufs = smem + p.epi_off + warp * kEpiBufs * kEpiBuf;
  int ec = 0;  // the warp's chunks stored by TMA (8)
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  constexpr int KS = CB / 32;  // k-steps of a chunk
  // a weight slot read: the streamed regime's one arrive a warp on each
  // block of the cluster (lane r on block r), else one a thread
  auto free_w = [&](int slot) {
    if constexpr (kCluster) {
      if (lane < kPair) mbar_arrive_cluster(empty_w(slot), lane);
    } else {
      mbar_arrive(empty_w(slot));
    }
  };
  if (copy_w || nres > 0) mbar_wait(wres, 0);
  int wq = 0;
  for (int u = 0; u < units; ++u) {
    const int ci = u % nchunk, s = u % sh;
    const int item = walker + (u / nchunk) * walkers;
    // the last column block runs the narrower wgmma (on acc's first kNL / 2)
    const bool last = kWide && item % p.ncb == p.ncb - 1;
    // (7) the cluster's consumers wait in try_wait, which frees the warp
    // schedulers and the shared memory the copies fill
    if constexpr (kCluster)
      mbar_sleep_wait(full_h(s), (u / sh) & 1);
    else
      mbar_wait(full_h(s), (u / sh) & 1);
    const uint32_t plane = sHalo + s * kStage;
    // A register sets: two (tap t + 1 loads while tap t runs), or for
    // N <= 16, whose taps are too short to hide a wait, one per tap (no
    // wait inside a resident unit)
    constexpr int KA = N <= 16 ? 9 : 2;
    uint32_t a[KA][KS][4];
    load_a<T, CB>(a[0], plane, hp_base, 0, lane);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t slice;
      // (7) a slice of the ring, or resident (all, or a tile's first nres)
      const bool ring = !resident && ci * 9 + tap >= nres;
      if (resident) {
        slice = sW + (ci * 9 + tap) * kSlice;
      } else if (!ring) {
        slice = sRes + (ci * 9 + tap) * kSlice;
      } else {
        if constexpr (kCluster)
          mbar_sleep_wait(full_w(wq % sw), (wq / sw) & 1);
        else
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
        if (KA == 2 || !resident) {
          wgmma_wait<1>();  // tap - 1 done: its weights and A set are free
          if (tap > 0 && !resident && ci * 9 + tap - 1 >= nres)
            free_w((wq - 1) % sw);
        }
        load_a<T, CB>(a[(tap + 1) % KA], plane, hp_base, tap + 1, lane);
      }
      if (ring) ++wq;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
    if (!resident) {  // taps 7 and 8, where streamed
      if (ci * 9 + 7 >= nres) free_w((wq - 2) % sw);
      if (ci * 9 + 8 >= nres) free_w((wq - 1) % sw);
    }
    mbar_arrive(empty_h(s));
    // (7) the partner of an odd last tile stores nothing
    if (ci == nchunk - 1 && (!kCluster || tile_of(item) < p.ntiles)) {
      const int tile = tile_of(item);
      const int tx = tile % p.tiles_x;
      const int ty = (tile / p.tiles_x) % p.tiles_y;
      const int b = tile / (p.tiles_x * p.tiles_y);
      const int gy = ty * kTH + trow, gx0 = tx * kTW;
      const long long pix0 = ((long long)b * p.H + gy) * p.W + gx0;
      if constexpr (kTmaEpi) {
        if (tma_epi) {
          epilogue_tma<T, N>(acc, p, &map_out, bufs, b, pix0, gy, gx0, lane,
                             ec);
          continue;
        }
      }
      epilogue<T, N>(acc, p, stage, pix0, gy, gx0, lane,
                     kWide ? item % p.ncb * N : 0, last ? kNL : N);
    }
  }
  if constexpr (kTmaEpi) {
    if (lane == 0) bulk_wait<0>();  // the warp's stores are done
  }
  if constexpr (kCluster) cluster_sync();  // no arrive lands after an exit
}

// ------------------------------------------------------------------- host

// Error codes of the host side, beside cudaGetLastError()'s and
// encode_nhwc's (9001, 9002).
constexpr int kErrSmem = 9003, kErrWidth = 9004, kErrScratch = 9005,
              kErrCluster = 9006;
constexpr int kSmemMax = 232448;

// The streamed regime's shared memory (7): kPairHalo halo stages, the
// epilogue's rows, and a ring of as many N x 128-byte weight slots as fit
// beside them (at most kRingMax).  ops/kernels/conv3x3.py::stream_plan
// mirrors it.
template <typename T, int N>
int plan_stream(Params& p, bool split, bool tma_epi) {
  constexpr int kStage = Halo<kLine>::kStage;
  const int slice = N * kLine;  // N * 128 bytes a slot: 1024-aligned
  // the TMA stores' staging (8), which holds epilogue()'s rows too, or those
  const int epi = tma_epi ? 8 * kEpiBufs * kEpiBuf
                          : 8 * kEpiRows * (kLine / (int)sizeof(T) + kEpiPad) *
                                (int)sizeof(T);
  const int most_bars = 8 * (2 * kPairHalo + 2 * kRingMax + 1);
  p.resident = 0;
  p.sh = kPairHalo;
  p.sw = (kSmemMax - kPairHalo * kStage - epi - most_bars) / slice;
  p.nres = 0;
  if (split && p.sw > kRingSplit) {  // the cluster kernel (7)
    p.nres = p.sw - kRingSplit;
    if (p.nres > 9 * p.nchunk - 1) p.nres = 9 * p.nchunk - 1;
    p.sw = kRingSplit;
  }
  if (p.sw > kRingMax) p.sw = kRingMax;
  p.halo_off = (p.sw + p.nres) * slice;
  p.epi_off = p.halo_off + p.sh * kStage;
  p.bar_off = p.epi_off + epi;
  return p.bar_off + 8 * (2 * p.sh + 2 * p.sw + 1);
}

// Shared memory of a launch (bytes), and where the weight lives: resident
// (the whole image, 9 taps of every chunk) or streamed (at cout <= 256 on
// 128-byte chunks the streamed regime, plan_stream; else a ring of 3
// taps).  ops/kernels/conv3x3.py::weight_resident mirrors the choice.
template <typename T, int N, int NL, int CB>
int plan(Params& p) {
  constexpr int kStage = Halo<CB>::kStage;
  const int slice = N * CB;
  const int epi = 8 * kEpiRows * (kLine / (int)sizeof(T) + kEpiPad) *
                  (int)sizeof(T);
  const int bar_bytes = 8 * (2 * 4 + 2 * 3 + 1);
  const int all_w = p.nchunk * 9 * slice;
  p.resident = NL == 0 && all_w + 2 * kStage + epi + bar_bytes <= kSmemMax;
  if (NL == 0 && CB == kLine && !p.resident)
    return plan_stream<T, N>(p, false, false);
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

// The launch's parameters, but for the plan and the work items.
template <typename T, int CB>
Params params_of(const void* x1, int c1, int c2, const void* weight,
                 void* packed, const void* bias, const void* residual,
                 void* out, int B, int H, int W, int cout, int act) {
  constexpr int kCh = CB / sizeof(T);
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
  p.nres = 0;
  return p;
}

// The halo's tensor maps, x1's and x2's (or x1's again), and with_out the
// output's (8: boxes of 128 bytes by 16 pixels, where cout makes rows of
// whole 16-byte vectors; else x1's again, unread).
template <typename T, int CB>
int encode_maps(CUtensorMap* m1, CUtensorMap* m2, CUtensorMap* mo,
                const void* x1, int c1, const void* x2, int c2,
                const void* out, int B, int H, int W, int cout,
                bool with_out) {
  int err = encode_nhwc<T, CB>(m1, x1, B, H, W, c1, kHaloW, kHaloH);
  if (err != 0) return err;
  err = x2 != nullptr
            ? encode_nhwc<T, CB>(m2, x2, B, H, W, c2, kHaloW, kHaloH)
            : encode_nhwc<T, CB>(m2, x1, B, H, W, c1, kHaloW, kHaloH);
  if (err != 0) return err;
  if (!with_out || CB != kLine || cout % Traits<T>::kVec != 0) {
    *mo = *m1;
    return 0;
  }
  return encode_nhwc<T, kLine>(mo, out, B, H, W, cout, kTW, 1);
}

// The streamed regime's launch in clusters (7), N <= 128: items (kPair
// neighbouring tiles) over clusters of kPair blocks, as many clusters as
// fit the card at once (the occupancy API's count, asked once) or one an
// item.  A cluster launch that is refused returns its error; there is no
// launch without the cluster.
template <typename T, int N>
int launch_pair(const void* x1, int c1, const void* x2, int c2,
                const void* weight, void* packed, const void* bias,
                const void* residual, void* out, int B, int H, int W,
                int cout, int act, void* stream) {
  Params p = params_of<T, kLine>(x1, c1, c2, weight, packed, bias, residual,
                                 out, B, H, W, cout, act);
  p.ncb = 1;
  p.nitems = (p.ntiles + kPair - 1) / kPair;
  const int smem = plan_stream<T, N>(p, true, true);
  if (packed == nullptr) return kErrScratch;
  int err = pack_weight<T, kLine>(weight, packed, cout, c1 + c2, N, stream);
  if (err != 0) return err;
  CUtensorMap m1, m2, mo;
  err = encode_maps<T, kLine>(&m1, &m2, &mo, x1, c1, x2, c2, out, B, H, W,
                              cout, true);
  if (err != 0) return err;
  auto kernel = conv3x3_wgmma<T, N, 0, kLine, true>;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kPair;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kPair);
  cfg.blockDim = dim3(kPairThreads);
  cfg.dynamicSmemBytes = smem;  // the same at every launch of this N
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  static int clusters = 0;
  if (clusters == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return kErrCluster;
  }
  if (p.nitems == 0) return 0;
  cfg.gridDim = dim3(kPair * (p.nitems < clusters ? p.nitems : clusters));
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, m1, m2, mo, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// weight: OIHW; packed: scratch for its image (unused by narrow inputs
// whose weight is resident, 6).
template <typename T, int N, int NL, int CB>
int launch_n(const void* x1, int c1, const void* x2, int c2,
             const void* weight, void* packed, const void* bias,
             const void* residual, void* out, int B, int H, int W, int cout,
             int act, void* stream) {
  Params p = params_of<T, CB>(x1, c1, c2, weight, packed, bias, residual,
                              out, B, H, W, cout, act);
  p.ncb = NL > 0 ? (cout + N - 1) / N : 1;
  p.nitems = p.ntiles * p.ncb;
  const int smem = plan<T, N, NL, CB>(p);
  if (smem < 0) return kErrSmem;
  if constexpr (NL == 0 && CB == kLine && N <= kPairWidth) {
    if (!p.resident)  // the streamed regime in clusters (7)
      return launch_pair<T, N>(x1, c1, x2, c2, weight, packed, bias,
                               residual, out, B, H, W, cout, act, stream);
  }
  if (CB == kLine || !p.resident) {
    if (packed == nullptr) return kErrScratch;
    const int err = pack_weight<T, CB>(weight, packed, cout, c1 + c2, N,
                                       stream);
    if (err != 0) return err;
  }

  CUtensorMap m1, m2, mo;
  // N 216 / 256 on 128-byte chunks (always streamed) without a residual,
  // rows of whole 16-byte vectors: the epilogue by TMA stores (8)
  const bool tma_out = NL == 0 && CB == kLine && N == kTmaOutWidth &&
                       sizeof(T) == 2 && residual == nullptr &&
                       cout % Traits<T>::kVec == 0;
  const int err = encode_maps<T, CB>(&m1, &m2, &mo, x1, c1, x2, c2, out, B,
                                     H, W, cout, tma_out);
  if (err != 0) return err;
  if constexpr (NL == 0 && CB == kLine && N == kTmaOutWidth &&
                sizeof(T) == 2) {
    if (tma_out) {
      const int smem_tma = plan_stream<T, N>(p, false, true);
      static bool tma_attribute_set = false;
      if (!tma_attribute_set) {
        cudaFuncSetAttribute(conv3x3_wgmma<T, N, 0, kLine, false, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
        tma_attribute_set = true;
      }
      const int grid = p.nitems < sm_count() ? p.nitems : sm_count();
      if (grid > 0)
        conv3x3_wgmma<T, N, 0, kLine, false, true>
            <<<grid, kThreads, smem_tma, (cudaStream_t)stream>>>(m1, m2, mo,
                                                                 p);
      return (int)cudaGetLastError();
    }
  }
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
        <<<grid, kThreads, smem, (cudaStream_t)stream>>>(m1, m2, mo, p);
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
