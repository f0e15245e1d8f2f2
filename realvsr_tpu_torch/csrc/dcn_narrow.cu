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
// dcn_frame_kernel.py `dcn_frame_fused` (:225) and `dcn_frame_fused_bwd`
// (:501, with its XLA epilogues `_fold_dpg` / `_fold_dcoord`), which take
// any group width and any number of outputs, and a mask or none, and run
// the tap products on the matrix unit (the forward's at :207-219, the
// backward's dS at :365 and dW at :496).  So do these kernels: both are an
// implicit GEMM on the tensor cores, with the sampled matrix S made in
// shared memory and never written out.
//
// Bound on the H100.  A pixel reads x (Ci), the offsets and mask (27 G)
// and writes Co outputs; its tap products are 2 x 9 Ci x Co flop (x2
// backward, which also reads g and writes dx and the offset and mask
// gradients).  Either bound is small: at the debug configs' 16 -> 16 (49k
// pixels) ~4 us forward, ~8 backward in bf16; at 256 -> 256 the products,
// 0.06 / 0.12 ms at 989 TFLOP/s.  What costs more is the sampling: 4
// corners of every (pixel, group, tap), gathered through L1 and L2, and in
// the backward dx, scattered with one f32 vector atomic a corner and
// CH-channel chunk (7M at 16 -> 16's 49k pixels).  The
// design below keeps the products on the tensor cores, gathers every
// element once whatever Co is (to 256 outputs), keeps dW's sums out of
// the atomics, and spends the registers on sampling threads.  It replaced
// a design with the products on the f32 cores (9 Ci Co FMAs a pixel), the
// forward's taps sampled again for every 16 outputs, and the backward's dW
// added with one f32 atomic per (co, ci, tap) and 256-pixel run.
//
// The K layout, shared by both kernels.  K runs over (tap, input channel),
// tap-major.  The channels of a tap are cut into steps of at most kStepCh:
// whole groups where a group fits (gps groups a step; 16 in 4 groups: one
// step of 16), else a group's pieces of kStepCh (the last shorter), a step
// each.  A step's K is its channels zero-padded to whole 32-byte chunks (E
// channels: 16 bf16, 8 f32), one wgmma k-step each.
//
// Tiles and the walk.  A tile is 64 nwg pixels of th x tw (tw 16, or the
// image's width rounded up to a power of two where it is narrower):
// compact, so that a tile's gathers share lines (with offsets of a few
// pixels a 16 x 16 tile reads ~3 input pixels an output pixel, a run of
// 256 along one row ~11).  Both kernels walk their items persistently:
// block b of the grid (as many blocks as the SMs hold at once, by the
// card's occupancy) takes items [b n / grid, (b + 1) n / grid).  The
// sampling threads take (step, pixel, group) items, groups fastest across
// a power of two of lanes a pixel, so that a warp's corner loads take
// whole lines (at 64 channels in 8 groups, 8 lanes a 128-byte row, as
// dcn_fwd.cu's); a thread loads its next item's offsets and mask while it
// gathers this one's corners (one item at a time: two in flight cost the
// 512-thread blocks their spill-free 128 registers), and reads a corner
// as one packed vector of at most 16 bytes.
//
// Forward: out[P, Co] = S[P, K] W[K, Co], on wgmma m64nN, N the outputs
// padded to a power of two from 8 to 256 (a template parameter; past 256
// outputs column blocks of 256, each sampling the taps again: no model of
// the repo has more than 128).  A block is 1, 2 or 4 warpgroups (four up
// to N 64 in bf16, 32 in f32: 128 registers a thread; else two), each a
// 64-row m-tile of the tile; an item is (column block, tile).  An item
// runs in super-steps of qs consecutive steps (the whole K where it is 18
// chunks or fewer and fits the stage budget): all threads sample a
// super-step into one of two A stages in the 32-byte-swizzled K-major
// layout (row r's 16-byte unit u at u ^ ((r >> 2) & 1), 8-row groups 256
// bytes apart), each value rounded to T (TF32 for f32) and the padding
// zeroed; after one __syncthreads each warpgroup issues its wgmma on its
// rows of that stage (A and B by descriptors) and, while the tensor cores
// run, the threads sample the next super-step into the other stage.  The
// weight, packed once a launch into the image of shared memory ([column
// block][K chunk][N rows][32 bytes], the same swizzle, TF32-rounded for
// f32) by pack_fwd, is resident where a block's fits kFwdResident (one
// bulk copy a block), else streamed a super-step at a time into two slots
// by bulk copies on mbarriers, the next one's issued as the last one's
// product is done.  Epilogue: bias, activation, cast, each warp's 16
// pixels staged in 64-byte column chunks and stored with 16-byte stores
// where the output row is whole 16-byte units.
//
// Backward, for the output cotangent g before bias and activation:
//   dS[p, tap, ci] = sum_co g[p, co] W[co, ci, tap]   (rounded to T)
//   dx             = the transpose of the bilinear sampling of dS * mask
//   doffset        = dS * mask . d(sample)/d(position), zero where the clamp
//                    cut the offset (the gate passes on [-R, R] inclusive)
//   dmask          = dS . (unmasked sample), times s (1 - s) in place
//   dW[co, ci, tap] = sum_p g[p, co] S[p, tap, ci]   (S the masked sample)
// (with no mask, m = 1 and no dmask).  A block is one warpgroup and a tile
// 64 pixels; steps run in K-blocks of qb consecutive steps, 64 channel
// rows at most (step i of a block at rows i wfull: 16 -> 16 takes 3
// K-blocks of 4 + 4 + 1 steps, not 9 rounds), one a block where a step is
// a group's piece.  An item is (slice, tile), a slice sps consecutive
// K-blocks whose dW the block holds; items slice-major.  Per item the
// tile's g ([Co chunk][64 pixels][32 bytes], swizzled, zero past Co and
// outside the image) is staged once by the threads; past 256 outputs it is
// cut into chunks of 256, staged for dS and again for dW.  Per K-block:
// 1. dS = g W^T on wgmma m64n64 (A the g tile, B the K-block's weight [Co
//    chunk][64 channel rows][32 bytes], packed by pack_bwd; resident where
//    all of it fits kBwdResident, else a (K-block, chunk) slice at a time
//    into two slots, or one where shared memory is short, by bulk copies),
//    rounded to T into shared memory;
// 2. one thread a (pixel, group, step) samples its corners: the dx scatter
//    of dS * m * (corner weight) with f32 vector atomics, E_k = dS . corner
//    k for dmask and the position gradients (written once the group's
//    channels are done; a group in pieces keeps E in the registers of one
//    thread across its steps), and the masked sample S, written transposed
//    (S^T: [pixel chunk][64 channel rows][32 bytes], swizzled);
// 3. dW^T[rows, co] += S^T g on the tensor cores: bf16 on wgmma m64nN with
//    B, the g tile, read MN-major (transposed: the layout that was A of
//    dS); f32 on mma.sync m16n8k8 (TF32 takes no transposed operand in
//    wgmma), the warps that hold the K-block's rows, past 128 outputs a
//    column half at a time.  Each thread adds its accumulators to its own
//    slots of the block's dW partials in shared memory (no barrier, no
//    atomic), which go to dW with one f32 atomic per element when the
//    block's slice changes and at its end: dW is written at most once per
//    element and block, never once per tile or run (where one slice's
//    partials outgrow shared memory, as at 256 -> 256 in one group, they
//    sit in the block's slot of a zeroed global scratch instead, the grid
//    as many blocks as it has slots).
// Atomics make the order of the f32 sums of dx and dW vary from run to run.
#include <algorithm>

#include "dcn_sample.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace rvsr {
namespace narrow {

constexpr int kThreads = 128;  // a backward block: one warpgroup
constexpr int kRows = 64;      // pixels of a tile: one m64 tile of wgmma
constexpr int kStepCh = 64;    // input channels of a step, at most
constexpr int kOneStage = 18;  // K chunks of a tile run in one super-step
constexpr int kStageChunks = 8;  // else a super-step's chunks, at most
constexpr int kColBlock = 256;  // outputs of a column block / g chunk
constexpr int kFwdResident = 48 * 1024;  // a block's forward weight, whole
constexpr int kSlotBytes = 32 * 1024;  // a streamed forward slot, at most
constexpr int kStageBytes = 32 * 1024;  // the forward's two A stages
constexpr int kBwdResident = 64 * 1024;  // the backward's weight, whole
constexpr int kDwBudget = 48 * 1024;  // dW partials of a slice, about
constexpr int kEpiLd = 80;     // bytes of a staged epilogue row (64 + 16)
constexpr int kSmemMax = 227 * 1024;  // dynamic shared memory of a block
constexpr int kErrWidth = 9102;

__host__ __device__ inline int pad_to(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The channels of a group read at once: the largest power of two up to
// one 16-byte vector (8 bf16, 4 f32) dividing Ci / G.
inline int chunk_of(int cpg, int es) {
  int ch = 16 / es;
  while (cpg % ch) ch /= 2;
  return ch;
}

// The N of a wgmma at least w wide: 8, 16, 32, 64, 128 or 256.
inline int nw_of(int w) {
  int n = 8;
  while (n < w) n *= 2;
  return n;
}

// The K layout (see the note): steps of whole groups or of a group's
// pieces, each zero-padded to whole E-channel chunks.
struct Plan {
  int Ci, Co, G, cpg, ch, E;
  int piece;  // a group wider than kStepCh: in pieces, a step each
  int gps;    // whole groups: groups of a step
  int ppg;    // pieces: steps of a group
  int nr;     // steps of a tap
  int wfull;  // K of a full step
  int kg;     // pieces: K of a group's steps
  int kt;     // K of a tap
  int padded;  // some step's channels are not whole chunks
};

inline Plan make_plan(int Ci, int Co, int G, int es) {
  Plan q;
  q.Ci = Ci, q.Co = Co, q.G = G, q.cpg = Ci / G;
  q.ch = chunk_of(q.cpg, es);
  q.E = 32 / es;
  if (q.cpg <= kStepCh) {
    q.piece = 0, q.ppg = 1, q.kg = 0;
    q.gps = std::min(kStepCh / q.cpg, G);
    q.nr = (G + q.gps - 1) / q.gps;
    q.wfull = pad_to(q.gps * q.cpg, q.E);
    q.kt = (q.nr - 1) * q.wfull +
           pad_to(Ci - (q.nr - 1) * q.gps * q.cpg, q.E);
    q.padded = (q.gps * q.cpg) % q.E != 0 ||
               (Ci - (q.nr - 1) * q.gps * q.cpg) % q.E != 0;
  } else {
    q.piece = 1, q.gps = 1;
    q.ppg = (q.cpg + kStepCh - 1) / kStepCh;
    q.nr = G * q.ppg;
    q.wfull = kStepCh;
    q.kg = (q.ppg - 1) * kStepCh +
           pad_to(q.cpg - (q.ppg - 1) * kStepCh, q.E);
    q.kt = G * q.kg;
    q.padded = (q.cpg - (q.ppg - 1) * kStepCh) % q.E != 0;
  }
  return q;
}

// Step j of a tap: its channels [c0, c1) and their K offset in the tap.
struct Range {
  int c0, c1, koff;
};

__host__ __device__ inline Range range_of(const Plan& q, int j) {
  Range r;
  if (!q.piece) {
    r.c0 = j * q.gps * q.cpg;
    r.c1 = imin(q.Ci, r.c0 + q.gps * q.cpg);
    r.koff = j * q.wfull;
  } else {
    const int g = j / q.ppg, i = j - g * q.ppg;
    r.c0 = g * q.cpg + i * kStepCh;
    r.c1 = imin(g * q.cpg + q.cpg, r.c0 + kStepCh);
    r.koff = g * q.kg + i * kStepCh;
  }
  return r;
}

// The K offset of flat step f (tap f / nr, step f % nr); 9 nr: the end.
__host__ __device__ inline int k_of(const Plan& q, int f) {
  return f / q.nr * q.kt + range_of(q, f % q.nr).koff;
}

// The channel at K offset k of a tap, or -1 in the padding.
__host__ __device__ inline int channel_at(const Plan& q, int k) {
  int j, off;
  if (!q.piece) {
    j = k / q.wfull;
    off = k - j * q.wfull;
    if (j >= q.nr) return -1;
  } else {
    const int g = k / q.kg, r = k - g * q.kg;
    const int i = imin(r / kStepCh, q.ppg - 1);
    j = g * q.ppg + i;
    off = r - i * kStepCh;
  }
  const Range rg = range_of(q, j);
  return rg.c0 + off < rg.c1 ? rg.c0 + off : -1;
}

// The forward's layout: N, column blocks, warpgroups of a block (each a
// 64-row m-tile of the tile's rows), the weight resident or streamed,
// super-steps, and the shared memory: two A stages, the weight (resident,
// or two slots), the warps' epilogue rows, three mbarriers.
struct FwdLayout {
  int N, nb, nwg, rows, resident, qs, nsuper, sc, wbytes;
  int stage_off, w_off, epi_off, bar_off, smem;
};

// Warpgroups a forward block at most: four where the accumulators and the
// sampling fit 128 registers a thread with no spill (N <= 64 in bf16, 32
// in f32), else two.
__host__ __device__ constexpr int fwd_max_wg(int N, int es) {
  return N <= (es == 2 ? 64 : 32) ? 4 : 2;
}

inline FwdLayout fwd_layout(const Plan& q) {
  FwdLayout L;
  L.N = q.Co > kColBlock ? kColBlock : nw_of(q.Co);
  L.nb = (q.Co + L.N - 1) / L.N;
  const int chunks = 9 * q.kt / q.E;  // K chunks of a column block
  L.wbytes = chunks * L.N * 32;
  L.resident = L.nb == 1 && L.wbytes <= kFwdResident;
  const int step_chunks = q.wfull / q.E;
  // the most warpgroups whose stages and weight fit a block
  for (L.nwg = fwd_max_wg(L.N, 32 / q.E); L.nwg >= 1; L.nwg /= 2) {
    L.rows = kRows * L.nwg;
    const int per_chunk = 2 * L.rows * 32;  // both stages
    if (chunks <= kOneStage && chunks * per_chunk <= kStageBytes &&
        (L.resident || chunks * L.N * 32 <= kSlotBytes)) {
      L.qs = 9 * q.nr;
    } else {
      L.qs = std::max(1, std::min(kStageChunks / step_chunks,
                                  kStageBytes / (step_chunks * per_chunk)));
      if (!L.resident)
        L.qs = std::min(L.qs,
                        std::max(1, kSlotBytes / (step_chunks * L.N * 32)));
      L.qs = std::min(L.qs, 9 * q.nr);
    }
    L.nsuper = (9 * q.nr + L.qs - 1) / L.qs;
    L.sc = L.qs * step_chunks;
    L.stage_off = 0;
    L.w_off = L.sc * per_chunk;
    L.epi_off = L.w_off + (L.resident ? L.wbytes : 2 * L.sc * L.N * 32);
    L.bar_off = L.epi_off + 4 * L.nwg * 16 * kEpiLd;
    L.smem = L.bar_off + 3 * 8;
    if (L.smem <= kSmemMax || L.nwg == 1) break;
  }
  return L;
}

// The backward's layout: K-blocks of qb consecutive steps (64 channel rows
// at most: step i of a block at rows i wfull ...; one step a block where a
// step is a group's piece), g chunks (gch outputs, each padded to a wgmma
// N), the weight resident or streamed in (K-block, chunk) slices through
// nslot slots, slices of sps K-blocks, the block's dW partials of a slice
// (part bytes) in shared memory (dws) or, where they outgrow it, in the
// block's slot of a global scratch, and the shared memory: the g tile, the
// weight, dS, S^T, the partials, three mbarriers.
struct BwdLayout {
  int qb, nkb, gch, ngc, nw0, nwl, cow, resident, nslot, wtotal;
  int nwr, sps, nslices, dws, part;
  int g_off, w_off, ds_off, st_off, dw_off, bar_off, smem;
};

inline BwdLayout bwd_layout(const Plan& q, int es) {
  BwdLayout L;
  L.qb = q.piece ? 1 : std::max(1, kStepCh / q.wfull);
  L.nkb = (9 * q.nr + L.qb - 1) / L.qb;
  L.gch = std::min(pad_to(q.Co, q.E), kColBlock);
  L.ngc = (q.Co + L.gch - 1) / L.gch;
  L.nw0 = nw_of(L.gch);
  L.nwl = nw_of(pad_to(q.Co - (L.ngc - 1) * L.gch, q.E));
  L.cow = (L.ngc - 1) * L.nw0 + L.nwl;
  L.wtotal = L.nkb * L.cow / q.E * kRows * 32;
  L.resident = L.wtotal <= kBwdResident;
  L.nwr = (L.qb * q.wfull + 15) / 16;
  const int gbytes = L.nw0 * kRows * es;
  const int slot = L.nw0 / q.E * kRows * 32;
  const int dsb = kRows * (kStepCh * es + 4);  // rows 4 bytes longer
  const int stb = kRows * kStepCh * es;
  const int per_kb = L.cow / 2 * L.nwr * 32 * 4;
  const int unit = q.piece ? q.ppg : 1;
  const int want = std::max(1, kDwBudget / (per_kb * unit)) * unit;
  // the first that fits: two slots with the partials of `want` steps,
  // one slot, then the fewest steps a slice takes; else the fewest steps'
  // partials in global scratch
  const int tries[4][3] = {{2, 1, 0}, {1, 1, 0}, {2, 1, 1}, {1, 1, 1}};
  L.dws = 0, L.nslot = 1, L.sps = unit;
  for (const auto& t : tries) {
    const int nslot = t[0], sps = t[2] ? unit : std::min(want, L.nkb);
    const int w = L.resident ? L.wtotal : nslot * slot;
    if (gbytes + w + dsb + stb + sps * per_kb + 24 <= kSmemMax) {
      L.dws = 1, L.nslot = nslot, L.sps = sps;
      break;
    }
  }
  if (!L.dws) {
    const int w2 = L.resident ? L.wtotal : 2 * slot;
    L.nslot = gbytes + w2 + dsb + stb + 24 <= kSmemMax ? 2 : 1;
  }
  L.nslices = (L.nkb + L.sps - 1) / L.sps;
  L.part = L.sps * per_kb;
  L.g_off = 0;
  L.w_off = gbytes;
  L.ds_off = L.w_off + (L.resident ? L.wtotal : L.nslot * slot);
  L.st_off = L.ds_off + dsb;
  L.dw_off = L.st_off + stb;
  L.bar_off = L.dw_off + (L.dws ? L.sps * per_kb : 0);
  L.smem = L.bar_off + 3 * 8;
  return L;
}

// ------------------------------------------------------------ device parts

// CH contiguous elements (at most 16 bytes, aligned) as one packed vector.
template <typename T, int CH>
struct Packed {
  static constexpr int kBytes = CH * (int)sizeof(T);
  static_assert(kBytes <= 16, "one 16-byte vector at most");
  using V = typename std::conditional<
      kBytes == 16, uint4,
      typename std::conditional<
          kBytes == 8, uint2,
          typename std::conditional<kBytes == 4, unsigned,
                                    unsigned short>::type>::type>::type;
};

// Element i of a packed vector, as f32.
template <typename T, int CH>
__device__ __forceinline__ float elem(const typename Packed<T, CH>::V& v,
                                      int i) {
  return Traits<T>::to_f(reinterpret_cast<const T*>(&v)[i]);
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

// The raw offsets and mask of one (pixel, group, tap), loaded ahead of
// their use and converted there (as dcn_fwd.cu's RawOffMask), so that the
// loads of the next items stay in flight beside this one's gathers.  The
// (dy, dx) pair is one vector load: the wrappers pass offset rows an even
// number of elements apart (DCNPack's om in an odd number of groups has
// its offsets copied).  With no mask (DCNv1) none is read and m = 1.
template <typename T>
struct Raw {
  using Pair = typename std::conditional<std::is_same<T, float>::value,
                                         float2, __nv_bfloat162>::type;
  Pair d;
  T m;
};

template <typename T>
__device__ __forceinline__ void load_raw(Raw<T>& r, const OffMask<T>& om,
                                         int p, int g, int tap) {
  r.d = __ldg(reinterpret_cast<const typename Raw<T>::Pair*>(
      om.off + (size_t)p * om.off_stride + g * 18 + 2 * tap));
  if (om.msk != nullptr)
    r.m = __ldg(om.msk + (size_t)p * om.msk_stride + g * 9 + tap);
}

// The geometry of a (pixel, group, tap) from its raw offsets and mask.
template <typename T>
__device__ __forceinline__ Corners geometry(const Raw<T>& r,
                                            const OffMask<T>& om, int p,
                                            int y, int xx, int tap, int H,
                                            int W, float max_off, int clamp,
                                            float& m) {
  using Tr = Traits<T>;
  float dy, dx;
  if constexpr (std::is_same<T, float>::value) {
    dy = r.d.x, dx = r.d.y;
  } else {
    dy = __low2float(r.d), dx = __high2float(r.d);
  }
  m = 1.f;
  if (om.msk != nullptr) {
    const float raw = Tr::to_f(r.m);
    m = om.logits ? Tr::to_f(Tr::from_f(1.f / (1.f + expf(-raw)))) : raw;
  }
  return corners(dy, dx, p, y, xx, tap, H, W, max_off, clamp);
}

// The sampling walk: a (step, pixel, group) item a thread, groups fastest
// across lpp = 2^lpp_log lanes a pixel (the step's groups rounded up to a
// power of two, at most 32), so that the lanes of a pixel read its
// neighbouring channels and a warp's corner load takes whole lines (at 64
// channels in 8 groups, 8 lanes a 128-byte row, as dcn_fwd.cu's);
// thread t keeps its lane of the pixel, t % lpp, and takes groups t % lpp
// + lpp j, j < nj.  Rows of the tile (a power of two) then steps follow.
struct Walk {
  int lpp_log, nj, rows_log, threads;
};

__host__ __device__ inline Walk walk_of(const Plan& q, int rows, int threads) {
  Walk w;
  w.lpp_log = 0;
  while ((1 << w.lpp_log) < q.gps && w.lpp_log < 5) ++w.lpp_log;
  w.nj = (q.gps + (1 << w.lpp_log) - 1) >> w.lpp_log;
  w.rows_log = 0;
  while ((1 << w.rows_log) < rows) ++w.rows_log;
  w.threads = threads;
  return w;
}

// A tile: th x tw pixels (tw = 2^tw_log: 16, or the image's width rounded
// up to a power of two where it is narrower), row r of the product the
// pixel (r >> tw_log, r & (tw - 1)) of it; tile = (b * tiles_y + ty) *
// tiles_x + tx.  Compact tiles keep the footprint of a tile's gathers
// small (with offsets of a few pixels a 16 x 16 tile reads ~3 input pixels
// an output pixel, a run of 256 along one row ~11).
struct Tiles {
  int tiles_x, tiles_y, th, tw_log;
};

struct TileAt {
  int b, y0, x0;
};

__device__ __forceinline__ TileAt tile_at(const Tiles& t, int tile) {
  TileAt a;
  const int rest = tile / t.tiles_x;
  a.x0 = (tile - rest * t.tiles_x) << t.tw_log;
  a.b = rest / t.tiles_y;
  a.y0 = (rest - a.b * t.tiles_y) * t.th;
  return a;
}

// The pixel of row r of a tile, at (y, x); -1 outside the image.
__device__ __forceinline__ int pixel_at(const TileAt& a, const Tiles& t,
                                        int r, int H, int W, int& y,
                                        int& x) {
  y = a.y0 + (r >> t.tw_log);
  x = a.x0 + (r & ((1 << t.tw_log) - 1));
  return y < H && x < W ? (a.b * H + y) * W + x : -1;
}

// A sampling item: pixel row r of the tile (pixel pix at (y, xx)), group
// grp of a step at tap `tap`, its channels [lo, hi).
struct Item {
  int r, pix, y, xx, grp, tap, lo, hi;
  int c0, k;  // the step's first channel and its K offset in the tile
  int sub;    // the step's place among the walk's steps
};

// The thread's items in steps [f0, f0 + nf) of a tile: how many.
__device__ __forceinline__ int items_of(const Walk& w, int nf) {
  const int slots = nf << (w.rows_log + w.lpp_log);
  const int t = threadIdx.x;
  return t < slots ? ((slots - 1 - t) / w.threads + 1) * w.nj : 0;
}

// Item m of the thread's; false where it has no channels or no pixel.
__device__ __forceinline__ bool item_at(const Plan& q, const Walk& w,
                                        const TileAt& a, const Tiles& t,
                                        int f0, int H, int W, int m,
                                        Item& d) {
  const int n = w.nj == 1 ? m : m / w.nj, j = m - n * w.nj;
  const int it = threadIdx.x + w.threads * n;
  const int slot = it >> w.lpp_log;
  const int gi = (it & ((1 << w.lpp_log) - 1)) + (j << w.lpp_log);
  d.r = slot & ((1 << w.rows_log) - 1);
  d.sub = slot >> w.rows_log;
  const int f = f0 + d.sub;
  d.tap = f / q.nr;
  const int jj = f - d.tap * q.nr;
  const Range rg = range_of(q, jj);
  d.grp = q.piece ? jj / q.ppg : jj * q.gps + gi;
  d.lo = imax(rg.c0, d.grp * q.cpg);
  d.hi = imin(rg.c1, d.grp * q.cpg + q.cpg);
  d.c0 = rg.c0;
  d.k = d.tap * q.kt + rg.koff;
  d.pix = pixel_at(a, t, d.r, H, W, d.y, d.xx);
  return gi < q.gps && d.lo < d.hi && d.pix >= 0;
}

// CH channels from ch0 of the 4 corners, pixel rows of C channels, packed
// (zeros where a corner is invalid); the four loads in flight together.
template <typename T, int CH>
__device__ __forceinline__ void corner_chunk(
    typename Packed<T, CH>::V (&e)[4], const T* x, const Corners& c, int C,
    int ch0) {
  using V = typename Packed<T, CH>::V;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    e[k] = c.valid[k] ? __ldg(reinterpret_cast<const V*>(
                            x + (size_t)c.pix[k] * C + ch0))
                      : V{};
}

// The masked bilinear sample of CH channels, corners in the plain op's
// order, rounded to T.
template <typename T, int CH>
__device__ __forceinline__ void masked(float (&v)[CH],
                                       const typename Packed<T, CH>::V (&e)[4],
                                       const Corners& c, float m) {
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    float a = elem<T, CH>(e[0], i) * c.cw[0];
    a += elem<T, CH>(e[1], i) * c.cw[1];
    a += elem<T, CH>(e[2], i) * c.cw[2];
    a += elem<T, CH>(e[3], i) * c.cw[3];
    v[i] = Traits<T>::to_f(Traits<T>::from_f(a * m));
  }
}

// Byte offset of element k of row r in a 32-byte-swizzled K-major image of
// `rows` rows: [k / E][r][32 bytes], 16-byte unit u of a row at u ^ ((r >>
// 2) & 1) (desc_sw32's layout).
template <typename T>
__device__ __forceinline__ int sw32_at(int r, int k, int rows) {
  constexpr int U = 16 / (int)sizeof(T), E = 2 * U;
  const int w = k % E;
  return (k / E) * rows * 32 + r * 32 + (((w / U) ^ ((r >> 2) & 1)) << 4) +
         (w % U) * (int)sizeof(T);
}

// v[0 .. CH) as the tensor cores take them, at elements k ... of row r of
// a swizzled K-major image of `rows` rows (k a multiple of CH).
template <typename T, int CH>
__device__ __forceinline__ void put_run(unsigned char* img, int r, int k,
                                        const float (&v)[CH], int rows) {
  constexpr int es = (int)sizeof(T), U = 16 / es;
  constexpr int n = CH < U ? CH : U;  // elements of one 16-byte unit
#pragma unroll
  for (int h = 0; h < CH / n; ++h) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < n; ++i) e[i] = Traits<T>::to_mma(v[h * n + i]);
    unsigned char* dst = img + sw32_at<T>(r, k + h * n, rows);
    if constexpr (n * es == 16)
      *reinterpret_cast<uint4*>(dst) = raw;
    else if constexpr (n * es == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(raw.x, raw.y);
    else if constexpr (n * es == 4)
      *reinterpret_cast<unsigned*>(dst) = raw.x;
    else
      *reinterpret_cast<T*>(dst) = e[0];
  }
}

// wgmma descriptor of an MN-major operand with the 32-byte swizzle: atoms
// of 8 K rows x 32 bytes (16 bf16 along N), 8-row K groups 256 bytes apart
// (stride byte offset), N atoms `lead` bytes apart (leading byte offset).
__device__ __forceinline__ uint64_t desc_mn32(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

// ---------------------------------------------------------------- forward

template <typename T>
struct FwdParams {
  const T* x;
  OffMask<T> om;           // om.msk null: no mask
  const unsigned char* w;  // packed by pack_fwd
  const T* bias;
  T* out;
  Plan q;
  FwdLayout L;
  Tiles t;
  int H, W, act, clamp, ntiles, nitems;
  float max_off;
};

// The packed forward weight: [column block][K chunk][N rows][32 bytes],
// swizzled, zero in the padding and past Co, TF32-rounded for f32.
template <typename T>
__global__ void pack_fwd(const T* __restrict__ w, T* __restrict__ out,
                         Plan q, int N, long long total) {
  constexpr int U = 16 / (int)sizeof(T);
  const int E = q.E, chunks = 9 * q.kt / E;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int pos = (int)(e % E);
    long long r = e / E;
    const int n = (int)(r % N);
    r /= N;
    const int kk = (int)(r % chunks), cb = (int)(r / chunks);
    const int lw = ((pos / U) ^ ((n >> 2) & 1)) * U + pos % U;
    const int k = kk * E + lw, tap = k / q.kt;
    const int c = channel_at(q, k - tap * q.kt), co = cb * N + n;
    float v = 0.f;
    if (c >= 0 && co < q.Co)
      v = Traits<T>::to_f(w[((size_t)co * q.Ci + c) * 9 + tap]);
    out[e] = Traits<T>::to_mma(v);
  }
}

// Sample super-step ss of a tile into an A stage: every (step, pixel,
// group) of it once, on the walk of walk_of, the raw offsets and mask of
// the thread's next item loaded while this one's corners are gathered
// (all four corner loads of a chunk in flight together); then zeros in
// each step's padding.  One item at a time: two in flight cost the
// registers of 512-thread blocks (128 a thread) their spill-free fit.
template <typename T, int CH>
__device__ void sample_fwd(const FwdParams<T>& p, int tile, int ss,
                           unsigned char* stage) {
  const Plan& q = p.q;
  const int R = p.L.rows;
  const Walk w = walk_of(q, R, 2 * R);
  const int f0 = ss * p.L.qs, f1 = imin(f0 + p.L.qs, 9 * q.nr);
  const int kbase = k_of(q, f0);
  const int cnt = items_of(w, f1 - f0);
  const TileAt at = tile_at(p.t, tile);
  // the next item's raw offsets and mask in flight; its indices are found
  // again when it comes up (registers, not the loads, bound the blocks)
  Raw<T> nraw;
  auto prefetch = [&](int i) {
    Item t;
    const bool v = i < cnt && item_at(q, w, at, p.t, f0, p.H, p.W, i, t);
    if (v) load_raw(nraw, p.om, t.pix, t.grp, t.tap);
    return v;
  };
  bool nv = prefetch(0);
#pragma unroll 1
  for (int i = 0; i < cnt; ++i) {
    const Raw<T> raw = nraw;
    const bool v = nv;
    nv = prefetch(i + 1);
    Item d;
    if (!v || !item_at(q, w, at, p.t, f0, p.H, p.W, i, d)) continue;
    float m;
    const Corners c = geometry<T>(raw, p.om, d.pix, d.y, d.xx, d.tap, p.H,
                                  p.W, p.max_off, p.clamp, m);
    const int k0 = d.k - kbase - d.c0;
#pragma unroll 1
    for (int ch = d.lo; ch < d.hi; ch += CH) {
      typename Packed<T, CH>::V e[4];
      float val[CH];
      corner_chunk<T, CH>(e, p.x, c, q.Ci, ch);
      masked<T, CH>(val, e, c, m);
      put_run<T, CH>(stage, d.r, k0 + ch, val, R);
    }
  }
  if (!q.padded) return;
  const int E = q.E;
  for (int it = threadIdx.x; it < (f1 - f0) * R * E; it += 2 * R) {
    const int kk = it % E, rr = it / E % R, f = f0 + it / (E * R);
    const int tap = f / q.nr, j = f - tap * q.nr;
    const Range rg = range_of(q, j);
    const int wd = rg.c1 - rg.c0;
    if (wd + kk < pad_to(wd, E))
      *reinterpret_cast<T*>(
          stage + sw32_at<T>(rr, tap * q.kt + rg.koff - kbase + wd + kk,
                             R)) = Traits<T>::from_f(0.f);
  }
}

template <typename T>
__device__ __forceinline__ void sample_fwd_any(const FwdParams<T>& p,
                                               int tile, int ss,
                                               unsigned char* stage) {
  constexpr int kV = 16 / (int)sizeof(T);  // the widest chunk of T
  switch (p.q.ch) {
    case kV:
      return sample_fwd<T, kV>(p, tile, ss, stage);
    case kV / 2:
      return sample_fwd<T, kV / 2>(p, tile, ss, stage);
    case kV / 4:
      return sample_fwd<T, kV / 4>(p, tile, ss, stage);
    default:
      return sample_fwd<T, 1>(p, tile, ss, stage);
  }
}

// The epilogue of one warp: its 16 pixels (rows 16 warp ...) of the tile
// by the N accumulator columns of column block cb, through its staging
// rows in 64-byte column chunks: bias, activation, cast, 16-byte stores
// where the output row is whole 16-byte units.
template <typename T, int N>
__device__ __forceinline__ void epilogue(const float* acc,
                                         const FwdParams<T>& p, int tile,
                                         int cb, unsigned char* stage,
                                         int warp, int lane) {
  using Tr = Traits<T>;
  constexpr int es = (int)sizeof(T), U = 16 / es;
  constexpr int EC = 64 / es;             // columns of a staged chunk
  constexpr int CW = N < EC ? N : EC;     // of this N
  constexpr int UPR = CW / U;             // 16-byte units of a staged row
  const int g = lane >> 2, t = lane & 3, Co = p.q.Co;
  const TileAt at = tile_at(p.t, tile);
  const bool whole = (Co * es) % 16 == 0;
#pragma unroll
  for (int cc = 0; cc < N / CW; ++cc) {
#pragma unroll
    for (int jj = 0; jj < CW / 8; ++jj) {
      const int j = cc * (CW / 8) + jj;
      const int col = cb * N + 8 * j + 2 * t;
      float b0 = 0.f, b1 = 0.f;
      if (p.bias != nullptr) {
        if (col < Co) b0 = Tr::to_f(p.bias[col]);
        if (col + 1 < Co) b1 = Tr::to_f(p.bias[col + 1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        T* d = reinterpret_cast<T*>(stage + (g + 8 * hh) * kEpiLd) +
               8 * jj + 2 * t;
        d[0] = Tr::from_f(apply_act(acc[4 * j + 2 * hh] + b0, p.act));
        d[1] = Tr::from_f(apply_act(acc[4 * j + 2 * hh + 1] + b1, p.act));
      }
    }
    __syncwarp();
    const int c0 = cb * N + cc * CW;
    for (int it = lane; it < 16 * UPR; it += 32) {
      const int r = it / UPR, uu = it % UPR, col = c0 + uu * U;
      int y, x;
      const int pix = pixel_at(at, p.t, 16 * warp + r, p.H, p.W, y, x);
      if (pix < 0 || col >= Co) continue;
      const unsigned char* src = stage + r * kEpiLd + uu * 16;
      T* dst = p.out + (size_t)pix * Co + col;
      if (whole && col + U <= Co) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        const T* e = reinterpret_cast<const T*>(src);
        for (int i = 0; i < U && col + i < Co; ++i) dst[i] = e[i];
      }
    }
    __syncwarp();
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(128 * fwd_max_wg(N, sizeof(T)), 1)
    fwd_kernel(const __grid_constant__ FwdParams<T> p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 255) __trap();  // the 32-byte swizzle needs 256-byte rows
  const Plan& q = p.q;
  const FwdLayout& L = p.L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t bars = base + L.bar_off;  // slot 0, slot 1, resident
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int i0 = (int)((long long)blockIdx.x * p.nitems / gridDim.x);
  const int i1 = (int)((long long)(blockIdx.x + 1) * p.nitems / gridDim.x);
  const int nu = (i1 - i0) * L.nsuper;  // the block's super-steps
  const int chunks = 9 * q.kt / q.E;
  const uint32_t slot_bytes = L.sc * N * 32;
  const int stage_bytes = L.sc * L.rows * 32;
  const int wg = warp >> 2;  // the warpgroup: m-tile wg of the tile
  // super-step u's weight: its chunks of its item's column block, into
  // slot u & 1
  auto issue_w = [&](int u) {
    const int item = i0 + u / L.nsuper, ss = u % L.nsuper;
    const int f0 = ss * L.qs, f1 = imin(f0 + L.qs, 9 * q.nr);
    const int k0 = k_of(q, f0), k1 = k_of(q, f1);
    const uint32_t bytes = (k1 - k0) / q.E * N * 32;
    const uint32_t bar = bars + 8 * (u & 1);
    mbar_expect_tx(bar, bytes);
    bulk_load(base + L.w_off + (u & 1) * slot_bytes,
              p.w + ((size_t)(item / p.ntiles) * chunks + k0 / q.E) * N * 32,
              bytes, bar);
  };
  if (tid == 0 && nu > 0) {
    if (L.resident) {
      mbar_expect_tx(bars + 16, L.wbytes);
      bulk_load(base + L.w_off, p.w, L.wbytes, bars + 16);
    } else {
      issue_w(0);
    }
  }
  unsigned char* epi = smem + L.epi_off + warp * 16 * kEpiLd;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  if (nu > 0) sample_fwd_any<T>(p, i0 % p.ntiles, 0, smem + L.stage_off);
  if (L.resident && nu > 0) mbar_wait(bars + 16, 0);
  for (int u = 0; u < nu; ++u) {
    fence_proxy_async();  // wgmma reads the stage
    __syncthreads();      // stage u & 1 whole; product u - 1 done
    if (!L.resident) {
      if (tid == 0 && u + 1 < nu) issue_w(u + 1);
      mbar_wait(bars + 8 * (u & 1), (u >> 1) & 1);
    }
    const int item = i0 + u / L.nsuper, ss = u % L.nsuper;
    const int f0 = ss * L.qs, f1 = imin(f0 + L.qs, 9 * q.nr);
    const int k0 = k_of(q, f0), nk = (k_of(q, f1) - k0) / q.E;
    const uint32_t a = base + L.stage_off + (u & 1) * stage_bytes;
    const uint32_t b = L.resident ? base + L.w_off + k0 / q.E * N * 32
                                  : base + L.w_off + (u & 1) * slot_bytes;
    wgmma_fence();
#pragma unroll 1
    for (int kc = 0; kc < nk; ++kc)
      WgmmaSS<T, N>::run(acc, desc_sw32(a + (kc * L.rows + wg * kRows) * 32),
                         desc_sw32(b + kc * N * 32),
                         (ss > 0 || kc > 0) ? 1 : 0);
    wgmma_commit();
    if (u + 1 < nu) {  // the next super-step, while the tensor cores run
      const int nitem = i0 + (u + 1) / L.nsuper;
      sample_fwd_any<T>(p, nitem % p.ntiles, (u + 1) % L.nsuper,
                        smem + L.stage_off + ((u + 1) & 1) * stage_bytes);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
    if (ss == L.nsuper - 1)
      epilogue<T, N>(acc, p, item % p.ntiles, item / p.ntiles, epi, warp,
                     lane);
  }
}

// --------------------------------------------------------------- backward

template <typename T>
struct BwdParams {
  const T* x;
  OffMask<T> om;            // om.msk null: no mask
  const unsigned char* wt;  // packed by pack_bwd
  const T* gout;
  float* dx;
  T* doff;  // offset gradient of pixel 0, rows of doff_stride
  T* dmsk;  // mask (or logit) gradient of pixel 0, rows of dmsk_stride;
            // null with no mask
  int doff_stride, dmsk_stride;
  float* dw;  // (Co, 9, Ci) = (cout, tap, cin)
  float* part;  // the blocks' dW partials where shared memory is short
  Plan q;
  BwdLayout L;
  Tiles t;
  int H, W, clamp, ntiles, nitems;
  float max_off;
};

// The packed backward weight: [K-block][co chunk][64 channel rows][32
// bytes] (row n: channel n % wfull of the block's step n / wfull), each g
// chunk's co padded to its wgmma N, swizzled, zero in the padding,
// TF32-rounded for f32.
template <typename T>
__global__ void pack_bwd(const T* __restrict__ w, T* __restrict__ out,
                         Plan q, BwdLayout L, long long total) {
  constexpr int U = 16 / (int)sizeof(T);
  const int E = q.E, chunks = L.cow / E;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int pos = (int)(e % E);
    long long r = e / E;
    const int n = (int)(r % kRows);
    r /= kRows;
    const int kk = (int)(r % chunks), kb = (int)(r / chunks);
    const int cw = kk * E + ((pos / U) ^ ((n >> 2) & 1)) * U + pos % U;
    const int gc = imin(cw / L.nw0, L.ngc - 1), off = cw - gc * L.nw0;
    const int co = gc * L.gch + off;
    const int sub = n / q.wfull, f = kb * L.qb + sub;
    const int tap = f / q.nr;
    const Range rg = range_of(q, f - tap * q.nr);
    const int c = rg.c0 + n - sub * q.wfull;
    float v = 0.f;
    if (sub < L.qb && f < 9 * q.nr && off < L.gch && co < q.Co && c < rg.c1)
      v = Traits<T>::to_f(w[((size_t)co * q.Ci + c) * 9 + tap]);
    out[e] = Traits<T>::to_mma(v);
  }
}

// The tile's g for chunk gc: [co chunk][64 pixels][32 bytes], swizzled,
// zero past Co, past the chunk and past P.
template <typename T>
__device__ void stage_g(const BwdParams<T>& p, int tile, int gc,
                        unsigned char* sg) {
  constexpr int U = 16 / (int)sizeof(T);
  const int Co = p.q.Co, nw = gc == p.L.ngc - 1 ? p.L.nwl : p.L.nw0;
  const int hi = imin(Co, gc * p.L.gch + p.L.gch);
  const bool whole = (Co * (int)sizeof(T)) % 16 == 0;
  const int upr = nw / U;
  const TileAt at = tile_at(p.t, tile);
  for (int it = threadIdx.x; it < kRows * upr; it += kThreads) {
    const int r = it / upr, u = it - r * upr, co0 = gc * p.L.gch + u * U;
    int y, x;
    const int pix = pixel_at(at, p.t, r, p.H, p.W, y, x);
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (pix >= 0 && co0 < hi) {
      const T* src = p.gout + (size_t)pix * Co + co0;
      if (whole && co0 + U <= hi) {
        raw = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        T* e = reinterpret_cast<T*>(&raw);
        for (int i = 0; i < U && co0 + i < hi; ++i) e[i] = src[i];
      }
    }
    *reinterpret_cast<uint4*>(sg + sw32_at<T>(r, u * U, kRows)) = raw;
  }
}

// Element (k row, pixel r) of S^T: [pixel chunk][64 rows][32 bytes].
template <typename T>
__device__ __forceinline__ void put_st(unsigned char* st, int k, int r,
                                       float v) {
  constexpr int U = 16 / (int)sizeof(T), E = 2 * U;
  const int w = r % E;
  *reinterpret_cast<T*>(st + (r / E) * kRows * 32 + k * 32 +
                        (((w / U) ^ ((k >> 2) & 1)) << 4) +
                        (w % U) * (int)sizeof(T)) = Traits<T>::to_mma(v);
}

// Sample step f of a tile on the walk of walk_of, the raw offsets and mask
// of the thread's next item loaded while this one's corners are gathered:
// dx, doffset, dmask, and S^T for dW (zero columns for pixels outside the
// image).  Ep: the E sums of a group in pieces (one a step, one lane a
// pixel), kept by the thread of its pixel across the group's steps.
template <typename T, int CH>
__device__ void sample_bwd(const BwdParams<T>& p, int tile, int kb,
                           const T* sds, unsigned char* sst,
                           float (&Ep)[4]) {
  using Tr = Traits<T>;
  constexpr int lds = kStepCh + 4 / (int)sizeof(T);
  const Plan& q = p.q;
  const Walk w = walk_of(q, kRows, kThreads);
  const int f = kb * p.L.qb, nf = imin(p.L.qb, 9 * q.nr - f);
  const int cnt = items_of(w, nf);
  const TileAt at = tile_at(p.t, tile);
  Item nd;
  Raw<T> nraw;
  bool nv = cnt > 0 && item_at(q, w, at, p.t, f, p.H, p.W, 0, nd);
  if (nv) load_raw(nraw, p.om, nd.pix, nd.grp, nd.tap);
#pragma unroll 1
  for (int i = 0; i < cnt; ++i) {
    const Item d = nd;
    const Raw<T> raw = nraw;
    const bool v = nv;
    nv = i + 1 < cnt && item_at(q, w, at, p.t, f, p.H, p.W, i + 1, nd);
    if (nv) load_raw(nraw, p.om, nd.pix, nd.grp, nd.tap);
    if (!v) continue;
    float m;
    const Corners c = geometry<T>(raw, p.om, d.pix, d.y, d.xx, d.tap, p.H,
                                  p.W, p.max_off, p.clamp, m);
    float E[4];  // E_k = dS . (corner k)
    const bool cont = q.piece && d.lo != d.grp * q.cpg;
    const int row0 = d.sub * q.wfull - d.c0;  // the K-block row of channel 0
#pragma unroll
    for (int k = 0; k < 4; ++k) E[k] = cont ? Ep[k] : 0.f;
#pragma unroll 1
    for (int ch = d.lo; ch < d.hi; ch += CH) {
      typename Packed<T, CH>::V e[4];
      float ds[CH], S[CH];
      corner_chunk<T, CH>(e, p.x, c, q.Ci, ch);
      // rounded to T when it was staged, as autograd of the plain op
      // rounds it through the cast of the columns
#pragma unroll
      for (int i2 = 0; i2 < CH; ++i2)
        ds[i2] = Tr::to_f(sds[d.r * lds + row0 + ch + i2]);
      masked<T, CH>(S, e, c, m);
#pragma unroll
      for (int i2 = 0; i2 < CH; ++i2)
        put_st<T>(sst, row0 + ch + i2, d.r, S[i2]);
      // dmask = sum_k w_k E_k, and the position gradients are m times
      // differences of the E_k
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i2 = 0; i2 < CH; ++i2) E[k] += ds[i2] * elem<T, CH>(e[k], i2);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c.valid[k])
          add_dx<CH>(p.dx + (size_t)c.pix[k] * q.Ci + ch, ds, c.cw[k] * m);
    }
    if (d.hi < d.grp * q.cpg + q.cpg) {  // more of the group later
#pragma unroll
      for (int k = 0; k < 4; ++k) Ep[k] = E[k];
      continue;
    }
    const float dty =
        m * ((1.f - c.tx) * (E[2] - E[0]) + c.tx * (E[3] - E[1]));
    const float dtx =
        m * ((1.f - c.ty) * (E[1] - E[0]) + c.ty * (E[3] - E[2]));
    const float gy = c.pass_y ? dty : 0.f, gx = c.pass_x ? dtx : 0.f;
    T* od = p.doff + (size_t)d.pix * p.doff_stride + d.grp * 18 + 2 * d.tap;
    od[0] = Tr::from_f(gy);
    od[1] = Tr::from_f(gx);
    if (p.dmsk != nullptr) {
      const float dm = c.cw[0] * E[0] + c.cw[1] * E[1] + c.cw[2] * E[2] +
                       c.cw[3] * E[3];
      float gm = Tr::to_f(Tr::from_f(dm));
      if (p.om.logits) gm = gm * (1.f - m) * m;
      p.dmsk[(size_t)d.pix * p.dmsk_stride + d.grp * 9 + d.tap] =
          Tr::from_f(gm);
    }
  }
  if (at.y0 + p.t.th > p.H || at.x0 + (1 << p.t.tw_log) > p.W) {
    // rows outside the image sample nothing: zero columns of S^T
    const int wd = nf * q.wfull;
    for (int it = threadIdx.x; it < kRows * wd; it += kThreads) {
      const int rr = it / wd;
      int y, x;
      if (pixel_at(at, p.t, rr, p.H, p.W, y, x) < 0)
        put_st<T>(sst, it - rr * wd, rr, 0.f);
    }
  }
}

// dW element of accumulator e of this thread (the wgmma / mma.sync
// layout): channel row and output column of a 64 x nw product.
__device__ __forceinline__ void dw_at(int e, int warp, int lane, int& row,
                                      int& col) {
  row = 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
  col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
}

// dW's address of accumulator row `row` (a K-block row), output co of
// K-block kb: (co, tap, ci), or -1 in the padding.
__device__ __forceinline__ long long dw_index(const Plan& q,
                                              const BwdLayout& L, int kb,
                                              int row, int co) {
  const int sub = row / q.wfull, f = kb * L.qb + sub;
  if (sub >= L.qb || f >= 9 * q.nr || co >= q.Co) return -1;
  const int tap = f / q.nr;
  const Range rg = range_of(q, f - tap * q.nr);
  const int c = rg.c0 + row - sub * q.wfull;
  return c < rg.c1 ? ((long long)co * 9 + tap) * q.Ci + c : -1;
}

// Add this thread's nw / 2 accumulators of K-block kb (slot i of the
// slice), g chunk gc, columns from col0, to its own slots of the block's
// dW partials: no barrier, no atomic.
template <int NW>
__device__ __forceinline__ void dw_add(const float* acc, float* sdw, int i,
                                       int gc, int col0,
                                       const BwdLayout& L) {
  const int tid = threadIdx.x, warp = tid >> 5;
  if (warp >= L.nwr) return;
  float* s = sdw + ((size_t)i * (L.cow / 2) + (gc * L.nw0 + col0) / 2) *
                       (L.nwr * 32) + tid;
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) s[e * L.nwr * 32] += acc[e];
}

// The block's dW partials of slice s to dW, one f32 atomic an element, and
// zeroed.
__device__ void dw_flush(float* sdw, int s, const Plan& q,
                         const BwdLayout& L, float* dw) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (warp >= L.nwr) return;
  const int k0 = s * L.sps, k1 = imin(k0 + L.sps, L.nkb);
  for (int kb = k0; kb < k1; ++kb) {
    for (int gc = 0; gc < L.ngc; ++gc) {
      const int nw = gc == L.ngc - 1 ? L.nwl : L.nw0;
      float* sp = sdw + ((size_t)(kb - k0) * (L.cow / 2) + gc * (L.nw0 / 2)) *
                            (L.nwr * 32) + tid;
      for (int e = 0; e < nw / 2; ++e) {
        int row, col;
        dw_at(e, warp, lane, row, col);
        const float v = sp[e * L.nwr * 32];
        sp[e * L.nwr * 32] = 0.f;
        const long long at = col < L.gch
                                 ? dw_index(q, L, kb, row, gc * L.gch + col)
                                 : -1;
        if (at >= 0) atomicAdd(dw + at, v);
      }
    }
  }
}

// f32's dW^T[64 channel rows, nw] = S^T g_chunk over the tile's 64 pixels
// on mma.sync m16n8k8 (TF32 takes no transposed operand in wgmma): warp w
// the rows 16 w ...; the accumulators in the wgmma layout.
template <int NW>
__device__ __forceinline__ void dw_mma_sync(float (&acc)[NW / 2],
                                            const unsigned char* sst,
                                            const unsigned char* sg,
                                            int warp, int lane) {
  constexpr int U = 4, E = 8;  // f32: elements of 16 and 32 bytes
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  // element (row k, column j) of a K-major swizzled image of kRows rows
  auto at = [&](const unsigned char* img, int k, int j) {
    const int w = j % E;
    return *reinterpret_cast<const float*>(
        img + (j / E) * kRows * 32 + k * 32 +
        (((w / U) ^ ((k >> 2) & 1)) << 4) + (w % U) * 4);
  };
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < kRows; ks += 8) {
    const uint32_t a0 = __float_as_uint(at(sst, r0, ks + t));
    const uint32_t a1 = __float_as_uint(at(sst, r1, ks + t));
    const uint32_t a2 = __float_as_uint(at(sst, r0, ks + t + 4));
    const uint32_t a3 = __float_as_uint(at(sst, r1, ks + t + 4));
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
      mma_tf32(acc + 4 * j, a0, a1, a2, a3,
               __float_as_uint(at(sg, ks + t, 8 * j + g)),
               __float_as_uint(at(sg, ks + t + 4, 8 * j + g)));
  }
}

// dW on mma.sync of NW columns from col0 of g chunk gc (sg_p at its
// first), added to the partials.
template <int NW>
__device__ void dw_step_cols(const BwdParams<float>& p,
                             const unsigned char* sst_p,
                             const unsigned char* sg_p, float* sdw, int i,
                             int kb, int gc, int col0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= p.L.nwr) return;
  float acc[NW / 2];
  dw_mma_sync<NW>(acc, sst_p, sg_p, warp, lane);
  dw_add<NW>(acc, sdw, i, gc, col0, p.L);
}

// K-block kb's dW for g chunk gc (nw = NW wide) and its addition to the
// partials: bf16 on wgmma with B (the g tile) MN-major, f32 on mma.sync.
template <typename T, int NW>
__device__ void dw_step(const BwdParams<T>& p, uint32_t sst, uint32_t sg,
                        const unsigned char* sst_p, const unsigned char* sg_p,
                        float* sdw, int i, int kb, int gc) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  if constexpr (kF32) {
    // mma.sync, past 128 outputs a column half at a time (its
    // accumulators' registers), from the one staged g tile
    constexpr int NC = NW < 128 ? NW : 128;
#pragma unroll 1
    for (int h = 0; h < NW / NC; ++h)
      dw_step_cols<NC>(p, sst_p, sg_p + h * NC / 8 * kRows * 32, sdw, i, kb,
                       gc, NC * h);
  } else {
    float acc[NW / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks)
      WgmmaSSTB<T, NW>::run(acc, desc_sw32(sst + ks * kRows * 32),
                            desc_mn32(sg + ks * 16 * 32, kRows * 32),
                            ks > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) fence_operand(acc[e]);
    dw_add<NW>(acc, sdw, i, gc, 0, p.L);
  }
}

// The narrowest g chunk's wgmma N: 16 in bf16 (chunks of 16 outputs), 8
// in f32.
template <typename T>
constexpr int kMinNw = std::is_same<T, float>::value ? 8 : 16;

// dw_step at the run-time width nw <= NWM (the kernel's widest).
template <typename T, int NWM>
__device__ __forceinline__ void dw_step_any(const BwdParams<T>& p, int nw,
                                            uint32_t sst, uint32_t sg,
                                            const unsigned char* sst_p,
                                            const unsigned char* sg_p,
                                            float* sdw, int i, int kb,
                                            int gc) {
  if (nw == NWM || NWM == kMinNw<T>)
    return dw_step<T, NWM>(p, sst, sg, sst_p, sg_p, sdw, i, kb, gc);
  if constexpr (NWM > kMinNw<T>)
    dw_step_any<T, NWM / 2>(p, nw, sst, sg, sst_p, sg_p, sdw, i, kb, gc);
}

template <typename T>
__device__ __forceinline__ void sample_bwd_any(const BwdParams<T>& p,
                                               int tile, int kb,
                                               const T* sds,
                                               unsigned char* sst,
                                               float (&Ep)[4]) {
  constexpr int kV = 16 / (int)sizeof(T);  // the widest chunk of T
  switch (p.q.ch) {
    case kV:
      return sample_bwd<T, kV>(p, tile, kb, sds, sst, Ep);
    case kV / 2:
      return sample_bwd<T, kV / 2>(p, tile, kb, sds, sst, Ep);
    case kV / 4:
      return sample_bwd<T, kV / 4>(p, tile, kb, sds, sst, Ep);
    default:
      return sample_bwd<T, 1>(p, tile, kb, sds, sst, Ep);
  }
}

// NWM: the widest g chunk's wgmma N (bwd_layout's nw0).
template <typename T, int NWM>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_kernel(const __grid_constant__ BwdParams<T> p) {
  using Tr = Traits<T>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (base & 255) __trap();  // the 32-byte swizzle needs 256-byte rows
  const Plan& q = p.q;
  const BwdLayout& L = p.L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t bars = base + L.bar_off;  // slot 0, slot 1, resident
  unsigned char* sg = smem + L.g_off;
  T* sds = reinterpret_cast<T*>(smem + L.ds_off);
  unsigned char* sst = smem + L.st_off;
  // the block's dW partials: shared memory, or its slot of the scratch
  float* sdw = L.dws ? reinterpret_cast<float*>(smem + L.dw_off)
                     : p.part + (size_t)blockIdx.x * (L.part / 4);
  const int per_kb = L.cow / 2 * L.nwr * 32;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (L.dws)
    for (int i = tid; i < L.sps * per_kb; i += kThreads) sdw[i] = 0.f;
  __syncthreads();
  const int i0 = (int)((long long)blockIdx.x * p.nitems / gridDim.x);
  const int i1 = (int)((long long)(blockIdx.x + 1) * p.nitems / gridDim.x);
  if (i0 >= i1) return;
  const int slot = L.nw0 / q.E * kRows * 32;
  // (K-block, chunk) slices of the weight in the order the block takes them
  auto slice_bytes = [&](int gc) {
    return (gc == L.ngc - 1 ? L.nwl : L.nw0) / q.E * kRows * 32;
  };
  auto slice_src = [&](int kb, int gc) {
    return p.wt + ((size_t)kb * L.cow + gc * L.nw0) / q.E * kRows * 32;
  };
  // the next slice to copy (streamed): item, K-block, chunk
  int n_item = i0, n_f = i0 / p.ntiles * L.sps, n_gc = 0, n_w = 0;
  auto issue_next = [&]() {
    if (n_item >= i1) return;
    const uint32_t bar = bars + 8 * (n_w % L.nslot);
    mbar_expect_tx(bar, slice_bytes(n_gc));
    bulk_load(base + L.w_off + (n_w % L.nslot) * slot,
              slice_src(n_f, n_gc), slice_bytes(n_gc), bar);
    ++n_w;
    if (++n_gc < L.ngc) return;
    n_gc = 0;
    const int s = n_item / p.ntiles;
    if (++n_f < imin(s * L.sps + L.sps, L.nkb)) return;
    if (++n_item < i1) n_f = n_item / p.ntiles * L.sps;
  };
  if (tid == 0) {
    if (L.resident) {
      mbar_expect_tx(bars + 16, L.wtotal);
      bulk_load(base + L.w_off, p.wt, L.wtotal, bars + 16);
    } else if (L.nslot == 2) {
      issue_next();
    }
  }
  if (L.resident) mbar_wait(bars + 16, 0);
  int w = 0;  // slices taken
  // the weight slice (f, gc): resident, or the next streamed one
  auto take = [&](int kb, int gc) -> uint32_t {
    if (L.resident)
      return base + L.w_off +
             ((size_t)kb * L.cow + gc * L.nw0) / q.E * kRows * 32;
    if (tid == 0) issue_next();  // two slots: the one after; one: this
    const int s = w % L.nslot;
    mbar_wait(bars + 8 * s, (w / L.nslot) & 1);
    ++w;
    return base + L.w_off + s * slot;
  };
  float Ep[4] = {0.f, 0.f, 0.f, 0.f};
  const int lds = kStepCh + 4 / (int)sizeof(T);
  for (int item = i0; item < i1; ++item) {
    const int s = item / p.ntiles, tile = item - s * p.ntiles;
    const int fs = s * L.sps, fe = imin(fs + L.sps, L.nkb);
    if (L.ngc == 1) {
      __syncthreads();  // the last item's reads of the g tile done
      stage_g<T>(p, tile, 0, sg);
      fence_proxy_async();
      __syncthreads();
    }
    for (int kb = fs; kb < fe; ++kb) {
      // 1. dS = g W^T on wgmma m64n64 (the K-block's 64 channel rows)
      float ds[32];
      for (int gc = 0; gc < L.ngc; ++gc) {
        if (L.ngc > 1) {
          __syncthreads();
          stage_g<T>(p, tile, gc, sg);
          fence_proxy_async();
          __syncthreads();
        }
        const uint32_t b = take(kb, gc);
        const int nk = (gc == L.ngc - 1 ? L.nwl : L.nw0) / q.E;
        wgmma_fence();
#pragma unroll 1
        for (int kc = 0; kc < nk; ++kc)
          WgmmaSS<T, 64>::run(ds, desc_sw32(base + L.g_off + kc * kRows * 32),
                              desc_sw32(b + kc * kRows * 32),
                              (gc > 0 || kc > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(ds[i]);
      }
      // rounded to T, as autograd of the plain op rounds it through the
      // cast of the columns
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        int row, col;
        dw_at(e, warp, lane, row, col);
        sds[row * lds + col] = Tr::from_f(ds[e]);
        sds[row * lds + col + 1] = Tr::from_f(ds[e + 1]);
      }
      __syncthreads();
      // 2. the sampling: dx, doffset, dmask, S^T
      sample_bwd_any<T>(p, tile, kb, sds, sst, Ep);
      fence_proxy_async();
      __syncthreads();
      // 3. dW^T += S^T g
      for (int gc = 0; gc < L.ngc; ++gc) {
        if (L.ngc > 1) {
          __syncthreads();
          stage_g<T>(p, tile, gc, sg);
          fence_proxy_async();
          __syncthreads();
        }
        dw_step_any<T, NWM>(p, gc == L.ngc - 1 ? L.nwl : L.nw0,
                       base + L.st_off, base + L.g_off, sst, sg, sdw, kb - fs,
                       kb, gc);
      }
    }
    if (item + 1 == i1 || (item + 1) / p.ntiles != s)
      dw_flush(sdw, s, q, L, p.dw);
  }
}

// ------------------------------------------------------------------- host

// The tiles of `rows` pixels over (B, H, W).
inline Tiles tiles_of(int B, int H, int W, int rows) {
  Tiles t;
  t.tw_log = 0;
  while ((1 << t.tw_log) < std::min(W, 16)) ++t.tw_log;
  t.th = rows >> t.tw_log;
  t.tiles_x = (W + (1 << t.tw_log) - 1) >> t.tw_log;
  t.tiles_y = (H + t.th - 1) / t.th;
  return t;
}

inline bool width_ok(int Ci, int Co, int G) {
  return Ci >= 1 && Co >= 1 && G >= 1 && Ci % G == 0;
}

// Blocks of the persistent walk: as many as the SMs hold at once.
template <typename K>
int grid_of(K kernel, int threads, int smem, int items) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const int cap = std::max(per_sm, 1) * sm_count();
  return items < cap ? items : cap;
}

template <typename T, int N>
int fwd_launch(const FwdParams<T>& p, void* stream) {
  static int attribute = 0;  // the largest shared memory allowed so far
  if (p.L.smem > attribute) {
    cudaFuncSetAttribute(fwd_kernel<T, N>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         p.L.smem);
    attribute = p.L.smem;
  }
  const int threads = 128 * p.L.nwg;
  const int grid = grid_of(fwd_kernel<T, N>, threads, p.L.smem, p.nitems);
  if (grid > 0)
    fwd_kernel<T, N><<<grid, threads, p.L.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_entry(const void* x, const void* off, int off_stride,
              const void* msk, int msk_stride, int logits,
              const void* weight, void* packed, long long packed_bytes,
              const void* bias, void* out, int B, int H, int W, int Ci,
              int Co, int G, int act, float max_off, int clamp,
              void* stream) {
  if (!width_ok(Ci, Co, G)) return kErrWidth;
  FwdParams<T> p;
  p.q = make_plan(Ci, Co, G, sizeof(T));
  p.L = fwd_layout(p.q);
  const long long total = (long long)p.L.nb * 9 * p.q.kt * p.L.N;
  if (p.L.smem > kSmemMax || packed_bytes < total * (long long)sizeof(T))
    return kErrWidth;
  const int blocks = (int)std::min<long long>((total + 255) / 256, 1024);
  pack_fwd<T><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const T*)weight, (T*)packed, p.q, p.L.N, total);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  p.x = (const T*)x;
  p.om = OffMask<T>{(const T*)off, (const T*)msk, off_stride, msk_stride,
                    logits};
  p.w = (const unsigned char*)packed;
  p.bias = (const T*)bias;
  p.out = (T*)out;
  p.H = H, p.W = W, p.act = act, p.clamp = clamp;
  p.max_off = max_off;
  p.t = tiles_of(B, H, W, p.L.rows);
  p.ntiles = B * p.t.tiles_y * p.t.tiles_x;
  p.nitems = p.L.nb * p.ntiles;
  switch (p.L.N) {
    case 8:
      return fwd_launch<T, 8>(p, stream);
    case 16:
      return fwd_launch<T, 16>(p, stream);
    case 32:
      return fwd_launch<T, 32>(p, stream);
    case 64:
      return fwd_launch<T, 64>(p, stream);
    case 128:
      return fwd_launch<T, 128>(p, stream);
    default:
      return fwd_launch<T, 256>(p, stream);
  }
}

template <typename T, int NWM>
int bwd_launch(const BwdParams<T>& p, long long part_bytes, void* stream) {
  static int attribute = 0;  // the largest shared memory allowed so far
  if (p.L.smem > attribute) {
    cudaFuncSetAttribute(bwd_kernel<T, NWM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         p.L.smem);
    attribute = p.L.smem;
  }
  int grid = grid_of(bwd_kernel<T, NWM>, kThreads, p.L.smem, p.nitems);
  if (!p.L.dws && grid > part_bytes / p.L.part)  // a scratch slot a block
    grid = (int)(part_bytes / p.L.part);
  if (grid > 0)
    bwd_kernel<T, NWM>
        <<<grid, kThreads, p.L.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_entry(const void* x, const void* off, int off_stride,
              const void* msk, int msk_stride, int logits,
              const void* weight, void* packed, long long packed_bytes,
              void* part, long long part_bytes, const void* gout, void* dx,
              void* doff, int doff_stride, void* dmsk, int dmsk_stride,
              void* dw, int B, int H, int W, int Ci, int Co, int G,
              float max_off, int clamp, void* stream) {
  if (!width_ok(Ci, Co, G)) return kErrWidth;
  BwdParams<T> p;
  p.q = make_plan(Ci, Co, G, sizeof(T));
  p.L = bwd_layout(p.q, sizeof(T));
  if (p.L.smem > kSmemMax || packed_bytes < p.L.wtotal) return kErrWidth;
  if (!p.L.dws && (part == nullptr || part_bytes < p.L.part))
    return kErrWidth;
  const long long total = p.L.wtotal / (long long)sizeof(T);
  const int blocks = (int)std::min<long long>((total + 255) / 256, 1024);
  pack_bwd<T><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const T*)weight, (T*)packed, p.q, p.L, total);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  p.x = (const T*)x;
  p.om = OffMask<T>{(const T*)off, (const T*)msk, off_stride, msk_stride,
                    logits};
  p.wt = (const unsigned char*)packed;
  p.gout = (const T*)gout;
  p.dx = (float*)dx;
  p.doff = (T*)doff;
  p.dmsk = (T*)dmsk;
  p.doff_stride = doff_stride, p.dmsk_stride = dmsk_stride;
  p.dw = (float*)dw;
  p.part = (float*)part;
  p.H = H, p.W = W, p.clamp = clamp, p.max_off = max_off;
  p.t = tiles_of(B, H, W, kRows);
  p.ntiles = B * p.t.tiles_y * p.t.tiles_x;
  p.nitems = p.L.nslices * p.ntiles;
  switch (p.L.nw0) {
    case 8:  // f32 only: bf16's chunks are 16 outputs at least
      if constexpr (kMinNw<T> == 8) return bwd_launch<T, 8>(p, part_bytes, stream);
      return kErrWidth;
    case 16:
      return bwd_launch<T, 16>(p, part_bytes, stream);
    case 32:
      return bwd_launch<T, 32>(p, part_bytes, stream);
    case 64:
      return bwd_launch<T, 64>(p, part_bytes, stream);
    case 128:
      return bwd_launch<T, 128>(p, part_bytes, stream);
    default:
      return bwd_launch<T, 256>(p, part_bytes, stream);
  }
}

}  // namespace narrow
}  // namespace rvsr

// Forward.  x (B,H,W,Ci) in G deformable groups (G | Ci); offsets of pixel
// p at off + p * off_stride, laid out (group, tap, (dy, dx)); the mask at
// msk + p * msk_stride, (group, tap), through the sigmoid already
// (logits == 0) or logits (logits != 0), or msk null for none (DCNv1);
// weight (Co, Ci, 3, 3) OIHW, packed into `packed` (packed_bytes of
// scratch, ops/kernels/dcn.py::narrow_fwd_layout's) first; bias (Co) or
// null; out (B,H,W,Co).  act: 0 none, 1 relu, 2 lrelu(0.1).  clamp != 0
// clips every offset to [-max_off, max_off].  Returns cudaGetLastError(),
// or 9102 (widths outside those, beyond shared memory, or too little
// scratch).
extern "C" int dcn_narrow_fwd_bf16(const void* x, const void* off,
                                   int off_stride, const void* msk,
                                   int msk_stride, int logits,
                                   const void* weight, void* packed,
                                   long long packed_bytes, const void* bias,
                                   void* out, int B, int H, int W, int Ci,
                                   int Co, int G, int act, float max_off,
                                   int clamp, void* stream) {
  return rvsr::narrow::fwd_entry<__nv_bfloat16>(
      x, off, off_stride, msk, msk_stride, logits, weight, packed,
      packed_bytes, bias, out, B, H, W, Ci, Co, G, act, max_off, clamp,
      stream);
}

extern "C" int dcn_narrow_fwd_f32(const void* x, const void* off,
                                  int off_stride, const void* msk,
                                  int msk_stride, int logits,
                                  const void* weight, void* packed,
                                  long long packed_bytes, const void* bias,
                                  void* out, int B, int H, int W, int Ci,
                                  int Co, int G, int act, float max_off,
                                  int clamp, void* stream) {
  return rvsr::narrow::fwd_entry<float>(
      x, off, off_stride, msk, msk_stride, logits, weight, packed,
      packed_bytes, bias, out, B, H, W, Ci, Co, G, act, max_off, clamp,
      stream);
}

// Backward.  Inputs as the forward's (the weight packed into `packed` of
// packed_bytes, narrow_bwd_layout's), plus gout (B,H,W,Co), the cotangent
// of the output before bias and activation, and `part` (part_bytes of
// zeroed f32 scratch, a slot of narrow_bwd_layout's part bytes a block;
// null where its partials sit in shared memory: the grid takes at most as
// many blocks as it has slots, and leaves it zeroed).  Outputs: dx (B,H,W,Ci) f32 and
// dw (Co, 9, Ci) = (cout, tap, cin) f32, both summed with atomics and so
// zeroed by the caller; the offset gradient at doff + p * doff_stride and
// the mask gradient (the logits' where logits != 0) at dmsk + p *
// dmsk_stride, in the input type (dmsk null with no mask).  Returns
// cudaGetLastError(), or 9102.
extern "C" int dcn_narrow_bwd_bf16(const void* x, const void* off,
                                   int off_stride, const void* msk,
                                   int msk_stride, int logits,
                                   const void* weight, void* packed,
                                   long long packed_bytes, void* part,
                                   long long part_bytes, const void* gout,
                                   void* dx, void* doff, int doff_stride,
                                   void* dmsk, int dmsk_stride, void* dw,
                                   int B, int H, int W, int Ci, int Co, int G,
                                   float max_off, int clamp, void* stream) {
  return rvsr::narrow::bwd_entry<__nv_bfloat16>(
      x, off, off_stride, msk, msk_stride, logits, weight, packed,
      packed_bytes, part, part_bytes, gout, dx, doff, doff_stride, dmsk,
      dmsk_stride, dw, B, H, W, Ci, Co, G, max_off, clamp, stream);
}

extern "C" int dcn_narrow_bwd_f32(const void* x, const void* off,
                                  int off_stride, const void* msk,
                                  int msk_stride, int logits,
                                  const void* weight, void* packed,
                                  long long packed_bytes, void* part,
                                  long long part_bytes, const void* gout,
                                  void* dx, void* doff, int doff_stride,
                                  void* dmsk, int dmsk_stride, void* dw,
                                  int B, int H, int W, int Ci, int Co, int G,
                                  float max_off, int clamp, void* stream) {
  return rvsr::narrow::bwd_entry<float>(
      x, off, off_stride, msk, msk_stride, logits, weight, packed,
      packed_bytes, part, part_bytes, gout, dx, doff, doff_stride, dmsk,
      dmsk_stride, dw, B, H, W, Ci, Co, G, max_off, clamp, stream);
}
