// Hopper pieces shared by the hand-written kernels (conv3x3.cu, dcn_fwd.cu,
// dcn_bwd.cu): the wgmma fences and waits, the descriptors of a K-major
// operand with the 128- and 32-byte swizzles, ldmatrix, mbarriers with a
// watchdog, TMA loads and stores and bulk copies, the cluster pieces (rank,
// barrier, remote arrives, multicast bulk copies), the tensor map of an
// NHWC tile, and the packer that lays an OIHW weight out as the image of
// shared memory the wgmma kernels copy.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace rvsr {

constexpr int kLine = 128;  // bytes: one channel chunk, a row of the swizzle

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each 8 x 8 matrix transposed: an A fragment from a
// column-major tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving reads of an accumulator across a wait.
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's descriptor reads) after the next barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A wait this long (cycles: seconds at the H100's clocks) is a fault: the
// kernel traps, which the next CUDA call reports, rather than hang the card.
constexpr long long kWatchdog = 1LL << 33;

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

// Waits for the phase of the given parity to complete; traps after
// kWatchdog cycles.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_ready(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_ready(bar, parity))
    if (clock64() - t0 > kWatchdog) __trap();
}

// mbar_wait with mbarrier.try_wait, which suspends the thread for a while
// before it returns false: the waiting warps then leave the issue slots to
// the working ones (dcn_bwd_kernel128: 8.31 against 8.44 ms bf16, 16.19
// against 16.42 f32, with mbar_wait's spin at EDVR-L's L1 training shape;
// the wgmma conv's consumers, with no other warps to yield to, run 1-2%
// faster spinning; chip run, the H100 at 700 W).
__device__ __forceinline__ void mbar_sleep_wait(uint32_t bar,
                                                uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (clock64() - t0 > kWatchdog) __trap();
  }
}

// bar.sync on named barrier `id` (1-15; 0 is __syncthreads) among `count`
// threads, whole warps.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
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

// ---------------------------------------------------------------- clusters

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of the cluster's blocks that has not exited meets here;
// what each wrote before (mbarrier inits too) is seen by all after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n\t"
      "barrier.cluster.wait.acquire;" ::
          : "memory");
}

// mbarrier.arrive on the barrier at `bar`'s offset in the shared memory of
// the cluster's block `rank` (the default release at CTA scope: a
// cluster-scope release would wait for the thread's global stores).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// bulk_load into the shared memory of every block of the cluster in `mask`,
// at `dst`'s offset in each, each completing the bytes on its barrier at
// `bar`'s offset.
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// TMA store of the box at `src` (shared memory) to the tensor map's
// coordinates, in this thread's bulk async-group; what lies outside the
// tensor is not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most kPending of this thread's bulk groups have yet to
// read their shared memory (.read) or to complete.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending)
               : "memory");
}
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(kPending) : "memory");
}

// wgmma descriptor of a K-major operand with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same with the 32-byte swizzle (layout type 3): rows of 32 bytes (one
// k-step), 8-row groups 256 bytes apart.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

// The 16-byte unit a swizzle of CB-byte rows (128 or 32) XORs into unit j
// of row r: r & 7 for 128 bytes, (r >> 2) & 1 for 32 (the address's bits
// 7-9 or 7 into bits 4-6 or 4, for rows from a 1024- / 256-byte boundary).
template <int CB>
__host__ __device__ __forceinline__ int swizzle_of(int r) {
  static_assert(CB == 128 || CB == 32, "128- or 32-byte rows");
  return CB == 128 ? (r & 7) : ((r >> 2) & 1);
}

// The shared-memory image of an OIHW weight (cout, cin, 3, 3) that the
// wgmma kernels copy: [cout / n][cin / ch][tap][n][ch] (a column block of n
// output rows at a time, one block where cout <= n; ch the channels of a
// CB-byte chunk), the 16-byte units of each CB-byte row swizzled (unit j of
// row o at j ^ swizzle_of<CB>(o)), zero rows from cout up to whole blocks,
// each value rounded as the tensor cores take it (TF32 for f32).
// ops/kernels/conv3x3.py::pack_weight is its plain version.
template <typename T, int CB>
__global__ void pack_weight_kernel(const T* __restrict__ w,
                                   T* __restrict__ packed, int cout, int cin,
                                   int n, long long total) {
  constexpr int ch = CB / sizeof(T), u = 16 / sizeof(T);
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int kl = (int)(e % ch);
    long long r = e / ch;
    const int o = (int)(r % n);
    r /= n;
    const int tap = (int)(r % 9);
    r /= 9;
    const int c = (int)(r % (cin / ch)), row = (int)(r / (cin / ch)) * n + o;
    const int i = c * ch + ((kl / u) ^ swizzle_of<CB>(o)) * u + kl % u;
    float v = 0.f;
    if (row < cout)
      v = Traits<T>::to_f(w[((long long)row * cin + i) * 9 + tap]);
    packed[e] = Traits<T>::to_mma(v);
  }
}

template <typename T, int CB = kLine>
int pack_weight(const void* weight, void* packed, int cout, int cin, int n,
                void* stream) {
  const long long total = (long long)((cout + n - 1) / n) * cin * 9 * n;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256
                                                      : 1024);
  pack_weight_kernel<T, CB><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const T*)weight, (T*)packed, cout, cin, n, total);
  return (int)cudaGetLastError();
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
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

// Error codes of encode_nhwc, beside cudaGetLastError()'s.
constexpr int kErrNoEncode = 9001, kErrEncode = 9002;

// Tensor map of an NHWC tensor (B, H, W, C) with a box of one CB-byte
// channel chunk (128 or 32) by box_h x box_w pixels, the CB-byte swizzle,
// zeros outside.
template <typename T, int CB = kLine>
int encode_nhwc(CUtensorMap* map, const void* x, int B, int H, int W, int C,
                int box_w, int box_h) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {C * es, (cuuint64_t)W * C * es,
                                 (cuuint64_t)H * W * C * es};
  const cuuint32_t box[4] = {(cuuint32_t)(CB / es), (cuuint32_t)box_w,
                             (cuuint32_t)box_h, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map,
         std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         4, const_cast<void*>(x), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE,
         CB == kLine ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

}  // namespace rvsr
