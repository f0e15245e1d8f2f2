// Hopper pieces shared by the hand-written kernels (conv3x3.cu, dcn_fwd.cu,
// dcn_bwd.cu): the wgmma fences and waits, the descriptor of a K-major
// operand with the 128-byte swizzle, ldmatrix, and the packer that lays an
// OIHW weight out as the image of shared memory the wgmma kernels copy.
#pragma once

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

// wgmma descriptor of a K-major operand with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The shared-memory image of an OIHW weight (cout, cin, 3, 3) that the
// wgmma kernels copy: [cin / ch][tap][n][ch], the 16-byte units of each
// 128-byte row swizzled (unit j of row o at j ^ (o & 7)), zero rows from
// cout to n, each value rounded as the tensor cores take it (TF32 for f32).
// ops/kernels/conv3x3.py::pack_weight is its plain version.
template <typename T>
__global__ void pack_weight_kernel(const T* __restrict__ w,
                                   T* __restrict__ packed, int cout, int cin,
                                   int n, long long total) {
  constexpr int ch = kLine / sizeof(T), u = ch / 8;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int kl = (int)(e % ch);
    long long r = e / ch;
    const int o = (int)(r % n);
    r /= n;
    const int tap = (int)(r % 9), c = (int)(r / 9);
    const int i = c * ch + ((kl / u) ^ (o & 7)) * u + kl % u;
    float v = 0.f;
    if (o < cout) v = Traits<T>::to_f(w[((long long)o * cin + i) * 9 + tap]);
    packed[e] = Traits<T>::to_mma(v);
  }
}

template <typename T>
int pack_weight(const void* weight, void* packed, int cout, int cin, int n,
                void* stream) {
  const long long total = (long long)cin * 9 * n;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256
                                                      : 1024);
  pack_weight_kernel<T><<<blocks, 256, 0, (cudaStream_t)stream>>>(
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

}  // namespace rvsr
