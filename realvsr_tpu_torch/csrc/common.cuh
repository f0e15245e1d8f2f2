// Shared pieces of the hand-written Hopper kernels: element traits, the
// fused activations, 16-byte vector load/store, and the warp-level tensor-core
// product of one 16-row tile against a shared-memory weight tile of 8 to 64
// columns.
//
// Two element types are taken: bf16 (mma.sync m16n8k16, f32 accumulate) and
// f32 (mma.sync m16n8k8 on TF32 operands, f32 accumulate; operands are
// rounded to TF32 with cvt.rna when they are staged in shared memory).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rvsr {

enum Act { kActNone = 0, kActRelu = 1, kActLrelu = 2 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kActRelu) return fmaxf(v, 0.f);
  if (act == kActLrelu) return v >= 0.f ? v : 0.1f * v;
  return v;
}

template <typename T>
struct Traits;

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kStep = 16;  // K depth of one mma
  static constexpr int kVec = 8;    // elements in 16 bytes
  static constexpr int kPad = 8;    // shared-memory row padding (elements)
  __device__ static __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ static __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
  // value as staged for the tensor cores
  __device__ static __forceinline__ __nv_bfloat16 to_mma(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <>
struct Traits<float> {
  static constexpr int kStep = 8;
  static constexpr int kVec = 4;
  static constexpr int kPad = 4;
  __device__ static __forceinline__ float to_f(float v) { return v; }
  __device__ static __forceinline__ float from_f(float v) { return v; }
  __device__ static __forceinline__ float to_mma(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return __uint_as_float(r);
  }
};

// 16-byte load of kVec elements, widened to f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < Traits<T>::kVec; ++j) out[j] = Traits<T>::to_f(e[j]);
}

// 16-byte store of kVec f32 values, each rounded as the tensor cores take it.
template <typename T>
__device__ __forceinline__ void store_vec_mma(T* dst, const float* v) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < Traits<T>::kVec; ++j) e[j] = Traits<T>::to_mma(v[j]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[nt] += A(16 x klen) * B(klen x 8) for the NT column tiles nt of an
// (8 * NT)-column output (64 columns by default).  a_lo / a_hi point at the
// K-contiguous shared-memory rows of this lane's fragment rows (group and
// group + 8); b is [8 * NT][ldb], K-contiguous.  Fragment layouts are those
// of the PTX ISA for mma.m16n8k16 (bf16) and mma.m16n8k8 (tf32), row.col.
template <typename T, int NT = 8>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const T* a_lo,
                                         const T* a_hi, const T* b, int ldb,
                                         int klen, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    for (int k = 0; k < klen; k += 8) {
      const uint32_t a0 = __float_as_uint(a_lo[k + t]);
      const uint32_t a1 = __float_as_uint(a_hi[k + t]);
      const uint32_t a2 = __float_as_uint(a_lo[k + t + 4]);
      const uint32_t a3 = __float_as_uint(a_hi[k + t + 4]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* br = b + (nt * 8 + g) * ldb + k;
        mma_tf32(acc[nt], a0, a1, a2, a3, __float_as_uint(br[t]),
                 __float_as_uint(br[t + 4]));
      }
    }
  } else {
    for (int k = 0; k < klen; k += 16) {
      const uint32_t a0 = ld32(a_lo + k + 2 * t);
      const uint32_t a1 = ld32(a_hi + k + 2 * t);
      const uint32_t a2 = ld32(a_lo + k + 8 + 2 * t);
      const uint32_t a3 = ld32(a_hi + k + 8 + 2 * t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* br = b + (nt * 8 + g) * ldb + k;
        mma_bf16(acc[nt], a0, a1, a2, a3, ld32(br + 2 * t),
                 ld32(br + 8 + 2 * t));
      }
    }
  }
}

// Stage the (ROWS x C) weight slice of one tap into shared memory
// [ROWS][ld].  weight is (ROWS or more, 9, C), K-contiguous.
template <typename T, int ROWS>
__device__ __forceinline__ void stage_weight_tap(T* sB, const T* weight,
                                                 int tap, int C, int ld) {
  constexpr int V = Traits<T>::kVec;
  const int nv = C / V;
  for (int it = threadIdx.x; it < ROWS * nv; it += blockDim.x) {
    const int n = it / nv, kv = it - n * nv;
    float v[V];
    load_vec<T>(weight + ((size_t)n * 9 + tap) * C + kv * V, v);
    store_vec_mma<T>(sB + n * ld + kv * V, v);
  }
}

}  // namespace rvsr
