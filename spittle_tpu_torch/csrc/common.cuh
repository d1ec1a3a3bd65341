// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every entry point has a plain C interface (loaded with ctypes by
// spittle_tpu_torch/ops/_build.py): device pointers and the CUDA stream
// arrive as void*, and each entry returns cudaGetLastError() right after
// its launches so that a refused launch surfaces in the Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SPT_API extern "C" __attribute__((visibility("default")))

namespace spt {

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats -> one register of two bf16 (lo in the low half), rounded
// to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 from memory -> one register (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo,
                                                  __nv_bfloat16 hi) {
  uint16_t a = *reinterpret_cast<uint16_t*>(&lo);
  uint16_t b = *reinterpret_cast<uint16_t*>(&hi);
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
// Fragment layout (g = lane / 4, c = lane % 4):
//   a0: (g, 2c..2c+1)  a1: (g+8, 2c..)  a2: (g, 2c+8..)  a3: (g+8, 2c+8..)
//   b0: (k=2c..2c+1, n=g)  b1: (k=2c+8.., n=g)
//   d0,d1: (g, 2c..2c+1)   d2,d3: (g+8, 2c..2c+1)
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D = A(16x32, row) * B(32x8, col) + D, int8 inputs, exact int32 sums.
//   a0: (g, 4c..4c+3)  a1: (g+8, 4c..)  a2: (g, 4c+16..)  a3: (g+8, 4c+16..)
//   b0: (k=4c..4c+3, n=g)  b1: (k=4c+16.., n=g)
//   d0,d1: (g, 2c..2c+1)   d2,d3: (g+8, 2c..2c+1)
__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a,
                                             const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace spt
