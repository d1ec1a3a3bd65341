// W8A8 GEMM for Hopper (sm_90a): y = act((quant(x) @ qw) * sx * sw + b).
//
// Replaces the TPU kernel spittle_tpu/ops/w8a8_gemm.py:w8a8_gemm
// (body _w8a8_kernel), which computes the same numbers as the reference's
// XLA path spittle_tpu/ops/quant.py:_mm_w8a8 with mm_bias's epilogue.
//
// What bounds it on an H100: at the encoder's shapes (M = B*1500 rows,
// (K, N) in {(1280,1280), (1280,5120), (5120,1280)}) the int8 products
// dominate: 2*M*K*N operations against ~M*(K + 2N) + K*N bytes, far above
// the card's ~590 ops/byte int8 ridge, so the bound is the tensor cores'
// 1,979 TOP/s int8 rate.
//
// Design: two launches, both here.
//  1. spt_w8a8_quantize_rows: one block per row takes the row amax, sets
//     sx = amax/127 (1 where amax is 0) and writes qx = clip(rint(x/sx),
//     +-127) as int8 with a true IEEE division and round-half-even, the
//     reference's exact rule (quant.py:88-91). No fast-math anywhere.
//  2. spt_w8a8_gemm: a 128x128 output tile per block, 8 warps of 64x32,
//     int8 mma.sync m16n8k32 with exact int32 accumulators, K staged in
//     64-byte slices through a double-buffered cp.async ring in shared
//     memory; the epilogue applies (acc * sx) * sw', adds b', applies the
//     exact erf GELU and stores the activation dtype. out_scale is folded
//     into sw' and b' by the wrapper, as the TPU kernel does.
//  The TPU kernel holds whole [bm, K] rows in VMEM and fuses the row
//  amax into its prologue. A Hopper block cannot hold fc2's 64 x 5120
//  rows next to its weight tiles, hence the separate quantize pass: it
//  costs one extra write and read of the int8 activations (M*K bytes each
//  way, ~61 MB per fc2 call at B=8), which a fused prologue (a row-amax
//  pre-pass over the bf16 tile, or quantization in the producing op's
//  epilogue) would save. wgmma, TMA and warp specialisation are later work.
#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kLds = kBK + 16;  // 80-byte smem rows: 16-B aligned, no bank conflicts
constexpr int kThreads = 256;
constexpr int kQuantThreads = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ qx,
                         float* __restrict__ sx, int K) {
  __shared__ float red[kQuantThreads / 32];
  const int row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * K;
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += kQuantThreads)
    amax = fmaxf(amax, fabsf(to_f32<T>(xr[i])));
  amax = spt::warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = amax > 0.f ? amax / 127.0f : 1.0f;
  if (threadIdx.x == 0) sx[row] = s;
  int8_t* qr = qx + static_cast<size_t>(row) * K;
  for (int i = threadIdx.x; i < K; i += kQuantThreads) {
    float q = rintf(to_f32<T>(xr[i]) / s);
    q = fminf(fmaxf(q, -127.f), 127.f);
    qr[i] = static_cast<int8_t>(q);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    w8a8_gemm_kernel(const int8_t* __restrict__ qx,   // [M, K]
                     const int8_t* __restrict__ qwt,  // [N, K] (qw, N-major)
                     const float* __restrict__ sx,    // [M]
                     const float* __restrict__ sw,    // [N], out_scale folded
                     const float* __restrict__ bias,  // [N] or null
                     T* __restrict__ out,             // [M, N]
                     int M, int N, int K, int gelu) {
  __shared__ __align__(16) int8_t As[2][kBM * kLds];
  __shared__ __align__(16) int8_t Bs[2][kBN * kLds];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // Rows past M or N are clamped to the last row: their products land in
  // outputs the epilogue never stores.
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int ch = tid; ch < kBM * kBK / 16; ch += kThreads) {
      const int r = ch >> 2, cc = (ch & 3) * 16;
      const int gm = min(m0 + r, M - 1);
      const int gn = min(n0 + r, N - 1);
      spt::cp_async_16(&As[stage][r * kLds + cc],
                       qx + static_cast<size_t>(gm) * K + k0 + cc);
      spt::cp_async_16(&Bs[stage][r * kLds + cc],
                       qwt + static_cast<size_t>(gn) * K + k0 + cc);
    }
    spt::cp_async_commit();
  };

  const int ktiles = K / kBK;
  load_stage(0, 0);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ktiles) {
      load_stage(st ^ 1, (kt + 1) * kBK);
      spt::cp_async_wait<1>();
    } else {
      spt::cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* A = As[st];
    const int8_t* B = Bs[st];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        af[mi][0] = spt::ld_u32(&A[r * kLds + kk + 4 * c]);
        af[mi][1] = spt::ld_u32(&A[(r + 8) * kLds + kk + 4 * c]);
        af[mi][2] = spt::ld_u32(&A[r * kLds + kk + 16 + 4 * c]);
        af[mi][3] = spt::ld_u32(&A[(r + 8) * kLds + kk + 16 + 4 * c]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        bf[ni][0] = spt::ld_u32(&B[n * kLds + kk + 4 * c]);
        bf[ni][1] = spt::ld_u32(&B[n * kLds + kk + 16 + 4 * c]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          spt::mma_s8_16832(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= M) continue;
      const float s_x = sx[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 32 + ni * 8 + 2 * c + j;
          if (col >= N) continue;
          float y = static_cast<float>(acc[mi][ni][half * 2 + j]) * s_x * sw[col];
          if (bias != nullptr) y += bias[col];
          if (gelu) y = y * 0.5f * (1.0f + erff(y * 0.70710678118654752f));
          out[static_cast<size_t>(row) * N + col] = from_f32<T>(y);
        }
      }
    }
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (x and out share it).
SPT_API int spt_w8a8_quantize_rows(const void* x, void* qx, void* sx, int M,
                                   int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    quantize_rows_kernel<__nv_bfloat16><<<M, kQuantThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(qx),
        static_cast<float*>(sx), K);
  else
    quantize_rows_kernel<float><<<M, kQuantThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(qx),
        static_cast<float*>(sx), K);
  return static_cast<int>(cudaGetLastError());
}

SPT_API int spt_w8a8_gemm(const void* qx, const void* qwt, const void* sx,
                          const void* sw, const void* bias, void* out, int M,
                          int N, int K, int gelu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const int8_t* a = static_cast<const int8_t*>(qx);
  const int8_t* b = static_cast<const int8_t*>(qwt);
  const float* fsx = static_cast<const float*>(sx);
  const float* fsw = static_cast<const float*>(sw);
  const float* fb = static_cast<const float*>(bias);
  if (dtype == 0)
    w8a8_gemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        a, b, fsx, fsw, fb, static_cast<__nv_bfloat16*>(out), M, N, K, gelu);
  else
    w8a8_gemm_kernel<float><<<grid, kThreads, 0, s>>>(
        a, b, fsx, fsw, fb, static_cast<float*>(out), M, N, K, gelu);
  return static_cast<int>(cudaGetLastError());
}
