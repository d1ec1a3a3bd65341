// Encoder self-attention in f32 for Hopper (sm_90a) on the CUDA cores: K1's
// function, and K5's for K/V past 4096 positions, with f32 q, k, v and
// output (entry spt_fullkv_attention_f32, which both wrappers call).
//
// Replaces the TPU kernels spittle_tpu/ops/attention.py:
// flash_attention_fullkv (K1, body _fullkv_kernel) and flash_attention
// (K5, body _flash_kernel) at the JAX package's default precision: both
// keep P in V's dtype, so on f32 inputs they run f32 end to end, and the
// JAX engine (dtype f32 by default) sends every encode there. q and k
// arrive pre-scaled by Dh^-0.25. Per (b, h, row i), with j < kv_len and,
// under `causal`, j <= i on absolute indices (no Tk - Tq offset):
//   s[i, j] = sum_d q[i, d] * k[j, d]
//   o[i, :] = sum_j exp(s[i, j] - m_i) * v[j, :] / sum_j exp(s[i, j] - m_i)
//
// What bounds it on an H100: operations. At [8, 20, 1500, 64] the two
// products take 4 * B*H*T*T*64 = 92.2 GFLOP, 1.38 ms at the data sheet's
// 67 TFLOP/s of f32 FMA; the 0.36 G exponentials take 0.09 ms on the
// special-function units, the 4 x 61 MB of q, k, v and o 0.07 ms. No TF32
// and no tensor cores: TF32 keeps about three decimal digits, and the
// JAX kernel's products are f32 (a 3 x TF32 split on wgmma is speed work
// for later).
//
// Design: one block of 256 threads per (b*h, 64 query rows), grid (row
// blocks, B*H). A head's f32 K and V (1500 x 64 x 4 bytes each) do not
// fit in shared memory, so they stream through it in tiles of 64 keys, two
// stages deep (16-byte cp.async: the next tile lands while this one is
// used), under an online softmax in f32: per tile the running max m, the
// sum l and the output are rescaled by exp(m_old - m_new), and o / l is
// taken after the last tile, as K1 applies 1/l after PV. Thread (ty, tx)
// of a 16 x 16 grid owns rows 4ty..4ty+3: for the scores the keys tx +
// 16j (j < 4), for PV the dims 4tx..4tx+3. Shared rows of 68 floats keep
// the float4 reads free of bank conflicts (a quarter-warp's eight K rows
// start on eight different 4-bank groups); P goes through shared memory.
// Each score sums over d in order, each output over the keys in order.
// Keys at or past kv_len (or past the block's last row, causal) are never
// loaded: their rows are zero-filled, and a causal block stops at the tile
// of its last row.
#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;     // a 16 x 16 grid
constexpr int kLd = kD + 4;       // a shared row, in floats
constexpr int kTile = kBQ * kLd;  // floats of one [64][68] tile
// Shared memory: q, two stages of K and two of V, P.
constexpr int kSmemBytes = 6 * kTile * 4;
static_assert(kBQ == kBK, "q, K, V and P tiles share one shape");

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + 64) of a [T, 64] f32 head (rows `ld` floats apart) into a
// [64][kLd] tile: rows below `limit` by 16-byte cp.async, the rest zeros.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ld, int r0, int limit) {
  for (int i = threadIdx.x; i < kBQ * (kD / 4); i += kThreads) {
    const int r = i >> 4, c = (i & 15) * 4;
    float* d = dst + r * kLd + c;
    if (r0 + r < limit)
      spt::cp_async_16(d, src + static_cast<long long>(r0 + r) * ld + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Reductions over the 16 lanes of one ty (a half-warp).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads, 2)
    fullkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int H,
                      int Tq, int kv_len, int causal, long long qsb,
                      long long qsh, long long qst, long long ksb, long long ksh,
                      long long kst, long long vsb, long long vsh, long long vst,
                      long long osb, long long osh, long long ost) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const qs = sm;
  float* const ps = sm + 5 * kTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qh = q + b * qsb + h * qsh;
  const float* kh = k + b * ksb + h * ksh;
  const float* vh = v + b * vsb + h * vsh;

  // Keys this block reads: below kv_len and, causal, up to its last row.
  const int kend = causal ? min(kv_len, q0 + kBQ) : kv_len;
  const int ntiles = (kend + kBK - 1) / kBK;

  load_tile(qs, qh, qst, q0, Tq);
  load_tile(sm + kTile, kh, kst, 0, kend);
  load_tile(sm + 3 * kTile, vh, vst, 0, kend);
  cp_async_commit();

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_tile(sm + (2 - buf) * kTile, kh, kst, (t + 1) * kBK, kend);
      load_tile(sm + (4 - buf) * kTile, vh, vst, (t + 1) * kBK, kend);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = sm + (1 + buf) * kTile;
    const float* vt = sm + (3 + buf) * kTile;

    // Scores s[i][j] for rows 4ty + i, keys tx + 16j of this tile.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // Masks, the running max, P into shared memory, the rescale.
    const int k0 = t * kBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < kv_len && (!causal || row >= col);
        s[i][j] = keep ? s[i][j] : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      const float mnew = fmaxf(m[i], half_warp_max(mt));
      // Key 0 is kept in every row, so m is finite from the first tile on;
      // the guard keeps a row with no kept key so far at p = 0.
      const float base = mnew == -INFINITY ? 0.f : mnew;
      const float alpha = expf(m[i] - base);
      m[i] = mnew;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - base);
        ps[(4 * ty + i) * kLd + tx + 16 * j] = p;
        ls += p;
      }
      l[i] = fmaf(l[i], alpha, ls);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // PV: acc[i][jj] += sum over this tile's keys c of P[4ty + i][c] *
    // V[c][4tx + jj].
#pragma unroll 4
    for (int c = 0; c < kBK; c += 4) {
      float4 pa[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kLd + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        vb[cc] = *reinterpret_cast<const float4*>(vt + (c + cc) * kLd + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pc[4] = {pa[i].x, pa[i].y, pa[i].z, pa[i].w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          acc[i][0] = fmaf(pc[cc], vb[cc].x, acc[i][0]);
          acc[i][1] = fmaf(pc[cc], vb[cc].y, acc[i][1]);
          acc[i][2] = fmaf(pc[cc], vb[cc].z, acc[i][2]);
          acc[i][3] = fmaf(pc[cc], vb[cc].w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // the stage and P are read before they are refilled
  }

  float* oh = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lsum = half_warp_sum(l[i]);
    const int row = q0 + 4 * ty + i;
    if (row < Tq)
      *reinterpret_cast<float4*>(oh + row * ost + 4 * tx) =
          make_float4(acc[i][0] / lsum, acc[i][1] / lsum, acc[i][2] / lsum,
                      acc[i][3] / lsum);
  }
}

}  // namespace

// q: [B, H, Tq, 64] f32 with strides (qsb, qsh, qst, 1); k, v: [B, H, Tk,
// 64] f32 likewise; every stride a multiple of 4 floats and every base
// 16-byte aligned (the 16-byte copies). o: [B, H, Tq, 64] f32 with strides
// (osb, osh, ost, 1), ost a multiple of 4. 1 <= kv_len <= Tk; B * H at
// most 65535 (the grid's y axis).
SPT_API int spt_fullkv_attention_f32(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Tq, int Tk, int kv_len, int causal, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, long long osb, long long osh,
    long long ost, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || kv_len < 1 || kv_len > Tk ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        fullkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  fullkv_f32_kernel<<<grid, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Tq, kv_len,
      causal, qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost);
  return static_cast<int>(cudaGetLastError());
}
