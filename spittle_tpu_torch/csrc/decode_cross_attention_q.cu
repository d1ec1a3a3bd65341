// Decode-time cross-attention over quantized K/V for Hopper (sm_90a), K6:
// up to 8 query rows per (batch, head) against the whole encoder K/V in
// the decode layout (time minor), int4 packed two per byte, with one f32
// scale per position. The kernel is written for int8 (kBits 8) or int4
// (kBits 4) stored rows; only the int4 instance is built: K3, the int8
// form, runs on decode_cross_attention_mh.cu's kernel.
//
// Replaces the TPU kernel spittle_tpu/ops/attention.py:
// decode_cross_attention_q4 (body _decode_cross_q4_kernel). q arrives
// bf16, pre-scaled by Dh^-0.5. Per (b, h), with t < kv_len:
//   s[r, t] = (sum_d q[r, d] * qK[d, t]) * ks[t]      (f32 dot of exact
//                                                      widened values)
//   m = max_t s, p = exp(s - m), l = sum_t p           (mask before the max:
//                                                      pad columns carry scales)
//   o[r, d] = sum_t bf16(p * vs[t]) * qV[d, t] / l
// int4 rows 0..31 are the low nibbles of the 32 stored rows, rows 32..63
// the high nibbles, each sign-extended.
//
// What bounds it on an H100: memory. At B=8, H=20, Tk=1500 a call reads
// 2 x 8*20*32*1500 packed bytes and 2 x 8*20*1500*4 scale bytes (17.3 MB)
// for only 4*R*Dh flops per (b, h, t).
//
// Design: split-T (flash-decoding). A block takes 256 time positions of
// one (b, h), which gives ceil(1500/256) * B*H = 960 blocks at B=8 where
// one block per (b, h) gives 160 on 132 SMs. The block copies each stored
// row's slice of K and of V into shared memory with 16-byte cp.async
// loads: rows are Tk bytes apart and Tk = 1500 is not a multiple of 16,
// so a row's slice is copied as the aligned 16-byte chunks that cover it
// and read back at its offset in the first chunk. V's copy runs while the
// scores are computed. One thread owns one position for the scores; each
// warp owns 8 output rows d for the PV sum, its lanes striding along
// time. The block writes its unnormalised (o, m, l) per row; a second
// small kernel (decode_cross_combine.cuh, shared with K3 and K11 in
// decode_cross_attention_mh.cu) rescales the chunks by exp(m_c - m) and
// divides by l.
#include "decode_cross_combine.cuh"

namespace {

using spt::decode_cross::decode_cross_q_combine;
using spt::decode_cross::kD;
using spt::decode_cross::kMaxR;
using spt::decode_cross::kRec;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;        // time positions per block
constexpr int kRowBytes = kChunk + 16;  // a row slice's aligned 16-byte cover
constexpr int kSegs = kRowBytes / 16;   // at most 17 chunks of 16 bytes

// Sign-extended nibbles of a stored byte: rows d (low) and d + 32 (high).
// The shifts run on an unsigned value; the cast back to int and the
// arithmetic right shift extend the sign.
__device__ __forceinline__ float nib_lo(unsigned b) {
  return static_cast<float>(static_cast<int>(b << 28) >> 28);
}
__device__ __forceinline__ float nib_hi(unsigned b) {
  return static_cast<float>(static_cast<int>(b << 24) >> 28);
}

// Copy bytes [t0, t1) of each of `rows` rows (Tk bytes apart, starting at
// base) into dst rows kRowBytes apart, as whole aligned 16-byte chunks.
// shift[row] receives the slice's offset in its first chunk. Every chunk
// holds at least one byte of the row, so no read leaves the tensor's
// 16-byte granules.
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           unsigned char* shift,
                                           const int8_t* base, int rows,
                                           int Tk, int t0, int t1) {
  for (int i = threadIdx.x; i < rows * kSegs; i += kThreads) {
    const int row = i / kSegs, seg = i % kSegs;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(base) +
                         static_cast<uintptr_t>(row) * Tk + t0;
    const uintptr_t hi = lo + (t1 - t0);
    const uintptr_t a0 = lo & ~static_cast<uintptr_t>(15);
    if (seg == 0) shift[row] = static_cast<unsigned char>(lo - a0);
    if (a0 + 16 * seg < hi)
      spt::cp_async_16(dst + row * kRowBytes + 16 * seg,
                       reinterpret_cast<const void*>(a0 + 16 * seg));
  }
}

// kBits 8: K/V hold 64 rows of int8; kBits 4: 32 rows of packed nibbles.
// R (query rows) is a template parameter so that every per-row loop is
// unrolled without predication: at R = 1, a decode step, the inner loops
// are one load, one convert and one FMA per byte.
template <int kBits, int R>
__global__ void __launch_bounds__(kThreads)
    decode_cross_q_kernel(const __nv_bfloat16* __restrict__ q,
                          const int8_t* __restrict__ qk,
                          const float* __restrict__ ks,
                          const int8_t* __restrict__ qv,
                          const float* __restrict__ vs,
                          float* __restrict__ part, int H, int Tk,
                          int kv_len, long long qsb, long long qsh,
                          long long qsr) {
  constexpr int kRows = kBits == 8 ? kD : kD / 2;
  __shared__ __align__(16) unsigned char ksm[kRows * kRowBytes];
  __shared__ __align__(16) unsigned char vsm[kRows * kRowBytes];
  __shared__ unsigned char kshift[kRows], vshift[kRows];
  __shared__ float qsm[kD][R];
  __shared__ float pv[kChunk][R];
  __shared__ float red[R][kWarps];
  __shared__ float rmax[R];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunk = blockIdx.x, nchunks = gridDim.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = chunk * kChunk;
  const int t1 = min(t0 + kChunk, kv_len);
  const int n = t1 - t0;  // >= 1: the grid covers kv_len exactly
  const size_t kv_off = static_cast<size_t>(bh) * kRows * Tk;

  stage_rows(ksm, kshift, qk + kv_off, kRows, Tk, t0, t1);
  spt::cp_async_commit();
  stage_rows(vsm, vshift, qv + kv_off, kRows, Tk, t0, t1);
  spt::cp_async_commit();

  q += b * qsb + h * qsh;
  for (int i = tid; i < R * kD; i += kThreads)
    qsm[i % kD][i / kD] = __bfloat162float(q[(i / kD) * qsr + (i % kD)]);
  spt::cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();

  // Scores: thread tid owns position t0 + tid.
  const bool live = tid < n;
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
  if (live) {
#pragma unroll 8
    for (int row = 0; row < kRows; ++row) {
      const unsigned byte = ksm[row * kRowBytes + kshift[row] + tid];
      if constexpr (kBits == 8) {
        const float kv = static_cast<float>(static_cast<int8_t>(byte));
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = fmaf(qsm[row][r], kv, s[r]);
      } else {
        const float lo = nib_lo(byte), hi = nib_hi(byte);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r] = fmaf(qsm[row][r], lo, s[r]);
          s[r] = fmaf(qsm[row + kRows][r], hi, s[r]);
        }
      }
    }
    const float sc = ks[static_cast<size_t>(bh) * Tk + t0 + tid];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] *= sc;
  }
  // Positions past kv_len never enter the max.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float mx = spt::warp_max(live ? s[r] : -INFINITY);
    if (lane == 0) red[r][warp] = mx;
  }
  __syncthreads();
  if (tid < R) {
    float mx = red[tid][0];
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[tid][w]);
    rmax[tid] = mx;
  }
  __syncthreads();

  // p = exp(s - m_chunk): l sums the f32 p; PV reads bf16(p * vs).
  const float vsc = live ? vs[static_cast<size_t>(bh) * Tk + t0 + tid] : 0.f;
  float lsum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float p = live ? expf(s[r] - rmax[r]) : 0.f;
    pv[tid][r] = __bfloat162float(__float2bfloat16_rn(p * vsc));
    lsum[r] = spt::warp_sum(p);
  }
  __syncthreads();  // pv complete; red free again
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (lane == 0) red[r][warp] = lsum[r];
  spt::cp_async_wait<0>();  // this thread's V copies have landed
  __syncthreads();

  float* rec = part + (static_cast<size_t>(bh) * nchunks + chunk) * R * kRec;
  if (tid < R) {
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += red[tid][w];
    rec[tid * kRec + kD] = rmax[tid];
    rec[tid * kRec + kD + 1] = l;
  }

  // o[r, d] = sum_t pv[t, r] * qV[d, t]: warp w owns 8 rows d (int4: 4
  // stored rows, each giving d and d + 32).
  constexpr int kStoredPerWarp = kRows / kWarps;
#pragma unroll
  for (int i = 0; i < kStoredPerWarp; ++i) {
    const int row = warp * kStoredPerWarp + i;
    const unsigned char* vrow = vsm + row * kRowBytes + vshift[row];
    float a0[R], a1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a0[r] = a1[r] = 0.f;
    for (int t = lane; t < n; t += 32) {
      const unsigned byte = vrow[t];
      if constexpr (kBits == 8) {
        const float v = static_cast<float>(static_cast<int8_t>(byte));
#pragma unroll
        for (int r = 0; r < R; ++r) a0[r] = fmaf(pv[t][r], v, a0[r]);
      } else {
        const float lo = nib_lo(byte), hi = nib_hi(byte);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a0[r] = fmaf(pv[t][r], lo, a0[r]);
          a1[r] = fmaf(pv[t][r], hi, a1[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float o0 = spt::warp_sum(a0[r]);
      if constexpr (kBits == 8) {
        if (lane == 0) rec[r * kRec + row] = o0;
      } else {
        const float o1 = spt::warp_sum(a1[r]);
        if (lane == 0) {
          rec[r * kRec + row] = o0;
          rec[r * kRec + row + kRows] = o1;
        }
      }
    }
  }
}

template <int kBits, int R>
cudaError_t launch_rows(const void* q, const void* qk, const void* ks,
                        const void* qv, const void* vs, void* part, int B,
                        int H, int Tk, int kv_len, long long qsb,
                        long long qsh, long long qsr, cudaStream_t st) {
  const int nchunks = (kv_len + kChunk - 1) / kChunk;
  decode_cross_q_kernel<kBits, R><<<dim3(nchunks, B * H), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(qk),
      static_cast<const float*>(ks), static_cast<const int8_t*>(qv),
      static_cast<const float*>(vs), static_cast<float*>(part), H, Tk, kv_len,
      qsb, qsh, qsr);
  return cudaGetLastError();
}

template <int kBits>
int launch(const void* q, const void* qk, const void* ks, const void* qv,
           const void* vs, void* part, void* o, int B, int H, int R, int Tk,
           int kv_len, long long qsb, long long qsh, long long qsr,
           long long osb, long long osh, long long osr, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (R) {
#define SPT_ROWS(n)                                                       \
  case n:                                                                 \
    err = launch_rows<kBits, n>(q, qk, ks, qv, vs, part, B, H, Tk, kv_len, \
                                qsb, qsh, qsr, st);                       \
    break;
    SPT_ROWS(1) SPT_ROWS(2) SPT_ROWS(3) SPT_ROWS(4)
    SPT_ROWS(5) SPT_ROWS(6) SPT_ROWS(7) SPT_ROWS(8)
#undef SPT_ROWS
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nchunks = (kv_len + kChunk - 1) / kChunk;
  decode_cross_q_combine<<<B * H, kMaxR * kD, 0, st>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(o), H, R,
      nchunks, osb, osh, osr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6. q: [B, H, R, 64] bf16 with strides (qsb, qsh, qsr, 1); qk, qv
// contiguous packed int4 [B, H, 32, Tk]; ks, vs contiguous f32 [B, H, Tk];
// part: f32 scratch [B*H, ceil(kv_len/256), R, 66]; o: [B, H, R, 64] bf16
// with strides (osb, osh, osr, 1).
SPT_API int spt_decode_cross_attention_q4(
    const void* q, const void* qk, const void* ks, const void* qv,
    const void* vs, void* part, void* o, int B, int H, int R, int Tk,
    int kv_len, long long qsb, long long qsh, long long qsr, long long osb,
    long long osh, long long osr, void* stream) {
  return launch<4>(q, qk, ks, qv, vs, part, o, B, H, R, Tk, kv_len, qsb, qsh,
                   qsr, osb, osh, osr, stream);
}
