// Decode-time cross-attention for Hopper (sm_90a): up to 8 query rows per
// (batch, head) against the whole encoder K/V in the decode layout
// [B, H, Dh, Tk] (time minor), bf16, any Tk >= 1.
//
// Replaces the TPU kernel spittle_tpu/ops/attention.py:
// decode_cross_attention (body _decode_cross_kernel). q arrives
// pre-scaled by Dh^-0.5.
//
// What bounds it on an H100: memory. Each call streams B*H*Dh*Tk*2*2
// bytes of K and V (61 MB at B=8, H=20, Tk=1500) for only 4*R*Dh flops
// per (b, h, t): with R <= 8 that is under 2 flops per byte, so the bound
// is the 3.35 TB/s of device memory.
//
// Design: one block per (batch, head), as on the TPU. The block reads K
// and V exactly once each, coalesced along time: in the score pass each
// thread takes pairs of time steps and walks Dh (bf16x2 loads, neighbouring
// threads on neighbouring addresses); in the PV pass each warp owns 8 of
// the 64 head-dim rows of V and its lanes stride along time. The [R, Tk]
// f32 score rows live in dynamic shared memory between the passes, where
// the softmax runs over t < kv_len only (the real 1500, no padding). P is
// rounded to bf16 for the PV sum, where the TPU kernel casts p to v's
// dtype, and 1/l is applied at the end. A reduced audio context may be
// odd; K/V rows are then only 2-byte aligned, and the kPairs = false
// instance reads the same pairs as two bf16 loads (still neighbouring
// threads on neighbouring addresses). With B*H = 160 blocks on 132 SMs
// the card is under-occupied; a split-T (flash-decoding) second pass is
// later work.
//
// Score rows longer than that buffer (R * kv_len * 4 bytes past 200 KB: 8
// rows from 6401 positions, 1 row from 51201) go to a second kernel,
// decode_cross_chunked_kernel, which walks kv in chunks of kChunk
// positions whose scores fit, with the online softmax across chunks: per
// row a running max m, alpha = exp(m - m') and a running sum l; the
// per-(r, d) PV partials, summed over the warp, are scaled by alpha before
// the next chunk's are added, and divided by l once at the end. P then
// rounds to bf16 against its chunk's running max (as K3's split-T does
// against its block's). It is a kernel of its own so that the one-pass
// kernel, which every shape that fits takes, keeps its code: folded into
// one loop over chunks, the one-pass case ran 25% slower at Tk 1500 on
// an H100.
#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kMaxR = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Score bytes a block may hold in dynamic shared memory, and the chunk
// (a multiple of 2 * kThreads positions) the chunked kernel walks.
constexpr int kScoreBytes = 200 * 1024;
constexpr int kChunk = 2048;

// Time steps t and t + 1 of one K/V row. kPairs: the row is 4-byte
// aligned and Tk is even, so one bf16x2 load stays inside the row;
// otherwise two bf16 loads, the second only when t + 1 is a live
// position.
template <bool kPairs>
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p, bool second) {
  if (kPairs)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(__bfloat162float(p[0]),
                     second ? __bfloat162float(p[1]) : 0.f);
}

template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
    decode_cross_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, int H, int R, int Tk,
                        int kv_len, int ldp, long long qsb, long long qsh,
                        long long qsr, long long osb, long long osh,
                        long long osr) {
  extern __shared__ float ps[];  // [R, ldp] scores, then probabilities
  __shared__ float qsm[kMaxR * kD];
  __shared__ float red[kMaxR][kWarps];
  __shared__ float rmax[kMaxR], rsum[kMaxR];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * kD * Tk;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * kD * Tk;
  q += b * qsb + h * qsh;
  o += b * osb + h * osh;

  for (int i = tid; i < R * kD; i += kThreads)
    qsm[i] = __bfloat162float(q[(i / kD) * qsr + (i % kD)]);
  __syncthreads();

  // Scores: s[r, t] = sum_d q[r, d] * k[d, t], two time steps per thread.
  const int npairs = (kv_len + 1) / 2;
  for (int tp = tid; tp < npairs; tp += kThreads) {
    const int t = 2 * tp;
    float a0[kMaxR], a1[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) a0[r] = a1[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      const float2 kk = ld_pair<kPairs>(kb + d * Tk + t, t + 1 < kv_len);
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r < R) {
          const float qv = qsm[r * kD + d];
          a0[r] = fmaf(qv, kk.x, a0[r]);
          a1[r] = fmaf(qv, kk.y, a1[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < R) {
        ps[r * ldp + t] = a0[r];
        if (t + 1 < kv_len) ps[r * ldp + t + 1] = a1[r];
      }
    }
  }
  __syncthreads();

  // Row max over the real kv_len columns.
  for (int r = 0; r < R; ++r) {
    float mx = -INFINITY;
    for (int t = tid; t < kv_len; t += kThreads) mx = fmaxf(mx, ps[r * ldp + t]);
    mx = spt::warp_max(mx);
    if (lane == 0) red[r][warp] = mx;
  }
  __syncthreads();
  if (tid < R) {
    float mx = red[tid][0];
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[tid][w]);
    rmax[tid] = mx;
  }
  __syncthreads();

  // p = exp(s - m): l sums the f32 p, the PV pass reads p rounded to bf16.
  for (int r = 0; r < R; ++r) {
    const float m = rmax[r];
    float sm = 0.f;
    for (int t = tid; t < kv_len; t += kThreads) {
      const float p = expf(ps[r * ldp + t] - m);
      sm += p;
      ps[r * ldp + t] = __bfloat162float(__float2bfloat16_rn(p));
    }
    sm = spt::warp_sum(sm);
    if (lane == 0) red[r][warp] = sm;
  }
  __syncthreads();
  if (tid < R) {
    float sm = 0.f;
    for (int w = 0; w < kWarps; ++w) sm += red[tid][w];
    rsum[tid] = sm;
  }
  __syncthreads();

  // o[r, d] = sum_t p[r, t] * v[d, t] / l[r]; warp w owns d = w, w+8, ...
  for (int d = warp; d < kD; d += kWarps) {
    const __nv_bfloat16* vrow = vb + d * Tk;
    float acc[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) acc[r] = 0.f;
    for (int tp = lane; tp < npairs; tp += 32) {
      const int t = 2 * tp;
      const bool second = t + 1 < kv_len;
      const float2 vv = ld_pair<kPairs>(vrow + t, second);
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r < R) {
          acc[r] = fmaf(ps[r * ldp + t], vv.x, acc[r]);
          if (second) acc[r] = fmaf(ps[r * ldp + t + 1], vv.y, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < R) {
        const float s = spt::warp_sum(acc[r]);
        if (lane == 0) o[r * osr + d] = __float2bfloat16_rn(s / rsum[r]);
      }
    }
  }
}

// K4 past its shared memory: the passes of decode_cross_kernel over one
// chunk at a time, with the online softmax across chunks.
template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
    decode_cross_chunked_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o, int H, int R,
                                int Tk, int kv_len, int ldp, long long qsb,
                                long long qsh, long long qsr, long long osb,
                                long long osh, long long osr) {
  extern __shared__ float ps[];  // [R, ldp = kChunk]: a chunk's scores, then p
  __shared__ float qsm[kMaxR * kD];
  __shared__ float red[kMaxR][kWarps];
  __shared__ float rmax[kMaxR], rsum[kMaxR], ralpha[kMaxR];
  __shared__ float opart[kMaxR][kD];  // sum over t of p * v, per (r, d)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * kD * Tk;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * kD * Tk;
  q += b * qsb + h * qsh;
  o += b * osb + h * osh;

  for (int i = tid; i < R * kD; i += kThreads)
    qsm[i] = __bfloat162float(q[(i / kD) * qsr + (i % kD)]);

  // Chunks [c0, c0 + n); kChunk is even, so pairs stay 4-byte aligned.
  for (int c0 = 0; c0 < kv_len; c0 += kChunk) {
    const int n = min(kChunk, kv_len - c0);
    const bool first = c0 == 0;
    __syncthreads();  // q staged; the previous chunk's PV has read ps

    // Scores: s[r, t] = sum_d q[r, d] * k[d, t], two time steps per thread.
    const int npairs = (n + 1) / 2;
    for (int tp = tid; tp < npairs; tp += kThreads) {
      const int t = 2 * tp;
      float a0[kMaxR], a1[kMaxR];
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) a0[r] = a1[r] = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; ++d) {
        const float2 kk = ld_pair<kPairs>(kb + d * Tk + c0 + t, t + 1 < n);
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r < R) {
            const float qv = qsm[r * kD + d];
            a0[r] = fmaf(qv, kk.x, a0[r]);
            a1[r] = fmaf(qv, kk.y, a1[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r < R) {
          ps[r * ldp + t] = a0[r];
          if (t + 1 < n) ps[r * ldp + t + 1] = a1[r];
        }
      }
    }
    __syncthreads();

    // Row max over the chunk's real columns; m' = max(m, chunk max).
    for (int r = 0; r < R; ++r) {
      float mx = -INFINITY;
      for (int t = tid; t < n; t += kThreads) mx = fmaxf(mx, ps[r * ldp + t]);
      mx = spt::warp_max(mx);
      if (lane == 0) red[r][warp] = mx;
    }
    __syncthreads();
    if (tid < R) {
      float mx = red[tid][0];
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[tid][w]);
      if (first) {
        rmax[tid] = mx;
      } else {
        const float mn = fmaxf(rmax[tid], mx);
        ralpha[tid] = expf(rmax[tid] - mn);
        rmax[tid] = mn;
      }
    }
    __syncthreads();

    // p = exp(s - m'): l sums the f32 p, the PV pass reads p rounded to
    // bf16.
    for (int r = 0; r < R; ++r) {
      const float m = rmax[r];
      float sm = 0.f;
      for (int t = tid; t < n; t += kThreads) {
        const float p = expf(ps[r * ldp + t] - m);
        sm += p;
        ps[r * ldp + t] = __bfloat162float(__float2bfloat16_rn(p));
      }
      sm = spt::warp_sum(sm);
      if (lane == 0) red[r][warp] = sm;
    }
    __syncthreads();
    if (tid < R) {
      float sm = 0.f;
      for (int w = 0; w < kWarps; ++w) sm += red[tid][w];
      rsum[tid] = first ? sm : rsum[tid] * ralpha[tid] + sm;
    }
    __syncthreads();

    // opart[r, d] = opart[r, d] * alpha + sum_t p[r, t] * v[d, t]; warp w
    // owns d = w, w+8, ..., and its lane 0 alone reads and writes them.
    for (int d = warp; d < kD; d += kWarps) {
      const __nv_bfloat16* vrow = vb + d * Tk + c0;
      float acc[kMaxR];
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) acc[r] = 0.f;
      for (int tp = lane; tp < npairs; tp += 32) {
        const int t = 2 * tp;
        const bool second = t + 1 < n;
        const float2 vv = ld_pair<kPairs>(vrow + t, second);
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r < R) {
            acc[r] = fmaf(ps[r * ldp + t], vv.x, acc[r]);
            if (second) acc[r] = fmaf(ps[r * ldp + t + 1], vv.y, acc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r < R) {
          const float s = spt::warp_sum(acc[r]);
          if (lane == 0) opart[r][d] = first ? s : opart[r][d] * ralpha[r] + s;
        }
      }
    }
  }

  // o[r, d] = opart[r, d] / l[r], by the lane that summed it.
  if (lane == 0) {
    for (int d = warp; d < kD; d += kWarps)
      for (int r = 0; r < R; ++r)
        o[r * osr + d] = __float2bfloat16_rn(opart[r][d] / rsum[r]);
  }
}

}  // namespace

// q: [B, H, R, Dh] bf16 with strides (qsb, qsh, qsr, 1); k, v contiguous
// [B, H, Dh, Tk] bf16, any Tk; o: [B, H, R, Dh] bf16 with strides
// (osb, osh, osr, 1). Dynamic shared memory: R * ldp floats, the whole
// kv_len where that fits kScoreBytes, else one chunk of kChunk positions
// for the chunked kernel.
SPT_API int spt_decode_cross_attention(const void* q, const void* k,
                                       const void* v, void* o, int B, int H,
                                       int R, int Tk, int kv_len,
                                       long long qsb, long long qsh,
                                       long long qsr, long long osb,
                                       long long osh, long long osr,
                                       void* stream) {
  int ldp = (kv_len + 1) & ~1;
  const bool fits = static_cast<size_t>(R) * ldp * sizeof(float) <= kScoreBytes;
  if (!fits) ldp = kChunk;
  const size_t smem = static_cast<size_t>(R) * ldp * sizeof(float);
  const bool pairs = Tk % 2 == 0 && reinterpret_cast<uintptr_t>(k) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 4 == 0;
  auto kernel = !fits ? (pairs ? decode_cross_chunked_kernel<true>
                               : decode_cross_chunked_kernel<false>)
                : pairs ? decode_cross_kernel<true>
                        : decode_cross_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      R, Tk, kv_len, ldp, qsb, qsh, qsr, osb, osh, osr);
  return static_cast<int>(cudaGetLastError());
}
