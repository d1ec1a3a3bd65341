// K15: the backward of K1's attention for Hopper (sm_90a). Given q, k, v,
// K1's output o and the output's gradient dO, all bf16 [B, H, T, 64] in
// the strided head views K1 takes, it writes dq, dk and dv of
// o = softmax(q k^T) v with K1's masks (col < kv_len; row >= col on
// absolute indices under `causal`). q and k arrive pre-scaled by
// Dh^-0.25, so no scale is applied here.
//
// It replaces no TPU kernel. The reference defines no custom_vjp around
// its attention: its training gradient (spittle_tpu/train/step.py) is
// XLA's transpose of the attention that spittle_tpu/ops/attention.py
// computes (multihead_attention, attention_reference on the CPU). The
// port has no XLA, so K1 (fullkv_attention.cu) has this kernel as its
// backward in ops/attention.py's autograd Function.
//
// What bounds it on an H100: the gradient needs ~10 * B * H * Tq * Tk * 64
// FLOPs (recomputing S, then dV, dP, dQ and dK), 92 * 2.5 = 230 GFLOP at
// [8, 20, 1500, 64] against ~246 MB of q, k, v, o, dO, dq, dk and dv
// (~0.073 ms at 3.35 TB/s): 0.23 ms at the tensor cores' 989 TFLOP/s
// (K1's forward: 0.093 ms).
//
// Design: FlashAttention-2's, simple and deterministic (no atomics, so
// two runs give the same bits). Two launches on the caller's stream:
//
//  1. rows (one block per (b, h) and 64 query rows, four warps of 16 rows):
//     the row max and sum of exp over the key tiles give each row's
//     log-sum-exp (K1 does not emit it); D = rowsum(dO * o); then a second
//     walk over the key tiles recomputes P = exp(S - lse) and accumulates
//     dQ = (P * (dO V^T - D)) K. lse and D go to f32 scratch.
//  2. cols (one block per (b, h) and 64 keys, four warps of 16 keys):
//     walks the query tiles that can see its keys, recomputes S^T = K Q^T
//     and P^T from the stored lse, and accumulates dV = P^T dO and
//     dK = dS^T Q with dS = P * (dP - D).
//
// Products are mma.sync m16n8k16 bf16 tiles with f32 accumulators; P and
// dS are rounded to bf16 as the A operands of the second products. Tiles
// are staged in shared memory rows of 72 bf16 (144 bytes: fragment loads
// hit 32 distinct banks); a tile past T is zero-filled. Rows past Tq are
// not stored; keys at or past kv_len get a zero gradient. wgmma, TMA and a
// ring of stages are later work.
#include "common.cuh"

namespace {

constexpr int kD = 64;       // head dim
constexpr int kTile = 64;    // query rows or keys per block
constexpr int kWarps = 4;    // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kPitch = kD + 8;  // shared-memory row pitch, bf16
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;
using Tile = bf16[kTile][kPitch];

struct Strides {
  long long b, h, t;  // elements
};

__device__ __forceinline__ long long offset(Strides s, int b, int h, int t) {
  return b * s.b + h * s.h + static_cast<long long>(t) * s.t;
}

// Rows t0 .. t0 + 63 of head (b, h) into dst; rows at or past n zeros.
__device__ __forceinline__ void load_tile(Tile& dst, const bf16* src,
                                          Strides s, int b, int h, int t0,
                                          int n) {
  for (int i = threadIdx.x; i < kTile * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + offset(s, b, h, t0 + r) + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

// A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 15 of x.
__device__ __forceinline__ void frag_a(uint32_t a[4], const Tile& x, int r0,
                                       int k0) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  a[0] = spt::ld_u32(&x[r0 + g][k0 + 2 * c]);
  a[1] = spt::ld_u32(&x[r0 + g + 8][k0 + 2 * c]);
  a[2] = spt::ld_u32(&x[r0 + g][k0 + 2 * c + 8]);
  a[3] = spt::ld_u32(&x[r0 + g + 8][k0 + 2 * c + 8]);
}

// B fragment with B[k][n] = x[n0 + n][k0 + k] (x's rows are B's columns).
__device__ __forceinline__ void frag_b_rows(uint32_t b[2], const Tile& x,
                                            int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  b[0] = spt::ld_u32(&x[n0 + g][k0 + 2 * c]);
  b[1] = spt::ld_u32(&x[n0 + g][k0 + 2 * c + 8]);
}

// B fragment with B[k][n] = x[k0 + k][n0 + n] (x's rows are B's rows).
__device__ __forceinline__ void frag_b_cols(uint32_t b[2], const Tile& x,
                                            int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  b[0] = spt::pack_bf16_raw(x[k0 + 2 * c][n0 + g], x[k0 + 2 * c + 1][n0 + g]);
  b[1] = spt::pack_bf16_raw(x[k0 + 2 * c + 8][n0 + g],
                            x[k0 + 2 * c + 9][n0 + g]);
}

// acc[n-tile] (16 x 64) = rows r0.. of a (held as A fragments) times the
// 64 rows of x taken as B's columns: a x^T.
__device__ __forceinline__ void product_rows(float acc[8][4],
                                             const uint32_t a[4][4],
                                             const Tile& x) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b[2];
      frag_b_rows(b, x, nt * 8, kk * 16);
      spt::mma_bf16_16816(acc[nt], a[kk], b);
    }
  }
}

// acc += p x, with p (16 x 64, f32 accumulator layout) rounded to bf16
// as the A operand and x's 64 rows as the reduction dimension.
__device__ __forceinline__ void accumulate_cols(float acc[8][4],
                                                const float p[8][4],
                                                const Tile& x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = spt::pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = spt::pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = spt::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = spt::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b[2];
      frag_b_cols(b, x, kk * 16, nt * 8);
      spt::mma_bf16_16816(acc[nt], a, b);
    }
  }
}

__device__ __forceinline__ bool kept(int row, int col, int tq, int kv_len,
                                     int causal) {
  return row < tq && col < kv_len && (!causal || row >= col);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stores rows r0 + g and r0 + g + 8 (absolute t0 + ...) of a 16 x 64
// accumulator as bf16, rows at or past n skipped.
__device__ __forceinline__ void store_rows(bf16* dst, Strides s, int b, int h,
                                           int t0, int n,
                                           const float acc[8][4]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + g + 8 * half;
    if (t >= n) continue;
    bf16* row = dst + offset(s, b, h, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(row + nt * 8 + 2 * c) =
          spt::pack_bf16(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  bf16 *dq, *dk, *dv;
  float *lse, *dd;  // [B * H, Tq]
  int h, tq, tk, kv_len, causal;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

__global__ void __launch_bounds__(kThreads) bwd_rows_kernel(Args a) {
  __shared__ __align__(16) Tile qs, dos, ks, vs;
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, r0 = warp * 16;
  const int row_lo = q0 + r0 + g, row_hi = row_lo + 8;

  load_tile(qs, a.q, a.sq, b, h, q0, a.tq);
  load_tile(dos, a.dout, a.sdo, b, h, q0, a.tq);
  load_tile(ks, a.o, a.so, b, h, q0, a.tq);  // o, for D
  __syncthreads();
  float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c * 16 + j;
    d_lo += __bfloat162float(dos[r0 + g][col]) * __bfloat162float(ks[r0 + g][col]);
    d_hi += __bfloat162float(dos[r0 + g + 8][col]) *
            __bfloat162float(ks[r0 + g + 8][col]);
  }
  d_lo = quad_sum(d_lo);
  d_hi = quad_sum(d_hi);
  uint32_t qa[4][4], da[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    frag_a(qa[kk], qs, r0, kk * 16);
    frag_a(da[kk], dos, r0, kk * 16);
  }

  // Keys that any row of this block can see.
  const int kend = a.causal ? min(a.kv_len, q0 + kTile) : a.kv_len;
  const int n_tiles = (kend + kTile - 1) / kTile;
  float s[8][4];

  // 1. The row max and sum of exp, online over the key tiles. Key 0 is
  // kept for every row, so the max is finite after the first tile.
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();
    load_tile(ks, a.k, a.sk, b, h, j * kTile, a.tk);
    __syncthreads();
    product_rows(s, qa, ks);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * kTile + nt * 8 + 2 * c + e;
        // A row past Tq keeps nothing: its lse is NaN and never read.
        if (!kept(row_lo, col, a.tq, a.kv_len, a.causal)) s[nt][e] = -INFINITY;
        if (!kept(row_hi, col, a.tq, a.kv_len, a.causal)) s[nt][2 + e] = -INFINITY;
        mx_lo = fmaxf(mx_lo, s[nt][e]);
        mx_hi = fmaxf(mx_hi, s[nt][2 + e]);
      }
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sum_lo += exp2f((s[nt][0] - mn_lo) * kLog2e) + exp2f((s[nt][1] - mn_lo) * kLog2e);
      sum_hi += exp2f((s[nt][2] - mn_hi) * kLog2e) + exp2f((s[nt][3] - mn_hi) * kLog2e);
    }
    l_lo = l_lo * exp2f((m_lo - mn_lo) * kLog2e) + quad_sum(sum_lo);
    l_hi = l_hi * exp2f((m_hi - mn_hi) * kLog2e) + quad_sum(sum_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
  }
  const float lse_lo = m_lo + logf(l_lo), lse_hi = m_hi + logf(l_hi);
  if (c == 0) {
    const long long base = static_cast<long long>(bh) * a.tq;
    if (row_lo < a.tq) {
      a.lse[base + row_lo] = lse_lo;
      a.dd[base + row_lo] = d_lo;
    }
    if (row_hi < a.tq) {
      a.lse[base + row_hi] = lse_hi;
      a.dd[base + row_hi] = d_hi;
    }
  }

  // 2. dQ = dS K over the same key tiles.
  float dq[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;
  float dp[8][4];
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();
    load_tile(ks, a.k, a.sk, b, h, j * kTile, a.tk);
    load_tile(vs, a.v, a.sv, b, h, j * kTile, a.tk);
    __syncthreads();
    product_rows(s, qa, ks);
    product_rows(dp, da, vs);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * kTile + nt * 8 + 2 * c + e;
        const float p_lo = kept(row_lo, col, a.tq, a.kv_len, a.causal)
                               ? exp2f((s[nt][e] - lse_lo) * kLog2e) : 0.f;
        const float p_hi = kept(row_hi, col, a.tq, a.kv_len, a.causal)
                               ? exp2f((s[nt][2 + e] - lse_hi) * kLog2e) : 0.f;
        s[nt][e] = p_lo * (dp[nt][e] - d_lo);
        s[nt][2 + e] = p_hi * (dp[nt][2 + e] - d_hi);
      }
    }
    accumulate_cols(dq, s, ks);
  }
  store_rows(a.dq, a.sdq, b, h, q0 + r0, a.tq, dq);
}

__global__ void __launch_bounds__(kThreads) bwd_cols_kernel(Args a) {
  __shared__ __align__(16) Tile ks, vs, qs, dos;
  __shared__ float lse_s[kTile], dd_s[kTile];
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, r0 = warp * 16;
  const int key_lo = k0 + r0 + g, key_hi = key_lo + 8;

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.f;
    dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.f;
  }
  if (k0 < a.kv_len) {
    load_tile(ks, a.k, a.sk, b, h, k0, a.tk);
    load_tile(vs, a.v, a.sv, b, h, k0, a.tk);
    __syncthreads();
    uint32_t ka[4][4], va[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      frag_a(ka[kk], ks, r0, kk * 16);
      frag_a(va[kk], vs, r0, kk * 16);
    }
    const long long base = static_cast<long long>(bh) * a.tq;
    // Under `causal` the first query tile that can see key k0.
    const int i0 = a.causal ? k0 / kTile : 0;
    const int n_q = (a.tq + kTile - 1) / kTile;
    float st[8][4], dpt[8][4];
    for (int i = i0; i < n_q; ++i) {
      const int q0 = i * kTile;
      __syncthreads();
      load_tile(qs, a.q, a.sq, b, h, q0, a.tq);
      load_tile(dos, a.dout, a.sdo, b, h, q0, a.tq);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool in = q0 + r < a.tq;
        lse_s[r] = in ? a.lse[base + q0 + r] : 0.f;
        dd_s[r] = in ? a.dd[base + q0 + r] : 0.f;
      }
      __syncthreads();
      product_rows(st, ka, qs);   // S^T: keys x query rows
      product_rows(dpt, va, dos);  // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rr = nt * 8 + 2 * c + e, row = q0 + rr;
          const float p_lo = kept(row, key_lo, a.tq, a.kv_len, a.causal)
                                 ? exp2f((st[nt][e] - lse_s[rr]) * kLog2e) : 0.f;
          const float p_hi = kept(row, key_hi, a.tq, a.kv_len, a.causal)
                                 ? exp2f((st[nt][2 + e] - lse_s[rr]) * kLog2e) : 0.f;
          st[nt][e] = p_lo;
          st[nt][2 + e] = p_hi;
          dpt[nt][e] = p_lo * (dpt[nt][e] - dd_s[rr]);
          dpt[nt][2 + e] = p_hi * (dpt[nt][2 + e] - dd_s[rr]);
        }
      }
      accumulate_cols(dv, st, dos);  // dV += P^T dO
      accumulate_cols(dk, dpt, qs);  // dK += dS^T Q
    }
  }
  store_rows(a.dk, a.sdk, b, h, k0 + r0, a.tk, dk);
  store_rows(a.dv, a.sdv, b, h, k0 + r0, a.tk, dv);
}

}  // namespace

// K15. q, o, dout [B, H, Tq, 64] and k, v [B, H, Tk, 64] bf16, dq [B, H,
// Tq, 64] and dk, dv [B, H, Tk, 64] bf16 outputs, each through (batch,
// head, time) strides in elements (multiples of 8, data 16-byte aligned,
// head dim contiguous); lse and dd f32 scratch of B * H * Tq. 1 <= kv_len
// <= Tk; causal: row >= col on absolute indices. Returns
// cudaGetLastError().
SPT_API int spt_fullkv_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dd,
    int b, int h, int tq, int tk, int kv_len, int causal,
    long long sqb, long long sqh, long long sqt, long long skb, long long skh,
    long long skt, long long svb, long long svh, long long svt, long long sob,
    long long soh, long long sot, long long sdob, long long sdoh,
    long long sdot, long long sdqb, long long sdqh, long long sdqt,
    long long sdkb, long long sdkh, long long sdkt, long long sdvb,
    long long sdvh, long long sdvt, void* stream) {
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lse = static_cast<float*>(lse);
  a.dd = static_cast<float*>(dd);
  a.h = h;
  a.tq = tq;
  a.tk = tk;
  a.kv_len = kv_len;
  a.causal = causal;
  a.sq = {sqb, sqh, sqt};
  a.sk = {skb, skh, skt};
  a.sv = {svb, svh, svt};
  a.so = {sob, soh, sot};
  a.sdo = {sdob, sdoh, sdot};
  a.sdq = {sdqb, sdqh, sdqt};
  a.sdk = {sdkb, sdkh, sdkt};
  a.sdv = {sdvb, sdvh, sdvt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bwd_rows_kernel<<<dim3((tq + kTile - 1) / kTile, b * h), kThreads, 0, s>>>(a);
  bwd_cols_kernel<<<dim3((tk + kTile - 1) / kTile, b * h), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
