// Tiled online-softmax attention for Hopper (sm_90a), K5: o = softmax(q
// k^T) v per (batch, head) for K/V of any length, with a kv_len mask and
// an optional causal mask.
//
// Replaces spittle_tpu/ops/attention.py:flash_attention (body
// _flash_kernel), the kernel the reference's dispatcher takes for K/V
// longer than 4096 positions: a long-window model's encoder
// self-attention. Inputs arrive pre-scaled (Whisper's split Dh^-0.25), so
// no scale is applied here.
//
// What bounds it on an H100: operations. At [2, 20, 6000, 64] a call does
// 4*B*H*Tq*Tk*Dh = 369 GFLOP against 123 MB of q, k, v and o: ~3,000 FLOP
// per byte, ten times the bf16 ridge, so the bound is the tensor cores'
// 989 TFLOP/s.
//
// Design: one block per (batch*head, 64 query rows), 4 warps x 16 rows,
// with the running max m, the row sum l and the f32 accumulator in
// registers, and a loop over 128-key tiles staged in shared memory. The
// tile width is the reference's block_k, so every row's m, alpha = exp(m
// - m') and l advance at the same keys as on the TPU and the two kernels
// round alike: the mask (col < kv_len, and row >= col on absolute indices
// under `causal`, without any Tk - Tq offset) goes on before the max with
// the finite -1e30, P is rounded to bf16 for the PV product, l sums the
// f32 P, and acc / l is one division at the end. The TPU grid carries m,
// l and acc in VMEM scratch across its sequential key axis; here they
// never leave registers. The reference pads q and K/V to multiples of 128
// in device memory and slices the result; this kernel takes ragged Tq and
// Tk (rows past Tk are zero-filled in shared memory and masked, rows past
// Tq are not stored) and reads heads through strides, so nothing is
// copied. Key tiles wholly past kv_len or wholly above the diagonal are
// skipped: they contribute exact zeros. K and V fragments come from
// shared memory with ldmatrix (V transposed by the instruction). Loads
// are not pipelined; cp.async/TMA and wgmma are later work.
#include "common.cuh"

namespace {

constexpr int kD = 64;     // head dim
constexpr int kBQ = 64;    // query rows per block (4 warps x 16)
constexpr int kBK = 128;   // keys per tile: the reference's block_k
constexpr int kLd = kD + 8;  // 144-byte rows: conflict-free for ldmatrix
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the reference's finite mask value

struct Strides {
  long long b, h, t;
};

// `rows` rows x 64 bf16 in 16-byte chunks; rows >= tmax are zeroed.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long st, int t0, int tmax,
                                          int rows, int tid) {
  for (int ch = tid; ch < rows * 8; ch += kThreads) {
    const int r = ch >> 3, cc = (ch & 7) * 8;
    const int t = t0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < tmax) v = *reinterpret_cast<const uint4*>(src + t * st + cc);
    *reinterpret_cast<uint4*>(dst + r * kLd + cc) = v;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int H, int Tq,
                           int Tk, int kv_len, int causal, Strides qs,
                           Strides ks, Strides vs, Strides os) {
  // The Q tile borrows the K buffer: Q is in registers before the first
  // K tile lands, and the loop opens with a barrier.
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * kLd];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * kLd];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  q += b * qs.b + h * qs.h;
  k += b * ks.b + h * ks.h;
  v += b * vs.b + h * vs.h;
  o += b * os.b + h * os.h;

  load_tile(Ks, q, qs.t, q0, Tq, kBQ, tid);
  __syncthreads();
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r = warp * 16 + g, col = kk * 16 + 2 * c;
    qf[kk][0] = spt::ld_u32(&Ks[r * kLd + col]);
    qf[kk][1] = spt::ld_u32(&Ks[(r + 8) * kLd + col]);
    qf[kk][2] = spt::ld_u32(&Ks[r * kLd + col + 8]);
    qf[kk][3] = spt::ld_u32(&Ks[(r + 8) * kLd + col + 8]);
  }

  float oacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum
  const int row_base = q0 + warp * 16 + g;  // rows row_base, row_base + 8

  // ldmatrix lane addressing. K (non-transposed): matrix lane/8 holds
  // keys nt*8.., head-dim chunk (lane/8)*8 of a 32-wide half. V
  // (transposed): matrices 0/1 are keys +0/+8 of head-dim tile dt,
  // matrices 2/3 the same keys of tile dt + 1.
  const int k_row = lane & 7, k_col = (lane >> 3) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_len, q0 + kBQ);
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile (and Q)
    load_tile(Ks, k, ks.t, kv0, Tk, kBK, tid);
    load_tile(Vs, v, vs.t, kv0, Tk, kBK, tid);
    __syncthreads();

    // S = Q K^T over the tile: 16 n-tiles of 8 keys.
    float s[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, &Ks[(nt * 8 + k_row) * kLd + half * 32 + k_col]);
        spt::mma_bf16_16816(s[nt], qf[2 * half], bfr);
        spt::mma_bf16_16816(s[nt], qf[2 * half + 1], bfr + 2);
      }
    }

    // The mask goes on before the max, as in the reference.
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + nt * 8 + 2 * c + (j & 1);
        const int row = row_base + (j >> 1) * 8;
        if (col >= kv_len || (causal && col > row)) s[nt][j] = kNegInf;
      }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // Column 0 is live for every row (kv_len >= 1, row >= 0), so m is a
      // real score from the first tile on and a masked p is exp(-1e30 -
      // m) = 0 exactly.
      const float m_new = fmaxf(m_run[hr], mx);
      const float alpha = expf(m_run[hr] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = expf(s[nt][2 * hr + j] - m_new);
          s[nt][2 * hr + j] = p;
          rs += p;
        }
      l_run[hr] = l_run[hr] * alpha + rs;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        oacc[dt][2 * hr] *= alpha;
        oacc[dt][2 * hr + 1] *= alpha;
      }
      m_run[hr] = m_new;
    }

    // acc += bf16(P) V: 8 k-steps of 16 keys.
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t pa[4];
      pa[0] = spt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = spt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = spt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = spt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, &Vs[(kk * 16 + v_row) * kLd + dp * 16 + v_col]);
        spt::mma_bf16_16816(oacc[2 * dp], pa, bfr);
        spt::mma_bf16_16816(oacc[2 * dp + 1], pa, bfr + 2);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row_base + hr * 8;
    if (row >= Tq) continue;
    __nv_bfloat16* orow = o + row * os.t;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int d = dt * 8 + 2 * c;
      *reinterpret_cast<uint32_t*>(orow + d) =
          spt::pack_bf16(oacc[dt][2 * hr] / l, oacc[dt][2 * hr + 1] / l);
    }
  }
}

}  // namespace

// K5. q, o [B, H, Tq, 64] and k, v [B, H, Tk, 64] bf16 through (batch,
// head, time) strides in elements; the head dim is contiguous in all four.
// 1 <= kv_len <= Tk; any Tq and Tk.
SPT_API int spt_flash_attention(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int Tq, int Tk,
                                int kv_len, int causal, long long qsb,
                                long long qsh, long long qst, long long ksb,
                                long long ksh, long long kst, long long vsb,
                                long long vsh, long long vst, long long osb,
                                long long osh, long long ost, void* stream) {
  dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  flash_attention_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      Tq, Tk, kv_len, causal, Strides{qsb, qsh, qst}, Strides{ksb, ksh, kst},
      Strides{vsb, vsh, vst}, Strides{osb, osh, ost});
  return static_cast<int>(cudaGetLastError());
}
