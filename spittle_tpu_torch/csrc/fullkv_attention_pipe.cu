// Software-pipelined encoder self-attention for Hopper (sm_90a), K10:
// K1's function (fullkv_attention.cu) for non-causal calls, on a body of
// its own (mma.sync, 64-key tiles; K1 is an instance of the TMA + wgmma
// attention core), with the copy of the next K/V tiles and the next
// tile's QK^T overlapped with the current tile's softmax and PV.
//
// Replaces the TPU kernel spittle_tpu/ops/attention.py:
// flash_attention_fullkv_pipe (body _fullkv_pipe_kernel). There, grid step
// i computes q-block i's QK^T (MXU) into one half of a double f32 score
// scratch while q-block i-1's softmax and PV (VPU, MXU) run from the
// other half, so that Mosaic overlaps the matrix unit with the vector unit.
//
// What bounds it on an H100: as K1, the tensor cores' 989 TFLOP/s bf16
// rate (~3,000 FLOP per byte at [8, 20, 1500, 64]: 0.093 ms).
//
// Design: a block of 64 query rows of one head (4 warps x 16 rows, bf16
// mma.sync, online softmax over 64-key tiles, masks before the running
// max, P rounded to bf16 for PV, 1/l after PV), with two changes over a
// synchronous loop of that kind:
//  - K and V tiles go through a two-stage cp.async ring each. At the top
//    of iteration j the block issues the copy of K tile j+2 and V tile
//    j+1, which lands while the whole of iteration j computes; iteration
//    j+1 waits for it. Rows past Tk are zero-filled by the copy.
//  - The scores run one tile ahead: iteration j issues tile j+1's QK^T
//    mma.sync into a second score register set before tile j's exp and
//    PV, so the tensor cores work on the next scores while the SFU
//    exponentiates the current ones (the TPU kernel's double scratch,
//    kept in registers).
// K1 runs 128-key tiles on wgmma, with exp2 and another summation order,
// so K10 is held to K1's tolerance, not K1's bits. wgmma, TMA and warp
// specialisation are later work.
#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kLdh = kD + 8;  // 144-byte smem rows, conflict-free
constexpr int kThreads = 128;
constexpr int kTile = kBKV * kLdh;

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ void cp_async_16_zfill(void* smem, const void* gmem,
                                                  bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// Issue the copy of 64 rows x 64 bf16 from t0 on; rows >= tmax are zeroed
// (their source address is clamped to row 0, and no byte of it is read).
__device__ __forceinline__ void issue_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long st, int t0, int tmax,
                                           int tid) {
#pragma unroll
  for (int ch = tid; ch < kBKV * kD / 8; ch += kThreads) {
    const int r = ch >> 3, cc = (ch & 7) * 8;
    const int t = t0 + r;
    const bool valid = t < tmax;
    cp_async_16_zfill(dst + r * kLdh + cc, src + (valid ? t : 0) * st + cc,
                      valid);
  }
}

// s = q k^T for one 64-key tile: 8 key groups x 4 head-dim steps.
__device__ __forceinline__ void qk_tile(float (&s)[8][4],
                                        const uint32_t (&qf)[4][4],
                                        const __nv_bfloat16* Ks, int g,
                                        int c) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int key = nt * 8 + g, col = kk * 16 + 2 * c;
      uint32_t bfr[2];
      bfr[0] = spt::ld_u32(&Ks[key * kLdh + col]);
      bfr[1] = spt::ld_u32(&Ks[key * kLdh + col + 8]);
      spt::mma_bf16_16816(s[nt], qf[kk], bfr);
    }
  }
}

// One tile's step: kv_len mask, running max and sum, rescale of the
// accumulators, P rounded to bf16, PV.
__device__ __forceinline__ void softmax_pv_tile(
    float (&s)[8][4], float (&oacc)[8][4], float (&m_run)[2],
    float (&l_run)[2], const __nv_bfloat16* Vs, int kv0, int kv_len, int g,
    int c) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = kv0 + nt * 8 + 2 * c + (j & 1);
      if (col >= kv_len) s[nt][j] = -INFINITY;
    }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[hr], mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m_run[hr] - m_use);
    float rs = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[nt][2 * hr + j] - m_use);
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

#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = spt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = spt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = spt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = spt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const int key = kk * 16 + 2 * c;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int d = dt * 8 + g;
      uint32_t bfr[2];
      bfr[0] = spt::pack_bf16_raw(Vs[key * kLdh + d], Vs[(key + 1) * kLdh + d]);
      bfr[1] = spt::pack_bf16_raw(Vs[(key + 8) * kLdh + d],
                                  Vs[(key + 9) * kLdh + d]);
      spt::mma_bf16_16816(oacc[dt], pa, bfr);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fullkv_attention_pipe_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 __nv_bfloat16* __restrict__ o, int H, int Tq,
                                 int Tk, int kv_len, Strides qs, Strides ks,
                                 Strides vs, Strides os) {
  // Two K stages and two V stages (36 KB); the Q tile borrows K stage 1,
  // which the first copy of a K tile into it (tile 1) follows.
  __shared__ __align__(16) __nv_bfloat16 smem[4 * kTile];
  auto k_stage = [&](int i) { return smem + (i & 1) * kTile; };
  auto v_stage = [&](int i) { return smem + (2 + (i & 1)) * kTile; };
  __nv_bfloat16* Qs = k_stage(1);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBQ;
  q += b * qs.b + h * qs.h;
  k += b * ks.b + h * ks.h;
  v += b * vs.b + h * vs.h;
  o += b * os.b + h * os.h;
  const int n = (kv_len + kBKV - 1) / kBKV;

  // Prologue: {Q, K0, V0} then Q's fragments and tile 0's scores.
  issue_tile(Qs, q, qs.t, q0, Tq, tid);
  issue_tile(k_stage(0), k, ks.t, 0, Tk, tid);
  issue_tile(v_stage(0), v, vs.t, 0, Tk, tid);
  spt::cp_async_commit();
  spt::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r = warp * 16 + g, col = kk * 16 + 2 * c;
    qf[kk][0] = spt::ld_u32(&Qs[r * kLdh + col]);
    qf[kk][1] = spt::ld_u32(&Qs[(r + 8) * kLdh + col]);
    qf[kk][2] = spt::ld_u32(&Qs[r * kLdh + col + 8]);
    qf[kk][3] = spt::ld_u32(&Qs[(r + 8) * kLdh + col + 8]);
  }
  float s_cur[8][4];
  qk_tile(s_cur, qf, k_stage(0), g, c);
  __syncthreads();  // Q read by every warp: K stage 1 is free
  if (n > 1) issue_tile(k_stage(1), k, ks.t, kBKV, Tk, tid);
  spt::cp_async_commit();

  float oacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n; ++j) {
    // K tile j+1 and V tile j have landed, and every warp is past
    // iteration j-1: K stage j%2 (tile j, scored in iteration j-1) and V
    // stage (j+1)%2 (tile j-1) are free.
    spt::cp_async_wait<0>();
    __syncthreads();
    if (j + 2 < n) issue_tile(k_stage(j), k, ks.t, (j + 2) * kBKV, Tk, tid);
    if (j + 1 < n)
      issue_tile(v_stage(j + 1), v, vs.t, (j + 1) * kBKV, Tk, tid);
    spt::cp_async_commit();

    float s_next[8][4];
    if (j + 1 < n) qk_tile(s_next, qf, k_stage(j + 1), g, c);
    softmax_pv_tile(s_cur, oacc, m_run, l_run, v_stage(j), j * kBKV, kv_len,
                    g, c);
    if (j + 1 < n) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s_cur[nt][i] = s_next[nt][i];
    }
  }

  const int row_base = q0 + warp * 16 + g;
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

// Non-causal only. Strides are in elements; the head dim is contiguous.
SPT_API int spt_fullkv_attention_pipe(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Tq,
    int Tk, int kv_len, long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, long long osb, long long osh, long long ost, void* stream) {
  dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  fullkv_attention_pipe_kernel<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      Tq, Tk, kv_len, Strides{qsb, qsh, qst}, Strides{ksb, ksh, kst},
      Strides{vsb, vsh, vst}, Strides{osb, osh, ost});
  return static_cast<int>(cudaGetLastError());
}
