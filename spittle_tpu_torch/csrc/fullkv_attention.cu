// Encoder self-attention for Hopper (sm_90a): o = softmax(q k^T) v per
// (batch, head), with a kv_len mask and an optional causal mask. Two
// instances of one body:
//
//  - K1 spt_fullkv_attention: heads addressed through (batch, head, time)
//    strides. Replaces spittle_tpu/ops/attention.py:flash_attention_fullkv
//    (body _fullkv_kernel).
//  - K8 spt_fullkv_attention_packed: the packed [B, T, H*64] projection
//    layout fixed at compile time (time stride H*64, head stride 64), in
//    and out. Replaces flash_attention_fullkv_packed (body _fullkv_kernel
//    with q_axis=2).
//
// (K9, the head-pair form, is an instance of the attention core in
// fullkv_attention_pair.cu.)
//
// Inputs arrive pre-scaled by Dh^-0.25 (Whisper's split scaling), so no
// scale is applied here.
//
// What bounds it on an H100: at the encoder's shape (T = 1500, Dh = 64)
// each (b, h) does 4*T*T*Dh FLOP against 4*T*Dh*2 bytes of q, k, v and o:
// ~1,500 FLOP per byte, far above the bf16 ridge (~295), so the bound is
// the tensor cores' 989 TFLOP/s bf16 rate.
//
// Design: the TPU kernel keeps the whole K/V of a head (384 KB in bf16 at
// T = 1536) in VMEM and does one big QK^T, one softmax, one PV. A Hopper
// block has at most 227 KB of shared memory, so this is an online-softmax
// (FlashAttention-2 style) loop instead: a block owns 64 query rows of
// one head (4 warps x 16 rows), holds them as bf16 mma.sync A fragments
// in registers, and streams K/V in 64-key tiles through shared memory.
// Scores stay in f32 registers; P is rounded to bf16 for the PV product
// exactly where the TPU kernel casts p to v's dtype, and the row sums l
// accumulate the f32 P. 1/l is applied after
// PV, as on the TPU. The ragged edge (1500 is not a multiple of 64) is
// masked in the kernel against kv_len; rows past Tk are zero-filled in
// shared memory, so nothing is padded in device memory. The TPU kernel
// takes an unmasked row max and masks after exp; the online loop masks
// before the running max: the same function, rounded differently. The
// causal mask is row >= col on absolute indices, as on the TPU.
// cp.async pipelining is K10 (fullkv_attention_pipe.cu); TMA and wgmma
// are the attention core's (attention_sm90.cuh).
#include "common.cuh"

namespace {

constexpr int kD = 64;   // head dim
constexpr int kBQ = 64;  // query rows per block (4 warps x 16)
constexpr int kBKV = 64; // keys per tile
constexpr int kLdh = kD + 8;  // 144-byte rows: conflict-free fragment loads

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long st, int t0, int tmax,
                                          int tid) {
  // 64 rows x 64 bf16 in 16-byte chunks (8 per row); rows >= tmax are
  // zeroed.
#pragma unroll
  for (int ch = tid; ch < kBKV << 3; ch += 128) {
    const int r = ch >> 3, cc = (ch & 7) * 8;
    const int t = t0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < tmax) v = *reinterpret_cast<const uint4*>(src + t * st + cc);
    *reinterpret_cast<uint4*>(dst + r * kLdh + cc) = v;
  }
}

// kPacked: q/k/v/o are [B, T, H*64] tensors and the strides below are
// derived from H, Tq and Tk; otherwise they come from the arguments.
template <bool kPacked>
__global__ void __launch_bounds__(128)
    fullkv_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int H, int Tq,
                            int Tk, int kv_len, int causal, Strides qs,
                            Strides ks, Strides vs, Strides os) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kBQ * kLdh];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBKV * kLdh];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBKV * kLdh];

  if (kPacked) {
    const long long row = static_cast<long long>(H) * kD;
    qs = Strides{Tq * row, kD, row};
    os = qs;
    ks = Strides{Tk * row, kD, row};
    vs = ks;
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  q += b * qs.b + h * qs.h;
  k += b * ks.b + h * ks.h;
  v += b * vs.b + h * vs.h;
  o += b * os.b + h * os.h;

  load_tile(Qs, q, qs.t, q0, Tq, tid);
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

  float oacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row_base = q0 + warp * 16 + g;  // rows row_base, row_base + 8

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_len, q0 + kBQ);
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBKV) {
    __syncthreads();  // every warp is done with the previous tile (and Q)
    load_tile(Ks, k, ks.t, kv0, Tk, tid);
    load_tile(Vs, v, vs.t, kv0, Tk, tid);
    __syncthreads();

    float s[8][4];
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

#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + nt * 8 + 2 * c + (j & 1);
        const int row = row_base + (j >> 1) * 8;
        if (col >= kv_len || (causal && col > row)) s[nt][j] = -INFINITY;
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
      // A row with every key masked so far keeps m = -inf; exponentiate
      // against 0 then so that its p stays 0 instead of NaN.
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

template <bool kPacked>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Tq, int Tk, int kv_len, int causal, Strides qs, Strides ks,
           Strides vs, Strides os, void* stream) {
  dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  fullkv_attention_kernel<kPacked>
      <<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), H, Tq, Tk, kv_len, causal, qs, ks,
          vs, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. Strides are in elements; the head dim is contiguous (stride 1) in
// all four tensors.
SPT_API int spt_fullkv_attention(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int Tq, int Tk,
                                 int kv_len, int causal, long long qsb,
                                 long long qsh, long long qst, long long ksb,
                                 long long ksh, long long kst, long long vsb,
                                 long long vsh, long long vst, long long osb,
                                 long long osh, long long ost, void* stream) {
  return launch<false>(q, k, v, o, B, H, Tq, Tk, kv_len, causal,
                       Strides{qsb, qsh, qst}, Strides{ksb, ksh, kst},
                       Strides{vsb, vsh, vst}, Strides{osb, osh, ost},
                       stream);
}

// K8. q, o contiguous [B, Tq, H*64]; k, v contiguous [B, Tk, H*64].
SPT_API int spt_fullkv_attention_packed(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int Tq, int Tk, int kv_len,
                                        int causal, void* stream) {
  const Strides none{0, 0, 0};
  return launch<true>(q, k, v, o, B, H, Tq, Tk, kv_len, causal, none, none,
                      none, none, stream);
}
