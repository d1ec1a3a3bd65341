// The combine pass of the split-T decode cross-attention kernel
// (decode_cross_attention_mh.cu: K3, K4, K6 and K11). Each work item of
// that kernel writes one partial record per (b, h, chunk of positions,
// query row): its unnormalised o[64], then its chunk's max m and its sum
// l, over f32 scratch [B*H, nchunks, R, 66]. This pass rescales the
// chunks by exp(m_c - m) and divides by l, a second launch after each.
// The kernel has internal linkage, one copy per source that includes it.
#pragma once

#include "common.cuh"

namespace spt {
namespace decode_cross {

constexpr int kD = 64;
constexpr int kMaxR = 8;
constexpr int kRec = kD + 2;  // partial record: o[64], m, l

// One block per (b, h), one thread per (r, d): o = sum_c o_c e^(m_c - m)
// / sum_c l_c e^(m_c - m), rounded to bf16.
static __global__ void __launch_bounds__(kMaxR * kD)
    decode_cross_q_combine(const float* __restrict__ part,
                           __nv_bfloat16* __restrict__ o, int H, int R,
                           int nchunks, long long osb, long long osh,
                           long long osr) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r = threadIdx.x / kD, d = threadIdx.x % kD;
  if (r >= R) return;
  const float* rec = part + static_cast<size_t>(bh) * nchunks * R * kRec;
  float m = -INFINITY;
  for (int c = 0; c < nchunks; ++c)
    m = fmaxf(m, rec[(c * R + r) * kRec + kD]);
  float acc = 0.f, l = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const float* x = rec + (c * R + r) * kRec;
    const float w = expf(x[kD] - m);
    acc = fmaf(x[d], w, acc);
    l = fmaf(x[kD + 1], w, l);
  }
  o[b * osb + h * osh + r * osr + d] = __float2bfloat16_rn(acc / l);
}

}  // namespace decode_cross
}  // namespace spt
