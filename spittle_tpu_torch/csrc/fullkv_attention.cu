// Encoder self-attention for Hopper (sm_90a): o = softmax(q k^T) v per
// (batch, head), with a kv_len mask and an optional causal mask. Two
// entries, one instance of the attention core (attention_sm90.cuh: TMA
// loads, wgmma products, a producer warp and two consumer warpgroups that
// overlap one tile's softmax with tensor-core work):
//
//  - K1 spt_fullkv_attention: heads addressed through the caller's
//    (batch, head, time) strides. Replaces spittle_tpu/ops/attention.py
//    :206 flash_attention_fullkv (body _fullkv_kernel).
//  - K1 under autograd, spt_fullkv_attention_lse: the same instance with
//    the core's kLse flag, which also stores each row's log-sum-exp (f32,
//    [B * H, Tq]) for the backward (fullkv_attention_bwd.cu); o's bits are
//    K1's.
//  - K8 spt_fullkv_attention_packed: the packed [B, T, H*64] projection
//    layout (time stride H*64, head stride 64), in and out. Replaces
//    spittle_tpu/ops/attention.py:478 flash_attention_fullkv_packed (body
//    _fullkv_kernel with q_axis=2).
//
// Both launch the same template instance, so K8 gives K1's bits; K5
// (flash_attention.cu) is the same policy and tile, so it gives K1's bits
// on K1's inputs too. (K9, the head-pair form, is the core's HeadPair
// instance in fullkv_attention_pair.cu; K10, fullkv_attention_pipe.cu, is
// the core's persistent kernel on this policy and tile.)
//
// Inputs arrive pre-scaled by Dh^-0.25 (Whisper's split scaling), so no
// scale is applied here.
//
// What bounds it on an H100: at the encoder's shape [8, 20, 1500, 64] a
// call does 4*B*H*T*T*Dh = 92 GFLOP against 31 MB of q, k, v and o (~3,000
// FLOP per byte, ten times the bf16 ridge): 0.093 ms at the tensor cores'
// 989 TFLOP/s. Its 3.6e8 exponentials take 0.092 ms on the
// special-function units (~3.9 T/s), the same floor, which the core's
// overlap is there to share.
//
// Design: the core's SplitRows policy. The TPU kernel keeps a head's whole
// K/V (384 KB at T = 1536) in VMEM and takes one QK^T, one softmax, one
// PV; a Hopper block has at most 227 KB of shared memory, so this is an
// online softmax over 128-key tiles. A block takes 128 query rows of one
// (b, h), warpgroup 0 rows 0-63 and warpgroup 1 rows 64-127, sharing every
// K/V box; grid (ceil(Tq / 128), B * H), one block per SM. Scores stay in
// f32 registers, the mask (col < kv_len, and row >= col on absolute
// indices under `causal`, with no Tk - Tq offset, as on the TPU) goes on
// before the running max with the finite -1e30, P is rounded to bf16 for
// PV where the TPU kernel casts p to v's dtype, l sums the f32 P, and acc
// / l is one division at the end. The TPU kernel takes an unmasked row max
// and masks after exp: the same function, rounded differently. TMA
// zero-fills rows past Tq and Tk inside each head, so nothing is padded in
// device memory; rows past Tq are not stored, and tiles wholly past kv_len
// or above the diagonal are skipped. At Tk = 1500 a row walks only 12 key
// tiles, so the ring's depth matters less than for K5's 47: kStages was
// chosen on an H100 among 3, 4 and 5 (probes/fullkv_stages.py builds a
// copy of this file at each depth and times the three in turns). They came
// within 1% of each other at [8, 20, 1500, 64] and [8, 20, 256, 64], 3
// the fastest at both; Q and three stages of K + V take 112 KB.
#include "attention_sm90.cuh"

namespace {

constexpr int kStages = 3;

}  // namespace

// K1. q, o [B, H, Tq, 64] and k, v [B, H, Tk, 64] bf16 through (batch,
// head, time) strides in elements, each a multiple of 8, data 16-byte
// aligned; the head dim is contiguous in all four. 1 <= kv_len <= Tk; any
// Tq and Tk; B * H <= 65535 (the grid's y axis).
SPT_API int spt_fullkv_attention(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int Tq, int Tk,
                                 int kv_len, int causal, long long qsb,
                                 long long qsh, long long qst, long long ksb,
                                 long long ksh, long long kst, long long vsb,
                                 long long vsh, long long vst, long long osb,
                                 long long osh, long long ost, void* stream) {
  using namespace spt::sm90;
  const long long qs[3] = {qsb, qsh, qst}, ks[3] = {ksb, ksh, kst},
                  vs[3] = {vsb, vsh, vst};
  const Params p{H, Tq, Tk, kv_len, causal, osb, osh, ost};
  return launch<SplitRows, 128, kStages>(q, k, v, o, B, p, qs, ks, vs, stream);
}

// K1 with each row's log-sum-exp: spt_fullkv_attention's arguments and
// lse, f32 [B * H, Tq] contiguous, where row t of head (b, h) gets
// ln(sum over its kept keys of exp(s)) at (b * H + h) * Tq + t.
SPT_API int spt_fullkv_attention_lse(const void* q, const void* k,
                                     const void* v, void* o, void* lse, int B,
                                     int H, int Tq, int Tk, int kv_len,
                                     int causal, long long qsb, long long qsh,
                                     long long qst, long long ksb,
                                     long long ksh, long long kst,
                                     long long vsb, long long vsh,
                                     long long vst, long long osb,
                                     long long osh, long long ost,
                                     void* stream) {
  using namespace spt::sm90;
  const long long qs[3] = {qsb, qsh, qst}, ks[3] = {ksb, ksh, kst},
                  vs[3] = {vsb, vsh, vst};
  const Params p{H,   Tq,  Tk,  kv_len, causal,
                 osb, osh, ost, static_cast<float*>(lse)};
  return launch<SplitRows, 128, kStages, true>(q, k, v, o, B, p, qs, ks, vs,
                                               stream);
}

// K8. q, o contiguous [B, Tq, H*64]; k, v contiguous [B, Tk, H*64];
// B * H <= 65535 (the grid's y axis).
SPT_API int spt_fullkv_attention_packed(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int Tq, int Tk, int kv_len,
                                        int causal, void* stream) {
  using namespace spt::sm90;
  // Heads of the packed layout: time stride H*64, head stride 64.
  const long long row = static_cast<long long>(H) * kD;
  const long long qs[3] = {Tq * row, kD, row}, ks[3] = {Tk * row, kD, row};
  const Params p{H, Tq, Tk, kv_len, causal, Tq * row, kD, row};
  return launch<SplitRows, 128, kStages>(q, k, v, o, B, p, qs, ks, ks, stream);
}
