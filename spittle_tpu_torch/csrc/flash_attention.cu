// Tiled online-softmax attention for Hopper (sm_90a), K5: o = softmax(q
// k^T) v per (batch, head) for K/V of any length, with a kv_len mask and
// an optional causal mask. An instance of the attention core
// (attention_sm90.cuh: TMA loads, wgmma products, a producer warp and two
// consumer warpgroups that overlap one tile's softmax with tensor-core
// work).
//
// Replaces spittle_tpu/ops/attention.py:flash_attention (body
// _flash_kernel), the kernel the reference's dispatcher takes for K/V
// longer than 4096 positions: a long-window model's encoder
// self-attention. Inputs arrive pre-scaled (Whisper's split Dh^-0.25), so
// no scale is applied here.
//
// What bounds it on an H100: at [2, 20, 6000, 64] a call does 4*B*H*Tq*Tk*Dh
// = 369 GFLOP against 123 MB of q, k, v and o (~3,000 FLOP per byte, ten
// times the bf16 ridge): 0.373 ms at the tensor cores' 989 TFLOP/s. Its
// 1.44e9 exponentials take 0.37 ms on the special-function units (~3.9
// T/s), the same floor, which the core's overlap is there to share.
//
// Design: the core's SplitRows policy. A block takes 128 query rows of one
// (b, h), warpgroup 0 rows 0-63 and warpgroup 1 rows 64-127, sharing every
// K/V box; grid (ceil(Tq / 128), B * H). Key tiles are the reference's
// block_k = 128, so every row's m, alpha = exp(m - m') and l advance at the
// same keys as on the TPU: the mask (col < kv_len, and row >= col on
// absolute indices under `causal`, with no Tk - Tq offset) goes on before
// the max with the finite -1e30, P is rounded to bf16 for PV, l sums the
// f32 P, and acc / l is one division at the end. The TPU grid carries m, l
// and acc in VMEM scratch across its sequential key axis; here they never
// leave registers. The reference pads q and K/V to multiples of 128 in
// device memory and slices the result; here TMA zero-fills rows past Tq and
// Tk inside each head, rows past Tq are not stored, and tiles wholly past
// kv_len or above the diagonal are skipped. Shared memory: Q 16 KB and
// four stages of K + V at 32 KB: 144 KB, one block per SM.
#include "attention_sm90.cuh"

// K5. q, o [B, H, Tq, 64] and k, v [B, H, Tk, 64] bf16 through (batch,
// head, time) strides in elements, each a multiple of 8, data 16-byte
// aligned; the head dim is contiguous in all four. 1 <= kv_len <= Tk; any
// Tq and Tk; B * H <= 65535 (the grid's y axis).
SPT_API int spt_flash_attention(const void* q, const void* k, const void* v,
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
  return launch<SplitRows, 128, 4>(q, k, v, o, B, p, qs, ks, vs, stream);
}
