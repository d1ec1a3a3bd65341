// Encoder self-attention over head pairs for Hopper (sm_90a), K9: o =
// softmax(q k^T) v per (batch, head) on the packed [B, T, H*64]
// projections, two adjacent heads per block, with a kv_len mask and an
// optional causal mask. An instance of the attention core
// (attention_sm90.cuh: TMA loads, wgmma products, a producer warp and two
// consumer warpgroups that overlap one tile's softmax with tensor-core
// work).
//
// Replaces spittle_tpu/ops/attention.py:flash_attention_fullkv_packed_pair
// (body _fullkv_pair_kernel), the encoder attention of
// SPITTLE_PACKED_ATTENTION=pair ("pair" here). Inputs arrive pre-scaled by
// Dh^-0.25, so no scale is applied here.
//
// What bounds it on an H100: at [8, 20, 1500, 64] a call does 92 GFLOP
// against 31 MB of q, k, v and o: 0.093 ms at the tensor cores' 989
// TFLOP/s, and its 3.6e8 exponentials take 0.092 ms on the
// special-function units (~3.9 T/s), the same floor, which the core's
// overlap is there to share.
//
// Design: the core's HeadPair policy, the TPU kernel's split of its
// 128-lane block into two heads. A block takes 64 query rows of heads h0
// and h0 + 1: warpgroup 0 owns h0, warpgroup 1 owns h0 + 1. A tile row of
// the pair is 256 contiguous bytes; it is loaded as two 64-column boxes
// (a 128-byte-swizzled box is at most 128 bytes wide), and each warpgroup
// reads its own head's box. Grid (ceil(Tq / 64), B * H / 2). Key tiles of
// BK = 128: a stage of both heads' K + V is 64 KB, so three stages and Q's
// 16 KB take 208 KB, one block per SM; 128 keys per tile halve the
// rescales and barrier rounds of 64. The TPU kernel holds a head's whole
// K/V in VMEM and takes one softmax; here an online softmax, the mask
// before the running max with the finite -1e30, P rounded to bf16 for PV,
// l summing the f32 P and one division acc / l at the end: K1's function.
// K1 is the core's SplitRows instance with the same 128-key tiles, so each
// row takes the same steps, except that a causal block of 64 rows skips
// fully masked tiles that K1's 128-row blocks run; the two are held to
// each other by K1's tolerance. Rows past Tk are zero-filled by TMA inside
// the head and masked; rows past Tq are not stored.
#include "attention_sm90.cuh"

// K9. q, o contiguous [B, Tq, H*64]; k, v contiguous [B, Tk, H*64]; H even;
// B * H / 2 <= 65535 (the grid's y axis).
SPT_API int spt_fullkv_attention_packed_pair(const void* q, const void* k,
                                             const void* v, void* o, int B,
                                             int H, int Tq, int Tk,
                                             int kv_len, int causal,
                                             void* stream) {
  using namespace spt::sm90;
  // Heads of the packed layout: time stride H*64, head stride 64.
  const long long row = static_cast<long long>(H) * kD;
  const long long qs[3] = {Tq * row, kD, row}, ks[3] = {Tk * row, kD, row};
  const Params p{H, Tq, Tk, kv_len, causal, Tq * row, kD, row};
  return launch<HeadPair, 128, 3>(q, k, v, o, B, p, qs, ks, ks, stream);
}
