// Pipelined encoder self-attention for Hopper (sm_90a), K10: K1's function
// (fullkv_attention.cu) for non-causal calls, on the persistent instance
// of the attention core (attention_sm90.cuh:
// attention_sm90_persistent_kernel: TMA loads, wgmma products, a producer
// warp and two consumer warpgroups).
//
// Replaces the TPU kernel spittle_tpu/ops/attention.py:
// flash_attention_fullkv_pipe (body _fullkv_pipe_kernel). There, grid step
// i computes q-block i's QK^T (MXU) into one half of a double f32 score
// scratch while q-block i-1's softmax and PV (VPU, MXU) run from the
// other half, and the grid is flattened to bh * nq + 1 steps, so the
// pipeline crosses (b, h) boundaries.
//
// What bounds it on an H100: as K1, at [8, 20, 1500, 64] 92 GFLOP at the
// tensor cores' 989 TFLOP/s (0.093 ms), and as many exponentials on the
// special-function units (~3.9 T/s: 0.092 ms), the two floors that the
// core's overlap shares.
//
// Design: inside one (q block, head), the core already issues S_{j+1}
// before PV_j. What K1's grid of one block per item cannot overlap is
// each item's ends: the Q load, tile 0's scores and softmax, and the last
// PV with the epilogue; at Tk 1500 a row walks only 12 key tiles, so these
// weigh four times as much as in K5's 47. The Hopper form of the TPU
// kernel's cross-item pipeline is a persistent grid: min(SMs, items)
// blocks, each walking K1's work items (128 query rows of one (b, h)) in
// K1's order with a stride of the grid, its K/V ring and barrier phases
// running on from one item into the next, the next item's Q in a second
// buffer, and each item's last PV issued in one turn with the next item's
// first QK^T, whose latency the epilogue hides. Each row walks the same
// 128-key tiles in the same order through the same steps as in K1, so
// K10 gives K1's bits. Shared memory: two Q buffers of 16 KB and three
// stages of K + V at 32 KB (K1's depth): 128 KB, one block per SM.
#include "attention_sm90.cuh"

namespace {

constexpr int kStages = 3;

}  // namespace

// K10. q, o [B, H, Tq, 64] and k, v [B, H, Tk, 64] bf16 through (batch,
// head, time) strides in elements, each a multiple of 8, data 16-byte
// aligned; the head dim is contiguous in all four. 1 <= kv_len <= Tk; any
// Tq and Tk; ceil(Tq / 128) * B * H below 2^31. num_sms: the card's SM
// count, the grid's size.
SPT_API int spt_fullkv_attention_pipe(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Tq,
    int Tk, int kv_len, int num_sms, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, long long osb, long long osh, long long ost,
    void* stream) {
  using namespace spt::sm90;
  const long long qs[3] = {qsb, qsh, qst}, ks[3] = {ksb, ksh, kst},
                  vs[3] = {vsb, vsh, vst};
  const Params p{H, Tq, Tk, kv_len, 0, osb, osh, ost};
  return launch_persistent<SplitRows, 128, kStages>(q, k, v, o, B, p, qs, ks,
                                                    vs, num_sms, stream);
}
