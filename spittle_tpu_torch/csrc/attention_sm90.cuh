// The port's attention core for Hopper (sm_90a): o = softmax(q k^T) v for
// a head dim of 64, bf16 in, f32 scores and sums, bf16 out, on TMA loads
// and wgmma products with a producer/consumer split. Written once and
// instantiated per kernel: K1 and K8 (fullkv_attention.cu), K5
// (flash_attention.cu) and K9 (fullkv_attention_pair.cu) on
// attention_sm90_kernel, one block per work item; K10
// (fullkv_attention_pipe.cu) on attention_sm90_persistent_kernel, the same
// steps in at most one block per SM whose pipeline runs on across items.
//
// What bounds it on an H100. Per score a call does 4 * 64 = 256 FLOP of
// tensor-core work (989 TFLOP/s bf16) and one exponential on the
// special-function units (132 SMs x 16 per clock, ~3.9 T/s): 0.26 ns of
// products against 0.26 ns of exponentials per 1,000 scores. The two
// floors are equal at Dh = 64, so a block can come near either only if one
// warpgroup's softmax runs while tensor-core work is already in flight.
//
// Block: three warpgroups (384 threads), one block per SM.
//  - Producer (warpgroup 0, one thread issuing): TMA loads
//    (cp.async.bulk.tensor, 128-byte swizzle, completion on mbarriers). It
//    loads the block's Q once (two 64-row boxes, one per consumer), then
//    streams K and V tiles of BK keys into a ring of kStages stages, each
//    with a full barrier (transaction bytes) and an empty barrier (one
//    arrival per consumer warp). It drops to 24 registers (setmaxnreg.dec)
//    and costs the consumers no registers or instructions for the copies.
//  - Consumers (warpgroups 1 and 2, setmaxnreg.inc to 240): each owns 64
//    query rows of one head. Per key tile j: S = Q K_j^T as four
//    wgmma.m64nBKk16 (A = the Q box, B = the K box, both K-major in shared
//    memory); the mask (col < kv_len, and row >= col on absolute indices
//    under causal) before the max with the finite -1e30; the online softmax
//    with m, alpha and l in registers; P rounded to bf16 and fed from
//    registers as the A operand of BK/16 wgmma.m64n64k16 against the V box,
//    which is stored [key, d] and so read MN-major (transpose bit).
//  - Overlap inside a warpgroup: S_{j+1} is issued, then PV_j, and the
//    warpgroup waits for S_{j+1} alone (wait_group 1), so tile j+1's
//    softmax runs while PV_j is still on the tensor cores; it waits for
//    PV_j (wait_group 0) only before rescaling o and repacking P.
//  - Overlap between warpgroups: the two issue their products in turn on
//    two named barriers (bar.sync / bar.arrive with ids 1 and 2), so one
//    warpgroup's softmax runs under the other's products.
//  - Registers per consumer thread: S (64 x BK f32 over 128 threads) BK/2,
//    P (bf16 pairs) BK/4, the o accumulator 32, m, l, alpha 6, plus
//    addressing: ~155 at BK = 128, inside the 240 that setmaxnreg gives
//    (24 x 128 + 240 x 256 = 64,512 of the SM's 65,536).
//  - Epilogue: one division acc / l per row, bf16, stored only for rows
//    < Tq, straight from registers. The kLse instances (K1 under autograd)
//    also store m + ln(l) per row in f32, which K15 reads.
//
// Exponentials are exp2(s * log2e - m * log2e): one FFMA and ex2.approx.
// The reference takes exp(s - m); the two differ in the last bits of an
// f32 that is rounded to bf16 (8 bits) right after for PV, and l sums the
// f32 values: within the tolerances that already allow exp's last bit.
//
// The policy (template parameter) says which (head, rows) each consumer
// owns and so what the producer's boxes address: SplitRows (two
// warpgroups on rows 0-63 and 64-127 of one head, sharing each K/V box:
// K1, K5 and K8) or HeadPair (both on the same 64 rows of heads h0
// and h0 + 1, each reading its own head's box: K9). The tensor maps are
// rank 4, (d, t, h, b), built per call from the caller's (batch, head,
// time) strides, so head views of a packed projection (time stride H*64,
// head stride 64) and contiguous [B, H, T, 64] tensors both load without
// a copy, and TMA zero-fills rows past T inside the head: no other head's
// values (which may be non-finite) reach a masked column, where 0 * inf
// would be NaN. Host side: cuTensorMapEncodeTiled comes from the driver
// through cudaGetDriverEntryPoint, so the library links only cudart.
#pragma once

#include "sm90.cuh"

namespace spt {
namespace sm90 {

constexpr int kD = 64;             // head dim: one 128-byte swizzle row
constexpr int kRowsPerWg = 64;     // query rows per consumer warpgroup
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kRowBytes = kD * 2;  // bytes per tile row
constexpr int kQBoxBytes = kRowsPerWg * kRowBytes;
constexpr float kNegBig = -1e30f;  // the reference's finite mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSchedBar = 1;       // named barriers 1, 2 (0 is __syncthreads)

// Which (head, rows) each consumer warpgroup w (0, 1) owns: head h0 + w *
// kHeadStep, rows q0 + w * kRowStep .. + 63.
template <int kHeadStep, int kRowStep>
struct Policy {
  static_assert((kHeadStep == 1 && kRowStep == 0) ||
                    (kHeadStep == 0 && kRowStep == kRowsPerWg),
                "two warpgroups split either the rows or the heads");
  static constexpr int kHeadSteps = kHeadStep;
  static constexpr int kRowSteps = kRowStep;
  static constexpr int kHeadsPerBlock = 1 + kHeadStep;
  static constexpr int kRowsPerBlock = kRowsPerWg + kRowStep;
  static constexpr int kKvBoxes = kHeadsPerBlock;  // K (and V) boxes per stage
};
using SplitRows = Policy<0, kRowsPerWg>;
using HeadPair = Policy<1, 0>;

// Dynamic shared memory: Q (one 8 KB box per consumer), then the stages
// (K boxes, then V boxes), then the barriers. Every box starts on a
// 1024-byte boundary, as the 128-byte swizzle needs.
template <class P, int BK, int kStages>
struct Layout {
  static constexpr int kQBytes = 2 * kQBoxBytes;
  static constexpr int kBoxBytes = BK * kRowBytes;
  static constexpr int kStageBytes = 2 * P::kKvBoxes * kBoxBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBarOffset + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

struct Params {
  int H, Tq, Tk, kv_len, causal;
  long long osb, osh, ost;  // output strides in elements (d contiguous)
  float* lse;  // [B * H, Tq] f32: each row's log-sum-exp (kLse instances)
};

// ---------------------------------------------------------------------------
// bf16 products and exponentials
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory
// (K-major, 128-byte swizzle); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (the m16n8k16
// A fragment of each warp's 16 rows), B from shared memory MN-major
// (128-byte swizzle, transpose bit set); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// The consumer's steps
// ---------------------------------------------------------------------------

// S = Q K^T over the head dim: four k-steps of 16. Both instances take
// 128-key tiles, so only the n128 form of the shared-memory wgmma exists.
template <int BK>
__device__ __forceinline__ void issue_scores(float* s, uint64_t dq,
                                             uint32_t k_box) {
  static_assert(BK == 128, "the scores' wgmma is m64n128k16");
  const uint64_t dk = desc_sw128(k_box);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_ss_n128(s, dq + 2 * kk, dk + 2 * kk, kk);
}

// acc += P V: BK/16 k-steps of 16 keys; P's k-step kk is pa[4kk..4kk+3],
// V's is 16 rows (2048 bytes) further into the box.
template <int BK>
__device__ __forceinline__ void issue_pv(float* acc, const uint32_t* pa,
                                         uint32_t v_box) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs_n64(acc, pa + 4 * kk, desc_sw128(v_box + kk * 16 * kRowBytes), 1);
}

// One tile of the online softmax, in the reference's order. s holds this
// thread's scores in the wgmma accumulator layout: s[i] is row row0 + 8 *
// ((i >> 1) & 1), key kv0 + 8 * (i >> 2) + 2c + (i & 1). On return s holds
// p = exp(s - m'), alpha[hr] = exp(m - m'), and l (this thread's share of
// each row's sum) is l * alpha + sum p.
template <int BK>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l,
                                             float* alpha, int kv0, int row0,
                                             int c, const Params& p) {
  if (kv0 + BK > p.kv_len || (p.causal && kv0 + BK - 1 > row0)) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = kv0 + (i >> 2) * 8 + 2 * c + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      if (col >= p.kv_len || (p.causal && col > row)) s[i] = kNegBig;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    // Column 0 is live for every row, so m is a real score from the first
    // tile on and a masked p is exp2(-1.4e30) = 0 exactly.
    float mx = m[hr];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
      mx = fmaxf(mx, fmaxf(s[4 * nb + 2 * hr], s[4 * nb + 2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float ml = mx * kLog2e;
    alpha[hr] = ex2(fmaf(m[hr], kLog2e, -ml));
    m[hr] = mx;
    float rs = 0.f;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = ex2(fmaf(s[4 * nb + 2 * hr + e], kLog2e, -ml));
        s[4 * nb + 2 * hr + e] = pe;
        rs += pe;
      }
    l[hr] = l[hr] * alpha[hr] + rs;
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Grid (q blocks, B * H / heads per block): the q blocks of one head group
// run side by side and share its K/V in L2. kLse: the epilogue also stores
// each row's log-sum-exp, m + ln(l), in f32 to p.lse (K1 under autograd,
// for its backward K15); the o it stores is the same either way.
template <class P, int BK, int kStages, bool kLse = false>
__global__ void __launch_bounds__(kThreads, 1)
    attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o, const Params p) {
  using L = Layout<P, BK, kStages>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBarOffset;
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto stage = [&](int j) { return base + L::kQBytes + (j % kStages) * L::kStageBytes; };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int groups = p.H / P::kHeadsPerBlock;
  const int b = blockIdx.y / groups;
  const int h0 = blockIdx.y % groups * P::kHeadsPerBlock;
  const int q0 = blockIdx.x * P::kRowsPerBlock;
  // Tiles wholly past kv_len, or wholly above the diagonal under causal,
  // contribute exact zeros and are skipped.
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, q0 + P::kRowsPerBlock);
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int w = 0; w < 2; ++w)
        tma_load_4d(base + w * kQBoxBytes, &tm_q, bar_q, 0,
                    q0 + w * P::kRowSteps, h0 + w * P::kHeadSteps, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty(s), (j / kStages - 1) & 1);
        const uint32_t st = stage(j);
        mbar_expect_tx(full(s), L::kStageBytes);
#pragma unroll
        for (int t = 0; t < P::kKvBoxes; ++t) {
          tma_load_4d(st + t * L::kBoxBytes, &tm_k, full(s), 0, j * BK, h0 + t, b);
          tma_load_4d(st + (P::kKvBoxes + t) * L::kBoxBytes, &tm_v, full(s), 0,
                      j * BK, h0 + t, b);
        }
      }
    }
  } else {
    // ---- consumers ----
    reg_alloc<240>();
    const int w = wg - 1, t = tid & 127;
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, c = lane & 3;
    const int head = h0 + w * P::kHeadSteps;
    const int row0 = q0 + w * P::kRowSteps + warp * 16 + g;  // and row0 + 8
    // This warpgroup's K and V boxes inside a stage (HeadPair: its head's).
    const uint32_t k_off = w * P::kHeadSteps * L::kBoxBytes;
    const uint32_t v_off = (P::kKvBoxes + w * P::kHeadSteps) * L::kBoxBytes;
    const uint64_t dq = desc_sw128(base + w * kQBoxBytes);
    const int own = kSchedBar + w, other = kSchedBar + 1 - w;

    float s[BK / 2], acc[32], m[2], l[2], alpha[2];
    uint32_t pa[BK / 4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) m[hr] = kNegBig, l[hr] = 0.f;

    if (w == 1) named_arrive(kSchedBar);  // warpgroup 0 issues first
    mbar_wait(bar_q, 0);

    // Tile 0: scores and softmax.
    mbar_wait(full(0), 0);
    named_sync(own);
    wgmma_fence();
    issue_scores<BK>(s, dq, stage(0) + k_off);
    wgmma_commit();
    named_arrive(other);
    wgmma_wait<0>();
    fence_regs<BK / 2>(s);
    softmax_tile<BK>(s, m, l, alpha, 0, row0, c, p);
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    for (int j = 1; j < n_tiles; ++j) {
      mbar_wait(full(j % kStages), (j / kStages) & 1);
      named_sync(own);
      wgmma_fence();
      issue_scores<BK>(s, dq, stage(j) + k_off);
      wgmma_commit();
      issue_pv<BK>(acc, pa, stage(j - 1) + v_off);
      wgmma_commit();
      named_arrive(other);
      wgmma_wait<1>();  // S_j is in; PV_{j-1} may still run
      fence_regs<BK / 2>(s);
      softmax_tile<BK>(s, m, l, alpha, j * BK, row0, c, p);
      wgmma_wait<0>();
      fence_regs<32>(acc);
      fence_regs<BK / 4>(pa);
      if (lane == 0) mbar_arrive(empty((j - 1) % kStages));
      // acc_j = acc_{j-1} * alpha_j + P_j V_j, as the reference advances.
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    }

    // The last tile's PV. Warpgroup 1 issues last and signals no one.
    named_sync(own);
    wgmma_fence();
    issue_pv<BK>(acc, pa, stage(n_tiles - 1) + v_off);
    wgmma_commit();
    if (w == 0) named_arrive(other);
    wgmma_wait<0>();
    fence_regs<32>(acc);
    fence_regs<BK / 4>(pa);

    const long long obase = b * p.osb + head * p.osh;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lt = l[hr];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = row0 + hr * 8;
      if (row >= p.Tq) continue;
      __nv_bfloat16* orow = o + obase + row * p.ost;
#pragma unroll
      for (int nb = 0; nb < kD / 8; ++nb)
        *reinterpret_cast<uint32_t*>(orow + nb * 8 + 2 * c) =
            pack_bf16(acc[4 * nb + 2 * hr] / lt, acc[4 * nb + 2 * hr + 1] / lt);
      if constexpr (kLse) {
        if (c == 0)
          p.lse[(static_cast<long long>(b) * p.H + head) * p.Tq + row] =
              m[hr] + logf(lt);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The persistent kernel
// ---------------------------------------------------------------------------

// Shared memory of the persistent kernel: two Q buffers (one item's Q and
// the next one's), the stages, then the barriers: Q full and Q empty per
// buffer, full and empty per stage.
template <class P, int BK, int kStages>
struct PersistentLayout {
  static constexpr int kQBytes = 2 * kQBoxBytes;  // one buffer
  static constexpr int kBoxBytes = BK * kRowBytes;
  static constexpr int kStageBytes = 2 * P::kKvBoxes * kBoxBytes;
  static constexpr int kStagesOffset = 2 * kQBytes;
  static constexpr int kBarOffset = kStagesOffset + kStages * kStageBytes;
  static constexpr int kBytes = kBarOffset + (4 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

// A work item of the persistent kernel: the block that
// attention_sm90_kernel runs at grid (x, y), numbered y * nq + x, so the
// q blocks of one head group stay adjacent.
struct Item {
  int b, h0, q0, n_tiles;
};

template <class P, int BK>
__device__ __forceinline__ Item item_at(int i, int nq, const Params& p) {
  const int groups = p.H / P::kHeadsPerBlock;
  Item it;
  it.b = i / nq / groups;
  it.h0 = i / nq % groups * P::kHeadsPerBlock;
  it.q0 = i % nq * P::kRowsPerBlock;
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, it.q0 + P::kRowsPerBlock);
  it.n_tiles = (kv_end + BK - 1) / BK;
  return it;
}

// The same function and the same per-row steps as attention_sm90_kernel,
// in a grid of at most one block per SM that walks the work items i =
// blockIdx.x, + gridDim.x, ... . The pipeline runs on from one item into
// the next: the ring's tile counter and barrier phases carry over, Q has
// two buffers (the producer loads the next item's Q while the current
// item's tiles are consumed; the consumers release a buffer after the
// item's last Q K^T), and at an item's end each consumer issues its last
// PV and the next item's first Q K^T in one turn, waits for the PV alone
// (wait_group 1), writes the item's rows while the scores run, then takes
// the next item with fresh m, l and acc. The two warpgroups keep their
// turns on the named barriers across items: both walk the same items and
// tiles, so they take the same number of turns.
template <class P, int BK, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
    attention_sm90_persistent_kernel(const __grid_constant__ CUtensorMap tm_q,
                                     const __grid_constant__ CUtensorMap tm_k,
                                     const __grid_constant__ CUtensorMap tm_v,
                                     __nv_bfloat16* __restrict__ o,
                                     const Params p, int n_items) {
  using L = PersistentLayout<P, BK, kStages>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBarOffset;
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 8 * (2 + qb); };
  auto full = [&](int s) { return bars + 8 * (4 + s); };
  auto empty = [&](int s) { return bars + 8 * (4 + kStages + s); };
  auto stage = [&](int g) {
    return base + L::kStagesOffset + (g % kStages) * L::kStageBytes;
  };
  auto q_buf = [&](int n) { return base + (n & 1) * L::kQBytes; };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int nq = (p.Tq + P::kRowsPerBlock - 1) / P::kRowsPerBlock;

  if (tid == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: item n's Q into buffer n % 2, then its K/V tiles ----
    reg_dealloc<24>();
    if (tid == 0) {
      int g = 0;  // tiles loaded so far, across items
      for (int i = blockIdx.x, n = 0; i < n_items; i += gridDim.x, ++n) {
        const Item it = item_at<P, BK>(i, nq, p);
        if (n >= 2) mbar_wait(q_empty(n & 1), ((n >> 1) - 1) & 1);
        mbar_expect_tx(q_full(n & 1), L::kQBytes);
#pragma unroll
        for (int w = 0; w < 2; ++w)
          tma_load_4d(q_buf(n) + w * kQBoxBytes, &tm_q, q_full(n & 1), 0,
                      it.q0 + w * P::kRowSteps, it.h0 + w * P::kHeadSteps, it.b);
        for (int j = 0; j < it.n_tiles; ++j, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(empty(s), (g / kStages - 1) & 1);
          const uint32_t st = stage(g);
          mbar_expect_tx(full(s), L::kStageBytes);
#pragma unroll
          for (int t = 0; t < P::kKvBoxes; ++t) {
            tma_load_4d(st + t * L::kBoxBytes, &tm_k, full(s), 0, j * BK,
                        it.h0 + t, it.b);
            tma_load_4d(st + (P::kKvBoxes + t) * L::kBoxBytes, &tm_v, full(s),
                        0, j * BK, it.h0 + t, it.b);
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    reg_alloc<240>();
    const int w = wg - 1, t = tid & 127;
    const int warp = t >> 5, lane = t & 31, gr = lane >> 2, c = lane & 3;
    const uint32_t k_off = w * P::kHeadSteps * L::kBoxBytes;
    const uint32_t v_off = (P::kKvBoxes + w * P::kHeadSteps) * L::kBoxBytes;
    const int own = kSchedBar + w, other = kSchedBar + 1 - w;

    float s[BK / 2], acc[32], m[2], l[2], alpha[2];
    uint32_t pa[BK / 4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) m[hr] = kNegBig, l[hr] = 0.f;

    int i = blockIdx.x, n = 0, g = 0;  // item, its number here, its tile 0
    Item it = item_at<P, BK>(i, nq, p);
    uint64_t dq = desc_sw128(q_buf(0) + w * kQBoxBytes);

    if (w == 1) named_arrive(kSchedBar);  // warpgroup 0 issues first
    // The first item's tile 0.
    mbar_wait(q_full(0), 0);
    mbar_wait(full(0), 0);
    named_sync(own);
    wgmma_fence();
    issue_scores<BK>(s, dq, stage(0) + k_off);
    wgmma_commit();
    named_arrive(other);
    wgmma_wait<0>();
    fence_regs<BK / 2>(s);

    for (;;) {
      const int head = it.h0 + w * P::kHeadSteps;
      const int row0 = it.q0 + w * P::kRowSteps + warp * 16 + gr;  // and + 8
      softmax_tile<BK>(s, m, l, alpha, 0, row0, c, p);
#pragma unroll
      for (int k = 0; k < BK / 4; ++k) pa[k] = pack_bf16(s[2 * k], s[2 * k + 1]);

      for (int j = 1; j < it.n_tiles; ++j) {
        const int gj = g + j;
        mbar_wait(full(gj % kStages), (gj / kStages) & 1);
        named_sync(own);
        wgmma_fence();
        issue_scores<BK>(s, dq, stage(gj) + k_off);
        wgmma_commit();
        issue_pv<BK>(acc, pa, stage(gj - 1) + v_off);
        wgmma_commit();
        named_arrive(other);
        wgmma_wait<1>();  // S_j is in; PV_{j-1} may still run
        fence_regs<BK / 2>(s);
        softmax_tile<BK>(s, m, l, alpha, j * BK, row0, c, p);
        wgmma_wait<0>();
        fence_regs<32>(acc);
        fence_regs<BK / 4>(pa);
        if (lane == 0) mbar_arrive(empty((gj - 1) % kStages));
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[k] *= alpha[(k >> 1) & 1];
#pragma unroll
        for (int k = 0; k < BK / 4; ++k) pa[k] = pack_bf16(s[2 * k], s[2 * k + 1]);
      }
      // Every Q K^T of this item is done: its Q buffer may take item n + 2's.
      if (lane == 0) mbar_arrive(q_empty(n & 1));

      // The item's last PV and the next item's S_0 in one turn. The last
      // item has no successor: its turn issues S_0 all the same, on the
      // current Q and a stage nothing writes any more, whose scores are
      // dropped, so that no wgmma sits on a branch (ptxas serialises the
      // products of a function that has one). Warpgroup 1's last turn
      // signals no one.
      const int last = g + it.n_tiles - 1;
      const int i_next = i + gridDim.x;
      const bool more = i_next < n_items;
      Item nx = it;
      uint64_t dq_next = dq;
      if (more) {
        nx = item_at<P, BK>(i_next, nq, p);
        dq_next = desc_sw128(q_buf(n + 1) + w * kQBoxBytes);
        mbar_wait(q_full((n + 1) & 1), ((n + 1) >> 1) & 1);
        mbar_wait(full((last + 1) % kStages), ((last + 1) / kStages) & 1);
      }
      named_sync(own);
      wgmma_fence();
      issue_pv<BK>(acc, pa, stage(last) + v_off);
      wgmma_commit();
      issue_scores<BK>(s, dq_next, stage(last + 1) + k_off);
      wgmma_commit();
      if (more || w == 0) named_arrive(other);
      wgmma_wait<1>();  // the PV is in; the next S_0 may still run
      fence_regs<32>(acc);
      fence_regs<BK / 4>(pa);
      if (lane == 0) mbar_arrive(empty(last % kStages));

      const long long obase = it.b * p.osb + head * p.osh;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float lt = l[hr];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const int row = row0 + hr * 8;
        if (row >= p.Tq) continue;
        __nv_bfloat16* orow = o + obase + row * p.ost;
#pragma unroll
        for (int nb = 0; nb < kD / 8; ++nb)
          *reinterpret_cast<uint32_t*>(orow + nb * 8 + 2 * c) =
              pack_bf16(acc[4 * nb + 2 * hr] / lt, acc[4 * nb + 2 * hr + 1] / lt);
      }

      // The next item starts from fresh row state.
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) l[hr] = 0.f, m[hr] = kNegBig;
      wgmma_wait<0>();
      fence_regs<BK / 2>(s);
      if (!more) break;
      i = i_next, ++n, g = last + 1, it = nx, dq = dq_next;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A rank-4 map (d, t, h, b) over bf16 with d contiguous: `rows` x 64 boxes,
// 128-byte swizzle, rows past T filled with zeros. Strides in elements.
// Returns 0, or an entry return code.
inline int encode_bhtd(CUtensorMap* map, const void* ptr, int B, int H, int T,
                       long long sb, long long sh, long long st, int rows) {
  const EncodeTiledFn enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kD),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

// q, o: [B, H, Tq, 64] and k, v: [B, H, Tk, 64] through (batch, head,
// time) strides in elements. Encodes the maps, raises the kernel's
// dynamic shared memory limit once, launches; returns 0 or an error code.
// Grid (query blocks, B * head groups): the query blocks of one head are
// adjacent, so they run side by side and share its K/V in L2; CUDA caps
// the y axis, so B * H / kHeadsPerBlock <= 65535 (the wrappers check).
// The three maps of a call: Q in 64-row boxes, K and V in BK-row boxes.
inline int encode_qkv(CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv,
                      const void* q, const void* k, const void* v, int B,
                      const Params& p, const long long* qs,
                      const long long* ks, const long long* vs, int BK) {
  int err = encode_bhtd(mq, q, B, p.H, p.Tq, qs[0], qs[1], qs[2], kRowsPerWg);
  if (err == 0) err = encode_bhtd(mk, k, B, p.H, p.Tk, ks[0], ks[1], ks[2], BK);
  if (err == 0) err = encode_bhtd(mv, v, B, p.H, p.Tk, vs[0], vs[1], vs[2], BK);
  return err;
}

template <class P, int BK, int kStages, bool kLse = false>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           const Params& p, const long long* qs, const long long* ks,
           const long long* vs, void* stream) {
  CUtensorMap mq, mk, mv;
  const int err = encode_qkv(&mq, &mk, &mv, q, k, v, B, p, qs, ks, vs, BK);
  if (err != 0) return err;
  constexpr int kSmem = Layout<P, BK, kStages>::kAlloc;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_sm90_kernel<P, BK, kStages, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const dim3 grid((p.Tq + P::kRowsPerBlock - 1) / P::kRowsPerBlock,
                  B * (p.H / P::kHeadsPerBlock));
  attention_sm90_kernel<P, BK, kStages, kLse>
      <<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
          mq, mk, mv, static_cast<__nv_bfloat16*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

// The persistent kernel over the same operands: min(num_sms, items) blocks
// of one per SM, where an item is one block of `launch`'s grid. Items are
// counted in an int, so ceil(Tq / rows per block) * B * H / heads per
// block must stay below 2^31; no grid axis caps B * H.
template <class P, int BK, int kStages>
int launch_persistent(const void* q, const void* k, const void* v, void* o,
                      int B, const Params& p, const long long* qs,
                      const long long* ks, const long long* vs, int num_sms,
                      void* stream) {
  const long long nq = (p.Tq + P::kRowsPerBlock - 1) / P::kRowsPerBlock;
  const long long items = nq * B * (p.H / P::kHeadsPerBlock);
  if (items > 0x7fffffffLL || num_sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  const int err = encode_qkv(&mq, &mk, &mv, q, k, v, B, p, qs, ks, vs, BK);
  if (err != 0) return err;
  constexpr int kSmem = PersistentLayout<P, BK, kStages>::kAlloc;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_sm90_persistent_kernel<P, BK, kStages>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const int grid = static_cast<int>(items < num_sms ? items : num_sms);
  attention_sm90_persistent_kernel<P, BK, kStages>
      <<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
          mq, mk, mv, static_cast<__nv_bfloat16*>(o), p,
          static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace spt
