// K15: the backward of K1's attention for Hopper (sm_90a). Given q, k, v,
// K1's output o, each row's log-sum-exp lse (which K1's forward stores
// under autograd: spt_fullkv_attention_lse in fullkv_attention.cu) and the
// output's gradient dO, all bf16 [B, H, T, 64] in the strided head views
// K1 takes, it writes dq, dk and dv of o = softmax(q k^T) v with K1's
// masks (col < kv_len; row >= col on absolute indices under `causal`). q
// and k arrive pre-scaled by Dh^-0.25, so no scale is applied here.
//
// It replaces no TPU kernel. The reference defines no custom_vjp around
// its attention: its training gradient (spittle_tpu/train/step.py) is
// XLA's transpose of the attention that spittle_tpu/ops/attention.py
// computes (multihead_attention, attention_reference on the CPU). The
// port has no XLA, so K1 (fullkv_attention.cu) has this kernel as its
// backward in ops/attention.py's autograd Function.
//
// What bounds it on an H100: the gradient needs ~10 * B * H * Tq * Tk * 64
// FLOPs (S, then dV, dP, dQ and dK), 92 * 2.5 = 230 GFLOP at
// [8, 20, 1500, 64] against ~246 MB of q, k, v, o, dO, dq, dk and dv
// (~0.073 ms at 3.35 TB/s): 0.23 ms at the tensor cores' 989 TFLOP/s.
// Each exponential on the special-function units (~3.9 T/s) costs
// 0.092 ms per walk over the 3.6e8 scores at that shape.
//
// Design: two launches on the caller's stream, each shaped like the
// attention core (attention_sm90.cuh): a producer warp issuing TMA loads
// (cp.async.bulk.tensor, 128-byte swizzle) into an mbarrier ring of
// kStages stages, two consumer warpgroups (setmaxnreg) and wgmma products
// with f32 accumulators, on the core's rank-4 (d, t, h, b) tensor maps
// built from the caller's strides. No atomics: each output row is summed
// by one thread in one order, so two calls give the same bits.
//
//  1. rows (one block per (b, h) and 128 query rows, each consumer
//     warpgroup 64 of them): the block loads its Q and dO boxes once; each
//     consumer computes D = rowsum(dO * o) for its rows from global memory
//     (to f32 scratch, for pass 2) and reads lse. K and V tiles of 64 keys
//     stream through the ring. Per tile: S = Q K^T and dP = dO V^T (both
//     operands from shared memory, K-major), P = exp2(S log2e - lse log2e)
//     masked, dS = P (dP - D) rounded to bf16 in registers as the A
//     operand of dQ += dS K (K read MN-major, the transpose bit, as the
//     core's P V reads V). Tile j's S and dP are issued with tile j - 1's
//     dQ product, which runs while tile j's dS is made (the core's
//     overlap: nothing is in flight across the loop's back edge). dq is
//     stored in bf16 from registers.
//  2. columns (one block per (b, h) and 128 keys, each consumer 64 of
//     them): the block loads its K and V boxes once; Q and dO tiles of 64
//     rows stream through the ring, with the rows' lse and D, which the
//     producer warp copies into the stage beside them. Per tile: S^T = K
//     Q^T and dP^T = V dO^T, P^T and dS^T = P^T (dP^T - D) in registers
//     (the accumulator layout is the A fragments' layout), dV += P^T dO and
//     dK += dS^T Q (transpose bit). The dK and dV accumulators leave no
//     registers for a second tile in flight: the other warpgroup's
//     products run under this one's exponentials. Under `causal` the walk
//     starts at the first query tile that sees the block's keys. A block
//     that no row sees (wholly at or past kv_len, or past the last row
//     under `causal`) stores zeros.
//
// Against the bound: 7 products per kept pair (14 units of 2 * 64 FLOP
// against the bound's 10: S and dP are made once in each pass) and 2
// exponentials (a 0.185 ms floor at [8, 20, 1500, 64]). The blocks of
// one (b, h) are adjacent on the grid's x axis, so they run side by side
// and share the streamed tiles in L2. The kernels are built for 384
// threads and one block per SM, which gives ptxas 168 registers a thread
// (setmaxnreg does not raise what it allocates): the consumers' tiles and
// accumulators are sized to fit them without spills (a wgmma whose
// registers do not fit is serialised), so S and dP read both operands
// from shared memory (A fragments in registers cost 16 a box) and the
// columns pass keeps no second tile in flight. The ring's depth (4) and
// where the time goes are measured by probes/fullkv_bwd_parts.py. The
// single-pass form (5 products, 1 exponential, dQ summed in a fixed order
// over key blocks) is the next step past this design. Rows past Tq and
// keys past Tk come in as TMA's zeros and are never stored; P is exactly
// 0 (a select, not a product) outside the masks, so keys at or past
// kv_len get exact zeros.
#include "attention_sm90.cuh"

namespace {

using namespace spt::sm90;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;           // rows or keys per consumer; streamed tile
constexpr int kBlock = 2 * kTile;   // rows (pass 1) or keys (pass 2) per block
constexpr int kBoxBytes = kTile * kRowBytes;
constexpr int kStages = 4;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 40*128 + 232*256 <= 64K

// Shared memory of both passes: the block's two fixed boxes of each of
// two operands (pass 1: Q, dO; pass 2: K, V), then the stages (two boxes
// each: pass 1 K, V; pass 2 Q, dO), then per stage 2 x 64 f32 (pass 2:
// the tile rows' lse * log2e and D), then the barriers: fixed boxes'
// full, then full and empty per stage.
struct BwdLayout {
  static constexpr int kSecondOffset = 2 * kBoxBytes;
  static constexpr int kStagesOffset = 4 * kBoxBytes;
  static constexpr int kStageBytes = 2 * kBoxBytes;
  static constexpr int kRowsOffset = kStagesOffset + kStages * kStageBytes;
  static constexpr int kBarOffset = kRowsOffset + kStages * 2 * kTile * 4;
  static constexpr int kAlloc = kBarOffset + (1 + 2 * kStages) * 8 + 1024;
};

struct Strides {
  long long b, h, t;  // elements
};

__device__ __forceinline__ long long offset(Strides s, int b, int h, int t) {
  return b * s.b + h * s.h + static_cast<long long>(t) * s.t;
}

struct Args {
  const bf16 *o, *dout;
  bf16 *dq, *dk, *dv;
  const float* lse;  // [B * H, Tq], from K1's forward
  float* dd;         // [B * H, Tq] scratch: D, from pass 1 to pass 2
  int h, tq, tk, kv_len, causal;
  Strides so, sdo, sdq, sdk, sdv;
};

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
// (K-major, 128-byte swizzle); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d = a b^T over the head dim: the 64 rows of box a times the 64 rows of
// box b as B's columns (both K-major).
__device__ __forceinline__ void issue_scores64(float* d, uint32_t a, uint32_t b) {
  const uint64_t da = desc_sw128(a), db = desc_sw128(b);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_ss_n64(d, da + 2 * kk, db + 2 * kk, kk);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// This thread's share (head-dim columns 16c .. 16c + 15) of row t's
// dO . o; rows at or past Tq give 0.
__device__ __forceinline__ float row_dot(const Args& a, int b, int h, int t,
                                         int c) {
  if (t >= a.tq) return 0.f;
  const bf16* orow = a.o + offset(a.so, b, h, t) + 16 * c;
  const bf16* drow = a.dout + offset(a.sdo, b, h, t) + 16 * c;
  float sum = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * half);
    const uint4 dv = *reinterpret_cast<const uint4*>(drow + 8 * half);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(op[e]), df = __bfloat1622float2(dp[e]);
      sum = fmaf(of.x, df.x, sum);
      sum = fmaf(of.y, df.y, sum);
    }
  }
  return sum;
}

// Rows r0 + 16 warp + g and + 8 of a 64 x 64 accumulator (this thread's
// share) as bf16, rows at or past n skipped.
__device__ __forceinline__ void store_rows(bf16* dst, Strides s, int b, int h,
                                           int row0, int n, int c,
                                           const float* acc) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int t = row0 + 8 * hr;
    if (t >= n) continue;
    bf16* row = dst + offset(s, b, h, t);
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb)
      *reinterpret_cast<uint32_t*>(row + nb * 8 + 2 * c) =
          spt::pack_bf16(acc[4 * nb + 2 * hr], acc[4 * nb + 2 * hr + 1]);
  }
}

__device__ __forceinline__ void init_barriers(uint32_t bars, int full_count) {
  mbar_init(bars, 1);
  for (int s = 0; s < kStages; ++s) {
    mbar_init(bars + 8 * (1 + s), full_count);
    mbar_init(bars + 8 * (1 + kStages + s), 8);  // one arrival per consumer warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Pass 1: dQ and D. Grid (ceil(Tq / 128), B * H).
__global__ void __launch_bounds__(kThreads, 1)
    bwd_rows_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_fixed = base + BwdLayout::kBarOffset;
  auto full = [&](int s) { return bar_fixed + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_fixed + 8 * (1 + kStages + s); };
  auto stage = [&](int j) {
    return base + BwdLayout::kStagesOffset + (j % kStages) * BwdLayout::kStageBytes;
  };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int q0 = blockIdx.x * kBlock;
  // Key tiles that any row of the block sees.
  int kv_end = a.kv_len;
  if (a.causal) kv_end = min(kv_end, q0 + kBlock);
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  if (tid == 0) init_barriers(bar_fixed, 1);
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues ----
    reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      mbar_expect_tx(bar_fixed, 4 * kBoxBytes);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        tma_load_4d(base + w * kBoxBytes, &tm_q, bar_fixed, 0, q0 + w * kTile, h, b);
        tma_load_4d(base + BwdLayout::kSecondOffset + w * kBoxBytes, &tm_do, bar_fixed,
                    0, q0 + w * kTile, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty(s), (j / kStages - 1) & 1);
        const uint32_t st = stage(j);
        mbar_expect_tx(full(s), BwdLayout::kStageBytes);
        tma_load_4d(st, &tm_k, full(s), 0, j * kTile, h, b);
        tma_load_4d(st + kBoxBytes, &tm_v, full(s), 0, j * kTile, h, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w takes rows q0 + 64 w .. + 63 ----
  reg_alloc<kConsumerRegs>();
  const int w = wg - 1, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, c = lane & 3;
  const int row0 = q0 + w * kTile + warp * 16 + g;  // and row0 + 8
  const long long rbase = static_cast<long long>(bh) * a.tq;

  // lse in log2 units and D of rows row0 and row0 + 8; D to scratch.
  float lse2[2], dd[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    dd[hr] = quad_sum(row_dot(a, b, h, row, c));
    lse2[hr] = row < a.tq ? a.lse[rbase + row] * kLog2e : 0.f;
    if (c == 0 && row < a.tq) a.dd[rbase + row] = dd[hr];
  }

  const uint32_t q_box = base + w * kBoxBytes;
  const uint32_t do_box = base + BwdLayout::kSecondOffset + w * kBoxBytes;
  float s[32], dp[32], dq[32];
  uint32_t dsa[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  // Tile j's dS = P (dP - D) into s, P = 0 outside the masks.
  auto ds_tile = [&](int j) {
    const int kv0 = j * kTile;
    const bool edge = kv0 + kTile > a.kv_len || (a.causal && kv0 + kTile - 1 > row0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hr = (i >> 1) & 1;
      float p = ex2(fmaf(s[i], kLog2e, -lse2[hr]));
      if (edge) {
        const int col = kv0 + 8 * (i >> 2) + 2 * c + (i & 1);
        if (col >= a.kv_len || (a.causal && col > row0 + 8 * hr)) p = 0.f;
      }
      s[i] = p * (dp[i] - dd[hr]);
    }
  };
  // dS rounded to bf16 as dQ's A operand.
  auto pack_ds = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i) dsa[i] = spt::pack_bf16(s[2 * i], s[2 * i + 1]);
  };

  // Tile 0: S = Q K^T and dP = dO V^T, then dS.
  mbar_wait(bar_fixed, 0);
  mbar_wait(full(0), 0);
  wgmma_fence();
  issue_scores64(s, q_box, stage(0));
  issue_scores64(dp, do_box, stage(0) + kBoxBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(s);
  fence_regs<32>(dp);
  ds_tile(0);
  pack_ds();

  // Tile j's S and dP, then tile j - 1's dQ += dS K (K read MN-major),
  // which runs while tile j's dS is made. Nothing is in flight across the
  // loop's back edge.
  for (int j = 1; j < n_tiles; ++j) {
    mbar_wait(full(j % kStages), (j / kStages) & 1);
    wgmma_fence();
    issue_scores64(s, q_box, stage(j));
    issue_scores64(dp, do_box, stage(j) + kBoxBytes);
    wgmma_commit();
    issue_pv<kTile>(dq, dsa, stage(j - 1));
    wgmma_commit();
    wgmma_wait<1>();  // S and dP are in; the dQ product may still run
    fence_regs<32>(s);
    fence_regs<32>(dp);
    ds_tile(j);
    wgmma_wait<0>();
    fence_regs<32>(dq);
    fence_regs<16>(dsa);
    if (lane == 0) mbar_arrive(empty((j - 1) % kStages));
    pack_ds();
  }
  wgmma_fence();
  issue_pv<kTile>(dq, dsa, stage(n_tiles - 1));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(dq);
  fence_regs<16>(dsa);
  store_rows(a.dq, a.sdq, b, h, row0, a.tq, c, dq);
}

// Pass 2: dK and dV. Grid (ceil(Tk / 128), B * H).
__global__ void __launch_bounds__(kThreads, 1)
    bwd_cols_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x, wg = tid >> 7;
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int k0 = blockIdx.x * kBlock;

  if (k0 >= a.kv_len || (a.causal && k0 >= a.tq)) {
    // No row sees these keys: zeros.
    for (int i = tid; i < kBlock * (kD / 8); i += kThreads) {
      const int key = k0 + i / (kD / 8), col = (i % (kD / 8)) * 8;
      if (key >= a.tk) continue;
      *reinterpret_cast<uint4*>(a.dk + offset(a.sdk, b, h, key) + col) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(a.dv + offset(a.sdv, b, h, key) + col) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // generic address of base
  const uint32_t bar_fixed = base + BwdLayout::kBarOffset;
  auto full = [&](int s) { return bar_fixed + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_fixed + 8 * (1 + kStages + s); };
  auto stage = [&](int j) {
    return base + BwdLayout::kStagesOffset + (j % kStages) * BwdLayout::kStageBytes;
  };
  // Stage j's 64 rows' lse * log2e, then their D.
  auto stage_rows = [&](int j) {
    return reinterpret_cast<float*>(gbase + BwdLayout::kRowsOffset) + (j % kStages) * 2 * kTile;
  };

  // Query tiles: under `causal`, from the first that sees key k0 (at
  // least one, as k0 < Tq).
  const int i0 = a.causal ? k0 / kTile : 0;
  const int n_q = (a.tq + kTile - 1) / kTile - i0;
  const long long rbase = static_cast<long long>(bh) * a.tq;

  // A stage is full on the TMA bytes and 33 arrivals: the expect-tx
  // arrival and one per lane of the producer warp after its lse and D.
  if (tid == 0) init_barriers(bar_fixed, 1 + 32);
  __syncthreads();

  if (wg == 0) {
    // ---- producer: warp 0 ----
    reg_dealloc<kProducerRegs>();
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      mbar_expect_tx(bar_fixed, 4 * kBoxBytes);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        tma_load_4d(base + w * kBoxBytes, &tm_k, bar_fixed, 0, k0 + w * kTile, h, b);
        tma_load_4d(base + BwdLayout::kSecondOffset + w * kBoxBytes, &tm_v, bar_fixed,
                    0, k0 + w * kTile, h, b);
      }
    }
    for (int j = 0; j < n_q; ++j) {
      const int s = j % kStages, r0 = (i0 + j) * kTile;
      if (j >= kStages) mbar_wait(empty(s), (j / kStages - 1) & 1);
      if (lane == 0) {
        const uint32_t st = stage(j);
        mbar_expect_tx(full(s), BwdLayout::kStageBytes);
        tma_load_4d(st, &tm_q, full(s), 0, r0, h, b);
        tma_load_4d(st + kBoxBytes, &tm_do, full(s), 0, r0, h, b);
      }
      float* rows = stage_rows(j);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = lane + 32 * half, row = r0 + r;
        const bool in = row < a.tq;
        rows[r] = in ? a.lse[rbase + row] * kLog2e : 0.f;
        rows[kTile + r] = in ? a.dd[rbase + row] : 0.f;
      }
      mbar_arrive(full(s));
    }
    return;
  }

  // ---- consumers: warpgroup w takes keys k0 + 64 w .. + 63 ----
  reg_alloc<kConsumerRegs>();
  const int w = wg - 1, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, c = lane & 3;
  const int key0 = k0 + w * kTile + warp * 16 + g;  // and key0 + 8
  const uint32_t k_box = base + w * kBoxBytes;
  const uint32_t v_box = base + BwdLayout::kSecondOffset + w * kBoxBytes;

  float st[32], dpt[32], dk[32], dv[32];
  uint32_t pa[16], dsa[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  // Tile j's P^T (0 outside the masks) and dS^T = P^T (dP^T - D), rounded
  // to bf16 as the A operands of dV and dK.
  auto p_ds_tile = [&](int j) {
    const float2* rows = reinterpret_cast<const float2*>(stage_rows(j));
    const int r0 = (i0 + j) * kTile;
    const bool edge = r0 + kTile > a.tq || key0 + 8 >= a.kv_len ||
                      (a.causal && r0 < key0 + 8);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int rr = 8 * (i >> 2) + 2 * c;  // this pair's rows rr, rr + 1
      const float2 l2 = rows[rr / 2], d2 = rows[(kTile + rr) / 2];
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = ex2(fmaf(st[i + e], kLog2e, -(e ? l2.y : l2.x)));
        if (edge) {
          const int row = r0 + rr + e, key = key0 + 8 * ((i >> 1) & 1);
          if (row >= a.tq || key >= a.kv_len || (a.causal && row < key)) p[e] = 0.f;
        }
      }
      pa[i / 2] = spt::pack_bf16(p[0], p[1]);
      dsa[i / 2] = spt::pack_bf16(p[0] * (dpt[i] - d2.x), p[1] * (dpt[i + 1] - d2.y));
    }
  };

  // Per tile j: S^T = K Q^T and dP^T = V dO^T; P^T and dS^T; then dV +=
  // P^T dO and dK += dS^T Q (Q and dO read MN-major). The dK and dV
  // accumulators leave no registers for a second tile in flight: the
  // other warpgroup's products run under this one's exponentials.
  mbar_wait(bar_fixed, 0);
  for (int j = 0; j < n_q; ++j) {
    const uint32_t sq = stage(j), sdo = sq + kBoxBytes;
    mbar_wait(full(j % kStages), (j / kStages) & 1);
    wgmma_fence();
    issue_scores64(st, k_box, sq);
    issue_scores64(dpt, v_box, sdo);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(st);
    fence_regs<32>(dpt);
    p_ds_tile(j);
    wgmma_fence();
    issue_pv<kTile>(dv, pa, sdo);
    issue_pv<kTile>(dk, dsa, sq);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(dk);
    fence_regs<32>(dv);
    fence_regs<16>(pa);
    fence_regs<16>(dsa);
    if (lane == 0) mbar_arrive(empty(j % kStages));
  }
  store_rows(a.dk, a.sdk, b, h, key0, a.tk, c, dk);
  store_rows(a.dv, a.sdv, b, h, key0, a.tk, c, dv);
}

}  // namespace

// K15. q, o, dout [B, H, Tq, 64] and k, v [B, H, Tk, 64] bf16, dq [B, H,
// Tq, 64] and dk, dv [B, H, Tk, 64] bf16 outputs, each through (batch,
// head, time) strides in elements (multiples of 8, data 16-byte aligned,
// head dim contiguous); lse f32 [B * H, Tq] contiguous, K1's
// (spt_fullkv_attention_lse), and dd f32 scratch of B * H * Tq.
// 1 <= kv_len <= Tk; causal: row >= col on absolute indices; B * H <=
// 65535 (the grid's y axis). Returns 0, cudaGetLastError() or a tensor-map
// code (sm90.cuh).
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
  CUtensorMap mq, mk, mv, mdo;
  int err = encode_bhtd(&mq, q, b, h, tq, sqb, sqh, sqt, kTile);
  if (err == 0) err = encode_bhtd(&mk, k, b, h, tk, skb, skh, skt, kTile);
  if (err == 0) err = encode_bhtd(&mv, v, b, h, tk, svb, svh, svt, kTile);
  if (err == 0) err = encode_bhtd(&mdo, dout, b, h, tq, sdob, sdoh, sdot, kTile);
  if (err != 0) return err;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BwdLayout::kAlloc);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_cols_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BwdLayout::kAlloc);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  Args a;
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lse = static_cast<const float*>(lse);
  a.dd = static_cast<float*>(dd);
  a.h = h;
  a.tq = tq;
  a.tk = tk;
  a.kv_len = kv_len;
  a.causal = causal;
  a.so = {sob, soh, sot};
  a.sdo = {sdob, sdoh, sdot};
  a.sdq = {sdqb, sdqh, sdqt};
  a.sdk = {sdkb, sdkh, sdkt};
  a.sdv = {sdvb, sdvh, sdvt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bwd_rows_kernel<<<dim3((tq + kBlock - 1) / kBlock, b * h), kThreads,
                    BwdLayout::kAlloc, s>>>(mq, mk, mv, mdo, a);
  bwd_cols_kernel<<<dim3((tk + kBlock - 1) / kBlock, b * h), kThreads,
                    BwdLayout::kAlloc, s>>>(mq, mk, mv, mdo, a);
  return static_cast<int>(cudaGetLastError());
}
