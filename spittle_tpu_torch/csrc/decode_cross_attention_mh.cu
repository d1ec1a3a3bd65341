// Decode-time cross-attention for Hopper (sm_90a) over a batch item's K/V
// read as one [H*rows, Tk] slab of row pitch ld, several heads per load: K4
// over bf16 K/V (entry spt_decode_cross_attention), K3 and K11 over int8
// K/V with per-position f32 scales (entry spt_decode_cross_attention_q8,
// which both wrappers call), and K6 over int4 K/V packed two per byte with
// the same scales (entry spt_decode_cross_attention_q4). One kernel,
// templated on the element type.
//
// Replaces the TPU kernels spittle_tpu/ops/attention.py:
// decode_cross_attention (K4, body _decode_cross_kernel),
// decode_cross_attention_q8 (K3, body _decode_cross_q8_kernel),
// decode_cross_attention_q4 (K6, body _decode_cross_q4_kernel) and the
// probe kernel scripts/bench_decode_cross.py:mh_q8 (K11, body
// _mh_q8_kernel), whose point on the TPU is one large DMA per batch item:
// K/V viewed as [B, H*64, Tk], all heads of an item in one program. K3
// and K11 compute the same function (tests/test_torch_probes.py), and
// here they give the same bits. q arrives bf16, pre-scaled by Dh^-0.5.
// Per (b, h), with t < kv_len:
//   s[r, t] = (sum_d q[r, d] * K[d, t]) * ks[t]
//   m = max_t s, p = exp(s - m), l = sum_t p     (mask before the max)
//   o[r, d] = sum_t bf16(p * vs[t]) * V[d, t] / l
// K4 is the same function with ks = vs = 1 (K and V bf16): both products
// by 1 are exact, so its instance drops them and loads no scales. K6's K
// and V are 32 stored rows per head: byte t of row d holds dims d (low
// nibble) and d + 32 (high nibble) of position t, each sign-extended
// (ops/quant.py:quantize_kv_int4).
//
// What bounds it on an H100: memory. At the probe's B 16, H 20, kv_len
// 1500 an int8 call reads 2 x 16*20*64*1500 int8 bytes and 2 x
// 16*20*1500*4 scale bytes (65 MB): 19.5 us at 3.35 TB/s, for 4 * R * 64
// flops per (b, h, t); K4 at B 8 reads 2 x 8*20*64*1500 bf16 values (61
// MB, 18.3 us); K6 at B 8 reads 2 x 8*20*32*1500 packed bytes and the same
// scales (17.3 MB, 5.2 us). Widening each int8 byte or nibble with I2F (16
// per clock per SM) would take ~17 us of its own on 132 SMs at K3's
// shape, so no byte goes through it.
//
// The row pitch. The decoder stores its cross-K/V with rows padded to a
// multiple of 16 bytes (models/whisper/model.py:precompute_cross_kv and
// precompute_cross_kv_quant, ops/attention.py:tma_pitch: 1504 positions
// for Tk 1500, int8, int4 and bf16 alike), so that TMA can address every
// row; the views keep the logical shape [B, H, rows, Tk]. Contiguous K/V
// (ld = Tk) takes TMA where its rows are 16-byte multiples and the covers
// otherwise.
//
// Design:
//  - Work items (b, pair of heads, one row slice: 128 bytes of int8 or
//    bf16, 128 int8 or 64 bf16 positions; kInt4Slice bytes of int4, as
//    many positions): 1920 at the probe's shape and at K4's B 8, in a
//    persistent grid of one block per SM (min(SMs, items) blocks, block i
//    taking items i, i + gridDim.x, ...), so every SM has work for the
//    whole call. A bf16 item thus moves an int8 item's bytes, and every
//    stage, lane mapping and bank pattern below is the same for both; an
//    int4 item has half their rows (32 per head).
//  - Producer warps fill a ring of kStages = 4 stages, one per team of
//    consumers, each an item's K and V rows (2 x 128 rows x 128 bytes, 32
//    KB; int4 2 x 64 rows x kInt4Slice bytes), guarded by a full and an
//    empty mbarrier per stage; the ring keeps up to 128 KB in flight per
//    SM. Two load paths, chosen by the host: where the byte pitch and the
//    slabs are 16-byte aligned a 2-D tensor map over the slab [B*H*rows,
//    Tk] loads an item's K rows (two heads) in one TMA box, and V's in
//    another, positions past Tk zero-filled (the padding past Tk is never
//    read); otherwise rows are at no 16-byte boundary, and four producer
//    warps copy each row's slice as the aligned 16-byte cp.async chunks
//    that cover it, into rows of the slice + 16 bytes, and each of their
//    threads signals the full barrier with cp.async.mbarrier.arrive.noinc
//    (one warp issuing 2,304 copies per item held the card to 0.047 ms
//    against the TMA path's 0.032 at the probe's shape on an H100 80GB
//    HBM3 at 700 W). A consumer reads a row at the slice's offset in its
//    first chunk, which it computes from the row's address.
//  - Eight consumer warps in four teams of two: team k takes the block's
//    items k, k + 4, ..., one head per warp, so every warp runs on its
//    own, with no block barrier. For the scores a lane owns a 32-bit word
//    of each K row per 128 bytes of slice (4 int8, 2 bf16 or 4 int4
//    positions: conflict-free reads); for PV two rows d (int8, bf16: d and
//    d + 32) or one stored int4 row (its nibbles are d and d + 32), whose
//    words it walks in an order rotated by its lane, so the 32 lanes hit
//    32 banks; bf16(p * vs) is passed through shared memory over the K
//    rows the scores have read. Ring depth and item size were timed on the
//    card (probes/decode_cross_items.py): head pairs, with 4 stages (7-11%
//    faster than 5 at K3's B 8 and 56, R 1; 5 were 5% faster at R 3 and 2%
//    on cp.async, but a ring deeper than the teams races: see the ring's
//    phases below); int4 slices of kInt4Slice bytes (PERF.md §6). Max
//    and sum are warp shuffles. q and the scales are loaded before the
//    wait for the stage.
//  - Widening: an int8 x becomes a float as 2^23 + (x + 128) built with
//    __byte_perm (the byte XOR 0x80 under the exponent bits of 2^23), less
//    2^23 + 128 in f32: exact for every byte, on the integer and FMA pipes.
//    An int4 nibble n likewise as 2^23 + (n + 8) (the nibble XOR 8, masked
//    out with one LOP3 per word and half), less 2^23 + 8. A bf16 is the
//    high half of its f32: a shift or a mask.
//  - Each row of a score sums over d in order (int4: d, d + 32, d + 1, d +
//    33, ..., the old split-T kernel's order); P rounds to bf16 against
//    the item's chunk's max, and the chunks are combined by the combine
//    pass (decode_cross_combine.cuh) from the partial records. K4's last
//    item zeroes the V values past kv_len before PV: an int8 byte is always
//    finite, a bf16 value there (or a stale stage word) need not be.
//
// The ring's phases: team k takes items k, k + kTeams, ... in stage k, and
// waits for the full barrier's phase of parity (g / kStages) & 1 of its
// item g. A parity wait is exact only while the barrier is at most one
// phase behind: if the stage's previous item has not landed either, the
// barrier's current phase has the parity asked for and the wait passes at
// once. So the stage's previous item must be one this same team has
// already waited for, which holds because kStages == kTeams: it is the
// team's own item g - kTeams. With more stages than teams (the parent's
// 5 for 4) the stage's previous item g - kStages belongs to another team,
// and on the TMA path its boxes may still be landing when those of g -
// kTeams, the team's own last item, have completed: the team then reads a
// stage that is still being filled and arrives on its empty barrier once
// too often, which faulted and hung on the card. On the cp.async path each
// producer thread's arrivals complete in its copies' order, so g - kStages
// should land before g - kTeams there; no fault was seen on it. The int4
// instance keeps the same ring and the same invariant.
#include "decode_cross_combine.cuh"
#include "sm90.cuh"

namespace {

namespace sm = spt::sm90;
using spt::decode_cross::decode_cross_q_combine;
using spt::decode_cross::kD;
using spt::decode_cross::kMaxR;
using spt::decode_cross::kRec;

constexpr int kHeads = 2;   // heads per item (one TMA box)
// Bytes (positions) of an int4 row per item: 128, the int8 and bf16
// slice, which the host's ops/attention.py:item_positions assumes. Its own
// constant only so that probes/decode_cross_items.py can rebuild the
// kernel at 256 to time the larger item.
constexpr int kInt4Slice = 128;
constexpr int kWarps = 8;                  // consumer warps
constexpr int kTeams = kWarps / kHeads;    // a team takes an item
// Ring depth: one stage per team, so that each stage's previous item is
// the team's own (the ring's phases, above). A deeper ring needs a wait
// that names the item, not a parity: an empty/full pair per item.
constexpr int kStages = kTeams;
static_assert(kStages == kTeams,
              "a stage's parity wait is exact only if its previous item is the team's own");
// Producer warps: one issues the TMA boxes; four issue the cp.async covers.
template <bool kTma>
constexpr int kProducers = kTma ? 1 : 4;
template <bool kTma>
constexpr int kThreads = 32 * (kWarps + kProducers<kTma>);

// Packed int4 K/V (K6): byte t of a stored row holds two positions' worth
// of dims, d in the low nibble and d + 32 in the high one.
struct Int4x2 {
  uint8_t bits;
};

// The element type: int8 codes with f32 scales (K3, K11), bf16 (K4) or
// packed int4 codes with f32 scales (K6). kBytes per position of a stored
// row, kHeadRows stored rows per head, kSlice bytes of a row per item
// (kChunk positions), kPer positions per lane in the scores and kPw per
// 32-bit word.
template <typename E>
struct Elem;
template <>
struct Elem<int8_t> {
  static constexpr bool kQuant = true, kNib = false;
  static constexpr int kBytes = 1, kHeadRows = kD, kSlice = 128;
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kQuant = false, kNib = false;
  static constexpr int kBytes = 2, kHeadRows = kD, kSlice = 128;
};
template <>
struct Elem<Int4x2> {
  static constexpr bool kQuant = true, kNib = true;
  static constexpr int kBytes = 1, kHeadRows = kD / 2, kSlice = kInt4Slice;
};
template <typename E>
struct Shape : Elem<E> {
  using El = Elem<E>;
  static constexpr int kChunk = El::kSlice / El::kBytes;
  static constexpr int kPw = 4 / El::kBytes;
  static constexpr int kPer = kChunk / 32;
  static constexpr int kLaneWords = kPer / kPw;  // words of a K row per lane
  static constexpr int kRowWords = El::kSlice / 4;
  static constexpr int kRows = kHeads * El::kHeadRows;  // K (or V) rows of an item
  static_assert(kPer % kPw == 0 && El::kSlice % 128 == 0, "a lane owns whole words");
  // P (kMaxR x kChunk f32) is written over one head's K rows.
  static_assert(kMaxR * kChunk * 4 <= El::kHeadRows * El::kSlice, "P fits a head's K rows");
};

// Shared memory: the stages (K rows, then V rows), q per warp ([64][8]
// f32), the barriers. A warp writes bf16(p * vs) ([R][kChunk] f32) over
// its head's K rows once its scores are summed.
template <typename E, bool kTma>
struct Smem {
  static constexpr int kRowBytes = kTma ? Elem<E>::kSlice : Elem<E>::kSlice + 16;
  static constexpr int kStageBytes = 2 * Shape<E>::kRows * kRowBytes;
  static constexpr int kQOffset = kStages * kStageBytes;
  static constexpr int kBarOffset = kQOffset + kWarps * kD * 8 * 4;
  static constexpr int kAlloc = kBarOffset + 2 * kStages * 8 + 1024;
};

struct Item {
  int b, h0, c, t0;
};

__device__ __forceinline__ Item item_at(int i, int groups, int nchunks,
                                        int chunk) {
  Item it;
  it.c = i % nchunks;
  it.h0 = i / nchunks % groups * kHeads;
  it.b = i / nchunks / groups;
  it.t0 = it.c * chunk;
  return it;
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed;
// the barrier's count includes the arrival.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// The kPw values of an int8 or bf16 word -> exact floats: four int8
// without I2F, or two bf16.
template <typename E>
__device__ __forceinline__ void widen(uint32_t w, float* f) {
  if constexpr (Elem<E>::kQuant) {
    const uint32_t u = w ^ 0x80808080u;  // each byte x + 128, 0..255
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) - 8388736.f;
  } else {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xFFFF0000u);
  }
}

// A word of packed int4 (four positions) -> exact floats: lo[j] the low
// nibble of byte j (dim d), hi[j] the high one (dim d + 32), each
// sign-extended. A nibble n XOR 8 is n + 8 (0..15); under the exponent
// bits of 2^23 it is 2^23 + n + 8, less 2^23 + 8 in f32.
__device__ __forceinline__ void widen_nibbles(uint32_t w, float* lo, float* hi) {
  const uint32_t u = w ^ 0x88888888u;  // each nibble n + 8
  const uint32_t l = u & 0x0F0F0F0Fu, h = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7440 + j)) - 8388616.f;
    hi[j] = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7440 + j)) - 8388616.f;
  }
}

// Word k (bytes 4k..4k+3 of the item's slice) of a stage row. TMA rows
// hold the slice from byte 0; cp.async rows from byte `shift` (0..15).
template <bool kTma>
__device__ __forceinline__ uint32_t row_word(const uint8_t* row, int k,
                                             int shift) {
  if constexpr (kTma) {
    return *reinterpret_cast<const uint32_t*>(row + 4 * k);
  } else {
    const uint8_t* w = row + (shift & ~3) + 4 * k;
    return __byte_perm(*reinterpret_cast<const uint32_t*>(w),
                       *reinterpret_cast<const uint32_t*>(w + 4),
                       0x3210 + 0x1111 * (shift & 3));
  }
}

// cp.async path: copy bytes [b0, b1) of `rows` rows of the slab (ldb
// bytes apart from `src`) into rows of kSlice + 16 bytes, as the aligned
// 16-byte chunks that cover each slice. Every chunk holds a byte of the
// row, so no read leaves the tensor's 16-byte granules.
template <int kSlice>
__device__ __forceinline__ void stage_covers(uint8_t* dst, const uint8_t* src,
                                             int rows, long long ldb, int b0,
                                             int b1, int first, int stride) {
  constexpr int kSegs = (kSlice + 16) / 16;
  for (int i = first; i < rows * kSegs; i += stride) {
    const int row = i / kSegs, seg = i % kSegs;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(src) +
                         static_cast<uintptr_t>(row) * ldb + b0;
    const uintptr_t a = (lo & ~static_cast<uintptr_t>(15)) + 16 * seg;
    if (a < lo + (b1 - b0))
      spt::cp_async_16(dst + row * (kSlice + 16) + 16 * seg,
                       reinterpret_cast<const void*>(a));
  }
}

template <typename E, bool kTma, int R>
__global__ void __launch_bounds__(kThreads<kTma>, 1)
    decode_cross_mh_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __nv_bfloat16* __restrict__ q,
                           const E* __restrict__ qk,
                           const float* __restrict__ ks,
                           const E* __restrict__ qv,
                           const float* __restrict__ vs,
                           float* __restrict__ part, int B, int H, int Tk,
                           int kv_len, long long qsb, long long qsh,
                           long long qsr, long long ld) {
  using S = Smem<E, kTma>;
  using Sh = Shape<E>;
  constexpr int kPer = Sh::kPer;
  constexpr int kPw = Sh::kPw;
  constexpr int kChunk = Sh::kChunk;
  constexpr int kRows = Sh::kRows;
  constexpr int kHeadRows = Sh::kHeadRows;
  constexpr int kEs = Sh::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (sm::smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t bars = sm::smem_u32(base) + S::kBarOffset;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (H + kHeads - 1) / kHeads;
  const int nchunks = (kv_len + kChunk - 1) / kChunk;
  const int n_items = B * groups * nchunks;
  const long long ldb = ld * kEs;  // the row pitch in bytes
  const uint8_t* kbytes = reinterpret_cast<const uint8_t*>(qk);
  const uint8_t* vbytes = reinterpret_cast<const uint8_t*>(qv);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm::mbar_init(full(s), kTma ? 1 : 32 * kProducers<kTma>);
      sm::mbar_init(empty(s), kHeads);  // one arrival per warp of the team
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWarps) {
    // ---- producers ----
    const int pt = threadIdx.x - 32 * kWarps;  // thread among the producers
    for (int i = blockIdx.x, g = 0; i < n_items; i += gridDim.x, ++g) {
      const int s = g % kStages;
      if (g >= kStages) sm::mbar_wait(empty(s), (g / kStages - 1) & 1);
      const Item it = item_at(i, groups, nchunks, kChunk);
      uint8_t* st = base + s * S::kStageBytes;
      const int row0 = (it.b * H + it.h0) * kHeadRows;
      if constexpr (kTma) {
        if (pt == 0) {
          sm::mbar_expect_tx(full(s), S::kStageBytes);
          sm::tma_load_2d(sm::smem_u32(st), &tm_k, full(s), it.t0, row0);
          sm::tma_load_2d(sm::smem_u32(st + kRows * S::kRowBytes), &tm_v, full(s),
                      it.t0, row0);
        }
      } else {
        // Rows of heads past H are not copied (no consumer reads them).
        const int rows = min(kHeads, H - it.h0) * kHeadRows;
        const int t1 = min(it.t0 + kChunk, kv_len);
        const size_t off = static_cast<size_t>(row0) * ldb;
        constexpr int kN = 32 * kProducers<kTma>;
        stage_covers<Sh::kSlice>(st, kbytes + off, rows, ldb, it.t0 * kEs, t1 * kEs,
                                 pt, kN);
        stage_covers<Sh::kSlice>(st + kRows * S::kRowBytes, vbytes + off, rows, ldb,
                                 it.t0 * kEs, t1 * kEs, pt, kN);
        cp_async_arrive(full(s));
      }
    }
    return;
  }

  // ---- consumers: warp `warp` takes head h0 + hh of its team's items ----
  const int team = warp / kHeads, hh = warp % kHeads;
  float* qsw = reinterpret_cast<float*>(base + S::kQOffset) + warp * kD * 8;
  for (int g = team;; g += kTeams) {
    const int i = blockIdx.x + g * gridDim.x;
    if (i >= n_items) break;
    const Item it = item_at(i, groups, nchunks, kChunk);
    const int h = it.h0 + hh;
    const bool mine = h < H;
    const int bh = it.b * H + h;

    // Loads that need no stage: the scales of this lane's positions, q.
    float ksc[kPer], vsc[kPer];
    bool live[kPer];
    if (mine) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int t = it.t0 + kPer * lane + j;
        live[j] = t < kv_len;
        if constexpr (Sh::kQuant) {
          const size_t at = static_cast<size_t>(bh) * Tk + t;
          ksc[j] = live[j] ? ks[at] : 0.f;
          vsc[j] = live[j] ? vs[at] : 0.f;
        }
      }
      const __nv_bfloat16* qh = q + it.b * qsb + h * qsh;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        qsw[lane * 8 + r] = __bfloat162float(qh[r * qsr + lane]);
        qsw[(lane + 32) * 8 + r] = __bfloat162float(qh[r * qsr + lane + 32]);
      }
      __syncwarp();
    }

    const int s = g % kStages;
    sm::mbar_wait(full(s), (g / kStages) & 1);
    if (mine) {
      const uint8_t* kst = base + s * S::kStageBytes + hh * kHeadRows * S::kRowBytes;
      const uint8_t* vst = kst + kRows * S::kRowBytes;
      // Slab address of this head's row 0 at t0: a row's cp.async slice
      // starts at its address's offset in 16 bytes.
      const uintptr_t k0 = reinterpret_cast<uintptr_t>(kbytes) +
                           static_cast<size_t>(bh) * kHeadRows * ldb + it.t0 * kEs;
      const uintptr_t v0 = reinterpret_cast<uintptr_t>(vbytes) +
                           static_cast<size_t>(bh) * kHeadRows * ldb + it.t0 * kEs;

      // Scores: s[r][j] for positions t0 + kPer lane + j, summed over d in
      // order (int4: d, d + 32, d + 1, d + 33, ...).
      float sc[R][kPer];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < kPer; ++j) sc[r][j] = 0.f;
      if constexpr (Sh::kNib) {
#pragma unroll 2
        for (int d = 0; d < kHeadRows; ++d) {
          float qlo[8], qhi[8];
          *reinterpret_cast<float4*>(qlo) = *reinterpret_cast<const float4*>(qsw + d * 8);
          *reinterpret_cast<float4*>(qhi) =
              *reinterpret_cast<const float4*>(qsw + (d + 32) * 8);
          if constexpr (R > 4) {
            *reinterpret_cast<float4*>(qlo + 4) =
                *reinterpret_cast<const float4*>(qsw + d * 8 + 4);
            *reinterpret_cast<float4*>(qhi + 4) =
                *reinterpret_cast<const float4*>(qsw + (d + 32) * 8 + 4);
          }
          const int shift = static_cast<int>((k0 + d * ldb) & 15);
#pragma unroll
          for (int w = 0; w < Sh::kLaneWords; ++w) {
            float lo[4], hi[4];
            widen_nibbles(row_word<kTma>(kst + d * S::kRowBytes,
                                         Sh::kLaneWords * lane + w, shift),
                          lo, hi);
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                sc[r][4 * w + j] = fmaf(qlo[r], lo[j], sc[r][4 * w + j]);
                sc[r][4 * w + j] = fmaf(qhi[r], hi[j], sc[r][4 * w + j]);
              }
          }
        }
      } else {
#pragma unroll 4
        for (int d = 0; d < kD; ++d) {
          float f[kPer];
          widen<E>(row_word<kTma>(kst + d * S::kRowBytes, lane,
                                  static_cast<int>((k0 + d * ldb) & 15)),
                   f);
          float qd[8];
          *reinterpret_cast<float4*>(qd) = *reinterpret_cast<const float4*>(qsw + d * 8);
          if constexpr (R > 4)
            *reinterpret_cast<float4*>(qd + 4) =
                *reinterpret_cast<const float4*>(qsw + d * 8 + 4);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < kPer; ++j) sc[r][j] = fmaf(qd[r], f[j], sc[r][j]);
        }
      }

      // Mask before the max; p = exp(s - m_chunk); l sums the f32 p; PV
      // reads bf16(p * vs), written over the K rows that the scores read.
      __syncwarp();
      float* pvw = reinterpret_cast<float*>(base + s * S::kStageBytes +
                                            hh * kHeadRows * S::kRowBytes);
      float* rec = part + (static_cast<size_t>(bh) * nchunks + it.c) * R * kRec;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float sj = Sh::kQuant ? sc[r][j] * ksc[j] : sc[r][j];
          sc[r][j] = live[j] ? sj : -INFINITY;
          mx = fmaxf(mx, sc[r][j]);
        }
        mx = spt::warp_max(mx);
        float ls = 0.f, pw[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float p = live[j] ? expf(sc[r][j] - mx) : 0.f;
          ls += p;
          pw[j] = __bfloat162float(__float2bfloat16_rn(Sh::kQuant ? p * vsc[j] : p));
        }
        ls = spt::warp_sum(ls);
        if constexpr (kPer % 4 == 0) {
#pragma unroll
          for (int j = 0; j < kPer; j += 4)
            *reinterpret_cast<float4*>(pvw + r * kChunk + kPer * lane + j) =
                *reinterpret_cast<const float4*>(pw + j);
        } else {
          *reinterpret_cast<float2*>(pvw + r * kChunk + 2 * lane) =
              *reinterpret_cast<const float2*>(pw);
        }
        if (lane == 0) {
          rec[r * kRec + kD] = mx;
          rec[r * kRec + kD + 1] = ls;
        }
      }
      __syncwarp();

      // o[r, d] for d = lane and lane + 32: over the words of the two V
      // rows (int8, bf16) or of stored row `lane` (int4, whose nibbles are
      // d and d + 32), word (i + lane) % kRowWords at step i. K4's last
      // item: the words past kv_len (live < kChunk positions) read as zeros.
      float a0[R], a1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a0[r] = a1[r] = 0.f;
      const int sh0 = static_cast<int>((v0 + lane * ldb) & 15);
      const uint8_t* vr0 = vst + lane * S::kRowBytes;
      if constexpr (Sh::kNib) {
#pragma unroll 4
        for (int step = 0; step < Sh::kRowWords; ++step) {
          const int k = (step + lane) & (Sh::kRowWords - 1);
          float lo[4], hi[4];
          widen_nibbles(row_word<kTma>(vr0, k, sh0), lo, hi);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float pp[4];
            *reinterpret_cast<float4*>(pp) =
                *reinterpret_cast<const float4*>(pvw + r * kChunk + 4 * k);
#pragma unroll
            for (int j = 0; j < 4; ++j) a0[r] = fmaf(pp[j], lo[j], a0[r]);
#pragma unroll
            for (int j = 0; j < 4; ++j) a1[r] = fmaf(pp[j], hi[j], a1[r]);
          }
        }
      } else {
        const int sh1 = static_cast<int>((v0 + (lane + 32) * ldb) & 15);
        const uint8_t* vr1 = vst + (lane + 32) * S::kRowBytes;
        const int nlive = kv_len - it.t0;
#pragma unroll 4
        for (int step = 0; step < 32; ++step) {
          const int k = (step + lane) & 31;
          uint32_t w0 = row_word<kTma>(vr0, k, sh0);
          uint32_t w1 = row_word<kTma>(vr1, k, sh1);
          if constexpr (!Sh::kQuant) {
            if (nlive < kChunk) {
              const uint32_t keep = 2 * k + 1 < nlive ? 0xFFFFFFFFu
                                    : 2 * k < nlive   ? 0x0000FFFFu
                                                      : 0u;
              w0 &= keep;
              w1 &= keep;
            }
          }
          float f0[kPw], f1[kPw];
          widen<E>(w0, f0);
          widen<E>(w1, f1);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float* pk = pvw + r * kChunk + kPw * k;
            float pp[kPw];
            if constexpr (kPw == 4)
              *reinterpret_cast<float4*>(pp) = *reinterpret_cast<const float4*>(pk);
            else
              *reinterpret_cast<float2*>(pp) = *reinterpret_cast<const float2*>(pk);
#pragma unroll
            for (int j = 0; j < kPw; ++j) a0[r] = fmaf(pp[j], f0[j], a0[r]);
#pragma unroll
            for (int j = 0; j < kPw; ++j) a1[r] = fmaf(pp[j], f1[j], a1[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        rec[r * kRec + lane] = a0[r];
        rec[r * kRec + lane + 32] = a1[r];
      }
    }
    __syncwarp();  // the stage, q and P are read
    if (lane == 0) sm::mbar_arrive(empty(s));
  }
}

// A 2-D map over a slab of `rows` rows of Tk positions, ldb bytes apart
// (ldb % 16 == 0): boxes of one item's slice (kChunk positions) x kRows
// rows, no swizzle, past Tk and past the last row filled with zeros. The
// map's width is Tk, so no element of a row's padding past Tk is read.
template <typename E>
int encode_slab(CUtensorMap* map, const void* ptr, long long rows, int Tk,
                long long ldb) {
  const sm::EncodeTiledFn enc = sm::encoder();
  if (enc == nullptr) return sm::kErrNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Tk),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldb)};
  const cuuint32_t box[2] = {Shape<E>::kChunk, Shape<E>::kRows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map,
                         Elem<E>::kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         2, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : sm::kErrEncode + static_cast<int>(r);
}

template <typename E, bool kTma, int R>
int launch_rows(const void* q, const void* qk, const void* ks, const void* qv,
                const void* vs, void* part, int B, int H, int Tk, int kv_len,
                int num_sms, long long qsb, long long qsh, long long qsr,
                long long ld, cudaStream_t st) {
  CUtensorMap mk{}, mv{};
  if (kTma) {
    const long long rows = static_cast<long long>(B) * H * Elem<E>::kHeadRows;
    const long long ldb = ld * Elem<E>::kBytes;
    int err = encode_slab<E>(&mk, qk, rows, Tk, ldb);
    if (err == 0) err = encode_slab<E>(&mv, qv, rows, Tk, ldb);
    if (err != 0) return err;
  }
  constexpr int kSmem = Smem<E, kTma>::kAlloc;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_cross_mh_kernel<E, kTma, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  constexpr int kChunk = Shape<E>::kChunk;
  const long long items = static_cast<long long>(B) * ((H + kHeads - 1) / kHeads) *
                          ((kv_len + kChunk - 1) / kChunk);
  const int grid = static_cast<int>(items < num_sms ? items : num_sms);
  decode_cross_mh_kernel<E, kTma, R><<<grid, kThreads<kTma>, kSmem, st>>>(
      mk, mv, static_cast<const __nv_bfloat16*>(q), static_cast<const E*>(qk),
      static_cast<const float*>(ks), static_cast<const E*>(qv),
      static_cast<const float*>(vs), static_cast<float*>(part), B, H, Tk,
      kv_len, qsb, qsh, qsr, ld);
  return static_cast<int>(cudaGetLastError());
}

// Every entry: ld is the row pitch in positions, checked here against Tk
// and, on the TMA path, the 16-byte rule; then the rows' instance and the
// combine pass over ceil(kv_len / kChunk) records per (b, h, r).
template <typename E>
int launch(const void* q, const void* qk, const void* ks, const void* qv,
           const void* vs, void* part, void* o, int B, int H, int R,
           int Tk, int kv_len, int num_sms, int tma, long long qsb,
           long long qsh, long long qsr, long long ld, long long osb,
           long long osh, long long osr, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_sms < 1 || ld < Tk) return static_cast<int>(cudaErrorInvalidValue);
  if (tma && ((ld * Elem<E>::kBytes) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(qk) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(qv) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (R) {
#define SPT_ROWS(n)                                                           \
  case n:                                                                     \
    err = (tma ? launch_rows<E, true, n> : launch_rows<E, false, n>)(         \
        q, qk, ks, qv, vs, part, B, H, Tk, kv_len, num_sms, qsb, qsh, qsr, ld, \
        st);                                                                  \
    break;
    SPT_ROWS(1) SPT_ROWS(2) SPT_ROWS(3) SPT_ROWS(4)
    SPT_ROWS(5) SPT_ROWS(6) SPT_ROWS(7) SPT_ROWS(8)
#undef SPT_ROWS
  }
  if (err != 0) return err;
  const int nchunks = (kv_len + Shape<E>::kChunk - 1) / Shape<E>::kChunk;
  decode_cross_q_combine<<<B * H, kMaxR * kD, 0, st>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(o), H, R,
      nchunks, osb, osh, osr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3 and K11. q: [B, H, R, 64] bf16 with strides (qsb, qsh, qsr, 1); qk,
// qv int8 [B, H, 64, Tk], rows ld >= Tk bytes apart with strides
// (H*64*ld, 64*ld, ld, 1) (per batch item one [H*64, Tk] slab of pitch
// ld); ks, vs contiguous f32 [B, H, Tk]; part: f32 scratch [B*H,
// ceil(kv_len/128), R, 66]; o: [B, H, R, 64] bf16 with strides (osb,
// osh, osr, 1). tma: the load path the host chose (ops/attention.py:
// decode_cross_load_path), TMA boxes (ld and both slabs 16-byte aligned)
// or 16-byte cp.async covers. num_sms: the card's SM count, the grid's
// size.
SPT_API int spt_decode_cross_attention_q8(
    const void* q, const void* qk, const void* ks, const void* qv,
    const void* vs, void* part, void* o, int B, int H, int R, int Tk,
    int kv_len, int num_sms, int tma, long long qsb, long long qsh,
    long long qsr, long long ld, long long osb, long long osh, long long osr,
    void* stream) {
  return launch<int8_t>(q, qk, ks, qv, vs, part, o, B, H, R, Tk, kv_len,
                        num_sms, tma, qsb, qsh, qsr, ld, osb, osh, osr, stream);
}

// K6: as K3 with qk, qv the packed int4 codes [B, H, 32, Tk] (int8 bytes,
// rows ld >= Tk bytes apart, strides (H*32*ld, 32*ld, ld, 1)); part: f32
// scratch [B*H, ceil(kv_len/kInt4Slice), R, 66].
SPT_API int spt_decode_cross_attention_q4(
    const void* q, const void* qk, const void* ks, const void* qv,
    const void* vs, void* part, void* o, int B, int H, int R, int Tk,
    int kv_len, int num_sms, int tma, long long qsb, long long qsh,
    long long qsr, long long ld, long long osb, long long osh, long long osr,
    void* stream) {
  return launch<Int4x2>(q, qk, ks, qv, vs, part, o, B, H, R, Tk, kv_len,
                        num_sms, tma, qsb, qsh, qsr, ld, osb, osh, osr, stream);
}

// K4: as K3 with k, v bf16 [B, H, 64, Tk], rows ld >= Tk elements apart
// (strides (H*64*ld, 64*ld, ld, 1); TMA needs 2 * ld % 16 == 0), no
// scales; part: f32 scratch [B*H, ceil(kv_len/64), R, 66].
SPT_API int spt_decode_cross_attention(
    const void* q, const void* k, const void* v, void* part, void* o, int B,
    int H, int R, int Tk, int kv_len, int num_sms, int tma, long long qsb,
    long long qsh, long long qsr, long long ld, long long osb, long long osh,
    long long osr, void* stream) {
  return launch<__nv_bfloat16>(q, k, nullptr, v, nullptr, part, o, B, H, R, Tk,
                               kv_len, num_sms, tma, qsb, qsh, qsr, ld, osb,
                               osh, osr, stream);
}
