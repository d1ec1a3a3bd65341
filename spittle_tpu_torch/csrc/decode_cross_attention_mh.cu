// Decode-time cross-attention over int8 K/V for Hopper (sm_90a): K3 and
// K11, one kernel and one entry (spt_decode_cross_attention_q8), which
// both wrappers call. The K/V of a batch item is read as
// one [H*64, Tk] int8 slab of row pitch ld, several heads per load.
//
// Replaces the TPU kernels spittle_tpu/ops/attention.py:
// decode_cross_attention_q8 (K3, body _decode_cross_q8_kernel) and the
// probe kernel scripts/bench_decode_cross.py:mh_q8 (K11, body
// _mh_q8_kernel), whose point on the TPU is one large DMA per batch item:
// K/V viewed as [B, H*64, Tk], all heads of an item in one program. Both
// compute the same function (tests/test_torch_probes.py), and here they
// give the same bits. q arrives bf16, pre-scaled by Dh^-0.5. Per (b, h),
// with t < kv_len:
//   s[r, t] = (sum_d q[r, d] * qK[d, t]) * ks[t]
//   m = max_t s, p = exp(s - m), l = sum_t p     (mask before the max)
//   o[r, d] = sum_t bf16(p * vs[t]) * qV[d, t] / l
//
// What bounds it on an H100: memory. At the probe's B 16, H 20, kv_len
// 1500 a call reads 2 x 16*20*64*1500 int8 bytes and 2 x 16*20*1500*4
// scale bytes (65 MB): 19.5 us at 3.35 TB/s, for 4 * R * 64 flops per (b,
// h, t). Widening each byte with I2F (16 per clock per SM) would take ~17
// us of its own on 132 SMs, so no byte goes through it.
//
// The row pitch. The decoder stores its int8 cross-K/V with rows padded to
// a multiple of 16 bytes (models/whisper/model.py:precompute_cross_kv_quant:
// 1504 for Tk 1500, 0.27% more bytes), so that TMA can address every row;
// the views keep the logical shape [B, H, 64, Tk]. Contiguous K/V (ld =
// Tk) takes TMA where Tk % 16 == 0 and the covers otherwise.
//
// Design:
//  - Work items (b, pair of heads, 128 positions): 1920 at the probe's
//    shape, in a persistent grid of one block per SM (min(SMs, items)
//    blocks, block i taking items i, i + gridDim.x, ...), so every SM has
//    work for the whole call.
//  - Producer warps fill a ring of kStages stages, each an item's K and
//    V rows (2 x 128 rows x 128 positions, 32 KB), guarded by a full and
//    an empty mbarrier per stage; the ring keeps up to 160 KB in flight
//    per SM. Two load paths, chosen by the host: where ld % 16 == 0 and
//    the slabs are 16-byte aligned a 2-D tensor map over the slab
//    [B*H*64, Tk] of pitch ld loads an item's 128 K rows (two heads) in
//    one TMA box, and V's in another, positions past Tk zero-filled (the
//    padding past Tk is never read); otherwise rows are ld bytes apart at
//    no 16-byte boundary, and four producer warps
//    copy each row's slice as the aligned 16-byte cp.async chunks that
//    cover it (K6's stage_rows), into rows of 144 bytes, and each of their
//    threads signals the full barrier with cp.async.mbarrier.arrive.noinc
//    (one warp issuing 2,304 copies per item held the card to 0.047 ms
//    against the TMA path's 0.032 at the probe's shape on an H100 80GB HBM3 at 700 W). A
//    consumer reads a row at the slice's offset in its first chunk, which
//    it computes from the row's address.
//  - Eight consumer warps in four teams of two: team k takes the block's
//    items k, k + 4, ..., one head per warp, so every warp runs on its
//    own, with no block barrier. A lane owns 4 positions for the scores (a
//    32-bit word of each K row: conflict-free reads of 128-byte rows) and
//    two rows d for PV (it walks the 32 words of its V rows in an order
//    rotated by its lane, so the 32 lanes hit 32 banks), with bf16(p * vs)
//    passed through shared memory over the K rows the scores have read.
//    Ring depth and item size were timed on the card
//    (probes/decode_cross_items.py): head pairs, with 4 stages at R 1 on
//    the TMA path (a decode step: 7-11% faster than 5 at K3's B 8 and
//    56) and 5 otherwise (5% faster than 4 at R 3, 2% on cp.async). Max and sum are
//    warp shuffles. q and the scales are loaded before the wait for the
//    stage.
//  - Widening: an int8 x becomes a float as 2^23 + (x + 128) built with
//    __byte_perm (the byte XOR 0x80 under the exponent bits of 2^23), less
//    2^23 + 128 in f32: exact for every byte, on the integer and FMA pipes.
//  - Each row of a score sums over d in K6's order; P rounds to bf16
//    against the 128-position chunk's max (K6: the 256-position chunk's),
//    and the chunks are combined by K6's combine pass
//    (decode_cross_combine.cuh) from the same partial records.
//
// The ring's phases: a team's consumers wait for the full barrier's phase
// of parity (g / kStages) & 1 of their item g. Before a team reaches item
// g it has finished item g - kTeams, so the producer has loaded at least
// up to it; with kStages >= kTeams the stage's barrier is then at most one
// phase behind, where a parity wait is exact.
#include "decode_cross_combine.cuh"
#include "sm90.cuh"

namespace {

namespace sm = spt::sm90;
using spt::decode_cross::decode_cross_q_combine;
using spt::decode_cross::kD;
using spt::decode_cross::kMaxR;
using spt::decode_cross::kRec;

constexpr int kHeads = 2;   // heads per item (one TMA box)
// Ring depth: kStages1 for one query row (a decode step) on the TMA path,
// kStagesN otherwise (more rows, the prefill's 3 or 4, or cp.async
// covers), as timed on the card.
constexpr int kStages1 = 4;
constexpr int kStagesN = 5;
template <bool kTma, int R>
constexpr int kRing = kTma && R == 1 ? kStages1 : kStagesN;
constexpr int kChunk = 128;                // positions per item: 4 per lane
constexpr int kWarps = 8;                  // consumer warps
constexpr int kTeams = kWarps / kHeads;    // a team takes an item
// Producer warps: one issues the TMA boxes; four issue the cp.async covers.
template <bool kTma>
constexpr int kProducers = kTma ? 1 : 4;
template <bool kTma>
constexpr int kThreads = 32 * (kWarps + kProducers<kTma>);
constexpr int kRows = kHeads * kD;         // K (or V) rows of an item
static_assert(kStages1 >= kTeams && kStagesN >= kTeams,
              "the parity waits need a ring of at least kTeams stages");

// Shared memory: the stages (K rows, then V rows), q per warp ([64][8]
// f32), the barriers. A warp writes bf16(p * vs) ([R][128] f32, at most 4
// KB) over its head's K rows (8 KB) once its scores are summed.
template <bool kTma, int R>
struct Smem {
  static constexpr int kDepth = kRing<kTma, R>;
  static constexpr int kRowBytes = kTma ? kChunk : kChunk + 16;
  static constexpr int kStageBytes = 2 * kRows * kRowBytes;
  static constexpr int kQOffset = kDepth * kStageBytes;
  static constexpr int kBarOffset = kQOffset + kWarps * kD * 8 * 4;
  static constexpr int kAlloc = kBarOffset + 2 * kDepth * 8 + 1024;
};

struct Item {
  int b, h0, c, t0;
};

__device__ __forceinline__ Item item_at(int i, int groups, int nchunks) {
  Item it;
  it.c = i % nchunks;
  it.h0 = i / nchunks % groups * kHeads;
  it.b = i / nchunks / groups;
  it.t0 = it.c * kChunk;
  return it;
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed;
// the barrier's count includes the arrival.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// Four int8 in a word -> four exact floats, without I2F.
__device__ __forceinline__ void widen4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;  // each byte x + 128, 0..255
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) - 8388736.f;
}

// Word k (positions 4k..4k+3 of the item) of a stage row. TMA rows hold
// the slice from byte 0; cp.async rows from byte `shift` (0..15).
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

// cp.async path: copy bytes [t0, t1) of `rows` rows of the slab (ld bytes
// apart from `src`) into rows of kChunk + 16 bytes, as the aligned 16-byte
// chunks that cover each slice. Every chunk holds a byte of the row, so no
// read leaves the tensor's 16-byte granules.
__device__ __forceinline__ void stage_covers(uint8_t* dst, const int8_t* src,
                                             int rows, long long ld, int t0,
                                             int t1, int first, int stride) {
  constexpr int kSegs = (kChunk + 16) / 16;
  for (int i = first; i < rows * kSegs; i += stride) {
    const int row = i / kSegs, seg = i % kSegs;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(src) +
                         static_cast<uintptr_t>(row) * ld + t0;
    const uintptr_t a = (lo & ~static_cast<uintptr_t>(15)) + 16 * seg;
    if (a < lo + (t1 - t0))
      spt::cp_async_16(dst + row * (kChunk + 16) + 16 * seg,
                       reinterpret_cast<const void*>(a));
  }
}

template <bool kTma, int R>
__global__ void __launch_bounds__(kThreads<kTma>, 1)
    decode_cross_mh_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __nv_bfloat16* __restrict__ q,
                           const int8_t* __restrict__ qk,
                           const float* __restrict__ ks,
                           const int8_t* __restrict__ qv,
                           const float* __restrict__ vs,
                           float* __restrict__ part, int B, int H, int Tk,
                           int kv_len, long long qsb, long long qsh,
                           long long qsr, long long ld) {
  using S = Smem<kTma, R>;
  constexpr int kStages = S::kDepth;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (sm::smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t bars = sm::smem_u32(base) + S::kBarOffset;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (H + kHeads - 1) / kHeads;
  const int nchunks = (kv_len + kChunk - 1) / kChunk;
  const int n_items = B * groups * nchunks;

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
      const Item it = item_at(i, groups, nchunks);
      uint8_t* st = base + s * S::kStageBytes;
      const int row0 = (it.b * H + it.h0) * kD;
      if constexpr (kTma) {
        if (pt == 0) {
          sm::mbar_expect_tx(full(s), S::kStageBytes);
          sm::tma_load_2d(sm::smem_u32(st), &tm_k, full(s), it.t0, row0);
          sm::tma_load_2d(sm::smem_u32(st + kRows * S::kRowBytes), &tm_v, full(s),
                      it.t0, row0);
        }
      } else {
        // Rows of heads past H are not copied (no consumer reads them).
        const int rows = min(kHeads, H - it.h0) * kD;
        const int t1 = min(it.t0 + kChunk, kv_len);
        const size_t off = static_cast<size_t>(row0) * ld;
        constexpr int kN = 32 * kProducers<kTma>;
        stage_covers(st, qk + off, rows, ld, it.t0, t1, pt, kN);
        stage_covers(st + kRows * S::kRowBytes, qv + off, rows, ld, it.t0, t1,
                     pt, kN);
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
    const Item it = item_at(i, groups, nchunks);
    const int h = it.h0 + hh;
    const bool mine = h < H;
    const int bh = it.b * H + h;

    // Loads that need no stage: the scales of this lane's positions, q.
    float ksc[4], vsc[4];
    bool live[4];
    if (mine) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = it.t0 + 4 * lane + j;
        live[j] = t < kv_len;
        const size_t at = static_cast<size_t>(bh) * Tk + t;
        ksc[j] = live[j] ? ks[at] : 0.f;
        vsc[j] = live[j] ? vs[at] : 0.f;
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
      const uint8_t* kst = base + s * S::kStageBytes + hh * kD * S::kRowBytes;
      const uint8_t* vst = kst + kRows * S::kRowBytes;
      // Slab address of this head's row 0 at t0: a row's cp.async slice
      // starts at its address's offset in 16 bytes.
      const uintptr_t k0 = reinterpret_cast<uintptr_t>(qk) +
                           static_cast<size_t>(bh) * kD * ld + it.t0;
      const uintptr_t v0 = reinterpret_cast<uintptr_t>(qv) +
                           static_cast<size_t>(bh) * kD * ld + it.t0;

      // Scores: s[r][j] for positions t0 + 4 lane + j, summed over d in
      // K3's order.
      float sc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[r][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < kD; ++d) {
        float f[4];
        widen4(row_word<kTma>(kst + d * S::kRowBytes, lane,
                              static_cast<int>((k0 + d * ld) & 15)),
               f);
        float qd[8];
        *reinterpret_cast<float4*>(qd) = *reinterpret_cast<const float4*>(qsw + d * 8);
        if constexpr (R > 4)
          *reinterpret_cast<float4*>(qd + 4) =
              *reinterpret_cast<const float4*>(qsw + d * 8 + 4);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[r][j] = fmaf(qd[r], f[j], sc[r][j]);
      }

      // Mask before the max; p = exp(s - m_chunk); l sums the f32 p; PV
      // reads bf16(p * vs), written over the K rows that the scores read.
      __syncwarp();
      float* pvw = reinterpret_cast<float*>(base + s * S::kStageBytes +
                                            hh * kD * S::kRowBytes);
      float* rec = part + (static_cast<size_t>(bh) * nchunks + it.c) * R * kRec;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[r][j] = live[j] ? sc[r][j] * ksc[j] : -INFINITY;
          mx = fmaxf(mx, sc[r][j]);
        }
        mx = spt::warp_max(mx);
        float ls = 0.f, pw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = live[j] ? expf(sc[r][j] - mx) : 0.f;
          ls += p;
          pw[j] = __bfloat162float(__float2bfloat16_rn(p * vsc[j]));
        }
        ls = spt::warp_sum(ls);
        *reinterpret_cast<float4*>(pvw + r * kChunk + 4 * lane) =
            *reinterpret_cast<const float4*>(pw);
        if (lane == 0) {
          rec[r * kRec + kD] = mx;
          rec[r * kRec + kD + 1] = ls;
        }
      }
      __syncwarp();

      // o[r, d] for d = lane and lane + 32, over the 32 words of the two V
      // rows, word (i + lane) % 32 at step i.
      float a0[R], a1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a0[r] = a1[r] = 0.f;
      const int sh0 = static_cast<int>((v0 + lane * ld) & 15);
      const int sh1 = static_cast<int>((v0 + (lane + 32) * ld) & 15);
      const uint8_t* vr0 = vst + lane * S::kRowBytes;
      const uint8_t* vr1 = vst + (lane + 32) * S::kRowBytes;
#pragma unroll 4
      for (int step = 0; step < 32; ++step) {
        const int k = (step + lane) & 31;
        float f0[4], f1[4];
        widen4(row_word<kTma>(vr0, k, sh0), f0);
        widen4(row_word<kTma>(vr1, k, sh1), f1);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(pvw + r * kChunk + 4 * k);
          a0[r] = fmaf(p4.x, f0[0], a0[r]);
          a0[r] = fmaf(p4.y, f0[1], a0[r]);
          a0[r] = fmaf(p4.z, f0[2], a0[r]);
          a0[r] = fmaf(p4.w, f0[3], a0[r]);
          a1[r] = fmaf(p4.x, f1[0], a1[r]);
          a1[r] = fmaf(p4.y, f1[1], a1[r]);
          a1[r] = fmaf(p4.z, f1[2], a1[r]);
          a1[r] = fmaf(p4.w, f1[3], a1[r]);
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

// A 2-D map over an int8 slab of `rows` rows of Tk positions, ld bytes
// apart (ld % 16 == 0): boxes of kChunk positions x kRows rows, no
// swizzle, past Tk and past the last row filled with zeros. The map's
// width is Tk, so no byte of a row's padding past Tk is read.
int encode_slab(CUtensorMap* map, const void* ptr, long long rows, int Tk,
                long long ld) {
  const sm::EncodeTiledFn enc = sm::encoder();
  if (enc == nullptr) return sm::kErrNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Tk),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {kChunk, kRows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : sm::kErrEncode + static_cast<int>(r);
}

template <bool kTma, int R>
int launch_rows(const void* q, const void* qk, const void* ks, const void* qv,
                const void* vs, void* part, int B, int H, int Tk, int kv_len,
                int num_sms, long long qsb, long long qsh, long long qsr,
                long long ld, cudaStream_t st) {
  CUtensorMap mk{}, mv{};
  if (kTma) {
    const long long rows = static_cast<long long>(B) * H * kD;
    int err = encode_slab(&mk, qk, rows, Tk, ld);
    if (err == 0) err = encode_slab(&mv, qv, rows, Tk, ld);
    if (err != 0) return err;
  }
  constexpr int kSmem = Smem<kTma, R>::kAlloc;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_cross_mh_kernel<kTma, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const long long items = static_cast<long long>(B) * ((H + kHeads - 1) / kHeads) *
                          ((kv_len + kChunk - 1) / kChunk);
  const int grid = static_cast<int>(items < num_sms ? items : num_sms);
  decode_cross_mh_kernel<kTma, R><<<grid, kThreads<kTma>, kSmem, st>>>(
      mk, mv, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(qk), static_cast<const float*>(ks),
      static_cast<const int8_t*>(qv), static_cast<const float*>(vs),
      static_cast<float*>(part), B, H, Tk, kv_len, qsb, qsh, qsr, ld);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* qk, const void* ks, const void* qv,
           const void* vs, void* part, void* o, int B, int H, int R,
           int Tk, int kv_len, int num_sms, int tma, long long qsb,
           long long qsh, long long qsr, long long ld, long long osb,
           long long osh, long long osr, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_sms < 1 || ld < Tk) return static_cast<int>(cudaErrorInvalidValue);
  if (tma && (ld % 16 != 0 || reinterpret_cast<uintptr_t>(qk) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(qv) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (R) {
#define SPT_ROWS(n)                                                           \
  case n:                                                                     \
    err = (tma ? launch_rows<true, n> : launch_rows<false, n>)(               \
        q, qk, ks, qv, vs, part, B, H, Tk, kv_len, num_sms, qsb, qsh, qsr, ld, \
        st);                                                                  \
    break;
    SPT_ROWS(1) SPT_ROWS(2) SPT_ROWS(3) SPT_ROWS(4)
    SPT_ROWS(5) SPT_ROWS(6) SPT_ROWS(7) SPT_ROWS(8)
#undef SPT_ROWS
  }
  if (err != 0) return err;
  const int nchunks = (kv_len + kChunk - 1) / kChunk;
  decode_cross_q_combine<<<B * H, kMaxR * kD, 0, st>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(o), H, R,
      nchunks, osb, osh, osr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3 and K11. q: [B, H, R, 64] bf16 with strides (qsb, qsh, qsr, 1); qk, qv int8 [B, H, 64, Tk], rows ld >= Tk bytes apart with
// strides (H*64*ld, 64*ld, ld, 1) (per batch item one [H*64, Tk] slab of
// pitch ld); ks, vs contiguous f32 [B, H, Tk]; part: f32 scratch [B*H,
// ceil(kv_len/128), R, 66]; o: [B, H, R, 64] bf16 with strides (osb,
// osh, osr, 1). tma:
// the load path the host chose (ops/attention.py: decode_cross_load_path),
// TMA boxes (ld and both slabs 16-byte aligned) or 16-byte cp.async
// covers. num_sms: the card's SM count, the grid's size.
SPT_API int spt_decode_cross_attention_q8(
    const void* q, const void* qk, const void* ks, const void* qv,
    const void* vs, void* part, void* o, int B, int H, int R, int Tk,
    int kv_len, int num_sms, int tma, long long qsb, long long qsh,
    long long qsr, long long ld, long long osb, long long osh, long long osr,
    void* stream) {
  return launch(q, qk, ks, qv, vs, part, o, B, H, R, Tk, kv_len, num_sms, tma,
                qsb, qsh, qsr, ld, osb, osh, osr, stream);
}
