// K14: decoder cross-attention with both products int8 x int8 -> int32
// (the "w8a8" decoder) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA,
// in the "qw8" branch of _cross_attention in
// spittle_tpu/models/whisper/model.py. It is written by hand because
// PyTorch has no integer matmul on CUDA, and an f32 product is not exact
// for P . V (sums reach 1500 * 127 * 127, above 2^24).
//
// The function, in the reference's order, for every (item, head, row):
//   sq = amax|q| / 127 (1 where 0), qq = clip(rint(q / sq), -127, 127);
//   s[t] = f32(int32 qq . K[:, t]) * sq * ks[t], masked to t < kv_len
//   before the max; p = e / sum(e) with e = exp(s - max);
//   pv = p * vs, sp = max(pv) / 127 (1 where 0),
//   qp = clip(rint(pv / sp), 0, 127);
//   out = f32(int32 qp . V[d, :]) * sp, rounded to q's type.
// The divisions are IEEE (no fast math) and rint rounds half to even, as
// jnp.round does.
//
// What bounds it on an H100: bytes at a decode step's few rows, the int8
// K and V read once (B 8, H 20, T 1500: 31 MB, 0.0098 ms with the
// scales); at a prefill's hundreds of rows, the per-score f32 work (an
// exp and two IEEE divisions per row and position). In practice the
// chain of dependent steps each CTA runs (loads, scores, three
// reductions across the cluster, P . V, the combine) sets its time;
// probes/w8a8_cross_parts.py times its phases.
//
// Design: T split over a thread-block cluster. Each (item, head, row
// tile) is one cluster of C CTAs (grid (C, row tiles, B * H), so a head's
// row tiles run next to each other and its K/V stay in L2); rank c takes
// positions [c * slice, (c + 1) * slice) of T, slice a multiple of 16
// (32 on the tensor cores), and the host's plan (ops/attention.py:
// w8a8_plan) picks C, the slice, the row tile and the shared memory.
//  - Loads: each CTA copies its slice of K's and V's Dh rows and of both
//    scales into shared memory with cp.async, in chunks of 16 bytes where
//    the slab's pointer and strides allow (the decoder's rows of
//    tma_pitch), else 4, else 1: K and the scales in one group, V in a
//    second, which stays in flight through the scores and the three
//    reductions. (One bulk copy per row, cp.async.bulk on an mbarrier,
//    timed no faster.) Where a slice of K and V does not fit beside the
//    scores (T past ~12,000 at Dh 64 and 8 rows), the plan streams them:
//    only the scales are copied, and the __dp4a products read K and V
//    from global memory (4-byte words where the granule is 4 or 16, else
//    bytes), so that a CTA's shared memory is ~13 bytes per position and
//    row (T up to ~140,000 at one row per CTA).
//  - Scores, two regimes of one kernel. Up to 8 rows, or any head dim
//    that is not a multiple of 32 (in row tiles of up to 8): __dp4a, each
//    thread reading a 4 x 4 byte block (4 head dims x 4 positions) and
//    transposing it with prmt into one word of 4 head dims per position,
//    for the rows rounded up to 1, 2, 4 or 8 at once; 128 threads. Past 8
//    rows with Dh a multiple of 32: mma.sync m16n8k32 s8 on the int8
//    tensor cores, in row tiles of 32 or 64 (16 where T is long), 512
//    threads (the row passes' f32 work in twice the chains of 256, which
//    were slower at a tile of 64). Q . K reduces over Dh, K's row index,
//    so the slice is transposed once in shared memory (the same prmt
//    blocks) and serves every row of the tile; P . V reduces over T,
//    which V's rows hold contiguous as they are. (The tensor cores at a
//    step's few rows, in a tile of 16, were slower than __dp4a.)
//  - Row passes: each warp takes a few rows at once, a group of lanes per
//    row, four positions a lane at a time. Three reductions across the
//    cluster through distributed shared memory: each CTA stores its rows'
//    values into slot [rank] of every rank's array with st.async, which
//    completes its bytes on that rank's mbarrier for the reduction, and
//    reads the C slots at home once its own mbarrier has them all: the
//    row max over live positions, the sum of e (taken over the ranks in
//    rank order, so every CTA holds the same bits) and max(pv). Then each
//    CTA writes P's codes for its slice. The divisions by the row's sum
//    and by P's scale take a correctly rounded reciprocal and two FMA
//    corrections (div_fma), the IEEE quotient.
//  - Combine: row r belongs to rank r % C. Each CTA stores its int32
//    partials qp . V into their owners' arrays the same way, and each
//    owner, once its mbarrier has every rank's, sums its rows over the
//    ranks (int32: exact in any order), scales by sp and stores. One
//    launch, one cluster barrier (before the first store into a peer,
//    which may not have started), no atomics, no combine pass. A CTA
//    whose slice lies past kv_len (or past T) still stores -inf, 0, 0 and
//    zero partials, so every mbarrier completes; no CTA reads a peer's
//    shared memory, and none is written once its last mbarrier has
//    completed, so a CTA may leave then.
//  - Code size: the loops are not unrolled beyond their four positions,
//    and the lane groups are a run-time width: copies of the kernel with
//    such loops unrolled and specialised, several times the size, ran
//    slower.
#include "sm90.cuh"

namespace sm = spt::sm90;

namespace {

constexpr int kMaxDh = 256;
constexpr int kMaxCluster = 8;
constexpr int kDp4aRows = 8;  // rows per CTA at most on the __dp4a regime
// Dynamic shared memory per CTA at most (ops/attention.py:W8A8_SMEM_BUDGET).
constexpr int kSmemBudget = 232448;

#define SPT_W8A8_THREADS(mma) ((mma) ? 512 : 128)

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The CTA's shared memory, in bytes from the base (ops/attention.py:
// w8a8_smem_bytes computes the same total for the plan, and the card tests
// hold it to spt_w8a8_smem_bytes). Rows of int8 K, V and P codes
// are the slice + 16 bytes long, rows of q codes and of the transposed K
// Dh + 16, rows of f32 scores the slice + 16 floats: with these pitches
// the tensor cores' fragment loads and the row passes' 16-byte loads hit
// distinct banks. This CTA's int32 partials [RT][Dh] take the scores'
// space once the codes are made; the
// partials that peers store for this rank's rows ([C][ceil(RT / C)][Dh])
// take K's once the scores are made (the transposed K's on the
// tensor-core regime, whose K as loaded gives way to the scores). The row
// slots: q's and P's scales, and the three reductions' [C][RT] arrays;
// then four mbarriers. On the __dp4a regime q's and P's codes have room for
// RT rows rounded up to 1, 2, 4 or 8 (pow2_rows). Streamed (stream, on
// __dp4a only), K and V stay in global memory: the scores, then the
// peers' partials, then the rest.
__host__ __device__ constexpr int pow2_rows(int nr) {
  return nr <= 1 ? 1 : nr <= 2 ? 2 : nr <= 4 ? 4 : 8;
}

struct Layout {
  int sp, dhp, sf, rpo;
  int k, v, kt, s, recv, qq, codes, kss, vss, rows, bars, total;
  __host__ __device__ Layout(bool mma, bool stream, int S, int RT, int Dh, int C) {
    sp = S + 16;
    dhp = Dh + 16;
    sf = S + 16;
    rpo = (RT + C - 1) / C;
    const int kbytes = Dh * sp, sbytes = imax(RT * sf * 4, RT * Dh * 4);
    const int rbytes = C * rpo * Dh * 4;
    int o = 0;
    k = v = kt = 0;
    if (mma) {  // K (then the scores), V, the transposed K (then the partials)
      s = o;
      o += align16(imax(kbytes, sbytes));
      v = o;
      o += align16(kbytes);
      kt = recv = o;
      o += align16(imax(S * dhp, rbytes));
    } else if (stream) {  // the scores, the partials
      s = o;
      o += align16(sbytes);
      recv = o;
      o += align16(rbytes);
    } else {  // K (then the partials), the scores, V
      k = recv = o;
      o += align16(imax(kbytes, rbytes));
      s = o;
      o += align16(sbytes);
      v = o;
      o += align16(kbytes);
    }
    const int crows = mma ? RT : pow2_rows(RT);  // rows of q's and P's codes
    qq = o;
    o += align16(crows * dhp);
    codes = o;
    o += align16(crows * sp);
    kss = o;
    o += align16(S * 4);
    vss = o;
    o += align16(S * 4);
    rows = o;
    o += align16((2 + 3 * C) * RT * 4);
    bars = o;  // four mbarriers: the three reductions, the partials
    o += 32;
    total = o;
  }
};

struct Params {
  const void* q;
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;
  void* out;
  int H, R, Dh, Tk, kv_len;
  int slice, row_tile;
  int k_gran, v_gran;  // the rows' granule in bytes: 16, 4 or 1
  long long q_sb, q_sh, q_sr, k_sb, k_sh, k_ld, v_sb, v_sh, v_ld;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---- cp.async and the cluster ----------------------------------------------

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_size() {
  int n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// The cluster's one barrier, in two halves: every CTA arrives once its
// mbarriers are set up (release: their initialisation is visible to the
// peers after the wait) and waits before its first store into a peer.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// x into the word at `p` (an address of this CTA's shared memory) in rank
// `peer`'s copy, completing 4 bytes on the peer's mbarrier at `bar` (an
// address of this CTA's shared memory too).
__device__ __forceinline__ void st_async(float* p, int peer, float x, uint32_t bar) {
  const unsigned a = sm::smem_u32(p);
  unsigned ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(peer));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(bar), "r"(peer));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(ra),
      "f"(x), "r"(rb)
      : "memory");
}

__device__ __forceinline__ void st_async4(int* p, int peer, int4 x, uint32_t bar) {
  const unsigned a = sm::smem_u32(p);
  unsigned ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(peer));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(bar), "r"(peer));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(ra),
      "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w), "r"(rb)
      : "memory");
}

// Wait for phase `parity` of the mbarrier at `bar`, whose bytes peers store
// (acquire at cluster scope); traps after ~2^26 polls, as sm90's mbar_wait.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// Max and sum over aligned groups of g lanes (g a power of two).
__device__ __forceinline__ float group_max(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- loads and the 4 x 4 transposition ----------------------------------------

// Positions [0, n) of `rows` slab rows (row d at src + d * ld) into rows
// of `pitch` bytes at dst, in chunks of `gran` bytes. A 16- or 4-byte
// chunk may run past n, never past the row's pitch (the host picks the
// granule from the slab's pointer and strides, and ld >= Tk).
__device__ __forceinline__ void load_rows(int8_t* dst, int pitch, const int8_t* src,
                                          long long ld, int rows, int n, int gran,
                                          int nthreads) {
  if (n <= 0) return;
  if (gran == 1) {
    for (int i = threadIdx.x; i < rows * n; i += nthreads) {
      const int d = i / n, c = i - d * n;
      dst[d * pitch + c] = src[d * ld + c];
    }
    return;
  }
  const int shift = gran == 16 ? 4 : 2;
  const int per = (n + gran - 1) >> shift;
  for (int i = threadIdx.x; i < rows * per; i += nthreads) {
    const int d = i / per, c = (i - d * per) << shift;
    if (gran == 16)
      spt::cp_async_16(dst + d * pitch + c, src + d * ld + c);
    else
      cp_async_4(dst + d * pitch + c, src + d * ld + c);
  }
}

__device__ __forceinline__ void load_f32(float* dst, const float* src, int n,
                                         int nthreads) {
  for (int i = threadIdx.x; i < n; i += nthreads) cp_async_4(dst + i, src + i);
}

// Four positions of four rows (pitch bytes apart, 4-byte aligned) -> one
// word per position holding its four codes, the first row in the low byte.
__device__ __forceinline__ void transpose_4x4(const int8_t* p, long long pitch, uint32_t c[4]) {
  const uint32_t a0 = spt::ld_u32(p), a1 = spt::ld_u32(p + pitch);
  const uint32_t a2 = spt::ld_u32(p + 2 * pitch), a3 = spt::ld_u32(p + 3 * pitch);
  const uint32_t x0 = __byte_perm(a0, a1, 0x5140);  // a0.b0 a1.b0 a0.b1 a1.b1
  const uint32_t x1 = __byte_perm(a0, a1, 0x7362);  // a0.b2 a1.b2 a0.b3 a1.b3
  const uint32_t y0 = __byte_perm(a2, a3, 0x5140);
  const uint32_t y1 = __byte_perm(a2, a3, 0x7362);
  c[0] = __byte_perm(x0, y0, 0x5410);
  c[1] = __byte_perm(x0, y0, 0x7632);
  c[2] = __byte_perm(x1, y1, 0x5410);
  c[3] = __byte_perm(x1, y1, 0x7632);
}

// The same from rows without 4-byte alignment (streamed from global
// memory), byte by byte; positions from `left` on read as 0.
__device__ __forceinline__ void transpose_4x4_bytes(const int8_t* p, long long pitch, int left,
                                                    uint32_t c[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t w = 0;
    if (j < left) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w |= static_cast<uint32_t>(static_cast<uint8_t>(p[i * pitch + j])) << (8 * i);
    }
    c[j] = w;
  }
}

// Four positions of one row: a 4-byte word, or bytes (0 from `left` on).
__device__ __forceinline__ int ld_word(const int8_t* p, bool bytes, int left) {
  if (!bytes) return *reinterpret_cast<const int*>(p);
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < left) w |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * j);
  return static_cast<int>(w);
}

// A score as the reference forms it, -inf past kv_len (tt, live: the
// position and the live positions, both from the slice's start).
__device__ __forceinline__ float score(int acc, float sqr, float ksv, int tt, int live) {
  const float sc = static_cast<float>(acc) * sqr * ksv;
  return tt < live ? sc : -INFINITY;
}

// ---- the __dp4a regime's products -----------------------------------------------

// The __dp4a loops run the rows rounded up to 1, 2, 4 or 8 (pow2_rows)
// unconditionally (q's and P's codes have that many rows of room; rows
// past nr are made and dropped).

// The scores of NR rows, a thread per word of four positions, from K's
// slice at kbuf with rows ld bytes apart (shared memory, or global memory
// when streamed; bytes: rows without 4-byte alignment).
template <int NR>
__device__ __forceinline__ void scores_dp4a(const int8_t* kbuf, long long ld, bool bytes,
                                            const int8_t* qq, const float* sq, const float* kss,
                                            float* s, const Layout& L, int Dh, int n, int nr,
                                            int live, int nthreads) {
  for (int w = threadIdx.x; 4 * w < n; w += nthreads) {
    const int tt = 4 * w;
    int acc[NR][4] = {};
    for (int d0 = 0; d0 < Dh; d0 += 4) {
      uint32_t kc[4];
      if (bytes)
        transpose_4x4_bytes(kbuf + d0 * ld + tt, ld, n - tt, kc);
      else
        transpose_4x4(kbuf + d0 * ld + tt, ld, kc);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int qa = *reinterpret_cast<const int*>(qq + r * L.dhp + d0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[r][j] = __dp4a(qa, static_cast<int>(kc[j]), acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r < nr) {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = score(acc[r][j], sq[r], kss[tt + j], tt + j, live);
        *reinterpret_cast<float4*>(s + r * L.sf + tt) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

// This rank's partials qp . V of NR rows into part [nr][Dh]: ns lanes
// per head dim (a power of two), each over every ns-th word of four
// positions up to the live ones. V's rows are ld bytes apart (bytes: as
// in scores_dp4a), P's codes' sp.
template <int NR>
__device__ __forceinline__ void pv_dp4a(const int8_t* vbuf, long long ld, bool bytes,
                                        const int8_t* codes, int* part, int sp, int Dh, int nr,
                                        int live, int warp, int lane, int nthreads) {
  int ns = 1;
  while (ns < 32 && 2 * ns * Dh <= nthreads) ns *= 2;
  const int words = (live + 3) >> 2;
  for (int u0 = warp * 32; u0 < Dh * ns; u0 += nthreads) {
    const int u = u0 + lane, d = u / ns, sub = u - d * ns;
    const bool on = u < Dh * ns;
    int acc[NR] = {};
    if (on) {
      const int8_t* vr = vbuf + d * ld;
      for (int w = sub; w < words; w += ns) {
        const int vw = ld_word(vr + 4 * w, bytes, live - 4 * w);
#pragma unroll
        for (int r = 0; r < NR; ++r)
          acc[r] = __dp4a(*reinterpret_cast<const int*>(codes + r * sp + 4 * w), vw, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r < nr) {
        for (int o = ns >> 1; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
        if (on && sub == 0) part[r * Dh + d] = acc[r];
      }
    }
  }
}

// ---- q's codes -------------------------------------------------------------------

// q's rows r0 + r over Dh (rows r < RT of the tile; codes 0 past nr), a
// group of G lanes per row: a warp takes rows 32 / G * warp + lane / G, so
// that its rows' loads are in flight together.
template <typename T>
__device__ __forceinline__ void quantize_q(const T* qb, long long q_sr, int8_t* qq,
                                           float* sq, int dhp, int RT, int nr, int r0,
                                           int Dh, int G, int warp, int lane) {
  const int r = (32 / G) * warp + lane / G, sub = lane & (G - 1);
  const T* qr = qb + static_cast<long long>(r0 + r) * q_sr;
  float amax = 0.f;
  if (r < nr) {
    for (int d = sub; d < Dh; d += G) amax = fmaxf(amax, fabsf(to_f32(qr[d])));
  }
  amax = group_max(amax, G);
  const float scale = amax > 0.f ? amax / 127.f : 1.f;
  if (r < RT) {
    for (int d = sub; d < Dh; d += G) {
      float c = 0.f;
      if (r < nr) c = fminf(fmaxf(rintf(to_f32(qr[d]) / scale), -127.f), 127.f);
      qq[r * dhp + d] = static_cast<int8_t>(c);
    }
    if (sub == 0) sq[r] = scale;
  }
}

// ---- the row passes ------------------------------------------------------------

// What the row passes read and write: the scores (then e, then pv) [RT][sf],
// P's codes [RT][sp], V's scales over the slice, the row slots (sq [RT],
// sp [RT], then red_m, red_l, red_p, each [C][RT]).
struct Rows {
  float* s;
  int8_t* codes;
  const float* vss;
  float* sq;
  int sf, sp, RT, nr, n, live, S, C, rank;
  uint32_t bar_m, bar_l, bar_p;  // the three reductions' mbarriers
};

// a / b rounded to nearest even, as __fdiv_rn gives it, from y = 1/b
// correctly rounded (__frcp_rn, once per row) and two FMA corrections
// (Markstein): the first makes the quotient faithful, the second correctly
// rounded, where nothing underflows (csrc/fullkv_attention_q8.cu's
// div_fma, whose bits its card tests hold). The row passes take it where
// the dividend (e over l >= 1) or the divisor (sp, the quotient then
// rounded to a code) is at least kMinFmaDiv, and __fdiv_rn otherwise.
constexpr float kMinFmaDiv = 0x1p-100f;
__device__ __forceinline__ float div_fma(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
  return __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
}

// P's code of pv / sp (0..127).
__device__ __forceinline__ uint32_t code_of(float pv, float sp, float ysp, bool fast) {
  const float x = fast ? div_fma(pv, sp, ysp) : __fdiv_rn(pv, sp);
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(rintf(x), 0.f), 127.f)));
}

// The three reductions, each row by a group of G lanes: a warp takes rows
// 32 / G * warp + lane / G, a lane the row's chunks of four positions
// sub, sub + G, ... Each row's value goes to slot [rank][r] of every rank
// (the group's lanes take the ranks in turn) by st.async, which completes
// its bytes on that rank's mbarrier for the reduction; once its own
// mbarrier has every rank's bytes, every lane of the group reads the C
// slots at home. Past kv_len the scores are -inf, so e and pv are 0 there,
// and P's codes 0 to the slice's end.
__device__ __forceinline__ void row_passes(const Rows& w, int G, int warp, int lane) {
  const int r = (32 / G) * warp + lane / G, sub = lane & (G - 1);
  const bool on = r < w.nr;
  const int RT = w.RT, C = w.C, rank = w.rank;
  const int nc = (w.n + 3) >> 2, lc = (w.live + 3) >> 2;
  float4* s4 = reinterpret_cast<float4*>(w.s + r * w.sf);
  const float4* vs4 = reinterpret_cast<const float4*>(w.vss);
  float* spr = w.sq + RT;
  float* red_m = w.sq + 2 * RT;
  float* red_l = red_m + C * RT;
  float* red_p = red_l + C * RT;
  float m = -INFINITY;
  if (on) {
    for (int c = sub; c < nc; c += G) {
      const float4 x = s4[c];
      m = fmaxf(m, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
    }
  }
  m = group_max(m, G);
  cluster_wait();  // the start's barrier: every peer has started
  if (on)
    for (int i = sub; i < C; i += G) st_async(red_m + rank * RT + r, i, m, w.bar_m);
  mbar_wait_cluster(w.bar_m, 0);

  float l = 0.f;
  if (on) {
    m = -INFINITY;
    for (int i = 0; i < C; ++i) m = fmaxf(m, red_m[i * RT + r]);
    for (int c = sub; c < lc; c += G) {
      float4 x = s4[c];
      x.x = expf(x.x - m);
      x.y = expf(x.y - m);
      x.z = expf(x.z - m);
      x.w = expf(x.w - m);
      s4[c] = x;
      l += x.x;
      l += x.y;
      l += x.z;
      l += x.w;
    }
  }
  l = group_sum(l, G);
  if (on)
    for (int i = sub; i < C; i += G) st_async(red_l + rank * RT + r, i, l, w.bar_l);
  mbar_wait_cluster(w.bar_l, 0);

  float pa = 0.f;
  if (on) {
    l = 0.f;
    for (int i = 0; i < C; ++i) l += red_l[i * RT + r];  // in rank order
    const float yl = __frcp_rn(l);
    auto pv_of = [&](float e, float vs) {
      return __fmul_rn(e >= kMinFmaDiv ? div_fma(e, l, yl) : __fdiv_rn(e, l), vs);
    };
    for (int c = sub; c < lc; c += G) {
      float4 x = s4[c];
      const float4 v = vs4[c];
      const int tt = 4 * c;
      x.x = tt < w.live ? pv_of(x.x, v.x) : 0.f;
      x.y = tt + 1 < w.live ? pv_of(x.y, v.y) : 0.f;
      x.z = tt + 2 < w.live ? pv_of(x.z, v.z) : 0.f;
      x.w = tt + 3 < w.live ? pv_of(x.w, v.w) : 0.f;
      s4[c] = x;
      pa = fmaxf(pa, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
    }
  }
  pa = group_max(pa, G);
  if (on)
    for (int i = sub; i < C; i += G) st_async(red_p + rank * RT + r, i, pa, w.bar_p);
  mbar_wait_cluster(w.bar_p, 0);

  if (on) {
    pa = 0.f;
    for (int i = 0; i < C; ++i) pa = fmaxf(pa, red_p[i * RT + r]);
    const float scale = pa > 0.f ? pa / 127.f : 1.f;
    const float ys = __frcp_rn(scale);
    const bool fast = scale >= kMinFmaDiv;
    uint32_t* cr = reinterpret_cast<uint32_t*>(w.codes + r * w.sp);
    for (int c = sub; c < (w.S >> 2); c += G) {
      uint32_t word = 0;
      if (c < lc) {
        const float4 x = s4[c];  // pv, 0 past kv_len: so is its code
        word = code_of(x.x, scale, ys, fast) | code_of(x.y, scale, ys, fast) << 8 |
               code_of(x.z, scale, ys, fast) << 16 | code_of(x.w, scale, ys, fast) << 24;
      }
      cr[c] = word;
    }
    if (sub == 0) spr[r] = scale;
  }
}

// ---- the kernel ----------------------------------------------------------------

template <typename T, bool kMma, bool kStream>
__global__ void __launch_bounds__(SPT_W8A8_THREADS(kMma))
    w8a8_cross_kernel(const Params p) {
  constexpr int kThreads = SPT_W8A8_THREADS(kMma);
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.slice, RT = p.row_tile, Dh = p.Dh;
  const int rank = cluster_rank(), C = cluster_size();
  constexpr bool stream = kStream && !kMma;
  const Layout L(kMma, stream, S, RT, Dh, C);
  int8_t* kbuf = reinterpret_cast<int8_t*>(smem + L.k);
  int8_t* vbuf = reinterpret_cast<int8_t*>(smem + L.v);
  int8_t* kt = reinterpret_cast<int8_t*>(smem + L.kt);
  int8_t* qq = reinterpret_cast<int8_t*>(smem + L.qq);
  int8_t* codes = reinterpret_cast<int8_t*>(smem + L.codes);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* kss = reinterpret_cast<float*>(smem + L.kss);
  float* vss = reinterpret_cast<float*>(smem + L.vss);
  float* sq = reinterpret_cast<float*>(smem + L.rows);

  const int bh = blockIdx.z, b = bh / p.H, h = bh - b * p.H;
  const int r0 = blockIdx.y * RT, nr = min(RT, p.R - r0);
  const int t0 = rank * S;
  const int n = max(0, min(S, p.Tk - t0));          // the slice's positions < Tk
  const int live = max(0, min(n, p.kv_len - t0));   // of them, those < kv_len
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x;
  const int mine = nr > rank ? (nr - rank + C - 1) / C : 0;  // rows r % C == rank
  // Lanes per row in the row-wise steps: 32 over the rows per warp,
  // rounded up to a power of two.
  int lanes = 32;
  while (lanes > 1 && (32 / lanes) * kWarps < RT) lanes >>= 1;

  // 0. The mbarriers: the three reductions' (each expects a float per row
  //    from every rank) and the partials' (Dh int32 per row of this rank
  //    from every rank).
  const uint32_t bar_m = sm::smem_u32(smem + L.bars), bar_l = bar_m + 8;
  const uint32_t bar_p = bar_m + 16, bar_part = bar_m + 24;
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) sm::mbar_init(bar_m + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm::mbar_expect_tx(bar_m, C * nr * 4);
    sm::mbar_expect_tx(bar_l, C * nr * 4);
    sm::mbar_expect_tx(bar_p, C * nr * 4);
    sm::mbar_expect_tx(bar_part, C * mine * Dh * 4);
  }
  __syncthreads();
  cluster_arrive();

  // 1. Loads: K and the two scale slices, then V (still in flight through
  //    the scores and the reductions). Streamed, the scales alone, and
  //    the products read K and V where they lie.
  const int8_t* kb = p.k + b * p.k_sb + h * p.k_sh + t0;
  const int8_t* vb = p.v + b * p.v_sb + h * p.v_sh + t0;
  const long long so = static_cast<long long>(bh) * p.Tk + t0;
  if (!stream) load_rows(kbuf, L.sp, kb, p.k_ld, Dh, n, p.k_gran, kThreads);
  load_f32(kss, p.ks + so, n, kThreads);
  load_f32(vss, p.vs + so, n, kThreads);
  cp_async_commit();
  if (!stream) load_rows(vbuf, L.sp, vb, p.v_ld, Dh, n, p.v_gran, kThreads);
  cp_async_commit();
  const int8_t* ksrc = stream ? kb : kbuf;
  const int8_t* vsrc = stream ? vb : vbuf;
  const long long kld = stream ? p.k_ld : L.sp, vld = stream ? p.v_ld : L.sp;
  const bool kbytes = stream && p.k_gran == 1, vbytes = stream && p.v_gran == 1;

  // 2. q's rows quantized over Dh, a group of lanes per row, every row of
  //    a warp at once; rows past R get codes 0 (they are never stored).
  quantize_q(static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_sr, qq, sq, L.dhp,
             RT, nr, r0, Dh, lanes, warp, lane);
  cp_async_wait<1>();
  __syncthreads();

  // 3. Scores of the slice's positions (-inf past kv_len).
  if constexpr (kMma) {
    // K's slice transposed to [position][Dh] (4 x 4 blocks, one per
    // thread at a time), then m16n8k32 tiles: warp w takes row block
    // w % (RT / 16) and every (warps / (RT / 16))-th column tile of 8
    // positions.
    const int words = (n + 3) >> 2, dq = Dh >> 2;
    for (int i = tid; i < words * dq; i += kThreads) {
      const int w = i / dq, d0 = (i - w * dq) << 2;
      uint32_t c[4];
      transpose_4x4(kbuf + d0 * L.sp + 4 * w, L.sp, c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(kt + (4 * w + j) * L.dhp + d0) = c[j];
    }
    __syncthreads();  // K as loaded is dead from here: the scores take its place
    const int blocks = RT >> 4, parts = kWarps / blocks;
    const int rb = warp % blocks, pt = warp / blocks;
    const int g = lane >> 2, cq = lane & 3;
    const int ra = 16 * rb + g;
    const int ksteps = Dh >> 5;
    uint32_t a[kMaxDh / 32][4];
#pragma unroll
    for (int kk = 0; kk < kMaxDh / 32; ++kk) {
      if (kk < ksteps) {
        const int8_t* qa = qq + ra * L.dhp + 32 * kk + 4 * cq;
        a[kk][0] = spt::ld_u32(qa);
        a[kk][1] = spt::ld_u32(qa + 8 * L.dhp);
        a[kk][2] = spt::ld_u32(qa + 16);
        a[kk][3] = spt::ld_u32(qa + 8 * L.dhp + 16);
      }
    }
    const float sqa = sq[ra], sqb = sq[ra + 8];
    for (int nt = pt; 8 * nt < n; nt += parts) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* kb8 = kt + (8 * nt + g) * L.dhp + 4 * cq;
#pragma unroll
      for (int kk = 0; kk < kMaxDh / 32; ++kk) {
        if (kk < ksteps) {
          const uint32_t bf[2] = {spt::ld_u32(kb8 + 32 * kk), spt::ld_u32(kb8 + 32 * kk + 16)};
          spt::mma_s8_16832(acc, a[kk], bf);
        }
      }
      const int tt = 8 * nt + 2 * cq;
      *reinterpret_cast<float2*>(s + ra * L.sf + tt) =
          make_float2(score(acc[0], sqa, kss[tt], tt, live),
                      score(acc[1], sqa, kss[tt + 1], tt + 1, live));
      *reinterpret_cast<float2*>(s + (ra + 8) * L.sf + tt) =
          make_float2(score(acc[2], sqb, kss[tt], tt, live),
                      score(acc[3], sqb, kss[tt + 1], tt + 1, live));
    }
  } else {
    // A thread per word of four positions, every row at once.
#define SPT_W8A8_SCORES(NR) \
  scores_dp4a<NR>(ksrc, kld, kbytes, qq, sq, kss, s, L, Dh, n, nr, live, kThreads)
    switch (pow2_rows(nr)) {
      case 1: SPT_W8A8_SCORES(1); break;
      case 2: SPT_W8A8_SCORES(2); break;
      case 4: SPT_W8A8_SCORES(4); break;
      default: SPT_W8A8_SCORES(8);
    }
#undef SPT_W8A8_SCORES
  }
  __syncthreads();

  // 4. Row passes and the three cluster reductions.
  const Rows rw{s, codes, vss, sq, L.sf, L.sp, RT, nr, n, live, S, C, rank,
                bar_m, bar_l, bar_p};
  row_passes(rw, lanes, warp, lane);
  cp_async_wait<0>();
  __syncthreads();

  // 5. This rank's int32 partials qp . V [rows x Dh], over the scores'
  //    space. Codes past the live positions are 0, so V's words there
  //    (never loaded) add nothing.
  int* part = reinterpret_cast<int*>(smem + L.s);
  if constexpr (kMma) {
    const int blocks = RT >> 4, parts = kWarps / blocks;
    const int rb = warp % blocks, pt = warp / blocks;
    const int g = lane >> 2, cq = lane & 3;
    const int ra = 16 * rb + g;
    const int kend = (live + 31) & ~31;
    for (int nt = pt; 8 * nt < Dh; nt += parts) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* vr = vbuf + (8 * nt + g) * L.sp + 4 * cq;
      const int8_t* ca = codes + ra * L.sp + 4 * cq;
      for (int k0 = 0; k0 < kend; k0 += 32) {
        const uint32_t af[4] = {spt::ld_u32(ca + k0), spt::ld_u32(ca + 8 * L.sp + k0),
                                spt::ld_u32(ca + k0 + 16),
                                spt::ld_u32(ca + 8 * L.sp + k0 + 16)};
        const uint32_t bf[2] = {spt::ld_u32(vr + k0), spt::ld_u32(vr + k0 + 16)};
        spt::mma_s8_16832(acc, af, bf);
      }
      const int d = 8 * nt + 2 * cq;
      *reinterpret_cast<int2*>(part + ra * Dh + d) = make_int2(acc[0], acc[1]);
      *reinterpret_cast<int2*>(part + (ra + 8) * Dh + d) = make_int2(acc[2], acc[3]);
    }
  } else {
#define SPT_W8A8_PV(NR) \
  pv_dp4a<NR>(vsrc, vld, vbytes, codes, part, L.sp, Dh, nr, live, warp, lane, kThreads)
    switch (pow2_rows(nr)) {
      case 1: SPT_W8A8_PV(1); break;
      case 2: SPT_W8A8_PV(2); break;
      case 4: SPT_W8A8_PV(4); break;
      default: SPT_W8A8_PV(8);
    }
#undef SPT_W8A8_PV
  }
  __syncthreads();
  //    Each row's partials, four head dims at a time, into its owner (rank
  //    r % C) at [rank][r / C][d].
  int* recv = reinterpret_cast<int*>(smem + L.recv);
  for (int e4 = tid; 4 * e4 < nr * Dh; e4 += kThreads) {
    const int r = 4 * e4 / Dh, d = 4 * e4 - r * Dh;
    st_async4(recv + (rank * L.rpo + r / C) * Dh + d, r % C,
              *reinterpret_cast<const int4*>(part + r * Dh + d), bar_part);
  }
  mbar_wait_cluster(bar_part, 0);

  // 6. Combine: this rank's rows (rank, rank + C, ...), four head dims
  //    per thread, summed over the ranks, scaled by sp and stored.
  T* out = static_cast<T*>(p.out);
  const float* spr = sq + RT;
  for (int e4 = tid; 4 * e4 < mine * Dh; e4 += kThreads) {
    const int lr = 4 * e4 / Dh, d = 4 * e4 - lr * Dh, r = rank + lr * C;
    int4 sum = make_int4(0, 0, 0, 0);
    for (int peer = 0; peer < C; ++peer) {
      const int4 x = *reinterpret_cast<const int4*>(recv + (peer * L.rpo + lr) * Dh + d);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const float scale = spr[r];
    T* o = out + (static_cast<long long>(bh) * p.R + r0 + r) * Dh + d;
    store(o, static_cast<float>(sum.x) * scale);
    store(o + 1, static_cast<float>(sum.y) * scale);
    store(o + 2, static_cast<float>(sum.z) * scale);
    store(o + 3, static_cast<float>(sum.w) * scale);
  }
}

// The largest chunk (16, 4 or 1 bytes) that every row of the slab starts on.
int granule(const void* ptr, long long sb, long long sh, long long ld) {
  const unsigned long long a = reinterpret_cast<uintptr_t>(ptr) |
                               static_cast<unsigned long long>(sb | sh | ld);
  return a % 16 == 0 ? 16 : a % 4 == 0 ? 4 : 1;
}

template <typename T, bool kMma, bool kStream = false>
int launch(const Params& p, int B, int cluster, int smem, cudaStream_t st) {
  auto kernel = w8a8_cross_kernel<T, kMma, kStream>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (p.R + p.row_tile - 1) / p.row_tile, B * p.H);
  cfg.blockDim = dim3(SPT_W8A8_THREADS(kMma));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A K14 CTA's dynamic shared memory under a plan (the Layout's total).
SPT_API int spt_w8a8_smem_bytes(int mma, int stream, int slice, int row_tile, int Dh,
                                int cluster) {
  return Layout(mma != 0, stream != 0 && mma == 0, slice, row_tile, Dh, cluster).total;
}

// K14. q [B, H, R, Dh] (bf16 when q_bf16, else f32) with strides
// (q_sb, q_sh, q_sr, 1); k/v int8 [B, H, Dh, Tk] with strides (sb, sh,
// ld, 1), ld >= Tk; ks/vs contiguous f32 [B, H, Tk]; out contiguous
// [B, H, R, Dh] of q's type. Strides in elements. The plan (ops/
// attention.py:w8a8_plan): mma (the tensor-core regime), the cluster
// size, the positions per rank, the rows per CTA and kv_stream (K and V
// read from global memory, on __dp4a); the shared memory is the Layout's.
SPT_API int spt_decode_cross_attention_w8a8(
    const void* q, const void* k, const void* ks, const void* v,
    const void* vs, void* out, int B, int H, int R, int Dh, int Tk,
    int kv_len, int mma, int cluster, int slice, int row_tile, int kv_stream,
    int q_bf16, long long q_sb, long long q_sh, long long q_sr, long long k_sb,
    long long k_sh, long long k_ld, long long v_sb, long long v_sh,
    long long v_ld, void* stream) {
  const bool ok_regime =
      mma ? (Dh % 32 == 0 && row_tile % 16 == 0 && row_tile <= 128 && slice % 32 == 0 &&
             !kv_stream)
          : (row_tile <= kDp4aRows && slice % 16 == 0);
  if (!ok_regime || B < 1 || H < 1 || R < 1 || row_tile < 1 || Dh % 4 != 0 ||
      Dh > kMaxDh || cluster < 1 || cluster > kMaxCluster || slice < 16 ||
      slice > (1 << 20) || static_cast<long long>(cluster) * slice < Tk || kv_len < 1 ||
      kv_len > Tk || k_ld < Tk || v_ld < Tk || static_cast<long long>(B) * H > 65535 ||
      (R + row_tile - 1) / row_tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = spt_w8a8_smem_bytes(mma, kv_stream, slice, row_tile, Dh, cluster);
  if (smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = static_cast<const int8_t*>(k);
  p.ks = static_cast<const float*>(ks);
  p.v = static_cast<const int8_t*>(v);
  p.vs = static_cast<const float*>(vs);
  p.out = out;
  p.H = H;
  p.R = R;
  p.Dh = Dh;
  p.Tk = Tk;
  p.kv_len = kv_len;
  p.slice = slice;
  p.row_tile = row_tile;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_sr = q_sr;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_ld = k_ld;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_ld = v_ld;
  p.k_gran = granule(k, p.k_sb, p.k_sh, p.k_ld);
  p.v_gran = granule(v, p.v_sb, p.v_sh, p.v_ld);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return mma         ? launch<__nv_bfloat16, true>(p, B, cluster, smem, st)
           : kv_stream ? launch<__nv_bfloat16, false, true>(p, B, cluster, smem, st)
                       : launch<__nv_bfloat16, false>(p, B, cluster, smem, st);
  return mma         ? launch<float, true>(p, B, cluster, smem, st)
         : kv_stream ? launch<float, false, true>(p, B, cluster, smem, st)
                     : launch<float, false>(p, B, cluster, smem, st);
}
