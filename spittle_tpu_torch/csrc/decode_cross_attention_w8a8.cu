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
// K and V read once per block (B 8, H 20, T 1500: 31 MB, 0.0098 ms with
// the scales). This first design is simple and right: one block of 256
// threads per (item, head, tile of up to 8 rows), any number of rows R
// (a prefill's prompt rows tile over the grid's y axis, each tile reading
// the head's K/V again, from L2 mostly). Scores live in shared memory
// (8 rows x 1504 x 4 bytes at T 1500), then one warp per row takes the
// max, the sum, pv and P's codes, and the P . V pass reduces along the
// slab's contiguous T axis. Q . K reduces across K's rows (Dh), so each
// thread reads a 4 x 4 byte block (4 head dims x 4 positions) and
// transposes it with prmt (__byte_perm) into one word of 4 head dims per
// position for __dp4a. Making it fast (TMA, wgmma, a persistent grid,
// K3's producer-fed kernel) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;      // query rows per block at most (a warp each)
constexpr int kMaxDh = 256;
// Dynamic shared memory per block (ops/attention.py:W8A8_SMEM_BUDGET):
// rows_per_block x T rounded to 4 x (4-byte score + 1-byte code).
constexpr int kSmemBudget = 224 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Four positions t..t+3 of four slab rows d0..d0+3 (row pitch ld bytes)
// -> one word per position holding its four int8 codes, row d0 in the
// low byte. vec: the rows are 4-byte aligned, so each row's four bytes
// are one load (past T only into the row's own pitch, whose codes the
// caller never uses); otherwise byte loads below `limit`.
__device__ __forceinline__ void load_4x4(const int8_t* p, long long ld, int t,
                                         int limit, bool vec, uint32_t c[4]) {
  if (vec) {
    const uint32_t a0 = spt::ld_u32(p + t), a1 = spt::ld_u32(p + ld + t);
    const uint32_t a2 = spt::ld_u32(p + 2 * ld + t);
    const uint32_t a3 = spt::ld_u32(p + 3 * ld + t);
    const uint32_t x0 = __byte_perm(a0, a1, 0x5140);  // a0.b0 a1.b0 a0.b1 a1.b1
    const uint32_t x1 = __byte_perm(a0, a1, 0x7362);  // a0.b2 a1.b2 a0.b3 a1.b3
    const uint32_t y0 = __byte_perm(a2, a3, 0x5140);
    const uint32_t y1 = __byte_perm(a2, a3, 0x7362);
    c[0] = __byte_perm(x0, y0, 0x5410);
    c[1] = __byte_perm(x0, y0, 0x7632);
    c[2] = __byte_perm(x1, y1, 0x5410);
    c[3] = __byte_perm(x1, y1, 0x7632);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t w = 0;
    if (t + j < limit) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w |= static_cast<uint32_t>(static_cast<uint8_t>(p[i * ld + t + j]))
             << (8 * i);
    }
    c[j] = w;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    w8a8_cross_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                      const float* __restrict__ ks,
                      const int8_t* __restrict__ v,
                      const float* __restrict__ vs, T* __restrict__ out,
                      int H, int R, int Dh, int Tk, int kv_len, int rows_per_block,
                      long long q_sb, long long q_sh, long long q_sr,
                      long long k_sb, long long k_sh, long long k_ld,
                      long long v_sb, long long v_sh, long long v_ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) int8_t qq[kRows][kMaxDh];
  __shared__ float sq[kRows], sp[kRows];

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int r0 = blockIdx.y * rows_per_block;
  const int nr = min(rows_per_block, R - r0);
  const int tpad = (Tk + 3) & ~3;
  float* s = reinterpret_cast<float*>(smem);                      // [rows][tpad]
  int8_t* codes = reinterpret_cast<int8_t*>(s + rows_per_block * tpad);  // [rows][tpad]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // 1. q's rows quantized over Dh, one warp per row; absent rows get
  //    codes 0 (they score 0 and are never stored).
  {
    const int r = warp;
    const T* qr = q + b * q_sb + h * q_sh + static_cast<long long>(r0 + r) * q_sr;
    float amax = 0.f;
    if (r < nr)
      for (int d = lane; d < Dh; d += 32) amax = fmaxf(amax, fabsf(to_f32(qr[d])));
    amax = spt::warp_max(amax);
    const float scale = amax > 0.f ? amax / 127.f : 1.f;
    for (int d = lane; d < Dh; d += 32) {
      float c = 0.f;
      if (r < nr) c = fminf(fmaxf(rintf(to_f32(qr[d]) / scale), -127.f), 127.f);
      qq[r][d] = static_cast<int8_t>(c);
    }
    if (lane == 0) sq[r] = scale;
  }
  __syncthreads();

  // 2. Scores of every position t < Tk (the pad's too: its scales are
  //    real numbers, and the mask below keeps them out), four positions
  //    per thread, all rows at once.
  const int8_t* kb = k + b * k_sb + h * k_sh;
  const bool kvec =
      ((reinterpret_cast<uintptr_t>(kb) | static_cast<uintptr_t>(k_ld)) & 3) == 0;
  const float* ksr = ks + static_cast<long long>(bh) * Tk;
  for (int t = 4 * threadIdx.x; t < tpad; t += 4 * kThreads) {
    int acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0;
    for (int d0 = 0; d0 < Dh; d0 += 4) {
      uint32_t kc[4];
      load_4x4(kb + d0 * k_ld, k_ld, t, Tk, kvec, kc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int qa = *reinterpret_cast<const int*>(&qq[r][d0]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[r][j] = __dp4a(qa, static_cast<int>(kc[j]), acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nr) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t + j < Tk)
          s[r * tpad + t + j] = static_cast<float>(acc[r][j]) * sq[r] * ksr[t + j];
    }
  }
  __syncthreads();

  // 3. One warp per row: the max over t < kv_len, e = exp(s - max) and
  //    its sum, p = e / sum, pv = p * vs and its max, then P's codes
  //    (0 past kv_len, so that the P . V pass may read whole words).
  if (warp < nr) {
    float* sr = s + warp * tpad;
    const float* vsr = vs + static_cast<long long>(bh) * Tk;
    float m = -INFINITY;
    for (int t = lane; t < Tk; t += 32) m = fmaxf(m, t < kv_len ? sr[t] : -1e30f);
    m = spt::warp_max(m);
    float l = 0.f;
    for (int t = lane; t < kv_len; t += 32) {
      const float e = expf(sr[t] - m);
      sr[t] = e;
      l += e;
    }
    l = spt::warp_sum(l);
    float pa = 0.f;
    for (int t = lane; t < kv_len; t += 32) {
      const float pv = sr[t] / l * vsr[t];
      sr[t] = pv;
      pa = fmaxf(pa, pv);
    }
    pa = spt::warp_max(pa);
    const float scale = pa > 0.f ? pa / 127.f : 1.f;
    int8_t* cr = codes + warp * tpad;
    for (int t = lane; t < tpad; t += 32)
      cr[t] = t < kv_len
                  ? static_cast<int8_t>(fminf(fmaxf(rintf(sr[t] / scale), 0.f), 127.f))
                  : int8_t(0);
    if (lane == 0) sp[warp] = scale;
  }
  __syncthreads();

  // 4. out[r][d] = f32(int32 qp[r] . V[d, :]) * sp[r]: a warp per head dim
  //    at a time, lanes over words of four positions.
  const int8_t* vb = v + b * v_sb + h * v_sh;
  const bool vvec =
      ((reinterpret_cast<uintptr_t>(vb) | static_cast<uintptr_t>(v_ld)) & 3) == 0;
  const int kv_pad = (kv_len + 3) & ~3;
  for (int d = warp; d < Dh; d += kWarps) {
    const int8_t* vr = vb + d * v_ld;
    int acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0;
    for (int t = 4 * lane; t < kv_pad; t += 128) {
      uint32_t w;
      if (vvec) {
        w = spt::ld_u32(vr + t);
      } else {
        w = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (t + j < kv_len)
            w |= static_cast<uint32_t>(static_cast<uint8_t>(vr[t + j])) << (8 * j);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nr) break;
        const int pc = *reinterpret_cast<const int*>(codes + r * tpad + t);
        acc[r] = __dp4a(pc, static_cast<int>(w), acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nr) break;
      int sum = acc[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0)
        store(out + (static_cast<long long>(bh) * R + r0 + r) * Dh + d,
              static_cast<float>(sum) * sp[r]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, void* out, int B, int H, int R, int Dh, int Tk,
           int kv_len, int rows_per_block, long long q_sb, long long q_sh,
           long long q_sr, long long k_sb, long long k_sh, long long k_ld,
           long long v_sb, long long v_sh, long long v_ld, void* stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a8_cross_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBudget);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const long long smem = static_cast<long long>(rows_per_block) * ((Tk + 3) & ~3) * 5;
  if (rows_per_block < 1 || rows_per_block > kRows || smem > kSmemBudget ||
      Dh % 4 != 0 || Dh > kMaxDh || kv_len < 1 || kv_len > Tk)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H, (R + rows_per_block - 1) / rows_per_block);
  w8a8_cross_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<T*>(out), H, R, Dh, Tk,
      kv_len, rows_per_block, q_sb, q_sh, q_sr, k_sb, k_sh, k_ld, v_sb, v_sh,
      v_ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K14. q [B, H, R, Dh] (bf16 when q_bf16, else f32) with strides
// (q_sb, q_sh, q_sr, 1); k/v int8 [B, H, Dh, Tk] with strides (sb, sh,
// ld, 1); ks/vs contiguous f32 [B, H, Tk]; out contiguous [B, H, R, Dh]
// of q's type. Strides in elements.
SPT_API int spt_decode_cross_attention_w8a8(
    const void* q, const void* k, const void* ks, const void* v,
    const void* vs, void* out, int B, int H, int R, int Dh, int Tk,
    int kv_len, int rows_per_block, int q_bf16, long long q_sb, long long q_sh,
    long long q_sr, long long k_sb, long long k_sh, long long k_ld,
    long long v_sb, long long v_sh, long long v_ld, void* stream) {
  if (q_bf16)
    return launch<__nv_bfloat16>(q, k, ks, v, vs, out, B, H, R, Dh, Tk, kv_len,
                                 rows_per_block, q_sb, q_sh, q_sr, k_sb, k_sh,
                                 k_ld, v_sb, v_sh, v_ld, stream);
  return launch<float>(q, k, ks, v, vs, out, B, H, R, Dh, Tk, kv_len,
                       rows_per_block, q_sb, q_sh, q_sr, k_sb, k_sh, k_ld, v_sb,
                       v_sh, v_ld, stream);
}
