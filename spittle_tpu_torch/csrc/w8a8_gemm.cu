// W8A8 GEMM for Hopper (sm_90a), K2: y = act((quant(x) @ qw) * sx * sw + b).
//
// Replaces the TPU kernel spittle_tpu/ops/w8a8_gemm.py:w8a8_gemm
// (body _w8a8_kernel), which computes the same numbers as the reference's
// XLA path spittle_tpu/ops/quant.py:_mm_w8a8 with mm_bias's epilogue.
//
// What bounds it on an H100: at the encoder's shapes (M = B*1500 rows,
// (K, N) in {(1280,1280), (1280,5120), (5120,1280)}) the int8 products:
// 2*M*K*N operations against ~M*(K + 2N) + K*N bytes, far above the
// card's ~590 ops/byte int8 ridge, so the bound is the tensor cores'
// 1,979 TOP/s int8 rate. Only wgmma reaches that rate.
//
// Design: two launches, both here.
//  1. spt_w8a8_quantize_rows: the row quantizer, bandwidth-bound (3 bytes
//     per element of x in bf16). kTpr threads per row (32 to 128, chosen
//     from K so that each holds at most four 16-element units) read the
//     row once with 16-byte loads and keep it in registers, reduce the
//     amax by shuffles (and shared memory past one warp), set sx =
//     amax/127 (1 where amax is 0) and write qx = clip(rint(x/sx), +-127)
//     with 16-byte int8 stores: a true IEEE division and round-half-even,
//     the reference's exact rule (quant.py:88-91). No fast-math anywhere. The TPU kernel quantizes inside
//     the GEMM, its whole [bm, K] row block in VMEM; a Hopper block cannot
//     hold fc2's [128, 5120] bf16 rows beside its weight ring, and the
//     amax needs the whole row before any K slice is quantized, so the
//     pass stays separate (the encoder runs it once for q, k and v).
//  2. spt_w8a8_gemm: a persistent, warp-specialised GEMM. min(SMs, tiles)
//     blocks of 384 threads walk the output tiles in a grouped order
//     (kGroupM row tiles sweep the columns together, so a panel of qx rows
//     and the weight stay in L2). A producer warp streams 128-byte K
//     slices of qx [M, K] and qw^T [N, K] (both K-major: qw is stored
//     N-major) by TMA, with the 128-byte swizzle, into a ring of kStages
//     stages guarded by full and empty mbarriers; TMA zero-fills rows past
//     M and N and K past its end, exact for int8 sums. It runs on into the
//     next tile's slices. Two consumer warpgroups (setmaxnreg 240; the
//     producer keeps 24) issue wgmma.m64nNk32.s32.s8.s8 into exact int32
//     accumulators in registers, releasing a stage once the next slice's
//     products are issued and its own are done, in one of two schedules
//     the host chooses (ops/w8a8_gemm.py:tile_n): cooperative 128 x 256
//     tiles (fc2's long K) or 128 x 128 (GELU), both warpgroups on each
//     tile; or ping-pong 128 x 128 tiles, each warpgroup a tile of its
//     own, passing the tensor cores on named barriers, so that one's
//     epilogue runs under the other's products (q, k, v, out). Epilogue:
//     sx of the thread's rows, sw' = sw * out_scale and b' = bias *
//     out_scale (the reference's fold, in the bias's dtype) staged once
//     per tile in shared memory, then (float(acc) * sx) * sw' + b' with
//     one rounding of the multiply-add, and the exact erf GELU: the
//     arithmetic of the mma.sync kernel this one replaced, whose bits it
//     keeps (the int32 sums are exact). The values go to shared memory as
//     128-byte swizzled rows (conflict-free) and leave by TMA stores,
//     which drop rows past M and columns past N.
#include "sm90.cuh"

namespace {

namespace sm = spt::sm90;

constexpr int kBM = 128;       // output rows per tile
constexpr int kBK = 128;       // K bytes per stage: one 128-byte swizzle row
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kGroupM = 8;     // row tiles that sweep the columns together
constexpr int kQuantThreads = 128;
constexpr int kUnits = 4;      // 16-element units of a row a quantizer thread holds

// Shared memory of a GEMM block: the stages (A box: 128 rows x 128 bytes,
// then B box: BN rows x 128 bytes), the output panels of both warpgroups
// (64 rows x 128 bytes each, the TMA store boxes), sw' and b' per
// warpgroup, the barriers. Every box starts on a 1024-byte boundary, as
// the 128-byte swizzle needs.
template <int BN, typename T>
struct Gemm {
  static constexpr int kStages = BN == 256 ? 3 : sizeof(T) == 2 ? 5 : 4;
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kStageBytes = kABytes + BN * kBK;
  static constexpr int kPanelCols = 128 / static_cast<int>(sizeof(T));
  static constexpr int kPanels = BN / kPanelCols;
  static constexpr int kPanelBytes = 64 * 128;
  static constexpr int kOutOffset = kStages * kStageBytes;
  static constexpr int kVecOffset = kOutOffset + 2 * kPanels * kPanelBytes;
  static constexpr int kBarOffset = kVecOffset + 2 * 2 * BN * 4;
  static constexpr int kAlloc = kBarOffset + 2 * kStages * 8 + 1024;
  static_assert(kAlloc <= 232448, "past the 227 KB a block may use");
};

// ---------------------------------------------------------------------------
// The row quantizer
// ---------------------------------------------------------------------------

// Sixteen elements of a row, held as 32-bit words: 32 bytes of bf16 or 64
// of f32, loaded 16 bytes at a time. Element e widens to f32 exactly (a
// bf16 is the high half of its f32).
template <typename T>
struct Unit {
  static constexpr int kWords = 16 * static_cast<int>(sizeof(T)) / 4;
  uint32_t u[kWords];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      u[4 * i] = v.x, u[4 * i + 1] = v.y, u[4 * i + 2] = v.z, u[4 * i + 3] = v.w;
    }
  }
  __device__ __forceinline__ float at(int e) const {
    if constexpr (sizeof(T) == 2)
      return __uint_as_float(e & 1 ? u[e >> 1] & 0xFFFF0000u : u[e >> 1] << 16);
    else
      return __uint_as_float(u[e]);
  }
  __device__ __forceinline__ float amax(float m) const {
#pragma unroll
    for (int e = 0; e < 16; ++e) m = fmaxf(m, fabsf(at(e)));
    return m;
  }
  // clip(rint(x / s), +-127), a true IEEE division, as 16 int8 in one
  // 16-byte store.
  __device__ __forceinline__ void quantize(int8_t* dst, float s) const {
    uint32_t q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = rintf(at(4 * i + j) / s);
        b[j] = __float2int_rn(fminf(fmaxf(v, -127.f), 127.f));
      }
      q[i] = __byte_perm(__byte_perm(b[0], b[1], 0x5140), __byte_perm(b[2], b[3], 0x5140),
                         0x5410);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
  }
};

// kTpr threads per row, kQuantThreads / kTpr rows per block. Thread `sub`
// of a row takes the units sub, sub + kTpr, ...: the first kUnits held in
// registers from the one read, any further ones (K past kUnits * kTpr *
// 16) read again for the quantization.
template <typename T, int kTpr>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ qx,
                         float* __restrict__ sx, int M, int K) {
  constexpr int kWarpsPerRow = kTpr / 32;
  __shared__ float red[kQuantThreads / 32];
  const int sub = threadIdx.x % kTpr;
  const int row = blockIdx.x * (kQuantThreads / kTpr) + threadIdx.x / kTpr;
  const bool live = row < M;
  const int units = K / 16;
  const T* xr = x + static_cast<size_t>(row) * K;
  int8_t* qr = qx + static_cast<size_t>(row) * K;

  Unit<T> held[kUnits];
  float amax = 0.f;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int i = sub + u * kTpr;
    if (live && i < units) {
      held[u].load(xr + 16 * i);
      amax = held[u].amax(amax);
    }
  }
  for (int i = sub + kUnits * kTpr; live && i < units; i += kTpr) {
    Unit<T> v;
    v.load(xr + 16 * i);
    amax = v.amax(amax);
  }
#pragma unroll
  for (int o = (kTpr < 32 ? kTpr : 32) / 2; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if constexpr (kWarpsPerRow > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = amax;
    __syncthreads();
    const int first = warp / kWarpsPerRow * kWarpsPerRow;
#pragma unroll
    for (int w = 0; w < kWarpsPerRow; ++w) amax = fmaxf(amax, red[first + w]);
  }
  if (!live) return;
  const float s = amax > 0.f ? amax / 127.0f : 1.0f;
  if (sub == 0) sx[row] = s;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int i = sub + u * kTpr;
    if (i < units) held[u].quantize(qr + 16 * i, s);
  }
  for (int i = sub + kUnits * kTpr; i < units; i += kTpr) {
    Unit<T> v;
    v.load(xr + 16 * i);
    v.quantize(qr + 16 * i, s);
  }
}

template <typename T, int kTpr>
void launch_quantize(const void* x, void* qx, void* sx, int M, int K,
                     cudaStream_t st) {
  constexpr int kRows = kQuantThreads / kTpr;
  quantize_rows_kernel<T, kTpr><<<(M + kRows - 1) / kRows, kQuantThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(qx),
      static_cast<float*>(sx), M, K);
}

template <typename T>
void quantize_rows(const void* x, void* qx, void* sx, int M, int K,
                   cudaStream_t st) {
  const int units = K / 16;
  static_assert(kQuantThreads == 128, "threads per row go up to the block's");
  if (units <= kUnits * 32)
    launch_quantize<T, 32>(x, qx, sx, M, K, st);
  else if (units <= kUnits * 64)
    launch_quantize<T, 64>(x, qx, sx, M, K, st);
  else
    launch_quantize<T, 128>(x, qx, sx, M, K, st);
}

// ---------------------------------------------------------------------------
// The GEMM
// ---------------------------------------------------------------------------

// D[64 x 256] (+)= A[64 x 32] * B[32 x 256], int8 x int8 -> exact int32
// sums, A and B from shared memory (K-major, 128-byte swizzle) at the
// descriptors da + kOffA and db + kOffB (the offsets in 16-byte units, added
// inside, so that one register pair per operand serves every K step and
// row half); scale_d 0 overwrites D. D's layout is the bf16 wgmma's: d[i]
// is row 16 * warp + g + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2c +
// (i & 1).
template <int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "add.s64 a, %128, %131;\n"
      "add.s64 b, %129, %132;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, a, b, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kOffA), "n"(kOffB));
}

template <int BN, int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BN == 256)
    wgmma_s8_n256<kOffA, kOffB>(d, da, db, scale_d);
  else
    sm::wgmma_s8_n128<kOffA, kOffB>(d, da, db, scale_d);
}

// One output value: (acc * sx) * sw' + b' with one rounding of the
// multiply-add, as the mma.sync kernel this one replaced compiled it,
// then the exact erf GELU. Without a bias b' is 0, which adds exactly:
// acc * sx * sw' is never -0 (acc's +0 times positive scales).
template <bool kGelu>
__device__ __forceinline__ float epilogue(int acc, float s_x, float s_w, float b) {
  float v = __fmaf_rn(__fmul_rn(static_cast<float>(acc), s_x), s_w, b);
  if constexpr (kGelu) v = v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
  return v;
}

// out_scale folded into the bias as PyTorch's bias * out_scale computes it
// (the reference's order): in f32, rounded to the bias's dtype.
__device__ __forceinline__ float fold_bias(const void* bias, int bf16, int col,
                                           float out_scale) {
  if (bf16)
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(
        __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col]), out_scale)));
  return __fmul_rn(static_cast<const float*>(bias)[col], out_scale);
}

// Tile t of the persistent order: groups of kGroupM row tiles, each group
// walking its columns with its row tiles adjacent (ops/w8a8_gemm.py:
// tile_order is the same map).
struct Tile {
  int m0, n0;
};

template <int BN>
__device__ __forceinline__ Tile tile_at(int t, int m_tiles, int n_tiles) {
  const int per_group = kGroupM * n_tiles;
  const int first = t / per_group * kGroupM;
  const int rows = min(kGroupM, m_tiles - first);
  const int r = t % per_group;
  return {(first + r % rows) * kBM, r / rows * BN};
}

// One 64-row half of a tile's epilogue, from a warpgroup's accumulators:
// acc[4 nb + 2 hr + e] is row warp * 16 + gr + 8 hr of the half, column 8 nb
// + 2c + e, written to the half's output panels (panel col / kPanelCols,
// 16-byte chunk j of row r at j ^ (r % 8): the TMA store boxes'
// 128-byte swizzle, and no bank conflicts).
template <int BN, typename T, bool kGelu>
__device__ __forceinline__ void epilogue_half(const int* acc, float sx0, float sx1,
                                              const float* sw_s, const float* b_s,
                                              uint8_t* out_s, int warp, int gr,
                                              int c) {
  using G = Gemm<BN, T>;
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
    const int col = 8 * nb + 2 * c;
    const float2 s_w = *reinterpret_cast<const float2*>(sw_s + col);
    const float2 b = *reinterpret_cast<const float2*>(b_s + col);
    const int byte = col % G::kPanelCols * static_cast<int>(sizeof(T));
    uint8_t* const panel = out_s + col / G::kPanelCols * G::kPanelBytes;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = 4 * nb + 2 * hr;
      const int r = warp * 16 + gr + 8 * hr;
      const float s_x = hr ? sx1 : sx0;
      const float y0 = epilogue<kGelu>(acc[i], s_x, s_w.x, b.x);
      const float y1 = epilogue<kGelu>(acc[i + 1], s_x, s_w.y, b.y);
      uint8_t* dst = panel + r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint32_t*>(dst) = spt::pack_bf16(y0, y1);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
    }
  }
}

// Two schedules of one block (a producer warp, two consumer warpgroups):
//  - cooperative (kPingPong false, 128 x 256 tiles): both warpgroups work on
//    each tile, 64 rows each, and write their epilogues together;
//  - ping-pong (kPingPong true, 128 x 128 tiles): the warpgroups take the
//    block's tiles in turn, each a whole tile (two m64 products per K
//    step), and pass the tensor cores to each other on named barriers 1
//    and 2 once their tile's products are issued, so one warpgroup's
//    epilogue (the GELU's erf above all) runs under the other's products.
//    They consume the ring in the producer's order, one tile after the
//    other, so each full barrier is at most one phase away from the
//    parity a warpgroup waits for.
template <int BN, typename T, bool kGelu, bool kPingPong>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,  // qx [M, K]
                     const __grid_constant__ CUtensorMap tm_b,  // qw^T [N, K]
                     const __grid_constant__ CUtensorMap tm_o,  // out [M, N]
                     const float* __restrict__ sx,    // [M]
                     const float* __restrict__ sw,    // [N]
                     const void* __restrict__ bias,   // [N] bf16 or f32, or null
                     int bias_bf16, float out_scale, int M, int N, int K) {
  using G = Gemm<BN, T>;
  constexpr int kAcc = kPingPong ? BN : BN / 2;  // accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bars = base + G::kBarOffset;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (G::kStages + s); };
  auto stage = [&](int g) { return base + (g % G::kStages) * G::kStageBytes; };

  // The tile counts are computed in each role, after setmaxnreg, so that
  // no value lives across it (ptxas would keep such values in local memory).
  auto counts = [&](int& m_tiles, int& n_tiles, int& tiles, int& slices) {
    m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + BN - 1) / BN;
    tiles = m_tiles * n_tiles, slices = (K + kBK - 1) / kBK;
  };
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      sm::mbar_init(full(s), 1);
      sm::mbar_init(empty(s), kPingPong ? 4 : 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: every tile's K slices, the ring running on across tiles ----
    sm::reg_dealloc<24>();
    if (tid == 0) {
      int m_tiles, n_tiles, tiles, slices;
      counts(m_tiles, n_tiles, tiles, slices);
      int g = 0;  // slices loaded so far, across tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile ti = tile_at<BN>(t, m_tiles, n_tiles);
        for (int j = 0; j < slices; ++j, ++g) {
          const int s = g % G::kStages;
          if (g >= G::kStages) sm::mbar_wait(empty(s), (g / G::kStages - 1) & 1);
          sm::mbar_expect_tx(full(s), G::kStageBytes);
          sm::tma_load_2d(stage(g), &tm_a, full(s), j * kBK, ti.m0);
          sm::tma_load_2d(stage(g) + G::kABytes, &tm_b, full(s), j * kBK, ti.n0);
        }
      }
    }
  } else {
    // ---- consumers ----
    sm::reg_alloc<240>();
    int m_tiles, n_tiles, tiles, slices;
    counts(m_tiles, n_tiles, tiles, slices);
    const int w = wg - 1, t = tid & 127;
    const int warp = t >> 5, lane = t & 31, gr = lane >> 2, c = lane & 3;
    const int bar = 3 + w;  // this warpgroup's own named barrier
    float* const sw_s = reinterpret_cast<float*>(gbase + G::kVecOffset) + w * 2 * BN;
    float* const b_s = sw_s + BN;
    uint8_t* const out_s = gbase + G::kOutOffset + w * G::kPanels * G::kPanelBytes;
    const uint32_t out_a = base + G::kOutOffset + w * G::kPanels * G::kPanelBytes;
    int acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;  // each tile's first wgmma overwrites

    // Cooperative: warpgroup w takes rows w * 64 .. + 63 of every tile.
    // Ping-pong: warpgroup w takes the block's tiles n = w, w + 2, ..., all
    // 128 rows, and warpgroup 0 has the tensor cores first.
    if (kPingPong && w == 1) sm::named_arrive(1);
    for (int n = kPingPong ? w : 0;; n += kPingPong ? 2 : 1) {
      const int tile = blockIdx.x + n * gridDim.x;
      if (tile >= tiles) break;
      const Tile ti = tile_at<BN>(tile, m_tiles, n_tiles);
      const int m0 = ti.m0 + (kPingPong ? 0 : w * 64);  // this warpgroup's first row
      // The previous tile's TMA stores have read the output panels, and
      // every thread has left the previous epilogue: sw' and b' may change.
      if (t == 0) sm::bulk_wait_read<0>();
      for (int i = t; i < BN; i += 128) {
        const int col = ti.n0 + i;
        sw_s[i] = col < N ? __fmul_rn(sw[col], out_scale) : 0.f;
        b_s[i] = bias != nullptr && col < N ? fold_bias(bias, bias_bf16, col, out_scale) : 0.f;
      }
      sm::bar_sync(bar, 128);

      if (kPingPong) sm::named_sync(1 + w);  // this warpgroup's turn
      int g = n * slices;  // the tile's first slice in the ring's order
      for (int j = 0; j < slices; ++j, ++g) {
        sm::mbar_wait(full(g % G::kStages), (g / G::kStages) & 1);
        const uint64_t da = sm::desc_sw128(stage(g) + (kPingPong ? 0 : w * 64 * kBK));
        const uint64_t db = sm::desc_sw128(stage(g) + G::kABytes);
        sm::wgmma_fence();
        static_assert(kBK == 128, "four K steps of 32 bytes per slice");
        // K steps of 32 bytes (+2 in the descriptors); ping-pong's rows
        // 64..127 lie 8 KB (+512) into the A box.
        wgmma_s8<BN, 0, 0>(acc, da, db, j > 0);
        if constexpr (kPingPong) wgmma_s8<BN, 512, 0>(acc + BN / 2, da, db, j > 0);
        wgmma_s8<BN, 2, 2>(acc, da, db, 1);
        if constexpr (kPingPong) wgmma_s8<BN, 514, 2>(acc + BN / 2, da, db, 1);
        wgmma_s8<BN, 4, 4>(acc, da, db, 1);
        if constexpr (kPingPong) wgmma_s8<BN, 516, 4>(acc + BN / 2, da, db, 1);
        wgmma_s8<BN, 6, 6>(acc, da, db, 1);
        if constexpr (kPingPong) wgmma_s8<BN, 518, 6>(acc + BN / 2, da, db, 1);
        sm::wgmma_commit();
        sm::wgmma_wait<1>();  // slice j - 1's products are done
        if (j > 0 && lane == 0) sm::mbar_arrive(empty((g - 1) % G::kStages));
      }
      // sx of rows h * 64 + warp * 16 + gr + 8 hr, h < 2 (ping-pong) or 1,
      // loaded while the last products run (not held through the loop).
      float sxr[kPingPong ? 4 : 2];
#pragma unroll
      for (int i = 0; i < (kPingPong ? 4 : 2); ++i) {
        const int row = m0 + (i >> 1) * 64 + warp * 16 + gr + 8 * (i & 1);
        sxr[i] = row < M ? sx[row] : 0.f;
      }
      // The other warpgroup's turn, if it has a tile left.
      if (kPingPong && blockIdx.x + (n + 1) * gridDim.x < tiles) sm::named_arrive(2 - w);
      sm::wgmma_wait<0>();
      sm::fence_regs<kAcc>(acc);
      if (lane == 0) sm::mbar_arrive(empty((g - 1) % G::kStages));

      // Epilogue, 64 rows at a time through this warpgroup's panels.
#pragma unroll
      for (int h = 0; h < (kPingPong ? 2 : 1); ++h) {
        if (h > 0) {
          if (t == 0) sm::bulk_wait_read<0>();
          sm::bar_sync(bar, 128);
        }
        epilogue_half<BN, T, kGelu>(acc + h * (BN / 2), sxr[2 * h], sxr[2 * h + 1],
                                    sw_s, b_s, out_s, warp, gr, c);
        sm::fence_proxy_async();
        sm::bar_sync(bar, 128);
        if (t == 0) {
          for (int p = 0; p < G::kPanels; ++p) {
            const int col = ti.n0 + p * G::kPanelCols;
            if (col < N)
              sm::tma_store_2d(&tm_o, out_a + p * G::kPanelBytes, col, m0 + h * 64);
          }
          sm::bulk_commit();
        }
      }
    }
    if (t == 0) sm::bulk_wait<0>();
  }
}

// A 2-D map over a row-major [rows, cols] tensor (`pitch` bytes between
// rows) with `box_cols` x `box_rows` boxes and the 128-byte swizzle;
// elements past either end load as zeros and are dropped on store.
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
              long long rows, long long cols, long long pitch, int box_cols,
              int box_rows) {
  const sm::EncodeTiledFn enc = sm::encoder();
  if (enc == nullptr) return sm::kErrNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(ptr), dims, strides,
                         box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : sm::kErrEncode + static_cast<int>(r);
}

template <int BN, typename T, bool kGelu, bool kPingPong>
int launch_gemm(const void* qx, const void* qwt, const void* sx, const void* sw,
                const void* bias, int bias_bf16, float out_scale, void* out,
                int M, int N, int K, int num_sms, cudaStream_t st) {
  using G = Gemm<BN, T>;
  const CUtensorMapDataType out_type = sizeof(T) == 2
                                           ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap ma, mb, mo;
  int err = encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, qx, M, K, K, kBK, kBM);
  if (err == 0)
    err = encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, qwt, N, K, K, kBK, BN);
  if (err == 0)
    err = encode_2d(&mo, out_type, out, M, N, static_cast<long long>(N) * sizeof(T),
                    G::kPanelCols, 64);
  if (err != 0) return err;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a8_gemm_kernel<BN, T, kGelu, kPingPong>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::kAlloc);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const long long tiles = static_cast<long long>((M + kBM - 1) / kBM) *
                          ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < num_sms ? tiles : num_sms);
  w8a8_gemm_kernel<BN, T, kGelu, kPingPong><<<grid, kThreads, G::kAlloc, st>>>(
      ma, mb, mo, static_cast<const float*>(sx), static_cast<const float*>(sw),
      bias, bias_bf16, out_scale, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (x and out share it). x: contiguous
// [M, K], 16-byte aligned, K % 16 == 0; qx: int8 [M, K]; sx: f32 [M].
SPT_API int spt_w8a8_quantize_rows(const void* x, void* qx, void* sx, int M,
                                   int K, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 16 || K % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    quantize_rows<__nv_bfloat16>(x, qx, sx, M, K, st);
  else
    quantize_rows<float>(x, qx, sx, M, K, st);
  return static_cast<int>(cudaGetLastError());
}

// qx: int8 [M, K]; qwt: int8 [N, K] (qw [K, N] stored N-major); sx: f32
// [M]; sw: f32 [N]; bias: [N], bf16 (bias_bf16 1) or f32, or null; out:
// [M, N] of dtype. out_scale is folded into sw and the bias per tile, as
// the reference folds it (sw * s, bias * s in the bias's dtype). K % 16
// == 0, N % 8 == 0, every pointer 16-byte aligned. bn: the tile width
// (ops/w8a8_gemm.py:tile_n chooses it): 256 for bf16 without GELU, else
// 128; num_sms: the card's SM count, the grid's size.
SPT_API int spt_w8a8_gemm(const void* qx, const void* qwt, const void* sx,
                          const void* sw, const void* bias, void* out, int M,
                          int N, int K, int gelu, int dtype, int bias_bf16,
                          int bn, int num_sms, float out_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 8 || N % 8 || K < 16 || K % 16 || num_sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define SPT_GEMM(BN, T, GELU)                                                  \
  return launch_gemm<BN, T, GELU, BN == 128 && !GELU>(                          \
      qx, qwt, sx, sw, bias, bias_bf16, out_scale, out, M, N, K, num_sms, st)
  if (dtype == 0 && bn == 256 && !gelu) SPT_GEMM(256, __nv_bfloat16, false);
  if (dtype == 0 && bn == 128) {
    if (gelu) SPT_GEMM(128, __nv_bfloat16, true);
    SPT_GEMM(128, __nv_bfloat16, false);
  }
  if (dtype == 1 && bn == 128) {
    if (gelu) SPT_GEMM(128, float, true);
    SPT_GEMM(128, float, false);
  }
#undef SPT_GEMM
  return static_cast<int>(cudaErrorInvalidValue);
}
