// In-place write of one position of a KV cache for Hopper (sm_90a), with
// the position read from device memory.
//
//  - K13 spt_cache_col_write: ctx minor, cache[r, pos] = cols[r] over the
//    flattened leading axes. Replaces the probe kernel
//    scripts/bench_cache_dus.py:alias_col_write (body _alias_write_kernel).
//  - K12 spt_cache_col_write_rows: ctx on the row axis, cache_t[r, pos, :]
//    = cols[r, :]. Replaces scripts/bench_cache_dus.py:alias_col_write_sub
//    (body _alias_write_kernel_sub).
//
// The TPU kernels alias the cache to their output and rewrite a whole
// 128-lane (K13) or 8-row (K12) block through a mask, because a Mosaic
// block cannot be narrower, with rows a multiple of 8. Here the cache is
// simply written in place, only the addressed elements, for any row
// count. `pos` is a device int32 (the TPU's prefetched scalar), so a CUDA
// graph of a decode step can hold the launch; a pos outside [0, ctx)
// writes nothing.
//
// What bounds it on an H100: bytes, `cols` read once and written once.
// K12 moves contiguous rows (2.5 KB at H*Dh = 1280) as 16-byte vectors
// and can reach that bound. K13 writes 2-byte elements ctx*2 bytes apart:
// every element dirties its own 32-byte sector, and memory brings in the
// sector's other 30 bytes before it goes back. Its floor in this layout is
// one sector read and one written per row (64 bytes a row: 168 MB, 0.050
// ms at the cache probe's 2.6 M rows); the layout sets that, not the
// kernel. Kernels that read each row's sector, merged the element and
// wrote the sector back whole (by lane pairs, or by TMA boxes) were 6-8%
// slower than this one at the probe's shape on an H100 (PERF.md §6).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// dst[r * row_stride + pos * pos_stride + j] = src[r * inner + j] for r <
// rows, j < inner, in units of T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    col_write_kernel(T* __restrict__ dst, const T* __restrict__ src,
                     const int* __restrict__ pos_ptr, long long n,
                     long long inner, long long row_stride,
                     long long pos_stride, int ctx) {
  const int pos = *pos_ptr;
  if (pos < 0 || pos >= ctx) return;
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long r = i / inner, j = i - r * inner;
  dst[r * row_stride + pos * pos_stride + j] = src[i];
}

template <typename T>
int launch(void* dst, const void* src, const void* pos, long long rows,
           long long inner, long long row_stride, long long pos_stride,
           int ctx, void* stream) {
  const long long n = rows * inner;
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  col_write_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(dst), static_cast<const T*>(src),
      static_cast<const int*>(pos), n, inner, row_stride, pos_stride, ctx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K13. cache: contiguous [rows, ctx] of 2-byte elements; cols: [rows].
SPT_API int spt_cache_col_write(void* cache, const void* cols,
                                const void* pos, long long rows, int ctx,
                                void* stream) {
  return launch<uint16_t>(cache, cols, pos, rows, 1, ctx, 1, ctx, stream);
}

// K12. cache_t: contiguous [rows, ctx, hd] of 2-byte elements, hd a
// multiple of 8 and both tensors 16-byte aligned; cols: [rows, hd].
SPT_API int spt_cache_col_write_rows(void* cache_t, const void* cols,
                                     const void* pos, long long rows, int ctx,
                                     int hd, void* stream) {
  const long long vec = hd / 8;  // 16-byte vectors per row
  return launch<uint4>(cache_t, cols, pos, rows, vec, ctx * vec, vec, ctx,
                       stream);
}
