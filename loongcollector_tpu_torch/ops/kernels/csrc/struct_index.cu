// K5: the structural index, four bitmaps a row, for sm_90a.
//
// Replaces the XLA program build_index_fn of the JAX package
// (loongcollector_tpu/ops/kernels/struct_index.py:119, core _index_core at
// :58): over rows u8 [B, L] and lengths i32 [B], in JSON mode or in
// delimiter mode with a separator byte, the masks in_string, structural,
// escaped and quote, each i32 [B, ceil(L / 16)], 16 bits a word (the walk
// and its semantics are in struct_walk.cuh).  ops/kernels/struct_index.py
// build_index_fn is the plain version it is held bit-exact against.
//
// What bounds it on this card (H100 SXM, 3.35 TB/s, 700 W): bytes.  The
// function reads each row's bytes below its length and its length, and
// writes 4 * 4 * ceil(L / 16) bytes a row: at B = 8192, L = 128 and ~100
// bytes a row about 1.9 MB, 0.6 us.  The design: one warp a row, eight rows
// a block of 256 threads.  The warp first copies its row's bytes below the
// length into its part of the block's shared tile, 16 bytes a cp.async
// copy, all in flight at once, waited for once; the walk (struct_walk.cuh,
// 32 bytes a step, a handful of ballots and integer ops a step) then reads
// no device memory, and stops at the length.  Each lane keeps one word of
// each mask, and the warp stores 32 words a mask at a time, coalesced, the
// zeros past the length included.
//
// Padding rows (length 0) and absent rows (length -1) are walked and
// written as all-zero rows.  Plain C interface, loaded with ctypes.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "struct_walk.cuh"

namespace {

constexpr int kThreads = 256;       // struct_index_cuda.THREADS
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxL = 4096;         // struct_index_cuda.MAX_L

// A row's stride in the shared tile: L rounded up to 16 bytes.
__host__ __device__ __forceinline__ int32_t tile_stride(int32_t L) {
  return (L + 15) & ~15;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
struct_index_kernel(const uint8_t* __restrict__ rows,
                    const int32_t* __restrict__ lens, int64_t B, int32_t L,
                    uint32_t sep, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t tile[];
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                      (threadIdx.x >> 5);
  if (row >= B) return;               // the whole warp leaves together
  const int32_t len = __ldg(lens + row);
  const int32_t n = len < 0 ? 0 : (len > L ? L : len);
  const int32_t W = (L + 15) >> 4;
  const uint8_t* const r = rows + row * L;
  uint8_t* const tb = tile + (threadIdx.x >> 5) * tile_stride(L);
  // the row's bytes below n: 16-byte copies when every row is 16-byte
  // aligned (each copy then lies inside the row), else byte loads.  The
  // loops' trip counts are the warp's, so the walk's ballots after them
  // need no divergence check.
  if ((L & 15) == 0 && (reinterpret_cast<uintptr_t>(rows) & 15) == 0) {
#pragma unroll 1
    for (int32_t c0 = 0; c0 < n; c0 += 16 * 32) {
      const int32_t c = c0 + 16 * lane;
      if (c < n) __pipeline_memcpy_async(tb + c, r + c, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
#pragma unroll 1
    for (int32_t p0 = 0; p0 < n; p0 += 32) {
      const int32_t p = p0 + lane;
      if (p < n) tb[p] = __ldg(r + p);
    }
  }
  __syncwarp();
  struct_row<MODE>([tb](int32_t p) { return tb[p]; }, L, n, sep, lane,
                   out + row * W, B * W);
}

}  // namespace

extern "C" {

// One index of the batch on `stream`, without a synchronise: rows u8 [B, L]
// (1 <= L <= 4096), lens i32 [B], out i32 [4, B, ceil(L / 16)] (in_string,
// structural, escaped, quote).  mode 0 is JSON, 1 delimiter with separator
// `sep`.
// ev_start / ev_end: CUDA events recorded right around the launch, or null.
// Returns the cudaError_t, 0 on success.
int lct_struct_index_cuda(const uint8_t* rows, const int32_t* lens, int64_t B,
                          int32_t L, int32_t mode, int32_t sep, int32_t* out,
                          void* stream, void* ev_start, void* ev_end) {
  if (B < 0 || L < 1 || L > kMaxL ||
      (mode != kStructJson && mode != kStructDelim) || sep < 0 || sep > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (ev_start && (e = cudaEventRecord(static_cast<cudaEvent_t>(ev_start),
                                       st)) != cudaSuccess)
    return static_cast<int>(e);
  const unsigned blocks =
      static_cast<unsigned>((B + kRowsPerBlock - 1) / kRowsPerBlock);
  // at most 32 KB at kMaxL: no opt-in past the default 48 KB
  const size_t smem = static_cast<size_t>(kRowsPerBlock) * tile_stride(L);
  if (mode == kStructJson)
    struct_index_kernel<kStructJson><<<blocks, kThreads, smem, st>>>(
        rows, lens, B, L, static_cast<uint32_t>(sep), out);
  else
    struct_index_kernel<kStructDelim><<<blocks, kThreads, smem, st>>>(
        rows, lens, B, L, static_cast<uint32_t>(sep), out);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (ev_end) e = cudaEventRecord(static_cast<cudaEvent_t>(ev_end), st);
  return static_cast<int>(e);
}

// Loads both modes' code onto the current device (the first launch then
// holds no module load).
int lct_struct_index_prepare(void) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, struct_index_kernel<kStructJson>);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a, struct_index_kernel<kStructDelim>);
  return static_cast<int>(e);
}

const char* lct_struct_index_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
