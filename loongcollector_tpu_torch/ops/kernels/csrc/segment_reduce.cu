// K6: the segment reduce of the windowed metric rollup, for sm_90a.
//
// Replaces the XLA program build_reduce_fn of the JAX package
// (loongcollector_tpu/ops/kernels/segment_reduce.py:362).  Over a padded
// batch of B rows, values f32 [B], segment ids i32 [B], bucket ids i32 [B]
// and valid u8 [B], and for each of G segments it computes
//   sum   f32  the sum of the segment's valid values
//   count i32  its valid rows
//   min   f32  their minimum (+inf for an empty segment)
//   max   f32  their maximum (-inf for an empty segment)
//   last  f32  the value at the largest valid row index (0 when empty)
//   hist  i32  [G, n_hist] valid rows by bucket id
// A row that is not valid, or whose segment lies outside [0, G), is dropped
// with no write; a kept row's histogram count is dropped when its bucket
// lies outside [0, n_hist) (the host's bucketing never gives one).  The
// outputs are one flat i32 buffer in that order, 5G + G*n_hist words, so
// the host copies them back in one transfer.
//
// The TPU form is five jax.ops.segment_* scatters over the slot.  Here one
// thread takes one row and folds it into its segment with global atomics:
//   * sum: atomicAdd in f32.  The order of the adds changes from run to run,
//     so sums are held to the reference's own tolerance (rtol = atol = 1e-5,
//     scripts/agg_equivalence.py:163), and everything else is exact;
//   * count and hist: atomicAdd in i32;
//   * min and max: float atomics on the bit patterns, an integer atomicMin /
//     atomicMax for a value whose sign bit is clear and the opposite unsigned
//     one for a value whose sign bit is set, which orders every non-NaN
//     float, +-inf included (NaN is invalid by the value grammar and never
//     reaches the kernel);
//   * last: a 64-bit atomicMax on (row << 32 | f32 bits) in a scratch word
//     per segment, whose low half is the value at the largest row.  An empty
//     segment keeps 0, whose low half is +0.0f, the empty value.
// An init kernel writes the empty values over all G segments first, and a
// finalize kernel moves each scratch word's low half into `last`, so the
// kernel equals its plain version on every segment, not only on the ones
// the batch fills.
//
// What bounds it: bytes and launches.  The function must read 13 bytes a
// row and write 4 (5 + n_hist) bytes a segment: 0.48 MB at the rollup path's
// B = 8192, G = 2048, 0.14 us at 3.35 TB/s, so the three launches dominate.
// At B = G = 65536 with 41 buckets it is 12.9 MB, 3.9 us, most of it the
// histogram the init writes and the host reads back.  A hot segment
// serialises its rows' atomics in L2.
// Forms that keep the segments on the chip or fold in one launch were
// measured against this one on the H100 and were all slower at the rollup
// path's B = 8192, G = 2048 (chip_probe.py k6 builds and times them):
//   * one thread-block cluster holding the segments in its blocks' shared
//     memory, rows folded into the owner block with distributed
//     shared-memory reductions: 2.8-4.5x; its fold is most of its time,
//     and the reductions compile to generic ATOM instructions that return
//     a value, the f32 add a compare-and-swap loop (a 64-bit max into
//     another block's shared memory also lost updates);
//   * blocks that each own a range in their shared memory and read the
//     whole batch: 1.5-1.7x at 128 blocks, worse with fewer;
//   * one cluster over device memory, cluster barriers in place of the
//     launch boundaries: 1.6-1.8x.
//
// The caller's timing events, when given, are recorded on the stream right
// around the three launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
init_kernel(int32_t* __restrict__ out, unsigned long long* __restrict__ last,
            int64_t G, int32_t n_hist) {
    const int64_t total = 5 * G + G * n_hist;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         i < total; i += stride) {
        int32_t v = 0;
        if (i >= 2 * G && i < 3 * G)
            v = 0x7f800000;                       // min: +inf
        else if (i >= 3 * G && i < 4 * G)
            v = static_cast<int32_t>(0xff800000u);  // max: -inf
        out[i] = v;
        if (i < G) last[i] = 0ull;
    }
}

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
    if (__float_as_int(v) >= 0)
        atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
    else
        atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
    if (__float_as_int(v) >= 0)
        atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
    else
        atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float* __restrict__ values,
               const int32_t* __restrict__ seg,
               const int32_t* __restrict__ buckets,
               const uint8_t* __restrict__ valid, int64_t B, int64_t G,
               int32_t n_hist, int32_t* __restrict__ out,
               unsigned long long* __restrict__ last) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (i >= B || !valid[i]) return;
    const int64_t s = seg[i];
    if (s < 0 || s >= G) return;
    const float v = values[i];
    atomicAdd(reinterpret_cast<float*>(out) + s, v);
    atomicAdd(out + G + s, 1);
    atomic_min_f32(reinterpret_cast<float*>(out + 2 * G) + s, v);
    atomic_max_f32(reinterpret_cast<float*>(out + 3 * G) + s, v);
    atomicMax(last + s, (static_cast<unsigned long long>(i) << 32) |
                            __float_as_uint(v));
    const int32_t b = buckets[i];
    if (b >= 0 && b < n_hist) atomicAdd(out + 5 * G + s * n_hist + b, 1);
}

__global__ void __launch_bounds__(kThreads)
finalize_kernel(const unsigned long long* __restrict__ last,
                int32_t* __restrict__ out, int64_t G) {
    const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (s < G)
        out[4 * G + s] = static_cast<int32_t>(
            static_cast<uint32_t>(last[s] & 0xffffffffull));
}

}  // namespace

extern "C" {

// One reduce on `stream`, without a synchronise.  out: 5G + G*n_hist i32
// words; last: G u64 words of scratch.  `init_blocks` blocks of kThreads
// threads write the empty values, ceil(B / kThreads) fold the rows and
// ceil(G / kThreads) finalize `last`.  Returns a cudaError_t, 0 on success.
int lct_segment_reduce(const float* values, const int32_t* seg,
                       const int32_t* buckets, const uint8_t* valid,
                       int64_t B, int64_t G, int32_t n_hist, int32_t* out,
                       unsigned long long* last, int32_t init_blocks,
                       void* stream, void* ev_start, void* ev_end) {
    if (B < 0 || G < 1 || n_hist < 1 || init_blocks < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaSuccess;
    if (ev_start && (e = cudaEventRecord(static_cast<cudaEvent_t>(ev_start),
                                         st)) != cudaSuccess)
        return static_cast<int>(e);
    init_kernel<<<static_cast<unsigned>(init_blocks), kThreads, 0, st>>>(
        out, last, G, n_hist);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    if (B > 0) {
        scatter_kernel<<<static_cast<unsigned>((B + kThreads - 1) / kThreads),
                         kThreads, 0, st>>>(values, seg, buckets, valid, B, G,
                                            n_hist, out, last);
        if ((e = cudaGetLastError()) != cudaSuccess)
            return static_cast<int>(e);
    }
    finalize_kernel<<<static_cast<unsigned>((G + kThreads - 1) / kThreads),
                      kThreads, 0, st>>>(last, out, G);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    if (ev_end) e = cudaEventRecord(static_cast<cudaEvent_t>(ev_end), st);
    return static_cast<int>(e);
}

// Load the kernels' code onto the current device (the first launch then
// holds no module load).
int lct_segment_reduce_prepare(void) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, init_kernel);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, scatter_kernel);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, finalize_kernel);
    return static_cast<int>(e);
}

const char* lct_segment_reduce_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
