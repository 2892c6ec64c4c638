// K2, K3 and K4: the Tier-2 DFA walk, one thread per row, for sm_90a.
//
// Replaces three XLA programs of the JAX package (ops/kernels/dfa_scan.py):
//   K2  build_dfa_match_fn       full DFA match per row  -> bool  [B]
//   K3  build_dfa_span_match_fn  K2 over a span per row  -> bool  [B]
//   K4  build_fused_scan_fn      fused multi-accept DFA  -> int32 [B] (u32)
// Both run one automaton over u8 rows [B, L] with i32 lengths [B]:
//   state = start; for p < length: state = delta(state, class(row[p]))
// K2 writes accept[state] != 0, K4 writes accept[state] (the u32 tag mask
// carried as i32; bit 31 included).  Positions at or past the length do not
// move the state (the TPU program's freeze class); a padding row (length 0)
// gives the start state's value.  K3 walks only the bytes of the row-relative
// span [start, start + spanlen) below the length (the reference's `inside`
// mask) and gives 0 where spanlen < 0, the absent-capture convention.
//
// The TPU form carried a bf16 one-hot state [B, S] and multiplied it by a
// [(K+1)S, S] matrix once per byte under lax.scan, because a per-element
// gather was slow there.  Here the automaton is a table walk.  The host
// folds the class map into a byte-indexed table t256[S][256] (S <= 128, the
// fused set's device cap, so a block's tables stay under 48 KB) and the
// per-state outputs into accept[S]; the table is an argument, so one build
// serves every pattern.
//
// What bounds it: the serial per-byte dependency, not bytes.  Each step is
// one shared-memory load whose address depends on the previous load, so a
// row of n bytes costs n dependent loads (~30 cycles each); the rows
// themselves are a few hundred KB per batch.  The design follows from that:
//   * each block copies t256 and accept into shared memory once (S*256 +
//     4S bytes: 8.75 KB for the 35-state multiline set), so every step hits
//     shared memory, not L1 or L2.  The copy is queued as asynchronous
//     16-byte copies (cp.async) and waited for once: a one-warp block
//     copying through registers waited out an L2 round trip per 16 bytes,
//     18 of them for that set, longer than a 128-byte row's walk;
//   * rows are read straight from device memory with 16-byte loads when the
//     row is 16-byte aligned (L a multiple of 16, as every length bucket
//     is), else byte by byte.  Staging rows per warp in shared memory, as
//     K1 does, would add a barrier and compete with the table for shared
//     memory, and buys nothing here: one 16-byte load feeds 16 dependent
//     steps, so the load hides under the walk;
//   * one row a thread, 32 to 128 threads a block: the wrapper halves the
//     block from 128 while the batch would leave an SM without one
//     (dfa_scan_cuda.launch_geometry), so a batch of 8192 rows runs 256
//     blocks of one warp, not 64 blocks of four.  Rows of one warp walk
//     different lengths; the warp runs until its longest row is done.
// The caller's timing events, when given, are recorded on the stream right
// around the launch, so a kernel's time holds no host latency.
// The byte walk is in dfa_walk.cuh, which the fused stage program
// (fused_program.cu) shares.
// Speed is later work (several rows a thread to hide the chain's latency,
// a warp per long row with a parallel-prefix over transition vectors).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dfa_walk.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMaxStates = 128;

template <bool kTags>
__global__ void __launch_bounds__(kMaxThreads)
dfa_walk_kernel(const uint8_t* __restrict__ rows,
                const int32_t* __restrict__ lengths, int64_t B, int32_t L,
                const uint8_t* __restrict__ t256, int32_t S,
                const int32_t* __restrict__ accept, int32_t start,
                void* __restrict__ out) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* tab = smem;
    int32_t* acc = reinterpret_cast<int32_t*>(smem + S * 256);
    for (int i = threadIdx.x; i < S * 16; i += blockDim.x)
        __pipeline_memcpy_async(tab + 16 * i, t256 + 16 * i, 16);
    for (int i = threadIdx.x; i < S; i += blockDim.x)
        __pipeline_memcpy_async(acc + i, accept + i, 4);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
    if (r >= B) return;
    int len = lengths[r];
    len = len < 0 ? 0 : (len > L ? L : len);
    const uint8_t* row = rows + r * L;
    uint32_t s = static_cast<uint32_t>(start);
    if ((reinterpret_cast<uintptr_t>(row) & 15) == 0 && (L & 15) == 0) {
        // aligned: whole 16-byte words, then the last partial word, which
        // lies inside the row because L is a multiple of 16
        const uint4* v = reinterpret_cast<const uint4*>(row);
        const int full = len >> 4;
        for (int w = 0; w < full; ++w) s = walk_vec(tab, s, __ldg(v + w), 16);
        const int rem = len & 15;
        if (rem) s = walk_vec(tab, s, __ldg(v + full), rem);
    } else {
        for (int p = 0; p < len; ++p) s = tab[(s << 8) | __ldg(row + p)];
    }
    if (kTags) {
        static_cast<int32_t*>(out)[r] = acc[s];
    } else {
        static_cast<uint8_t*>(out)[r] = acc[s] != 0;
    }
}

// K3: the walk over bytes [max(start, 0), start + max(spanlen, 0)) of each
// row, cut at the row's length; a row with spanlen < 0 gives 0.
__global__ void __launch_bounds__(kMaxThreads)
dfa_span_kernel(const uint8_t* __restrict__ rows,
                const int32_t* __restrict__ lengths, int64_t B, int32_t L,
                const uint8_t* __restrict__ t256, int32_t S,
                const int32_t* __restrict__ accept, int32_t start,
                const int32_t* __restrict__ starts,
                const int32_t* __restrict__ spanlens,
                uint8_t* __restrict__ out) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* tab = smem;
    int32_t* acc = reinterpret_cast<int32_t*>(smem + S * 256);
    for (int i = threadIdx.x; i < S * 16; i += blockDim.x)
        __pipeline_memcpy_async(tab + 16 * i, t256 + 16 * i, 16);
    for (int i = threadIdx.x; i < S; i += blockDim.x)
        __pipeline_memcpy_async(acc + i, accept + i, 4);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
    if (r >= B) return;
    int len = lengths[r];
    len = len < 0 ? 0 : (len > L ? L : len);
    const int32_t st = starts[r], sl = spanlens[r];
    const int64_t end = static_cast<int64_t>(st) + (sl < 0 ? 0 : sl);
    const int lo = st < 0 ? 0 : st;
    const int hi = static_cast<int>(end < len ? end : len);
    const uint8_t* row = rows + r * L;
    const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0
                     && (L & 15) == 0;
    const uint32_t s = walk_row_range(tab, static_cast<uint32_t>(start), row,
                                      lo, hi, vec);
    out[r] = sl >= 0 && acc[s] != 0;
}

template <bool kTags>
int launch(const uint8_t* rows, const int32_t* lengths, int64_t B, int32_t L,
           const uint8_t* t256, int32_t S, const int32_t* accept,
           int32_t start, void* out, int32_t threads, int32_t smem,
           cudaStream_t stream, cudaEvent_t ev_start, cudaEvent_t ev_end) {
    if (B <= 0) return 0;
    if (threads < 32 || threads > kMaxThreads || threads % 32 || S < 1
        || S > kMaxStates || start < 0 || start >= S)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (B + threads - 1) / threads;
    cudaError_t e;
    if (ev_start && (e = cudaEventRecord(ev_start, stream)) != cudaSuccess)
        return static_cast<int>(e);
    dfa_walk_kernel<kTags><<<static_cast<unsigned>(blocks), threads, smem,
                             stream>>>(rows, lengths, B, L, t256, S, accept,
                                       start, out);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    if (ev_end) e = cudaEventRecord(ev_end, stream);
    return static_cast<int>(e);
}

}  // namespace

extern "C" {

// ev_start / ev_end: CUDA events recorded around the launch, or null.

// K2: out is bool [B] (one byte a row).
int lct_dfa_match(const uint8_t* rows, const int32_t* lengths, int64_t B,
                  int32_t L, const uint8_t* t256, int32_t S,
                  const int32_t* accept, int32_t start, uint8_t* out,
                  int32_t threads, int32_t smem, void* stream,
                  void* ev_start, void* ev_end) {
    return launch<false>(rows, lengths, B, L, t256, S, accept, start, out,
                         threads, smem, static_cast<cudaStream_t>(stream),
                         static_cast<cudaEvent_t>(ev_start),
                         static_cast<cudaEvent_t>(ev_end));
}

// K4: out is int32 [B], the u32 accept-tag mask of each row.
int lct_fused_scan(const uint8_t* rows, const int32_t* lengths, int64_t B,
                   int32_t L, const uint8_t* t256, int32_t S,
                   const int32_t* accept, int32_t start, int32_t* out,
                   int32_t threads, int32_t smem, void* stream,
                   void* ev_start, void* ev_end) {
    return launch<true>(rows, lengths, B, L, t256, S, accept, start, out,
                        threads, smem, static_cast<cudaStream_t>(stream),
                        static_cast<cudaEvent_t>(ev_start),
                        static_cast<cudaEvent_t>(ev_end));
}

// K3: out is bool [B]; starts and spanlens are int32 [B], row-relative.
int lct_dfa_span_match(const uint8_t* rows, const int32_t* lengths,
                       int64_t B, int32_t L, const uint8_t* t256, int32_t S,
                       const int32_t* accept, int32_t start,
                       const int32_t* starts, const int32_t* spanlens,
                       uint8_t* out, int32_t threads, int32_t smem,
                       void* stream, void* ev_start, void* ev_end) {
    if (B <= 0) return 0;
    if (threads < 32 || threads > kMaxThreads || threads % 32 || S < 1
        || S > kMaxStates || start < 0 || start >= S)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (B + threads - 1) / threads;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (ev_start && (e = cudaEventRecord(static_cast<cudaEvent_t>(ev_start),
                                         st)) != cudaSuccess)
        return static_cast<int>(e);
    dfa_span_kernel<<<static_cast<unsigned>(blocks), threads, smem, st>>>(
        rows, lengths, B, L, t256, S, accept, start, starts, spanlens, out);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    if (ev_end) e = cudaEventRecord(static_cast<cudaEvent_t>(ev_end), st);
    return static_cast<int>(e);
}

// Loads the walkers' code now: CUDA loads a module's kernels lazily, at
// their first launch, and the first batch's time would hold the load.
int lct_dfa_prepare(void) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, dfa_walk_kernel<false>);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, dfa_walk_kernel<true>);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, dfa_span_kernel);
    return static_cast<int>(e);
}

const char* lct_dfa_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
