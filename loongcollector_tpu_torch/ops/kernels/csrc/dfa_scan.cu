// K2, K3 and K4: the Tier-2 DFA walk, one thread per row, for sm_90a.
//
// Replaces three XLA programs of the JAX package (ops/kernels/dfa_scan.py):
//   K2  build_dfa_match_fn       full DFA match per row  -> bool  [B]
//   K3  build_dfa_span_match_fn  K2 over a span per row  -> bool  [B]
//   K4  build_fused_scan_fn      fused multi-accept DFA  -> int32 [B] (u32)
// Each runs one automaton over u8 rows [B, L] with i32 lengths [B]:
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
// fused set's device cap) and the per-state outputs into accept[S], and
// numbers the settled states (every state reachable from one has its accept
// value) from first_settled up; the tables are arguments, so one build
// serves every pattern.  Each block copies t256 and accept into shared
// memory once, as asynchronous 16-byte copies (cp.async) waited for once.
//
// What bounds it on this card: the latency chain, not bytes.  Each step is
// one shared-memory load whose address depends on the previous load (~37
// cycles a byte measured), so a row of n bytes costs n dependent loads,
// while the rows are a few hundred KB a batch (0.0002 ms at 3.35 TB/s).  A
// warp runs until its longest row is done: a batch of B = 2048 rows of up
// to 4096 bytes ran 4096 * 37 cycles, ~0.09 ms.  What acts on that chain:
//   * the settled exit (dfa_walk.cuh): a walk stops once its state is
//     settled, checked once a 16-byte word, off the chain.  It is exact: no
//     later byte can change the accept value.  A Java message that holds
//     "Exception" settles by its ~100th byte however long it is;
//   * rows are read straight from device memory with 16-byte loads when the
//     row is 16-byte aligned (L a multiple of 16, as every bucket is), else
//     byte by byte, and the next word is loaded while this one is walked;
//   * one row a thread, 32 to 128 threads a block: for K2 and K3 the
//     wrapper halves the block from 128 while the batch would leave an SM
//     without one (dfa_scan_cuda.launch_geometry); K4 takes 128.
// A row that never settles still walks all its bytes on one thread.  A warp
// a row (each lane a 16-byte chunk's transition map from every state, the
// maps composed 32 chunks at a time) was faster only on long rows that
// never settle, which no path sends, and level on the paths' own rows
// (PERF.md section 6), so it is not built.
//
// K4 adds the skip (fused_scan_kernel, fused_scan_walk): a state s below
// the settled ones whose escape set E(s) = { b : t256[s][b] != s } holds
// one to four bytes is a skip state, and the host packs E(s) for each state
// (dfa_scan.py skip_escapes: the bytes in the low word, |E(s)| in the high
// word, 0 for any other state).  Once a word, where the walk already checks
// for a settled state, it reads its state's skip word (beside the word's
// first table step: both loads hang on the state alone, so a state that is
// not a skip state adds no step to the chain).  In a skip state, a word
// that holds none of its escape bytes is not walked: the walk scans the
// following words, eight loaded at once, for the first that holds one
// below the length (each 32-bit lane XORed with each escape byte
// broadcast, a zero-byte test, ORed, and __ffs), and walks that word
// through the table from its first byte; with none, the state is the
// row's.  A byte outside E(s) leaves the state at s, so the skip changes
// no result.  Path 2's start/continue set sits in a `.*` tail after ~11
// bytes of a header line, which only `\n` leaves, so a 250-byte row walks
// ~16 bytes through the table and scans ~14 words.  K2, K3 and K7 keep the
// plain walk.
//
// K3 adds the length gate (dfa_span_kernel): the host computes, for each
// automaton, the span lengths n for which some walk of exactly n bytes from
// the start ends in an accepting state (dfa_scan.length_gate: their hull
// [lo, hi] and, where the hull is not exact, their bitmap).  A row whose
// walked length (the span cut at the row's length) fails the gate gives 0
// without loading a row byte or a table byte: a fullmatch of /health
// accepts only 7 bytes, of [45]\d\d only 3.  The gate is a necessary
// condition, so it changes no result.  The table copy is issued before the
// row's length, start and span length and the span's first word are
// loaded, and a block waits for it only if one of its rows passes.  A form
// that walks through the read-only cache with no copy measured slower at
// the paths' B=8192 (chip_probe.py K3_LDG, PERF.md section 6).
// The caller's timing events, when given, are recorded on the stream right
// around the launch, so a kernel's time holds no host latency.  The byte
// walk is in dfa_walk.cuh, which the fused stage program (fused_program.cu)
// shares.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dfa_walk.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMaxStates = 128;

// The block's copy of t256 and accept into shared memory, issued: each
// thread's share as cp.async copies in one batch, not waited for.
__device__ __forceinline__ void copy_tables_begin(uint8_t* tab, int32_t* acc,
                                                  const uint8_t* t256,
                                                  const int32_t* accept,
                                                  int S) {
  for (int i = threadIdx.x; i < S * 16; i += blockDim.x)
    __pipeline_memcpy_async(tab + 16 * i, t256 + 16 * i, 16);
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    __pipeline_memcpy_async(acc + i, accept + i, 4);
  __pipeline_commit();
}

// The block's copy of t256 and accept into shared memory, waited for.
__device__ __forceinline__ void copy_tables(uint8_t* tab, int32_t* acc,
                                            const uint8_t* t256,
                                            const int32_t* accept, int S) {
  copy_tables_begin(tab, acc, t256, accept, S);
  __pipeline_wait_prior(0);
  __syncthreads();
}

// K3's length gate: a walked span length n can be accepted only inside the
// hull [lo, hi] of the lengths the automaton accepts and, where the hull is
// not exact, with bit n of the host's bitmap set (dfa_scan.length_gate).
__device__ __forceinline__ bool gate_passes(int n, int32_t lo, int32_t hi,
                                            const uint32_t* bits) {
  if (n < lo || n > hi) return false;
  return bits == nullptr || ((__ldg(bits + (n >> 5)) >> (n & 31)) & 1u);
}

// K4's copy: t256, the skip table (u64: |E(s)| << 32 | the escape bytes)
// and accept, as one batch of cp.async copies waited for once.
__device__ __forceinline__ void copy_skip_tables(
    uint8_t* tab, unsigned long long* skip, int32_t* acc,
    const uint8_t* t256, const unsigned long long* skips,
    const int32_t* accept, int S) {
  for (int i = threadIdx.x; i < S * 16; i += blockDim.x)
    __pipeline_memcpy_async(tab + 16 * i, t256 + 16 * i, 16);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    __pipeline_memcpy_async(skip + i, skips + i, 8);
    __pipeline_memcpy_async(acc + i, accept + i, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Rows read as 16-byte words: the row 16-byte aligned and L a multiple of
// 16, so every word that holds a byte below the length lies in the row.
__device__ __forceinline__ bool aligned_rows(const uint8_t* row, int32_t L) {
  return (reinterpret_cast<uintptr_t>(row) & 15) == 0 && (L & 15) == 0;
}

// Bytes [0, n) of a row from state s, stopping at a settled state: whole
// 16-byte words, then the last partial word, when `vec`; else byte by
// byte.  The next word is loaded before this one is walked: the exit's
// branch would keep the compiler from hoisting it.
__device__ __forceinline__ uint32_t walk_prefix(const uint8_t* tab,
                                                uint32_t s, const uint8_t* row,
                                                int n, bool vec, uint32_t fs) {
  if (!vec) return walk_row_range(tab, s, row, 0, n, false, fs);
  const uint4* v = reinterpret_cast<const uint4*>(row);
  const int full = n >> 4, rem = n & 15;
  const int last = full - (rem == 0);
  if (last < 0) return s;
  uint4 q = __ldg(v);
  int w = 0;
  for (; w < full && s < fs; ++w) {
    const uint4 next = __ldg(v + min(w + 1, last));
    s = walk_vec(tab, s, q, 16);
    q = next;
  }
  if (rem && w == full && s < fs) s = walk_vec(tab, s, q, rem);
  return s;
}

// The escape bytes of one 32-bit lane x: the high bit of a byte is set
// where the byte equals one of the first n (1..4) bytes of e, by the
// zero-byte test on x ^ the escape byte broadcast.  Only the lowest set
// bit is exact (a borrow may mark a byte above a match), and that is the
// one the scan reads.
__device__ __forceinline__ uint32_t lane_hits(uint32_t x, uint32_t e, int n) {
  uint32_t h = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < n) {
      const uint32_t y = x ^ (((e >> (8 * j)) & 0xFFu) * 0x01010101u);
      h |= (y - 0x01010101u) & ~y & 0x80808080u;
    }
  }
  return h;
}

// The first byte of q that is one of the escape bytes; 16: none.
__device__ __forceinline__ int first_escape(uint4 q, uint32_t e, int n) {
  const uint32_t h0 = lane_hits(q.x, e, n), h1 = lane_hits(q.y, e, n);
  const uint32_t h2 = lane_hits(q.z, e, n), h3 = lane_hits(q.w, e, n);
  if (!(h0 | h1 | h2 | h3)) return 16;
  if (h0) return (__ffs(h0) - 1) >> 3;
  if (h1) return 4 + ((__ffs(h1) - 1) >> 3);
  if (h2) return 8 + ((__ffs(h2) - 1) >> 3);
  return 12 + ((__ffs(h3) - 1) >> 3);
}

constexpr int kScanWords = 8;     // words a scan loads at once: 128 bytes

// K4's walk of bytes [0, n) of an aligned row from state s, a word at a
// time, from its first word q.  At each word it stops at a settled state,
// as walk_prefix does; else it reads the state's skip word and, beside it,
// the step on the word's first byte (both loads hang on s alone).  A state
// that is not a skip state, or a skip state whose word holds one of its
// escape bytes, walks the word through the table.  A skip state whose word
// holds none scans the following words, kScanWords at a time (their loads
// all in flight at once, not one word ahead), for the first that holds an
// escape byte below the length (none: the walk is done), and walks that
// word from its first byte: the bytes before the escape leave the state
// as it is.
__device__ __forceinline__ uint32_t fused_scan_walk(
    const uint8_t* tab, const unsigned long long* skip, uint32_t s,
    const uint8_t* row, int n, uint32_t fs, uint4 q) {
  if (n <= 0) return s;
  const uint4* v = reinterpret_cast<const uint4*>(row);
  const int last = (n - 1) >> 4;
  int w = 0;
  for (;;) {
    if (s >= fs) return s;
    const unsigned long long e = skip[s];
    uint32_t t = tab[(s << 8) | (q.x & 0xFFu)];
    uint4 next = __ldg(v + min(w + 1, last));
    if (e >> 32) {
      const uint32_t eb = static_cast<uint32_t>(e);
      const int ne = static_cast<int>(e >> 32);
      int p = first_escape(q, eb, ne);
      if (p == 16) {                      // none in this word: skip it
        for (int w0 = w + 1; p == 16 && w0 <= last; w0 += kScanWords) {
          uint4 c[kScanWords];
#pragma unroll
          for (int j = 0; j < kScanWords; ++j)
            c[j] = __ldg(v + min(w0 + j, last));
#pragma unroll
          for (int j = 0; j < kScanWords; ++j) {
            if (p == 16 && w0 + j <= last) {
              p = first_escape(c[j], eb, ne);
              w = w0 + j;
              q = c[j];
            }
          }
        }
        if (p == 16) return s;            // no escape byte to the row's end
        next = __ldg(v + min(w + 1, last));
        t = tab[(s << 8) | (q.x & 0xFFu)];
      }
      if (16 * w + p >= n) return s;      // no escape byte below the length
    }
    s = walk_vec_range(tab, t, q, 1, w == last ? n - 16 * w : 16);
    if (w == last) return s;
    ++w;
    q = next;
  }
}

// K2: one row a thread.
__global__ void __launch_bounds__(kMaxThreads)
dfa_walk_kernel(const uint8_t* __restrict__ rows,
                const int32_t* __restrict__ lengths, int64_t B, int32_t L,
                const uint8_t* __restrict__ t256, int32_t S,
                const int32_t* __restrict__ accept, int32_t start,
                int32_t first_settled, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tab = smem;
  int32_t* acc = reinterpret_cast<int32_t*>(smem + S * 256);
  copy_tables(tab, acc, t256, accept, S);

  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (r >= B) return;
  int len = lengths[r];
  len = len < 0 ? 0 : (len > L ? L : len);
  const uint8_t* row = rows + r * L;
  const uint32_t s = walk_prefix(tab, static_cast<uint32_t>(start), row,
                                 len, aligned_rows(row, L),
                                 static_cast<uint32_t>(first_settled));
  out[r] = acc[s] != 0;
}

// K4: one row a thread, with the skip (fused_scan_walk) on aligned rows.
// The row's length and first word are loaded before the block waits for
// its tables, so their latency runs beside the copy.
__global__ void __launch_bounds__(kMaxThreads)
fused_scan_kernel(const uint8_t* __restrict__ rows,
                  const int32_t* __restrict__ lengths, int64_t B, int32_t L,
                  const uint8_t* __restrict__ t256, int32_t S,
                  const int32_t* __restrict__ accept, int32_t start,
                  int32_t first_settled,
                  const unsigned long long* __restrict__ skips,
                  int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tab = smem;
  unsigned long long* skip =
      reinterpret_cast<unsigned long long*>(smem + S * 256);
  int32_t* acc = reinterpret_cast<int32_t*>(skip + S);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  const uint8_t* row = rows + r * L;
  const bool vec = L > 0 && aligned_rows(row, L);
  int len = 0;
  uint4 q = make_uint4(0u, 0u, 0u, 0u);
  if (r < B) {
    len = lengths[r];
    if (vec) q = __ldg(reinterpret_cast<const uint4*>(row));
  }
  copy_skip_tables(tab, skip, acc, t256, skips, accept, S);

  if (r >= B) return;
  len = len < 0 ? 0 : (len > L ? L : len);
  const uint32_t fs = static_cast<uint32_t>(first_settled);
  const uint32_t s = vec
      ? fused_scan_walk(tab, skip, static_cast<uint32_t>(start), row, len,
                        fs, q)
      : walk_prefix(tab, static_cast<uint32_t>(start), row, len, false, fs);
  out[r] = acc[s];
}

// K3's walk of bytes [lo, hi) (lo < hi) of an aligned row from state s,
// stopping at a settled state once a 16-byte word, from the first word q
// (the one that holds byte lo), already loaded.
__device__ __forceinline__ uint32_t walk_span(const uint8_t* tab, uint32_t s,
                                              const uint8_t* row, int lo,
                                              int hi, uint32_t fs, uint4 q) {
  const uint4* v = reinterpret_cast<const uint4*>(row);
  const int w0 = lo >> 4, w1 = (hi - 1) >> 4;
  for (int w = w0; w <= w1 && s < fs; ++w) {
    if (w != w0) q = __ldg(v + w);
    const int a = w == w0 ? lo & 15 : 0;
    const int b = w == w1 ? hi - 16 * w : 16;
    s = a == 0 ? walk_vec(tab, s, q, b) : walk_vec_range(tab, s, q, a, b);
  }
  return s;
}

// K3: the walk over bytes [max(start, 0), start + max(spanlen, 0)) of each
// row, cut at the row's length; a row with spanlen < 0 gives 0, and so does
// a row whose walked length fails the gate, before it reads a row byte or a
// table byte.  The table copy is issued first; the row's length, start and
// span length, then (a row that walks, aligned) the span's first 16-byte
// word are loaded while it is in flight.  A block whose rows all fail
// writes its zeros and only drains its copies (a block leaves no copy in
// flight into shared memory that the next block may take).
__global__ void __launch_bounds__(kMaxThreads)
dfa_span_kernel(const uint8_t* __restrict__ rows,
                const int32_t* __restrict__ lengths, int64_t B, int32_t L,
                const uint8_t* __restrict__ t256, int32_t S,
                const int32_t* __restrict__ accept, int32_t start,
                int32_t first_settled, const int32_t* __restrict__ starts,
                const int32_t* __restrict__ spanlens, int32_t gate_lo,
                int32_t gate_hi, const uint32_t* __restrict__ gate_bits,
                uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tab = smem;
  int32_t* acc = reinterpret_cast<int32_t*>(smem + S * 256);
  copy_tables_begin(tab, acc, t256, accept, S);

  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  int lo = 0, hi = 0;
  bool walk = false;
  if (r < B) {
    int len = lengths[r];
    len = len < 0 ? 0 : (len > L ? L : len);
    const int32_t st = starts[r], sl = spanlens[r];
    const int64_t end = static_cast<int64_t>(st) + (sl < 0 ? 0 : sl);
    lo = st < 0 ? 0 : st;
    hi = static_cast<int>(end < len ? end : len);
    walk = sl >= 0 && gate_passes(max(hi - lo, 0), gate_lo, gate_hi,
                                  gate_bits);
  }
  const uint8_t* row = rows + r * L;
  const bool vec = aligned_rows(row, L);
  uint4 q = make_uint4(0u, 0u, 0u, 0u);
  if (walk && vec && hi > lo)
    q = __ldg(reinterpret_cast<const uint4*>(row) + (lo >> 4));
  if (!__syncthreads_or(walk)) {
    if (r < B) out[r] = 0;
    __pipeline_wait_prior(0);
    return;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (r >= B) return;
  bool m = false;
  if (walk) {
    uint32_t s = static_cast<uint32_t>(start);
    const uint32_t fs = static_cast<uint32_t>(first_settled);
    if (!vec)
      s = walk_row_range(tab, s, row, lo, hi, false, fs);
    else if (hi > lo)
      s = walk_span(tab, s, row, lo, hi, fs, q);
    m = acc[s] != 0;
  }
  out[r] = m;
}

// The automaton's arguments, checked as every entry point checks them.
bool bad_automaton(int32_t S, int32_t start, int32_t first_settled) {
  return S < 1 || S > kMaxStates || start < 0 || start >= S
         || first_settled < 0 || first_settled > S;
}

template <bool kTags>
int launch(const uint8_t* rows, const int32_t* lengths, int64_t B, int32_t L,
           const uint8_t* t256, int32_t S, const int32_t* accept,
           int32_t start, int32_t first_settled,
           const unsigned long long* skips, void* out, int32_t threads,
           int32_t smem, cudaStream_t stream, cudaEvent_t ev_start,
           cudaEvent_t ev_end) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32
      || bad_automaton(S, start, first_settled) || (kTags && !skips))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (B + threads - 1) / threads;
  cudaError_t e;
  if (ev_start && (e = cudaEventRecord(ev_start, stream)) != cudaSuccess)
    return static_cast<int>(e);
  if (kTags) {
    fused_scan_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                        stream>>>(rows, lengths, B, L, t256, S, accept, start,
                                  first_settled, skips,
                                  static_cast<int32_t*>(out));
  } else {
    dfa_walk_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                      stream>>>(rows, lengths, B, L, t256, S, accept, start,
                                first_settled, static_cast<uint8_t*>(out));
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (ev_end) e = cudaEventRecord(ev_end, stream);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// first_settled: the automaton's first settled state (S: none).
// ev_start / ev_end: CUDA events recorded around the launch, or null.

// K2: out is bool [B] (one byte a row).
int lct_dfa_match(const uint8_t* rows, const int32_t* lengths, int64_t B,
                  int32_t L, const uint8_t* t256, int32_t S,
                  const int32_t* accept, int32_t start, int32_t first_settled,
                  uint8_t* out, int32_t threads, int32_t smem, void* stream,
                  void* ev_start, void* ev_end) {
  return launch<false>(rows, lengths, B, L, t256, S, accept, start,
                       first_settled, nullptr, out, threads, smem,
                       static_cast<cudaStream_t>(stream),
                       static_cast<cudaEvent_t>(ev_start),
                       static_cast<cudaEvent_t>(ev_end));
}

// K4: out is int32 [B], the u32 accept-tag mask of each row; skips is the
// u64 [S] skip table (|E(s)| << 32 | escape bytes; 0: not a skip state),
// smem at least 264 S bytes.
int lct_fused_scan(const uint8_t* rows, const int32_t* lengths, int64_t B,
                   int32_t L, const uint8_t* t256, int32_t S,
                   const int32_t* accept, int32_t start,
                   int32_t first_settled, const unsigned long long* skips,
                   int32_t* out, int32_t threads, int32_t smem, void* stream,
                   void* ev_start, void* ev_end) {
  return launch<true>(rows, lengths, B, L, t256, S, accept, start,
                      first_settled, skips, out, threads, smem,
                      static_cast<cudaStream_t>(stream),
                      static_cast<cudaEvent_t>(ev_start),
                      static_cast<cudaEvent_t>(ev_end));
}

// K3: out is bool [B]; starts and spanlens are int32 [B], row-relative;
// gate_lo, gate_hi and gate_bits the length gate (gate_bits: u32 words over
// lengths 0..L at least, or null where the hull is exact).
int lct_dfa_span_match(const uint8_t* rows, const int32_t* lengths,
                       int64_t B, int32_t L, const uint8_t* t256, int32_t S,
                       const int32_t* accept, int32_t start,
                       int32_t first_settled, const int32_t* starts,
                       const int32_t* spanlens, int32_t gate_lo,
                       int32_t gate_hi, const uint32_t* gate_bits,
                       uint8_t* out, int32_t threads,
                       int32_t smem, void* stream,
                       void* ev_start, void* ev_end) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32
      || bad_automaton(S, start, first_settled))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (B + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (ev_start && (e = cudaEventRecord(static_cast<cudaEvent_t>(ev_start),
                                       st)) != cudaSuccess)
    return static_cast<int>(e);
  dfa_span_kernel<<<static_cast<unsigned>(blocks), threads, smem, st>>>(
      rows, lengths, B, L, t256, S, accept, start, first_settled, starts,
      spanlens, gate_lo, gate_hi, gate_bits, out);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (ev_end) e = cudaEventRecord(static_cast<cudaEvent_t>(ev_end), st);
  return static_cast<int>(e);
}

// Loads the walkers' code now: CUDA loads a module's kernels lazily, at
// their first launch, and the first batch's time would hold the load.
int lct_dfa_prepare(void) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, dfa_walk_kernel);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fused_scan_kernel);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, dfa_span_kernel);
  return static_cast<int>(e);
}

const char* lct_dfa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
