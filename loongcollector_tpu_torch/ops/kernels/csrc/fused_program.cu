// K7: one pipeline program of Tier-1 extract, DFA scan, filter-keep and
// structural-index stages over rows staged once, for sm_90a.
//
// Replaces the XLA program of the JAX package's resident stage fusion
// (loongcollector_tpu/ops/fused_pipeline.py:156, build_fused_fn), which
// chains the member stages' kernels (K1 build_extract_fn, K4
// build_fused_scan_fn, K2 build_dfa_match_fn, K3 build_dfa_span_match_fn,
// K5 build_index_fn) into one jitted program per stage list: inputs packed
// once, inter-stage capture spans kept on the device, every output back in
// one transfer.
//
// What it computes, per row, stage by stage (fused_pipeline.build_fused_fn
// is the plain version it is held bit-exact against):
//   extract  the Tier-1 program's ok bit and capture spans (row-relative);
//   scan     the fused automaton's accept value (u32 tags carried as i32);
//   keep     the AND of its conditions, each optionally negated:
//              match       a DFA full match of the row, and length >= 0;
//              extract_ok  a Tier-1 program's ok bit, and length >= 0;
//              span_match  a DFA full match of the bytes of capture `cap` of
//                          an earlier extract stage, cut at the row's length;
//                          false where that capture is absent (len -1),
//                          before any negation;
//   struct_index  K5's four bitmaps of the row (in_string, structural,
//                 escaped, quote), JSON or delimiter mode, ceil(L / 16) i32
//                 words a row each: the warp walks its rows' tile bytes one
//                 row at a time with struct_walk.cuh, as K5 walks them.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 700 W): bytes, the row bytes
// below each length, the lengths, the descriptor and B * (outputs) bytes.
// For the Apache filter path (B=8192, ~5,500 rows of ~95 bytes, L=128, one
// 9-capture extract and two span conditions) that is ~1.2 MB, ~0.36 us:
// far below a launch.  Each row's walks are chains of dependent
// shared-memory loads, so a row's latency sets the time, as in K1 and K2.
//
// The design:
//  * One launch a chunk.  Each warp stages its 32 rows into the block's
//    shared tile once (extract_walk.cuh's stage_warp_rows, K1's staging);
//    every stage then walks those bytes: the Tier-1 walker (extract_walk.cuh)
//    and the DFA byte walk (dfa_walk.cuh) over the tile's 32-bit words.
//  * The stage list is data: one int32 descriptor (fused_program_cuda.py):
//    a header, a record a stage and a record a condition, then the sections
//    (Tier-1 programs, automata as t256[S][256] with their accept values).
//    One build serves every pipeline.  The host packs the header, the
//    records and the sections that fit first, padded to 16 bytes; the block
//    copies those words into shared memory with 16-byte cp.async copies,
//    issued before the rows are staged and waited for once, so the copy
//    runs beside the staging.  Sections that would not fit beside the rows
//    of the smallest block at the largest bucket stay in device memory:
//    automata read through the read-only cache, programs through L1.
//  * A keep condition's record holds what its test needs, resolved on the
//    host: the producer's final capture state (offset, stride, count), the
//    automaton's start, first settled state, table and accept offsets and
//    its placement.  A row reads the record (four 16-byte shared loads,
//    the same for every row) and then only its own capture state and
//    bytes: no stage record or automaton header on the row's chain.
//  * Capture spans never leave the block: each extract stage keeps its
//    capture state in shared memory ((3C | 1) words a row, as K1), and a
//    later span condition reads it from there.  The warp writes the spans
//    out, coalesced, for the host only.
//  * Outputs: one flat buffer, the fixed i32 arrays first (each stage's
//    cap_off, cap_len, tags), then the struct_index masks (N_WIDE arrays of
//    ceil(L / 16) words a row), then the byte arrays (ok, keep), an array
//    at B * (row bytes before it).  The host copies it back once.
//  * Instantiations: the first extract stage, when its program is depth 0
//    and in shared memory, runs on its own inlined walker (by pivot kind),
//    so the Apache program's stage has no stack frame (chip_smoke.py phase 1
//    checks).  extract_ok conditions, later extract stages and nested
//    programs run on the general walker (nested, pivot by the header): one
//    out-of-line function, called only by the instantiations built for a
//    stage list that has such a program, so the build compiles the nested
//    walkers once.
// Padding rows (length 0) are walked and written like any row; rows past B
// are not.  Plain C interface, loaded with ctypes.

#include <atomic>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "dfa_walk.cuh"
#include "extract_walk.cuh"
#include "struct_walk.cuh"

namespace {

// descriptor header indices (fused_program_cuda.py _HEADER)
enum : int {
  D_MAGIC = 0, D_NSTAGES, D_SHARED_WORDS, D_TOTAL_WORDS, D_FIRST,
  D_FIRST_STAGE, D_GENERAL, D_CAPS_WORDS, D_SCRATCH_OFF, D_ROW_BYTES,
  D_NCONDS, D_NWIDE, D_HEADER = 16
};
constexpr int32_t kMagic = 0x4B375046;
constexpr int kRecordWords = 8;
constexpr int kCondWords = 16;
constexpr int kMaxStages = 32;
// stage record: kind; section (extract, scan) or first condition (keep) or
// mode (struct_index); captures (extract) or conditions (keep) or separator
// (struct_index); capture state offset (words a thread); pivot; outputs as
// bytes a row before each array (struct_index: the fixed i32 arrays' bytes
// a row, then its first mask's index among the mask arrays)
enum : int {
  S_KIND = 0, S_SEC, S_COUNT, S_CAPS_OFF, S_PIVOT, S_OUT0, S_OUT1, S_OUT2
};
enum : int { ST_EXTRACT = 0, ST_SCAN = 1, ST_KEEP = 2, ST_STRUCT_INDEX = 3 };
// condition record (kCondWords, 16-byte aligned): kind, negate, section,
// producer stage, capture; span: the producer's final capture state, in
// words of T from the capture state's start (its offset, past the forward
// copy for a pivot program), its stride (3C | 1) and capture count C
// (extract_ok: the program's stride and count); match and span: the
// automaton's states, start, first settled state, accept and table offsets,
// and 1 when the section lies in the shared part
enum : int {
  C_KIND = 0, C_NEG, C_SEC, C_PROD, C_CAP, C_FIN, C_PCW, C_PC, C_S, C_START,
  C_FS, C_ACC, C_TAB, C_SHARED
};
enum : int { CK_MATCH = 0, CK_EXTRACT_OK = 1, CK_SPAN = 2 };

// The descriptor: its first `shared_words` words copied to shared memory,
// all of it in device memory.  An automaton section is
// [S, start, first_settled, 0][t256: S * 64 words][accept: S words], its
// settled states numbered from first_settled up (dfa_walk.cuh).
struct Blob {
  const int32_t* s;
  const int32_t* g;
  int32_t shared_words;
};

__device__ __forceinline__ const int32_t* section(const Blob& b,
                                                  int32_t off) {
  return off < b.shared_words ? b.s + off : b.g + off;
}

// The accept value of an automaton after bytes [lo, hi) of the tile row
// `w`, from its resolved fields: table and accept offsets in the descriptor,
// in its shared part or not, start and first settled state; the walk stops
// at a settled state.
__device__ __forceinline__ int32_t dfa_resolved(const Blob& b, bool shared,
                                                int32_t tab, int32_t acc,
                                                uint32_t start, uint32_t fs,
                                                const uint32_t* w, int lo,
                                                int hi) {
  if (shared) {
    const uint32_t s = walk_tile(reinterpret_cast<const uint8_t*>(b.s + tab),
                                 start, w, lo, hi, fs);
    return b.s[acc + s];
  }
  const uint32_t s = walk_tile(
      LdgTab{reinterpret_cast<const uint8_t*>(b.g + tab)}, start, w, lo, hi,
      fs);
  return __ldg(b.g + acc + s);
}

// The same for the automaton section at `off`, read from its header.
__device__ __forceinline__ int32_t dfa_tile(const Blob& b, int32_t off,
                                            const uint32_t* w, int lo,
                                            int hi) {
  const int32_t* a = section(b, off);
  const bool shared = off < b.shared_words;
  const int32_t S = shared ? a[0] : __ldg(a);
  const int32_t start = shared ? a[1] : __ldg(a + 1);
  const int32_t fs = shared ? a[2] : __ldg(a + 2);
  return dfa_resolved(b, shared, off + 4, off + 4 + 64 * S,
                      static_cast<uint32_t>(start), static_cast<uint32_t>(fs),
                      w, lo, hi);
}

// The shared part of the descriptor, `words` (a multiple of 4) from `src`
// (16-byte aligned) into `dst`: 16-byte cp.async copies spread over the
// block, left in flight; desc_copy_wait() waits for this thread's.
__device__ __forceinline__ void desc_copy_begin(int32_t* dst,
                                                const int32_t* src,
                                                int32_t words, int32_t tid,
                                                int32_t T) {
  for (int32_t i = 4 * tid; i < words; i += 4 * T)
    __pipeline_memcpy_async(dst + i, src + i, 16);
  __pipeline_commit();
}

__device__ __forceinline__ void desc_copy_wait() {
  __pipeline_wait_prior(0);
}

// A Tier-1 program on the general walker: nested, the pivot kind from its
// header.  Out of line, so every instantiation shares one copy.
__device__ __noinline__ bool extract_any(const int32_t* h, const Row r,
                                         const Caps cs, const Caps rs) {
  const int32_t pivot = h[M_HAS_P2] ? 2 : h[M_HAS_P1];
  if (pivot == 0) return extract_row<true, 0>(h, r, cs, rs);
  if (pivot == 1) return extract_row<true, 1>(h, r, cs, rs);
  return extract_row<true, 2>(h, r, cs, rs);
}

// Shared memory, in 32-bit words (fused_program_cuda.smem_bytes):
//   [descriptor words 0 .. shared_words)[tile T * (ceil(L/4) + 1)]
//   [capture state T * caps_words]
// where each extract stage's state is T * (3C | 1) words (twice for a pivot
// program: the reverse walk's copy follows), then the scratch state of the
// general walker's extract_ok conditions.  FIRST is the pivot kind of the
// first extract stage's depth-0 program, run on its own walker, or -1 when
// none does; GENERAL compiles in calls to the general walker.
template <int FIRST, bool GENERAL>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
fused_program_kernel(const uint8_t* __restrict__ rows,
                     const int32_t* __restrict__ lens, int64_t B, int32_t L,
                     const int32_t* __restrict__ desc,
                     uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  const int32_t T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int64_t row0 = (int64_t)blockIdx.x * T;
  const int32_t nrows = B - row0 < T ? (int32_t)(B - row0) : T;
  const int32_t wrow = tid - lane;         // this warp's first row
  const int32_t wrows = max(0, min(32, nrows - wrow));
  const int32_t ws = (L + 3) / 4 + 1;      // tile row stride in words
  const int32_t shared_words = __ldg(desc + D_SHARED_WORDS);

  int32_t* const sdesc = smem;
  uint32_t* const tile = reinterpret_cast<uint32_t*>(sdesc + shared_words);
  int32_t* const scaps = reinterpret_cast<int32_t*>(tile + T * ws);

  const int32_t len = tid < nrows ? __ldg(lens + row0 + tid) : 0;
  desc_copy_begin(sdesc, desc, shared_words, tid, T);
  stage_warp_rows(rows, row0, wrow, wrows, lane, L, len, tile, ws);
  desc_copy_wait();
  __syncthreads();

  const int32_t* d = sdesc;
  const int32_t nst = d[D_NSTAGES];
  const uint32_t need = 4u * (shared_words + T * ws + T * d[D_CAPS_WORDS]);
  // the host picks the instantiation and the size from the same descriptor
  if (d[D_MAGIC] != kMagic || d[D_FIRST] != FIRST ||
      (d[D_GENERAL] != 0) != GENERAL || nst > kMaxStages ||
      (shared_words & 3) != 0 || need > dynamic_smem_bytes())
    __trap();

  const Blob b{sdesc, desc, shared_words};
  // 16-byte aligned: the header and each stage record are 8 words
  const int32_t* conds = d + D_HEADER + kRecordWords * nst;
  const bool live = tid < nrows;
  const Row r{tile + tid * ws, L, len};
  const int32_t clen = len < 0 ? 0 : (len > L ? L : len);  // bytes a DFA walks
  // a mask row's words, and the mask arrays' bytes ahead of the byte arrays
  const int32_t W = (L + 15) >> 4;
  const int64_t bshift = B * 4 * W * d[D_NWIDE];
  uint32_t ext_ok = 0;      // bit si: extract stage si matched this row
  for (int32_t si = 0; si < nst; ++si) {
    const int32_t* st = d + D_HEADER + kRecordWords * si;
    const int32_t kind = st[S_KIND];
    if (kind == ST_EXTRACT) {
      const int32_t C = st[S_COUNT], cw = (3 * C) | 1;
      int32_t* const fwd = scaps + T * st[S_CAPS_OFF];
      int32_t* const rev = fwd + T * cw;
      const Caps cs{fwd + tid * cw, C};
      const Caps rs{rev + tid * cw, C};
      bool ok = false;
      if (live) {
        if constexpr (FIRST >= 0) {
          if (si == d[D_FIRST_STAGE]) {
            ok = extract_row<false, (FIRST < 0 ? 0 : FIRST)>(
                sdesc + st[S_SEC], r, cs, rs);
          } else if constexpr (GENERAL) {
            ok = extract_any(section(b, st[S_SEC]), r, cs, rs);
          } else {
            __trap();
          }
        } else if constexpr (GENERAL) {
          ok = extract_any(section(b, st[S_SEC]), r, cs, rs);
        } else {
          __trap();
        }
        out[B * st[S_OUT0] + bshift + row0 + tid] = ok;
      }
      ext_ok |= static_cast<uint32_t>(ok) << si;
      __syncwarp();
      write_warp_caps((st[S_PIVOT] ? rev : fwd) + wrow * cw, cw, C, ok, lane,
                      wrows,
                      reinterpret_cast<int32_t*>(out + B * st[S_OUT1])
                          + (row0 + wrow) * C,
                      reinterpret_cast<int32_t*>(out + B * st[S_OUT2])
                          + (row0 + wrow) * C);
    } else if (kind == ST_SCAN) {
      if (live)
        reinterpret_cast<int32_t*>(out + B * st[S_OUT0])[row0 + tid] =
            dfa_tile(b, st[S_SEC], r.w, 0, clen);
    } else if (kind == ST_STRUCT_INDEX) {
      // the warp walks its rows one at a time, as K5 does
      int32_t* const masks = reinterpret_cast<int32_t*>(out + B * st[S_OUT0])
                             + B * W * st[S_OUT1];
      const uint32_t sep = static_cast<uint32_t>(st[S_COUNT]);
      for (int32_t i = 0; i < wrows; ++i) {
        const int32_t rl = __shfl_sync(0xffffffffu, len, i);
        const int32_t n = rl < 0 ? 0 : (rl > L ? L : rl);
        const uint8_t* const tb =
            reinterpret_cast<const uint8_t*>(tile + (wrow + i) * ws);
        const auto fetch = [tb](int32_t p) { return tb[p]; };
        int32_t* const o = masks + (row0 + wrow + i) * W;
        if (st[S_SEC] == kStructJson)
          struct_row<kStructJson>(fetch, L, n, sep, lane, o, B * W);
        else
          struct_row<kStructDelim>(fetch, L, n, sep, lane, o, B * W);
      }
    } else if (live) {      // keep
      bool keep = true;
      const int32_t c_end = st[S_SEC] + st[S_COUNT];
      for (int32_t ci = st[S_SEC]; keep && ci < c_end; ++ci) {
        // the record, resolved on the host: four 16-byte loads, the same
        // address in every lane.  c0 = {C_KIND, C_NEG, C_SEC, C_PROD},
        // c1 = {C_CAP, C_FIN, C_PCW, C_PC}, c2 = {C_S, C_START, C_FS,
        // C_ACC}, c3 = {C_TAB, C_SHARED, 0, 0}
        const int4* cr =
            reinterpret_cast<const int4*>(conds + kCondWords * ci);
        const int4 c0 = cr[0], c1 = cr[1], c2 = cr[2], c3 = cr[3];
        const int32_t kind = c0.x;
        bool ok;
        if (kind == CK_MATCH) {
          ok = len >= 0 &&
               dfa_resolved(b, c3.y, c3.x, c2.w, c2.y, c2.z, r.w, 0,
                            clen) != 0;
        } else if (kind == CK_SPAN) {
          // the producer's final capture state, as its write-back reads it
          const int32_t cap = c1.x;
          const int32_t* fin = scaps + T * c1.y + tid * c1.z;
          const bool pok = (ext_ok >> c0.w) & 1u;
          const int32_t so = pok ? fin[cap] : 0;
          const int32_t sl = pok ? fin[c1.w + cap] : -1;
          const int64_t end = (int64_t)so + (sl < 0 ? 0 : sl);
          const int32_t lo = so < 0 ? 0 : so;
          const int32_t hi = (int32_t)(end < clen ? end : clen);
          ok = sl >= 0 &&
               dfa_resolved(b, c3.y, c3.x, c2.w, c2.y, c2.z, r.w, lo,
                            hi) != 0;
        } else {
          if constexpr (GENERAL) {
            const int32_t* h = c3.y ? sdesc + c0.z : desc + c0.z;
            const int32_t pcw = c1.z;
            int32_t* const sf = scaps + T * d[D_SCRATCH_OFF];
            ok = len >= 0 &&
                 extract_any(h, r, Caps{sf + tid * pcw, c1.w},
                             Caps{sf + T * pcw + tid * pcw, c1.w});
          } else {
            __trap();
          }
        }
        keep = c0.y ? !ok : ok;
      }
      out[B * st[S_OUT0] + bshift + row0 + tid] = keep;
    }
  }
}

using Kernel = void (*)(const uint8_t*, const int32_t*, int64_t, int32_t,
                        const int32_t*, uint8_t*);

template <int FIRST, bool GENERAL>
int launch_one(const uint8_t* rows, const int32_t* lens, int64_t B, int32_t L,
               const int32_t* desc, uint8_t* out, int32_t threads,
               int32_t smem_bytes, cudaStream_t stream) {
  Kernel kernel = fused_program_kernel<FIRST, GENERAL>;
  // as in field_extract.cu: each instantiation opts into the whole budget
  // once per device
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBudget);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const int64_t blocks = (B + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, (size_t)smem_bytes, stream>>>(
      rows, lens, B, L, desc, out);
  return (int)cudaGetLastError();
}

using Launcher = int (*)(const uint8_t*, const int32_t*, int64_t, int32_t,
                         const int32_t*, uint8_t*, int32_t, int32_t,
                         cudaStream_t);

// by [FIRST + 1][GENERAL]
constexpr Launcher kLaunchers[4][2] = {
    {launch_one<-1, false>, launch_one<-1, true>},
    {launch_one<0, false>, launch_one<0, true>},
    {launch_one<1, false>, launch_one<1, true>},
    {launch_one<2, false>, launch_one<2, true>},
};

const Kernel kKernels[4][2] = {
    {fused_program_kernel<-1, false>, fused_program_kernel<-1, true>},
    {fused_program_kernel<0, false>, fused_program_kernel<0, true>},
    {fused_program_kernel<1, false>, fused_program_kernel<1, true>},
    {fused_program_kernel<2, false>, fused_program_kernel<2, true>},
};

}  // namespace

extern "C" {

// One launch on `stream` without synchronising: rows u8 [B, L], lens i32
// [B], the descriptor `desc` in device memory, `out` the flat output of
// B * (ROW_BYTES + 4 * ceil(L / 16) * N_WIDE) bytes; `first` and `general` pick the instantiation (from
// the descriptor's header), `threads` and `smem_bytes` the block
// (fused_program_cuda.launch_geometry).  ev_start / ev_end: CUDA events
// recorded right around the launch, or null.  Returns the cudaError_t.
int lct_fused_program(const uint8_t* rows, const int32_t* lens, int64_t B,
                      int32_t L, const int32_t* desc, int32_t first,
                      int32_t general, uint8_t* out, int32_t threads,
                      int32_t smem_bytes, void* stream, void* ev_start,
                      void* ev_end) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || first < -1 ||
      first > 2 || general < 0 || general > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (ev_start && (e = cudaEventRecord(static_cast<cudaEvent_t>(ev_start),
                                       st)) != cudaSuccess)
    return (int)e;
  const int rc = kLaunchers[first + 1][general](rows, lens, B, L, desc, out,
                                                threads, smem_bytes, st);
  if (rc != 0) return rc;
  if (ev_end) e = cudaEventRecord(static_cast<cudaEvent_t>(ev_end), st);
  else e = cudaSuccess;
  return (int)e;
}

// Loads every instantiation's code now (CUDA loads a module's kernels at
// their first launch, and the first chunk's time would hold the load).
int lct_fused_prepare(void) {
  cudaFuncAttributes a;
  for (const auto& row : kKernels)
    for (Kernel k : row) {
      const cudaError_t e = cudaFuncGetAttributes(&a, k);
      if (e != cudaSuccess) return (int)e;
    }
  return 0;
}

const char* lct_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
