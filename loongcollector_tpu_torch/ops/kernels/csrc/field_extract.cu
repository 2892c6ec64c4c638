// Tier-1 field extraction on Hopper: one thread walks one row.
//
// Replaces the TPU kernel loongcollector_tpu/ops/kernels/field_extract_pallas.py:54
// (build_extract_fn_pallas, whose body is build_extract_core in
// field_extract.py).  That kernel is a branch-free interpreter: every cursor
// step is a masked min/max/sum reduction over the whole [bB, L] tile, because
// the TPU rules out gathers and scans.  Hopper has neither limit, so here the
// SegmentProgram runs as a scalar per-row walker with an explicit
// save/restore stack for Optional_ and Alt — each row byte is read about once
// instead of once per program op.
//
// Semantics are build_extract_core's, op for op (the plain PyTorch version in
// field_extract.py is held bit-exact against this kernel):
//   * forward Lit hits only at pos == cur with cur < L, needs cur + k <= len,
//     and moves cur to min(cur + k, L); FixedSpan likewise;
//   * forward Span stops at the first non-member (bytes at or past len are
//     non-members) and never moves cur backwards;
//   * reverse Span is clamped by max_len, by the pivot floor and to [0, cur];
//   * bytes at or past L read as zero (pack_rows zero-fills past len);
//   * a row stops at its first failure: `ok` never turns true again in the
//     reference walk, and a failed trial's state is discarded;
//   * failed rows write off 0 and len -1.
//
// Bound on this card (H100 SXM, 3.35 TB/s of HBM by the data sheet, at the
// 700 W power limit): the function needs only the row bytes below each
// row's length (the sum of the lengths, about 95 bytes an Apache line; the
// zero padding past a length, and padding rows, need not be read), plus B
// lengths and the program, and must write B*(8C+1) output bytes.  At the
// Apache main path's geometry B=8192 (about 5,500 real rows), L=128, C=9
// that is about 1.15 MB, about 0.34 us of memory time, so a launch is
// dominated by its fixed latency.  The per-row
// walk reads each byte about once (the TPU form re-reads the tile for every
// op) and keeps the program in shared memory, loaded once per block; rows
// are read straight from global memory through L1.  Staging the row tile in
// shared memory with a padded stride, or a warp per row, are later steps.
//
// Interface: plain C, loaded with ctypes.  The program arrives as one int32
// blob (layout in field_extract_cuda.py: a 32-word header, then the IR words,
// the class bitsets [K][8] u32, the literal offsets and lengths, and the
// literal bytes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCaps = 32;
constexpr int kMaxDepth = 8;      // Optional_/Alt nesting, checked at build
constexpr int kThreads = 128;

// header indices (field_extract_cuda.py _META)
enum : int {
  M_NCAPS = 0, M_PREFIX_OFF, M_PREFIX_N, M_HAS_P1, M_P1_CLS, M_P1_MIN,
  M_P1_MAX, M_P1_LAZY, M_SUFFIX_OFF, M_SUFFIX_N, M_HAS_P2, M_P2_CLS,
  M_P2_MIN, M_P2_MAX, M_MID_OFF, M_MID_N, M_MID_LIT, M_MID_FIXED,
  M_SPLIT_OFF, M_NSPLIT, M_MIDEND_OFF, M_NMIDEND, M_BITS_OFF, M_NCLASSES,
  M_LOFFS_OFF, M_LLENS_OFF, M_NLITS, M_BLOB_OFF, M_BLOB_LEN, M_DEPTH,
  M_TOTAL, M_HEADER
};
static_assert(M_HEADER <= 32, "header holds 32 words");

struct Prog {
  const int32_t* w;       // whole blob in shared memory
  const uint32_t* bits;   // [K][8] class bitsets
  const int32_t* loffs;
  const int32_t* llens;
  const uint8_t* lits;
};

struct Row {
  const uint8_t* p;
  int32_t L;
  int32_t len;
};

struct State {
  int32_t cur;
  int32_t off[kMaxCaps];
  int32_t len[kMaxCaps];
  int32_t start[kMaxCaps];
};

struct Frame {
  int32_t kind;       // 5 = Optional_, 6 = Alt
  int32_t end;        // word index after the whole construct
  int32_t body_end;   // word index after the body being tried
  int32_t left;       // Alt: branches after the current one
};

__device__ __forceinline__ uint8_t byte_at(const Row& r, int32_t q) {
  return q < r.L ? r.p[q] : 0;
}

__device__ __forceinline__ bool in_class(const Prog& g, int32_t cls,
                                         uint32_t b) {
  return (g.bits[cls * 8 + (b >> 5)] >> (b & 31)) & 1u;
}

// membership as the reference's mask: class & pos < len & 0 <= pos < L
__device__ __forceinline__ bool member_at(const Prog& g, const Row& r,
                                          int32_t cls, int32_t q) {
  return q >= 0 && q < r.L && q < r.len && in_class(g, cls, r.p[q]);
}

__device__ bool all_member(const Prog& g, const Row& r, int32_t cls,
                           int32_t lo, int32_t hi) {
  for (int32_t q = lo; q < hi; ++q)
    if (!member_at(g, r, cls, q)) return false;
  return true;
}

// the reference's lit_ok[lit][q] for q in [0, L): bytes from q on, zero past L
__device__ bool lit_at(const Prog& g, const Row& r, int32_t li, int32_t q) {
  if (q < 0 || q >= r.L) return false;
  const int32_t k = g.llens[li];
  const uint8_t* d = g.lits + g.loffs[li];
  for (int32_t i = 0; i < k; ++i)
    if (byte_at(r, q + i) != d[i]) return false;
  return true;
}

__device__ __forceinline__ void copy_state(State& d, const State& s,
                                           int32_t C) {
  d.cur = s.cur;
  for (int32_t k = 0; k < C; ++k) {
    d.off[k] = s.off[k];
    d.len[k] = s.len[k];
    d.start[k] = s.start[k];
  }
}

// Walks the ops in words [pc, end) over one row; returns the row's ok.
// REV walks right to left (the pivot suffix): cur is the exclusive end
// boundary, CapEnd records the right edge and CapStart closes the group.
template <bool REV>
__device__ bool walk(const Prog& g, const Row& r, int32_t pc, int32_t end,
                     int32_t floor_, State& st, int32_t C, State* saved) {
  Frame fr[kMaxDepth];
  int32_t depth = 0;
  int32_t limit = end;
  while (true) {
    if (pc >= limit) {
      if (depth == 0) return true;
      // the innermost body matched: keep its state (greedy Optional_,
      // leftmost Alt branch) and continue after the construct
      --depth;
      pc = fr[depth].end;
      limit = depth == 0 ? end : fr[depth - 1].body_end;
      continue;
    }
    const int32_t* w = g.w + pc;
    bool ok = true;
    switch (w[0]) {
      case 0: {  // Lit
        const int32_t li = w[1];
        const int32_t k = g.llens[li];
        if (!REV) {
          ok = st.cur + k <= r.len && lit_at(g, r, li, st.cur);
          st.cur = min(st.cur + k, r.L);
        } else {
          const int32_t s = st.cur - k;
          ok = s >= 0 && lit_at(g, r, li, s);
          st.cur = max(s, 0);
        }
        pc += 2;
        break;
      }
      case 1: {  // Span
        const int32_t cls = w[1], mn = w[2], mx = w[3];
        if (!REV) {
          const int32_t lim = min(r.L, r.len);
          int32_t e = st.cur;
          while (e < lim && in_class(g, cls, r.p[e])) ++e;
          const int32_t run = e - st.cur;
          ok = run >= mn && (mx < 0 || run <= mx);
          st.cur = e;
        } else {
          int32_t s = min(st.cur, r.L);
          while (s > 0 && member_at(g, r, cls, s - 1)) --s;
          if (mx >= 0) s = max(s, st.cur - mx);
          s = max(s, floor_);
          s = min(max(s, 0), st.cur);
          ok = st.cur - s >= mn;
          st.cur = s;
        }
        pc += 5;
        break;
      }
      case 2: {  // FixedSpan
        const int32_t cls = w[1], n = w[2];
        if (!REV) {
          ok = st.cur + n <= r.len && all_member(g, r, cls, st.cur, st.cur + n);
          st.cur = min(st.cur + n, r.L);
        } else {
          const int32_t s = st.cur - n;
          ok = s >= 0 && all_member(g, r, cls, s, st.cur);
          st.cur = max(s, 0);
        }
        pc += 3;
        break;
      }
      case 3: {  // CapStart
        const int32_t id = w[1];
        if (!REV) {
          st.start[id] = st.cur;
        } else {
          st.off[id] = st.cur;
          st.len[id] = st.start[id] - st.cur;
        }
        pc += 2;
        break;
      }
      case 4: {  // CapEnd
        const int32_t id = w[1];
        if (!REV) {
          st.off[id] = st.start[id];
          st.len[id] = st.cur - st.start[id];
        } else {
          st.start[id] = st.cur;
        }
        pc += 2;
        break;
      }
      case 5: {  // Optional_: try the body, restore the saved state on failure
        if (depth >= kMaxDepth) __trap();
        const int32_t body_end = pc + 2 + w[1];
        copy_state(saved[depth], st, C);
        fr[depth] = Frame{5, body_end, body_end, 0};
        ++depth;
        pc += 2;
        limit = body_end;
        break;
      }
      case 6: {  // Alt: first branch whose whole body matches
        const int32_t nb = w[1];
        if (nb == 0) {
          ok = false;
          pc += 2;
          break;
        }
        if (depth >= kMaxDepth) __trap();
        int32_t q = pc + 2;
        for (int32_t b = 0; b < nb; ++b) q += 1 + g.w[q];
        const int32_t first_end = pc + 3 + w[2];
        copy_state(saved[depth], st, C);
        fr[depth] = Frame{6, q, first_end, nb - 1};
        ++depth;
        pc += 3;
        limit = first_end;
        break;
      }
      default:
        __trap();   // the host validates every program before upload
    }
    if (ok) continue;
    // failure: unwind to the innermost construct that can absorb it
    while (true) {
      if (depth == 0) return false;
      Frame& f = fr[depth - 1];
      copy_state(st, saved[depth - 1], C);
      if (f.kind == 5) {           // failed optional body: skip the group
        --depth;
        pc = f.end;
        limit = depth == 0 ? end : fr[depth - 1].body_end;
        break;
      }
      if (f.left > 0) {            // next Alt branch from the saved state
        const int32_t q = f.body_end;
        f.body_end = q + 1 + g.w[q];
        --f.left;
        pc = q + 1;
        limit = f.body_end;
        break;
      }
      --depth;                     // no branch matched: the Alt fails
    }
  }
}

__global__ void __launch_bounds__(kThreads)
field_extract_kernel(const uint8_t* __restrict__ rows,
                     const int32_t* __restrict__ lens, int64_t B, int32_t L,
                     const int32_t* __restrict__ prog, int32_t prog_words,
                     uint8_t* __restrict__ ok_out,
                     int32_t* __restrict__ off_out,
                     int32_t* __restrict__ len_out) {
  extern __shared__ int32_t sprog[];
  for (int32_t i = threadIdx.x; i < prog_words; i += blockDim.x)
    sprog[i] = prog[i];
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;

  const int32_t* h = sprog;
  Prog g{sprog, reinterpret_cast<const uint32_t*>(sprog + h[M_BITS_OFF]),
         sprog + h[M_LOFFS_OFF], sprog + h[M_LLENS_OFF],
         reinterpret_cast<const uint8_t*>(sprog + h[M_BLOB_OFF])};
  const Row r{rows + row * L, L, lens[row]};
  const int32_t C = h[M_NCAPS];

  State st;
  st.cur = 0;
  for (int32_t k = 0; k < C; ++k) {
    st.off[k] = 0;
    st.len[k] = -1;
    st.start[k] = 0;
  }
  State saved[kMaxDepth];
  State rst;
  const State* fin = &st;

  bool ok = walk<false>(g, r, h[M_PREFIX_OFF], h[M_PREFIX_OFF] + h[M_PREFIX_N],
                        0, st, C, saved);
  if (ok && h[M_HAS_P2]) {
    // double pivot: prefix | pivot1 | mid literal | pivot2 | suffix
    const int32_t p1min = h[M_P1_MIN], p2min = h[M_P2_MIN];
    const int32_t mfix = h[M_MID_FIXED];
    copy_state(rst, st, C);
    rst.cur = r.len;
    ok = walk<true>(g, r, h[M_SUFFIX_OFF], h[M_SUFFIX_OFF] + h[M_SUFFIX_N],
                    st.cur + p1min + mfix + p2min, rst, C, saved);
    if (ok) {
      const int32_t lo1 = st.cur, hi2 = rst.cur;
      const int32_t a = max(lo1 + p1min, 0);
      const int32_t b = min(hi2 - mfix - p2min, L - 1);
      const int32_t mid_lit = h[M_MID_LIT];
      int32_t p = -1;
      if (h[M_P1_LAZY]) {          // both lazy: first occurrence
        for (int32_t q = a; q <= b; ++q)
          if (lit_at(g, r, mid_lit, q)) { p = q; break; }
      } else {                     // both greedy: last occurrence
        for (int32_t q = b; q >= a; --q)
          if (lit_at(g, r, mid_lit, q)) { p = q; break; }
      }
      ok = p >= 0;
      if (ok) {
        st.cur = p;
        ok = walk<false>(g, r, h[M_MID_OFF], h[M_MID_OFF] + h[M_MID_N], 0,
                         st, C, saved);
        const int32_t lo2 = st.cur;
        ok = ok && hi2 >= lo2 && p - lo1 >= p1min && hi2 - lo2 >= p2min &&
             all_member(g, r, h[M_P1_CLS], lo1, p) &&
             all_member(g, r, h[M_P2_CLS], lo2, hi2);
      }
      if (ok) {
        for (int32_t i = 0; i < h[M_NMIDEND]; ++i) {
          const int32_t k = h[h[M_MIDEND_OFF] + i];
          rst.off[k] = st.off[k];
          rst.len[k] = st.len[k];
        }
        for (int32_t i = 0; i < h[M_NSPLIT]; ++i) {
          const int32_t k = h[h[M_SPLIT_OFF] + i];
          rst.off[k] = st.start[k];
          rst.len[k] = rst.start[k] - st.start[k];
        }
        fin = &rst;
      }
    }
  } else if (ok && h[M_HAS_P1]) {
    // single pivot: forward prefix, reverse suffix, pivot class between
    copy_state(rst, st, C);
    rst.cur = r.len;
    ok = walk<true>(g, r, h[M_SUFFIX_OFF], h[M_SUFFIX_OFF] + h[M_SUFFIX_N],
                    st.cur + h[M_P1_MIN], rst, C, saved);
    if (ok) {
      const int32_t lo = st.cur, hi = rst.cur, run = hi - lo;
      const int32_t p1max = h[M_P1_MAX];
      ok = hi >= lo && run >= h[M_P1_MIN] && (p1max < 0 || run <= p1max) &&
           all_member(g, r, h[M_P1_CLS], lo, hi);
    }
    if (ok) {
      // split caps open where the forward walk put their CapStart and
      // close at the reverse walk's right edge
      for (int32_t i = 0; i < h[M_NSPLIT]; ++i) {
        const int32_t k = h[h[M_SPLIT_OFF] + i];
        rst.off[k] = st.start[k];
        rst.len[k] = rst.start[k] - st.start[k];
      }
      fin = &rst;
    }
  } else if (ok) {
    ok = st.cur == r.len;
  }

  ok_out[row] = ok ? 1 : 0;
  int32_t* co = off_out + row * C;
  int32_t* cl = len_out + row * C;
  for (int32_t k = 0; k < C; ++k) {
    co[k] = ok ? fin->off[k] : 0;
    cl[k] = ok ? fin->len[k] : -1;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) without synchronising;
// returns the launch's cudaError_t (0 = launched).
int lct_field_extract(const uint8_t* rows, const int32_t* lens, int64_t B,
                      int32_t L, const int32_t* prog, int32_t prog_words,
                      uint8_t* ok_out, int32_t* off_out, int32_t* len_out,
                      void* stream) {
  if (B <= 0) return 0;
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  const size_t smem = (size_t)prog_words * sizeof(int32_t);
  field_extract_kernel<<<(unsigned)blocks, kThreads, smem,
                         (cudaStream_t)stream>>>(
      rows, lens, B, L, prog, prog_words, ok_out, off_out, len_out);
  return (int)cudaGetLastError();
}

const char* lct_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
