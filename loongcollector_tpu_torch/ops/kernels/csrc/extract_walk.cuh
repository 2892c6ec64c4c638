// The Tier-1 segment-program walker, shared by K1 (field_extract.cu) and the
// fused stage program K7 (fused_program.cu).
//
// One thread walks one row of a shared-memory tile; its capture state lives
// in shared memory.  The walker is a template on nesting (depth 0, or
// Optional_/Alt nesting with a save stack in local memory) and on the pivots
// (none, single, double), picked on the host from the program header; a
// row's match, pivots included, is extract_row.  The program is one int32
// blob (layout in field_extract_cuda.py).  stage_warp_rows and
// write_warp_caps are K7's row staging and capture write-back; K1 keeps
// the same loops inline (see field_extract.cu).  Everything here is
// force-inlined into the kernels, so a kernel's registers, stack and spills
// are its own.

#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {


constexpr int kMaxCaps = 32;
constexpr int kMaxDepth = 8;       // Optional_/Alt nesting, checked at build
constexpr int kMaxThreads = 128;   // launch_geometry's largest block
// ptxas sizes registers for this many blocks of kMaxThreads on an SM (up to
// 128 registers a thread).  With the thread bound alone it squeezes the
// depth-0 walks into 32 registers and spills; shared memory caps the blocks
// an SM holds below this anyway.
constexpr int kMinBlocks = 4;
constexpr int kBatch = 8;          // global loads a thread keeps in flight
constexpr int kSmemBudget = 232448;  // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;

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

// One row of the shared tile: 4-byte aligned, its bytes below min(L, len)
// copied in.
struct Row {
  const uint32_t* w;
  int32_t L;
  int32_t len;
};

// This thread's capture state in shared memory: off[C], len[C], start[C].
// Threads' states lie (3C | 1) words apart, an odd stride, so a warp's
// accesses to one capture fall in 32 banks.
struct Caps {
  int32_t* p;
  int32_t C;
  __device__ __forceinline__ int32_t& off(int32_t k) const { return p[k]; }
  __device__ __forceinline__ int32_t& len(int32_t k) const {
    return p[C + k];
  }
  __device__ __forceinline__ int32_t& start(int32_t k) const {
    return p[2 * C + k];
  }
};

struct Frame {
  int32_t kind;       // 5 = Optional_, 6 = Alt
  int32_t end;        // word index after the whole construct
  int32_t body_end;   // word index after the body being tried
  int32_t left;       // Alt: branches after the current one
};

// The Optional_/Alt save stack: only the nested instantiations have one,
// in local memory.
template <bool NESTED>
struct SaveStack {};

template <>
struct SaveStack<true> {
  Frame fr[kMaxDepth];
  int32_t cur[kMaxDepth];
  int32_t caps[kMaxDepth][3 * kMaxCaps];

  __device__ __forceinline__ void save(int32_t d, int32_t c, const Caps& s) {
    cur[d] = c;
    for (int32_t i = 0; i < 3 * s.C; ++i) caps[d][i] = s.p[i];
  }
  __device__ __forceinline__ int32_t restore(int32_t d, const Caps& s) const {
    for (int32_t i = 0; i < 3 * s.C; ++i) s.p[i] = caps[d][i];
    return cur[d];
  }
};

__device__ __forceinline__ uint32_t dynamic_smem_bytes() {
  uint32_t n;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));
  return n;
}

// Bit j set when byte j of `word` is in the class with bitset `cb`: four
// independent loads, so their latencies overlap.
__device__ __forceinline__ uint32_t members4(const uint32_t* cb,
                                             uint32_t word) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t b = (word >> (8 * j)) & 255u;
    m |= ((cb[b >> 5] >> (b & 31)) & 1u) << j;
  }
  return m;
}

// The same for the eight bytes of two consecutive words.
__device__ __forceinline__ uint32_t members8(const uint32_t* cb, uint32_t lo,
                                             uint32_t hi) {
  return members4(cb, lo) | (members4(cb, hi) << 4);
}

// The first q in [lo, hi) whose byte is not in the class, or hi; needs
// 0 <= lo < hi <= min(L, len).  Eight bytes a step.
__device__ __forceinline__ int32_t run_end(const uint32_t* cb, const Row& r,
                                           int32_t lo, int32_t hi) {
  int32_t q = lo & ~3;
  uint32_t live = (0xFFu << (lo & 3)) & 0xFFu;
  while (true) {
    // the second word is within the row's stride: q < L
    const uint32_t a = r.w[q >> 2], b = r.w[(q >> 2) + 1];
    if (hi - q < 8) live &= (1u << (hi - q)) - 1;
    const uint32_t miss = live & ~members8(cb, a, b);
    if (miss) return q + __ffs(miss) - 1;
    q += 8;
    if (q >= hi) return hi;
    live = 0xFFu;
  }
}

// The least s <= hi with every byte of [s, hi) in the class; needs
// 0 < hi <= min(L, len).  Eight bytes a step, from the word holding hi - 1
// and the one below it.
__device__ __forceinline__ int32_t run_start(const uint32_t* cb, const Row& r,
                                             int32_t hi) {
  int32_t q = ((hi - 1) & ~3) - 4;         // first byte of the lower word
  uint32_t live = (1u << (hi - q)) - 1;    // hi - q is 5..8
  while (true) {
    const uint32_t a = q >= 0 ? r.w[q >> 2] : 0u, b = r.w[(q >> 2) + 1];
    if (q < 0) live &= 0xF0u;
    const uint32_t miss = live & ~members8(cb, a, b);
    if (miss) return q + 32 - __clz(miss);
    if (q <= 0) return 0;
    q -= 8;
    live = 0xFFu;
  }
}

// every q in [lo, hi) a member as the reference's mask has it: class, and
// 0 <= q < min(L, len)
__device__ __forceinline__ bool all_member(const Prog& g, const Row& r,
                                           int32_t cls, int32_t lo,
                                           int32_t hi) {
  if (lo >= hi) return true;
  if (lo < 0 || hi > min(r.L, r.len)) return false;
  return run_end(g.bits + cls * 8, r, lo, hi) == hi;
}

// Four bytes from byte offset `off` of a 4-byte aligned array.
__device__ __forceinline__ uint32_t bytes4(const uint32_t* w, int32_t off) {
  const int32_t i = off >> 2;
  return __funnelshift_r(w[i], w[i + 1], (off & 3) * 8);
}

// the reference's lit_ok[lit][q] for q in [0, L): bytes at or past L read
// zero.  Every caller has q + k <= len, so no byte at or past the length
// is compared; four bytes are compared at a time.
__device__ __forceinline__ bool lit_at(const Prog& g, const Row& r,
                                       int32_t li, int32_t q) {
  if (q < 0 || q >= r.L) return false;
  const int32_t k = g.llens[li], o = g.loffs[li];
  const uint32_t* lw = reinterpret_cast<const uint32_t*>(g.lits);
  if (k <= 4 && q + k <= r.L) {      // the usual case: one compare
    const uint32_t keep = k < 4 ? (1u << (8 * k)) - 1 : ~0u;
    return ((bytes4(r.w, q) ^ bytes4(lw, o)) & keep) == 0;
  }
  for (int32_t i = 0; i < k; i += 4) {
    const int32_t n = min(k - i, 4), past = r.L - (q + i);
    if (past <= 0) {     // the rest of the literal faces zeros
      for (int32_t j = i; j < k; ++j)
        if (g.lits[o + j]) return false;
      return true;
    }
    const uint32_t row = bytes4(r.w, q + i);
    const uint32_t keep = (n < 4 ? (1u << (8 * n)) - 1 : ~0u) &
                          (past < 4 ? (1u << (8 * past)) - 1 : ~0u);
    const uint32_t lit = bytes4(lw, o + i) &
                         (n < 4 ? (1u << (8 * n)) - 1 : ~0u);
    if ((row & keep) != lit) return false;
  }
  return true;
}

// Walks the ops in words [pc, end) over one row; returns the row's ok.
// REV walks right to left (the pivot suffix): cur is the exclusive end
// boundary, CapEnd records the right edge and CapStart closes the group.
// An op's four words are loaded together, and capture markers, which only
// record the cursor, are taken in a loop of their own.
template <bool REV, bool NESTED>
__device__ __forceinline__ bool walk(const Prog& g, const Row& r, int32_t pc,
                                     const int32_t end, const int32_t floor_,
                                     int32_t& cur, const Caps& cs) {
  SaveStack<NESTED> ss;
  int32_t depth = 0;
  int32_t limit = end;
  while (true) {
    if (pc >= limit) {
      if constexpr (NESTED) {
        if (depth > 0) {
          // the innermost body matched: keep its state (greedy Optional_,
          // leftmost Alt branch) and continue after the construct
          --depth;
          pc = ss.fr[depth].end;
          limit = depth == 0 ? end : ss.fr[depth - 1].body_end;
          continue;
        }
      }
      return true;
    }
    int32_t w0 = g.w[pc], w1 = g.w[pc + 1];
    while ((w0 == 3 || w0 == 4) && pc < limit) {   // CapStart, CapEnd
      if ((w0 == 3) != REV) {   // a group opens (forward CapStart)
        cs.start(w1) = cur;
      } else if (!REV) {        // forward CapEnd closes it
        cs.off(w1) = cs.start(w1);
        cs.len(w1) = cur - cs.start(w1);
      } else {                  // reverse CapStart closes it
        cs.off(w1) = cur;
        cs.len(w1) = cs.start(w1) - cur;
      }
      pc += 2;
      w0 = g.w[pc];
      w1 = g.w[pc + 1];
    }
    if (pc >= limit) continue;
    const int32_t w2 = g.w[pc + 2], w3 = g.w[pc + 3];
    // op sizes in words, a nibble per op code: Lit 2, Span 5, FixedSpan 3,
    // CapStart 2, CapEnd 2, Optional_ 2 (then its body), Alt 3 (then its
    // first branch)
    const int32_t next = pc + ((0x3222352 >> (4 * (w0 & 7))) & 15);
    bool ok = true;
    if (w0 == 1) {              // Span
      const uint32_t* cb = g.bits + w1 * 8;
      if (!REV) {
        // up to the first non-member below min(L, len)
        const int32_t lim = min(r.L, r.len);
        const int32_t e = cur < lim ? run_end(cb, r, cur, lim) : cur;
        const int32_t run = e - cur;
        ok = run >= w2 && (w3 < 0 || run <= w3);
        cur = e;
      } else {
        // down to the last non-member; bytes at or past len are not
        // members, so a cursor past len does not move
        int32_t s = min(cur, r.L);
        if (s > 0 && s <= r.len) s = run_start(cb, r, s);
        if (w3 >= 0) s = max(s, cur - w3);
        s = max(s, floor_);
        s = min(max(s, 0), cur);
        ok = cur - s >= w2;
        cur = s;
      }
      pc = next;
    } else if (w0 == 0) {       // Lit
      const int32_t k = g.llens[w1];
      if (!REV) {
        ok = cur + k <= r.len && lit_at(g, r, w1, cur);
        cur = min(cur + k, r.L);
      } else {
        const int32_t s = cur - k;
        ok = s >= 0 && lit_at(g, r, w1, s);
        cur = max(s, 0);
      }
      pc = next;
    } else if (w0 == 2) {       // FixedSpan
      if (!REV) {
        ok = cur + w2 <= r.len && all_member(g, r, w1, cur, cur + w2);
        cur = min(cur + w2, r.L);
      } else {
        const int32_t s = cur - w2;
        ok = s >= 0 && all_member(g, r, w1, s, cur);
        cur = max(s, 0);
      }
      pc = next;
    } else if (w0 == 6 && w1 == 0) {   // Alt without branches
      ok = false;
      pc += 2;
    } else if constexpr (NESTED) {
      if (depth >= kMaxDepth) __trap();
      ss.save(depth, cur, cs);
      if (w0 == 5) {            // Optional_: try the body
        const int32_t body_end = pc + 2 + w1;
        ss.fr[depth] = Frame{5, body_end, body_end, 0};
        limit = body_end;
      } else if (w0 == 6) {     // Alt: first branch whose body matches
        int32_t q = pc + 2;
        for (int32_t b = 0; b < w1; ++b) q += 1 + g.w[q];
        ss.fr[depth] = Frame{6, q, pc + 3 + w2, w1 - 1};
        limit = pc + 3 + w2;
      } else {
        __trap();   // the host validates every program before upload
      }
      ++depth;
      pc = next;
    } else {
      __trap();     // a depth-0 program has no Optional_ or Alt
    }
    if (ok) continue;
    if constexpr (!NESTED) {
      return false;
    } else {
      // failure: unwind to the innermost construct that can absorb it,
      // restoring the state saved when it was entered
      while (true) {
        if (depth == 0) return false;
        Frame& f = ss.fr[depth - 1];
        cur = ss.restore(depth - 1, cs);
        if (f.kind == 5) {           // failed optional body: skip the group
          --depth;
          pc = f.end;
          limit = depth == 0 ? end : ss.fr[depth - 1].body_end;
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
}

// The program's view of its blob: the header is word 0.
__device__ __forceinline__ Prog make_prog(const int32_t* h) {
  return Prog{h, reinterpret_cast<const uint32_t*>(h + h[M_BITS_OFF]),
              h + h[M_LOFFS_OFF], h + h[M_LLENS_OFF],
              reinterpret_cast<const uint8_t*>(h + h[M_BLOB_OFF])};
}

// A warp copies its `wrows` rows (from global row row0 + wrow) into its part
// of the tile, up to each length rounded up to 16 bytes: 16-byte loads,
// neighbouring lanes on neighbouring chunks, when L and the rows allow it,
// else byte copies up to each length.  `len` is this lane's row length.
__device__ __forceinline__ void stage_warp_rows(
    const uint8_t* __restrict__ rows, int64_t row0, int32_t wrow,
    int32_t wrows, int32_t lane, int32_t L, int32_t len, uint32_t* tile,
    int32_t ws) {
  const uint8_t* wsrc = rows + (row0 + wrow) * L;
  uint32_t* wtile = tile + wrow * ws;
  if ((L & 15) == 0 && (reinterpret_cast<uintptr_t>(rows) & 15) == 0) {
    const int32_t cpr = L >> 4;            // 16-byte chunks per row
    const int32_t n = wrows * cpr;
    for (int32_t base = 0; base < n; base += kBatch * 32) {
      uint4 v[kBatch];
      int32_t dst[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int32_t i = base + j * 32 + lane, r = min(i / cpr, 31);
        const int32_t c = i - r * cpr;
        const int32_t rlen = __shfl_sync(0xffffffffu, len, r);
        dst[j] = -1;
        if (i < n && c * 16 < rlen) {
          v[j] = __ldg(reinterpret_cast<const uint4*>(wsrc) + i);
          dst[j] = r * ws + c * 4;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (dst[j] < 0) continue;
        uint32_t* d = wtile + dst[j];
        d[0] = v[j].x;
        d[1] = v[j].y;
        d[2] = v[j].z;
        d[3] = v[j].w;
      }
    }
  } else {                                 // unaligned rows: byte copies
    uint8_t* tb = reinterpret_cast<uint8_t*>(wtile);
    for (int32_t base = 0; base < wrows * L; base += 32) {
      const int32_t i = base + lane, r = min(i / L, 31), c = i - r * L;
      const int32_t rlen = __shfl_sync(0xffffffffu, len, r);
      if (i < wrows * L && c < rlen) tb[r * ws * 4 + c] = wsrc[i];
    }
  }
}

// One row's match of the program whose header is `h`: returns ok.  The
// captures end in `cs` (no pivot) or `rs` (pivot programs: the reverse
// walk's copy, which starts from the forward state).  Failed rows leave
// whatever state the walk reached; write_warp_caps writes them as off 0,
// len -1.
template <bool NESTED, int PIVOT>
__device__ __forceinline__ bool extract_row(const int32_t* h, const Row& r,
                                            const Caps& cs, const Caps& rs) {
  const int32_t C = h[M_NCAPS];
  for (int32_t k = 0; k < C; ++k) {
    cs.off(k) = 0;
    cs.len(k) = -1;
    cs.start(k) = 0;
  }
  const Prog g = make_prog(h);
  int32_t cur = 0;
  bool ok = walk<false, NESTED>(g, r, h[M_PREFIX_OFF],
                                h[M_PREFIX_OFF] + h[M_PREFIX_N], 0, cur, cs);
  if constexpr (PIVOT == 0) {
    ok = ok && cur == r.len;
  } else if (ok) {
    // the reverse walk starts from the forward state with cur = len
    for (int32_t i = 0; i < 3 * C; ++i) rs.p[i] = cs.p[i];
    int32_t rcur = r.len;
    if constexpr (PIVOT == 2) {
      // double pivot: prefix | pivot1 | mid literal | pivot2 | suffix
      const int32_t p1min = h[M_P1_MIN], p2min = h[M_P2_MIN];
      const int32_t mfix = h[M_MID_FIXED];
      ok = walk<true, NESTED>(g, r, h[M_SUFFIX_OFF],
                              h[M_SUFFIX_OFF] + h[M_SUFFIX_N],
                              cur + p1min + mfix + p2min, rcur, rs);
      if (ok) {
        const int32_t lo1 = cur, hi2 = rcur;
        const int32_t a = max(lo1 + p1min, 0);
        const int32_t b = min(hi2 - mfix - p2min, r.L - 1);
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
          cur = p;
          ok = walk<false, NESTED>(g, r, h[M_MID_OFF],
                                   h[M_MID_OFF] + h[M_MID_N], 0, cur, cs);
          const int32_t lo2 = cur;
          ok = ok && hi2 >= lo2 && p - lo1 >= p1min && hi2 - lo2 >= p2min &&
               all_member(g, r, h[M_P1_CLS], lo1, p) &&
               all_member(g, r, h[M_P2_CLS], lo2, hi2);
        }
        if (ok) {
          for (int32_t i = 0; i < h[M_NMIDEND]; ++i) {
            const int32_t k = h[h[M_MIDEND_OFF] + i];
            rs.off(k) = cs.off(k);
            rs.len(k) = cs.len(k);
          }
        }
      }
    } else {
      // single pivot: forward prefix, reverse suffix, pivot class between
      ok = walk<true, NESTED>(g, r, h[M_SUFFIX_OFF],
                              h[M_SUFFIX_OFF] + h[M_SUFFIX_N],
                              cur + h[M_P1_MIN], rcur, rs);
      if (ok) {
        const int32_t lo = cur, hi = rcur, run = hi - lo;
        const int32_t p1max = h[M_P1_MAX];
        ok = hi >= lo && run >= h[M_P1_MIN] &&
             (p1max < 0 || run <= p1max) &&
             all_member(g, r, h[M_P1_CLS], lo, hi);
      }
    }
    if (ok) {
      // split caps open where the forward walk put their CapStart and
      // close at the reverse walk's right edge
      for (int32_t i = 0; i < h[M_NSPLIT]; ++i) {
        const int32_t k = h[h[M_SPLIT_OFF] + i];
        rs.off(k) = cs.start(k);
        rs.len(k) = rs.start(k) - cs.start(k);
      }
    }
  }
  return ok;
}

// The warp writes back its rows' captures from the shared state: `fin` is
// the warp's first row's final state (rows cw words apart), `co`/`cl` the
// warp's first row in the [B, C] outputs.  Failed rows write off 0 and
// len -1.  Every lane of the warp takes part.
__device__ __forceinline__ void write_warp_caps(const int32_t* fin,
                                                int32_t cw, int32_t C,
                                                bool ok, int32_t lane,
                                                int32_t wrows,
                                                int32_t* __restrict__ co,
                                                int32_t* __restrict__ cl) {
  // e / C as a multiply: exact for e < 2^20 (here e < 32 * 32)
  const uint64_t inv = ((1ull << 32) + C - 1) / C;
#pragma unroll 4
  for (int32_t base = 0; base < wrows * C; base += 32) {
    const int32_t e = base + lane;
    const int32_t i = (int32_t)(((uint64_t)e * inv) >> 32), k = e - i * C;
    const bool rok = __shfl_sync(0xffffffffu, ok, min(i, 31));
    if (e < wrows * C) {
      co[e] = rok ? fin[i * cw + k] : 0;
      cl[e] = rok ? fin[i * cw + C + k] : -1;
    }
  }
}

}  // namespace
