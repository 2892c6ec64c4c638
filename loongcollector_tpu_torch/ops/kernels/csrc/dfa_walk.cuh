// The Tier-2 DFA byte walk, shared by K2/K3/K4 (dfa_scan.cu) and the fused
// stage program K7 (fused_program.cu).
//
// An automaton is a byte-indexed table t256[S][256] of u8 next states
// (S <= 128); a walk is one dependent table load a byte.  The table is read
// through `tab_at`: a plain pointer (shared memory, or any generic address)
// or an LdgTab, a table left in device memory and read through the
// read-only cache.  Row bytes come as 16-byte words (rows in device memory)
// or 32-bit words (rows staged in a shared tile).
//
// The settled exit: the host numbers the automaton's settled states (every
// state reachable from one has its accept value) from `fs` (first settled)
// up, so a walk whose state reaches `fs` has its result and stops.  The
// range walks check once a word (16 bytes, or 4 from a tile), off the
// dependent chain; fs = S never exits.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// A table in device memory, read through the read-only cache.
struct LdgTab {
  const uint8_t* p;
};

__device__ __forceinline__ uint32_t tab_at(const uint8_t* t, uint32_t i) {
  return t[i];
}

__device__ __forceinline__ uint32_t tab_at(LdgTab t, uint32_t i) {
  return __ldg(t.p + i);
}

// The low min(n, 4) bytes of `w`, lowest first.
template <class Tab>
__device__ __forceinline__ uint32_t walk_word(Tab tab, uint32_t s, uint32_t w,
                                              int n) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < n) s = tab_at(tab, (s << 8) | ((w >> (8 * k)) & 0xFFu));
  }
  return s;
}

// The first min(n, 16) bytes of `q`.
template <class Tab>
__device__ __forceinline__ uint32_t walk_vec(Tab tab, uint32_t s, uint4 q,
                                             int n) {
  s = walk_word(tab, s, q.x, n);
  s = walk_word(tab, s, q.y, n - 4);
  s = walk_word(tab, s, q.z, n - 8);
  return walk_word(tab, s, q.w, n - 12);
}

// Bytes [a, b) of `q` (0 <= a <= b <= 16).
template <class Tab>
__device__ __forceinline__ uint32_t walk_vec_range(Tab tab, uint32_t s,
                                                   uint4 q, int a, int b) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k >= a && k < b)
      s = tab_at(tab, (s << 8) | ((w[k >> 2] >> (8 * (k & 3))) & 0xFFu));
  }
  return s;
}

// Bytes [lo, hi) of a row in device memory, stopping at a settled state;
// `vec` when the row is 16-byte aligned and its width a multiple of 16, so
// every 16-byte word that holds a byte of the range lies inside the row.
template <class Tab>
__device__ __forceinline__ uint32_t walk_row_range(Tab tab, uint32_t s,
                                                   const uint8_t* row, int lo,
                                                   int hi, bool vec,
                                                   uint32_t fs) {
  if (lo >= hi) return s;
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
    const int w0 = lo >> 4, w1 = (hi - 1) >> 4;
    for (int w = w0; w <= w1 && s < fs; ++w) {
      const int a = w == w0 ? lo & 15 : 0;
      const int b = w == w1 ? hi - 16 * w : 16;
      const uint4 q = __ldg(v + w);
      s = (a == 0) ? walk_vec(tab, s, q, b) : walk_vec_range(tab, s, q, a, b);
    }
  } else {
    for (int p = lo; p < hi && s < fs; p += 16) {
      const int e = min(p + 16, hi);
      for (int i = p; i < e; ++i) s = tab_at(tab, (s << 8) | __ldg(row + i));
    }
  }
  return s;
}

// Bytes [lo, hi) of a row staged as 32-bit words (a shared tile row),
// stopping at a settled state.
template <class Tab>
__device__ __forceinline__ uint32_t walk_tile(Tab tab, uint32_t s,
                                              const uint32_t* w, int lo,
                                              int hi, uint32_t fs) {
  while (lo < hi && s < fs) {
    const int k = lo & 3, n = min(4 - k, hi - lo);
    s = walk_word(tab, s, w[lo >> 2] >> (8 * k), n);
    lo += n;
  }
  return s;
}

}  // namespace
