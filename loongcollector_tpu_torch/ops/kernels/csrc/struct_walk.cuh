// The structural index's row walk (K5), shared by struct_index.cu (the
// standalone kernel) and the struct_index stage of fused_program.cu (K7).
//
// It computes _index_core of the JAX package (loongcollector_tpu/ops/kernels/
// struct_index.py:58) for one row: four bitmaps over the row's L positions,
//   in_string   the inclusive prefix-XOR of the real quotes (an opening quote
//               is inside its string, the closing one outside);
//   structural  JSON mode: one of { } [ ] : , outside strings; delimiter
//               mode: the separator byte outside strings;
//   escaped     JSON mode: a byte that is not a backslash and follows a run
//               of backslashes of odd length (a run at the row's start counts
//               from position 0); delimiter mode: none;
//   quote       a '"' that is not escaped;
// each cut at the row's length (a length of -1 or 0 gives all-zero masks),
// packed 16 bits a word, little-endian, each word a zero-extended int32.
//
// One warp walks one row, 32 bytes a step: each lane holds one byte, and
// __ballot_sync turns the per-byte tests into 32-bit masks.  A lane's escape
// comes from the nearest non-backslash below it in the step (__clz on the
// masked complement); with none, the run continues the previous step's
// trailing run, of which only the parity is carried.  The in-string mask is
// a prefix-XOR inside the step, flipped by the carried parity, which then
// takes the parity of the step's real quotes.  The walk stops at the row's
// length: a row of n bytes takes ceil(n / 32) steps, and reads no byte at or
// past n.  Lane w % 32 keeps word w of each mask (a step makes two words);
// every 32 words (16 steps, 512 bytes) the warp stores them, one coalesced
// row of words a mask, and the words past the length go out as zeros in the
// same stores.  Everything here is force-inlined.

#pragma once

#include <cstdint>

namespace {

constexpr int kStructJson = 0;    // struct_index_cuda.MODES
constexpr int kStructDelim = 1;

// The carry from one 32-byte step to the next.
struct StructCarry {
  uint32_t bs_odd;   // the backslash run ending the last step has odd length
  uint32_t in_str;   // the in-string parity after the last step
};

__device__ __forceinline__ bool json_structural(uint32_t b) {
  return b == '{' || b == '}' || b == '[' || b == ']' || b == ':' ||
         b == ',';
}

// One step, called by all 32 lanes of a warp with the same carry: lane
// `lane` holds byte `b` of the step, and `valid` when it lies below the
// row's length.  Returns the four masks (in_string, structural, escaped,
// quote; bit l = the step's byte l), the same in every lane.
template <int MODE>
__device__ __forceinline__ void struct_step(uint32_t b, bool valid,
                                            uint32_t sep, int lane,
                                            StructCarry& c, uint32_t m[4]) {
  constexpr unsigned kAll = 0xffffffffu;
  const uint32_t vmask = __ballot_sync(kAll, valid);
  const uint32_t quote = __ballot_sync(kAll, valid && b == '"');
  uint32_t esc = 0, st;
  if (MODE == kStructJson) {
    const uint32_t bs = __ballot_sync(kAll, valid && b == '\\');
    // the run of backslashes ending at lane - 1
    const uint32_t below = ~bs & ((1u << lane) - 1u);
    const uint32_t odd = below
        ? static_cast<uint32_t>(lane - 1 - (31 - __clz(below))) & 1u
        : (static_cast<uint32_t>(lane) + c.bs_odd) & 1u;
    esc = __ballot_sync(kAll, valid && b != '\\' && odd);
    // a step of 32 backslashes keeps the parity; else the trailing run's
    if (bs != kAll) c.bs_odd = static_cast<uint32_t>(__clz(~bs)) & 1u;
    st = __ballot_sync(kAll, valid && json_structural(b));
  } else {
    st = __ballot_sync(kAll, valid && b == sep);
  }
  const uint32_t q = quote & ~esc;
  uint32_t x = q;
  x ^= x << 1;
  x ^= x << 2;
  x ^= x << 4;
  x ^= x << 8;
  x ^= x << 16;
  if (c.in_str) x = ~x;
  c.in_str ^= static_cast<uint32_t>(__popc(q)) & 1u;
  const uint32_t ins = x & vmask;
  m[0] = ins;
  m[1] = st & ~ins;
  m[2] = esc;
  m[3] = q;
}

// One row as one warp: `fetch(p)` gives the row's byte p for p < n (called
// only there), `n` is the row's length cut to [0, L].  Mask k's word w goes
// to out[k * plane + w], for the row's W = ceil(L / 16) words.  Every lane
// of the warp calls it with the same n.
template <int MODE, class Fetch>
__device__ __forceinline__ void struct_row(Fetch fetch, int32_t L, int32_t n,
                                           uint32_t sep, int lane,
                                           int32_t* __restrict__ out,
                                           int64_t plane) {
  const int32_t W = (L + 15) >> 4;
  const int32_t steps = (n + 31) >> 5;     // the walk stops at the length
  StructCarry c{0u, 0u};
  // the high half (odd lane) or low half of a step's masks
  const uint32_t shift = 16u * static_cast<uint32_t>(lane & 1);
  for (int32_t w0 = 0; w0 < W; w0 += 32) {
    // the masks of the step that makes this lane's word w0 + lane of each
    // mask: zero unless the walk reaches that step
    uint32_t kw[4] = {0u, 0u, 0u, 0u};
    const int32_t s1 = min(steps, (w0 + 32) >> 1);
    for (int32_t s = w0 >> 1; s < s1; ++s) {
      const int32_t p = 32 * s + lane;
      const uint32_t b = p < n ? static_cast<uint32_t>(fetch(p)) : 0u;
      uint32_t m[4];
      struct_step<MODE>(b, p < n, sep, lane, c, m);
      // step s makes words 2s (low halves) and 2s + 1 (high halves)
      if ((lane >> 1) == (s & 15)) {
#pragma unroll
        for (int k = 0; k < 4; ++k) kw[k] = m[k];
      }
    }
    const int32_t w = w0 + lane;
    if (w < W) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out[k * plane + w] =
            static_cast<int32_t>((kw[k] >> shift) & 0xffffu);
    }
  }
}

}  // namespace
