// Tier-1 field extraction on Hopper: each warp stages its 32 rows in shared
// memory, then each thread walks one row.
//
// Replaces the TPU kernel loongcollector_tpu/ops/kernels/field_extract_pallas.py:54
// (build_extract_fn_pallas, pl.pallas_call at :84; body build_extract_core).
// That kernel reduces the whole [bB, L] tile once per program op, because the
// TPU rules out gathers and scans; here the SegmentProgram runs as a scalar
// walker per row, and each row byte is read about once.
//
// Bound on this card (H100 SXM, 3.35 TB/s HBM, 700 W): bytes, counted as
// chip_smoke.py:bound_ms counts them: the row bytes below each length, B
// lengths, the program, and B*(8C+1) output bytes.  At the Apache main path
// (B=8192, ~5,500 real rows, L=128, C=9) that is ~1.15 MB, 0.34 us: less than
// one launch's fixed cost.  The walk is a chain of dependent shared-memory
// loads per row, so a row's latency, not bandwidth, sets the time.
//
// Against the four limits of the first version (one thread per row reading
// global memory a byte at a time, walk state in local memory, 128-row blocks):
//  1. Row bytes: a warp copies its 32 consecutive rows to shared memory with
//     16-byte loads, neighbouring lanes on neighbouring chunks, up to each
//     length rounded up to 16 bytes (the walk reads no byte at or past a
//     length, so padding rows copy nothing).  The tile's row stride is L + 4
//     bytes, so one column of a warp's rows lies in 32 banks.  Spans test
//     eight bytes a step from two 32-bit words; literals compare four at once.
//  2. Walk state: the capture state (off/len/start, and the reverse walk's
//     copy for pivot programs) lives in shared memory, 3C | 1 words a row (an
//     odd stride: a capture's slot of 32 rows falls in 32 banks).  The walker
//     is a template on nesting (depth 0 or more) and on the pivots (none,
//     single, double), picked on the host from the program header.  Depth-0
//     instantiations hold no save stack and no frames: no stack frame, no
//     spills (chip_smoke.py phase 1 checks).  Nested ones keep a save stack in
//     local memory.
//  3. Occupancy: threads per block (32..128) and shared memory come from
//     field_extract_cuda.launch_geometry, which shrinks the block as L grows
//     and until B gives all 132 SMs a block.  One barrier per block; a warp
//     writes its rows' outputs back from shared memory, coalesced.
//  4. Class test: a shared-memory bitset load per byte, the loads of a step
//     independent.  A byte-to-class table measured no better (PERF.md).
// Plain C interface, loaded with ctypes, one entry point per instantiation;
// the program is one int32 blob (layout in field_extract_cuda.py).  The
// walker and the pivot logic (extract_row) are in extract_walk.cuh, which
// the fused stage program (fused_program.cu) shares.  The staging and the
// write-back below stay inline: taking the header's copies instead moved
// this kernel's registers (PERF.md, PR 5).
//
// K8, the sharded parse step (lct_sharded_extract_*), is this kernel with
// STATS on.  It replaces the TPU program loongcollector_tpu/parallel/mesh.py:73
// (ShardedParsePlane: K1's XLA body under shard_map, then three psum'd
// counts, :90-98).  One launch covers every shard a device holds: the
// launch's B rows are shards of shard_rows consecutive rows each.  The walk
// is K1's; an epilogue gives each shard its three counts: matched = sum(ok)
// over every row of the shard, padding rows included (a pattern that
// matches the empty string makes them ok, and the reference counts them),
// events = the rows with len > 0, bytes = sum(len).  No count is zeroed
// first and none is added to with an atomic: the rows split into pieces,
// where a warp's 32 rows meet a shard (a warp straddles a shard boundary
// when shard_rows is not a multiple of 32), and each piece's counts are
// written once, by the last lane of a segmented shuffle sum over the
// warp's lanes, at the piece's index (ordered by first row: the warp and
// shard starts below it, field_extract_cuda.stat_pieces).  The host folds
// the pieces per shard when it folds the counts (parallel/mesh.py), the
// psum's counterpart.  The counts are 64-bit; the reference's are int32 (x64
// off), equal while sum(len) < 2^31, which holds for B <= 65,536 rows of
// L <= 4,096 bytes (2^28).  Bound: K1's bytes plus 24 bytes a shard.  With
// STATS off the epilogue compiles away, and the six K1 entry points are what
// they were.

#include "extract_walk.cuh"

namespace {

// Shared memory, in 32-bit words (field_extract_cuda.smem_bytes):
//   [program][tile T * (ceil(L/4) + 1)][caps T * (3C | 1)]
//   [reverse caps T * (3C | 1), pivot programs only]
// A warp stages, walks and writes back its own 32 rows, so the block
// synchronises once, after the program and the tile are in.
template <bool NESTED, int PIVOT, bool STATS>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
field_extract_kernel(const uint8_t* __restrict__ rows,
                     const int32_t* __restrict__ lens, int64_t B, int32_t L,
                     const int32_t* __restrict__ prog, int32_t prog_words,
                     uint8_t* __restrict__ ok_out,
                     int32_t* __restrict__ off_out,
                     int32_t* __restrict__ len_out,
                     long long* __restrict__ pieces, uint32_t shard_rows,
                     uint32_t lcm_rows) {
  extern __shared__ int32_t smem[];
  const int32_t T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int64_t row0 = (int64_t)blockIdx.x * T;
  const int32_t nrows = B - row0 < T ? (int32_t)(B - row0) : T;
  const int32_t wrow = tid - lane;         // this warp's first row
  const int32_t wrows = max(0, min(32, nrows - wrow));
  const int32_t ws = (L + 3) / 4 + 1;      // tile row stride in words

  int32_t* const sprog = smem;
  uint32_t* const tile = reinterpret_cast<uint32_t*>(sprog + prog_words);
  int32_t* const scaps = reinterpret_cast<int32_t*>(tile + T * ws);

  // every global load a thread makes before the one barrier: its row's
  // length, the program in batches of kBatch words, then its warp's rows
  // in 16-byte chunks up to each length rounded up to 16 bytes
  const int32_t len = tid < nrows ? __ldg(lens + row0 + tid) : 0;
  for (int32_t i0 = tid; i0 < prog_words; i0 += kBatch * T) {
    int32_t v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (i0 + j * T < prog_words) v[j] = __ldg(prog + i0 + j * T);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (i0 + j * T < prog_words) sprog[i0 + j * T] = v[j];
  }
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
  __syncthreads();

  const int32_t* h = sprog;
  const int32_t C = h[M_NCAPS];
  const int32_t pivot = h[M_HAS_P2] ? 2 : h[M_HAS_P1];
  const int32_t cw = (3 * C) | 1;          // capture state stride in words
  const uint32_t need = 4u * (prog_words + T * ws + (PIVOT ? 2 : 1) * T * cw);
  // the host picks the instantiation and the size from the same header
  if (pivot != PIVOT || (!NESTED && h[M_DEPTH] > 0) ||
      need > dynamic_smem_bytes())
    __trap();

  const Caps cs{scaps + tid * cw, C};
  const Caps rs{scaps + (T + tid) * cw, C};
  bool ok = false;
  if (tid < nrows) {
    const Row r{tile + tid * ws, L, len};
    ok = extract_row<NESTED, PIVOT>(h, r, cs, rs);
  }
  __syncwarp();

  // the warp writes back its rows from the shared state: pivot programs end
  // in the reverse walk's caps; failed rows write off 0 and len -1
  const int32_t* fin = scaps + ((PIVOT ? T : 0) + wrow) * cw;
  if (lane < wrows) ok_out[row0 + tid] = ok;
  int32_t* co = off_out + (row0 + wrow) * C;
  int32_t* cl = len_out + (row0 + wrow) * C;
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

  if constexpr (STATS) {
    // the warp's rows by shard: each lane sums the lanes from its shard's
    // first row in the warp (seg) up to its own; lanes past nrows hold
    // ok = false and len = 0 and write nothing (B < 2^31: the launcher
    // checks)
    const uint32_t wfirst = static_cast<uint32_t>(row0 + wrow);
    const uint32_t row = wfirst + lane;
    const uint32_t sh = row / shard_rows;
    const int32_t seg = static_cast<int32_t>(
        sh * shard_rows > wfirst ? sh * shard_rows - wfirst : 0);
    uint32_t m = ok, ev = len > 0;
    int32_t by = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t m2 = __shfl_up_sync(0xffffffffu, m, d);
      const uint32_t e2 = __shfl_up_sync(0xffffffffu, ev, d);
      const int32_t b2 = __shfl_up_sync(0xffffffffu, by, d);
      if (lane - d >= seg) {
        m += m2;
        ev += e2;
        by += b2;
      }
    }
    // the last lane of a piece writes it
    if (lane < wrows && (lane == 31 || lane + 1 == wrows
                         || (row + 1) % shard_rows == 0)) {
      const uint32_t r = wfirst + seg;     // the piece's first row
      const uint32_t p = (r + 31) / 32 + (r + shard_rows - 1) / shard_rows
                         - (r + lcm_rows - 1) / lcm_rows;
      long long* o = pieces + 3 * static_cast<int64_t>(p);
      o[0] = m;
      o[1] = ev;
      o[2] = by;
    }
  }
}

template <bool NESTED, int PIVOT, bool STATS>
int launch(const uint8_t* rows, const int32_t* lens, int64_t B, int32_t L,
           const int32_t* prog, int32_t prog_words, uint8_t* ok_out,
           int32_t* off_out, int32_t* len_out, long long* pieces,
           int64_t shard_rows, int64_t lcm_rows, int32_t threads,
           int32_t smem_bytes, void* stream) {
  if (B <= 0) return 0;
  if (STATS && (B >= (1ll << 31) || shard_rows < 1 || B % shard_rows
                || lcm_rows < 1 || lcm_rows > B || lcm_rows % shard_rows))
    return (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  auto kernel = field_extract_kernel<NESTED, PIVOT, STATS>;
  // The attribute is a cap, not a reservation: each instantiation opts into
  // the whole budget once per device and no launch lowers it again, so two
  // threads launching at once can only set the same value twice.
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
  kernel<<<(unsigned)blocks, threads, (size_t)smem_bytes,
           (cudaStream_t)stream>>>(rows, lens, B, L, prog, prog_words, ok_out,
                                   off_out, len_out, pieces,
                                   (uint32_t)shard_rows, (uint32_t)lcm_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` (PyTorch's current stream) without
// synchronising, with `threads` per block and `smem_bytes` of dynamic shared
// memory (field_extract_cuda.launch_geometry); returns the launch's
// cudaError_t (0 = launched).  dN is nesting (0: depth 0), pN the pivots.
#define LCT_FIELD_EXTRACT(NAME, NESTED, PIVOT)                               \
  int NAME(const uint8_t* rows, const int32_t* lens, int64_t B, int32_t L,   \
           const int32_t* prog, int32_t prog_words, uint8_t* ok_out,         \
           int32_t* off_out, int32_t* len_out, int32_t threads,              \
           int32_t smem_bytes, void* stream) {                               \
    return launch<NESTED, PIVOT, false>(rows, lens, B, L, prog, prog_words,   \
                                        ok_out, off_out, len_out, nullptr,   \
                                        1, 1, threads, smem_bytes, stream);  \
  }

// K8: the same walk over shards of `shard_rows` rows (B a multiple), and
// each piece's three counts (i64 [pieces][3]: matched, events, bytes)
// written into `pieces`, every piece once, nothing zeroed first;
// `lcm_rows` = min(lcm(32, shard_rows), B), from which a piece's index
// follows (field_extract_cuda.stat_pieces).  The launch writes through the
// pointers of the current device.
#define LCT_SHARDED_EXTRACT(NAME, NESTED, PIVOT)                             \
  int NAME(const uint8_t* rows, const int32_t* lens, int64_t B, int32_t L,   \
           const int32_t* prog, int32_t prog_words, uint8_t* ok_out,         \
           int32_t* off_out, int32_t* len_out, long long* pieces,            \
           int64_t shard_rows, int64_t lcm_rows, int32_t threads,            \
           int32_t smem_bytes, void* stream) {                               \
    return launch<NESTED, PIVOT, true>(rows, lens, B, L, prog, prog_words,    \
                                       ok_out, off_out, len_out, pieces,     \
                                       shard_rows, lcm_rows, threads,        \
                                       smem_bytes, stream);                  \
  }

extern "C" {

LCT_FIELD_EXTRACT(lct_field_extract_d0_p0, false, 0)
LCT_FIELD_EXTRACT(lct_field_extract_d0_p1, false, 1)
LCT_FIELD_EXTRACT(lct_field_extract_d0_p2, false, 2)
LCT_FIELD_EXTRACT(lct_field_extract_d1_p0, true, 0)
LCT_FIELD_EXTRACT(lct_field_extract_d1_p1, true, 1)
LCT_FIELD_EXTRACT(lct_field_extract_d1_p2, true, 2)

LCT_SHARDED_EXTRACT(lct_sharded_extract_d0_p0, false, 0)
LCT_SHARDED_EXTRACT(lct_sharded_extract_d0_p1, false, 1)
LCT_SHARDED_EXTRACT(lct_sharded_extract_d0_p2, false, 2)
LCT_SHARDED_EXTRACT(lct_sharded_extract_d1_p0, true, 0)
LCT_SHARDED_EXTRACT(lct_sharded_extract_d1_p1, true, 1)
LCT_SHARDED_EXTRACT(lct_sharded_extract_d1_p2, true, 2)

const char* lct_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
