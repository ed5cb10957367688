// HK2 tile_seal: end of the stage-1 build.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:1443 (tile_seal =
// _dup_check_impl :1454 + _finalize_impl :1476 + tile_stats :749), and
// quorum_tpu/ops/sketch.py:348 (singleton_entries: the build slots with
// exactly one observation, counted before the fold -- in a two-pass
// prefiltered build, the sketch's false passes).
//
// Each slot folds into the query layout
//   lo = rlo << (bits+1) | q << bits | min(count, max_val),  hi = rhi
// (q = the slot saw a high-quality observation; count is then the hq
// count, else the lq count; an unoccupied slot -- EMPTY_TAG, or no count
// -- becomes 0), no two occupied slots of a row may hold one tag pair
// (the duplicate flag; a pair whose hi word is all ones never counts, as
// in the plain version's sort), and the statistics are (occupied,
// distinct-hq, total-hq, single-observation slots).
//
// Design: a warp a row, with no block barrier until the end. A lane owns
// the slot pair (2 lane, 2 lane + 1): one 16-byte tag load (lo0, hi0, lo1,
// hi1) and 8-byte hq and lq loads, and one 16-byte streaming store of the
// sealed pair. A warp issues the loads of SEAL_ROWS consecutive rows
// before it uses any (every load of a row is read once: streaming), and
// the blocks walk the table with a grid stride, a persistent grid of
// SEAL_BLOCKS (8 blocks of 4 warps on each of the H100's 132 SMs): the
// statistics stay in registers across a block's rows, ballots and
// popcounts for the counts, and each block adds them once to the five
// 64-bit counters (table.cuh block_add), a few thousand atomics in all
// where a block a tile of rows would take five a tile. The duplicate
// check runs over the row's occupied slots only: the ballots give their
// number c, and when c > 1 the warp gathers their tag pairs by ballot
// rank into its own 512-byte stage (__syncwarp, no block barrier); then,
// for c <= 32, lane i compares pair i with pair (i + d) mod c for d = 1
// .. c / 2, which meets every unordered pair in c / 2 steps (about 4 at
// the main path's 13.7% occupancy); a row of more than 32 sorts its pairs
// across the warp (table.cuh warp_sort64, 21 shuffle stages) and
// compares neighbours.
// __match_any_sync on the 64-bit pair (a lane past c holding a sentinel,
// lo = EMPTY_TAG) was no faster than the loop on a table at 13.7%
// occupancy and needs the same fallback past 32, so the loop stays.
//
// Bound: bytes. It reads the tag plane (512 B/row) and the hq/lq planes
// (512 B/row) once and writes the sealed rows (512 B/row).
#include "table.cuh"

#define SEAL_WARPS 4
#define SEAL_ROWS 4  // rows a warp has in flight
#define SEAL_BLOCKS (132 * 8)

// Whether two of the c tag pairs gathered in `key` are equal: for c <=
// 32 a lane compares pair i = lane with pair (i + d) mod c for d = 1 ..
// c / 2, which meets every unordered pair; for c > 32 the warp sorts the
// pairs (table.cuh warp_sort64) and compares neighbours.
__device__ __forceinline__ bool dup_pairs(const uint2* key, int c, int lane) {
  bool dup = false;
  if (c <= 32) {  // whole warps
    if (lane < c) {
      const uint2 a = key[lane];
      for (int d = 1; d <= c / 2; ++d) {
        const int j = lane + d < c ? lane + d : lane + d - c;
        const uint2 b = key[j];
        dup |= a.x == b.x && a.y == b.y;
      }
    }
    return dup;
  }
  uint2 x = key[lane];
  unsigned long long a = (unsigned long long)x.y << 32 | x.x, b = ~0ull;
  if (lane + 32 < c) {
    x = key[lane + 32];
    b = (unsigned long long)x.y << 32 | x.x;
  }
  warp_sort64(a, b);
  // neighbours: a's in lanes l, l + 1, the last a and the first b, b's;
  // a gathered pair's lo word is never EMPTY_TAG, so no pair is ~0
  const unsigned long long na = __shfl_down_sync(FULL_MASK, a, 1);
  const unsigned long long nb = __shfl_down_sync(FULL_MASK, b, 1);
  const unsigned long long b0 = __shfl_sync(FULL_MASK, b, 0);
  return a == (lane < 31 ? na : b0) || (lane < 31 && b == nb && b != ~0ull);
}

__global__ void __launch_bounds__(32 * SEAL_WARPS, 8)
    seal_kernel(const uint4* __restrict__ tag, const uint2* __restrict__ hq,
                const uint2* __restrict__ lq, long long rows, int bits,
                uint4* __restrict__ out, unsigned long long* stats) {
  __shared__ uint2 s_key[SEAL_WARPS][TSLOTS];  // a row's occupied pairs
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint2* key = s_key[wid];
  const uint32_t maxv = (1u << bits) - 1u;
  const unsigned lower = (1u << lane) - 1u;  // slots 2i, 2i + 1 for i < lane
  bool dup = false;
  // occupied, distinct-hq (lane 0's, whole rows), total-hq (each lane's
  // slots), singletons (lane 0's)
  unsigned long long v[4] = {0ull, 0ull, 0ull, 0ull};
  const long long stride = (long long)gridDim.x * SEAL_WARPS * SEAL_ROWS;
  for (long long r0 = ((long long)blockIdx.x * SEAL_WARPS + wid) * SEAL_ROWS;
       r0 < rows; r0 += stride) {
    uint4 t[SEAL_ROWS];
    uint2 h[SEAL_ROWS], l[SEAL_ROWS];
#pragma unroll
    for (int j = 0; j < SEAL_ROWS; ++j) {
      const long long i = (r0 + j) * 32 + lane;
      const bool in = r0 + j < rows;
      t[j] = in ? __ldcs(tag + i) : make_uint4(0u, 0u, 0u, 0u);
      h[j] = in ? __ldcs(hq + i) : make_uint2(0u, 0u);
      l[j] = in ? __ldcs(lq + i) : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < SEAL_ROWS; ++j) {
      if (r0 + j >= rows) break;  // whole warps
      const bool o0 = t[j].x != EMPTY_TAG && (h[j].x | l[j].x) != 0u;
      const bool o1 = t[j].z != EMPTY_TAG && (h[j].y | l[j].y) != 0u;
      const bool q0 = o0 && h[j].x > 0u, q1 = o1 && h[j].y > 0u;
      uint32_t c0 = q0 ? h[j].x : l[j].x, c1 = q1 ? h[j].y : l[j].y;
      c0 = c0 < maxv ? c0 : maxv;
      c1 = c1 < maxv ? c1 : maxv;
      __stcs(out + (r0 + j) * 32 + lane,
             make_uint4(
                 o0 ? (t[j].x << (bits + 1)) | ((uint32_t)q0 << bits) | c0
                    : 0u,
                 o0 ? t[j].y : 0u,
                 o1 ? (t[j].z << (bits + 1)) | ((uint32_t)q1 << bits) | c1
                    : 0u,
                 o1 ? t[j].w : 0u));
      const unsigned m0 = __ballot_sync(FULL_MASK, o0);
      const unsigned m1 = __ballot_sync(FULL_MASK, o1);
      v[0] += __popc(m0) + __popc(m1);
      v[1] += __popc(__ballot_sync(FULL_MASK, q0)) +
              __popc(__ballot_sync(FULL_MASK, q1));
      v[2] += (q0 ? c0 : 0u) + (q1 ? c1 : 0u);
      v[3] += __popc(__ballot_sync(FULL_MASK, o0 && h[j].x + l[j].x == 1u)) +
              __popc(__ballot_sync(FULL_MASK, o1 && h[j].y + l[j].y == 1u));
      // the duplicate check, over the occupied pairs whose hi is not all
      // ones
      const bool d0 = o0 && t[j].y != EMPTY_TAG;
      const bool d1 = o1 && t[j].w != EMPTY_TAG;
      const unsigned k0 = __ballot_sync(FULL_MASK, d0);
      const unsigned k1 = __ballot_sync(FULL_MASK, d1);
      const int c = __popc(k0) + __popc(k1);
      if (c < 2) continue;  // whole warps
      const int e = __popc(k0 & lower) + __popc(k1 & lower);
      if (d0) key[e] = make_uint2(t[j].x, t[j].y);
      if (d1) key[e + d0] = make_uint2(t[j].z, t[j].w);
      __syncwarp();
      dup |= dup_pairs(key, c, lane);
      __syncwarp();  // the stage is read before the next row's gather
    }
  }
  // lane 0 counted whole rows for the ballots; the other lanes' shares
  if (lane != 0) v[0] = v[1] = v[3] = 0ull;
  if (__syncthreads_or(dup) && threadIdx.x == 0) atomicOr(stats, 1ull);
  block_add<4>(v, stats + 1);
}

extern "C" int tile_seal(const uint32_t* tag, const uint32_t* hq,
                         const uint32_t* lq, long long rows, int bits,
                         uint32_t* out, unsigned long long* stats,
                         void* stream) {
  // the wrapper checks tag's and out's 16-byte and hq's and lq's 8-byte
  // alignment
  const long long tiles = (rows + SEAL_WARPS * SEAL_ROWS - 1) /
                          (SEAL_WARPS * SEAL_ROWS);
  if (rows > 0)
    seal_kernel<<<(unsigned)(tiles < SEAL_BLOCKS ? tiles : SEAL_BLOCKS),
                  32 * SEAL_WARPS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const uint4*>(tag),
        reinterpret_cast<const uint2*>(hq),
        reinterpret_cast<const uint2*>(lq), rows, bits,
        reinterpret_cast<uint4*>(out), stats);
  return (int)cudaGetLastError();
}
