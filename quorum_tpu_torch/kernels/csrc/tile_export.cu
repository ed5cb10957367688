// HK6 tile_export: the sealed table -> the v4/v5 database payload.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:1643 (tile_export_v4 =
// _canonical_rows :1548, a per-row lax.sort by (empty, hi, lo), then
// tile_compact_device :764, a cumsum + scatter compaction).
//
// Payload, written in place as one device buffer: counts u8[rows] (the
// occupied slots of each row), then the occupied entries' lo words as LE
// u32 in row order, each row's entries sorted by (hi, lo) unsigned, then
// `hi_bytes` byte planes of their hi words. Occupied = (lo & max_val) !=
// 0; the seal made every other slot 0.
//
// The rows may be a row range of a larger table (one shard of a sharded
// export, or one pass of the partitioned build after HK13 rebased it): the
// wrapper passes the plane's own row count and the file geometry's
// hi_bytes.
//
// Both entries below read each row once in a single-pass chained scan
// (decoupled look-back): a block takes the next tile of CT_TILE = 24 rows
// from an atomic ticket (so every tile it looks back on already runs);
// each of its four warps loads six rows into registers (a lane the
// 16-byte slot pair it owns in each, streaming loads), ballots count and
// rank the occupied slots, and the block publishes its count in the
// tile's status word (flag | value, one 64-bit relaxed store) and puts
// each occupied (lo, hi) at its rank in shared memory. Warp 0 then sums
// its predecessors' words, 32 at a time, back to the nearest inclusive
// prefix and publishes its own inclusive prefix, while no row is held in
// registers; the block copies its entries out in coalesced stores. The
// last tile writes the total itself, so the wrapper zeroes only the
// status words (8 B a tile). The block's latency (ticket, loads,
// look-back) is what the design hides: 128 threads and 12 KB of stage a
// block let 16 blocks of the compact entry share an SM, and 12 of the
// export, whose sort takes 40 registers a thread. Twenty-four rows is no
// power of two, so every table and every shard of one ends in a ragged
// tile.
//
// Export (K8): the payload needs the entry count n before the first hi
// byte is placed, and the caller holds it (the seal's occupied count), so
// the export is one launch. Before the look-back each warp sorts its rows
// in the stage, by the row's c occupied (hi, lo) keys only: for c <= 32 a
// lane takes one key and counts the keys below it, ties broken by slot as
// the plain version's stable sorts break them -- c steps of broadcast
// loads, not 64 -- and the warp writes each key at its rank; a longer row
// goes through table.cuh's warp sort (__syncwarp, no block barrier,
// either way). The block then writes its rows' counts, its lo words
// (4 bytes a lane where rows % 4 == 0, else a byte a lane) and its hi
// byte planes (a byte a lane) from the stage as contiguous runs, and drops
// every entry at or past n, so a wrong n never writes out of bounds; the
// wrapper holds the kernel's total to n. Without n, a count launch (a
// warp a row, each lane its two slots, one atomic a block) gives it
// first: two reads of the table where the main path reads it once.
//
// Compact entry (K22, quorum_tpu/ops/ctable.py:764 tile_compact_device):
// the occupied slots' (row address i32, lo, hi) in row-major SLOT order
// (not canonical order), packed into `cap` lanes (zeros past the n-th),
// with n = the occupied slots in all; the block copies its entries to
// [prefix, prefix + count) of the lanes (an entry's row from the rows'
// first ranks) and drops those at or past cap; the last tile zeroes the
// lanes [min(n, cap), cap), so the wrapper allocates the lanes
// uninitialised.
//
// Bound: bytes. The least traffic reads the sealed rows once (512 B a
// row) and writes the payload once (the export: a byte a row and 4 +
// hi_bytes an entry; compact: 12 B an entry, the three cap-lane planes);
// the status words add 8 B for every 24 rows (1/1536 of the rows'
// bytes). The export's count launch, where n is not given, reads the rows
// a second time.
#include "table.cuh"

#define CT_WARPS 4
#define CT_ROWS 6  // rows a warp loads
#define CT_TILE (CT_WARPS * CT_ROWS)
// a tile's status word: flag in the top two bits, value below
#define CT_AGG (1ull << 62)  // the tile's own count
#define CT_INC (2ull << 62)  // the inclusive prefix through the tile
#define CT_VAL (CT_AGG - 1ull)

__device__ __forceinline__ unsigned long long ct_load(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void ct_store(unsigned long long* p,
                                         unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The sum of the tiles before `tile` (warp 0 of its block, every lane;
// tile > 0): windows of 32 predecessors, newest first, each waited on
// until every word in it is published, summed down to the newest
// inclusive word (the words before tile 0 read as an inclusive 0).
__device__ long long ct_look_back(const unsigned long long* status,
                                  long long tile) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (long long j = tile - 1;; j -= 32) {
    const long long pj = j - lane;
    unsigned long long s;
    do {
      s = pj >= 0 ? ct_load(status + pj) : CT_INC;
    } while (__any_sync(FULL_MASK, (s >> 62) == 0));
    const unsigned inc = __ballot_sync(FULL_MASK, (s >> 62) == 2);
    const int last = inc ? __ffs(inc) - 1 : 31;
    long long v = lane <= last ? (long long)(s & CT_VAL) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    excl += v;
    if (inc) return excl;
  }
}

// Warp 0 of tile `tile`'s block (every lane): publish the tile's count
// `agg`, look back and publish the inclusive prefix; returns the tiles
// before it.
__device__ __forceinline__ long long ct_publish(unsigned long long* status,
                                                long long tile, int agg) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  if (tile == 0) {
    if (lane == 0) ct_store(status, CT_INC | (unsigned long long)agg);
  } else {
    if (lane == 0) ct_store(status + tile, CT_AGG | (unsigned long long)agg);
    excl = ct_look_back(status, tile);
    if (lane == 0)
      ct_store(status + tile, CT_INC | (unsigned long long)(excl + agg));
  }
  return excl;
}

// 16 blocks of 128 threads an SM: 32 registers a thread, 12 KB of stage
__global__ void __launch_bounds__(32 * CT_WARPS, 16)
    compact_kernel(const uint4* __restrict__ rows, long long nrows,
                   uint32_t maxv, long long ntiles,
                   unsigned long long* status, long long cap,
                   int* __restrict__ addr, uint32_t* __restrict__ lo,
                   uint32_t* __restrict__ hi) {
  __shared__ uint2 s_ent[CT_TILE * TSLOTS];  // the tile's (lo, hi), ranked
  __shared__ int s_row[CT_TILE];              // each row's first rank
  __shared__ long long s_tile, s_base, s_n;
  __shared__ int s_warp[CT_WARPS];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0)
    s_tile = (long long)atomicAdd(status + ntiles, 1ull);  // the ticket
  __syncthreads();
  const long long tile = s_tile;
  const long long r0 = tile * CT_TILE;
  const long long row0 = r0 + wid * CT_ROWS;
  // every row load in flight before a use; streaming, as each row is
  // read once
  uint4 w[CT_ROWS];
#pragma unroll
  for (int j = 0; j < CT_ROWS; ++j)
    w[j] = row0 + j < nrows ? __ldcs(rows + (row0 + j) * 32 + lane)
                            : make_uint4(0u, 0u, 0u, 0u);
  int off[CT_ROWS];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < CT_ROWS; ++j) {
    off[j] = cnt;
    cnt += __popc(__ballot_sync(FULL_MASK, (w[j].x & maxv) != 0u)) +
           __popc(__ballot_sync(FULL_MASK, (w[j].z & maxv) != 0u));
  }
  if (lane == 0) s_warp[wid] = cnt;
  __syncthreads();
  int below = 0, agg = 0;
#pragma unroll
  for (int v = 0; v < CT_WARPS; ++v) {
    below += v < wid ? s_warp[v] : 0;
    agg += s_warp[v];
  }
  // each occupied slot at its rank in the tile (slot order), before the
  // look-back, so that no row stays in registers while warp 0 waits
  const unsigned lower = (1u << lane) - 1u;  // slots 2i, 2i + 1 for i < lane
#pragma unroll
  for (int j = 0; j < CT_ROWS; ++j) {
    const bool o0 = (w[j].x & maxv) != 0u, o1 = (w[j].z & maxv) != 0u;
    const unsigned m0 = __ballot_sync(FULL_MASK, o0);
    const unsigned m1 = __ballot_sync(FULL_MASK, o1);
    const int e0 = below + off[j] + __popc(m0 & lower) + __popc(m1 & lower);
    if (lane == 0) s_row[wid * CT_ROWS + j] = below + off[j];
    if (o0) s_ent[e0] = make_uint2(w[j].x, w[j].y);
    if (o1) s_ent[e0 + (o0 ? 1 : 0)] = make_uint2(w[j].z, w[j].w);
  }
  if (wid == 0) {
    const long long excl = ct_publish(status, tile, agg);
    if (lane == 0) {
      s_base = excl;
      s_n = excl + agg;
    }
  }
  __syncthreads();
  // the tile's entries to [base, base + agg) of the lanes, coalesced; an
  // entry's row is the last row whose first rank is at or below it
  const long long base = s_base;
  for (int e = threadIdx.x; e < agg && base + e < cap; e += blockDim.x) {
    int a = 0, b = CT_TILE - 1;
    while (a < b) {
      const int m = (a + b + 1) >> 1;
      if (s_row[m] <= e) a = m; else b = m - 1;
    }
    const uint2 v = s_ent[e];
    __stcs(addr + base + e, (int)(r0 + a));  // streaming: written once
    __stcs(lo + base + e, v.x);
    __stcs(hi + base + e, v.y);
  }
  if (tile == ntiles - 1) {  // the last ticket: n, and the lanes past it
    const long long n = s_n;
    if (threadIdx.x == 0) status[ntiles + 1] = (unsigned long long)n;
    for (long long e = (n < cap ? n : cap) + threadIdx.x; e < cap;
         e += blockDim.x) {
      addr[e] = 0;
      lo[e] = 0u;
      hi[e] = 0u;
    }
  }
}

// Export, the count launch (n not given): the occupied slots in all into
// *total (zeroed by the caller), a warp a row, each lane its two slots.
#define TOTAL_BLOCKS (132 * 8)

__global__ void __launch_bounds__(256)
    export_total_kernel(const uint4* __restrict__ rows, long long nrows,
                        uint32_t maxv, unsigned long long* total) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  unsigned long long v[1] = {0ull};
  for (long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                       (threadIdx.x >> 5);
       row < nrows; row += warps) {
    const uint4 w = __ldcs(rows + row * 32 + lane);
    v[0] += ((w.x & maxv) != 0u) + ((w.z & maxv) != 0u);
  }
  block_add<1>(v, total);
}

__device__ __forceinline__ unsigned long long ent_key(uint2 v) {
  return (unsigned long long)v.y << 32 | v.x;
}

// Sort a row's c (> 1) occupied entries, staged in slot order at `ent`,
// in place by (hi, lo) unsigned (a whole warp). For c <= 32 a lane takes
// one entry and counts the row's keys below it, equal keys by slot as the
// plain version's stable sorts order them (a broadcast load a step), and
// the warp writes each at its rank; a longer row goes through table.cuh
// warp_sort64 (equal keys are equal entries there, so their order does
// not show).
__device__ __forceinline__ void sort_row(uint2* ent, int c, int lane) {
  if (c <= 32) {
    const uint2 a = lane < c ? ent[lane] : make_uint2(0u, 0u);
    const unsigned long long ka = ent_key(a);
    int r = 0;
    for (int m = 0; m < c; ++m) {
      const unsigned long long k = ent_key(ent[m]);
      r += k < ka || (k == ka && m < lane);
    }
    __syncwarp();  // every key is read before any moves
    if (lane < c) ent[r] = a;
    return;
  }
  unsigned long long a = ent_key(ent[lane]);
  unsigned long long b = lane + 32 < c ? ent_key(ent[lane + 32]) : ~0ull;
  warp_sort64(a, b);
  __syncwarp();  // every key is read before any moves
  ent[lane] = make_uint2((uint32_t)a, (uint32_t)(a >> 32));
  if (lane + 32 < c)
    ent[lane + 32] = make_uint2((uint32_t)b, (uint32_t)(b >> 32));
}

// 12 blocks of 128 threads an SM: 40 registers a thread (the compact
// entry's 32 spill the sort's), 12 KB of stage
__global__ void __launch_bounds__(32 * CT_WARPS, 12)
    export_kernel(const uint4* __restrict__ rows, long long nrows,
                  uint32_t maxv, long long ntiles,
                  unsigned long long* status, long long n, int hi_bytes,
                  uint8_t* __restrict__ out) {
  __shared__ uint2 s_ent[CT_TILE * TSLOTS];  // the tile's (lo, hi), sorted
  __shared__ int s_row[CT_TILE + 1];          // each row's first rank
  __shared__ long long s_tile, s_base, s_n;
  __shared__ int s_warp[CT_WARPS];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0)
    s_tile = (long long)atomicAdd(status + ntiles, 1ull);  // the ticket
  __syncthreads();
  const long long tile = s_tile;
  const long long r0 = tile * CT_TILE;
  const long long row0 = r0 + wid * CT_ROWS;
  uint4 w[CT_ROWS];
#pragma unroll
  for (int j = 0; j < CT_ROWS; ++j)
    w[j] = row0 + j < nrows ? __ldcs(rows + (row0 + j) * 32 + lane)
                            : make_uint4(0u, 0u, 0u, 0u);
  int off[CT_ROWS + 1];
  off[0] = 0;
#pragma unroll
  for (int j = 0; j < CT_ROWS; ++j)
    off[j + 1] = off[j] +
                 __popc(__ballot_sync(FULL_MASK, (w[j].x & maxv) != 0u)) +
                 __popc(__ballot_sync(FULL_MASK, (w[j].z & maxv) != 0u));
  if (lane == 0) s_warp[wid] = off[CT_ROWS];
  __syncthreads();
  int below = 0, agg = 0;
#pragma unroll
  for (int v = 0; v < CT_WARPS; ++v) {
    below += v < wid ? s_warp[v] : 0;
    agg += s_warp[v];
  }
  // each occupied slot at its rank in the tile (slot order), then each
  // row ranked, before the look-back
  const unsigned lower = (1u << lane) - 1u;  // slots 2i, 2i + 1 for i < lane
#pragma unroll
  for (int j = 0; j < CT_ROWS; ++j) {
    const bool o0 = (w[j].x & maxv) != 0u, o1 = (w[j].z & maxv) != 0u;
    const unsigned m0 = __ballot_sync(FULL_MASK, o0);
    const unsigned m1 = __ballot_sync(FULL_MASK, o1);
    const int e0 = below + off[j] + __popc(m0 & lower) + __popc(m1 & lower);
    if (lane == 0) s_row[wid * CT_ROWS + j] = below + off[j];
    if (o0) s_ent[e0] = make_uint2(w[j].x, w[j].y);
    if (o1) s_ent[e0 + (o0 ? 1 : 0)] = make_uint2(w[j].z, w[j].w);
  }
  if (threadIdx.x == 0) s_row[CT_TILE] = agg;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < CT_ROWS; ++j)
    if (off[j + 1] - off[j] > 1)  // whole warps
      sort_row(s_ent + below + off[j], off[j + 1] - off[j], lane);
  if (wid == 0) {
    const long long excl = ct_publish(status, tile, agg);
    if (lane == 0) {
      s_base = excl;
      s_n = excl + agg;
    }
  }
  __syncthreads();
  // the tile's counts, then its entries [base, base + agg) of the n in
  // the lo words and each hi plane, in canonical order, from the stage in
  // contiguous runs
  const long long base = s_base;
  const int nt = (int)(nrows - r0 < CT_TILE ? nrows - r0 : CT_TILE);
  if ((int)threadIdx.x < nt)
    out[r0 + threadIdx.x] = (uint8_t)(s_row[threadIdx.x + 1] -
                                      s_row[threadIdx.x]);
  const int m = (int)(n - base < agg ? (n - base > 0 ? n - base : 0) : agg);
  uint8_t* lo_out = out + nrows;
  uint8_t* hi_out = lo_out + 4 * n + base;
  const bool aligned = (nrows & 3) == 0;
  for (int p = threadIdx.x; p < m; p += blockDim.x) {
    const uint2 v = s_ent[p];
    if (aligned)  // streaming: written once
      __stcs(reinterpret_cast<uint32_t*>(lo_out) + base + p, v.x);
    for (int j = 0; j < hi_bytes; ++j)
      hi_out[j * n + p] = (uint8_t)(v.y >> (8 * j));
  }
  if (!aligned)
    for (int b = threadIdx.x; b < 4 * m; b += blockDim.x)
      lo_out[4 * base + b] =
          (uint8_t)(s_ent[b >> 2].x >> (8 * (b & 3)));
  if (tile == ntiles - 1 && threadIdx.x == 0)  // the last ticket: the total
    status[ntiles + 1] = (unsigned long long)s_n;
}

// Export, the count launch: the occupied slots of the rows in all into
// *total, which the caller zeroed.
extern "C" int tile_export_total(const uint32_t* rows, long long nrows,
                                 int bits, unsigned long long* total,
                                 void* stream) {
  const long long blocks = (nrows + 7) / 8;
  if (nrows > 0)
    export_total_kernel<<<(unsigned)(blocks < TOTAL_BLOCKS ? blocks
                                                           : TOTAL_BLOCKS),
                          256, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const uint4*>(rows), nrows, (1u << bits) - 1u,
        total);
  return (int)cudaGetLastError();
}

// Export: the payload of n entries (nrows + (4 + hi_bytes) * n bytes) into
// `out`, entries past the n-th dropped; the entries the rows hold in all
// (as int64) into status[ntiles + 1]. `status` holds status_len >=
// ntiles + 2 int64 zeroed by the caller (ntiles = ceil(nrows / CT_TILE)
// tile words, the ticket, the total).
extern "C" int tile_export_rows(const uint32_t* rows, long long nrows,
                                int bits, long long n, int hi_bytes,
                                uint8_t* out, unsigned long long* status,
                                long long status_len, void* stream) {
  const long long ntiles = (nrows + CT_TILE - 1) / CT_TILE;
  if (nrows < 1 || n < 0 || status_len < ntiles + 2)
    return (int)cudaErrorInvalidValue;
  export_kernel<<<(unsigned)ntiles, 32 * CT_WARPS, 0,
                  (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(rows), nrows, (1u << bits) - 1u, ntiles,
      status, n, hi_bytes, out);
  return (int)cudaGetLastError();
}

// Compact entry: (addr, lo, hi) of cap lanes each, written whole; n (as
// int64) into status[ntiles + 1]. `status` holds status_len >= ntiles + 2
// int64 zeroed by the caller (ntiles = ceil(nrows / CT_TILE) tile words,
// the ticket, n).
extern "C" int tile_export_compact(const uint32_t* rows, long long nrows,
                                   int bits, long long cap, int* addr,
                                   uint32_t* lo, uint32_t* hi,
                                   unsigned long long* status,
                                   long long status_len, void* stream) {
  const long long ntiles = (nrows + CT_TILE - 1) / CT_TILE;
  if (nrows < 1 || cap < 0 || status_len < ntiles + 2)
    return (int)cudaErrorInvalidValue;
  compact_kernel<<<(unsigned)ntiles, 32 * CT_WARPS, 0,
                   (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(rows), nrows, (1u << bits) - 1u, ntiles,
      status, cap, addr, lo, hi);
  return (int)cudaGetLastError();
}
