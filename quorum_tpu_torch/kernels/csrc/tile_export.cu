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
// Design: pass 1, one warp per row: each lane loads two slots as one
// 16-byte vector, a ballot counts the occupied ones, and table.cuh
// row_offsets scans the counts into each row's first entry index (the
// grand total comes back to the wrapper, which sizes the buffer). Pass 2,
// one warp per row again: the row's 64 (hi, lo) keys go to shared memory
// (empty slots as all ones, which no entry reaches: lo < 2^31), and each
// lane ranks its two keys by counting the smaller ones -- keys in a row
// are distinct, so the ranks of the occupied entries are 0..count-1 --
// and writes each entry at first[row] + rank.
//
// The rows may be a row range of a larger table (one shard of a sharded
// export, or one pass of the partitioned build after HK13 rebased it): the
// wrapper passes the plane's own row count and the file geometry's
// hi_bytes.
//
// Compact entry (K22, quorum_tpu/ops/ctable.py:764 tile_compact_device):
// the occupied slots' (row address i32, lo, hi) in row-major SLOT order
// (not canonical order), packed into `cap` lanes (zeros past the n-th),
// with n = the occupied slots in all. One kernel reads each row once, in
// a single-pass chained scan (decoupled look-back): a block takes the
// next tile of CT_TILE = 24 rows from an atomic ticket (so every tile it
// looks back on already runs); each of its four warps loads six rows
// into registers (a lane the 16-byte slot pair it owns in each), ballots
// count and rank the occupied slots, and the block publishes its count
// in the tile's status word (flag | value, one 64-bit relaxed store) and
// puts each occupied (lo, hi) at its rank in shared memory. Warp 0 then
// sums its predecessors' words, 32 at a time, back to the nearest
// inclusive prefix and publishes its own inclusive prefix, while no row
// is held in registers; the block copies its entries to [prefix, prefix
// + count) of the lanes in coalesced stores (an entry's row from the
// rows' first ranks) and drops those at or past cap. The last tile
// writes n and zeroes the lanes [min(n, cap), cap) itself, so the wrapper
// allocates the lanes uninitialised and zeroes only the status words (8
// B a tile). The block's latency (ticket, loads, look-back) is what the
// design hides: 128 threads, 32 registers and 12 KB of stage a block let
// 16 blocks share an SM. Twenty-four rows is no power of two, so every
// table and every shard of one ends in a ragged tile.
//
// Bound: bytes. The least traffic reads the sealed rows once (512 B a
// row) and writes the payload once (compact: 12 B an entry, the three
// cap-lane planes); the export's pass 1 reads the rows a second time.
// The compact entry reads them once; its status words add 8 B for every
// 24 rows (1/1536 of the rows' bytes).
#include "table.cuh"

#define ROWS_PER_BLOCK 8

__global__ void export_counts_kernel(const uint4* __restrict__ rows,
                                     long long nrows, uint32_t maxv,
                                     uint8_t* __restrict__ counts) {
  const long long row =
      (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= nrows) return;  // whole warps
  const uint4 w = rows[row * 32 + lane];
  const unsigned m0 = __ballot_sync(FULL_MASK, (w.x & maxv) != 0u);
  const unsigned m1 = __ballot_sync(FULL_MASK, (w.z & maxv) != 0u);
  if (lane == 0) counts[row] = (uint8_t)(__popc(m0) + __popc(m1));
}

__device__ __forceinline__ void put_entry(uint8_t* lo_out, uint8_t* hi_out,
                                          long long n, long long e,
                                          bool aligned, uint32_t lo,
                                          uint32_t hi, int hi_bytes) {
  if (aligned) {
    *reinterpret_cast<uint32_t*>(lo_out + 4 * e) = lo;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) lo_out[4 * e + j] = (uint8_t)(lo >> (8 * j));
  }
  for (int j = 0; j < hi_bytes; ++j)
    hi_out[j * n + e] = (uint8_t)(hi >> (8 * j));
}

__global__ void export_rows_kernel(const uint4* __restrict__ rows,
                                   long long nrows, uint32_t maxv,
                                   const uint8_t* __restrict__ counts,
                                   const long long* __restrict__ first,
                                   long long n, int hi_bytes,
                                   uint8_t* __restrict__ out) {
  __shared__ unsigned long long keys[ROWS_PER_BLOCK][TSLOTS];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + wid;
  if (row >= nrows) return;  // whole warps; no block barrier below
  const uint4 w = rows[row * 32 + lane];
  const bool o0 = (w.x & maxv) != 0u, o1 = (w.z & maxv) != 0u;
  const unsigned long long k0 =
      o0 ? ((unsigned long long)w.y << 32 | w.x) : ~0ull;
  const unsigned long long k1 =
      o1 ? ((unsigned long long)w.w << 32 | w.z) : ~0ull;
  keys[wid][2 * lane] = k0;
  keys[wid][2 * lane + 1] = k1;
  __syncwarp();
  int r0 = 0, r1 = 0;
#pragma unroll 8
  for (int j = 0; j < TSLOTS; ++j) {
    const unsigned long long kj = keys[wid][j];
    r0 += kj < k0;
    r1 += kj < k1;
  }
  if (lane == 0) out[row] = counts[row];
  uint8_t* lo_out = out + nrows;
  uint8_t* hi_out = lo_out + 4 * n;
  const bool aligned = (nrows & 3) == 0;
  const long long base = first[row];
  if (o0) put_entry(lo_out, hi_out, n, base + r0, aligned, w.x, w.y,
                    hi_bytes);
  if (o1) put_entry(lo_out, hi_out, n, base + r1, aligned, w.z, w.w,
                    hi_bytes);
}

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
    long long excl = 0;
    if (tile == 0) {
      if (lane == 0) ct_store(status, CT_INC | (unsigned long long)agg);
    } else {
      if (lane == 0) ct_store(status + tile, CT_AGG | (unsigned long long)agg);
      excl = ct_look_back(status, tile);
      if (lane == 0)
        ct_store(status + tile, CT_INC | (unsigned long long)(excl + agg));
    }
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

static inline unsigned row_blocks(long long nrows) {
  return (unsigned)((nrows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
}

// Pass 1: counts u8[rows], scratch sums, first int64[rows + 1].
extern "C" int tile_export_counts(const uint32_t* rows, long long nrows,
                                  int bits, uint8_t* counts, long long* sums,
                                  long long* first, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nrows > 0)
    export_counts_kernel<<<row_blocks(nrows), 32 * ROWS_PER_BLOCK, 0, s>>>(
        reinterpret_cast<const uint4*>(rows), nrows, (1u << bits) - 1u,
        counts);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)row_offsets(counts, nrows, sums, first, s);
}

// Pass 2: the payload (rows + (4 + hi_bytes) * n bytes) into `out`.
extern "C" int tile_export_rows(const uint32_t* rows, long long nrows,
                                int bits, const uint8_t* counts,
                                const long long* first, long long n,
                                int hi_bytes, uint8_t* out, void* stream) {
  if (nrows > 0)
    export_rows_kernel<<<row_blocks(nrows), 32 * ROWS_PER_BLOCK, 0,
                         (cudaStream_t)stream>>>(
        reinterpret_cast<const uint4*>(rows), nrows, (1u << bits) - 1u,
        counts, first, n, hi_bytes, out);
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
