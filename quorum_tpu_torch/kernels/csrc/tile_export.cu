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
// with n = the occupied slots in all. It reuses pass 1's counts and scan;
// its own pass, one warp per row again, ranks each occupied slot among
// the row's occupied slots before it (two ballots and a popcount) and
// writes its triplet at first[row] + rank when that is below cap.
//
// Bound: bytes. The least traffic reads the sealed rows once (512 B a
// row) and writes the payload once (compact: the three cap-lane planes);
// pass 1 reads the rows a second time.
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

__global__ void compact_kernel(const uint4* __restrict__ rows,
                               long long nrows, uint32_t maxv,
                               const long long* __restrict__ first,
                               long long cap, int* __restrict__ addr,
                               uint32_t* __restrict__ lo,
                               uint32_t* __restrict__ hi) {
  const long long row =
      (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= nrows) return;  // whole warps
  const uint4 w = rows[row * 32 + lane];
  const bool o0 = (w.x & maxv) != 0u, o1 = (w.z & maxv) != 0u;
  const unsigned m0 = __ballot_sync(FULL_MASK, o0);
  const unsigned m1 = __ballot_sync(FULL_MASK, o1);
  const unsigned below = (1u << lane) - 1u;  // slots 2j, 2j + 1 for j < lane
  const long long e0 = first[row] + __popc(m0 & below) + __popc(m1 & below);
  const long long e1 = e0 + (o0 ? 1 : 0);
  if (o0 && e0 < cap) {
    addr[e0] = (int)row;
    lo[e0] = w.x;
    hi[e0] = w.y;
  }
  if (o1 && e1 < cap) {
    addr[e1] = (int)row;
    lo[e1] = w.z;
    hi[e1] = w.w;
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

// Compact entry, after pass 1: (addr, lo, hi) of cap lanes each, zeroed by
// the caller.
extern "C" int tile_export_compact(const uint32_t* rows, long long nrows,
                                   int bits, const long long* first,
                                   long long cap, int* addr, uint32_t* lo,
                                   uint32_t* hi, void* stream) {
  if (nrows > 0 && cap > 0)
    compact_kernel<<<row_blocks(nrows), 32 * ROWS_PER_BLOCK, 0,
                     (cudaStream_t)stream>>>(
        reinterpret_cast<const uint4*>(rows), nrows, (1u << bits) - 1u,
        first, cap, addr, lo, hi);
  return (int)cudaGetLastError();
}
