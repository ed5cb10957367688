// HK14 pack_finish: one stage-2 batch's result in one u32 buffer, the
// batch's single device-to-host copy.
//
// Replaces the TPU path quorum_tpu/models/corrector.py:2038
// (_pack_finish_lean, K14, fused into _correct_core :1916-1920) and the
// status merge of _bwd_epilogue (:1212): a read's status is its forward
// lane's where that is not OK, else its backward lane's.
//
// Layout (_pack_finish_lean's): [maxn][total] [B x start << 16 | end]
// [B x status << 16 | f_n] [B x b_n] [cap x (pos + POS_BIAS) << 16 |
// meta], every field cut to 16 bits; read i's forward then backward
// entries start at the exclusive prefix sum of f_n + b_n; entries past
// cap are dropped (the host sees total > cap and packs again with room),
// and the slots from total to cap are zero. maxn is the longest log, or
// maxe + 1 where HK4 flagged an overflow, which the host refuses.
//
// Design: two launches of ceil(B / PACK_TILE) blocks, a tile of
// PACK_TILE reads a block and one read a thread (a reduce, then a scan
// over the tiles' sums). The first reduces each tile's f_n + b_n and
// longest log into one int64 word of `sums`, at the tile's first read.
// In the second, a block adds the sums of the tiles before its own (B /
// PACK_TILE words at most, from L2), so no block waits on another, none
// needs a ticket, a status word or zeroed scratch, no order of the blocks
// can deadlock, and the work stays linear in B at any --batch-size (one
// launch whose blocks each reduced every count before their tile read
// B^2 / (2 PACK_TILE) words: 1 GB at B = 2^18). A block then scans its
// tile (table.cuh block_excl_scan), writes its reads' three words and
// merged status with coalesced stores, and keeps its reads' entry
// offsets in shared memory; its threads then walk the tile's entry
// slots, which are contiguous in the buffer (each read's forward then
// backward entries): thread t takes slot t, t + PACK_TILE, ..., finds the
// slot's read by a binary search of the offsets, and copies the entry,
// so that the reads of a read's log and the writes to the buffer are
// contiguous, with no division by maxe and as many entries in flight as
// threads. The last block, whose prefix holds every other read, also
// takes the longest log (a block max of the tiles' maxima), writes maxn
// and total, and zeroes the slots from total to cap.
//
// Bound: bytes, a few hundred KB a batch (24 B a read and 8 B a live
// entry in, the buffer and the status out), so at the main path's shapes
// a launch's latency, not the card's memory rate, sets its time.
#include "table.cuh"

#define PACK_TILE 256  // reads a block
#define POS_BIAS 4

// The block's max of v (blockDim.x a multiple of 32); every thread of the
// block must call it.
__device__ int block_max(int v) {
  __shared__ int wmax[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(FULL_MASK, v, o));
  if (lane == 0) wmax[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < nw ? wmax[lane] : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      v = max(v, __shfl_xor_sync(FULL_MASK, v, o));
    if (lane == 0) wmax[0] = v;
  }
  __syncthreads();
  return wmax[0];
}

// Tile blockIdx.x's f_n + b_n (low 32 bits) and longest log (high 32
// bits) into sums[blockIdx.x * PACK_TILE] (a tile holds at most
// 2 PACK_TILE maxe < 2^31 entries).
__global__ void __launch_bounds__(PACK_TILE) pack_sums_kernel(
    const int* __restrict__ f_n, const int* __restrict__ b_n, int B,
    long long* __restrict__ sums) {
  const int i = blockIdx.x * PACK_TILE + threadIdx.x;
  const int fn = i < B ? f_n[i] : 0, bn = i < B ? b_n[i] : 0;
  long long tile;
  block_excl_scan(fn + bn, &tile);
  const int mx = block_max(max(fn, bn));
  if (threadIdx.x == 0)
    sums[(long long)blockIdx.x * PACK_TILE] =
        ((long long)mx << 32) | (unsigned long long)tile;
}

__global__ void __launch_bounds__(PACK_TILE) pack_kernel(
    const int* __restrict__ start, const int* __restrict__ end,
    const int* __restrict__ status_f, const int* __restrict__ status_b,
    const int* __restrict__ f_n, const int* __restrict__ b_n,
    const int* __restrict__ overflow, const int* __restrict__ f_pos,
    const int* __restrict__ f_meta, const int* __restrict__ b_pos,
    const int* __restrict__ b_meta, const long long* __restrict__ sums,
    int B, int maxe, long long cap, uint32_t* __restrict__ buf,
    int* __restrict__ status) {
  __shared__ int incl[PACK_TILE];  // the tile's inclusive entry counts
  __shared__ int fns[PACK_TILE];
  const int t = threadIdx.x;
  const int t0 = blockIdx.x * PACK_TILE;
  const bool last = blockIdx.x == gridDim.x - 1;
  // the entries of the tiles before this one; the last block also takes
  // every tile's longest log
  long long before = 0;
  int mx = 0;
  const int nt = last ? gridDim.x : blockIdx.x;
  for (int v = t; v < nt; v += PACK_TILE) {
    const long long s = __ldg(sums + (long long)v * PACK_TILE);
    if (v < (int)blockIdx.x) before += s & 0xFFFFFFFFll;
    mx = max(mx, (int)(s >> 32));
  }
  const int i = t0 + t;
  int fn = 0, bn = 0;
  if (i < B) {
    fn = f_n[i];
    bn = b_n[i];
  }
  long long prefix, tile;
  block_excl_scan(before, &prefix);
  const long long off = prefix + block_excl_scan(fn + bn, &tile);
  uint32_t* h1 = buf + 2;
  uint32_t* h2 = h1 + B;
  uint32_t* h3 = h2 + B;
  uint32_t* flat = h3 + B;
  if (i < B) {
    const int sf = status_f[i];
    const int st = sf != 0 ? sf : status_b[i];
    status[i] = st;
    h1[i] = ((uint32_t)start[i] << 16) | ((uint32_t)end[i] & 0xFFFFu);
    h2[i] = ((uint32_t)st << 16) | ((uint32_t)fn & 0xFFFFu);
    h3[i] = (uint32_t)bn & 0xFFFFu;
  }
  incl[t] = (int)(off - prefix) + fn + bn;
  fns[t] = fn;
  __syncthreads();
  // the tile's entries, slot by slot (the slots past cap are dropped)
  const long long n_slots = min(tile, cap - prefix);
  for (long long s = t; s < n_slots; s += PACK_TILE) {
    int lo = 0, hi = PACK_TILE - 1;  // the first read whose incl > s
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (incl[mid] > s) hi = mid;
      else lo = mid + 1;
    }
    const int j = (int)(s - (lo ? incl[lo - 1] : 0));
    const long long e = (long long)(t0 + lo) * maxe;
    const int fj = fns[lo];
    const int pos = j < fj ? f_pos[e + j] : b_pos[e + j - fj];
    const int meta = j < fj ? f_meta[e + j] : b_meta[e + j - fj];
    flat[prefix + s] = ((uint32_t)(pos + POS_BIAS) << 16) |
                       ((uint32_t)meta & 0xFFFFu);
  }
  if (last) {  // block-uniform
    const long long total = prefix + tile;
    mx = block_max(mx);
    if (t == 0) {
      buf[0] = (uint32_t)(*overflow ? max(mx, maxe + 1) : mx);
      buf[1] = (uint32_t)total;
    }
    for (long long s = total + t; s < cap; s += PACK_TILE) flat[s] = 0;
  }
}

extern "C" int pack_finish(const int* start, const int* end,
                           const int* status_f, const int* status_b,
                           const int* f_n, const int* b_n,
                           const int* overflow, const int* f_pos,
                           const int* f_meta, const int* b_pos,
                           const int* b_meta, int B, int maxe, long long cap,
                           uint32_t* buf, int* status, long long* sums,
                           void* stream) {
  // one block even for an empty batch: it writes maxn, total and the
  // zeroed entry area (`sums` holds max(B, 1) words)
  const unsigned grid = (unsigned)(B > 0 ? (B + PACK_TILE - 1) / PACK_TILE
                                         : 1);
  pack_sums_kernel<<<grid, PACK_TILE, 0, (cudaStream_t)stream>>>(f_n, b_n, B,
                                                                 sums);
  pack_kernel<<<grid, PACK_TILE, 0, (cudaStream_t)stream>>>(
      start, end, status_f, status_b, f_n, b_n, overflow, f_pos, f_meta,
      b_pos, b_meta, sums, B, maxe, cap, buf, status);
  return (int)cudaGetLastError();
}
