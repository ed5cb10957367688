// HK7 tile_load: the v4/v5 database payload -> the sealed table, and its
// statistics.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:787
// (tile_rows_device_from_compact, with the host placement
// tile_compact_placement :806 and db_format._place_compact :627), the
// host decode of the hi byte planes of the v4/v5 read
// (quorum_tpu/io/db_format.py:835-849) and ctable.tile_stats :749.
//
// The payload is counts u8[rows], then n lo words (LE u32), then
// `hi_bytes` byte planes of n hi words (tile_export.cu). The host has
// already refused a payload whose counts exceed 64 in a row or do not
// sum to n, so every index below is in range.
//
// Design: table.cuh row_offsets scans the counts into each row's first
// entry index. Then a fixed grid of 8-warp blocks walks the rows, one
// warp per row: lane l fills slots 2l and 2l+1 -- entry first[row] + s
// for slot s < count, zeros past it -- and writes them as one 16-byte
// vector, so a warp writes its 512-byte row in one coalesced pass. The
// same pass sums (occupied, distinct hq, total hq) as exact 64-bit
// integers in registers, reduces them over the block, and adds them to
// the three global counters with one atomic per block (not per row,
// which is what serialises HK2 at load).
//
// Bound: bytes. It reads the payload once and writes the row plane once
// (512 B a row).
#include "table.cuh"

#define LOAD_WARPS 8
#define LOAD_MAX_BLOCKS 2048

__device__ __forceinline__ void load_entry(const uint8_t* lo_in,
                                           const uint8_t* hi_in, long long n,
                                           long long e, bool aligned,
                                           int hi_bytes, uint32_t& lo,
                                           uint32_t& hi) {
  if (aligned) {
    lo = *reinterpret_cast<const uint32_t*>(lo_in + 4 * e);
  } else {
    lo = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) lo |= (uint32_t)lo_in[4 * e + j] << (8 * j);
  }
  hi = 0;
  for (int j = 0; j < hi_bytes; ++j)
    hi |= (uint32_t)hi_in[j * n + e] << (8 * j);
}

__global__ void load_kernel(const uint8_t* __restrict__ payload,
                            long long nrows, long long n, int hi_bytes,
                            int bits, const long long* __restrict__ first,
                            uint4* __restrict__ rows,
                            unsigned long long* stats) {
  __shared__ unsigned long long part[LOAD_WARPS][3];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t maxv = (1u << bits) - 1u;
  const uint8_t* lo_in = payload + nrows;
  const uint8_t* hi_in = lo_in + 4 * n;
  const bool aligned = (nrows & 3) == 0;
  unsigned long long occ = 0, dhq = 0, thq = 0;
  for (long long row = (long long)blockIdx.x * LOAD_WARPS + wid; row < nrows;
       row += (long long)gridDim.x * LOAD_WARPS) {
    const int count = payload[row];
    const long long base = first[row];
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * lane + h;
      if (s < count) {
        load_entry(lo_in, hi_in, n, base + s, aligned, hi_bytes, w[2 * h],
                   w[2 * h + 1]);
        const uint32_t c = w[2 * h] & maxv;
        if (c) {
          ++occ;
          if ((w[2 * h] >> bits) & 1u) {
            ++dhq;
            thq += c;
          }
        }
      }
    }
    rows[row * 32 + lane] = make_uint4(w[0], w[1], w[2], w[3]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    occ += __shfl_down_sync(FULL_MASK, occ, o);
    dhq += __shfl_down_sync(FULL_MASK, dhq, o);
    thq += __shfl_down_sync(FULL_MASK, thq, o);
  }
  if (lane == 0) {
    part[wid][0] = occ;
    part[wid][1] = dhq;
    part[wid][2] = thq;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned long long sum = 0;
    for (int v = 0; v < LOAD_WARPS; ++v) sum += part[v][threadIdx.x];
    if (sum) atomicAdd(stats + threadIdx.x, sum);
  }
}

// stats: int64[3] zeroed by the caller = (occupied, distinct_hq,
// total_hq); sums: ceil(rows / SCAN_CHUNK) int64 scratch; first:
// int64[rows + 1] scratch.
extern "C" int tile_load(const uint8_t* payload, long long nrows, long long n,
                         int hi_bytes, int bits, long long* sums,
                         long long* first, uint32_t* rows,
                         unsigned long long* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = row_offsets(payload, nrows, sums, first, s);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (nrows + LOAD_WARPS - 1) / LOAD_WARPS;
  if (blocks > LOAD_MAX_BLOCKS) blocks = LOAD_MAX_BLOCKS;
  if (blocks > 0)
    load_kernel<<<(unsigned)blocks, 32 * LOAD_WARPS, 0, s>>>(
        payload, nrows, n, hi_bytes, bits, first,
        reinterpret_cast<uint4*>(rows), stats);
  return (int)cudaGetLastError();
}
