// HK20 flat_finalize: end of a flat-table build.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:404 (finalize_build)
// and :463 (table_stats).
//
// Design: one thread per bucket (a 16-byte row of four slots), 256-thread
// blocks walking the planes with a grid stride, loads the row's four
// keytag words at once and writes the row's four entry words
//   rem << (bits+1) | q << bits | min(max(count, 1), max_val)
// at once (q = the slot saw a high-quality observation; count is then
// the hq count, else the lq count; 0 for an empty slot), and keeps its
// share of the statistics (occupied, distinct-hq, total-hq) in
// registers; each block adds them once to three global 64-bit counters
// (table.cuh block_add: warp shuffles, then one atomic a block and
// value), as HK2 does. A slot reads hq only when keytag says it is
// occupied, and lq only when it is occupied with no hq count, so the
// sparse table's empty slots cost their keytag word and their entry
// word alone. The totals are exact integers; JAX sums total-hq in
// float32, the same value below 2^24.
//
// Bound: bytes. keytag read and entries written (8 B a slot), plus the
// 32-byte sectors of hq that hold an occupied slot and those of lq that
// hold an occupied slot without hq.
#include "flat.cuh"

#define FLAT_BLOCKS (132 * 16)

__global__ void flat_finalize_kernel(const uint4* __restrict__ tag,
                                     const uint32_t* __restrict__ hq,
                                     const uint32_t* __restrict__ lq,
                                     long long rows, int bits, int rem_bits,
                                     uint4* __restrict__ entries,
                                     unsigned long long* stats) {
  const uint32_t maxv = (1u << bits) - 1u;
  const uint32_t rmask = rem_bits ? (uint32_t)((1ull << rem_bits) - 1ull) : 0u;
  unsigned long long v[3] = {0ull, 0ull, 0ull};
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows; r += (long long)gridDim.x * blockDim.x) {
    const uint4 t4 = tag[r];
    const uint32_t t[FLAT_BUCKET] = {t4.x, t4.y, t4.z, t4.w};
    uint32_t e[FLAT_BUCKET];
#pragma unroll
    for (int j = 0; j < FLAT_BUCKET; ++j) {
      e[j] = 0u;
      if (t[j] == EMPTY_TAG) continue;
      const long long i = FLAT_BUCKET * r + j;
      const uint32_t h = hq[i];
      const bool q = h > 0u;
      uint32_t cnt = q ? h : lq[i];
      cnt = cnt < maxv ? cnt : maxv;
      cnt = cnt > 1u ? cnt : 1u;
      e[j] = ((t[j] & rmask) << (bits + 1)) | ((uint32_t)q << bits) | cnt;
      v[0] += 1ull;
      v[1] += q;
      v[2] += q ? cnt : 0u;
    }
    entries[r] = make_uint4(e[0], e[1], e[2], e[3]);
  }
  block_add<3>(v, stats);
}

static unsigned blocks_for(long long n) {
  const long long b = (n + 255) / 256;
  return (unsigned)(b < FLAT_BLOCKS ? b : FLAT_BLOCKS);
}

extern "C" int flat_finalize(const uint32_t* tag, const uint32_t* hq,
                             const uint32_t* lq, long long size, int bits,
                             int rem_bits, uint32_t* entries,
                             unsigned long long* stats, void* stream) {
  // size is 4 * 2^nb; the wrapper checks keytag's and the entries'
  // 16-byte alignment
  const long long rows = size / FLAT_BUCKET;
  if (rows > 0)
    flat_finalize_kernel<<<blocks_for(rows), 256, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const uint4*>(tag), hq, lq, rows, bits, rem_bits,
        reinterpret_cast<uint4*>(entries), stats);
  return (int)cudaGetLastError();
}
