// HK2 tile_seal: end of the stage-1 build.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:1443 (tile_seal =
// _dup_check_impl :1454 + _finalize_impl :1476 + tile_stats :749), and
// quorum_tpu/ops/sketch.py:348 (singleton_entries: the build slots with
// exactly one observation, counted before the fold -- in a two-pass
// prefiltered build, the sketch's false passes).
//
// Design: 64-thread blocks, one thread per slot, each block walking rows
// with a grid stride. Each thread folds its slot into the query layout
//   lo = rlo << (bits+1) | q << bits | min(count, max_val),  hi = rhi
// (q = the slot saw a high-quality observation; count is then the hq
// count, else the lq count) and checks its tag pair against the later
// slots of the row held in shared memory (duplicate check). The
// statistics (occupied / distinct-hq / total-hq / single-observation
// slots, and the duplicate flag) stay in registers across the block's
// rows -- warp ballots and popcounts for the counts -- and each block
// adds them once to five global 64-bit counters: a few thousand
// same-address atomics in all, not five per row. One launch, then one
// 40-byte D2H.
//
// Bound: bytes. It reads the tag plane (512 B/row) and the hq/lq planes
// (512 B/row) once and writes the sealed rows (512 B/row).
#include "table.cuh"

// 64-thread blocks: 32 resident on an SM, 132 SMs on an H100 SXM
#define SEAL_BLOCKS (132 * 32)

__global__ void seal_kernel(const uint32_t* __restrict__ tag,
                            const uint32_t* __restrict__ hq,
                            const uint32_t* __restrict__ lq, long long rows,
                            int bits, uint32_t* __restrict__ out,
                            unsigned long long* stats) {
  __shared__ uint32_t s_lo[TSLOTS];
  __shared__ uint32_t s_hi[TSLOTS];
  __shared__ int s_occ[TSLOTS];
  __shared__ unsigned long long s_acc[5];
  const int s = threadIdx.x;
  if (s < 5) s_acc[s] = 0;
  const uint32_t maxv = (1u << bits) - 1u;
  bool dup = false;
  unsigned long long n_occ = 0, n_q = 0, n_one = 0, sum = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const uint32_t tlo = tag[row * TILE_WORDS + 2 * s];
    const uint32_t thi = tag[row * TILE_WORDS + 2 * s + 1];
    const uint32_t h = hq[row * TSLOTS + s];
    const uint32_t l = lq[row * TSLOTS + s];
    const bool occ = tlo != EMPTY_TAG && (h | l) != 0;
    const bool q = occ && h > 0;
    uint32_t cnt = q ? h : l;
    cnt = cnt < maxv ? cnt : maxv;
    __syncthreads();  // the previous row's duplicate check is done
    s_lo[s] = tlo;
    s_hi[s] = thi;
    s_occ[s] = occ;
    __syncthreads();
    if (occ)
      for (int t = s + 1; t < TSLOTS; ++t)
        dup |= s_occ[t] && s_lo[t] == tlo && s_hi[t] == thi;
    out[row * TILE_WORDS + 2 * s] =
        occ ? ((tlo << (bits + 1)) | ((uint32_t)q << bits) | cnt) : 0u;
    out[row * TILE_WORDS + 2 * s + 1] = occ ? thi : 0u;
    n_occ += __popc(__ballot_sync(0xFFFFFFFFu, occ));
    n_q += __popc(__ballot_sync(0xFFFFFFFFu, q));
    n_one += __popc(__ballot_sync(0xFFFFFFFFu, occ && h + l == 1u));
    if (q) sum += cnt;
  }
  for (int d = 16; d > 0; d >>= 1)
    sum += __shfl_down_sync(0xFFFFFFFFu, sum, d);
  __syncthreads();  // s_acc is cleared
  if (dup) s_acc[0] = 1;
  if ((s & 31) == 0) {
    if (n_occ) atomicAdd(&s_acc[1], n_occ);
    if (n_q) {
      atomicAdd(&s_acc[2], n_q);
      atomicAdd(&s_acc[3], sum);
    }
    if (n_one) atomicAdd(&s_acc[4], n_one);
  }
  __syncthreads();
  if (s == 0) {
    if (s_acc[0]) atomicOr(&stats[0], 1ull);
    if (s_acc[1]) atomicAdd(&stats[1], s_acc[1]);
    if (s_acc[2]) atomicAdd(&stats[2], s_acc[2]);
    if (s_acc[3]) atomicAdd(&stats[3], s_acc[3]);
    if (s_acc[4]) atomicAdd(&stats[4], s_acc[4]);
  }
}

extern "C" int tile_seal(const uint32_t* tag, const uint32_t* hq,
                         const uint32_t* lq, long long rows, int bits,
                         uint32_t* out, unsigned long long* stats,
                         void* stream) {
  if (rows > 0)
    seal_kernel<<<(unsigned)(rows < SEAL_BLOCKS ? rows : SEAL_BLOCKS), TSLOTS,
                  0, (cudaStream_t)stream>>>(tag, hq, lq, rows, bits, out,
                                             stats);
  return (int)cudaGetLastError();
}
