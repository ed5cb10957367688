// HK2 tile_seal: end of the stage-1 build.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:1443 (tile_seal =
// _dup_check_impl :1454 + _finalize_impl :1476 + tile_stats :749).
//
// Design: one 64-thread block per row, one thread per slot. Each thread
// folds its slot into the query layout
//   lo = rlo << (bits+1) | q << bits | min(count, max_val),  hi = rhi
// (q = the slot saw a high-quality observation; count is then the hq
// count, else the lq count), checks its tag pair against the later slots
// of the row held in shared memory (duplicate check), and the block
// reduces occupied / distinct-hq / total-hq into four global 64-bit
// counters with one atomicAdd each. One launch, then one 32-byte D2H.
//
// Bound: bytes. It reads the tag plane (512 B/row) and the hq/lq planes
// (512 B/row) once and writes the sealed rows (512 B/row).
#include "table.cuh"

__global__ void seal_kernel(const uint32_t* __restrict__ tag,
                            const uint32_t* __restrict__ hq,
                            const uint32_t* __restrict__ lq, int bits,
                            uint32_t* __restrict__ out,
                            unsigned long long* stats) {
  __shared__ uint32_t s_lo[TSLOTS];
  __shared__ uint32_t s_hi[TSLOTS];
  __shared__ int s_occ[TSLOTS];
  __shared__ unsigned long long s_acc[4];
  const size_t row = blockIdx.x;
  const int s = threadIdx.x;
  if (s < 4) s_acc[s] = 0;
  const uint32_t tlo = tag[row * TILE_WORDS + 2 * s];
  const uint32_t thi = tag[row * TILE_WORDS + 2 * s + 1];
  const uint32_t h = hq[row * TSLOTS + s];
  const uint32_t l = lq[row * TSLOTS + s];
  const bool occ = tlo != EMPTY_TAG && (h | l) != 0;
  const bool q = occ && h > 0;
  const uint32_t maxv = (1u << bits) - 1u;
  uint32_t cnt = q ? h : l;
  cnt = cnt < maxv ? cnt : maxv;
  s_lo[s] = tlo;
  s_hi[s] = thi;
  s_occ[s] = occ;
  __syncthreads();
  bool dup = false;
  if (occ)
    for (int t = s + 1; t < TSLOTS; ++t)
      dup |= s_occ[t] && s_lo[t] == tlo && s_hi[t] == thi;
  out[row * TILE_WORDS + 2 * s] =
      occ ? ((tlo << (bits + 1)) | ((uint32_t)q << bits) | cnt) : 0u;
  out[row * TILE_WORDS + 2 * s + 1] = occ ? thi : 0u;
  if (dup) s_acc[0] = 1;
  if (occ) atomicAdd(&s_acc[1], 1ull);
  if (q) {
    atomicAdd(&s_acc[2], 1ull);
    atomicAdd(&s_acc[3], (unsigned long long)cnt);
  }
  __syncthreads();
  if (s == 0) {
    if (s_acc[0]) atomicOr(&stats[0], 1ull);
    if (s_acc[1]) atomicAdd(&stats[1], s_acc[1]);
    if (s_acc[2]) atomicAdd(&stats[2], s_acc[2]);
    if (s_acc[3]) atomicAdd(&stats[3], s_acc[3]);
  }
}

extern "C" int tile_seal(const uint32_t* tag, const uint32_t* hq,
                         const uint32_t* lq, long long rows, int bits,
                         uint32_t* out, unsigned long long* stats,
                         void* stream) {
  if (rows > 0)
    seal_kernel<<<(unsigned)rows, TSLOTS, 0, (cudaStream_t)stream>>>(
        tag, hq, lq, bits, out, stats);
  return (int)cudaGetLastError();
}
