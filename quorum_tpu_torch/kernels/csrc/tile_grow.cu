// HK8 tile_grow: double the build table's rows and re-insert every slot.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:1521 (tile_grow_build:
// the per-chunk rehash _tile_grow_prep :1498, then _tile_round1 claim
// rounds into the doubled table).
//
// Design: one thread per old slot. The full hash is (rem << rb) | addr
// with rem = rhi:rlo, so doubling moves rem's low bit into the address's
// new top bit: addr' = addr | (rlo & 1) << rb, rlo' = rlo >> 1 | (rhi & 1)
// << (rlo_bits - 1), rhi' = rhi >> 1 (32-bit words, so the masks are
// implicit). A live slot (tag not empty, hq | lq != 0) claims its slot
// in the doubled table with table.cuh claim_add -- the 64-bit atomicCAS
// that HK1 uses -- and stores its hq and lq there. One launch per grow:
// no compaction, no chunk loop, no rounds. A row of the doubled table
// takes keys of one old row only, so it cannot overflow; `full` still
// reports a failed claim, and the wrapper raises on it.
//
// Bound: bytes. It reads the old tags and counters once (1 KiB per old
// row) and, per live key, touches one tag sector and one counter sector
// of the new table (32 B each, written once).
#include "table.cuh"

__global__ void grow_kernel(const uint2* __restrict__ tag,
                            const uint32_t* __restrict__ hq,
                            const uint32_t* __restrict__ lq,
                            long long n_slots, int rb, int rlo_bits,
                            uint32_t* ntag, uint32_t* nhq, uint32_t* nlq,
                            int* full) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const uint2 t = tag[i];  // (rlo, rhi)
  const uint32_t h = hq[i], l = lq[i];
  if (t.x == EMPTY_TAG || (h | l) == 0u) return;
  KeyParts p;
  p.addr = (uint32_t)(i / TSLOTS) | ((t.x & 1u) << rb);
  p.rlo = (t.x >> 1) | ((t.y & 1u) << (rlo_bits - 1));
  p.rhi = t.y >> 1;
  if (!claim_add(ntag, nhq, nlq, p, h, l)) *full = 1;
}

extern "C" int tile_grow(const uint32_t* tag, const uint32_t* hq,
                         const uint32_t* lq, long long rows, int rb,
                         int rlo_bits, uint32_t* ntag, uint32_t* nhq,
                         uint32_t* nlq, int* full, void* stream) {
  const long long n = rows * TSLOTS;
  if (n > 0)
    grow_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                  (cudaStream_t)stream>>>(
        reinterpret_cast<const uint2*>(tag), hq, lq, n, rb, rlo_bits, ntag,
        nhq, nlq, full);
  return (int)cudaGetLastError();
}
