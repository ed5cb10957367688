// Shared device code of the flat bucket-4 table (K25, the JAX package's
// "v0" table, quorum_tpu/ops/ctable.py:51-560): a key's bucket and
// remainder (ctable.bucket_rem :180) and the slot claim of HK18's two
// entries.
//
// The table is flat u32 planes of 4 * 2^nb slots; slot j of bucket b is
// word 4b + j, so a bucket is one aligned 16-byte row. While it is built,
// keytag holds each slot's remainder (EMPTY_TAG = empty) beside the split
// quality counts hq / lq; sealed, one entry word a slot.
#pragma once
#include "table.cuh"

#define FLAT_BUCKET 4

// The full 2k-bit Feistel mix of a canonical mer (ctable.feistel_mix):
// the low nb bits are the bucket, the next rem_bits the remainder.
__device__ __forceinline__ void flat_bucket_rem(uint64_t key, int k, int nb,
                                                int rem_bits,
                                                unsigned long long* bucket,
                                                uint32_t* rem) {
  const uint32_t kmask = (1u << k) - 1u;
  uint32_t r = (uint32_t)(key & kmask);
  uint32_t l = (uint32_t)((key >> k) & kmask);
  const uint32_t C[4] = {0x9E3779B9u, 0x85EBCA6Bu, 0xC2B2AE35u, 0x27D4EB2Fu};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t f = mix32(r + C[i]) & kmask;
    uint32_t t = l ^ f;
    l = r;
    r = t;
  }
  const uint64_t full = ((uint64_t)l << k) | r;
  *bucket = full & ((1ull << nb) - 1ull);
  *rem = (uint32_t)((full >> nb) & ((1ull << rem_bits) - 1ull));
}

// The slot of `rem` in its 4-slot bucket `row`: the slot already holding
// it, else the first empty one, claimed with atomicCAS; -1 when the
// bucket holds four other keys. Slots fill in order and are never freed,
// so every lane of one key meets in one slot: a CAS that loses to the
// same remainder has matched, one that loses to another rescans. The row
// is read through L2 (__ldcg), where the atomics land.
__device__ __forceinline__ int flat_claim(uint32_t* row, uint32_t rem) {
  for (;;) {
    const uint4 t = __ldcg(reinterpret_cast<const uint4*>(row));
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
    int e = -1;
#pragma unroll
    for (int j = 0; j < FLAT_BUCKET; ++j) {
      if (w[j] == rem) return j;
      if (w[j] == EMPTY_TAG && e < 0) e = j;
    }
    if (e < 0) return -1;
    const uint32_t old = atomicCAS(row + e, EMPTY_TAG, rem);
    if (old == EMPTY_TAG || old == rem) return e;
  }
}
