// HK9 batch_aggregate: a batch's distinct canonical mers with their exact
// per-batch multiplicities.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:1016 (_aggregate_obs_impl:
// a device sort by key, segment sums of the hq/lq adds, compaction to
// distinct lanes), reached through quorum_tpu/ops/sketch.py:158
// (_distinct_lanes, at cap = n).
//
// Design: a batch-local open-addressing hash in scratch memory takes the
// place of the sort. One thread per window end reads its window off the
// packed wire (table.cuh wire_window, as HK1 does), claims the key's slot
// with one 64-bit atomicCAS (linear probing from a splitmix64 hash of the
// key) and adds its observation to the slot's hq or lq counter with
// atomicAdd. The slot array is the lane array: an empty slot (key -1) is
// an invalid lane, so nothing is compacted, and lane order is free because
// every consumer (HK10, HK11's inline entry) is order-independent. The
// launcher clears the scratch first; the wrapper sizes it to a power of
// two at least twice the batch's windows, so a probe always ends.
//
// Bound: bytes. The wire in and the distinct lanes out (16 bytes each);
// the scratch hash's clearing and its per-observation traffic belong to
// this design, not to the function.
#include "table.cuh"

#define EMPTY_KEY 0xFFFFFFFFFFFFFFFFull

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__global__ void aggregate_kernel(Wire w, int k, int slots_log2,
                                 unsigned long long* keys, uint32_t* hq,
                                 uint32_t* lq) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)w.b * w.L) return;
  uint64_t key;
  bool qual;
  if (!wire_window(w, (int)(idx / w.L), (int)(idx % w.L), k, &key, &qual))
    return;
  const uint64_t mask = (1ull << slots_log2) - 1ull;
  uint64_t s = splitmix64(key) & mask;
  for (;;) {
    unsigned long long cur =
        *reinterpret_cast<volatile unsigned long long*>(keys + s);
    if (cur == EMPTY_KEY) cur = atomicCAS(keys + s, EMPTY_KEY, key);
    if (cur == EMPTY_KEY || cur == key) break;
    s = (s + 1) & mask;
  }
  atomicAdd(qual ? hq + s : lq + s, 1u);
}

extern "C" int batch_aggregate(const uint8_t* wire, int b, int L,
                               long long off_nmask, long long off_hq,
                               long long off_len, int k, int slots_log2,
                               unsigned long long* keys, uint32_t* hq,
                               uint32_t* lq, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t slots = (size_t)1 << slots_log2;
  cudaMemsetAsync(keys, 0xFF, slots * sizeof(unsigned long long), st);
  cudaMemsetAsync(hq, 0, slots * sizeof(uint32_t), st);
  cudaMemsetAsync(lq, 0, slots * sizeof(uint32_t), st);
  const long long n = (long long)b * L;
  if (n > 0)
    aggregate_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        Wire{wire, b, L, off_nmask, off_hq, off_len}, k, slots_log2, keys,
        hq, lq);
  return (int)cudaGetLastError();
}
