// HK3 tile_lookup: batched exact lookup in the sealed tile table.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:677 (tile_lookup_impl,
// jitted as tile_lookup :700 and inside _tile_parts_jit :1387 /
// corrector._position_sweep).
//
// Design: one thread per canonical key hashes it (table.cuh key_parts)
// and probes its one 512-byte row with 16-byte vector loads, stopping at
// the match; the same __device__ probe_row serves HK4. A warp per probe
// would coalesce the row read; this first version keeps one thread per
// key.
//
// Bound: bytes. 8 B of key in and 8 B of value out per lookup, plus one
// read of each 512-byte row touched.
#include "table.cuh"

__global__ void lookup_kernel(const uint32_t* __restrict__ rows,
                              const long long* __restrict__ keys, long long n,
                              int k, int rb, int bits,
                              long long* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = probe_row(rows, key_parts((uint64_t)keys[i], k, rb, bits), bits);
}

extern "C" int tile_lookup(const uint32_t* rows, const long long* keys,
                           long long n, int k, int rb, int bits,
                           long long* out, void* stream) {
  if (n > 0)
    lookup_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                    (cudaStream_t)stream>>>(rows, keys, n, k, rb, bits, out);
  return (int)cudaGetLastError();
}
