// HK19 flat_lookup: batched exact lookup in the sealed flat table.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:306 (lookup, jitted over
// lookup_impl :283).
//
// Design: one thread per canonical key hashes it inline (flat.cuh
// flat_bucket_rem), loads its bucket's four entry words as one aligned
// 16-byte row and compares each occupied entry's remainder with the
// key's: the value word (count << 1) | qual of the match, else 0 (a key
// occupies at most one slot).
//
// Bound: bytes. 8 B of key in and 4 B of value out per lookup, plus one
// 32-byte sector for each distinct bucket row touched.
#include "flat.cuh"

__global__ void flat_lookup_kernel(const uint32_t* __restrict__ entries,
                                   const long long* __restrict__ keys,
                                   long long n, int k, int nb, int rem_bits,
                                   int bits, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned long long b;
  uint32_t rem;
  flat_bucket_rem((uint64_t)keys[i], k, nb, rem_bits, &b, &rem);
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(entries) + b);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
  const uint32_t vmask = (1u << (bits + 1)) - 1u, maxv = (1u << bits) - 1u;
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < FLAT_BUCKET; ++j)
    if ((w[j] & vmask) != 0u && (w[j] >> (bits + 1)) == rem)
      v = ((w[j] & maxv) << 1) | ((w[j] >> bits) & 1u);
  out[i] = v;
}

extern "C" int flat_lookup(const uint32_t* entries, const long long* keys,
                           long long n, int k, int nb, int rem_bits, int bits,
                           uint32_t* out, void* stream) {
  if (n > 0)
    flat_lookup_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(entries, keys, n, k, nb,
                                                 rem_bits, bits, out);
  return (int)cudaGetLastError();
}
