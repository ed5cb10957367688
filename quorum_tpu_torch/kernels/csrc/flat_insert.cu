// HK18 flat_insert: counting into the flat bucket-4 table, and its grow.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:380 insert_observations:
// _bucket_rem_jit :376, _prep_obs :363, the claim rounds of _build_round
// :316 and _finish_obs :371; its grow entry replaces :434 grow_build
// (_grow_prep :420 and the re-insert rounds).
//
// Design: one thread per observation hashes its mer inline
// (flat.cuh flat_bucket_rem), finds its key's slot or claims the
// bucket's first empty one (flat_claim: a 16-byte row load through L2,
// then one atomicCAS on keytag), and adds one to hq or lq with an
// atomic. A lane whose bucket holds four other keys stays unplaced and
// sets `full`, JAX's pending overflow lane: the caller doubles the table
// and inserts again the valid lanes not placed. JAX's scatter-set claim
// lets XLA pick the winner among one slot's claimers; the CAS gives the
// first to arrive, so a key's slot within its bucket, and which lanes of
// an overflowing bucket stay pending, may differ from JAX's, never the
// key -> counts map or `full`. The grow entry takes one thread per old
// bucket (one 16-byte keytag row): an occupied slot moves to bucket
// b | (rem & 1) << nb with remainder rem >> 1 (ctable.rehash_grow), hq
// and lq verbatim. A doubled bucket receives the keys of one old bucket
// only, so the thread owns both of its bucket's images: it fills them
// in registers in slot order, with no atomic and no overflow, and
// stores each non-empty one as one 16-byte row. One launch replaces
// JAX's chunks and rounds.
//
// Bound: bytes. The insert reads each observation (8 B of mer, 1 B of
// qual, 1 B of valid), writes its placed byte, and touches each distinct
// 16-byte bucket row of keytag and the counts' 32-byte sectors once; the
// grow reads the old keytag once (4 B a slot), the 32-byte sectors of hq
// and lq that hold an occupied slot (an empty slot's counts are never
// read), and writes three words an entry (the doubled table's fill is
// its caller's).
#include "flat.cuh"

__global__ void flat_insert_kernel(const long long* __restrict__ keys,
                                   const uint8_t* __restrict__ qual,
                                   const uint8_t* __restrict__ valid,
                                   long long n, int k, int nb, int rem_bits,
                                   uint32_t* keytag, uint32_t* hq,
                                   uint32_t* lq, uint8_t* __restrict__ placed,
                                   int* full) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!valid[i]) {
      placed[i] = 0;
      continue;
    }
    unsigned long long b;
    uint32_t rem;
    flat_bucket_rem((uint64_t)keys[i], k, nb, rem_bits, &b, &rem);
    const int j = flat_claim(keytag + FLAT_BUCKET * b, rem);
    if (j < 0) {
      placed[i] = 0;
      *full = 1;
      continue;
    }
    atomicAdd((qual[i] ? hq : lq) + FLAT_BUCKET * b + j, 1u);
    placed[i] = 1;
  }
}

__global__ void flat_grow_kernel(const uint4* __restrict__ otag,
                                 const uint32_t* __restrict__ ohq,
                                 const uint32_t* __restrict__ olq,
                                 long long orows, uint4* __restrict__ ntag,
                                 uint32_t* __restrict__ nhq,
                                 uint32_t* __restrict__ nlq) {
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < orows; r += (long long)gridDim.x * blockDim.x) {
    const uint4 t4 = otag[r];
    const uint32_t t[FLAT_BUCKET] = {t4.x, t4.y, t4.z, t4.w};
    // the images: bucket r (rem's low bit 0) and r + 2^nb = r + orows;
    // constant indices only, so both stay in registers
    uint32_t lo[FLAT_BUCKET], hi[FLAT_BUCKET];
    int nlo = 0, nhi = 0;
#pragma unroll
    for (int x = 0; x < FLAT_BUCKET; ++x) lo[x] = hi[x] = EMPTY_TAG;
#pragma unroll
    for (int j = 0; j < FLAT_BUCKET; ++j) {
      if (t[j] == EMPTY_TAG) continue;
      const bool up = t[j] & 1u;
      const int s = up ? nhi++ : nlo++;
#pragma unroll
      for (int x = 0; x < FLAT_BUCKET; ++x) {
        if (x != s) continue;
        if (up)
          hi[x] = t[j] >> 1;
        else
          lo[x] = t[j] >> 1;
      }
      const long long o = FLAT_BUCKET * r + j;
      const long long d = FLAT_BUCKET * (up ? r + orows : r) + s;
      nhq[d] = ohq[o];
      nlq[d] = olq[o];
    }
    if (nlo) ntag[r] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    if (nhi) ntag[r + orows] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
}

static unsigned grid_for(long long n) {
  const long long blocks = (n + 255) / 256;
  return (unsigned)(blocks < 132 * 64 ? blocks : 132 * 64);
}

extern "C" int flat_insert(const long long* keys, const uint8_t* qual,
                           const uint8_t* valid, long long n, int k, int nb,
                           int rem_bits, uint32_t* keytag, uint32_t* hq,
                           uint32_t* lq, uint8_t* placed, int* full,
                           void* stream) {
  if (n > 0)
    flat_insert_kernel<<<grid_for(n), 256, 0, (cudaStream_t)stream>>>(
        keys, qual, valid, n, k, nb, rem_bits, keytag, hq, lq, placed, full);
  return (int)cudaGetLastError();
}

// osize = 4 * 2^nb; the wrapper checks both keytags' 16-byte alignment
// and that the new table is the empty doubled one.
extern "C" int flat_grow(const uint32_t* otag, const uint32_t* ohq,
                         const uint32_t* olq, long long osize, uint32_t* ntag,
                         uint32_t* nhq, uint32_t* nlq, void* stream) {
  const long long orows = osize / FLAT_BUCKET;
  if (orows > 0)
    flat_grow_kernel<<<grid_for(orows), 256, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const uint4*>(otag), ohq, olq, orows,
        reinterpret_cast<uint4*>(ntag), nhq, nlq);
  return (int)cudaGetLastError();
}
