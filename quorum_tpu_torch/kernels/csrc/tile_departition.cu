// HK13 tile_departition: rebase one partition pass's sealed table onto the
// global geometry of the partitioned multi-pass build.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:1566
// (tile_departition_rows). Pass `part` of P = 2^g counted only the mers
// whose remainder's low g bits, at the local geometry rb_local, equal
// `part` (HK1's partition filter). At the global geometry rb_local + g
// those bits are the top bits of the row address, so the pass's rows ARE
// the global rows [part * rows_local, (part + 1) * rows_local), and each
// entry's global remainder is its local remainder shifted right by g.
//
// For each occupied slot (count = lo & max_val != 0) of the sealed local
// plane: rebuild the local remainder rem = hi:rlo from (lo, hi) (rlo =
// lo >> (bits + 1), rlo_bits = 31 - bits), flag `bad` unless its low g
// bits equal `part`, shift it right by g, and repack it as the global
// geometry's (rlo, hi), hi masked to the global rem_high width; the
// value and qual bits of lo stay. An empty slot becomes (0, 0). All u32
// arithmetic with logical shifts (the port stores rows as int32).
//
// Design: IN PLACE (the JAX package returns a new plane; the local plane
// is dead once this pass's shard is exported, so the port saves a copy of
// it), one thread per 16-byte vector = two (lo, hi) slot pairs, a
// grid-stride loop, a vector written back only where a word changes;
// `bad` comes back through one atomicOr per thread that saw a foreign
// entry (none, unless the partition routing is broken).
//
// Bound: bytes. The local rows read once, and each 32-byte sector that
// holds an occupied entry written once.
#include "table.cuh"

struct Rebase {
  uint32_t maxv, vqmask, rlmask, gmask, part, himask;
  int bits, rl, g;
};

// One slot pair; returns true for a foreign entry.
__device__ __forceinline__ bool rebase(const Rebase& r, uint32_t& lo,
                                       uint32_t& hi) {
  if ((lo & r.maxv) == 0u) {
    lo = hi = 0u;
    return false;
  }
  const uint32_t vq = lo & r.vqmask;
  const uint32_t rem_lo = (lo >> (r.bits + 1)) | (hi << r.rl);
  const uint32_t rem_hi = hi >> (32 - r.rl);
  const bool bad = (rem_lo & r.gmask) != r.part;
  const uint32_t glo = (rem_lo >> r.g) | (rem_hi << (32 - r.g));
  const uint32_t ghi = rem_hi >> r.g;
  lo = ((glo & r.rlmask) << (r.bits + 1)) | vq;
  hi = ((glo >> r.rl) | (ghi << (32 - r.rl))) & r.himask;
  return bad;
}

__global__ void departition_kernel(uint4* rows, long long n4, Rebase r,
                                   int* bad) {
  bool foreign = false;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const uint4 v = rows[i];
    uint4 u = v;
    foreign |= rebase(r, u.x, u.y);
    foreign |= rebase(r, u.z, u.w);
    if (u.x != v.x || u.y != v.y || u.z != v.z || u.w != v.w) rows[i] = u;
  }
  if (foreign) atomicOr(bad, 1);
}

// rows: the sealed local plane (nrows = 2^rb_local rows of 128 u32), in
// place; g = log2(P) in [1, 8]; hi_bits = the global geometry's rem_high
// width, max(0, 2k - (rb_local + g) - rlo_bits); bad: int32, zeroed by
// the caller.
extern "C" int tile_departition(uint32_t* rows, long long nrows, int bits,
                                int g, int part, int hi_bits, int* bad,
                                void* stream) {
  Rebase r;
  r.bits = bits;
  r.rl = 31 - bits;
  r.g = g;
  r.maxv = (1u << bits) - 1u;
  r.vqmask = (1u << (bits + 1)) - 1u;
  r.rlmask = (1u << r.rl) - 1u;
  r.gmask = (1u << g) - 1u;
  r.part = (uint32_t)part;
  r.himask = hi_bits >= 32 ? 0xFFFFFFFFu : (1u << hi_bits) - 1u;
  const long long n4 = nrows * (TILE_WORDS / 4);
  const long long blocks = (n4 + 255) / 256;
  if (n4 > 0)
    departition_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16),
                         256, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<uint4*>(rows), n4, r, bad);
  return (int)cudaGetLastError();
}
