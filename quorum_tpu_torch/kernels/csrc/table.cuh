// Shared device code of the tile-bucket table: the Feistel key hash
// (quorum_tpu/ops/ctable.py:151-198, 633-674), the preferred slot
// (ctable.py:938), the direction-generic mer arithmetic
// (quorum_tpu/ops/mer.py:104-190) and the one-row probe that HK3 and HK4
// share (ctable.tile_lookup_impl, ctable.py:677-696).
//
// A k-mer (k <= 31) is one uint64 of 2k bits; a table row is 128 u32
// words = 64 (lo, hi) slot pairs.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define TSLOTS 64
#define TILE_WORDS 128
#define EMPTY_TAG 0xFFFFFFFFu
#define EMPTY_PAIR 0xFFFFFFFFFFFFFFFFull

struct KeyParts {
  uint32_t addr;
  uint32_t rlo;
  uint32_t rhi;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ KeyParts key_parts(uint64_t key, int k, int rb,
                                              int bits) {
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
  uint64_t full = ((uint64_t)l << k) | r;
  uint64_t rem = full >> rb;
  int rl = 31 - bits;
  KeyParts p;
  p.addr = (uint32_t)(full & ((1ull << rb) - 1ull));
  p.rlo = (uint32_t)(rem & ((1ull << rl) - 1ull));
  p.rhi = (uint32_t)(rem >> rl);
  return p;
}

__device__ __forceinline__ int preferred_slot(uint32_t rlo, uint32_t rhi) {
  return (int)((rlo ^ (rlo >> 7) ^ (rhi << 3)) & (TSLOTS - 1));
}

__device__ __forceinline__ uint64_t canonical(uint64_t f, uint64_t r) {
  return f <= r ? f : r;
}

// Shift `code` in at the direction of travel d; the revcomp lane takes
// the complement at the opposite end.
__device__ __forceinline__ void dir_shift(uint64_t& f, uint64_t& r,
                                          uint32_t code, int d, int k) {
  const uint64_t mask = (1ull << (2 * k)) - 1ull;
  const int top = 2 * k - 2;
  if (d > 0) {
    f = ((f << 2) | code) & mask;
    r = (r >> 2) | ((uint64_t)(3 - code) << top);
  } else {
    f = (f >> 2) | ((uint64_t)code << top);
    r = ((r << 2) | (3 - code)) & mask;
  }
}

__device__ __forceinline__ int dir_base0(uint64_t f, int d, int k) {
  int i = d > 0 ? 0 : k - 1;
  return (int)((f >> (2 * i)) & 3ull);
}

__device__ __forceinline__ void dir_replace0(uint64_t& f, uint64_t& r,
                                             uint32_t code, int d, int k) {
  int i = d > 0 ? 0 : k - 1;
  int ri = k - 1 - i;
  f = (f & ~(3ull << (2 * i))) | ((uint64_t)code << (2 * i));
  r = (r & ~(3ull << (2 * ri))) | ((uint64_t)(3 - code) << (2 * ri));
}

// The value word (count << 1) | qual of the key in its 512-byte row, or
// 0: 32 16-byte loads over the 64 slots, stopping at the match (a key
// occupies at most one slot of its row).
__device__ __forceinline__ uint32_t probe_row(const uint32_t* __restrict__ rows,
                                              KeyParts p, int bits) {
  const uint4* row = reinterpret_cast<const uint4*>(rows) +
                     (size_t)p.addr * (TILE_WORDS / 4);
  const uint32_t maxv = (1u << bits) - 1u;
#pragma unroll 4
  for (int j = 0; j < TILE_WORDS / 4; ++j) {
    uint4 w = __ldg(row + j);
    uint32_t c0 = w.x & maxv, c1 = w.z & maxv;
    if (c0 && (w.x >> (bits + 1)) == p.rlo && w.y == p.rhi)
      return (c0 << 1) | ((w.x >> bits) & 1u);
    if (c1 && (w.z >> (bits + 1)) == p.rlo && w.w == p.rhi)
      return (c1 << 1) | ((w.z >> bits) & 1u);
  }
  return 0;
}
