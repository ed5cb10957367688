// Shared device code of the tile-bucket table: the Feistel key hash
// (quorum_tpu/ops/ctable.py:151-198, 633-674), the preferred slot
// (ctable.py:938), the direction-generic mer arithmetic
// (quorum_tpu/ops/mer.py:104-190), the constant-time window extraction
// from the packed wire that HK1, HK5, HK9, HK11 and HK15 share
// (ctable.extract_observations_impl, ctable.py:1174),
// HK3's one-row probe, the warp-cooperative one of HK4 and HK16 and the
// slot-pair match they share with HK5's line probes
// (ctable.tile_lookup_impl, ctable.py:677-696) with their two row
// accessors (one plane, or a table sharded by leading row bits:
// quorum_tpu/parallel/tile_sharded.py:706 routed_lookup_local), the slot
// claim that HK1, HK8 and HK11 share, the count-min sketch hash of HK10
// and HK11 (quorum_tpu/ops/sketch.py:111-132), a one-atomic-per-block
// sum, the warp's 64-key sort that HK2 and HK6 share, and HK7's
// exclusive scan of per-row entry counts.
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
#define FULL_MASK 0xFFFFFFFFu

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

// The remainder's low 32 bits (rlo holds its low 31 - bits of them): the
// partition filter's bits (quorum_tpu/ops/ctable.py:1195 partition_mask).
__device__ __forceinline__ uint32_t rem_low(KeyParts p, int bits) {
  return p.rlo | (p.rhi << (31 - bits));
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

// One batch's packed wire (quorum_tpu_torch/io/packing.py): b rows of
// 2-bit codes (ceil(L/4) bytes each), then the N mask, the qual >=
// threshold plane (ceil(L/8) bytes each) and the little-endian u32 lengths
// at the given offsets.
struct Wire {
  const uint8_t* p;
  int b, L;
  long long off_nmask, off_hq, off_len;
};

__device__ __forceinline__ int wire_len(const Wire& w, int i) {
  const uint8_t* lb = w.p + w.off_len + 4ll * i;
  return (int)((uint32_t)lb[0] | ((uint32_t)lb[1] << 8) |
               ((uint32_t)lb[2] << 16) | ((uint32_t)lb[3] << 24));
}

// The little-endian 64 bits of the wire at byte `at`, zero past its end
// (off_len + 4b bytes): one 8-byte load where the word is aligned and
// inside the wire (every word but the last few, on a torch allocation),
// else byte loads.
__device__ __forceinline__ uint64_t wire_word(const Wire& w, long long at) {
  const long long end = w.off_len + 4ll * w.b;
  const uint8_t* q = w.p + at;
  if (at + 8 <= end && ((uintptr_t)q & 7u) == 0)
    return __ldg(reinterpret_cast<const unsigned long long*>(q));
  uint64_t x = 0;
  for (int j = 0; j < 8 && at + j < end; ++j)
    x |= (uint64_t)__ldg(q + j) << (8 * j);
  return x;
}

// `n` (< 64) bits of the wire from wire bit `bit` (bit b of byte j is
// wire bit 8j + b): one or two words.
__device__ __forceinline__ uint64_t wire_bits(const Wire& w, long long bit,
                                              int n) {
  const long long at = (bit >> 6) << 3;
  const int sh = (int)(bit & 63);
  uint64_t x = wire_word(w, at) >> sh;
  if (sh + n > 64) x |= wire_word(w, at + 8) << (64 - sh);
  return x & ((1ull << n) - 1ull);
}

// x's 32 2-bit groups in reverse order (group m -> group 31 - m).
__device__ __forceinline__ uint64_t rev2(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) |
         ((x & 0x5555555555555555ull) << 1);
}

// Read i's three rows of the wire as wire bit offsets, and its length.
struct ReadWire {
  long long code, nmask, hq;
  int len;
};

__device__ __forceinline__ ReadWire read_wire(const Wire& w, int i) {
  const long long c4 = (w.L + 3) / 4, c8 = (w.L + 7) / 8;
  return ReadWire{8 * (long long)i * c4, 8 * (w.off_nmask + i * c8),
                  8 * (w.off_hq + i * c8), wire_len(w, i)};
}

// The canonical mer and its qual bit (all k bases high quality) of the
// window of read `r` that ends at position p, read straight off the wire
// in constant time; false where there is no window (p < k - 1, p past
// the read, or a non-ACGT base in it). The codes sit 2 bits a base at
// bit 2 pos of the read's row, so the 2k bits from the window's first
// base X hold the oldest base lowest: the reverse-complement word is ~X,
// the forward word X with its 2-bit groups reversed (the newest base at
// bits 0-1). The N mask and the qual plane give k-bit extracts.
__device__ __forceinline__ bool read_window(const Wire& w, const ReadWire& r,
                                            int p, int k, uint64_t* key,
                                            bool* qual) {
  if (p < k - 1 || p >= r.len || p >= w.L) return false;
  const int s = p - k + 1;  // the window's first base
  if (wire_bits(w, r.nmask + s, k)) return false;  // non-ACGT
  const uint64_t x = wire_bits(w, r.code + 2 * s, 2 * k);
  *key = canonical(rev2(x) >> (64 - 2 * k), ~x & ((1ull << (2 * k)) - 1ull));
  *qual = wire_bits(w, r.hq + s, k) == (1ull << k) - 1ull;
  return true;
}

__device__ __forceinline__ bool wire_window(const Wire& w, int i, int p,
                                            int k, uint64_t* key,
                                            bool* qual) {
  return read_window(w, read_wire(w, i), p, k, key, qual);
}

// The count-min sketch's cell h (0 or 1) of a canonical mer: the two
// hash streams of sketch.py:_H_C over the mer's high and low 32-bit
// words, h = mix(hi, ca) ^ mix(lo ^ cb, cb), all mod 2^32.
__device__ __forceinline__ uint32_t sketch_mix(uint32_t x, uint32_t c) {
  x *= c | 1u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ uint32_t sketch_addr(uint64_t key, int h,
                                                uint32_t mask) {
  const uint32_t ca = h ? 0xC2B2AE35u : 0x9E3779B9u;
  const uint32_t cb = h ? 0x27D4EB2Fu : 0x85EBCA6Bu;
  const uint32_t hi = (uint32_t)(key >> 32), lo = (uint32_t)key;
  return (sketch_mix(hi, ca) ^ sketch_mix(lo ^ cb, cb)) & mask;
}

// The count-min query: the smaller of the mer's two cells (0, 1 or 2).
__device__ __forceinline__ int sketch_query(const uint8_t* __restrict__ cells,
                                            uint64_t key, uint32_t mask) {
  const int a = cells[sketch_addr(key, 0, mask)];
  const int b = cells[sketch_addr(key, 1, mask)];
  return a < b ? a : b;
}

// Add each thread's v[j] to out[j] with one atomic per block and value
// (a warp shuffle sum, then the block's warps). Every thread of the block
// must call it; blockDim.x is a multiple of 32.
template <int NV>
__device__ __forceinline__ void block_add(unsigned long long (&v)[NV],
                                          unsigned long long* out) {
  __shared__ unsigned long long part[32][NV];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    unsigned long long x = v[j];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xFFFFFFFFu, x, o);
    if (lane == 0) part[w][j] = x;
  }
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unsigned long long x = lane < nw ? part[lane][j] : 0ull;
      for (int o = 16; o > 0; o >>= 1)
        x += __shfl_down_sync(0xFFFFFFFFu, x, o);
      if (lane == 0 && x) atomicAdd(out + j, x);
    }
  }
}

// Row accessors of the sealed table, for the probes of HK3, HK4, HK5 and
// HK16: a probe computes the key parts at the table's GLOBAL geometry and
// asks the accessor for the 512-byte row of its address. PlaneRows is one
// card's plane. ShardRows is a table sharded by leading row bits over up
// to MAX_ROUTED_SHARDS planes (the routed stage-2 layout): shard s holds
// the global rows [s << local_rb, (s + 1) << local_rb), and a shard on
// another card is read in place through peer access. A kernel takes its
// accessor by value as a __grid_constant__ parameter, so the shard
// pointer table is indexed in the parameter space, with no per-thread
// copy; against PlaneRows the sharded row costs a shift, a mask and one
// 8-byte parameter load per probe.
struct PlaneRows {
  const uint32_t* rows;
  __device__ __forceinline__ const uint32_t* row(uint32_t addr) const {
    return rows + (size_t)addr * TILE_WORDS;
  }
};

#define MAX_ROUTED_SHARDS 64

struct ShardRows {
  const uint32_t* shard[MAX_ROUTED_SHARDS];
  int local_rb;
  __device__ __forceinline__ const uint32_t* row(uint32_t addr) const {
    return shard[addr >> local_rb] +
           (size_t)(addr & ((1u << local_rb) - 1u)) * TILE_WORDS;
  }
};

// The accessor of a host array of n shard planes; false past
// MAX_ROUTED_SHARDS.
static inline bool shard_rows(const uint32_t* const* shards, int n,
                              int local_rb, ShardRows* out) {
  if (n < 1 || n > MAX_ROUTED_SHARDS) return false;
  for (int s = 0; s < MAX_ROUTED_SHARDS; ++s)
    out->shard[s] = s < n ? shards[s] : nullptr;
  out->local_rb = local_rb;
  return true;
}

// The value word (count << 1) | qual of the key in `row`, its 512-byte
// row (an accessor's row(p.addr)), or 0 (HK3): 32 16-byte loads over the
// 64 slots, stopping at the match (a key occupies at most one slot of
// its row).
__device__ __forceinline__ uint32_t probe_row(const uint32_t* __restrict__ row,
                                              KeyParts p, int bits) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  const uint32_t maxv = (1u << bits) - 1u;
#pragma unroll 4
  for (int j = 0; j < TILE_WORDS / 4; ++j) {
    uint4 w = __ldg(r4 + j);
    uint32_t c0 = w.x & maxv, c1 = w.z & maxv;
    if (c0 && (w.x >> (bits + 1)) == p.rlo && w.y == p.rhi)
      return (c0 << 1) | ((w.x >> bits) & 1u);
    if (c1 && (w.z >> (bits + 1)) == p.rlo && w.w == p.rhi)
      return (c1 << 1) | ((w.z >> bits) & 1u);
  }
  return 0;
}

// The warp-cooperative probe (HK4, HK16): the 32 threads of a warp probe the
// same keys together, every thread calling with the same arguments.
// Thread t loads the 16 bytes at row + 16 t, so the row comes in one
// coalesced 512-byte request; a ballot finds the lane whose slot pair
// holds the key (at most one slot of the row does) and a shuffle hands
// its value word (count << 1) | qual, or 0, to the whole warp.
__device__ __forceinline__ uint4 warp_row_load(const uint32_t* row) {
  return __ldg(reinterpret_cast<const uint4*>(row) + (threadIdx.x & 31));
}

// Whether one of the two slot pairs in `w` holds the key, and then its
// value word (count << 1) | qual in *val.
__device__ __forceinline__ bool pair_match(uint4 w, KeyParts p, int bits,
                                           uint32_t* val) {
  const uint32_t maxv = (1u << bits) - 1u;
  const bool h0 = (w.x & maxv) && (w.x >> (bits + 1)) == p.rlo &&
                  w.y == p.rhi;
  const bool h1 = (w.z & maxv) && (w.z >> (bits + 1)) == p.rlo &&
                  w.w == p.rhi;
  const uint32_t lo = h0 ? w.x : w.z;
  *val = ((lo & maxv) << 1) | ((lo >> bits) & 1u);
  return h0 || h1;
}

__device__ __forceinline__ uint32_t warp_row_match(uint4 w, KeyParts p,
                                                   int bits) {
  uint32_t v;
  const unsigned m = __ballot_sync(FULL_MASK, pair_match(w, p, bits, &v));
  return m ? __shfl_sync(FULL_MASK, v, __ffs(m) - 1) : 0u;
}

// KeyParts of lane `src`, for every lane.
__device__ __forceinline__ KeyParts shfl_parts(KeyParts p, int src) {
  return KeyParts{__shfl_sync(FULL_MASK, p.addr, src),
                  __shfl_sync(FULL_MASK, p.rlo, src),
                  __shfl_sync(FULL_MASK, p.rhi, src)};
}

// The value words of N keys given by their parts (the same on every
// lane), the rows of those whose bit is set in `want` all loaded before
// any compare (N requests in flight a thread); a key left out reads 0.
template <int N, class Acc>
__device__ __forceinline__ void warp_probe_parts(const Acc& rows,
                                                 const KeyParts (&p)[N],
                                                 unsigned want, int bits,
                                                 uint32_t (&val)[N]) {
  uint4 w[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    w[j] = (want >> j) & 1u ? warp_row_load(rows.row(p[j].addr))
                            : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < N; ++j) val[j] = warp_row_match(w[j], p[j], bits);
}

// The same for N canonical keys.
template <int N, class Acc>
__device__ __forceinline__ void warp_probe(const Acc& rows,
                                           const uint64_t (&keys)[N],
                                           unsigned want, int k, int rb,
                                           int bits, uint32_t (&val)[N]) {
  KeyParts p[N];
#pragma unroll
  for (int j = 0; j < N; ++j) p[j] = key_parts(keys[j], k, rb, bits);
  warp_probe_parts<N>(rows, p, want, bits, val);
}

// The value word of canonical `key` in the table behind accessor `rows`
// at geometry (k, rb, bits).
template <class Acc>
__device__ __forceinline__ uint32_t probe(const Acc& rows, uint64_t key,
                                          int k, int rb, int bits) {
  const KeyParts p = key_parts(key, k, rb, bits);
  return probe_row(rows.row(p.addr), p, bits);
}

// Claim-or-match the key's slot in the build table and add (ah, al) to
// its counters; false if the 64-slot row is full of other keys. The scan
// starts at the preferred slot and goes round the row in the same order
// for every insert of a key, and slots are never freed, so concurrent
// inserts of one key (within a launch or across launches) meet in one
// slot: the tag pair is claimed with one 64-bit atomicCAS expecting the
// empty pair.
__device__ __forceinline__ bool claim_add(uint32_t* tag, uint32_t* hq,
                                          uint32_t* lq, KeyParts p,
                                          uint32_t ah, uint32_t al) {
  unsigned long long* row =
      reinterpret_cast<unsigned long long*>(tag) + (size_t)p.addr * TSLOTS;
  const unsigned long long want =
      ((unsigned long long)p.rhi << 32) | (unsigned long long)p.rlo;
  const int p0 = preferred_slot(p.rlo, p.rhi);
  for (int t = 0; t < TSLOTS; ++t) {
    const int s = (p0 + t) & (TSLOTS - 1);
    unsigned long long cur =
        *reinterpret_cast<volatile unsigned long long*>(row + s);
    if (cur == EMPTY_PAIR) cur = atomicCAS(row + s, EMPTY_PAIR, want);
    if (cur == EMPTY_PAIR || cur == want) {
      const size_t slot = (size_t)p.addr * TSLOTS + s;
      if (ah) atomicAdd(hq + slot, ah);
      if (al) atomicAdd(lq + slot, al);
      return true;
    }
  }
  return false;
}

// Whether the key's tag pair sits in one of the 64 slots of its build
// table row (read after the launches that claim, so plain loads).
__device__ __forceinline__ bool row_holds(const uint32_t* tag, KeyParts p) {
  const unsigned long long* row =
      reinterpret_cast<const unsigned long long*>(tag) +
      (size_t)p.addr * TSLOTS;
  const unsigned long long want =
      ((unsigned long long)p.rhi << 32) | (unsigned long long)p.rlo;
  bool hit = false;
  for (int s = 0; s < TSLOTS; ++s) hit |= row[s] == want;
  return hit;
}

// ------------------------------------------------------------------
// Sort 64 keys held two a lane ascending across a whole warp (a bitonic
// network: shuffles, no shared memory): element e sits in lane e & 31, in
// `a` for e < 32 and in `b` above. HK2's duplicate check and HK6's export
// sort a row's occupied keys with it where the row holds more than 32
// (padded with ~0, which sorts last).
__device__ __forceinline__ void warp_sort64(unsigned long long& a,
                                            unsigned long long& b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // k == 64: the partner is the lane's other element
        const unsigned long long lo = a < b ? a : b;
        b = a < b ? b : a;
        a = lo;
      } else {
        const unsigned long long pa = __shfl_xor_sync(FULL_MASK, a, j);
        const unsigned long long pb = __shfl_xor_sync(FULL_MASK, b, j);
        // the lower element of a pair keeps the minimum where its run
        // ascends (bit k of the element clear)
        const bool low = (lane & j) == 0;
        const bool upa = (lane & k) == 0, upb = ((lane + 32) & k) == 0;
        a = (low == upa) == (a < pa) ? a : pa;
        b = (low == upb) == (b < pb) ? b : pb;
      }
    }
  }
}

// Exclusive scan of per-row u8 entry counts: first[r] = sum of
// counts[0..r), first[rows] = the total. Two passes over chunks of
// SCAN_CHUNK rows (chunk sums; one block scans the chunk sums), then the
// per-row offsets. Each thread of a 256-thread block owns 4 rows.

#define SCAN_CHUNK 1024
#define SCAN_THREADS 256

__device__ __forceinline__ long long warp_incl_scan(long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Exclusive scan of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum. Every thread of the block must call it.
__device__ long long block_excl_scan(long long v, long long* total) {
  __shared__ long long warp_sum[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const long long inc = warp_incl_scan(v);
  if (lane == 31) warp_sum[w] = inc;
  __syncthreads();
  if (w == 0) {
    long long t = lane < nw ? warp_sum[lane] : 0;
    t = warp_incl_scan(t);
    if (lane < nw) warp_sum[lane] = t;
  }
  __syncthreads();
  const long long below = w ? warp_sum[w - 1] : 0;
  *total = warp_sum[nw - 1];
  __syncthreads();  // warp_sum is free again for the next call
  return below + inc - v;
}

__device__ __forceinline__ long long chunk_row_counts(const uint8_t* counts,
                                                      long long rows,
                                                      long long r0,
                                                      int c[4]) {
  long long sum = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j] = r0 + j < rows ? counts[r0 + j] : 0;
    sum += c[j];
  }
  return sum;
}

__global__ void scan_chunk_sums_kernel(const uint8_t* __restrict__ counts,
                                       long long rows,
                                       long long* __restrict__ sums) {
  int c[4];
  const long long r0 = (long long)blockIdx.x * SCAN_CHUNK + 4 * threadIdx.x;
  long long total;
  block_excl_scan(chunk_row_counts(counts, rows, r0, c), &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: chunk sums -> exclusive chunk offsets, and the grand total.
__global__ void scan_chunk_offsets_kernel(long long* sums, long long nchunks,
                                          long long* total_out) {
  long long carry = 0;
  for (long long base = 0; base < nchunks; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    const long long v = i < nchunks ? sums[i] : 0;
    long long tile;
    const long long ex = block_excl_scan(v, &tile);
    if (i < nchunks) sums[i] = carry + ex;
    carry += tile;
  }
  if (threadIdx.x == 0) *total_out = carry;
}

__global__ void scan_row_offsets_kernel(const uint8_t* __restrict__ counts,
                                        long long rows,
                                        const long long* __restrict__ sums,
                                        long long* __restrict__ first) {
  int c[4];
  const long long r0 = (long long)blockIdx.x * SCAN_CHUNK + 4 * threadIdx.x;
  long long total;
  long long off = sums[blockIdx.x] +
                  block_excl_scan(chunk_row_counts(counts, rows, r0, c),
                                  &total);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r0 + j < rows) first[r0 + j] = off;
    off += c[j];
  }
}

// Enqueue the scan: `sums` is scratch of ceil(rows / SCAN_CHUNK) int64,
// `first` holds rows + 1 int64.
static inline cudaError_t row_offsets(const uint8_t* counts, long long rows,
                                      long long* sums, long long* first,
                                      cudaStream_t stream) {
  const long long nchunks = (rows + SCAN_CHUNK - 1) / SCAN_CHUNK;
  if (nchunks == 0) return cudaMemsetAsync(first, 0, sizeof(long long),
                                           stream);
  scan_chunk_sums_kernel<<<(unsigned)nchunks, SCAN_THREADS, 0, stream>>>(
      counts, rows, sums);
  scan_chunk_offsets_kernel<<<1, 1024, 0, stream>>>(sums, nchunks,
                                                    first + rows);
  scan_row_offsets_kernel<<<(unsigned)nchunks, SCAN_THREADS, 0, stream>>>(
      counts, rows, sums, first);
  return cudaGetLastError();
}

// ------------------------------------------------------------------
// Exact owner buckets (HK15 and HK8's shard entry). A source maps lane i
// to (owner, lane) or to nothing: `bool Src::get(long long i, int* owner,
// typename Src::Lane* lane) const`. Pass 1 counts each owner's lanes
// (a block histogram in shared memory, one global atomic per block and
// owner); the host scans the S counts into each bucket's first lane;
// pass 2 scatters every lane to its owner's bucket, each block reserving
// its range of a bucket with one atomic per owner and placing its lanes
// at their ranks in the block. No lane can miss its bucket, so no pass
// re-routes; the order inside a bucket is the launch's own. Both passes
// take 12 * S bytes of dynamic shared memory.

template <class Src>
__global__ void bucket_count_kernel(Src src, long long n, int S,
                                    unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned long long bucket_smem[];
  unsigned* cnt = reinterpret_cast<unsigned*>(bucket_smem + S);
  for (int j = threadIdx.x; j < S; j += blockDim.x) cnt[j] = 0;
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int owner = -1;
  typename Src::Lane lane;
  if (i < n && src.get(i, &owner, &lane)) atomicAdd(&cnt[owner], 1u);
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += blockDim.x)
    if (cnt[j]) atomicAdd(counts + j, (unsigned long long)cnt[j]);
}

template <class Src>
__global__ void bucket_scatter_kernel(Src src, long long n, int S,
                                      unsigned long long* __restrict__ cursor,
                                      typename Src::Lane* __restrict__ out) {
  extern __shared__ unsigned long long bucket_smem[];
  unsigned long long* base = bucket_smem;
  unsigned* cnt = reinterpret_cast<unsigned*>(bucket_smem + S);
  for (int j = threadIdx.x; j < S; j += blockDim.x) cnt[j] = 0;
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int owner = -1;
  unsigned rank = 0;
  typename Src::Lane lane;
  if (i < n && src.get(i, &owner, &lane)) rank = atomicAdd(&cnt[owner], 1u);
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += blockDim.x)
    if (cnt[j]) base[j] = atomicAdd(cursor + j, (unsigned long long)cnt[j]);
  __syncthreads();
  if (owner >= 0) out[base[owner] + rank] = lane;
}

#define BUCKET_THREADS 256

template <class Src>
static inline cudaError_t bucket_count(Src src, long long n, int S,
                                       unsigned long long* counts,
                                       cudaStream_t stream) {
  if (n > 0)
    bucket_count_kernel<Src><<<(unsigned)((n + BUCKET_THREADS - 1) /
                                          BUCKET_THREADS),
                               BUCKET_THREADS, 12 * (size_t)S, stream>>>(
        src, n, S, counts);
  return cudaGetLastError();
}

template <class Src>
static inline cudaError_t bucket_scatter(Src src, long long n, int S,
                                         unsigned long long* cursor,
                                         typename Src::Lane* out,
                                         cudaStream_t stream) {
  if (n > 0)
    bucket_scatter_kernel<Src><<<(unsigned)((n + BUCKET_THREADS - 1) /
                                            BUCKET_THREADS),
                                 BUCKET_THREADS, 12 * (size_t)S, stream>>>(
        src, n, S, cursor, out);
  return cudaGetLastError();
}
