// HK1 tile_insert: stage-1 counting into the tile-bucket build table.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:1280
// (_tile_insert_reads_fused_packed = mer.wire_parts_device /
// unpack_codes_device / synth_quals_device, extract_observations_impl
// :1174, tile_key_parts :671, the write-then-verify claim rounds
// _tile_round_body :1054 / _tile_compact_rounds_body :1123) and the grow
// re-insert of tile_grow_build :1521.
//
// Design: one thread per window end reads its k bases straight from the
// packed wire (2-bit codes, N mask, qual>=threshold plane), builds the
// canonical mer and its qual bit, hashes it, and claims a slot of its
// 64-slot row with ONE 64-bit atomicCAS on the adjacent (rlo, rhi) tag
// words, expecting the empty pair. The scan starts at the preferred slot
// and goes round the row in the same order for every insert of a key, and
// slots are never freed, so a key can never land twice in a row; the
// count goes to the slot with atomicAdd (hq or lq). The TPU's rounds,
// compaction and phantom tags do not exist here. A key that meets 64
// other keys reports `failed`; the caller grows and re-inserts it
// through the parts entry, which also serves the grow's re-insert.
//
// Bound: bytes. The scan stops at the first empty or matching slot, so
// at the build's load an insert touches one 32-byte sector of tags (read,
// and written when the key is new) and one 32-byte sector of counters
// (read and written); the least work of a batch is the wire plus those
// sectors for each distinct key (chip_smoke.py computes it).
#include "table.cuh"

// Claim-or-match the key's slot and add (ah, al); false if the row is
// full of other keys.
__device__ bool claim_add(uint32_t* tag, uint32_t* hq, uint32_t* lq,
                          KeyParts p, uint32_t ah, uint32_t al) {
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

__global__ void insert_reads_kernel(const uint8_t* __restrict__ wire, int b,
                                    int L, long long off_nmask,
                                    long long off_hq, long long off_len,
                                    int k, int rb, int bits, uint32_t* tag,
                                    uint32_t* hq, uint32_t* lq,
                                    uint8_t* failed, long long* fkeys,
                                    int* full) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)b * L) return;
  const int i = (int)(idx / L);
  const int p = (int)(idx % L);
  const int c4 = (L + 3) / 4, c8 = (L + 7) / 8;
  const uint8_t* lb = wire + off_len + 4ll * i;
  const int len = (int)((uint32_t)lb[0] | ((uint32_t)lb[1] << 8) |
                        ((uint32_t)lb[2] << 16) | ((uint32_t)lb[3] << 24));
  failed[idx] = 0;
  if (p < k - 1 || p >= len) return;
  const uint8_t* pc = wire + (long long)i * c4;
  const uint8_t* nm = wire + off_nmask + (long long)i * c8;
  const uint8_t* hp = wire + off_hq + (long long)i * c8;
  uint64_t f = 0, r = 0;
  bool qual = true;
  for (int j = 0; j < k; ++j) {  // base at p-j -> bit 2j of f
    const int q = p - j;
    if ((nm[q >> 3] >> (q & 7)) & 1) return;  // non-ACGT: no window
    const uint32_t c = (pc[q >> 2] >> (2 * (q & 3))) & 3u;
    f |= (uint64_t)c << (2 * j);
    r |= (uint64_t)(3 - c) << (2 * (k - 1 - j));
    qual &= ((hp[q >> 3] >> (q & 7)) & 1) != 0;
  }
  const uint64_t key = canonical(f, r);
  KeyParts kp = key_parts(key, k, rb, bits);
  if (!claim_add(tag, hq, lq, kp, qual ? 1u : 0u, qual ? 0u : 1u)) {
    failed[idx] = qual ? 3 : 1;
    fkeys[idx] = (long long)key;
    *full = 1;
  }
}

__global__ void insert_parts_kernel(const long long* __restrict__ addr,
                                    const long long* __restrict__ rlo,
                                    const long long* __restrict__ rhi,
                                    const int* __restrict__ ah,
                                    const int* __restrict__ al, long long n,
                                    uint32_t* tag, uint32_t* hq, uint32_t* lq,
                                    uint8_t* placed) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  KeyParts kp;
  kp.addr = (uint32_t)addr[i];
  kp.rlo = (uint32_t)rlo[i];
  kp.rhi = (uint32_t)rhi[i];
  placed[i] = claim_add(tag, hq, lq, kp, (uint32_t)ah[i], (uint32_t)al[i]);
}

static inline unsigned grid_for(long long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

extern "C" int tile_insert_reads(const uint8_t* wire, int b, int L,
                                 long long off_nmask, long long off_hq,
                                 long long off_len, int k, int rb, int bits,
                                 uint32_t* tag, uint32_t* hq, uint32_t* lq,
                                 uint8_t* failed, long long* fkeys, int* full,
                                 void* stream) {
  const long long n = (long long)b * L;
  if (n > 0)
    insert_reads_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        wire, b, L, off_nmask, off_hq, off_len, k, rb, bits, tag, hq, lq,
        failed, fkeys, full);
  return (int)cudaGetLastError();
}

extern "C" int tile_insert_parts(const long long* addr, const long long* rlo,
                                 const long long* rhi, const int* ah,
                                 const int* al, long long n, uint32_t* tag,
                                 uint32_t* hq, uint32_t* lq, uint8_t* placed,
                                 void* stream) {
  if (n > 0)
    insert_parts_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        addr, rlo, rhi, ah, al, n, tag, hq, lq, placed);
  return (int)cudaGetLastError();
}
