// HK1 tile_insert: stage-1 counting into the tile-bucket build table.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:1280
// (_tile_insert_reads_fused_packed = mer.wire_parts_device /
// unpack_codes_device / synth_quals_device, extract_observations_impl
// :1174, tile_key_parts :671, the write-then-verify claim rounds
// _tile_round_body :1054 / _tile_compact_rounds_body :1123) and the
// re-insert of observations left over after a grow
// (tile_insert_observations :1405), with the partition filter of the
// partitioned multi-pass build fused in (partition_mask :1195, applied at
// :1258-1260).
//
// Design: one thread per window end reads its k bases straight from the
// packed wire (2-bit codes, N mask, qual>=threshold plane; table.cuh
// wire_window, shared with HK9 and HK11), builds the canonical mer and its
// qual bit, hashes it, and claims a slot of its 64-slot row with ONE
// 64-bit atomicCAS on the adjacent (rlo, rhi) tag words, expecting the
// empty pair (table.cuh claim_add, shared with HK8 and HK11); the count
// goes to the slot with atomicAdd (hq or lq). The TPU's rounds, compaction
// and phantom tags do not exist here. A key that meets 64 other keys
// reports `failed`; the caller grows (HK8) and re-inserts those
// observations, one thread each, through the keys entry.
//
// Shard entry (--devices N): the receiving half of the sharded build
// (quorum_tpu/parallel/tile_sharded.py:286-329, the claim rounds of
// _routed_insert_local on the shard's slice). It takes the lanes HK15
// routed to this shard, (key << 1) | qual, one observation each, and
// claims through claim_add with the key parts of the GLOBAL geometry and
// the row localized to the shard (the address's low local_rb bits; its
// leading bits name the shard). A lane that meets a full row reports
// not placed; the caller grows every shard and routes it again, so each
// observation counts exactly once.
//
// Partition filter: pass `part` of `n_parts` (a power of two) counts only
// the mers whose remainder's low log2(n_parts) bits, at the table's own
// (local) geometry, equal `part` (table.cuh rem_low of the key parts the
// insert computes anyway); an observation the pass does not own is done,
// never failed. n_parts = 1 owns every mer.
//
// Bound: bytes. The scan stops at the first empty or matching slot, so
// at the build's load an insert touches one 32-byte sector of tags (read,
// and written when the key is new) and one 32-byte sector of counters
// (read and written); the least work of a batch is the wire plus those
// sectors for each distinct key (chip_smoke.py computes it). The shard
// entry reads 8 bytes a lane in place of the wire and writes a flag.
#include "table.cuh"

__global__ void insert_reads_kernel(Wire w, int k, int rb, int bits,
                                    uint32_t part, uint32_t pmask,
                                    uint32_t* tag, uint32_t* hq,
                                    uint32_t* lq, uint8_t* failed,
                                    long long* fkeys, int* full) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)w.b * w.L) return;
  failed[idx] = 0;
  uint64_t key;
  bool qual;
  if (!wire_window(w, (int)(idx / w.L), (int)(idx % w.L), k, &key, &qual))
    return;
  KeyParts kp = key_parts(key, k, rb, bits);
  if ((rem_low(kp, bits) & pmask) != part) return;  // another pass's mer
  if (!claim_add(tag, hq, lq, kp, qual ? 1u : 0u, qual ? 0u : 1u)) {
    failed[idx] = qual ? 3 : 1;
    fkeys[idx] = (long long)key;
    *full = 1;
  }
}

// Canonical mers with their qual bit, one per observation (the
// observations a full batch left over, after the grow); duplicates meet
// in one slot through claim_add.
__global__ void insert_keys_kernel(const long long* __restrict__ keys,
                                   const uint8_t* __restrict__ qual,
                                   long long n, int k, int rb, int bits,
                                   uint32_t* tag, uint32_t* hq, uint32_t* lq,
                                   uint8_t* placed) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t q = qual[i] ? 1u : 0u;
  placed[i] = claim_add(tag, hq, lq, key_parts((uint64_t)keys[i], k, rb, bits),
                        q, 1u - q);
}

__global__ void insert_shard_kernel(const long long* __restrict__ lanes,
                                    long long n, int k, int rb, int bits,
                                    int local_rb, uint32_t* tag,
                                    uint32_t* hq, uint32_t* lq,
                                    uint8_t* placed) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long v = lanes[i];
  KeyParts p = key_parts((uint64_t)v >> 1, k, rb, bits);
  p.addr &= (1u << local_rb) - 1u;
  const uint32_t q = (uint32_t)(v & 1);
  placed[i] = claim_add(tag, hq, lq, p, q, 1u - q);
}

static inline unsigned grid_for(long long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

extern "C" int tile_insert_reads(const uint8_t* wire, int b, int L,
                                 long long off_nmask, long long off_hq,
                                 long long off_len, int k, int rb, int bits,
                                 int part, int n_parts, uint32_t* tag,
                                 uint32_t* hq, uint32_t* lq, uint8_t* failed,
                                 long long* fkeys, int* full, void* stream) {
  const long long n = (long long)b * L;
  if (n > 0)
    insert_reads_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        Wire{wire, b, L, off_nmask, off_hq, off_len}, k, rb, bits,
        (uint32_t)part, (uint32_t)(n_parts - 1), tag, hq, lq, failed, fkeys,
        full);
  return (int)cudaGetLastError();
}

extern "C" int tile_insert_keys(const long long* keys, const uint8_t* qual,
                                long long n, int k, int rb, int bits,
                                uint32_t* tag, uint32_t* hq, uint32_t* lq,
                                uint8_t* placed, void* stream) {
  if (n > 0)
    insert_keys_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        keys, qual, n, k, rb, bits, tag, hq, lq, placed);
  return (int)cudaGetLastError();
}

extern "C" int tile_insert_shard(const long long* lanes, long long n, int k,
                                 int rb, int bits, int local_rb,
                                 uint32_t* tag, uint32_t* hq, uint32_t* lq,
                                 uint8_t* placed, void* stream) {
  if (n > 0)
    insert_shard_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        lanes, n, k, rb, bits, local_rb, tag, hq, lq, placed);
  return (int)cudaGetLastError();
}
