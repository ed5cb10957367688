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
// Design: a warp per read; its lanes take the read's window ends 32 at a
// time, from k - 1 to the read's end (no thread for a window that is not
// there). A lane builds its window in constant time from 64-bit words of
// the packed wire (table.cuh read_window, shared through wire_window
// with HK9, HK11 and HK15): the reverse-complement word is the
// complement of the 2k-bit extract of the read's code row, the forward
// word the same extract with its 2-bit groups reversed, and the window's
// validity and qual bit are k-bit extracts of the N mask and the qual
// plane: one or two 8-byte loads a plane, the warp's lanes sharing
// their words in L1. It hashes
// the canonical mer and claims a slot of its 64-slot row with ONE 64-bit
// atomicCAS on the adjacent (rlo, rhi) tag words, expecting the empty
// pair (table.cuh claim_add, shared with HK8 and HK11); the count goes to
// the slot with atomicAdd (hq or lq). The TPU's rounds, compaction and
// phantom tags do not exist here. A key that meets 64 other keys is a
// failure, and only failures are written: a warp-aggregated list (one
// atomic a warp) of (key << 1) | qual words, with its device-side count.
// Past the list's capacity the count still counts, and the wrapper lists
// the failures again, exactly, in a second launch (`relist`) that builds
// the same windows and lists those whose key its row lacks: a key fails
// only when every slot of its row holds another key, and slots are never
// freed, so the failed windows are exactly the windows whose key is
// absent after the launch. The caller grows (HK8) and re-inserts those
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
// What sets the time (design experiments on an H100 80GB HBM3 at 700 W,
// a late full batch of the E. coli-size cell into a 2^22-row table that
// holds the other batches, PERF.md section 6): the claims. Alone (the
// keys entry on the batch's 1,040,384 observations) they take as long
// as the whole reads entry, two random sectors an observation in 4 GiB
// of build state; the window build and hash alone take about a quarter
// of that, which sets the partition entry, where three quarters of the
// windows claim nothing.
#include "table.cuh"

#define INS_WARPS 8  // reads a block

template <bool RELIST>
__global__ void __launch_bounds__(INS_WARPS * 32) insert_reads_kernel(
    Wire w, int k, int rb, int bits, uint32_t part, uint32_t pmask,
    uint32_t* tag, uint32_t* hq, uint32_t* lq,
    long long* __restrict__ flist, int cap, int* __restrict__ n_fail) {
  const int i = blockIdx.x * INS_WARPS + (threadIdx.x >> 5);
  if (i >= w.b) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const ReadWire r = read_wire(w, i);
  const int end = r.len < w.L ? r.len : w.L;
  for (int p0 = k - 1; p0 < end; p0 += 32) {
    uint64_t key = 0;
    bool qual = false, fail = false;
    if (read_window(w, r, p0 + lane, k, &key, &qual)) {
      const KeyParts kp = key_parts(key, k, rb, bits);
      if ((rem_low(kp, bits) & pmask) == part)  // else another pass's mer
        fail = RELIST ? !row_holds(tag, kp)
                      : !claim_add(tag, hq, lq, kp, qual ? 1u : 0u,
                                   qual ? 0u : 1u);
    }
    // list the failures: one atomic per warp
    const unsigned m = __ballot_sync(FULL_MASK, fail);
    if (m) {
      int at = 0;
      if (lane == 0) at = atomicAdd(n_fail, __popc(m));
      at = __shfl_sync(FULL_MASK, at, 0) + __popc(m & ((1u << lane) - 1u));
      if (fail && at < cap) flist[at] = (long long)((key << 1) | qual);
    }
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

// `n_fail` must be zero; `flist` holds `cap` words. relist = 1: list the
// windows whose key the table lacks, claiming nothing.
extern "C" int tile_insert_reads(const uint8_t* wire, int b, int L,
                                 long long off_nmask, long long off_hq,
                                 long long off_len, int k, int rb, int bits,
                                 int part, int n_parts, int relist,
                                 uint32_t* tag, uint32_t* hq, uint32_t* lq,
                                 long long* flist, int cap, int* n_fail,
                                 void* stream) {
  if ((long long)b * L > 0) {
    const Wire w{wire, b, L, off_nmask, off_hq, off_len};
    const unsigned grid = grid_for(b, INS_WARPS);
    if (relist)
      insert_reads_kernel<true><<<grid, INS_WARPS * 32, 0,
                                  (cudaStream_t)stream>>>(
          w, k, rb, bits, (uint32_t)part, (uint32_t)(n_parts - 1), tag, hq,
          lq, flist, cap, n_fail);
    else
      insert_reads_kernel<false><<<grid, INS_WARPS * 32, 0,
                                   (cudaStream_t)stream>>>(
          w, k, rb, bits, (uint32_t)part, (uint32_t)(n_parts - 1), tag, hq,
          lq, flist, cap, n_fail);
  }
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
