// HK15 shard_route: stage 1's owner bucketing for a table sharded by
// leading row bits (--devices N).
//
// Replaces the TPU path quorum_tpu/parallel/tile_sharded.py:275-285 (the
// sending half of _routed_insert_local: tile_key_parts at the global
// geometry, owner = addr >> local_rb, _owner_rank :219, the scatter into
// the [S, cap] send buffer) fed from the wire as build_step_wire :413-431
// feeds it, and the re-route of observations left over by a grow (the
// pending lanes that build_step_wire's caller sends again after
// tile_sharded.grow).
//
// Design: one thread per window end of the shard's row range of the
// batch (its own wire, io/packing.split_rows) reads its k bases (table.cuh
// wire_window), forms the canonical mer and its qual bit, hashes it at the
// GLOBAL geometry and takes owner = addr >> local_rb. The lane it writes
// is the mer and its qual bit in one word, (key << 1) | qual: the owner
// recomputes the key parts (HK1's shard entry), and a lane left over by
// a grow re-routes under the doubled geometry from the same word (the
// lanes entry). Buckets are exact (table.cuh bucket_count, a scan of the
// S counts on the host, bucket_scatter): no lane misses its bucket, so
// JAX's bucket_slack and overflow pass have no counterpart. The order
// inside a bucket is the launch's own; the table's content does not
// depend on it.
//
// The partition entry (shard_route_part) is the wire entry of a pass of
// the partitioned build over the mesh (--partitions P with --devices N;
// it replaces the filter of quorum_tpu/parallel/tile_sharded.py:421-423,
// build_step_wire(part=), with ctable.partition_mask :1195): a window
// whose mer the pass does not own -- the remainder's low log2(n_parts)
// bits at the pass's global geometry (table.cuh rem_low, so the high tag
// word supplies them where rlo holds fewer bits, as at -b 25 and -b 30)
// differ from `part` -- is dropped before it is counted or bucketed.
//
// Bound: bytes. It reads the shard's wire once and writes 8 bytes a
// valid (owned) window; the count pass reads the wire a second time
// (the hash is recomputed rather than stored).
#include "table.cuh"

// part/pmask: pass `part` of pmask + 1 owns the lane (pmask 0: all).
struct WireSrc {
  typedef long long Lane;
  Wire w;
  int k, rb, bits, local_rb;
  uint32_t part, pmask;
  __device__ bool get(long long i, int* owner, long long* lane) const {
    uint64_t key;
    bool q;
    if (!wire_window(w, (int)(i / w.L), (int)(i % w.L), k, &key, &q))
      return false;
    const KeyParts kp = key_parts(key, k, rb, bits);
    if ((rem_low(kp, bits) & pmask) != part) return false;
    *owner = (int)(kp.addr >> local_rb);
    *lane = (long long)((key << 1) | (q ? 1ull : 0ull));
    return true;
  }
};

struct LaneSrc {
  typedef long long Lane;
  const long long* lanes;
  int k, rb, bits, local_rb;
  __device__ bool get(long long i, int* owner, long long* lane) const {
    const long long v = lanes[i];
    *owner = (int)(key_parts((uint64_t)v >> 1, k, rb, bits).addr >> local_rb);
    *lane = v;
    return true;
  }
};

static int route_wire(const WireSrc& src, int S, int phase,
                      unsigned long long* counts_or_cursor, long long* out,
                      void* stream) {
  const long long n = (long long)src.w.b * src.w.L;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(phase == 0
                   ? bucket_count(src, n, S, counts_or_cursor, st)
                   : bucket_scatter(src, n, S, counts_or_cursor, out, st));
}

// phase 0: count, phase 1: scatter (cursor = each bucket's first lane).
extern "C" int shard_route_wire(const uint8_t* wire, int b, int L,
                                long long off_nmask, long long off_hq,
                                long long off_len, int k, int rb, int bits,
                                int local_rb, int S, int phase,
                                unsigned long long* counts_or_cursor,
                                long long* out, void* stream) {
  WireSrc src{Wire{wire, b, L, off_nmask, off_hq, off_len}, k, rb, bits,
              local_rb, 0u, 0u};
  return route_wire(src, S, phase, counts_or_cursor, out, stream);
}

// The partition entry: only the windows pass `part` of `n_parts` (a power
// of two) owns at the global geometry rb.
extern "C" int shard_route_part(const uint8_t* wire, int b, int L,
                                long long off_nmask, long long off_hq,
                                long long off_len, int k, int rb, int bits,
                                int local_rb, int S, int part, int n_parts,
                                int phase,
                                unsigned long long* counts_or_cursor,
                                long long* out, void* stream) {
  WireSrc src{Wire{wire, b, L, off_nmask, off_hq, off_len}, k, rb, bits,
              local_rb, (uint32_t)part, (uint32_t)(n_parts - 1)};
  return route_wire(src, S, phase, counts_or_cursor, out, stream);
}

extern "C" int shard_route_lanes(const long long* lanes, long long n, int k,
                                 int rb, int bits, int local_rb, int S,
                                 int phase,
                                 unsigned long long* counts_or_cursor,
                                 long long* out, void* stream) {
  LaneSrc src{lanes, k, rb, bits, local_rb};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(phase == 0
                   ? bucket_count(src, n, S, counts_or_cursor, st)
                   : bucket_scatter(src, n, S, counts_or_cursor, out, st));
}
