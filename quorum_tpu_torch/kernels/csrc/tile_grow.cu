// HK8 tile_grow: double the build table's rows and re-insert every slot.
//
// Replaces the TPU path quorum_tpu/ops/ctable.py:1521 (tile_grow_build:
// the per-chunk rehash _tile_grow_prep :1498, then _tile_round1 claim
// rounds into the doubled table) and, in its shard entry, the sharded
// grow quorum_tpu/parallel/tile_sharded.py:458-555 (grow, _entries_host,
// _try_place_all).
//
// Design: one thread per old slot. The full hash is (rem << rb) | addr
// with rem = rhi:rlo, so doubling moves rem's low bit into the address's
// new top bit: addr' = addr | (rlo & 1) << rb, rlo' = rlo >> 1 | (rhi & 1)
// << (rlo_bits - 1), rhi' = rhi >> 1 (32-bit words, so the masks are
// implicit). A live slot (tag not empty, hq | lq != 0) claims its slot
// in the doubled table with table.cuh claim_add -- the 64-bit atomicCAS
// that HK1 uses -- and stores its hq and lq there. One launch per grow:
// no compaction, no chunk loop, no rounds. A row of the doubled table
// takes keys of one old row only, so it cannot overflow; `full` still
// reports a failed claim, and the wrapper raises on it.
//
// Shard entry (--devices N, S = 2^owner_bits shards by leading row
// bits): the same arithmetic on the global address s << local_rb | row
// of shard s's slot, with no key decoded. The doubled address's leading
// owner_bits name the slot's new shard, ((rlo & 1) << (owner_bits - 1))
// | (s >> 1), and its low local_rb + 1 bits its row there, (s & 1) <<
// local_rb | row. Pass 1 buckets each live slot's (row, rlo', rhi', hq,
// lq) by its new shard (table.cuh bucket_count / bucket_scatter); the
// buckets cross to their shards' devices; pass 2 (tile_grow_place) claims
// them in each shard's fresh doubled slice. At owner_bits = 0 the new
// shard is 0 and the row is HK8's addr'. A new row still takes keys of
// one old row only. JAX instead pulls every entry to the host, decodes
// and re-routes it, doubling again on a failed placement; the port keeps
// one doubling per grow with the table on the device.
//
// Bound: bytes. It reads the old tags and counters once (1 KiB per old
// row) and, per live key, touches one tag sector and one counter sector
// of the new table (32 B each, written once). The shard entry adds a
// 20-byte bucket lane per live key, written and read once.
#include "table.cuh"

__global__ void grow_kernel(const uint2* __restrict__ tag,
                            const uint32_t* __restrict__ hq,
                            const uint32_t* __restrict__ lq,
                            long long n_slots, int rb, int rlo_bits,
                            uint32_t* ntag, uint32_t* nhq, uint32_t* nlq,
                            int* full) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const uint2 t = tag[i];  // (rlo, rhi)
  const uint32_t h = hq[i], l = lq[i];
  if (t.x == EMPTY_TAG || (h | l) == 0u) return;
  KeyParts p;
  p.addr = (uint32_t)(i / TSLOTS) | ((t.x & 1u) << rb);
  p.rlo = (t.x >> 1) | ((t.y & 1u) << (rlo_bits - 1));
  p.rhi = t.y >> 1;
  if (!claim_add(ntag, nhq, nlq, p, h, l)) *full = 1;
}

extern "C" int tile_grow(const uint32_t* tag, const uint32_t* hq,
                         const uint32_t* lq, long long rows, int rb,
                         int rlo_bits, uint32_t* ntag, uint32_t* nhq,
                         uint32_t* nlq, int* full, void* stream) {
  const long long n = rows * TSLOTS;
  if (n > 0)
    grow_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                  (cudaStream_t)stream>>>(
        reinterpret_cast<const uint2*>(tag), hq, lq, n, rb, rlo_bits, ntag,
        nhq, nlq, full);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- shard entry

struct GrowLane {
  uint32_t row, rlo, rhi, hq, lq;
};

struct GrowSrc {
  typedef GrowLane Lane;
  const uint2* tag;
  const uint32_t* hq;
  const uint32_t* lq;
  uint32_t s;
  int local_rb, owner_bits, rlo_bits;
  __device__ bool get(long long i, int* owner, GrowLane* lane) const {
    const uint2 t = tag[i];
    const uint32_t h = hq[i], l = lq[i];
    if (t.x == EMPTY_TAG || (h | l) == 0u) return false;
    const uint32_t row = (uint32_t)(i / TSLOTS), bit = t.x & 1u;
    if (owner_bits == 0) {
      *owner = 0;
      lane->row = row | (bit << local_rb);
    } else {
      *owner = (int)((bit << (owner_bits - 1)) | (s >> 1));
      lane->row = ((s & 1u) << local_rb) | row;
    }
    lane->rlo = (t.x >> 1) | ((t.y & 1u) << (rlo_bits - 1));
    lane->rhi = t.y >> 1;
    lane->hq = h;
    lane->lq = l;
    return true;
  }
};

// Pass 1 on shard s's old slice (rows = 2^local_rb): phase 0 counts the
// live slots by new shard, phase 1 scatters them (cursor = each bucket's
// first lane).
extern "C" int tile_grow_shard(const uint32_t* tag, const uint32_t* hq,
                               const uint32_t* lq, int local_rb, int s,
                               int owner_bits, int rlo_bits, int phase,
                               unsigned long long* counts_or_cursor,
                               uint32_t* out, void* stream) {
  GrowSrc src{reinterpret_cast<const uint2*>(tag), hq, lq, (uint32_t)s,
              local_rb, owner_bits, rlo_bits};
  const long long n = (1ll << local_rb) * TSLOTS;
  const int S = 1 << owner_bits;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(phase == 0
                   ? bucket_count(src, n, S, counts_or_cursor, st)
                   : bucket_scatter(src, n, S, counts_or_cursor,
                                    reinterpret_cast<GrowLane*>(out), st));
}

__global__ void grow_place_kernel(const GrowLane* __restrict__ lanes,
                                  long long n, uint32_t* ntag, uint32_t* nhq,
                                  uint32_t* nlq, int* full) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const GrowLane g = lanes[i];
  KeyParts p;
  p.addr = g.row;
  p.rlo = g.rlo;
  p.rhi = g.rhi;
  if (!claim_add(ntag, nhq, nlq, p, g.hq, g.lq)) *full = 1;
}

// Pass 2 on a shard's fresh doubled slice: claim the n lanes routed to it.
extern "C" int tile_grow_place(const uint32_t* lanes, long long n,
                               uint32_t* ntag, uint32_t* nhq, uint32_t* nlq,
                               int* full, void* stream) {
  if (n > 0)
    grow_place_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                        (cudaStream_t)stream>>>(
        reinterpret_cast<const GrowLane*>(lanes), n, ntag, nhq, nlq, full);
  return (int)cudaGetLastError();
}
