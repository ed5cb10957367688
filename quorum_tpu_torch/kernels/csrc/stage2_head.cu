// HK5 stage2_head: the head of a stage-2 batch, from the packed wire to
// the anchors HK4 extends from.
//
// Replaces the TPU path quorum_tpu/ops/mer.py:349-374 (wire_parts_device,
// unpack_codes_device, synth_quals_device: K1), mer.rolling_kmers :192
// and mer.canonical :151 (K2), and quorum_tpu/models/corrector.py:312
// (_position_sweep: one lookup per window, K10) with find_anchors :348
// (the closed-form anchor scan, K11), and their contaminant halves: the
// contaminant lookup of _position_sweep (:327-333) and the kill of
// find_anchors (:393-406).
//
// Design: one warp per read; lanes stride the read's positions, 32 at a
// time. A lane reads its base straight from the packed wire as HK1 does
// and writes the int8 codes plane (0..3, -1 N, -2 past the read) and the
// qual >= cutoff plane that HK4 consumes. It builds the forward and
// reverse mer of the window ending at its position from the k bases
// before it, a non-ACGT base entering as A (corrector.py:316-319), and
// probes the table (table.cuh probe_row) where the window is checked
// (k consecutive ACGT bases, past `skip`, at most len - 2; the value
// elsewhere never reaches an anchor). The anchor scan -- a run of good
// windows reset by invalid or low windows, anchor at the first window
// whose run reaches `good` -- is a warp scan of ballots per 32-position
// chunk, with the run carried from chunk to chunk; probes stop once the
// anchor is found. Where there is none, the outputs are the plain
// version's: position 0's mers and value, start_off 1.
//
// The contaminant entry (CONTAM) probes one more table, with its own
// geometry (rb, bits), for every valid window past `skip` until the
// anchor: a member window is neither good nor a reset, and unless `trim`
// the first checked member before the anchor (a ballot per chunk) kills
// the read. The scan goes on to the anchor all the same, since start_off
// is one past it (find_anchors), and the kernel writes the read's status
// (OK, ST_CONTAMINANT, ST_NO_ANCHOR) in both entries.
//
// The sharded-table entry (stage2_head_shard) is the same kernel probing
// a table sharded by leading row bits in place (table.cuh ShardRows, the
// routed stage-2 layout; it replaces the routed lookups of
// quorum_tpu/parallel/tile_sharded.py:878 correct_step_routed and :909
// correct_step_wire(routed_meta=), dispatched from corrector._db_lookup
// :184): each probe reads its row from the shard that owns it, on this
// card or over NVLink, and gets the value routed_lookup_local would
// return. The contaminant set stays one plane on this card (replicated,
// as JAX's crows is P()). Both entries take both contaminant variants.
//
// Bound: bytes. The wire in, the codes and qual planes and the anchors
// out, and one read of the 512-byte row of every probed window (HK3's
// count per probe), in each table probed; the same for the sharded-table
// entry, whose shard pointer table is one kernel parameter (nothing per
// probe beyond a shift and a mask).
#include "table.cuh"

#define HEAD_WARPS 4

#define ST_OK 0
#define ST_CONTAMINANT 1
#define ST_NO_ANCHOR 2

struct HeadCfg {
  int k, rb, bits, crb, cbits, trim, skip, good, anchor_count;
};

template <class Acc, bool CONTAM>
__global__ void head_kernel(const uint8_t* __restrict__ wire, int B, int L,
                            long long off_nmask, long long off_hq,
                            long long off_len,
                            const __grid_constant__ Acc rows,
                            const uint32_t* __restrict__ crows, HeadCfg c,
                            int8_t* __restrict__ codes,
                            uint8_t* __restrict__ hqb,
                            int* __restrict__ lengths,
                            uint8_t* __restrict__ found,
                            int* __restrict__ start_off,
                            long long* __restrict__ anc_f,
                            long long* __restrict__ anc_r,
                            int* __restrict__ prev,
                            int* __restrict__ status) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * HEAD_WARPS + (threadIdx.x >> 5);
  if (i >= B) return;  // whole warps
  const int c4 = (L + 3) / 4, c8 = (L + 7) / 8;
  const uint8_t* lb = wire + off_len + 4ll * i;
  const int len = (int)((uint32_t)lb[0] | ((uint32_t)lb[1] << 8) |
                        ((uint32_t)lb[2] << 16) | ((uint32_t)lb[3] << 24));
  const uint8_t* pc = wire + (long long)i * c4;
  const uint8_t* nm = wire + off_nmask + (long long)i * c8;
  const uint8_t* hp = wire + off_hq + (long long)i * c8;
  const int k = c.k;
  int run = 0;
  bool hit_found = false, kill_found = false;
  int hit_p = 0, hit_v = 0, v0 = 0, kill_p = 0;
  unsigned long long hit_f = 0, hit_r = 0, f0 = 0, r0 = 0;
  for (int base = 0; base < L; base += 32) {
    const int p = base + lane;
    bool a = false, z = false, kill = false;
    unsigned long long f = 0, r = 0;
    int vhq = 0;
    if (p < L) {
      int code = -2;
      if (p < len && !((nm[p >> 3] >> (p & 7)) & 1))
        code = (pc[p >> 2] >> (2 * (p & 3))) & 3;
      else if (p < len)
        code = -1;
      codes[(long long)i * L + p] = (int8_t)code;
      hqb[(long long)i * L + p] = (hp[p >> 3] >> (p & 7)) & 1;
      bool valid = p >= k - 1;  // k consecutive ACGT bases end at p
      for (int j = 0; j < k && j <= p; ++j) {  // base at p-j -> bit 2j
        const int q = p - j;
        uint32_t cq = 0;
        if (q >= len || ((nm[q >> 3] >> (q & 7)) & 1))
          valid = false;
        else
          cq = (pc[q >> 2] >> (2 * (q & 3))) & 3u;
        f |= (unsigned long long)cq << (2 * j);
        r |= (unsigned long long)(3u - cq) << (2 * (k - 1 - j));
      }
      const bool vw = valid && p >= c.skip + k - 1;
      const bool checked = vw && p <= len - 2;
      bool con = false;
      if (vw && !hit_found) {
        const uint64_t m = canonical(f, r);
        const uint32_t val = probe(rows, m, k, c.rb, c.bits);
        vhq = (val & 1u) ? (int)(val >> 1) : 0;
        if (CONTAM)
          con = probe(PlaneRows{crows}, m, k, c.crb, c.cbits) != 0;
      }
      a = checked && !con && vhq >= c.anchor_count;
      z = !vw || (checked && !con && vhq < c.anchor_count);
      kill = CONTAM && !c.trim && checked && con;
    }
    if (base == 0) {
      f0 = __shfl_sync(FULL_MASK, f, 0);
      r0 = __shfl_sync(FULL_MASK, r, 0);
      v0 = __shfl_sync(FULL_MASK, vhq, 0);
    }
    // run at p = good windows since the last reset at or before p
    const unsigned am = __ballot_sync(FULL_MASK, a);
    const unsigned zm = __ballot_sync(FULL_MASK, z);
    const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane
    const unsigned zl = zm & upto;
    int myrun;
    if (zl) {
      const int lz = 31 - __clz(zl);
      myrun = __popc(am & upto & ~((2u << lz) - 1u));
    } else {
      myrun = run + __popc(am & upto);
    }
    const unsigned hm = __ballot_sync(FULL_MASK, a && myrun >= c.good);
    if (CONTAM) {  // the first kill before the anchor (none after it)
      const unsigned km = __ballot_sync(FULL_MASK, kill);
      if (km && !hit_found && !kill_found) {
        kill_found = true;
        kill_p = base + __ffs(km) - 1;
      }
    }
    if (hm && !hit_found) {
      const int hl = __ffs(hm) - 1;
      hit_found = true;
      hit_p = base + hl;
      hit_f = __shfl_sync(FULL_MASK, f, hl);
      hit_r = __shfl_sync(FULL_MASK, r, hl);
      hit_v = __shfl_sync(FULL_MASK, vhq, hl);
    }
    run = __shfl_sync(FULL_MASK, myrun, 31);
  }
  if (lane == 0) {
    const bool killed = kill_found && (!hit_found || kill_p < hit_p);
    const bool ok = hit_found && !killed;
    lengths[i] = len;
    found[i] = ok;
    start_off[i] = (hit_found ? hit_p : 0) + 1;
    anc_f[i] = (long long)(ok ? hit_f : f0);
    anc_r[i] = (long long)(ok ? hit_r : r0);
    prev[i] = ok ? hit_v : v0;
    status[i] = ok ? ST_OK : killed ? ST_CONTAMINANT : ST_NO_ANCHOR;
  }
}

template <class Acc>
static int launch_head(const uint8_t* wire, int B, int L, long long off_nmask,
                       long long off_hq, long long off_len, const Acc& rows,
                       const uint32_t* crows, const HeadCfg& c, int8_t* codes,
                       uint8_t* hqb, int* lengths, uint8_t* found,
                       int* start_off, long long* anc_f, long long* anc_r,
                       int* prev, int* status, void* stream) {
  const unsigned grid = (unsigned)((B + HEAD_WARPS - 1) / HEAD_WARPS);
  if (B > 0 && crows)
    head_kernel<Acc, true><<<grid, 32 * HEAD_WARPS, 0,
                             (cudaStream_t)stream>>>(
        wire, B, L, off_nmask, off_hq, off_len, rows, crows, c, codes, hqb,
        lengths, found, start_off, anc_f, anc_r, prev, status);
  else if (B > 0)
    head_kernel<Acc, false><<<grid, 32 * HEAD_WARPS, 0,
                              (cudaStream_t)stream>>>(
        wire, B, L, off_nmask, off_hq, off_len, rows, crows, c, codes, hqb,
        lengths, found, start_off, anc_f, anc_r, prev, status);
  return (int)cudaGetLastError();
}

// `crows` null: the entry without a contaminant.
extern "C" int stage2_head(const uint8_t* wire, int B, int L,
                           long long off_nmask, long long off_hq,
                           long long off_len, const uint32_t* rows, int k,
                           int rb, int bits, const uint32_t* crows, int crb,
                           int cbits, int trim, int skip, int good,
                           int anchor_count, int8_t* codes, uint8_t* hqb,
                           int* lengths, uint8_t* found, int* start_off,
                           long long* anc_f, long long* anc_r, int* prev,
                           int* status, void* stream) {
  HeadCfg c{k, rb, bits, crb, cbits, trim, skip, good, anchor_count};
  return launch_head(wire, B, L, off_nmask, off_hq, off_len, PlaneRows{rows},
                     crows, c, codes, hqb, lengths, found, start_off, anc_f,
                     anc_r, prev, status, stream);
}

// The sharded-table entry: `shards` a host array of n_shards plane
// pointers (2^local_rb rows each), rb the GLOBAL geometry.
extern "C" int stage2_head_shard(const uint8_t* wire, int B, int L,
                                 long long off_nmask, long long off_hq,
                                 long long off_len,
                                 const uint32_t* const* shards, int n_shards,
                                 int local_rb, int k, int rb, int bits,
                                 const uint32_t* crows, int crb, int cbits,
                                 int trim, int skip, int good,
                                 int anchor_count, int8_t* codes,
                                 uint8_t* hqb, int* lengths, uint8_t* found,
                                 int* start_off, long long* anc_f,
                                 long long* anc_r, int* prev, int* status,
                                 void* stream) {
  ShardRows acc;
  if (!shard_rows(shards, n_shards, local_rb, &acc))
    return (int)cudaErrorInvalidValue;
  HeadCfg c{k, rb, bits, crb, cbits, trim, skip, good, anchor_count};
  return launch_head(wire, B, L, off_nmask, off_hq, off_len, acc, crows, c,
                     codes, hqb, lengths, found, start_off, anc_f, anc_r,
                     prev, status, stream);
}
