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
// Design: one warp per read, two reads a block (a read without an anchor
// scans three times as long as one with it, and a block's registers are
// held until its last warp ends).
//
// The planes: the warp writes the int8 codes plane (0..3, -1 N, -2 past
// the read) and the qual >= cutoff plane that HK4 consumes in 8-byte
// words a lane, each from one 16-bit extract of the read's code row and
// two 8-bit extracts (N mask, qual) of the packed wire (table.cuh
// wire_bits). A lane's first word is loaded before the scan and stored
// after it, so that its loads wait behind the scan's; a word the row
// shares with its neighbour is written a byte at a time.
//
// The scan: only windows from skip + k - 1 on can be checked (the value
// elsewhere never reaches an anchor, and those windows reset the run), so
// the warp takes the read's window ends 32 at a time from there to the
// read's end. A lane builds the forward and reverse mer of its window in
// constant time from the wire (table.cuh read_window's extracts: the
// reverse word the complement of the 2k-bit code extract, the forward
// word the same with its 2-bit groups reversed; the window is valid when
// its k-bit N-mask extract is zero) and hashes it; a table in shared
// memory lists the chunk's valid windows in position order. Then the
// warp probes them in groups of HEAD_GROUP: a quad of 8 lanes probes a
// window's row by 128-byte lines (16 slots), first the line of the key's
// preferred slot and line 0, which hold the key in a handoff table (at
// or a few slots after its preferred slot) and in one HK7 loaded (packed
// from slot 0), every line of the group in flight before any compare;
// only a key that neither line holds reads the row's other two lines (a
// probe reads its whole row, or stops at the line that holds its key). A
// found key costs 256 bytes, not the row's 512. After each group the
// anchor scan -- a run of good windows reset by invalid or low windows,
// anchor at the first window whose run reaches `good` -- runs as a warp
// scan of ballots over the chunk's windows resolved so far, with the run
// carried from chunk to chunk; probing stops at the group that holds the
// anchor, so a read probes at most a group less one past it.
// Non-ACGT bases enter a mer as A (corrector.py:316-319) only in windows
// that are invalid, whose mers reach the outputs in one place: a read
// without an anchor returns position 0's mers and value (the plain
// version's), and those are base 0's code (A where it is N or past the
// read) and its complement at the top, computed directly.
//
// What sets the time (an H100 80GB HBM3 at 700 W, `full`'s first batch
// of 8,192 reads on its 2^22-row table, PERF.md section 6): the latency
// of a read's chain of groups, not the card's memory rate (under 1.5
// TB/s of lines). A probe that read its whole 512-byte row moved as many
// bytes as the parent's scan, which stopped at the key; picking a
// group's windows with __fns in place of the shared table was far
// slower; groups of 4 took more rounds and groups of 16 more
// registers (fewer warps), both slower than 8 (PERF.md section 6).
//
// The contaminant entry (CONTAM) probes one more table, with its own
// geometry (rb, bits), for every valid window past `skip` until the
// anchor: its rows are read whole (a read's mers are rarely members, and
// an absent key reads its whole row), in flight in the same group as the
// main table's lines. A member window is neither good nor a reset, and
// unless `trim` the first checked member before the anchor (a ballot per
// chunk) kills the read. The scan goes on to the anchor all the same,
// since start_off is one past it (find_anchors), and the kernel writes
// the read's status (OK, ST_CONTAMINANT, ST_NO_ANCHOR) in both entries.
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
// out, and for the windows the scan must probe, in each table probed:
// the 128-byte line that holds each found key, and the whole 512-byte
// row of each absent key (a probe cannot know a key is absent before it
// has read every slot), each line or row once. The same for the
// sharded-table entry, whose shard pointer table is one kernel parameter
// (nothing per probe beyond a shift and a mask).
#include "table.cuh"

// Reads a block, and windows probed together (a multiple of 4).
#define HEAD_WARPS 2
#define HEAD_GROUP 8

// The group size as the build has it, for a caller that counts probes
// (read through ctypes: c_int.in_dll).
extern "C" const int stage2_head_group = HEAD_GROUP;

#define ST_OK 0
#define ST_CONTAMINANT 1
#define ST_NO_ANCHOR 2

struct HeadCfg {
  int k, rb, bits, crb, cbits, trim, skip, good, anchor_count;
};

// Position p's codes-plane byte: 0..3, -1 for N, -2 past the read; from
// the code row's 2-bit group and the N mask's bit.
__device__ __forceinline__ uint32_t code_byte(uint32_t code, uint32_t n,
                                              int p, int len) {
  return p >= len ? 0xFEu : n ? 0xFFu : code;
}

// Read i's rows of the codes and qual-bit planes ([i L, (i + 1) L) of
// each) in 8-byte words, lane-strided: a word inside the row is one
// extract of 16 code bits and two of 8 bits (N mask, qual) of the wire
// and one 8-byte store a plane; a word the row shares with a
// neighbouring row is written a byte at a time, only its own bytes.
struct PlaneWord {
  long long wd;     // the word's index in the planes
  int p;            // the position of its first byte in the read
  uint32_t cb, nh;  // 16 code bits; N bits | qual bits << 8
};

__device__ __forceinline__ PlaneWord plane_load(const Wire& w,
                                                const ReadWire& r, int i,
                                                long long wd) {
  const long long r0 = (long long)i * w.L;
  PlaneWord pw{wd, (int)(8 * wd - r0), 0u, 0u};
  if (pw.p >= 0 && pw.p + 8 <= w.L) {
    pw.cb = (uint32_t)wire_bits(w, r.code + 2 * pw.p, 16);
    pw.nh = (uint32_t)wire_bits(w, r.nmask + pw.p, 8) |
            ((uint32_t)wire_bits(w, r.hq + pw.p, 8) << 8);
  }
  return pw;
}

__device__ __forceinline__ void plane_store(const Wire& w, const ReadWire& r,
                                            int i, const PlaneWord& pw,
                                            int8_t* __restrict__ codes,
                                            uint8_t* __restrict__ hqb) {
  const long long r0 = (long long)i * w.L;
  if (pw.p >= 0 && pw.p + 8 <= w.L) {
    unsigned long long cw = 0, hw = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cw |= (unsigned long long)code_byte((pw.cb >> (2 * j)) & 3u,
                                          (pw.nh >> j) & 1u, pw.p + j, r.len)
            << (8 * j);
      hw |= (unsigned long long)((pw.nh >> (8 + j)) & 1u) << (8 * j);
    }
    reinterpret_cast<unsigned long long*>(codes)[pw.wd] = cw;
    reinterpret_cast<unsigned long long*>(hqb)[pw.wd] = hw;
    return;
  }
  for (int j = 0; j < 8; ++j) {
    const int q = pw.p + j;
    if (q < 0 || q >= w.L) continue;
    codes[r0 + q] = (int8_t)code_byte(
        (uint32_t)wire_bits(w, r.code + 2 * q, 2),
        (uint32_t)wire_bits(w, r.nmask + q, 1), q, r.len);
    hqb[r0 + q] = (uint8_t)wire_bits(w, r.hq + q, 1);
  }
}

// A row's 128-byte lines: 16 slots each, 4 a row. A quad of 8 lanes
// reads one line, lane t of the quad its 16 bytes (slots 2t, 2t + 1).
__device__ __forceinline__ uint4 line_load(const uint32_t* row, int line,
                                           int t) {
  return __ldg(reinterpret_cast<const uint4*>(row) + 8 * line + t);
}

// The value words of a group's windows, its window j (j < cnt) probed
// by quad j % 4 in its (j / 4)-th step: first the line of the key's
// preferred slot and line 0 (line 1 where those are one), which hold the
// key in a handoff table (at or a few slots after its preferred slot)
// and in a table HK7 loaded (packed from slot 0); then, only for the
// windows whose key neither line holds, the row's other two lines. Every
// lane calls it; the group is windows j0 .. j0 + cnt - 1 of the chunk's
// list (wlane: window j's lane; myj the calling lane's place in it), and
// the lane of a window of the group gets its value word (0 where the row
// lacks the key).
template <int NQ, class Acc>
__device__ __forceinline__ uint32_t quad_probe(const Acc& rows, KeyParts kp,
                                               const uint8_t* wlane, int j0,
                                               int cnt, int myj, int bits,
                                               int lane) {
  const int q = lane >> 3, t = lane & 7;
  const bool isw = myj >= j0 && myj < j0 + cnt;
  KeyParts p[NQ];
  const uint32_t* rp[NQ];
  int la[NQ];
  uint4 wa[NQ], wb[NQ];
#pragma unroll
  for (int s = 0; s < NQ; ++s) {
    const int j = 4 * s + q;
    const bool on = j < cnt;
    p[s] = shfl_parts(kp, on ? wlane[j0 + j] : 0);
    rp[s] = rows.row(p[s].addr);
    la[s] = preferred_slot(p[s].rlo, p[s].rhi) >> 4;
    wa[s] = on ? line_load(rp[s], la[s], t) : make_uint4(0u, 0u, 0u, 0u);
    wb[s] = on ? line_load(rp[s], la[s] ? 0 : 1, t)
               : make_uint4(0u, 0u, 0u, 0u);
  }
  unsigned unres = 0;  // bit j: window j's key is in neither line
  uint32_t v = 0;
#pragma unroll
  for (int s = 0; s < NQ; ++s) {
    uint32_t va = 0, vb = 0;
    const bool ha = pair_match(wa[s], p[s], bits, &va);
    const bool hb = pair_match(wb[s], p[s], bits, &vb);
    const unsigned ball = __ballot_sync(FULL_MASK, ha || hb);
    const int mq = (myj - j0) & 3;
    const unsigned qb = (ball >> (8 * mq)) & 0xFFu;
    const uint32_t got = __shfl_sync(FULL_MASK, ha ? va : vb,
                                     qb ? 8 * mq + __ffs(qb) - 1 : 0);
    if (isw && ((myj - j0) >> 2) == s && qb) v = got;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (4 * s + r < cnt && !((ball >> (8 * r)) & 0xFFu))
        unres |= 1u << (4 * s + r);
  }
  if (unres) {
#pragma unroll
    for (int s = 0; s < NQ; ++s) {
      const bool on = (unres >> (4 * s + q)) & 1u;
      const int a = la[s];
      const int c = a == 0 ? 2 : a == 1 ? 2 : 1;  // the lines not yet read
      const int d = a == 0 ? 3 : a == 3 ? 2 : 3;
      wa[s] = on ? line_load(rp[s], c, t) : make_uint4(0u, 0u, 0u, 0u);
      wb[s] = on ? line_load(rp[s], d, t) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int s = 0; s < NQ; ++s) {
      if (!((unres >> (4 * s)) & 0xFu)) continue;  // warp-uniform
      uint32_t va = 0, vb = 0;
      const bool on = (unres >> (4 * s + q)) & 1u;
      const bool ha = on && pair_match(wa[s], p[s], bits, &va);
      const bool hb = on && pair_match(wb[s], p[s], bits, &vb);
      const unsigned ball = __ballot_sync(FULL_MASK, ha || hb);
      const int mq = (myj - j0) & 3;
      const unsigned qb = (ball >> (8 * mq)) & 0xFFu;
      const uint32_t got = __shfl_sync(FULL_MASK, ha ? va : vb,
                                       qb ? 8 * mq + __ffs(qb) - 1 : 0);
      if (isw && ((myj - j0) >> 2) == s && qb) v = got;
    }
  }
  return v;
}

template <class Acc, bool CONTAM>
__global__ void head_kernel(Wire w, const __grid_constant__ Acc rows,
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
  __shared__ uint8_t wlanes[HEAD_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * HEAD_WARPS + (threadIdx.x >> 5);
  if (i >= w.b) return;  // whole warps
  uint8_t* wlane = wlanes[threadIdx.x >> 5];
  const ReadWire rw = read_wire(w, i);
  // the planes' first 256 positions: loaded now, stored after the scan
  const long long pw0 = ((long long)i * w.L) >> 3;
  const long long pw1 = ((long long)i * w.L + w.L + 7) >> 3;
  const PlaneWord first = plane_load(w, rw, i, pw0 + lane);
  const int k = c.k, len = rw.len;
  const int pend = min(len, w.L);  // windows end before pend
  const unsigned long long kmask = (1ull << (2 * k)) - 1ull;
  int run = 0, hit_p = 0, kill_p = 0, hit_v = 0, v0 = 0;
  bool hit_found = false, kill_found = false;
  unsigned long long hit_x = 0;
  for (int base = max(c.skip, 0) + k - 1; base < pend && !hit_found;
       base += 32) {
    const int p = base + lane;
    bool vw = false;  // a valid window past `skip`
    unsigned long long x = 0;
    KeyParts kp{0u, 0u, 0u}, cp{0u, 0u, 0u};
    if (p < pend) {
      const int s = p - k + 1;  // the window's first base
      vw = wire_bits(w, rw.nmask + s, k) == 0;
      if (vw) {
        x = wire_bits(w, rw.code + 2 * s, 2 * k);
        const uint64_t m = canonical(rev2(x) >> (64 - 2 * k), ~x & kmask);
        kp = key_parts(m, k, c.rb, c.bits);
        if (CONTAM) cp = key_parts(m, k, c.crb, c.cbits);
      }
    }
    const bool checked = vw && p <= len - 2;
    const unsigned vm = __ballot_sync(FULL_MASK, vw);
    if (!vm) {  // no valid window: every position resets the run
      run = 0;
      continue;
    }
    // the chunk's valid windows in position order: window j's lane
    const int nv = __popc(vm), myj = __popc(vm & ((1u << lane) - 1u));
    if (vw) wlane[myj] = (uint8_t)lane;
    __syncwarp();
    int vhq = 0, myrun = 0;
    bool con = false;
    for (int j0 = 0; j0 < nv && !hit_found; j0 += HEAD_GROUP) {
      const int cnt = min(nv - j0, HEAD_GROUP);
      const int last = wlane[j0 + cnt - 1];  // the group's last window
      // the contaminant rows go in flight first, beside the main lines
      KeyParts gc[HEAD_GROUP];
      int src[HEAD_GROUP];
      uint4 wc[HEAD_GROUP];
      if (CONTAM) {
#pragma unroll
        for (int j = 0; j < HEAD_GROUP; ++j) {
          src[j] = j < cnt ? wlane[j0 + j] : 0;
          gc[j] = shfl_parts(cp, src[j]);
          wc[j] = j < cnt ? warp_row_load(PlaneRows{crows}.row(gc[j].addr))
                          : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      const uint32_t mv = quad_probe<HEAD_GROUP / 4>(rows, kp, wlane, j0, cnt,
                                                     myj, c.bits, lane);
      if (vw && myj >= j0 && myj < j0 + cnt)
        vhq = (mv & 1u) ? (int)(mv >> 1) : 0;
      if (CONTAM) {
#pragma unroll
        for (int j = 0; j < HEAD_GROUP; ++j) {
          const bool cm = warp_row_match(wc[j], gc[j], c.cbits) != 0;
          if (j < cnt && lane == src[j]) con = cm;
        }
      }
      // lanes whose window is resolved (probed, or invalid)
      const unsigned done = j0 + cnt < nv ? (2u << last) - 1u : FULL_MASK;
      // run at p = good windows since the last reset at or before p, over
      // the resolved lanes (the run at a lane reads only lanes below it)
      const bool res = (done >> lane) & 1u;
      const bool a = res && checked && !con && vhq >= c.anchor_count;
      const bool z = res && (!vw || (checked && !con &&
                                     vhq < c.anchor_count));
      const unsigned am = __ballot_sync(FULL_MASK, a);
      const unsigned zm = __ballot_sync(FULL_MASK, z);
      const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane
      const unsigned zl = zm & upto;
      if (zl) {
        const int lz = 31 - __clz(zl);
        myrun = __popc(am & upto & ~((2u << lz) - 1u));
      } else {
        myrun = run + __popc(am & upto);
      }
      const unsigned hm = __ballot_sync(FULL_MASK, a && myrun >= c.good);
      if (hm) {
        const int hl = __ffs(hm) - 1;
        hit_found = true;
        hit_p = base + hl;
        hit_x = __shfl_sync(FULL_MASK, x, hl);
        hit_v = __shfl_sync(FULL_MASK, vhq, hl);
      }
    }
    __syncwarp();  // wlane is rewritten by the next chunk
    if (CONTAM) {  // the first kill before the anchor (none after it)
      const unsigned km = __ballot_sync(FULL_MASK, !c.trim && checked && con);
      if (km && !kill_found) {
        kill_found = true;
        kill_p = base + __ffs(km) - 1;
      }
    }
    if (base == 0) v0 = __shfl_sync(FULL_MASK, vhq, 0);  // k = 1, skip 0
    run = __shfl_sync(FULL_MASK, myrun, 31);
  }
  if (pw0 + lane < pw1) plane_store(w, rw, i, first, codes, hqb);
  for (long long wd = pw0 + lane + 32; wd < pw1; wd += 32)
    plane_store(w, rw, i, plane_load(w, rw, i, wd), codes, hqb);
  if (lane == 0) {
    const bool killed = kill_found && (!hit_found || kill_p < hit_p);
    const bool ok = hit_found && !killed;
    unsigned long long f, r;
    if (ok) {
      f = rev2(hit_x) >> (64 - 2 * k);
      r = ~hit_x & kmask;
    } else {  // position 0's mers: base 0 (A where N or past the read)
      const bool at0 = w.L > 0;  // no position 0 in a zero-width batch
      const uint64_t b0 = at0 && len > 0 && !wire_bits(w, rw.nmask, 1)
                              ? wire_bits(w, rw.code, 2)
                              : 0;
      f = at0 ? b0 : 0;
      r = at0 ? (3ull - b0) << (2 * (k - 1)) : 0;
    }
    lengths[i] = len;
    found[i] = ok;
    start_off[i] = (hit_found ? hit_p : 0) + 1;
    anc_f[i] = (long long)f;
    anc_r[i] = (long long)r;
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
  const Wire w{wire, B, L, off_nmask, off_hq, off_len};
  if (B > 0 && crows)
    head_kernel<Acc, true><<<grid, 32 * HEAD_WARPS, 0,
                             (cudaStream_t)stream>>>(
        w, rows, crows, c, codes, hqb, lengths, found, start_off, anc_f,
        anc_r, prev, status);
  else if (B > 0)
    head_kernel<Acc, false><<<grid, 32 * HEAD_WARPS, 0,
                              (cudaStream_t)stream>>>(
        w, rows, crows, c, codes, hqb, lengths, found, start_off, anc_f,
        anc_r, prev, status);
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
