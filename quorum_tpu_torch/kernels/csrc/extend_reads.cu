// HK4 extend_reads: stage-2 extension of every anchored read, both
// directions.
//
// Replaces the TPU path quorum_tpu/models/corrector.py:1095 (extend /
// _extend_loop :549 with _gba :265, _gba_reduce :238, _log_append :107,
// _log_remove_last_window :135, _append_trunc :155, _advance_lwin :94),
// the float32 Poisson term of ops/poisson.py:45 (K15), the
// reverse-complement frame of _rc_prologue / _bwd_epilogue
// (corrector.py:1181-1223, K12) and the contaminant checks of the
// extension (_contam_hit :286; con1 :806-812, con2 :864-871, con3
// :962-968).
//
// Design: one warp per (read, direction) lane runs the reference's
// sequential extension (models/oracle.py:350-505, error_correct_reads.cc
// :384-565) directly: a GPU has per-lane control flow, so the TPU's
// lockstep masks, compaction caps and stall-and-retry are gone. The 32
// threads of the warp walk the lane in lockstep: every branch depends on
// values that all 32 load from one address (one broadcast transaction),
// so the warp never diverges, and only thread 0 writes (the bases, the
// logs, the lane's words). What the warp buys is the probe: each table
// probe reads its 512-byte row as one coalesced request, a thread 16
// bytes (table.cuh warp_probe: a ballot picks the matching slot pair and
// a shuffle hands its value word to the warp), and the probes of one step
// go out together before any compare -- get_best_alternatives' 4 variant
// rows in one round trip, the ambiguous step's up to 16 continuation rows
// in two rounds of 8 -- where a thread's own row scan took 8 dependent
// round trips a miss, about 30 a get_best_alternatives. A block holds two
// lanes, so a slow lane keeps one other lane's slot waiting, and 2B lanes
// fill the card with 16,384 warps at B = 8192 (one thread a lane filled
// 6% of it). The backward lane steps d = -1 in the read's own frame
// instead of running in a reverse-complement frame (K12 is computed by
// stepping, not by mirroring); like that frame, it shifts a non-ACGT base
// in as T. The Poisson keep test reads a host-built table of the float32
// outcome over (sum of kept counts, c_ori), so no float math runs here.
// The edit logs (err_log.hpp) live in global memory, maxe entries a lane;
// the window advance reads them back after a __syncwarp.
//
// The contaminant entry (CONTAM) probes a second table, with its own
// geometry (rb, bits), for the shifted mer when the read's base is ACGT
// and for each substituted mer (log_substitution, error_correct_reads.cc
// :360-379): a hit logs a truncation at the position and ends the lane
// under `trim`, else it ends the lane with status ST_CONTAMINANT and no
// entry. Each lane writes its own status word (the anchor status it
// started from, or ST_CONTAMINANT); HK14 merges the two lanes of a read,
// the forward one's first (_bwd_epilogue :1212), so no word is shared.
//
// The sharded-table entry (extend_reads_shard) runs the same lanes
// against a table sharded by leading row bits, read in place (table.cuh
// ShardRows, the routed stage-2 layout; it replaces the routed lookups
// of quorum_tpu/parallel/tile_sharded.py:878 correct_step_routed and
// :909 correct_step_wire(routed_meta=) through corrector._db_lookup
// :184). JAX's routed extension keeps every shard in lockstep (pmax on
// the loop condition) around two all_to_all exchanges per lookup; here
// each lane walks its own extension and a probe reads the owner's row
// directly, on this card or over NVLink. The contaminant set stays one
// plane on this card. Both contaminant variants, as for the plane entry.
//
// The event entry (extend_reads_event, and extend_reads_event_shard on
// the sharded table) is the JAX package's default event mode
// (_extend_loop with planes, corrector.py:549: the teleport :769-790, the
// mixed gba :815-845, the pre-passed tie-break :903-930), reading HK17's
// [2B, L] frame planes. A lane is synced while its frame position is at
// or past `resync`, k past its last substitution. A synced lane at a
// clean position teleports to the next event (nd): its mer, and prev
// where a prev-defining keep lies in the run (lastc1 >= the start), come
// from the planes at the run's end, and the skipped bases keep the codes
// already in `out`. A synced step takes counts, level, count and ucode
// from cnt/aux and an ambiguous step its continuation bits from the
// pre-pass; a desynced step probes live, as the plain entry does (JAX's
// tail probe batches exactly those live steps; its stalls and lane
// draining only delay a lane). A backward lane at read position pos reads
// frame position len - 1 - pos of its reverse-complement row, whose
// variant v is read code 3 - v; the planes' windows hold a non-ACGT base
// as A in read orientation, so where a backward lane kept an N the synced
// step takes the planes' facts for a mer that is not its own, as JAX
// does (the departure from the reference, ROADMAP Queue 3).
//
// Frame planes: read in place with broadcast loads. A teleport takes two
// dependent trips (clean beside nd, then the four run-end elements
// together), a synced step one (cnt and aux beside the codes). Staging
// the lane's plane row in shared memory instead would copy 37 B x L a
// lane (5.9 KB a warp at L = 160; ~97 MB a launch at B = 8192, ~29 us at
// 3.35 TB/s, H100 data sheet) and hold that much shared memory for each
// resident warp (38 warps an SM at most at L = 160).
//
// Bound: bytes. Each step of a lane makes 4 probes (16 more on an
// ambiguous base); the least traffic is one read of every row the run
// probes, plus the codes/quals in and the corrected bases and logs out;
// the same for the sharded-table entry (its pointer table is one kernel
// parameter). The event entry's least traffic is the plane bytes its
// lanes read (one position a teleport or synced step) and the rows of
// its desynced steps' probes.
#include "table.cuh"

#define ST_OK 0
#define ST_CONTAMINANT 1
#define AX_COUNT 1
#define AX_UCODE 4
#define AX_PRE 6
#define AX_SUCC 8
#define AX_CWN 12

// HK17's frame planes, [2B, L] each.
struct Planes {
  const uint8_t* clean;
  const int *nd, *cnt, *aux, *lastc1, *prevval;
  const long long *mf, *mr;
};

struct Cfg {
  int k, rb, bits, crb, cbits, trim, L, window, error, min_count, cutoff,
      maxe;
};

#define EXT_WARPS 2  // lanes (warps) a block

__device__ __forceinline__ bool contam_hit(const uint32_t* crows,
                                           const Cfg& c, uint64_t f,
                                           uint64_t r) {
  const uint64_t key[1] = {canonical(f, r)};
  uint32_t val[1];
  warp_probe<1>(PlaneRows{crows}, key, 1u, c.k, c.crb, c.cbits, val);
  return val[0] != 0;
}

// get_best_alternatives (mer_database.hpp:302-329) of the 4 variants'
// value words.
__device__ __forceinline__ void gba_reduce(const uint32_t* val,
                                           int counts[4], int& ucode,
                                           int& level, int& count) {
  level = 0;
#pragma unroll
  for (int v = 0; v < 4; ++v)
    if ((val[v] >> 1) > 0 && (int)(val[v] & 1u) > level) level = 1;
  count = 0;
  ucode = 0;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    counts[v] = ((val[v] >> 1) > 0 && (int)(val[v] & 1u) == level)
                    ? (int)(val[v] >> 1) : 0;
    if (counts[v] > 0) {
      ++count;
      ucode = v;
    }
  }
}

// The canonical keys of the mer with its first base (in the direction of
// travel) set to each of the 4 codes.
__device__ __forceinline__ void variant_keys(uint64_t f, uint64_t r, int d,
                                             int k, uint64_t* keys) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    uint64_t fv = f, rv = r;
    dir_replace0(fv, rv, v, d, k);
    keys[v] = canonical(fv, rv);
  }
}

// The warp's get_best_alternatives: the 4 variant rows in one round.
template <class Acc>
__device__ __forceinline__ void gba(const Acc& rows, const Cfg& c,
                                    uint64_t f, uint64_t r, int d,
                                    int counts[4], int& ucode, int& level,
                                    int& count) {
  uint64_t keys[4];
  uint32_t val[4];
  variant_keys(f, r, d, c.k, keys);
  warp_probe<4>(rows, keys, 0xFu, c.k, c.rb, c.bits, val);
  gba_reduce(val, counts, ucode, level, count);
}

// One lane's err_log (err_log.hpp:22-135), raw read positions.
struct Log {
  int* pos;
  int* meta;
  int n, lwin, d, window, error, maxe;
  int* overflow;
  bool lead;  // the warp's thread 0, the one that writes

  __device__ void check() {  // check_nb_error's window advance
    if (n == 0) return;
    const int back = pos[n - 1];
    const bool guard = d > 0 ? back > window : back < window;
    if (guard)
      while (d * (back - pos[lwin]) > window) ++lwin;
  }
  __device__ bool append(int raw, int m) {
    if (n >= maxe) {
      if (lead) *overflow = 1;
      return false;
    }
    if (lead) {
      pos[n] = raw;
      meta[n] = m;
    }
    __syncwarp();  // check() reads pos[] on every thread of the warp
    ++n;
    check();
    return n - lwin - 1 >= error;
  }
  __device__ void truncation(int raw) {  // backward records raw + 1
    append(d < 0 ? raw + 1 : raw, 1);
  }
  __device__ int remove_last_window() {
    if (n == 0) return 0;
    const int diff = d * (pos[n - 1] - pos[lwin]);
    n = lwin;
    lwin = 0;
    check();
    return diff;
  }
};

__device__ __forceinline__ int sub_meta(int frm, int to) {
  return ((frm >= 0 ? frm : 4) << 1) | ((to >= 0 ? to : 4) << 4);
}

template <class Acc, bool CONTAM, bool EVENT>
__global__ void __launch_bounds__(32 * EXT_WARPS) extend_kernel(
    const __grid_constant__ Acc rows, const uint32_t* __restrict__ crows,
    Cfg c, const int8_t* __restrict__ codes,
    const uint8_t* __restrict__ hqb, const int* __restrict__ lengths,
    const int* __restrict__ status0, const int* __restrict__ start_off,
    const long long* __restrict__ anc_f, const long long* __restrict__ anc_r,
    const int* __restrict__ prev0, const uint8_t* __restrict__ keep,
    Planes pl, int B, int8_t* out, int* start, int* end, int* lstatus,
    int* log_n, int* log_lwin, int* log_pos, int* log_meta, int* overflow) {
  const int lane = blockIdx.x * EXT_WARPS + (threadIdx.x >> 5);
  if (lane >= 2 * B) return;  // whole warps
  const bool lead = (threadIdx.x & 31) == 0;
  const int i = lane < B ? lane : lane - B;
  const int d = lane < B ? 1 : -1;
  const int k = c.k;
  const int so = start_off[i];
  Log lg{log_pos + (size_t)lane * c.maxe, log_meta + (size_t)lane * c.maxe,
         0, 0, d, c.window, c.error, c.maxe, overflow, lead};
  int st = status0[i];
  if (st != ST_OK) {  // not anchored
    if (lead) {
      if (d > 0) end[i] = so; else start[i] = so - k;
      lstatus[lane] = st;
      log_n[lane] = 0;
      log_lwin[lane] = 0;
    }
    return;
  }
  const int8_t* rc = codes + (size_t)i * c.L;
  const uint8_t* rq = hqb + (size_t)i * c.L;
  int8_t* ro = out + (size_t)i * c.L;
  const int len = lengths[i];
  const int endp = d > 0 ? len : -1;
  const int maxv = (1 << c.bits) - 1;
  uint64_t f = (uint64_t)anc_f[i], r = (uint64_t)anc_r[i];
  int prev = prev0[i];
  int pos = d > 0 ? so : so - k - 1;
  int opos = pos;
  // event mode: this lane's plane row, and resync in frame positions
  const size_t prow = (size_t)lane * c.L;
  int resync = -(1 << 30);
  while (d > 0 ? pos < endp : pos > endp) {
    if (EVENT) {  // teleport over a clean run
      const int fp = d > 0 ? pos : len - 1 - pos;
      if (fp >= resync) {
        const int nd = pl.nd[prow + fp];  // loaded beside clean
        if (pl.clean[prow + fp]) {
          const int tgt = min(nd, len);
          const size_t at = prow + (tgt - 1);
          const uint64_t mf = (uint64_t)pl.mf[at], mr = (uint64_t)pl.mr[at];
          const int lc = pl.lastc1[at], pv = pl.prevval[at];
          f = d > 0 ? mf : mr;
          r = d > 0 ? mr : mf;
          if (lc >= fp) prev = pv;
          opos += d * (tgt - fp);
          pos = d > 0 ? tgt : len - 1 - tgt;
          if (!(d > 0 ? pos < endp : pos > endp)) break;
        }
      }
    }
    const int cpos = pos;
    const int cfp = d > 0 ? cpos : len - 1 - cpos;
    const bool synced = EVENT && cfp >= resync;
    const int ori = rc[cpos];
    const bool qb = rq[cpos] != 0;
    int pc = 0, pa = 0;  // the synced step's cnt and aux words
    if (synced) {
      pc = pl.cnt[prow + cfp];
      pa = pl.aux[prow + cfp];
    }
    pos += d;
    dir_shift(f, r, ori >= 0 ? ori : (d > 0 ? 0 : 3), d, k);
    if (CONTAM && ori >= 0 && contam_hit(crows, c, f, r)) {  // con1
      if (c.trim) lg.truncation(cpos); else st = ST_CONTAMINANT;
      break;
    }
    int counts[4], ucode, level, count;
    if (synced) {  // the planes' facts; variant v is read code 3 - v backward
      for (int v = 0; v < 4; ++v)
        counts[v] = (pc >> (7 * (d > 0 ? v : 3 - v))) & 127;
      level = pa & 1;
      count = (pa >> AX_COUNT) & 7;
      ucode = (pa >> AX_UCODE) & 3;
      if (d < 0) ucode = 3 - ucode;
    } else {
      gba(rows, c, f, r, d, counts, ucode, level, count);
    }
    if (count == 0) {
      lg.truncation(cpos);
      break;
    }
    if (count == 1) {
      prev = counts[ucode];
      if (ori != ucode) {
        dir_replace0(f, r, ucode, d, k);
        if (EVENT) resync = cfp + k;
        if (CONTAM && contam_hit(crows, c, f, r)) {  // con2
          if (c.trim) lg.truncation(cpos); else st = ST_CONTAMINANT;
          break;
        }
        if (lg.append(cpos, sub_meta(ori, ucode))) {
          const int diff = lg.remove_last_window();
          lg.truncation(cpos - d * diff);
          opos -= d * diff;
          break;
        }
      }
      if (lead) ro[opos] = (int8_t)dir_base0(f, d, k);
      opos += d;
      continue;
    }
    if (ori >= 0) {
      const int c_ori = counts[ori];
      if (c_ori > c.min_count) {
        bool kp = c_ori >= c.cutoff || qb;
        if (!kp) {
          const int s = counts[0] + counts[1] + counts[2] + counts[3];
          kp = keep[(size_t)s * (maxv + 1) + c_ori] != 0;
        }
        if (kp) {
          if (lead) ro[opos] = (int8_t)dir_base0(f, d, k);
          opos += d;
          continue;
        }
      } else if (level == 0 && c_ori == 0) {
        lg.truncation(cpos);
        break;
      }
    } else if (level == 0) {
      lg.truncation(cpos);
      break;
    }
    // multiple alternatives (error_correct_reads.cc:473-545)
    int check = ori;
    bool success = false;
    int cont[4] = {0, 0, 0, 0};
    bool cwn[4] = {false, false, false, false};
    const int nb = (d > 0 ? pos < endp : pos > endp) ? rc[pos] : -1;
    unsigned cand = 0;  // the variants past min_count
    for (int v = 0; v < 4; ++v)
      if (counts[v] > c.min_count) {
        cand |= 1u << v;
        check = v;
      }
    if (synced && ((pa >> AX_PRE) & 1)) {  // the frame variants' pre-pass bits
      for (int v = 0; v < 4; ++v) {
        const int fv = d > 0 ? v : 3 - v;
        if (((cand >> v) & 1u) && ((pa >> (AX_SUCC + fv)) & 1)) {
          cwn[v] = nb >= 0 && ((pa >> (AX_CWN + fv)) & 1);
          success = true;
          cont[v] = counts[v];
        }
      }
    } else {
      // each candidate's next mer (the variant in, a base shifted on)
      // and its get_best_alternatives: two candidates' 8 rows a round
#pragma unroll
      for (int h = 0; h < 4; h += 2) {
        const unsigned want = ((cand >> h) & 1u ? 0x0Fu : 0u) |
                              ((cand >> (h + 1)) & 1u ? 0xF0u : 0u);
        if (!want) continue;
        uint64_t keys[8];
        uint32_t val[8];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint64_t nf = f, nr = r;
          dir_replace0(nf, nr, h + j, d, k);
          dir_shift(nf, nr, 0, d, k);
          variant_keys(nf, nr, d, k, keys + 4 * j);
        }
        warp_probe<8>(rows, keys, want, c.k, c.rb, c.bits, val);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int v = h + j;
          if (!((cand >> v) & 1u)) continue;
          int ncounts[4], nu, nlevel, ncount;
          gba_reduce(val + 4 * j, ncounts, nu, nlevel, ncount);
          if (ncount > 0 && nlevel >= level) {
            cwn[v] = nb >= 0 && ncounts[nb] > 0;
            success = true;
            cont[v] = counts[v];
          }
        }
      }
    }
    if (success) {
      // prev_count <= min_count: the reference's int overflow makes the
      // tie-break dead code (oracle.py:23-25) -- no candidate matches
      check = -1;
      if (prev > c.min_count) {
        int min_diff = 0x7FFFFFFF;
        for (int v = 0; v < 4; ++v) {
          const int df = abs(cont[v] - prev);
          if (cont[v] > 0 && df < min_diff) min_diff = df;
        }
        int ncand = 0;
        bool pick[4];
        for (int v = 0; v < 4; ++v) {
          pick[v] = abs(cont[v] - prev) == min_diff;
          if (pick[v]) {
            ++ncand;
            check = v;
          }
        }
        if (ncand > 1 && nb >= 0) {
          for (int v = 0; v < 4; ++v) {
            if (!pick[v]) continue;
            if (!cwn[v]) --ncand;
            else check = v;
          }
        }
        if (ncand != 1) check = -1;
      }
      if (check >= 0 && check != ori) {
        dir_replace0(f, r, check, d, k);
        if (EVENT) resync = cfp + k;
        if (CONTAM && contam_hit(crows, c, f, r)) {  // con3
          if (c.trim) lg.truncation(cpos); else st = ST_CONTAMINANT;
          break;
        }
        if (lg.append(cpos, sub_meta(ori, check))) {
          const int diff = lg.remove_last_window();
          lg.truncation(cpos - d * diff);
          opos -= d * diff;
          break;
        }
      }
    }
    if (ori < 0 && check < 0) {
      lg.truncation(cpos);
      break;
    }
    if (lead) ro[opos] = (int8_t)dir_base0(f, d, k);
    opos += d;
  }
  if (lead) {
    if (d > 0) end[i] = opos; else start[i] = opos + 1;
    lstatus[lane] = st;
    log_n[lane] = lg.n;
    log_lwin[lane] = lg.lwin;
  }
}

template <class Acc, bool EVENT>
static int launch_extend(
    const Acc& rows, const uint32_t* crows, const Cfg& c,
    const int8_t* codes, const uint8_t* hqb, const int* lengths,
    const int* status0, const int* start_off, const long long* anc_f,
    const long long* anc_r, const int* prev0, const uint8_t* keep,
    const Planes& pl, int B, int8_t* out, int* start, int* end,
    int* lstatus, int* log_n, int* log_lwin, int* log_pos, int* log_meta,
    int* overflow, void* stream) {
  const unsigned grid = (unsigned)((2 * B + EXT_WARPS - 1) / EXT_WARPS);
  if (B > 0 && crows)
    extend_kernel<Acc, true, EVENT><<<grid, 32 * EXT_WARPS, 0,
                                      (cudaStream_t)stream>>>(
        rows, crows, c, codes, hqb, lengths, status0, start_off, anc_f,
        anc_r, prev0, keep, pl, B, out, start, end, lstatus, log_n,
        log_lwin, log_pos, log_meta, overflow);
  else if (B > 0)
    extend_kernel<Acc, false, EVENT><<<grid, 32 * EXT_WARPS, 0,
                                       (cudaStream_t)stream>>>(
        rows, crows, c, codes, hqb, lengths, status0, start_off, anc_f,
        anc_r, prev0, keep, pl, B, out, start, end, lstatus, log_n,
        log_lwin, log_pos, log_meta, overflow);
  return (int)cudaGetLastError();
}

// `crows` null: the entry without a contaminant.
extern "C" int extend_reads(
    const uint32_t* rows, int k, int rb, int bits, const uint32_t* crows,
    int crb, int cbits, int trim, const int8_t* codes, const uint8_t* hqb,
    const int* lengths, const int* status0, const int* start_off,
    const long long* anc_f, const long long* anc_r, const int* prev0,
    const uint8_t* keep, int B, int L, int window, int error, int min_count,
    int cutoff, int maxe, int8_t* out, int* start, int* end, int* lstatus,
    int* log_n, int* log_lwin, int* log_pos, int* log_meta, int* overflow,
    void* stream) {
  Cfg c{k, rb, bits, crb, cbits, trim, L, window, error, min_count, cutoff,
        maxe};
  return launch_extend<PlaneRows, false>(
      PlaneRows{rows}, crows, c, codes, hqb, lengths, status0, start_off,
      anc_f, anc_r, prev0, keep, Planes{}, B, out, start, end, lstatus,
      log_n, log_lwin, log_pos, log_meta, overflow, stream);
}

// The sharded-table entry: `shards` a host array of n_shards plane
// pointers (2^local_rb rows each), rb the GLOBAL geometry.
extern "C" int extend_reads_shard(
    const uint32_t* const* shards, int n_shards, int local_rb, int k, int rb,
    int bits, const uint32_t* crows, int crb, int cbits, int trim,
    const int8_t* codes, const uint8_t* hqb, const int* lengths,
    const int* status0, const int* start_off, const long long* anc_f,
    const long long* anc_r, const int* prev0, const uint8_t* keep, int B,
    int L, int window, int error, int min_count, int cutoff, int maxe,
    int8_t* out, int* start, int* end, int* lstatus, int* log_n,
    int* log_lwin, int* log_pos, int* log_meta, int* overflow,
    void* stream) {
  ShardRows acc;
  if (!shard_rows(shards, n_shards, local_rb, &acc))
    return (int)cudaErrorInvalidValue;
  Cfg c{k, rb, bits, crb, cbits, trim, L, window, error, min_count, cutoff,
        maxe};
  return launch_extend<ShardRows, false>(
      acc, crows, c, codes, hqb, lengths, status0, start_off, anc_f, anc_r,
      prev0, keep, Planes{}, B, out, start, end, lstatus, log_n, log_lwin,
      log_pos, log_meta, overflow, stream);
}

// The event entries: the plain entries' arguments with HK17's eight frame
// planes after `keep` (clean2, nd, cnt2, aux2, lastc1, prevval, mf2, mr2).
extern "C" int extend_reads_event(
    const uint32_t* rows, int k, int rb, int bits, const uint32_t* crows,
    int crb, int cbits, int trim, const int8_t* codes, const uint8_t* hqb,
    const int* lengths, const int* status0, const int* start_off,
    const long long* anc_f, const long long* anc_r, const int* prev0,
    const uint8_t* keep, const uint8_t* clean2, const int* nd,
    const int* cnt2, const int* aux2, const int* lastc1, const int* prevval,
    const long long* mf2, const long long* mr2, int B, int L, int window,
    int error, int min_count, int cutoff, int maxe, int8_t* out, int* start,
    int* end, int* lstatus, int* log_n, int* log_lwin, int* log_pos,
    int* log_meta, int* overflow, void* stream) {
  Cfg c{k, rb, bits, crb, cbits, trim, L, window, error, min_count, cutoff,
        maxe};
  Planes pl{clean2, nd, cnt2, aux2, lastc1, prevval, mf2, mr2};
  return launch_extend<PlaneRows, true>(
      PlaneRows{rows}, crows, c, codes, hqb, lengths, status0, start_off,
      anc_f, anc_r, prev0, keep, pl, B, out, start, end, lstatus, log_n,
      log_lwin, log_pos, log_meta, overflow, stream);
}

extern "C" int extend_reads_event_shard(
    const uint32_t* const* shards, int n_shards, int local_rb, int k, int rb,
    int bits, const uint32_t* crows, int crb, int cbits, int trim,
    const int8_t* codes, const uint8_t* hqb, const int* lengths,
    const int* status0, const int* start_off, const long long* anc_f,
    const long long* anc_r, const int* prev0, const uint8_t* keep,
    const uint8_t* clean2, const int* nd, const int* cnt2, const int* aux2,
    const int* lastc1, const int* prevval, const long long* mf2,
    const long long* mr2, int B, int L, int window, int error, int min_count,
    int cutoff, int maxe, int8_t* out, int* start, int* end, int* lstatus,
    int* log_n, int* log_lwin, int* log_pos, int* log_meta, int* overflow,
    void* stream) {
  ShardRows acc;
  if (!shard_rows(shards, n_shards, local_rb, &acc))
    return (int)cudaErrorInvalidValue;
  Cfg c{k, rb, bits, crb, cbits, trim, L, window, error, min_count, cutoff,
        maxe};
  Planes pl{clean2, nd, cnt2, aux2, lastc1, prevval, mf2, mr2};
  return launch_extend<ShardRows, true>(
      acc, crows, c, codes, hqb, lengths, status0, start_off, anc_f, anc_r,
      prev0, keep, pl, B, out, start, end, lstatus, log_n, log_lwin,
      log_pos, log_meta, overflow, stream);
}
