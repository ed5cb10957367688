// HK16 event_planes: every window's get_best_alternatives facts, in the
// frame that consumes it, classified as the live extension step would
// take them, and the continuation probe of every ambiguous position.
//
// Replaces the TPU path quorum_tpu/models/corrector.py:1624
// (_event_planes, before its remap) with _frame_facts :1245,
// _sibling_mers :1276, _classify :1290, _pack_counts :1315,
// _class_planes :1324 (the full 3-probe sibling sweep, compact_sweep=False)
// and _ambig_prepass :1561, plus the own-window lookup of _position_sweep
// :312 that the planes read (HK5 stops probing at the anchor).
//
// Design. Pass 1 (event_classify): a thread per (read, window end e)
// for everything but the probes. It builds the window's mers from the
// int8 codes HK5 wrote (a non-ACGT base enters as A, taps before the read
// as 0: mer.rolling_kmers), picks the frame that consumes e -- forward
// for e >= start_off, the reverse-complement frame for e <= start_off -
// 2, where the frame's mer is the window's words swapped and the step
// adds the complement of the window's first base -- and hashes the own
// window and its 3 siblings (the other base-0 variants of the frame; a
// non-ACGT base is variant 0, as in the JAX sweep). The probes are the
// warp's together: the warp walks its 32 windows two at a time, every
// lane loading 16 bytes of each of the two windows' 4 rows (5 with the
// contaminant table), so each row comes in as one coalesced 512-byte
// request and all 8 (or 10) are in flight before any compare
// (table.cuh warp_probe_parts); a ballot finds the matching slot, and
// the window's own lane keeps the value word. A probe reads its whole
// row: a key sits at or after its preferred slot in a build table and
// from slot 0 in one HK7 loaded, so no slot range may be skipped. The
// classification then reads the host-built Poisson keep table (no float
// math here) and writes the clean bit, the packed counts, the aux fields,
// the own value word and the window's mers, coalesced, and appends each
// ambiguous-class position to a list (one atomic per warp). Pass 2
// (event_prepass): a warp per listed position (a grid-stride loop over
// the list, whose length only the device knows: no host sync). Lanes
// 0-15 hash the 16 continuation mers of error_correct_reads.cc:473-507
// (4 variants x 4 next bases), and the warp probes the rows of the
// variants whose count passes min_count, two variants (8 rows) in flight
// at a time, then or-s the success and continues-with-next-base bits
// into aux. JAX caps that list at max(256, B*L/16) positions and leaves
// the rest to the in-loop probe; here every listed position is probed
// (no cap).
//
// The contaminant variant (CONTAM) probes the window's canonical mer in a
// second table with its own geometry where the window is valid (k ACGT
// bases), and a member is not clean (_position_sweep's con). The
// sharded-table entries (event_classify_shard, event_prepass_shard) run
// the same passes against a table sharded by leading row bits, read in
// place (table.cuh ShardRows, the routed stage-2 layout).
//
// Bound: bytes. Each window reads its 512-byte row in 4 probes (the own
// window and 3 siblings; 5 with a contaminant table) and each ambiguous
// position up to 16 more; the planes out are 29 bytes a window. The
// function needs each distinct row once (chip_smoke.py counts them); the
// design reads a row per probe, and the rows of one batch repeat little
// in the 50 MB L2, so it moves about 512 bytes a probe.
#include "table.cuh"

#define AX_COUNT 1
#define AX_UCODE 4
#define AX_PRE 6
#define AX_C1K 7
#define AX_SUCC 8
#define AX_CWN 12
#define EV_THREADS 128

struct EvCfg {
  int k, rb, bits, crb, cbits, B, L, min_count, cutoff;
};

__device__ __forceinline__ int comp(int c) { return c >= 0 ? 3 - c : c; }

// get_best_alternatives' reduction (mer_database.hpp:302-329): counts
// kept only at the best quality level present; ucode the largest variant
// with a kept count.
__device__ __forceinline__ void gba_reduce(const uint32_t v[4],
                                           int counts[4], int& ucode,
                                           int& level, int& count) {
  level = 0;
  for (int j = 0; j < 4; ++j)
    if ((v[j] >> 1) > 0 && (int)(v[j] & 1u) > level) level = 1;
  count = 0;
  ucode = 0;
  for (int j = 0; j < 4; ++j) {
    const int cj = (int)(v[j] >> 1);
    counts[j] = (cj > 0 && (int)(v[j] & 1u) == level) ? cj : 0;
    if (counts[j] > 0) {
      ++count;
      ucode = j;
    }
  }
}

// The frame that consumes window end e of read row `rc` (length len,
// anchor start_off so): the base the step adds, its qual bit, the next
// base in frame direction (-1 past the read or non-ACGT).
struct Facts {
  int ori, nb;
  bool fwd, qual;
};

__device__ __forceinline__ Facts frame_facts(const int8_t* rc,
                                             const uint8_t* rq, int e,
                                             int len, int so, int k) {
  Facts x;
  x.fwd = e >= so;
  if (x.fwd) {
    x.ori = rc[e];
    x.qual = rq[e] != 0;
    x.nb = e + 1 < len ? rc[e + 1] : -1;
  } else {
    const int q = e - (k - 1);
    x.ori = q >= 0 ? comp(rc[q]) : -2;
    x.qual = q >= 0 && rq[q] != 0;
    x.nb = e - k >= 0 ? comp(rc[e - k]) : -1;
  }
  if (x.nb < 0) x.nb = -1;
  return x;
}

// a[i] for a runtime i in 0..3, without a local-memory array
template <class T>
__device__ __forceinline__ T pick4(const T (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

template <class Acc, bool CONTAM>
__global__ void __launch_bounds__(EV_THREADS) classify_kernel(
    const __grid_constant__ Acc rows, const uint32_t* __restrict__ crows,
    EvCfg c, const int8_t* __restrict__ codes,
    const uint8_t* __restrict__ hqb, const int* __restrict__ lengths,
    const int* __restrict__ start_off, const uint8_t* __restrict__ keep,
    uint8_t* __restrict__ clean, int* __restrict__ cnt,
    int* __restrict__ aux, int* __restrict__ val,
    long long* __restrict__ fout, long long* __restrict__ rout,
    int* __restrict__ amb, int* __restrict__ n_amb) {
  const long long n = (long long)c.B * c.L;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int k = c.k;
  const bool live = idx < n;  // the live lanes are a prefix of the warp
  Facts x{0, -1, true, false};
  bool valid = false;
  KeyParts kp[4] = {}, cp{0u, 0u, 0u};
  if (live) {
    const int i = (int)(idx / c.L), e = (int)(idx % c.L);
    const int8_t* rc = codes + (size_t)i * c.L;
    x = frame_facts(rc, hqb + (size_t)i * c.L, e, lengths[i], start_off[i],
                    k);
    uint64_t f = 0, r = 0;
    valid = e >= k - 1;
    for (int j = 0; j < k; ++j) {  // base at e-j -> bit 2j
      const int q = e - j;
      if (q < 0) break;  // taps before the read are 0 in both words
      int b = rc[q];
      if (b < 0) {
        valid = false;
        b = 0;
      }
      f |= (uint64_t)b << (2 * j);
      r |= (uint64_t)(3 - b) << (2 * (k - 1 - j));
    }
    fout[idx] = (long long)f;
    rout[idx] = (long long)r;
    const uint64_t own_key = canonical(f, r);
    const uint64_t wf = x.fwd ? f : r, wr = x.fwd ? r : f;
    const int orie = x.ori < 0 ? 0 : x.ori;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // the own window at variant orie
      uint64_t sf = wf, sr = wr;
      dir_replace0(sf, sr, j, 1, k);
      kp[j] = key_parts(j == orie ? own_key : canonical(sf, sr), k, c.rb,
                        c.bits);
    }
    if (CONTAM && valid) cp = key_parts(own_key, k, c.crb, c.cbits);
  }
  // the warp's probes, two windows (8 rows, 10 with the contaminant
  // table) in flight at a time; window w's lane keeps its value words
  const int nlive = __popc(__ballot_sync(FULL_MASK, live));
  const unsigned con_m = __ballot_sync(FULL_MASK, CONTAM && valid);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  bool con = false;
  for (int w0 = 0; w0 < nlive; w0 += 2) {
    const int w1 = w0 + 1 < nlive ? w0 + 1 : w0;
    KeyParts q[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      q[j] = shfl_parts(kp[j], w0);
      q[4 + j] = shfl_parts(kp[j], w1);
    }
    uint32_t got[8];
    if (CONTAM) {
      const KeyParts cq0 = shfl_parts(cp, w0), cq1 = shfl_parts(cp, w1);
      const bool c0 = (con_m >> w0) & 1u, c1 = w1 > w0 && (con_m >> w1) & 1u;
      const uint4 cr0 = c0 ? warp_row_load(PlaneRows{crows}.row(cq0.addr))
                           : make_uint4(0u, 0u, 0u, 0u);
      const uint4 cr1 = c1 ? warp_row_load(PlaneRows{crows}.row(cq1.addr))
                           : make_uint4(0u, 0u, 0u, 0u);
      warp_probe_parts<8>(rows, q, w1 > w0 ? 0xFFu : 0xFu, c.bits, got);
      const bool h0 = warp_row_match(cr0, cq0, c.cbits) != 0;
      const bool h1 = warp_row_match(cr1, cq1, c.cbits) != 0;
      if (lane == w0) con = h0;
      if (lane == w1 && w1 > w0) con = h1;
    } else {
      warp_probe_parts<8>(rows, q, w1 > w0 ? 0xFFu : 0xFu, c.bits, got);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (lane == w0) v[j] = got[j];
      if (lane == w1 && w1 > w0) v[j] = got[4 + j];
    }
  }
  bool ambig = false;
  if (live) {
    int counts[4], ucode, level, count;
    gba_reduce(v, counts, ucode, level, count);
    const int maxv = (1 << c.bits) - 1;
    const int c_ori = x.ori >= 0 ? pick4(counts, x.ori) : 0;
    const bool c1keep = count == 1 && ucode == x.ori;
    const bool ori_hi = x.ori >= 0 && c_ori > c.min_count;
    const bool keep_cut =
        count > 1 && ori_hi && (c_ori >= c.cutoff || x.qual);
    const int total = counts[0] + counts[1] + counts[2] + counts[3];
    const bool keep_poi = count > 1 && ori_hi && !keep_cut &&
                          keep[(size_t)total * (maxv + 1) + c_ori] != 0;
    const bool cl = (c1keep || keep_cut || keep_poi) && !con;
    const bool t_a = count > 1 && x.ori >= 0 && !ori_hi && level == 0 &&
                     c_ori == 0;
    const bool t_b = count > 1 && x.ori < 0 && level == 0;
    ambig = count > 1 && !(keep_cut || keep_poi) && !t_a && !t_b;
    clean[idx] = cl;
    cnt[idx] = counts[0] | (counts[1] << 7) | (counts[2] << 14) |
               (counts[3] << 21);
    aux[idx] = level | (count << AX_COUNT) | (ucode << AX_UCODE) |
               ((cl && c1keep) ? 1 << AX_C1K : 0);
    val[idx] = (int)pick4(v, x.ori < 0 ? 0 : x.ori);
  }
  // list the ambiguous positions: one atomic per warp
  const unsigned m = __ballot_sync(FULL_MASK, ambig);
  int at = 0;
  if (lane == 0 && m) at = atomicAdd(n_amb, __popc(m));
  at = __shfl_sync(FULL_MASK, at, 0);
  if (ambig) amb[at + __popc(m & ((1u << lane) - 1u))] = (int)idx;
}

template <class Acc>
__global__ void __launch_bounds__(EV_THREADS) prepass_kernel(
    const __grid_constant__ Acc rows, EvCfg c,
    const int8_t* __restrict__ codes, const int* __restrict__ lengths,
    const int* __restrict__ start_off, const int* __restrict__ cnt, int* aux,
    const long long* __restrict__ fin, const long long* __restrict__ rin,
    const int* __restrict__ amb, const int* __restrict__ n_amb) {
  const int n = *n_amb;
  const int k = c.k;
  const int lane = threadIdx.x & 31;
  const int wpb = EV_THREADS / 32;
  for (int t = blockIdx.x * wpb + (threadIdx.x >> 5); t < n;
       t += gridDim.x * wpb) {  // a warp per listed position
    const int idx = amb[t];
    const int i = idx / c.L, e = idx % c.L;
    const int8_t* rc = codes + (size_t)i * c.L;
    const bool fwd = e >= start_off[i];
    int nb = fwd ? (e + 1 < lengths[i] ? rc[e + 1] : -1)
                 : (e - k >= 0 ? comp(rc[e - k]) : -1);
    if (nb < 0) nb = -1;
    const uint64_t f = (uint64_t)fin[idx], r = (uint64_t)rin[idx];
    const uint64_t wf = fwd ? f : r, wr = fwd ? r : f;
    const int cw = cnt[idx];
    const int level = aux[idx] & 1;
    // lane 4v + j: variant v stepped on by next base j
    KeyParts mine{0u, 0u, 0u};
    if (lane < 16) {
      uint64_t vf = wf, vr = wr;
      dir_replace0(vf, vr, lane >> 2, 1, k);
      dir_shift(vf, vr, 0, 1, k);
      dir_replace0(vf, vr, lane & 3, 1, k);
      mine = key_parts(canonical(vf, vr), k, c.rb, c.bits);
    }
    int bits = 1 << AX_PRE;
#pragma unroll
    for (int v0 = 0; v0 < 4; v0 += 2) {
      const unsigned want =
          (((cw >> (7 * v0)) & 127) > c.min_count ? 0x0Fu : 0u) |
          (((cw >> (7 * (v0 + 1))) & 127) > c.min_count ? 0xF0u : 0u);
      if (!want) continue;
      KeyParts q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] = shfl_parts(mine, 4 * v0 + j);
      uint32_t nv8[8];
      warp_probe_parts<8>(rows, q, want, c.bits, nv8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!((want >> (4 * h)) & 1u)) continue;
        const uint32_t nv[4] = {nv8[4 * h], nv8[4 * h + 1], nv8[4 * h + 2],
                                nv8[4 * h + 3]};
        int ncounts[4], nu, nlevel, ncount;
        gba_reduce(nv, ncounts, nu, nlevel, ncount);
        if (ncount > 0 && nlevel >= level) {
          bits |= 1 << (AX_SUCC + v0 + h);
          if (nb >= 0 && pick4(ncounts, nb) > 0)
            bits |= 1 << (AX_CWN + v0 + h);
        }
      }
    }
    if (lane == 0) aux[idx] |= bits;
  }
}

static inline unsigned ev_grid(long long n) {
  return (unsigned)((n + EV_THREADS - 1) / EV_THREADS);
}

template <class Acc>
static int launch_classify(const Acc& rows, const uint32_t* crows,
                           const EvCfg& c, const int8_t* codes,
                           const uint8_t* hqb, const int* lengths,
                           const int* start_off, const uint8_t* keep,
                           uint8_t* clean, int* cnt, int* aux, int* val,
                           long long* f, long long* r, int* amb, int* n_amb,
                           void* stream) {
  const long long n = (long long)c.B * c.L;
  if (n > 0 && crows)
    classify_kernel<Acc, true><<<ev_grid(n), EV_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        rows, crows, c, codes, hqb, lengths, start_off, keep, clean, cnt,
        aux, val, f, r, amb, n_amb);
  else if (n > 0)
    classify_kernel<Acc, false><<<ev_grid(n), EV_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        rows, crows, c, codes, hqb, lengths, start_off, keep, clean, cnt,
        aux, val, f, r, amb, n_amb);
  return (int)cudaGetLastError();
}

template <class Acc>
static int launch_prepass(const Acc& rows, const EvCfg& c,
                          const int8_t* codes, const int* lengths,
                          const int* start_off, const int* cnt, int* aux,
                          const long long* f, const long long* r,
                          const int* amb, const int* n_amb, void* stream) {
  // a grid-stride loop, a warp a listed position, over a list whose
  // length only the device knows (no host sync): sized for every window,
  // capped at 16 blocks an SM of the H100's 132
  const long long n = (long long)c.B * c.L;
  unsigned grid = ev_grid(n);
  if (grid > 132 * 16) grid = 132 * 16;
  if (n > 0)
    prepass_kernel<Acc><<<grid, EV_THREADS, 0, (cudaStream_t)stream>>>(
        rows, c, codes, lengths, start_off, cnt, aux, f, r, amb, n_amb);
  return (int)cudaGetLastError();
}

// `crows` null: the entry without a contaminant. `n_amb` must be zero.
extern "C" int event_classify(const uint32_t* rows, int k, int rb, int bits,
                              const uint32_t* crows, int crb, int cbits,
                              const int8_t* codes, const uint8_t* hqb,
                              const int* lengths, const int* start_off,
                              const uint8_t* keep, int B, int L,
                              int min_count, int cutoff, uint8_t* clean,
                              int* cnt, int* aux, int* val, long long* f,
                              long long* r, int* amb, int* n_amb,
                              void* stream) {
  EvCfg c{k, rb, bits, crb, cbits, B, L, min_count, cutoff};
  return launch_classify(PlaneRows{rows}, crows, c, codes, hqb, lengths,
                         start_off, keep, clean, cnt, aux, val, f, r, amb,
                         n_amb, stream);
}

extern "C" int event_prepass(const uint32_t* rows, int k, int rb, int bits,
                             const int8_t* codes, const int* lengths,
                             const int* start_off, int B, int L,
                             int min_count, const int* cnt, int* aux,
                             const long long* f, const long long* r,
                             const int* amb, const int* n_amb,
                             void* stream) {
  EvCfg c{k, rb, bits, 0, 0, B, L, min_count, 0};
  return launch_prepass(PlaneRows{rows}, c, codes, lengths, start_off, cnt,
                        aux, f, r, amb, n_amb, stream);
}

// The sharded-table entries: `shards` a host array of n_shards plane
// pointers (2^local_rb rows each), rb the GLOBAL geometry.
extern "C" int event_classify_shard(
    const uint32_t* const* shards, int n_shards, int local_rb, int k, int rb,
    int bits, const uint32_t* crows, int crb, int cbits, const int8_t* codes,
    const uint8_t* hqb, const int* lengths, const int* start_off,
    const uint8_t* keep, int B, int L, int min_count, int cutoff,
    uint8_t* clean, int* cnt, int* aux, int* val, long long* f, long long* r,
    int* amb, int* n_amb, void* stream) {
  ShardRows acc;
  if (!shard_rows(shards, n_shards, local_rb, &acc))
    return (int)cudaErrorInvalidValue;
  EvCfg c{k, rb, bits, crb, cbits, B, L, min_count, cutoff};
  return launch_classify(acc, crows, c, codes, hqb, lengths, start_off, keep,
                         clean, cnt, aux, val, f, r, amb, n_amb, stream);
}

extern "C" int event_prepass_shard(const uint32_t* const* shards,
                                   int n_shards, int local_rb, int k, int rb,
                                   int bits, const int8_t* codes,
                                   const int* lengths, const int* start_off,
                                   int B, int L, int min_count,
                                   const int* cnt, int* aux,
                                   const long long* f, const long long* r,
                                   const int* amb, const int* n_amb,
                                   void* stream) {
  ShardRows acc;
  if (!shard_rows(shards, n_shards, local_rb, &acc))
    return (int)cudaErrorInvalidValue;
  EvCfg c{k, rb, bits, 0, 0, B, L, min_count, 0};
  return launch_prepass(acc, c, codes, lengths, start_off, cnt, aux, f, r,
                        amb, n_amb, stream);
}
