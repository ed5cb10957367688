"""The plain versions of HK9 (batch_aggregate), HK10 (sketch_update and
its query), HK11 (gated_insert, two-pass and inline), HK2's singleton
statistic and HK12 (tile_floor) against the JAX package's singleton
prefilter (quorum_tpu/ops/sketch.py) and presence floor
(quorum_tpu/ops/ctable.py:tile_floor) on the same seeded reads: the
inputs of tests/test_memfrugal.py (k = 15, 512 x 80 bp, 1%
substitutions), all high quality or with ~10% low-quality bases.
Integer work throughout: every comparison is exact."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quorum_tpu.io import packing as jpacking
from quorum_tpu.ops import ctable as jct
from quorum_tpu.ops import sketch as jsk
from quorum_tpu_torch import kernels
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.io import fastq as tfastq
from quorum_tpu_torch.io import packing as tpacking
from quorum_tpu_torch.kernels import reference as ref
from quorum_tpu_torch.models import create_database as tcdb
from quorum_tpu_torch.ops import ctable as tct
from quorum_tpu_torch.ops import sketch as tsk

K = 15
READ_LEN = 80
N_READS = 512
BATCH = 256
QT = 38
M32 = 0xFFFFFFFF


def memfrugal_reads(low_q: bool):
    """tests/test_memfrugal.py's reads (seed 17); with `low_q`, ~10% of
    the bases get a quality below QT (seed 18)."""
    rng = np.random.default_rng(17)
    genome = rng.integers(0, 4, size=5000, dtype=np.int8)
    starts = rng.integers(0, len(genome) - READ_LEN, size=N_READS)
    idx = starts[:, None] + np.arange(READ_LEN)[None, :]
    truth = genome[idx]
    errs = rng.random(truth.shape) < 0.01
    codes = np.where(errs, (truth + rng.integers(
        1, 4, size=truth.shape)) % 4, truth).astype(np.int8)
    quals = np.full(codes.shape, 70, np.uint8)
    if low_q:
        quals[np.random.default_rng(18).random(codes.shape) < 0.1] = 35
    return codes, quals


def batches(codes, quals, size):
    """(JAX PackedReads, port PackedReads, port wire) per `size` reads."""
    out = []
    for s in range(0, codes.shape[0], size):
        c, q = codes[s:s + size], quals[s:s + size]
        lengths = np.full(c.shape[0], READ_LEN, np.int32)
        tpk = tpacking.pack_reads(c, q, lengths, thresholds=(QT,))
        out.append((jpacking.pack_reads(c, q, lengths, thresholds=(QT,)),
                    tpk, torch.from_numpy(tpk.to_wire())))
    return out


def halves(keys: np.ndarray):
    """int64 mers -> the JAX package's (hi, lo) uint32 words."""
    return (jnp.asarray((keys >> 32).astype(np.uint32)),
            jnp.asarray((keys & M32).astype(np.uint32)))


def port_payload_of_jax(sj, meta):
    """The JAX sealed table's v4 payload, exported by the port."""
    state, tm = tdb.tile_state_from_numpy(np.asarray(sj.rows), meta.k,
                                          meta.bits, meta.rb_log2, "cpu")
    return tct.tile_export_v4(state, tm)


@pytest.mark.parametrize("low_q", [False, True])
def test_batch_aggregate_matches_jax(low_q):
    """HK9's lanes equal _aggregate_obs_impl's at cap = n as (key, hq,
    lq) sets, and they count every valid observation once."""
    codes, quals = memfrugal_reads(low_q)
    jpk, tpk, wire = batches(codes, quals, BATCH)[0]
    n = BATCH * READ_LEN
    chi, clo, qual, valid = jsk._extract_wire(
        K, jnp.asarray(jpk.to_wire()), QT, BATCH, READ_LEN, jpk.thresholds)
    hq_add, lq_add, _inv = jct._prep_obs(qual, valid)
    u_chi, u_clo, u_hq, u_lq, u_valid, _seg_of = (
        np.asarray(x) for x in jct._aggregate_obs_impl(
            chi, clo, hq_add, lq_add, valid, n))
    keys, hq, lq = (x.numpy() for x in kernels.batch_aggregate(
        wire, BATCH, READ_LEN, tpk.thresholds, QT, K))

    def lane_set(k, h, l):
        m = k >= 0
        o = np.argsort(k[m])
        return np.stack([k[m][o], h[m][o].astype(np.int64),
                         l[m][o].astype(np.int64)])

    uv = u_valid.astype(bool)
    jkeys = (u_chi.astype(np.int64) << 32) | u_clo.astype(np.int64)
    assert np.array_equal(lane_set(keys, hq, lq),
                          lane_set(np.where(uv, jkeys, -1), u_hq, u_lq))
    assert (hq + lq).max() > 1 and bool(lq.sum()) == low_q
    assert int((hq + lq).sum()) == int(np.asarray(valid).sum())


@pytest.mark.parametrize("cells_log2", [10, 12])
def test_sketch_update_matches_jax_with_colliding_cells(cells_log2):
    """HK10's update and query equal sketch_update_packed and sketch_min
    byte for byte after every batch, on a sketch small enough that
    lanes share cells within a hash and across the two hashes."""
    codes, quals = memfrugal_reads(True)
    smeta = jsk.SketchMeta(cells_log2)
    js = jsk.make_sketch(smeta)
    ts = tsk.make_sketch(tsk.SketchMeta(cells_log2), "cpu")
    shared = cross = 0
    for jpk, tpk, wire in batches(codes[:64], quals[:64], 8):
        keys, hq, lq = kernels.batch_aggregate(
            wire, 8, READ_LEN, tpk.thresholds, QT, K)
        live = keys[keys >= 0]
        assert np.array_equal(
            kernels.sketch_min(ts.cells, cells_log2, live).numpy(),
            np.asarray(jsk.sketch_min(js, smeta, *halves(live.numpy()))))
        a1, a2 = ref.sketch_addrs(live, cells_log2)
        shared += live.numel() - torch.unique(a1).numel()
        cross += np.intersect1d(a1.numpy(), a2.numpy()).size
        js, _n = jsk.sketch_update_packed(js, smeta, K, jpk, QT)
        kernels.sketch_update(ts.cells, cells_log2, keys, hq, lq)
        assert np.array_equal(ts.cells.numpy(), np.asarray(js.cells))
    assert shared > 0 and cross > 0
    assert set(np.unique(ts.cells.numpy())) == {0, 1, 2}


def test_two_singletons_in_one_cell_give_one():
    """Two distinct mers seen once each, sharing their hash-1 cell: the
    cell becomes 1 (a per-observation saturating sum would give 2), as
    in the JAX update."""
    cells_log2 = 10
    cand = torch.from_numpy(np.random.default_rng(5).integers(
        0, 1 << 30, size=4096))
    a1, _a2 = ref.sketch_addrs(cand, cells_log2)
    seen: dict = {}
    for i, a in enumerate(a1.tolist()):
        if a in seen:
            pair = [seen[a], i]
            break
        seen[a] = i
    keys = cand[pair]
    assert int(keys[0]) != int(keys[1])
    cells = torch.zeros(1 << cells_log2, dtype=torch.uint8)
    kernels.sketch_update(cells, cells_log2, keys,
                          torch.ones(2, dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32))
    assert int(cells[a1[pair[0]]]) == 1
    smeta = jsk.SketchMeta(cells_log2)
    js = jsk._sketch_update_lanes(jsk.make_sketch(smeta), smeta,
                                  *halves(keys.numpy()),
                                  jnp.ones(2, jnp.uint32),
                                  jnp.ones(2, bool))
    assert np.array_equal(cells.numpy(), np.asarray(js.cells))


def _finished_sketches(bs, cells_log2):
    smeta = jsk.SketchMeta(cells_log2)
    js = jsk.make_sketch(smeta)
    ts = tsk.make_sketch(tsk.SketchMeta(cells_log2), "cpu")
    for jpk, tpk, wire in bs:
        js, _n = jsk.sketch_update_packed(js, smeta, K, jpk, QT)
        tsk.sketch_update_packed(ts, tsk.SketchMeta(cells_log2), K, tpk,
                                 wire, QT)
    assert np.array_equal(ts.cells.numpy(), np.asarray(js.cells))
    return smeta, js, ts


def _tables(rb):
    jm = jct.TileMeta(k=K, bits=7, rb_log2=rb)
    tm = tct.TileMeta(K, 7, rb)
    return jm, jct.make_tile_build(jm), tm, tct.make_tile_build(tm, "cpu")


@pytest.mark.parametrize("low_q", [False, True])
def test_two_pass_gated_insert_matches_jax(low_q):
    """HK11's two-pass entry behind a finished 2^12-cell sketch (many
    false passes): the same table content, dropped counts and false
    passes (HK2's singleton statistic vs singleton_entries) as
    tile_insert_reads_packed_gated(..., "two-pass")."""
    codes, quals = memfrugal_reads(low_q)
    bs = batches(codes, quals, BATCH)
    smeta, js, ts = _finished_sketches(bs, 12)
    jm, jb, tm, tb = _tables(jct.tile_rb_for(8192, K, 7))
    dropped = 0
    for jpk, tpk, wire in bs:
        jb, js, full, _o, d_hq, d_lq = jsk.tile_insert_reads_packed_gated(
            jb, jm, js, smeta, jpk, QT, "two-pass")
        tfull, _left, tdrop = kernels.gated_insert_reads(
            tb, tm, ts.cells, 12, wire, BATCH, READ_LEN, tpk.thresholds, QT)
        assert not full and not tfull
        assert tdrop.tolist() == [d_hq, d_lq]
        dropped += d_hq + d_lq
    sj, _dup, occ, _dh, _th = jct.tile_seal(jb, jm)
    st, dup, tocc, _td, _tt, singles = tct.tile_seal(tb, tm)
    assert not dup and tocc == int(occ)
    assert np.array_equal(tct.tile_export_v4(st, tm),
                          port_payload_of_jax(sj, jm))
    assert singles == int(jsk.singleton_entries(jb)) > 0 and dropped > 0


@pytest.mark.parametrize("low_q", [False, True])
def test_inline_gated_insert_matches_jax(low_q):
    """HK9 + HK10's query + HK11's inline entry + HK10's update per
    batch: the table content, dropped counts and sketch bytes of JAX's
    inline mode. JAX drains compaction-cap overflow per observation,
    without the retro credit (sketch.py:316-322); the port gives every
    gated lane its credit. So the two are compared only where JAX
    drained nothing: at 8 reads a batch its cap covers every lane (a new
    key waits one round for its verify, so at 256 reads the lanes past
    the cap drain), and its inline program reports no failed and no
    unfit observation for any batch."""
    codes, quals = memfrugal_reads(low_q)
    bs = batches(codes, quals, 8)
    smeta = jsk.SketchMeta(12)
    js = jsk.make_sketch(smeta)
    tsmeta = tsk.SketchMeta(12)
    ts = tsk.make_sketch(tsmeta, "cpu")
    jm, jb, tm, tb = _tables(jct.tile_rb_for(8192, K, 7))
    n = 8 * READ_LEN
    for jpk, tpk, wire in bs:
        jb, js, _obs, _done, n_failed, n_unfit, d_hq, d_lq = \
            jsk._gated_insert_wire(
                jb, js, jm, smeta, jnp.asarray(jpk.to_wire()), QT, 23,
                min(n, max(1024, n // 8)), 8, READ_LEN, jpk.thresholds,
                "inline", (None, 1), jct.agg_cap_for(n))
        assert int(n_failed) == 0 and int(n_unfit) == 0
        full, _left, t_hq, t_lq = tsk.tile_insert_reads_packed_gated(
            tb, tm, ts, tsmeta, tpk, wire, QT, "inline")
        assert not full and (t_hq, t_lq) == (int(d_hq), int(d_lq))
        assert np.array_equal(ts.cells.numpy(), np.asarray(js.cells))
    sj, _dup, occ, _dh, _th = jct.tile_seal(jb, jm)
    st, _tdup, tocc, _td, _tt, _ts = tct.tile_seal(tb, tm)
    assert tocc == int(occ)
    assert np.array_equal(tct.tile_export_v4(st, tm),
                          port_payload_of_jax(sj, jm))


def true_counts(codes, quals):
    """Every canonical mer of the reads with its (hq, lq) observations."""
    lengths = np.full(codes.shape[0], READ_LEN, np.int32)
    pk = tpacking.pack_reads(codes, quals, lengths, thresholds=(QT,))
    cw, hqb = ref.widen_wire(torch.from_numpy(pk.to_wire()),
                             codes.shape[0], READ_LEN, pk.thresholds, QT)
    keys, qual, valid = ref.extract_observations(cw, hqb, K)
    uk, inv = torch.unique(keys[valid], return_inverse=True)
    q = qual[valid].to(torch.int64)
    hq = torch.zeros(uk.numel(), dtype=torch.int64).index_add_(0, inv, q)
    lq = torch.zeros_like(hq).index_add_(0, inv, 1 - q)
    return uk, hq, lq


@pytest.mark.parametrize("sketch_bits,initial_size",
                         [("12", 8192), ("20", 8192), ("12", 100),
                          ("20", 100)],
                         ids=["12", "20", "12-grows", "20-grows"])
def test_inline_build_holds_its_guarantees(monkeypatch, sketch_bits,
                                           initial_size):
    """The port's inline build (tests/test_memfrugal.py:511, with mixed
    qualities): every mer seen >= 2 times is present; every entry is a
    real mer; every absent mer is a true singleton; the stored count is
    within one of the truth in its quality class (a collision or a
    class change between a mer's first and later observations moves
    one count). From a 16-row table (`-grows`) lanes that find a full
    row hand their observations to the grow loop one count each (HK8,
    then HK1's keys entry), without the retro credit."""
    monkeypatch.setenv("QUORUM_SKETCH_BITS", sketch_bits)
    codes, quals = memfrugal_reads(True)
    cfg = tcdb.BuildConfig(k=K, bits=7, qual_thresh=QT,
                           initial_size=initial_size, batch_size=BATCH,
                           device="cpu", prefilter="inline")
    items = [(tfastq.ReadBatch(None, None, tpk.lengths, [], BATCH), tpk)
             for _j, tpk, _w in batches(codes, quals, BATCH)]
    state, meta, stats = tcdb.build_database([], cfg, torch.device("cpu"),
                                             batches_factory=lambda: items)
    assert stats.sketch_cells_log2 == int(sketch_bits)
    assert (stats.grows >= 2) == (initial_size == 100)
    uk, hq, lq = true_counts(codes, quals)
    val = ref.tile_lookup(state.rows, meta, uk)
    present, q, cnt = val != 0, (val & 1) == 1, val >> 1
    assert int(present.sum()) == stats.distinct  # every entry a real mer
    assert bool(present[hq + lq >= 2].all())
    assert bool((hq + lq)[~present].eq(1).all())
    p = present & (hq < meta.max_val - 1) & (lq < meta.max_val - 1)
    assert bool(((cnt - hq).abs() <= 1)[p & q].all())
    assert bool(((hq <= 1) & ((cnt - lq).abs() <= 1))[p & ~q].all())
    # the dropped observations: every absent mer's one, plus the first
    # observations deferred until their mer's gate opened
    assert stats.prefilter_dropped >= int((~present).sum()) > 0


@pytest.mark.parametrize("low_q", [False, True])
def test_singleton_statistic_matches_jax(low_q):
    """HK2's fifth statistic equals singleton_entries on an unfiltered
    build of the same reads."""
    codes, quals = memfrugal_reads(low_q)
    jm, jb, tm, tb = _tables(8)
    for jpk, tpk, wire in batches(codes, quals, BATCH):
        jb, full, _obs = jct.tile_insert_reads_packed(jb, jm, jpk, QT)
        tfull, _left = kernels.tile_insert_reads(
            tb, tm, wire, BATCH, READ_LEN, tpk.thresholds, QT)
        assert not full and not tfull
    _rows, stats = kernels.tile_seal(tb, tm)
    assert int(stats[4]) == int(jsk.singleton_entries(jb)) > 0


@pytest.mark.parametrize("floor", [2, 3])
def test_tile_floor_matches_jax(floor):
    """HK12 in place on the sealed rows equals ctable.tile_floor; a
    floor of 1 changes nothing."""
    codes, quals = memfrugal_reads(True)
    jm, jb, _tm, _tb = _tables(8)
    for jpk, _tpk, _wire in batches(codes, quals, BATCH):
        jb, full, _obs = jct.tile_insert_reads_packed(jb, jm, jpk, QT)
    sj, _dup, _occ, _dh, _th = jct.tile_seal(jb, jm)
    want = np.asarray(jct.tile_floor(sj, jm, floor).rows)
    state, tm = tdb.tile_state_from_numpy(np.asarray(sj.rows), K, 7, 8, "cpu")
    before = state.rows.clone()
    assert tct.tile_floor(state, tm, 1) is state
    assert torch.equal(state.rows, before)
    tct.tile_floor(state, tm, floor)
    assert np.array_equal(state.rows.numpy().view(np.uint32), want)
    assert not np.array_equal(want, np.asarray(sj.rows))
