"""The plain versions of HK6 (tile_export), HK7 (tile_load) and HK8
(tile_grow), and HK1's keys entry for the observations a grow leaves
over, against the JAX package on the same seeded tables
(quorum_tpu_torch/kernels/reference.py; the port runs them on the CPU).
Integer work throughout: every comparison is exact."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quorum_tpu.io import fastq as jfastq
from quorum_tpu.io import packing as jpacking
from quorum_tpu.models import create_database as jcdb
from quorum_tpu.ops import ctable as jct
from quorum_tpu_torch import kernels
from quorum_tpu_torch.io import fastq as tfastq
from quorum_tpu_torch.io import packing as tpacking
from quorum_tpu_torch.kernels import reference as ref
from quorum_tpu_torch.models import create_database as tcdb
from quorum_tpu_torch.ops import ctable as tct

QT = 38


def _reads(seed, b=48, l=80):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, l)).astype(np.int8)
    codes[rng.random((b, l)) < 0.02] = -1
    lengths = rng.integers(l // 2, l + 1, size=b).astype(np.int32)
    codes[np.arange(l)[None, :] >= lengths[:, None]] = -2
    quals = rng.integers(33, 75, size=(b, l)).astype(np.uint8)
    quals[codes == -2] = 0
    return codes, quals, lengths


def _batches(seed, n, jax_side):
    out = []
    for i in range(n):
        codes, quals, lengths = _reads(seed + i)
        hdr = [f"r{i}_{j}" for j in range(len(lengths))]
        mod_f, mod_p = (jfastq, jpacking) if jax_side else (tfastq, tpacking)
        out.append((mod_f.ReadBatch(codes, quals, lengths, hdr, len(hdr)),
                    mod_p.pack_reads(codes, quals, lengths,
                                     thresholds=(QT,))))
    return out


@pytest.fixture(scope="module", params=[13, 24])
def grown(request):
    """Both packages' stage-1 builds of the same seeded batches, from
    16 rows, so each grows several times."""
    k = request.param
    jcfg = jcdb.BuildConfig(k=k, bits=7, qual_thresh=QT, initial_size=100,
                            batch_size=48)
    js, jm, jst = jcdb.build_database([], jcfg,
                                      batches=_batches(k, 3, jax_side=True))
    tcfg = tcdb.BuildConfig(k=k, bits=7, qual_thresh=QT, initial_size=100,
                            batch_size=48, device="cpu")
    ts, tm, tst = tcdb.build_database(
        [], tcfg, torch.device("cpu"),
        batches_factory=lambda: _batches(k, 3, jax_side=False))
    assert tst.grows >= 2 and (tm.k, tm.rb_log2) == (jm.k, jm.rb_log2)
    return js, jm, jst, ts, tm, tst


def _jax_payload(state, meta, n):
    counts, lo_b, hi_pl, jn = jct.tile_export_v4(
        state, meta, 1 << max(10, (n - 1).bit_length()))
    assert int(jn) == n
    parts = [np.asarray(counts), np.asarray(lo_b)[:4 * n]]
    parts += [np.asarray(hi_pl)[j, :n] for j in range(hi_pl.shape[0])]
    return np.concatenate(parts)


def test_export_matches_jax_on_a_grown_table(grown):
    js, jm, jst, ts, tm, tst = grown
    got = kernels.tile_export(ts.rows, tm).numpy()
    assert np.array_equal(got, ref.tile_export(ts.rows, tm).numpy())
    assert np.array_equal(got, _jax_payload(js, jm, int(jst.distinct)))
    assert got.shape[0] == tm.rows + (4 + tm.hi_bytes) * tst.distinct


def test_load_matches_jax_rows_and_stats(grown):
    js, jm, jst, _ts, tm, tst = grown
    n = int(jst.distinct)
    payload = _jax_payload(js, jm, n)
    rows, stats = kernels.tile_load(torch.from_numpy(payload), tm, n)
    # the JAX load: host placement (rank within row), device scatter
    counts = payload[:jm.rows].astype(np.int64)
    lo = payload[jm.rows:jm.rows + 4 * n].copy().view(np.uint32)
    hi = np.zeros(n, np.uint32)
    for j in range(tm.hi_bytes):
        at = jm.rows + 4 * n + j * n
        hi |= payload[at:at + n].astype(np.uint32) << np.uint32(8 * j)
    addr = np.repeat(np.arange(jm.rows), counts)
    row, col = jct.tile_compact_placement(addr)
    want = jct.tile_rows_device_from_compact(
        jnp.asarray(row), jnp.asarray(col), jnp.asarray(lo), jnp.asarray(hi),
        jm)
    assert np.array_equal(rows.numpy().view(np.uint32),
                          np.asarray(want.rows))
    occ, distinct, total = (int(x) for x in jct.tile_stats(want, jm))
    assert stats.tolist() == [occ, distinct, total]
    assert stats.tolist() == [tst.distinct, tst.distinct_hq, tst.total_hq]
    with pytest.raises(ValueError):
        kernels.tile_load(torch.from_numpy(payload[:-1]), tm, n)


@pytest.mark.parametrize("k,rb", [(13, 8), (24, 7)])
def test_grow_matches_jax_by_export_payload(k, rb):
    """One doubling of the same build table (slot positions may differ
    between the packages; the sealed export may not)."""
    jm = jct.TileMeta(k=k, bits=7, rb_log2=rb)
    bj = jct.make_tile_build(jm)
    for b, pk in _batches(100 + k, 2, jax_side=True):
        bj, full, _obs = jct.tile_insert_reads_packed(bj, jm, pk, QT)
        assert not full
    bt = tct.TBuildState(*(torch.from_numpy(np.asarray(x).view(np.int32)
                                            .copy()) for x in bj))
    tm = tct.TileMeta(k, 7, rb)
    gj, gjm = jct.tile_grow_build(bj, jm)
    gt, gtm = tct.tile_grow_build(bt, tm)
    assert gtm.rb_log2 == gjm.rb_log2 == rb + 1
    sj, _dup, occ, _d, _t = jct.tile_seal(gj, gjm)
    st, dup, tocc, _td, _tt, _singles = tct.tile_seal(gt, gtm)
    assert not dup and tocc == int(occ) > 0
    assert np.array_equal(tct.tile_export_v4(st, gtm),
                          _jax_payload(sj, gjm, int(occ)))


def test_pending_duplicates_reinsert_to_the_same_payload():
    """Observations with repeated keys, re-inserted one count each (the
    keys entry a grow's leftovers take), give the table the JAX
    package's observation insert gives."""
    codes, quals, lengths = _reads(3, b=64)
    pk = tpacking.pack_reads(codes, quals, lengths, thresholds=(QT,))
    cw, hqb = ref.widen_wire(torch.from_numpy(pk.to_wire()), 64, 80,
                             pk.thresholds, QT)
    keys, qual, valid = ref.extract_observations(cw, hqb, 13)
    keys, qual = keys[valid], qual[valid]
    # every key twice, the copies' quals flipped (hq and lq counts)
    keys = torch.cat([keys, keys.flip(0)])
    qual = torch.cat([qual, ~qual.flip(0)])
    assert torch.unique(keys).numel() < keys.numel()
    tm = tct.TileMeta(13, 7, 7)
    bt = tct.make_tile_build(tm, "cpu")
    left_k, left_q = tct.tile_insert_pending(bt, tm, keys, qual)
    assert left_k.numel() == 0 and left_q.numel() == 0
    st, dup, occ, dist, total, _singles = tct.tile_seal(bt, tm)
    jm = jct.TileMeta(k=13, bits=7, rb_log2=7)
    k64 = keys.numpy()
    bj, full, _placed = jct.tile_insert_observations(
        jct.make_tile_build(jm), jm,
        jnp.asarray((k64 >> 32).astype(np.uint32)),
        jnp.asarray((k64 & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray(qual.numpy()), jnp.ones(k64.shape[0], bool))
    assert not full
    sj, jdup, jocc, jdist, jtotal = jct.tile_seal(bj, jm)
    assert (dup, occ, dist, total) == (bool(jdup), int(jocc), int(jdist),
                                       int(jtotal))
    assert np.array_equal(tct.tile_export_v4(st, tm),
                          _jax_payload(sj, jm, int(jocc)))


def test_keys_entry_refuses_mixed_devices():
    """The keys entry holds keys, qual and the table to one device: a
    qual plane elsewhere raises before any launch."""
    tm = tct.TileMeta(13, 7, 4)
    bt = tct.make_tile_build(tm, "cpu")
    keys = torch.arange(8, dtype=torch.int64)
    qual = torch.ones(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="mixed devices"):
        kernels.tile_insert_keys(bt, tm, keys, qual)


@pytest.mark.parametrize("damage", ["over_64", "sum_mismatch"])
def test_load_refuses_a_bad_payload_structure_before_the_device(
        grown, tmp_path, damage):
    """HK7 trusts its indices: the host refuses a row holding more than
    64 entries, or counts that do not sum to n_entries, first."""
    from quorum_tpu_torch.io import db_format as tdb

    _js, _jm, _jst, ts, tm, tst = grown
    path = str(tmp_path / "v4.qdb")
    tdb.write_db(path, ts, tm, n_entries=tst.distinct, db_version=4)
    data = bytearray(open(path, "rb").read())
    at = data.index(b"\n") + 1  # the counts section
    if damage == "over_64":
        data[at], data[at + 1] = 65, max(0, data[at] + data[at + 1] - 65)
    else:
        data[at] += 1
    open(path, "wb").write(bytes(data))
    with pytest.raises(tdb.IntegrityError):
        tdb.load_db(path, device="cpu")
