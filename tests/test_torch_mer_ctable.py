"""The port's k-mer extraction, key hash, table build (with grows),
seal, export and lookup against the JAX package on the same seeded
inputs (quorum_tpu_torch/kernels/reference.py: the plain versions of
HK1-HK3, which the port runs on the CPU). Integer work throughout:
every comparison is exact."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quorum_tpu.io import db_format as jdb
from quorum_tpu.io import fastq as jfastq
from quorum_tpu.io import packing as jpacking
from quorum_tpu.models import create_database as jcdb
from quorum_tpu.ops import ctable as jct
from quorum_tpu.ops import mer as jmer
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch import kernels
from quorum_tpu_torch.io import packing as tpacking
from quorum_tpu_torch.kernels import reference as ref
from quorum_tpu_torch.models import create_database as tcdb
from quorum_tpu_torch.ops import ctable as tct

QT = 38


def seeded_reads(seed, b, l, n_rate=0.02):
    """codes int8 [b, l] (ragged lengths, -1 Ns, -2 padding) and quals
    uint8 [b, l] from a numpy seed."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, l)).astype(np.int8)
    codes[rng.random((b, l)) < n_rate] = -1
    lengths = rng.integers(l // 2, l + 1, size=b).astype(np.int32)
    lengths[:3] = [0, 5, l]
    codes[np.arange(l)[None, :] >= lengths[:, None]] = -2
    quals = rng.integers(33, 75, size=(b, l)).astype(np.uint8)
    quals[codes == -2] = 0
    return codes, quals, lengths


@pytest.mark.parametrize("k", [13, 24])
def test_observations_and_key_parts_match_jax(k):
    codes, quals, lengths = seeded_reads(k, 24, 96)
    chi, clo, qbit, valid = (np.asarray(x) for x in
                             jct.extract_observations_impl(
                                 jnp.asarray(codes), jnp.asarray(quals), k, QT))
    # the port reads the packed wire, as both stages do
    pk = tpacking.pack_reads(codes, quals, lengths, thresholds=(QT,))
    jpk = jpacking.pack_reads(codes, quals, lengths, thresholds=(QT,))
    assert np.array_equal(pk.to_wire(), jpk.to_wire())
    tcodes, hqb = ref.widen_wire(torch.from_numpy(pk.to_wire()), 24, 96,
                                 pk.thresholds, QT)
    assert np.array_equal(tcodes.numpy(), codes)
    keys, tq, tvalid = ref.extract_observations(tcodes, hqb, k)
    hi, lo = keys >> 32, keys & 0xFFFFFFFF
    assert np.array_equal(tvalid.numpy(), valid)
    assert np.array_equal(tq.numpy(), qbit.astype(bool))
    assert np.array_equal(hi.numpy(), chi.astype(np.int64))
    assert np.array_equal(lo.numpy(), clo.astype(np.int64))
    for rb in (4, 13, 22):
        meta = jct.TileMeta(k=k, bits=7, rb_log2=rb)
        addr, rlo, rhi = (np.asarray(x) for x in
                          jct.tile_key_parts(jnp.asarray(chi),
                                             jnp.asarray(clo), meta))
        ta, trl, trh = ref.tile_key_parts(keys, tct.TileMeta(k, 7, rb))
        assert np.array_equal(ta.numpy(), addr.astype(np.int64))
        assert np.array_equal(trl.numpy(), rlo.astype(np.int64))
        assert np.array_equal(trh.numpy(), rhi.astype(np.int64))
        p0 = np.asarray(jct._preferred_slot(jnp.asarray(rlo),
                                            jnp.asarray(rhi)))
        assert np.array_equal(ref.preferred_slot(trl, trh).numpy(), p0)


def _batches(seed, n_batches, b, l, jax_side):
    out = []
    for i in range(n_batches):
        codes, quals, lengths = seeded_reads(seed + i, b, l)
        headers = [f"r{i}_{j}" for j in range(b)]
        if jax_side:
            rb = jfastq.ReadBatch(codes, quals, lengths, headers, b)
            out.append((rb, jpacking.pack_reads(codes, quals, lengths,
                                                thresholds=(QT,))))
        else:
            from quorum_tpu_torch.io import fastq as tfastq
            rb = tfastq.ReadBatch(codes, quals, lengths, headers, b)
            out.append((rb, tpacking.pack_reads(codes, quals, lengths,
                                                thresholds=(QT,))))
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The same seeded batches through both stage-1 builds, started at
    16 rows so the build grows several times."""
    d = tmp_path_factory.mktemp("build")
    jcfg = jcdb.BuildConfig(k=13, bits=7, qual_thresh=QT, initial_size=100,
                            batch_size=48)
    jstate, jmeta, jstats = jcdb.build_database(
        [], jcfg, batches=_batches(7, 3, 48, 80, jax_side=True))
    jdb.write_db(str(d / "jax.qdb"), jstate, jmeta, n_entries=jstats.distinct)
    tcfg = tcdb.BuildConfig(k=13, bits=7, qual_thresh=QT, initial_size=100,
                            batch_size=48, device="cpu")
    tstate, tmeta, tstats = tcdb.build_database(
        [], tcfg, torch.device("cpu"),
        batches_factory=lambda: _batches(7, 3, 48, 80, jax_side=False))
    tdb.write_db(str(d / "port.qdb"), tstate, tmeta,
                 n_entries=tstats.distinct)
    return dict(dir=d, jstate=jstate, jmeta=jmeta, jstats=jstats,
                tstate=tstate, tmeta=tmeta, tstats=tstats)


def test_build_with_grows_writes_identical_payload(built):
    assert built["tstats"].grows >= 2
    assert built["tstats"].grows == built["jstats"].grows
    assert built["tmeta"].rb_log2 == built["jmeta"].rb_log2
    assert (tdb.db_payload_bytes(str(built["dir"] / "port.qdb"))
            == jdb.db_payload_bytes(str(built["dir"] / "jax.qdb")))


def test_seal_stats_match_jax():
    codes, quals, lengths = seeded_reads(3, 64, 80)
    meta_j = jct.TileMeta(k=13, bits=7, rb_log2=6)
    bj = jct.make_tile_build(meta_j)
    bj, full, _obs = jct.tile_insert_reads_packed(
        bj, meta_j, jpacking.pack_reads(codes, quals, lengths,
                                        thresholds=(QT,)), QT)
    assert not full
    sj, dup, occ, dist, total = jct.tile_seal(bj, meta_j)
    meta_t = tct.TileMeta(13, 7, 6)
    bt = tct.make_tile_build(meta_t, "cpu")
    pk = tpacking.pack_reads(codes, quals, lengths, thresholds=(QT,))
    tfull, _pend = kernels.tile_insert_reads(
        bt, meta_t, torch.from_numpy(pk.to_wire()), 64, 80, pk.thresholds, QT)
    assert not tfull
    st, tdup, tocc, tdist, ttotal, _singles = tct.tile_seal(bt, meta_t)
    assert (tdup, tocc, tdist, ttotal) == (bool(dup), int(occ), int(dist),
                                           int(total))
    # same content: the canonical exports agree byte for byte
    assert np.array_equal(
        tct.tile_export_v4(st, meta_t),
        np.asarray(tct.tile_export_v4(
            tdb.tile_state_from_numpy(np.asarray(sj.rows), 13, 7, 6,
                                      "cpu")[0], meta_t)))


def test_lookup_matches_jax(built):
    jstate, jmeta = built["jstate"], built["jmeta"]
    khi, klo, _v = jct.tile_iterate(jstate, jmeta)
    rng = np.random.default_rng(11)
    absent = rng.integers(0, 1 << 26, size=500, dtype=np.int64)
    keys = np.concatenate([(khi.astype(np.int64) << 32)
                           | klo.astype(np.int64), absent])
    want = np.asarray(jct.tile_lookup(
        jstate, jmeta, jnp.asarray((keys >> 32).astype(np.uint32)),
        jnp.asarray((keys & 0xFFFFFFFF).astype(np.uint32))))
    state, meta = tdb.tile_state_from_numpy(
        np.asarray(jstate.rows), jmeta.k, jmeta.bits, jmeta.rb_log2, "cpu")
    got = kernels.tile_lookup(state.rows, meta, torch.from_numpy(keys))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert (got[:len(khi)] != 0).all() and int(got.sum()) > 0
