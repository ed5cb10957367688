"""The row layouts and read shapes that the port's hand kernels for HK16
(event_planes) and HK1 (tile_insert) must handle, pinned on the CPU,
where the wrappers run their plain versions, against the JAX package.

HK16's probes must not assume where in its row a key sits: a build
table keeps a key at or after its preferred slot, and one that HK7
loaded packs each row from slot 0. So the port's event planes
(kernels.event_planes + event_scan) equal JAX's _event_planes (the full
sibling sweep) on one crowded table (rows of 40 and more keys, keys far
from their preferred slots) in both layouts: JAX's rows as its stage 1
built them, and the same table written to a v5 file by the JAX package
and loaded by the port. HK1 builds each window from words of the packed
wire: the port's stage-1 payload equals JAX's at k = 13, 24 and 31
(62-bit windows) on reads of mixed lengths, some shorter than k, in rows
77 bases wide (no multiple of 4 or 8). Integer work: every comparison
is exact."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quorum_tpu.io import db_format as jdb
from quorum_tpu.io import packing as jpacking
from quorum_tpu.models import corrector as jcorr
from quorum_tpu.models.create_database import extract_observations
from quorum_tpu.models.ec_config import ECConfig as JECConfig
from quorum_tpu.ops import ctable as jct
from quorum_tpu_torch import kernels
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.io import packing as tpacking
from quorum_tpu_torch.kernels import reference as ref
from quorum_tpu_torch.models import corrector as tcorr
from quorum_tpu_torch.models.ec_config import ECConfig as TECConfig
from quorum_tpu_torch.ops import ctable as tct

K, RLEN, B, CUTOFF, QT = 9, 50, 256, 4, 38
CROWDED_RB = 6  # 64 rows for ~2,900 keys


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops: one thread, so the
    suite's parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.partial(jax.jit, static_argnums=(1, 6, 7))
def _jax_planes(state, meta, codes32, quals32, lengths, start_off, cfg,
                cap):
    sweep = jcorr._position_sweep(state, meta, codes32, cfg,
                                  *jcorr._dummy_contam(K), False)
    return jcorr._event_planes(state, meta, sweep, codes32, quals32,
                               lengths, start_off, cfg, None, cap, False)


@pytest.fixture(scope="module")
def crowded(tmp_path_factory):
    """256 reads of 50 bp from a 500 bp genome with 3% substitutions and
    Ns, built by the JAX package's stage 1 into 64 rows (rows of 40 and
    more keys), written by it to a v5 file; JAX's planes on its table,
    and the batch's port inputs."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, size=500, dtype=np.int8)
    starts = rng.integers(0, len(genome) - RLEN, size=B)
    codes = genome[starts[:, None] + np.arange(RLEN)[None, :]].astype(np.int8)
    errs = rng.random(codes.shape) < 0.03
    codes = np.where(errs, (codes + rng.integers(1, 4, size=codes.shape)) % 4,
                     codes).astype(np.int8)
    codes[rng.random(codes.shape) < 0.005] = -1
    quals = np.full(codes.shape, 70, np.uint8)
    quals[errs] = 68
    meta = jct.TileMeta(k=K, bits=7, rb_log2=CROWDED_RB)
    chi, clo, q, valid = extract_observations(
        jnp.asarray(codes), jnp.asarray(quals), K, QT)
    bstate, full, _ = jct.tile_insert_observations(
        jct.make_tile_build(meta), meta, chi, clo, q, valid)
    assert not full
    jstate, _dup, occ, _dist, _total = jct.tile_seal(bstate, meta)
    path = str(tmp_path_factory.mktemp("crowded") / "crowded.qdb")
    jdb.write_db(path, jstate, meta, n_entries=int(occ))
    jcfg = JECConfig(k=K, cutoff=CUTOFF, qual_cutoff=69)
    tcfg = TECConfig(k=K, cutoff=CUTOFF, qual_cutoff=69)
    lengths = np.full(B, RLEN, np.int32)
    pk = tpacking.pack_reads(codes, quals, lengths,
                             thresholds=(tcfg.qual_cutoff,))
    build, tmeta = tdb.tile_state_from_numpy(np.asarray(jstate.rows), K, 7,
                                             CROWDED_RB, "cpu")
    head = kernels.stage2_head(
        build.rows, tmeta, torch.from_numpy(pk.to_wire()), B, RLEN,
        pk.thresholds, tcfg.qual_cutoff, skip=1, good=2, anchor_count=3)
    so = head[3][1].numpy()
    planes = _jax_planes(jstate, meta, jnp.asarray(codes, jnp.int32),
                         jnp.asarray(quals, jnp.int32), jnp.asarray(lengths),
                         jnp.asarray(so), jcfg, B * RLEN)
    return dict(build=build, meta=tmeta, path=path, pk=pk, so=so,
                keep=tcorr.make_keep_table(tmeta, tcfg, "cpu"),
                planes=planes, qual_cutoff=tcfg.qual_cutoff)


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def _layout(rows, meta):
    """(most keys in a row, mean slot distance of a key from its
    preferred slot, keys more than 4 slots from it) of a sealed table."""
    s = rows.view(meta.rows, ref.TSLOTS, 2).to(torch.int64) & 0xFFFFFFFF
    live = (s[..., 0] & meta.max_val) != 0
    pref = ref.preferred_slot(s[..., 0] >> (meta.bits + 1), s[..., 1])
    dist = ((torch.arange(ref.TSLOTS)[None, :] - pref) % ref.TSLOTS)[live]
    return (int(live.sum(1).max()), float(dist.float().mean()),
            int((dist > 4).sum()))


@pytest.mark.parametrize("layout", ["build", "v5"])
def test_event_planes_equal_jax_in_both_row_layouts(crowded, layout):
    """Every field of every frame position against JAX's full sweep; the
    build layout keeps keys off their preferred slots, the v5 load packs
    every row from slot 0."""
    meta = crowded["meta"]
    if layout == "build":
        state = crowded["build"]
    else:
        state, lmeta, _h, _stats = tdb.load_db(crowded["path"], "cpu")
        assert lmeta == meta
    most, mean, far = _layout(state.rows, meta)
    assert most >= 40
    assert far > 100 if layout == "build" else mean > 10.0
    pk = crowded["pk"]
    tc, hqb, tl, anc = kernels.stage2_head(
        state.rows, meta, torch.from_numpy(pk.to_wire()), B, RLEN,
        pk.thresholds, crowded["qual_cutoff"], skip=1, good=2,
        anchor_count=3)
    assert np.array_equal(anc[1].numpy(), crowded["so"])
    port = kernels.event_scan(*kernels.event_planes(
        state.rows, meta, tc, hqb, tl, anc[1], crowded["keep"], min_count=1,
        cutoff=CUTOFF), tl, K)
    clean, nd, cnt, aux, lastc1, prevval, mf, mr = (x.numpy() for x in port)
    full = crowded["planes"]
    assert np.array_equal(clean, np.asarray(full.clean))
    for name, got in (("nd", nd), ("lastc1", lastc1),
                      ("prevval", prevval)):
        assert np.array_equal(got, np.asarray(getattr(full, name))), name
    for name, got in (("cnt", cnt), ("aux", aux)):
        assert np.array_equal(_u32(got), _u32(getattr(full, name))), name
    assert np.array_equal(mf, (_u32(full.mfh) << 32) | _u32(full.mfl))
    assert np.array_equal(mr, (_u32(full.mrh) << 32) | _u32(full.mrl))
    assert ((aux >> ref.AX_PRE) & 1).sum() > 0
    assert (~clean[:B, K - 1:]).sum() > 0


def _mixed_reads(seed, k):
    """96 reads in rows 77 wide: lengths 0..77 with some below k, 1%
    Ns, random quals; codes -2 and quals 0 past each read."""
    rng = np.random.default_rng(seed)
    b, w = 96, 77
    codes = rng.integers(0, 4, size=(b, w)).astype(np.int8)
    codes[rng.random((b, w)) < 0.01] = -1
    lengths = rng.integers(0, w + 1, size=b).astype(np.int32)
    lengths[:4] = [0, k - 1, k, w]
    codes[np.arange(w)[None, :] >= lengths[:, None]] = -2
    quals = rng.integers(33, 75, size=(b, w)).astype(np.uint8)
    quals[codes == -2] = 0
    return codes, quals, lengths


@pytest.mark.parametrize("k", [13, 24, 31])
def test_stage1_payload_equals_jax_at_mixed_lengths(k, tmp_path):
    codes, quals, lengths = _mixed_reads(k, k)
    b, w = codes.shape
    jmeta = jct.TileMeta(k=k, bits=7, rb_log2=8)
    bj, full, _obs = jct.tile_insert_reads_packed(
        jct.make_tile_build(jmeta), jmeta,
        jpacking.pack_reads(codes, quals, lengths, thresholds=(QT,)), QT)
    assert not full
    sj, _dup, occ, dist, total = jct.tile_seal(bj, jmeta)
    jdb.write_db(str(tmp_path / "jax.qdb"), sj, jmeta, n_entries=int(occ))
    meta = tct.TileMeta(k, 7, 8)
    bt = tct.make_tile_build(meta, "cpu")
    pk = tpacking.pack_reads(codes, quals, lengths, thresholds=(QT,))
    tfull, _left = kernels.tile_insert_reads(
        bt, meta, torch.from_numpy(pk.to_wire()), b, w, pk.thresholds, QT)
    assert not tfull
    st, _tdup, tocc, tdist, ttotal, _singles = tct.tile_seal(bt, meta)
    assert (tocc, tdist, ttotal) == (int(occ), int(dist), int(total))
    assert tocc > 1000
    tdb.write_db(str(tmp_path / "port.qdb"), st, meta, n_entries=tocc)
    assert (tdb.db_payload_bytes(str(tmp_path / "port.qdb"))
            == jdb.db_payload_bytes(str(tmp_path / "jax.qdb")))
