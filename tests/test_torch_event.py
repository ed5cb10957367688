"""The port's event-mode stage 2 (HK16 event_planes, HK17 event_scan and
HK4's event entry, run here as their plain versions) against the JAX
package's default event mode on the same table and reads.

The planes equal JAX's _event_planes field for field against its full
sibling sweep (compact_sweep=False, with a pre-pass cap that covers
every ambiguous position, as the port's pre-pass has none), and on every
value the walk consumes against its compacted sweep. The BatchResults
equal JAX's correct_batch(event_driven=True) exactly (the live-log
comparison of tests/test_event_driven._assert_same) at JAX's CPU
defaults, with uniform and variable lengths, and at its accelerator
levers (compact_sweep=True, drain_levels=2) with an ambiguous-lane cap
of 1, whose stalls are only delays, and on an error-heavy batch whose
ambiguous positions overflow JAX's pre-pass cap (the overflow takes
JAX's in-loop probe; the port's pre-pass has no cap). Inputs: seeded
batches shaped like test_event_driven's (long clean runs, isolated and
clustered errors, N bases), built by the JAX package's stage 1 at
k = 9."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

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

K, RLEN, B, CUTOFF = 9, 50, 256, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops: one thread, so the
    suite's parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(codes, quals):
    """The JAX stage-1 table of `codes`/`quals` (the same geometry for
    every batch of this module, so JAX compiles each shape once) and the
    port's copy of it."""
    meta = jct.TileMeta(k=K, bits=7, rb_log2=jct.tile_rb_for(50_000, K, 7))
    chi, clo, q, valid = extract_observations(
        jnp.asarray(codes), jnp.asarray(quals), K, 38)
    bstate, full, _ = jct.tile_insert_observations(
        jct.make_tile_build(meta), meta, chi, clo, q, valid)
    assert not full
    jstate = jct.tile_finalize(bstate, meta)
    tstate, tmeta = tdb.tile_state_from_numpy(
        np.asarray(jstate.rows), K, 7, meta.rb_log2, "cpu")
    return jstate, meta, tstate, tmeta


@pytest.fixture(scope="module")
def batch():
    """256 reads of 50 bp from a 500 bp genome (25.6x), 2% substitutions,
    errors 4 apart on 32 reads, an N at position 30 of 16 reads, low
    quality on the erroneous bases; the JAX table of these reads and the
    port's copy of it."""
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=500, dtype=np.int8)
    starts = rng.integers(0, len(genome) - RLEN, size=B)
    codes = genome[starts[:, None] + np.arange(RLEN)[None, :]].astype(np.int8)
    errs = rng.random(codes.shape) < 0.02
    errs[:32, 20] = True
    errs[:32, 24] = True
    codes = np.where(errs, (codes + rng.integers(1, 4, size=codes.shape)) % 4,
                     codes).astype(np.int8)
    codes[32:48, 30] = -1
    quals = np.full(codes.shape, 70, np.uint8)
    quals[errs] = 68
    return (codes, quals) + _table(codes, quals)


def _cfgs(qual_cutoff=69):
    return (JECConfig(k=K, cutoff=CUTOFF, qual_cutoff=qual_cutoff),
            TECConfig(k=K, cutoff=CUTOFF, qual_cutoff=qual_cutoff))


@functools.partial(jax.jit, static_argnums=(1, 6, 7, 8))
def _jax_planes(state, meta, codes32, quals32, lengths, start_off, cfg,
                cap, compact):
    sweep = jcorr._position_sweep(state, meta, codes32, cfg,
                                  *jcorr._dummy_contam(K), False)
    return jcorr._event_planes(state, meta, sweep, codes32, quals32,
                               lengths, start_off, cfg, None, cap, compact)


def _planes(batch):
    """JAX's planes (full and compacted sweep) and the port's, on the
    batch's anchors."""
    codes, quals, jstate, jmeta, tstate, tmeta = batch
    jcfg, tcfg = _cfgs()
    lengths = np.full(B, RLEN, np.int32)
    pk = tpacking.pack_reads(codes, quals, lengths,
                             thresholds=(tcfg.qual_cutoff,))
    tc, hqb, tl, anc = kernels.stage2_head(
        tstate.rows, tmeta, torch.from_numpy(pk.to_wire()), B, RLEN,
        pk.thresholds, tcfg.qual_cutoff, skip=1, good=2, anchor_count=3)
    keep = tcorr.make_keep_table(tmeta, tcfg, "cpu")
    port = kernels.event_scan(*kernels.event_planes(
        tstate.rows, tmeta, tc, hqb, tl, anc[1], keep, min_count=1,
        cutoff=CUTOFF), tl, K)
    args = (jstate, jmeta, jnp.asarray(codes, jnp.int32),
            jnp.asarray(quals, jnp.int32), jnp.asarray(lengths),
            jnp.asarray(anc[1].numpy()), jcfg, B * RLEN)
    return (_jax_planes(*args, False), _jax_planes(*args, True), port,
            anc[1].numpy())


def _u32(*xs):
    return [np.asarray(x).astype(np.int64) & 0xFFFFFFFF for x in xs]


def _mers(p):
    """JAX's (hi, lo) u32 mer planes as the port's int64 mers."""
    return [(a << 32) | b for a, b in ((_u32(p.mfh)[0], _u32(p.mfl)[0]),
                                        (_u32(p.mrh)[0], _u32(p.mrl)[0]))]


@pytest.fixture(scope="module")
def planes(batch):
    return _planes(batch)


def test_planes_equal_the_full_sweep_field_for_field(planes):
    """Every field of every frame position, the reverse-complement rows'
    fills and the windows past the read included; the batch is one the
    walk teleports on (most positions clean) with a non-empty ambiguous
    pre-pass."""
    full, _comp, port, _so = planes
    clean, nd, cnt, aux, lastc1, prevval, mf, mr = (x.numpy() for x in port)
    assert np.array_equal(clean, np.asarray(full.clean))
    for name, got in (("nd", nd), ("lastc1", lastc1),
                      ("prevval", prevval)):
        assert np.array_equal(got, np.asarray(getattr(full, name))), name
    for name, got in (("cnt", cnt), ("aux", aux)):
        assert np.array_equal(_u32(got)[0], _u32(getattr(full, name))[0]), \
            name
    jf, jr = _mers(full)
    assert np.array_equal(mf, jf) and np.array_equal(mr, jr)
    assert clean[:B, K - 1:].mean() > 0.5
    assert ((aux >> ref.AX_PRE) & 1).sum() > 0


def test_planes_consumed_values_equal_the_compacted_sweep(planes):
    """Against JAX's compacted sweep (the accelerator default), on what
    the walk reads (tests/test_round7.py
    ::test_compact_sweep_planes_consumed_parity): clean and nd
    everywhere, cnt and aux but the C1K bit at every event, lastc1 and
    prevval at every consumption point whose chain can be read."""
    _full, comp, port, so = planes
    clean, nd, cnt, aux, lastc1, prevval, _mf, _mr = (x.numpy()
                                                      for x in port)
    assert np.array_equal(clean, np.asarray(comp.clean))
    assert np.array_equal(nd, np.asarray(comp.nd))
    ev = ~clean
    m = ~(1 << ref.AX_C1K) & 0xFFFFFFFF
    for got, want in ((cnt, comp.cnt), (aux, comp.aux)):
        assert np.array_equal(np.where(ev, _u32(got)[0] & m, 0),
                              np.where(ev, _u32(want)[0] & m, 0))
    l = clean.shape[1]
    p = np.arange(l)[None, :]
    ln = np.full(B, RLEN)
    lengths2 = np.concatenate([ln, ln])[:, None]
    min_pos = np.concatenate([so, ln - so + K])[:, None]
    nxt = np.concatenate([~clean[:, 1:], np.ones((2 * B, 1), bool)], axis=1)
    cp = clean & (p < lengths2) & (nxt | (p == lengths2 - 1))
    floor = np.maximum(np.maximum.accumulate(np.where(~clean, p, -1),
                                             axis=1) + 1, min_pos)
    lc_c = np.asarray(comp.lastc1)
    live = cp & (lastc1 >= floor)
    assert live.any()
    assert np.all(~cp | (lastc1 == lc_c) | ((lastc1 < floor)
                                             & (lc_c < floor)))
    assert np.array_equal(np.where(live, prevval, 0),
                          np.where(live, np.asarray(comp.prevval), 0))


def _assert_same(j, t):
    """tests/test_event_driven._assert_same across the packages: out,
    start, end, status, and each log's n and live entries."""
    for name in ("out", "start", "end", "status"):
        assert np.array_equal(getattr(t, name).numpy(),
                              np.asarray(getattr(j, name))), name
    for jl, tl in ((j.fwd_log, t.fwd_log), (j.bwd_log, t.bwd_log)):
        n = np.asarray(jl.n)
        assert np.array_equal(tl.n.numpy(), n)
        w = tl.pos.shape[1]
        live = np.arange(w)[None, :] < n[:, None]
        for f in ("pos", "meta"):
            assert np.array_equal(
                np.where(live, getattr(tl, f).numpy(), 0),
                np.where(live, np.asarray(getattr(jl, f))[:, :w], 0)), f


def _lengths(kind):
    if kind == "uniform":
        return np.full(B, RLEN, np.int32)
    return np.random.default_rng(3).integers(
        K + 5, RLEN + 1, size=B).astype(np.int32)


@pytest.mark.parametrize("kind", ["uniform", "variable"])
def test_batch_matches_jax_event_mode(batch, kind):
    """JAX at its CPU defaults (full sweep, one loop level); variable
    lengths take its gather-path remap. The set departs from the plain
    walk on some reads, so the event mode is what is compared."""
    codes, quals, jstate, jmeta, tstate, tmeta = batch
    lengths = _lengths(kind)
    c = codes.copy()
    c[np.arange(RLEN)[None, :] >= lengths[:, None]] = -2
    jcfg, tcfg = _cfgs()
    jres = jcorr.correct_batch(jstate, jmeta, c, quals, lengths, jcfg,
                               event_driven=True)
    tres = tcorr.correct_batch(tstate, tmeta, c, quals, lengths, tcfg)
    _assert_same(jres, tres)
    assert int((tres.fwd_log.n + tres.bwd_log.n).sum()) > 0


def test_batch_matches_jax_at_accelerator_levers_and_tiny_cap(batch):
    """JAX's compacted sweep, two drain levels and an ambiguous-lane cap
    of 1 (stall-and-retry everywhere): the same result as the port."""
    codes, quals, jstate, jmeta, tstate, tmeta = batch
    lengths = _lengths("uniform")
    jcfg, tcfg = _cfgs()
    jres = jcorr.correct_batch(jstate, jmeta, codes, quals, lengths, jcfg,
                               ambig_cap=1, event_driven=True,
                               compact_sweep=True, drain_levels=2)
    tres = tcorr.correct_batch(tstate, tmeta, codes, quals, lengths, tcfg)
    _assert_same(jres, tres)


@pytest.fixture(scope="module")
def heavy_batch():
    """256 reads of 50 bp (the shapes above) from a 500 bp genome, 2%
    substitutions, and on the first 160 reads a substitution every 10th
    base as well (low quality on every erroneous base). The table holds
    these reads and 256 more of the genome at 2%, so each dense error's
    own window is in it beside its true sibling: an ambiguous position."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, size=500, dtype=np.int8)

    def sample(n, dense=0):
        s = rng.integers(0, len(genome) - RLEN, size=n)
        c = genome[s[:, None] + np.arange(RLEN)[None, :]].astype(np.int8)
        errs = rng.random(c.shape) < 0.02
        phase = rng.integers(0, 10, size=dense)
        errs[:dense] |= np.arange(RLEN)[None, :] % 10 == phase[:, None]
        c = np.where(errs, (c + rng.integers(1, 4, size=c.shape)) % 4, c)
        q = np.full(c.shape, 70, np.uint8)
        q[errs] = 68
        return c.astype(np.int8), q

    more, more_q = sample(B)
    codes, quals = sample(B, dense=160)
    return (codes, quals) + _table(np.concatenate([more, codes]),
                                   np.concatenate([more_q, quals]))


def test_batch_matches_jax_past_the_prepass_cap(heavy_batch):
    """More ambiguous positions than JAX's pre-pass holds (max(256,
    B*L/16), corrector._correct_core): JAX sends the positions past its
    cap, read-major, to its in-loop probe, the port pre-passes them all;
    the BatchResults are equal. The overflow lies in anchored reads, so
    the walk reaches it."""
    codes, quals, jstate, jmeta, tstate, tmeta = heavy_batch
    lengths = _lengths("uniform")
    jcfg, tcfg = _cfgs()
    pk = tpacking.pack_reads(codes, quals, lengths,
                             thresholds=(tcfg.qual_cutoff,))
    tc, hqb, tl, anc = kernels.stage2_head(
        tstate.rows, tmeta, torch.from_numpy(pk.to_wire()), B, RLEN,
        pk.thresholds, tcfg.qual_cutoff, skip=1, good=2, anchor_count=3)
    aux = kernels.event_planes(
        tstate.rows, tmeta, tc, hqb, tl, anc[1],
        tcorr.make_keep_table(tmeta, tcfg, "cpu"), min_count=1,
        cutoff=CUTOFF)[2]
    amb = ((aux >> ref.AX_PRE) & 1).reshape(-1)
    cap = max(256, B * RLEN // 16)
    assert int(amb.sum()) > cap
    over = ((amb == 1) & (torch.cumsum(amb, 0) > cap)).view(B, RLEN)
    assert int((over.any(1) & anc[0]).sum()) > 0
    jres = jcorr.correct_batch(jstate, jmeta, codes, quals, lengths, jcfg,
                               event_driven=True)
    tres = tcorr.correct_batch(tstate, tmeta, codes, quals, lengths, tcfg)
    _assert_same(jres, tres)
    assert int((tres.fwd_log.n + tres.bwd_log.n).sum()) > 0
