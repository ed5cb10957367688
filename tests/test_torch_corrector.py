"""The port's stage-2 corrector (anchor sweep + the plain version of HK4)
against quorum_tpu.models.corrector.correct_batch on the same table and
the same reads. Exact comparison, field by field: status/start/end for
every read, `out` inside [start, end) for corrected reads, and each
log's n with its first n pos/meta entries (slots past n and the
internal lwin are padding)."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quorum_tpu.io import fastq as jfastq
from quorum_tpu.io import packing as jpacking
from quorum_tpu.models import corrector as jcorr
from quorum_tpu.models import create_database as jcdb
from quorum_tpu.models import error_correct as jec
from quorum_tpu.models.ec_config import ECConfig as JECConfig
from quorum_tpu.ops.poisson import poisson_term
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.models import corrector as tcorr
from quorum_tpu_torch.models import error_correct as tec
from quorum_tpu_torch.models.ec_config import ECConfig as TECConfig
from quorum_tpu_torch.ops import ctable as tctable
from quorum_tpu_torch.ops import poisson as tpoisson

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reads.fastq")


@pytest.fixture(scope="module")
def table():
    """The golden stage-1 table (k=13), built by the JAX package and
    carried into the port with tile_state_from_numpy."""
    batches = [(b, jpacking.pack_reads(b.codes, b.quals, b.lengths,
                                       thresholds=(38,)))
               for b in jfastq.read_batches([GOLDEN], 256)]
    cfg = jcdb.BuildConfig(k=13, bits=7, qual_thresh=38, initial_size=64000,
                           batch_size=256)
    jstate, jmeta, _stats = jcdb.build_database([], cfg, batches=batches)
    tstate, tmeta = tdb.tile_state_from_numpy(
        np.asarray(jstate.rows), jmeta.k, jmeta.bits, jmeta.rb_log2, "cpu")
    golden = batches[0][0]
    return jstate, jmeta, tstate, tmeta, golden


def _cfgs(meta, cutoff, qual_cutoff=127):
    return (JECConfig(k=meta.k, cutoff=cutoff, qual_cutoff=qual_cutoff),
            TECConfig(k=meta.k, cutoff=cutoff, qual_cutoff=qual_cutoff))


def _compare(jres, tres, n):
    status = np.asarray(jres.status)[:n]
    assert np.array_equal(tres.status.numpy()[:n], status)
    assert np.array_equal(tres.start.numpy()[:n], np.asarray(jres.start)[:n])
    assert np.array_equal(tres.end.numpy()[:n], np.asarray(jres.end)[:n])
    jout = np.asarray(jres.out)
    tout = tres.out.numpy()
    start = np.asarray(jres.start)
    end = np.asarray(jres.end)
    for i in np.nonzero(status == 0)[0]:
        s, e = start[i], end[i]
        assert np.array_equal(tout[i, s:e], jout[i, s:e]), i
    for jl, tl in ((jres.fwd_log, tres.fwd_log), (jres.bwd_log, tres.bwd_log)):
        jn = np.asarray(jl.n)[:n]
        assert np.array_equal(tl.n.numpy()[:n], jn)
        jp, jm = np.asarray(jl.pos), np.asarray(jl.meta)
        for i in np.nonzero(jn)[0]:
            c = jn[i]
            assert np.array_equal(tl.pos.numpy()[i, :c], jp[i, :c]), i
            assert np.array_equal(tl.meta.numpy()[i, :c], jm[i, :c]), i


def test_cutoff_matches_resolve_cutoff(table):
    jstate, jmeta, tstate, tmeta, _g = table
    want = jec.resolve_cutoff(jstate, jmeta, jec.ECOptions())
    # the statistics the stand-alone stage 2 takes: HK7's, on loading
    # the table's payload
    payload = tctable.tile_export_v4(tstate, tmeta)
    n = (payload.size - tmeta.rows) // (4 + tmeta.hi_bytes)
    _s, (_occ, distinct, total) = tctable.tile_load(payload, tmeta, n, "cpu")
    assert tec.resolve_cutoff(tec.ECOptions(device="cpu"),
                              (distinct, total)) == want


@pytest.mark.parametrize("max_val", [127, 15])
def test_keep_table_matches_device_poisson_term(max_val):
    """The host-built keep table equals the JAX float32 term's verdict
    over every (sum of kept counts, c_ori) the corrector can ask."""
    cp, thr = 0.01 / 3.0, 1e-6
    s = np.arange(4 * max_val + 1)[:, None]
    c = np.arange(max_val + 1)[None, :]
    lam = jnp.asarray(s, jnp.float32) * jnp.float32(cp)
    want = np.asarray(poisson_term(lam, jnp.asarray(
        np.broadcast_to(c, (s.shape[0], c.shape[1])))) < thr)
    got = tpoisson.keep_table(max_val, cp, thr)
    assert np.array_equal(got.astype(bool), want)


@pytest.mark.parametrize("cutoff", [4, 2])
def test_golden_batch_matches_jax(table, cutoff):
    jstate, jmeta, tstate, tmeta, g = table
    jcfg, tcfg = _cfgs(jmeta, cutoff)
    jres = jcorr.correct_batch(jstate, jmeta, g.codes, g.quals, g.lengths,
                               jcfg)
    tres = tcorr.correct_batch(tstate, tmeta, g.codes, g.quals, g.lengths,
                               tcfg)
    _compare(jres, tres, g.n)
    assert int((tres.fwd_log.n + tres.bwd_log.n).sum()) > 0


def _seeded_ns(g):
    """Golden reads with Ns sprinkled in, cut short, or replaced by
    random sequence (no anchor)."""
    rng = np.random.default_rng(5)
    n = g.n
    codes = g.codes[:n].copy()
    quals = g.quals[:n].copy()
    lengths = g.lengths[:n].copy()
    inread = np.arange(codes.shape[1])[None, :] < lengths[:, None]
    codes[(rng.random(codes.shape) < 0.02) & inread] = -1
    short = rng.random(n) < 0.1
    lengths[short] = rng.integers(5, 30, size=int(short.sum()))
    rnd = rng.random(n) < 0.05
    codes[rnd] = rng.integers(0, 4, size=(int(rnd.sum()), codes.shape[1]))
    pad = np.arange(codes.shape[1])[None, :] >= lengths[:, None]
    codes[pad] = -2
    quals[pad] = 0
    return codes, quals, lengths


def test_seeded_batch_with_ns_and_short_reads(table):
    """Golden reads with Ns sprinkled in, cut short, or replaced by
    random sequence (no anchor), and a qual cutoff that protects some
    bases. The port's plain walk (event_driven=False) held to the JAX
    plain loop, which agrees with the oracle here; the event mode of
    both departs from it at some backward-direction Ns where both
    substitute (ROADMAP, Queue 3)."""
    jstate, jmeta, tstate, tmeta, g = table
    n = g.n
    codes, quals, lengths = _seeded_ns(g)
    jcfg, tcfg = _cfgs(jmeta, 3, qual_cutoff=70)
    jres = jcorr.correct_batch(jstate, jmeta, codes, quals, lengths, jcfg,
                               event_driven=False)
    tres = tcorr.correct_batch(tstate, tmeta, codes, quals, lengths, tcfg,
                               event_driven=False)
    _compare(jres, tres, n)
    assert int((codes[tres.status.numpy() == 0] == -1).sum()) > 0
    status = tres.status.numpy()
    assert (status == 0).any() and (status != 0).any()


def test_seeded_batch_with_ns_and_short_reads_event_mode(table):
    """The same reads in event mode, the default of both packages."""
    jstate, jmeta, tstate, tmeta, g = table
    codes, quals, lengths = _seeded_ns(g)
    jcfg, tcfg = _cfgs(jmeta, 3, qual_cutoff=70)
    jres = jcorr.correct_batch(jstate, jmeta, codes, quals, lengths, jcfg,
                               event_driven=True)
    tres = tcorr.correct_batch(tstate, tmeta, codes, quals, lengths, tcfg)
    _compare(jres, tres, g.n)
