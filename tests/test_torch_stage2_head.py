"""The plain version of HK5 (quorum_tpu_torch/kernels/reference.py:
stage2_head: wire widening, one lookup per window, the anchor scan)
against the JAX package's mer.wire_parts_device / unpack_codes_device /
synth_quals_device and corrector.find_anchors (no contaminant), on the
same packed wire and the same golden table. Integer work: every
comparison is exact."""

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
from quorum_tpu.models.ec_config import ECConfig as JECConfig
from quorum_tpu.ops import mer as jmer
from quorum_tpu_torch import kernels
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.io import packing as tpacking
from quorum_tpu_torch.kernels import reference as ref

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reads.fastq")
QC = 70  # a qual cutoff between the golden reads' low and high values


@pytest.fixture(scope="module")
def table():
    """The golden stage-1 table (k = 13), built by the JAX package and
    carried into the port; and the golden batch."""
    batches = [(b, jpacking.pack_reads(b.codes, b.quals, b.lengths,
                                       thresholds=(38,)))
               for b in jfastq.read_batches([GOLDEN], 256)]
    cfg = jcdb.BuildConfig(k=13, bits=7, qual_thresh=38, initial_size=64000,
                           batch_size=256)
    jstate, jmeta, _stats = jcdb.build_database([], cfg, batches=batches)
    tstate, tmeta = tdb.tile_state_from_numpy(
        np.asarray(jstate.rows), jmeta.k, jmeta.bits, jmeta.rb_log2, "cpu")
    return jstate, jmeta, tstate, tmeta, batches[0][0]


def _reads(g, seed):
    """The golden reads with Ns sprinkled in, some cut short (a few
    shorter than k, one empty) and some replaced by random sequence (no
    anchor); -2 past each read."""
    rng = np.random.default_rng(seed)
    n = g.n
    codes = g.codes[:n].copy()
    quals = g.quals[:n].copy()
    lengths = g.lengths[:n].copy()
    inread = np.arange(codes.shape[1])[None, :] < lengths[:, None]
    codes[(rng.random(codes.shape) < 0.02) & inread] = -1
    short = rng.random(n) < 0.1
    lengths[short] = rng.integers(0, 30, size=int(short.sum()))
    lengths[0] = 0
    rnd = rng.random(n) < 0.05
    codes[rnd] = rng.integers(0, 4, size=(int(rnd.sum()), codes.shape[1]))
    pad = np.arange(codes.shape[1])[None, :] >= lengths[:, None]
    codes[pad] = -2
    quals[pad] = 0
    return codes, quals, lengths


def _jax_head(jstate, jmeta, wire, b, length, cfg):
    pcodes, nmask, hq, lengths = jmer.wire_parts_device(
        jnp.asarray(wire), b, length, (cfg.qual_cutoff,))
    codes = jmer.unpack_codes_device(pcodes, nmask, lengths, length)
    quals = jmer.synth_quals_device(hq[cfg.qual_cutoff], length,
                                    cfg.qual_cutoff)
    anc = jcorr.find_anchors(jstate, jmeta, codes, lengths, cfg, None, None,
                             False)
    f = (np.asarray(anc.fhi).astype(np.int64) << 32) \
        | np.asarray(anc.flo).astype(np.int64)
    r = (np.asarray(anc.rhi).astype(np.int64) << 32) \
        | np.asarray(anc.rlo).astype(np.int64)
    return (np.asarray(codes), np.asarray(quals) >= cfg.qual_cutoff,
            np.asarray(lengths), np.asarray(anc.found),
            np.asarray(anc.start_off), f, r, np.asarray(anc.prev_count))


@pytest.mark.parametrize("seed,skip,good,anchor_count",
                         [(5, 1, 2, 3), (6, 0, 1, 1), (7, 3, 4, 6)])
def test_stage2_head_matches_jax(table, seed, skip, good, anchor_count):
    jstate, jmeta, tstate, tmeta, g = table
    codes, quals, lengths = _reads(g, seed)
    b, length = codes.shape
    pk = tpacking.pack_reads(codes, quals, lengths, thresholds=(QC,))
    jpk = jpacking.pack_reads(codes, quals, lengths, thresholds=(QC,))
    assert np.array_equal(pk.to_wire(), jpk.to_wire())
    cfg = JECConfig(k=13, skip=skip, good=good, anchor_count=anchor_count,
                    cutoff=4, qual_cutoff=QC)
    want = _jax_head(jstate, jmeta, jpk.to_wire(), b, length, cfg)
    tc, th, tl, anc = kernels.stage2_head(
        tstate.rows, tmeta, torch.from_numpy(pk.to_wire()), b, length,
        pk.thresholds, QC, skip=skip, good=good, anchor_count=anchor_count)
    got = (tc, th, tl, *anc)
    names = ("codes", "hqb", "lengths", "found", "start_off", "f", "r",
             "prev")
    for name, x, y in zip(names, got, want):
        assert np.array_equal(x.numpy(), y.astype(x.numpy().dtype)), name
    assert np.array_equal(tc.numpy(), codes)
    found = anc[0].numpy()
    assert found.any() and (~found).any()
    # reads with an N inside their anchor scan still anchor
    assert ((codes == -1).any(axis=1) & found).any()


def test_stage2_head_on_the_cpu_is_the_plain_version(table):
    _js, _jm, tstate, tmeta, g = table
    codes, quals, lengths = _reads(g, 8)
    pk = tpacking.pack_reads(codes, quals, lengths, thresholds=(38, QC))
    wire = torch.from_numpy(pk.to_wire())
    args = (tstate.rows, tmeta, wire, len(lengths), codes.shape[1],
            pk.thresholds, QC)
    kw = dict(skip=1, good=2, anchor_count=3)
    a = kernels.stage2_head(*args, **kw)
    b = ref.stage2_head(*args, **kw)
    for x, y in zip(a[:3] + tuple(a[3]), b[:3] + tuple(b[3])):
        assert torch.equal(x, y)
    with pytest.raises(KeyError):
        kernels.stage2_head(*args[:-1], 39, **kw)
    with pytest.raises(ValueError):
        kernels.stage2_head(tstate.rows, tmeta, wire[:-1], *args[3:], **kw)
