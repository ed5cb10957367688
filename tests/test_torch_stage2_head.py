"""The plain version of HK5 (quorum_tpu_torch/kernels/reference.py:
stage2_head: wire widening, one lookup per window, the anchor scan)
against the JAX package's mer.wire_parts_device / unpack_codes_device /
synth_quals_device and corrector.find_anchors (no contaminant), on the
same packed wire and the same golden table; and at the read shapes the
hand kernel's scan must handle (k = 24 and 31, reads of up to 150 bases
whose lengths are no multiple of 8, anchors past position 32 and runs
of good windows across the 32-window chunks it scans, a read without an
anchor whose base 0 is N), on tables the JAX package builds. Integer
work: every comparison is exact."""

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
from quorum_tpu.ops import ctable as jct
from quorum_tpu.ops import mer as jmer
from quorum_tpu_torch import kernels
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.io import packing as tpacking
from quorum_tpu_torch.kernels import reference as ref

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reads.fastq")
QC = 70  # a qual cutoff between the golden reads' low and high values
QT = 38  # the shaped tables' stage-1 threshold
WIDTH = 150  # the shaped reads' row width (no multiple of 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops: one thread, so the
    suite's parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def shaped_tables():
    """k -> (genome, JAX table, its meta, the port's copy, its meta): an
    800 bp genome's 96 full-width reads at ~18x, all bases high quality,
    counted by the JAX package's stage 1 (each k built once)."""
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 800).astype(np.int8)
    start = rng.integers(0, genome.size - WIDTH, 96)
    codes = genome[start[:, None] + np.arange(WIDTH)[None, :]]
    quals = np.full(codes.shape, 70, np.uint8)
    lengths = np.full(96, WIDTH, np.int32)
    cache = {}

    def get(k):
        if k not in cache:
            jmeta = jct.TileMeta(k=k, bits=7, rb_log2=8)
            bj, full, _obs = jct.tile_insert_reads_packed(
                jct.make_tile_build(jmeta), jmeta,
                jpacking.pack_reads(codes, quals, lengths, thresholds=(QT,)),
                QT)
            assert not full
            jstate = jct.tile_seal(bj, jmeta)[0]
            tstate, tmeta = tdb.tile_state_from_numpy(
                np.asarray(jstate.rows), k, 7, 8, "cpu")
            cache[k] = (genome, jstate, jmeta, tstate, tmeta)
        return cache[k]

    return get


def _shaped_reads(genome, k, skip, good, seed):
    """40 reads in rows WIDTH wide: an empty read, one shorter than k,
    random sequence (no anchor) with an N at base 0 (read 2) and without
    one, reads whose bases up to q are N so that the first valid window
    ends just before a 32-window chunk's edge (the run of `good` windows
    crosses it) or deep in the read (anchors past position 32), and
    genome reads of random lengths with Ns and substitutions."""
    rng = np.random.default_rng(seed)
    b = 40
    start = rng.integers(0, genome.size - WIDTH, b)
    codes = genome[start[:, None] + np.arange(WIDTH)[None, :]].copy()
    lengths = rng.integers(5, WIDTH + 1, b).astype(np.int32)
    lengths[0], lengths[1] = 0, k - 3
    codes[2:4] = rng.integers(0, 4, (2, WIDTH))
    codes[2, 0] = -1
    base = skip + k - 1  # the scan's first window end
    ends = [base + 31 - j for j in range(max(good - 1, 1))]
    ends += [base + 63 - j for j in range(max(good - 1, 1))]
    ends += list(rng.integers(base + 33, WIDTH - good - 2, 16 - len(ends)))
    for r, e0 in enumerate(ends, start=4):
        lengths[r] = WIDTH
        codes[r, :e0 - k + 1] = -1  # the first valid window ends at e0
    rest = slice(20, b)
    sub = rng.random(codes[rest].shape) < 0.01
    codes[rest] = np.where(sub, (codes[rest] + 1) % 4, codes[rest])
    codes[rest] = np.where(rng.random(codes[rest].shape) < 0.02, -1,
                           codes[rest])
    pad = np.arange(WIDTH)[None, :] >= lengths[:, None]
    codes[pad] = -2
    quals = np.where(rng.random(codes.shape) < 0.1, 60, 70).astype(np.uint8)
    quals[pad] = 0
    return codes, quals, lengths


@pytest.mark.parametrize("k,skip,good", [(24, 1, 2), (24, 3, 4), (31, 0, 3),
                                         (31, 1, 2)])
def test_stage2_head_matches_jax_at_read_shapes(shaped_tables, k, skip,
                                                good):
    genome, jstate, jmeta, tstate, tmeta = shaped_tables(k)
    codes, quals, lengths = _shaped_reads(genome, k, skip, good, k + skip)
    b, length = codes.shape
    pk = tpacking.pack_reads(codes, quals, lengths, thresholds=(QC,))
    cfg = JECConfig(k=k, skip=skip, good=good, anchor_count=3, cutoff=4,
                    qual_cutoff=QC)
    want = _jax_head(jstate, jmeta, pk.to_wire(), b, length, cfg)
    tc, th, tl, anc = kernels.stage2_head(
        tstate.rows, tmeta, torch.from_numpy(pk.to_wire()), b, length,
        pk.thresholds, QC, skip=skip, good=good, anchor_count=3)
    names = ("codes", "hqb", "lengths", "found", "start_off", "f", "r",
             "prev")
    for name, x, y in zip(names, (tc, th, tl, *anc), want):
        assert np.array_equal(x.numpy(), y.astype(x.numpy().dtype)), name
    found, start_off = anc[0].numpy(), anc[1].numpy()
    rel = start_off - 1 - (skip + k - 1)  # from the scan's first window
    assert (found & (start_off - 1 > 32)).any()  # anchors past 32
    # a run of good windows that began in the chunk before the anchor's
    assert (found & (rel >= 32) & (rel % 32 < good - 1)).any()
    # no anchor, base 0 an N: position 0's mers, N as A, and no value
    assert not found[2] and not found[0] and not found[1]
    assert (anc[2][2], anc[3][2], anc[4][2]) == (0, 3 << (2 * (k - 1)), 0)
