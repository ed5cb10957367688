"""The JAX package's event-driven corrector, its default, departs from
the reference on some reads with an N in reach of the backward
extension (ROADMAP Queue 3); the port's default, event mode, departs
with it, and its plain walk (event_driven=False) follows the reference.
This pins one such read where both substitute the N but with different
bases: on a seeded set of 1,500 reads (40-300 bp from a 20 kbp genome,
1% substitutions, 0.3% N, ~10% low-quality bases, k = 17, cutoff 3,
qual cutoff 70), read 191's backward log is `32:sub:N-T` in the port's
plain walk, in JAX's plain loop and in the oracle, and `32:sub:N-G` in
the event mode of both packages. Exact comparison of every rendered
field."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quorum_tpu.models import corrector as jcorr
from quorum_tpu.models.ec_config import ECConfig as JECConfig
from quorum_tpu.models.oracle import DictDB, OracleCorrector
from quorum_tpu.ops import ctable as jct
from quorum_tpu_torch.io import packing as tpacking
from quorum_tpu_torch.io.fastq import ReadBatch
from quorum_tpu_torch.models import corrector as tcorr
from quorum_tpu_torch.models import create_database as tcdb
from quorum_tpu_torch.models.ec_config import ECConfig as TECConfig

K = 17
READ = 191


def _reads(seed=0, n=1500, gsize=20000, width=304):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=gsize, dtype=np.int8)
    codes = np.full((n, width), -2, np.int8)
    quals = np.zeros((n, width), np.uint8)
    lengths = rng.integers(40, 301, size=n).astype(np.int32)
    for i in range(n):
        ln = lengths[i]
        s = rng.integers(0, gsize - ln)
        c = genome[s:s + ln].copy()
        if rng.random() < 0.5:
            c = (3 - c[::-1]).astype(np.int8)
        e = rng.random(ln) < 0.01
        c[e] = (c[e] + rng.integers(1, 4, size=e.sum())) % 4
        c[rng.random(ln) < 0.003] = -1
        codes[i, :ln] = c
        quals[i, :ln] = np.where(rng.random(ln) < 0.1, 35, 73)
    return codes, quals, lengths


@pytest.fixture(scope="module")
def case():
    """The set's table (the port's stage 1 on the CPU, at the JAX
    package's geometry for -s 400000) and read 191 alone."""
    codes, quals, lengths = _reads()
    pk = tpacking.pack_reads(codes, quals, lengths, thresholds=(38,))
    n = len(lengths)
    cfg = tcdb.BuildConfig(k=K, bits=7, qual_thresh=38, initial_size=400000,
                           batch_size=n, device="cpu")
    state, meta, _stats = tcdb.build_database(
        [], cfg, torch.device("cpu"),
        batches_factory=lambda: [(ReadBatch(codes, quals, lengths, [], n),
                                  pk)])
    jstate = jct.TileState(jnp.asarray(state.rows.numpy().view(np.uint32)))
    jmeta = jct.TileMeta(k=K, bits=7, rb_log2=meta.rb_log2)
    one = slice(READ, READ + 1)
    return state, meta, jstate, jmeta, codes[one], quals[one], lengths[one]


def _jax(case, event_driven):
    _s, _m, jstate, jmeta, codes, quals, lengths = case
    cfg = JECConfig(k=K, cutoff=3, qual_cutoff=70)
    res = jcorr.correct_batch(jstate, jmeta, codes, quals, lengths, cfg,
                              event_driven=event_driven)
    return jcorr.finish_batch(res, 1, cfg, codes=codes)[0]


def _fields(r):
    return (r.ok, r.error, r.seq, r.fwd_log, r.bwd_log, r.start, r.end)


def test_backward_n_substitution_follows_the_reference(case):
    state, meta, jstate, jmeta, codes, quals, lengths = case
    cfg = TECConfig(k=K, cutoff=3, qual_cutoff=70)
    res = tcorr.correct_batch(state, meta, codes, quals, lengths, cfg,
                              event_driven=False)
    port = tcorr.finish_batch(res, 1, codes, cfg)[0]
    plain = _jax(case, event_driven=False)
    ln = int(lengths[0])
    seq = "".join("ACGT"[c] if c >= 0 else "N" for c in codes[0, :ln])
    oracle = OracleCorrector(DictDB.from_table(jstate, jmeta),
                             JECConfig(k=K, cutoff=3, qual_cutoff=70)
                             ).correct(seq, "".join(map(chr, quals[0, :ln])))
    assert _fields(port) == _fields(plain) == _fields(oracle)
    assert port.ok and "32:sub:N-T" in port.bwd_log.split()
    # the recorded departure of JAX's default (event-driven) mode
    event = _jax(case, event_driven=True)
    assert "32:sub:N-G" in event.bwd_log.split()


def test_backward_n_substitution_in_event_mode_follows_jax(case):
    """The port's default, event mode, writes JAX's event-mode record."""
    state, meta, _js, _jm, codes, quals, lengths = case
    cfg = TECConfig(k=K, cutoff=3, qual_cutoff=70)
    res = tcorr.correct_batch(state, meta, codes, quals, lengths, cfg)
    port = tcorr.finish_batch(res, 1, codes, cfg)[0]
    assert _fields(port) == _fields(_jax(case, event_driven=True))
    assert port.ok and "32:sub:N-G" in port.bwd_log.split()
