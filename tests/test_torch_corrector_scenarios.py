"""The port's stage-2 corrector on the adversarial k=9 scenarios of
tests/test_corrector.py: exact (count, quality) tables that force the
Poisson keep, the Poisson reject and next-base tie-break with Ns, and
the err_log window-trip rewind. The plain version of HK4's plain walk
(event_driven=False) is held to the JAX plain loop field by field and,
through the rendered .fa text, to the oracle (models/oracle.py, pinned
to the reference binary); the port's default, event mode (HK16, HK17
and HK4's event entry as their plain versions), to JAX's event mode."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import numpy as np
import pytest

from quorum_tpu.models import corrector as jcorr
from quorum_tpu.models.ec_config import ECConfig as JECConfig
from quorum_tpu.models.oracle import OracleCorrector
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.models import corrector as tcorr
from quorum_tpu_torch.models.ec_config import ECConfig as TECConfig
from quorum_tpu_torch.models.error_correct import render_result
from test_torch_corrector import _compare



def _scenario(name):
    """The adversarial k=9 scenarios of tests/test_corrector.py (exact
    (count, quality) tables that force the Poisson keep, the Poisson
    reject + next-base tie-break with Ns, and the window-trip rewind)."""
    from test_corrector import (BASES, K, add_seq, rand_quals, rand_seq,
                                table_from_dict)

    rng = np.random.default_rng(7)
    db = {}
    reads, quals = [], []
    if name == "branching":
        core = rand_seq(rng, 40)
        add_seq(db, core[:20] + "A" + core[20:], 10, 1)
        add_seq(db, core[:20] + "C" + core[20:], 7, 1)
        src_of = lambda: core[:20] + ("A" if rng.random() < 0.5 else "C") \
            + core[20:]  # noqa: E731
        cfg = dict(cutoff=30)
    else:
        g = rand_seq(rng, 300)
        add_seq(db, g, 3, 1)
        if name == "tiebreak":
            add_seq(db, rand_seq(rng, 60), 5, 0)
        src_of = lambda: g  # noqa: E731
        cfg = (dict(cutoff=8, qual_cutoff=60) if name == "tiebreak"
               else dict(cutoff=30, window=6, error=2))
    for _ in range(64):
        src = src_of()
        start = int(rng.integers(0, max(len(src) - 30, 1)))
        ln = int(min(len(src) - start, 25 + rng.integers(0, 15)))
        r = list(src[start:start + ln])
        for j in range(int(rng.integers(1, 4))):
            r[min(int(rng.integers(0, ln)) + j, ln - 1)] = \
                BASES[rng.integers(0, 4)]
        if name == "tiebreak" and rng.random() < 0.3:
            r[rng.integers(0, ln)] = "N"
        reads.append("".join(r))
        quals.append(rand_quals(rng, ln))
    state, meta, dictdb = table_from_dict(db, K)
    return state, meta, dictdb, reads, quals, cfg


def _batch(name):
    """A scenario as a batch: (JAX table, its port copy, the oracle's
    table, reads, quals, codes, qual array, lengths, JAX and port
    configs)."""
    state, meta, dictdb, reads, quals, kw = _scenario(name)
    b, l = len(reads), max(len(r) for r in reads)
    codes = np.full((b, l), -2, np.int8)
    qarr = np.zeros((b, l), np.uint8)
    lengths = np.array([len(r) for r in reads], np.int32)
    for i, (r, q) in enumerate(zip(reads, quals)):
        codes[i, :len(r)] = [{"A": 0, "C": 1, "G": 2, "T": 3}.get(c, -1)
                             for c in r]
        qarr[i, :len(r)] = np.frombuffer(q.encode(), np.uint8)
    jcfg = JECConfig(k=meta.k, poisson_dtype="float32", **kw)
    tcfg = TECConfig(k=meta.k, **kw)
    tstate, tmeta = tdb.tile_state_from_numpy(
        np.asarray(state.rows), meta.k, meta.bits, meta.rb_log2, "cpu")
    return (state, meta, tstate, tmeta, dictdb, reads, quals, codes, qarr,
            lengths, jcfg, tcfg)


@pytest.mark.parametrize("name", ["branching", "tiebreak", "window"])
def test_adversarial_scenarios_match_jax_and_oracle(name):
    (state, meta, tstate, tmeta, dictdb, reads, quals, codes, qarr, lengths,
     jcfg, tcfg) = _batch(name)
    b = len(reads)
    jres = jcorr.correct_batch(state, meta, codes, qarr, lengths, jcfg,
                               event_driven=False)
    tres = tcorr.correct_batch(tstate, tmeta, codes, qarr, lengths, tcfg,
                               event_driven=False)
    _compare(jres, tres, b)
    oc = OracleCorrector(dictdb, jcfg)
    got = tcorr.finish_batch(tres, b, codes)
    for i in range(b):
        o = oc.correct(reads[i], quals[i])
        assert render_result("r", got[i], tcfg) == \
            render_result("r", o, tcfg), (i, reads[i])


@pytest.mark.parametrize("name", ["branching", "tiebreak", "window"])
def test_adversarial_scenarios_event_mode_match_jax(name):
    (state, meta, tstate, tmeta, _db, reads, _q, codes, qarr, lengths,
     jcfg, tcfg) = _batch(name)
    jres = jcorr.correct_batch(state, meta, codes, qarr, lengths, jcfg,
                               event_driven=True)
    tres = tcorr.correct_batch(tstate, tmeta, codes, qarr, lengths, tcfg)
    _compare(jres, tres, len(reads))
