"""The port's two inspection CLIs against the JAX package's, on the
golden reads' database in every format both packages write (v5, v4 and
the reference's binary/quorum_db), each written by either package:
query_mer_database's stdout and stderr, histo_mer_database's stdout and
its --json document; the observability flags whose machinery is not
ported refused; without a card the default --device cuda refuses."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from quorum_tpu.cli import create_database as jcdb_cli
from quorum_tpu.cli import histo_mer_database as jhisto
from quorum_tpu.cli import query_mer_database as jquery
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import histo_mer_database as thisto
from quorum_tpu_torch.cli import query_mer_database as tquery
from quorum_tpu_torch import kernels
from quorum_tpu_torch.io import db_format
from quorum_tpu_torch.ops import ctable, mer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLDEN, "reads.fastq")
CDB = ["-s", "64k", "-m", "13", "-b", "7", "-q", "38"]
FORMATS = {"v5": [], "v4": ["--db-version", "4"], "ref": ["--ref-format"]}
K = 13
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The golden database in every format, written by each package."""
    d = tmp_path_factory.mktemp("inspect")
    out = {}
    for fmt, flags in FORMATS.items():
        for who, main, extra in (("port", tcdb_cli.main, ["--device", "cpu"]),
                                 ("jax", jcdb_cli.main, [])):
            path = str(d / f"{who}_{fmt}.jf")
            assert main(CDB + flags + extra + ["-o", path, READS]) == 0
            out[(fmt, who)] = path
    return out


@pytest.fixture(scope="module")
def mers():
    """Seeded query mers: 24 that occur in the reads, 12 random ones
    (almost surely absent), and one of the wrong length."""
    rng = np.random.default_rng(15)
    with open(READS) as f:
        seqs = [ln.strip() for i, ln in enumerate(f) if i % 4 == 1]
    got = []
    while len(got) < 24:
        s = seqs[int(rng.integers(len(seqs)))]
        i = int(rng.integers(len(s) - K + 1))
        if set(s[i:i + K]) <= set("ACGT"):
            got.append(s[i:i + K])
    got += ["".join("ACGT"[c] for c in rng.integers(0, 4, K))
            for _ in range(12)]
    return got + ["ACGTACGT"]


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


CASES = [(fmt, who) for fmt in FORMATS for who in ("port", "jax")]


@pytest.mark.parametrize("fmt,who", CASES)
def test_query_matches_jax(dbs, mers, fmt, who):
    path = dbs[(fmt, who)]
    got = _run(tquery.main, CPU + [path] + mers)
    assert got == _run(jquery.main, [path] + mers)
    rc, out, err = got
    lines = out.splitlines()
    assert rc == 0 and lines[0] == str(K) and len(lines) == 1 + 36
    assert err == f"ACGTACGT: wrong length (k={K})\n"
    found = [ln for ln in lines[1:25] if " val:0 " not in ln]
    assert len(found) == 24


@pytest.mark.parametrize("fmt,who", CASES)
def test_histo_matches_jax(dbs, tmp_path, fmt, who):
    path = dbs[(fmt, who)]
    tj, jj = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    got = _run(thisto.main, CPU + ["--json", tj, path])
    want = _run(jhisto.main, ["--json", jj, path])
    assert got == want
    assert got[0] == 0 and got[1]
    with open(tj) as f:
        doc = json.load(f)
    with open(jj) as f:
        assert doc == json.load(f)
    assert doc["schema"] == "quorum-tpu-histo/1"
    assert doc["stats"]["distinct_total"] == 3525
    assert not os.path.exists(tj + ".tmp")


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_histo_same_for_either_writer(dbs, fmt):
    """A format written by either package reads to the same histogram,
    and every format to the v5 file's."""
    got = _run(thisto.main, CPU + [dbs[(fmt, "port")]])
    assert got == _run(thisto.main, CPU + [dbs[(fmt, "jax")]])
    assert got == _run(thisto.main, CPU + [dbs[("v5", "port")]])


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_card_lookup_matches_host_lookup(dbs, mers, fmt):
    """What query_mer_database runs on a card, HK3 over all the mers at
    once (its plain version here), gives each mer's host lookup."""
    state, meta, _h, _st = db_format.load_db(dbs[(fmt, "port")], "cpu")
    keys = []
    for s in mers[:-1]:
        chi, clo = mer.canonical_py(*mer.pack_kmer(s), K)
        keys.append((chi << 32) | clo)
    host = tquery.lookup_values(state, meta, keys)
    card = kernels.tile_lookup(state.rows, meta, torch.tensor(keys))
    assert card.tolist() == host
    assert sum(v != 0 for v in host[:24]) == 24


def test_histo_of_value_words_matches_jax(dbs):
    """The bincount histogram against JAX's np.add.at one, counts past
    the cap and empty words among them, from numpy and from the slot
    values of a table."""
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 2 * 1500, 5000).astype(np.uint32)
    vals[::7] = 0
    assert np.array_equal(thisto.histo(vals), jhisto.histo(vals))
    assert np.array_equal(thisto.histo(torch.from_numpy(vals)),
                          jhisto.histo(vals))
    state, meta, _h, _st = db_format.load_db(dbs[("v5", "port")], "cpu")
    _khi, _klo, v = ctable.tile_iterate(state, meta)
    assert np.array_equal(thisto.histo(ctable.slot_values(state.rows, meta)),
                          jhisto.histo(v))


@pytest.mark.parametrize("main,argv", [
    (tquery.main, ["--alert-rules", "r.json"]),
    (thisto.main, ["--metrics-push-url", "http://localhost:9"]),
    (thisto.main, ["--metrics-push-interval", "5"]),
])
def test_observability_flags_refused(dbs, main, argv):
    """The flags whose machinery is not ported are refused with the
    ROADMAP item that brings them (the telemetry core's own flags run:
    tests/test_torch_observability_cli.py; the live exposition's:
    tests/test_torch_export.py)."""
    rc, out, err = _run(main, CPU + argv + [dbs[("v5", "port")]]
                        + (["ACGTACGTACGTA"] if main is tquery.main else []))
    assert rc == 1 and out == ""
    assert "is not ported to quorum_tpu_torch yet" in err
    assert "ROADMAP Queue 1 item" in err


def test_default_device_needs_a_card(dbs):
    """Like every entry point of the port, the tools run on the card
    unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, out, err = _run(thisto.main, [dbs[("v5", "port")]])
    assert rc == 1 and out == "" and "CUDA is not available" in err
