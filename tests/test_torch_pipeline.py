"""The port's command-line pipeline on the golden reads, on the CPU
(--device cpu: the kernels' plain versions): the stage CLIs reproduce
the committed fixtures byte for byte, the quorum driver reproduces the
JAX driver's .fa/.log and database payload, database files load both
ways, and tile_state_from_numpy round-trips."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import filecmp
import os

import numpy as np
import pytest

from quorum_tpu.cli import quorum as jquorum
from quorum_tpu.io import db_format as jdb
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.cli import quorum as tquorum
from quorum_tpu_torch.io import db_format as tdb

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLDEN, "reads.fastq")


def _same(a, b):
    return filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("variant", ["p4", "auto"])
def test_stage_clis_reproduce_golden(tmp_path, variant):
    db = str(tmp_path / "db.jf")
    assert tcdb_cli.main(["-s", "64k", "-m", "13", "-b", "7", "-q", "38",
                          "-o", db, "--device", "cpu", READS]) == 0
    out = str(tmp_path / "corr")
    extra = ["-p", "4"] if variant == "p4" else []
    assert tec_cli.main(extra + [db, READS, "-o", out, "--device",
                                 "cpu"]) == 0
    suffix = "" if variant == "p4" else "_auto"
    assert _same(out + ".fa", os.path.join(GOLDEN, f"expected{suffix}.fa"))
    assert _same(out + ".log", os.path.join(GOLDEN, f"expected{suffix}.log"))


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    d = tmp_path_factory.mktemp("drivers")
    argv = ["-s", "64k", "-k", "13"]
    assert tquorum.main(argv + ["-p", str(d / "port"), "--device", "cpu",
                                READS]) == 0
    assert jquorum.main(argv + ["-p", str(d / "jax"), "--devices", "1",
                                READS]) == 0
    return d


def test_driver_matches_jax_driver(drivers):
    d = drivers
    assert _same(str(d / "port.fa"), str(d / "jax.fa"))
    assert _same(str(d / "port.log"), str(d / "jax.log"))
    assert (tdb.db_payload_bytes(str(d / "port_mer_database.jf"))
            == jdb.db_payload_bytes(str(d / "jax_mer_database.jf")))


def test_driver_reparses_past_the_replay_cap(drivers, tmp_path,
                                            monkeypatch):
    """Past REPLAY_CACHE_BYTES the driver drops its cache of parsed
    batches and stage 2 parses the reads again: same output bytes."""
    from quorum_tpu_torch.io import fastq as tfastq

    calls = []
    real = tfastq.read_batches

    def counting(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(tfastq, "read_batches", counting)
    monkeypatch.setattr(tquorum, "REPLAY_CACHE_BYTES", 1)
    out = str(tmp_path / "capped")
    assert tquorum.main(["-s", "64k", "-k", "13", "-p", out, "--device",
                         "cpu", READS]) == 0
    assert len(calls) == 2  # stage 1's parse and stage 2's re-parse
    assert _same(out + ".fa", str(drivers / "port.fa"))
    assert _same(out + ".log", str(drivers / "port.log"))


def test_databases_load_both_ways(drivers, tmp_path):
    d = drivers
    port_db = str(d / "port_mer_database.jf")
    jax_db = str(d / "jax_mer_database.jf")
    # the JAX package reads the port's file and writes it back unchanged
    js, jm, _h = jdb.read_db(port_db, to_device=False)
    jdb.write_db(str(tmp_path / "j.qdb"), js, jm)
    assert (jdb.db_payload_bytes(str(tmp_path / "j.qdb"))
            == tdb.db_payload_bytes(port_db))
    # and the port reads the JAX package's file
    ts, tm, _h, _stats = tdb.load_db(jax_db, device="cpu")
    tdb.write_db(str(tmp_path / "t.qdb"), ts, tm, db_version=4)
    assert (tdb.db_payload_bytes(str(tmp_path / "t.qdb"))
            == jdb.db_payload_bytes(jax_db))
    assert (tm.k, tm.bits, tm.rb_log2) == (jm.k, jm.bits, jm.rb_log2)


def test_tile_state_from_numpy_round_trips(drivers):
    js, jm, _h = jdb.read_db(str(drivers / "jax_mer_database.jf"),
                             to_device=False)
    rows = np.asarray(js.rows)
    ts, tm = tdb.tile_state_from_numpy(rows, jm.k, jm.bits, jm.rb_log2,
                                       "cpu")
    assert (tm.k, tm.bits, tm.rb_log2) == (jm.k, jm.bits, jm.rb_log2)
    assert np.array_equal(ts.rows.numpy().view(np.uint32), rows)
    with pytest.raises(ValueError):
        tdb.tile_state_from_numpy(rows[:-1], jm.k, jm.bits, jm.rb_log2,
                                  "cpu")


def test_corrupt_v5_database_is_refused(drivers, tmp_path):
    src = str(drivers / "port_mer_database.jf")
    bad = str(tmp_path / "bad.jf")
    data = bytearray(open(src, "rb").read())
    rows = tdb.read_header(src)["rows"]
    data[len(data.split(b"\n", 1)[0]) + 1 + rows + 10] ^= 0xFF  # a lo word
    open(bad, "wb").write(bytes(data))
    assert tec_cli.main(["-p", "4", bad, READS, "-o",
                         str(tmp_path / "x"), "--device", "cpu"]) == 3
    with pytest.raises(tdb.IntegrityError):
        tdb.load_db(bad, device="cpu", verify="sample")
    tdb.load_db(bad, device="cpu", verify="off")  # structural load only
