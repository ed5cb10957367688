"""The port's --devices N through its CLIs on the CPU (--device cpu, a
mesh that names the CPU N times, the kernels' plain versions): the
quorum driver at --devices 4 reproduces the golden fixtures and the JAX
driver's --devices 4 run (bytes and database payload), each package
loads the other's 4-shard manifest, --partitions and the routed
stage-2 layout run over the mesh, and the refusals carry the JAX
package's messages and exit codes (the routed layout's on cards without
peer access: tests/test_torch_routed_cli.py). Inputs: the golden reads
(k = 13). Exact comparisons throughout."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import filecmp
import os

import numpy as np
import pytest
import torch

import quorum_tpu_torch
from quorum_tpu.cli import create_database as jcdb_cli
from quorum_tpu.cli import quorum as jquorum
from quorum_tpu.io import db_format as jdb
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.cli import quorum as tquorum
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.parallel import tile_sharded as tts

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
READS = os.path.join(GOLDEN, "reads.fastq")
CDB = ["-s", "64k", "-m", "13", "-b", "7", "-q", "38"]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the
    cores (a golden driver run: about 3 s in a process of its own,
    100-150 s beside five other loaded xdist workers on 8 cores with
    the default thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def golden_output(prefix):
    return all(filecmp.cmp(prefix + ext,
                           os.path.join(GOLDEN, f"expected_auto{ext}"),
                           shallow=False) for ext in (".fa", ".log"))


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """The port's and the JAX package's quorum driver at --devices 4
    with the sharded layout on the golden reads."""
    d = tmp_path_factory.mktemp("sharded_drivers")
    argv = ["-s", "64k", "-k", "13", "--devices", "4", "--db-layout",
            "sharded"]
    assert tquorum.main(argv + CPU + ["-p", str(d / "port"), READS]) == 0
    assert jquorum.main(argv + ["-p", str(d / "jax"), READS]) == 0
    return d


def test_driver_devices_4_matches_golden_and_jax(drivers):
    d = drivers
    assert golden_output(str(d / "port"))
    for ext in (".fa", ".log"):
        assert filecmp.cmp(str(d / f"port{ext}"), str(d / f"jax{ext}"),
                           shallow=False)
    port_db = str(d / "port_mer_database.jf")
    jax_db = str(d / "jax_mer_database.jf")
    assert tdb.db_payload_bytes(port_db) == jdb.db_payload_bytes(jax_db)
    for path in (port_db, jax_db):
        h = tdb.read_header(path)
        assert h["n_shards"] == 4 and len(h["shards"]) == 4


@pytest.mark.parametrize("devices", ["1", "2"])
def test_jax_manifest_corrects_in_the_port(drivers, tmp_path, devices):
    out = str(tmp_path / "ec")
    assert tec_cli.main(CPU + ["--devices", devices, "-o", out,
                               str(drivers / "jax_mer_database.jf"),
                               READS]) == 0
    assert golden_output(out)


def test_port_manifest_loads_in_jax(drivers):
    pst, pmeta, _ph = jdb.read_db(str(drivers / "port_mer_database.jf"),
                                  to_device=False)
    jst, jmeta, _jh = jdb.read_db(str(drivers / "jax_mer_database.jf"),
                                  to_device=False)
    assert pmeta == jmeta
    assert np.array_equal(np.asarray(pst.rows), np.asarray(jst.rows))


def test_stage2_rounds_the_batch_size_up(drivers, tmp_path, capsys):
    out = str(tmp_path / "ec")
    assert tec_cli.main(CPU + ["--devices", "4", "--batch-size", "10", "-o",
                               out, str(drivers / "port_mer_database.jf"),
                               READS]) == 0
    assert ("quorum_error_correct_reads: rounding --batch-size up to 12 "
            "(multiple of --devices 4)") in capsys.readouterr().err
    assert golden_output(out)


# ------------------------------------------------ refusals


@pytest.mark.parametrize("argv,msg", [
    (["--devices", "3"], "--devices must be a power of two (leading-bit "
                         "shard layout), got 3"),
    (["--devices", "2", "--prefilter", "two-pass"],
     "--prefilter composes with --devices 1 today; use --partitions for "
     "multi-pass capacity over a mesh"),
])
def test_stage1_refuses_as_jax(tmp_path, capsys, argv, msg):
    out = str(tmp_path / "db.jf")
    assert tcdb_cli.main(CDB + CPU + argv + ["-o", out, READS]) == 1
    assert msg in capsys.readouterr().err
    assert jcdb_cli.main(CDB + argv + ["-o", out, READS]) == 1
    assert msg in capsys.readouterr().err
    assert not os.path.exists(out)


CARDS = torch.cuda.device_count()
ASK = max(2, CARDS + 1)  # more CUDA devices than the host has


@pytest.mark.parametrize("argv,msg", [
    # --partitions over the mesh runs (msg None: the golden bytes)
    (["--devices", "2", "--partitions", "4"] + CPU, None),
    (["--devices", str(ASK), "--device", "cuda"],
     f"--devices {ASK} but only {CARDS} local device(s) present"),
])
def test_driver_refuses(tmp_path, capsys, argv, msg):
    out = str(tmp_path / "out")
    rc = tquorum.main(["-s", "64k", "-k", "13", "-p", out] + argv + [READS])
    if msg is None:
        assert rc == 0 and golden_output(out)
        return
    assert rc == 1
    assert msg in capsys.readouterr().err
    assert not os.path.exists(out + ".fa")


def test_routed_layout_is_refused(drivers, tmp_path, capsys, monkeypatch):
    """No longer refused: a table over the replicate cap takes the
    routed layout (row-sharded, loaded onto the mesh) and corrects to
    the golden bytes."""
    monkeypatch.setenv("QUORUM_REPLICATE_TABLE_BYTES", "1k")
    out = str(tmp_path / "ec")
    assert tec_cli.main(CPU + ["--devices", "2", "-o", out,
                               str(drivers / "port_mer_database.jf"),
                               READS]) == 0
    assert "goes on with one device" not in capsys.readouterr().err
    assert golden_output(out)


# ------------------------------------------------ --devices auto


def two_cards(monkeypatch, peers=True):
    """A host that reports two CUDA devices, with or without peer access
    between them, where "cuda" resolves to the CPU: the CLIs' --devices
    policy sees two cards while the work runs through the kernels' plain
    versions."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: peers)
    for mod in (quorum_tpu_torch, tquorum, tcdb_cli, tec_cli):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda name="cuda": torch.device("cpu"))


ONE = "--devices auto goes on with one device instead of 2"


@pytest.mark.parametrize("argv,cap", [
    (["-s", "64k", "--partitions", "4"], None),
    # the table at -s 64k is over the cap before stage 1
    (["-s", "64k"], "1k"),
    # 2^5 global rows at -s 100 fit the cap; the build grows past it
    (["-s", "100"], str(tts.table_bytes(5))),
])
def test_driver_auto_devices_fall_back_to_one(tmp_path, capsys, monkeypatch,
                                              argv, cap):
    """With the default --devices (auto) on a two-card host with peer
    access, --partitions and a table past the replicated layout's cap
    (from the start, or grown past it) run over both devices and give
    the golden bytes; nothing falls back to one device any more (no
    note). An explicit --devices 2 takes the same path
    (test_driver_refuses, test_routed_layout_is_refused)."""
    two_cards(monkeypatch)
    if cap is not None:
        monkeypatch.setenv("QUORUM_REPLICATE_TABLE_BYTES", cap)
    out = str(tmp_path / "auto")
    assert tquorum.main(argv + ["-k", "13", "-p", out, READS]) == 0
    assert ONE not in capsys.readouterr().err
    assert golden_output(out)


def test_stage2_auto_devices_fall_back_to_one(drivers, tmp_path, capsys,
                                              monkeypatch):
    """quorum_error_correct_reads with the default --devices on a
    two-card host with peer access corrects a table over the replicated
    layout's cap over both devices, in the routed layout (no note)."""
    two_cards(monkeypatch)
    monkeypatch.setenv("QUORUM_REPLICATE_TABLE_BYTES", "1k")
    out = str(tmp_path / "ec")
    assert tec_cli.main(["-o", out, str(drivers / "port_mer_database.jf"),
                         READS]) == 0
    assert ONE not in capsys.readouterr().err
    assert golden_output(out)
