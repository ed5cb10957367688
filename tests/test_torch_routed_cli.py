"""The port's routed stage-2 layout and --partitions P with --devices N
through its CLIs on the CPU (--device cpu, meshes naming the CPU 4
times, the kernels' plain versions) against the JAX package: the
stage-1 CLI's --partitions 4 --devices 4 payload, the stage-2 CLI's
routed --devices 4 from a port and a JAX manifest (the mesh load), and
the mesh load against the one-card load. Inputs: the golden reads
(k = 13). Exact comparisons throughout."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import filecmp
import os

import pytest
import torch

from quorum_tpu.cli import create_database as jcdb_cli
from quorum_tpu.cli import error_correct_reads as jec_cli
from quorum_tpu.io import db_format as jdb
import quorum_tpu_torch
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.cli import quorum as tquorum
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.ops import ctable as tct

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



def _same(a, b):
    return filecmp.cmp(a, b, shallow=False)


def _golden_output(prefix):
    return all(_same(prefix + ext, os.path.join(GOLDEN, f"expected_auto{ext}"))
               for ext in (".fa", ".log"))


def test_partitions_over_devices_payload_matches_jax_and_one_pass(tmp_path):
    """quorum_create_database --partitions 4 --devices 4 (each pass a
    sharded build through HK15's partition entry) writes the payload of
    the JAX package's same command and of --partitions 1 --devices 1."""
    argv = CDB + ["--partitions", "4", "--devices", "4"]
    port, jax_db, one = (str(tmp_path / n) for n in ("p.jf", "j.jf", "1.jf"))
    assert tcdb_cli.main(argv + CPU + ["-o", port, READS]) == 0
    assert jcdb_cli.main(argv + ["-o", jax_db, READS]) == 0
    assert tcdb_cli.main(CDB + CPU + ["--partitions", "1", "--devices", "1",
                                      "-o", one, READS]) == 0
    h = tdb.read_header(port)
    assert h["n_shards"] == 4 and len(h["shards"]) == 4
    want = tdb.db_payload_bytes(one)
    assert tdb.db_payload_bytes(port) == want
    assert jdb.db_payload_bytes(jax_db) == want


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    """The golden reads' database as a 4-shard manifest written by each
    package (--devices 4 --db-layout sharded)."""
    d = tmp_path_factory.mktemp("routed_manifests")
    argv = CDB + ["--devices", "4", "--db-layout", "sharded"]
    assert tcdb_cli.main(argv + CPU + ["-o", str(d / "port.jf"), READS]) == 0
    assert jcdb_cli.main(argv + ["-o", str(d / "jax.jf"), READS]) == 0
    return d


def test_routed_stage2_from_manifests_matches_golden_and_jax(
        manifests, tmp_path, monkeypatch):
    """quorum_error_correct_reads --devices 4 with the replicate cap at
    1k takes the routed layout and loads each package's manifest
    row-sharded (one HK7 launch a shard): .fa/.log equal to the golden
    fixtures and to the JAX package's routed run."""
    monkeypatch.setenv("QUORUM_REPLICATE_TABLE_BYTES", "1k")
    loads = []
    orig = tdb._load_on_mesh

    def spy(*a):
        loads.append(len(a[3]))
        return orig(*a)

    monkeypatch.setattr(tdb, "_load_on_mesh", spy)
    for name in ("port", "jax"):
        out = str(tmp_path / name)
        assert tec_cli.main(CPU + ["--devices", "4", "-o", out,
                                   str(manifests / f"{name}.jf"),
                                   READS]) == 0
        assert _golden_output(out), name
    assert loads == [4, 4]
    jout = str(tmp_path / "jax_run")
    assert jec_cli.main(["--devices", "4", "-o", jout,
                         str(manifests / "jax.jf"), READS]) == 0
    for ext in (".fa", ".log"):
        assert _same(str(tmp_path / "port") + ext, jout + ext)


def test_mesh_load_matches_one_card_load(manifests):
    """A manifest (and the same table as one file) loaded onto a mesh of
    4 or 2 CPU entries: the shards, concatenated, are the one-card
    load's plane, with the same statistics; a one-card load of a
    manifest past rb_log2 24 refuses as the JAX package does."""
    path = str(manifests / "port.jf")
    one, meta1, _h, st1 = tdb.load_db(path, "cpu")
    for S in (4, 2):
        state, meta, _h, st = tdb.load_db(path, mesh=[torch.device("cpu")] * S)
        assert isinstance(state, tct.ShardedTileState)
        assert meta.n_shards == S and meta.rb_log2 == meta1.rb_log2
        assert torch.equal(torch.cat(state.shards), one.rows) and st == st1


def test_one_card_load_past_rb_24_refuses(tmp_path):
    h = {"format": tdb.MANIFEST_FORMAT, "rb_log2": 25, "n_shards": 2,
         "key_len": 48, "bits": 7}
    with pytest.raises(ValueError, match="past the single-chip geometry cap "
                                         "of 24 — run stage 2 with --devices"):
        tdb._load_manifest(str(tmp_path / "m.jf"), h, "off", False)


# ------------------------------------------------ peer access


def two_cards(monkeypatch, peers: bool):
    """A host that reports two CUDA devices, with or without peer access
    between them, where "cuda" resolves to the CPU (as
    test_torch_sharded_cli.two_cards): the CLIs' --devices policy sees
    two cards while the work runs through the kernels' plain versions."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: peers)
    for mod in (quorum_tpu_torch, tquorum, tcdb_cli, tec_cli):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda name="cuda": torch.device("cpu"))


NO_PEER = ("needs peer access between the mesh's cards, which cuda:0 -> "
           "cuda:1 lacks")
ONE = "--devices auto goes on with one device instead of 2"


@pytest.mark.parametrize("size,ok", [("64k", True), ("2G", False)])
def test_driver_routed_without_peer_access(tmp_path, capsys, monkeypatch,
                                           size, ok):
    """On two cards without peer access a table past the cap cannot take
    the routed layout: an explicit --devices 2 is refused with the
    reason before stage 1; auto goes on with one device (a note) where
    one card holds the table (-s 64k), and is refused where it cannot
    (-s 2G: 2^25 global rows)."""
    two_cards(monkeypatch, False)
    monkeypatch.setenv("QUORUM_REPLICATE_TABLE_BYTES", "1k")
    out = str(tmp_path / "explicit")
    assert tquorum.main(["-s", size, "-k", "13", "--devices", "2", "-p", out,
                         READS]) == 1
    err = capsys.readouterr().err
    assert NO_PEER in err and ONE not in err
    assert not os.path.exists(out + "_mer_database.jf")
    out = str(tmp_path / "auto")
    rc = tquorum.main(["-s", size, "-k", "13", "-p", out, READS])
    err = capsys.readouterr().err
    assert NO_PEER in err
    if ok:
        assert rc == 0 and f"{NO_PEER}; {ONE}" in err
        assert _golden_output(out)
    else:
        assert rc == 1 and ONE not in err
        assert not os.path.exists(out + "_mer_database.jf")


@pytest.mark.parametrize("devices", [None, "2"])
def test_stage2_routed_without_peer_access(manifests, tmp_path, capsys,
                                           monkeypatch, devices):
    """quorum_error_correct_reads on two cards without peer access, a
    table over the cap: auto corrects on one device with a note, an
    explicit --devices 2 is refused with the reason."""
    two_cards(monkeypatch, False)
    monkeypatch.setenv("QUORUM_REPLICATE_TABLE_BYTES", "1k")
    out = str(tmp_path / "ec")
    argv = [] if devices is None else ["--devices", devices]
    rc = tec_cli.main(argv + ["-o", out,
                              str(manifests / "port.jf"), READS])
    err = capsys.readouterr().err
    assert NO_PEER in err
    if devices is None:
        assert rc == 0 and f"{NO_PEER}; {ONE}" in err
        assert _golden_output(out)
    else:
        assert rc == 1 and not os.path.exists(out + ".fa")
