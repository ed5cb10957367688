"""The memory-frugal stage 1 on the CPU: the port's
quorum_create_database and quorum driver with --prefilter two-pass and
inline (HK9-HK11's plain versions), and its stage 2 with the presence
floor (HK12's), against the JAX package on the reads of
tests/test_memfrugal.py (k = 15, 512 x 80 bp, 1% substitutions, ~10%
low-quality bases).

The guarantees: a two-pass database is the JAX package's payload with
the same prefilter declaration and full-table Poisson statistics; stage
2 on it is byte-equal to stage 2 on the unfiltered database at presence
floor 2 (the floor theorem), also when the build grows; and either
package's stage 2 corrects either package's prefiltered database to the
same bytes."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import filecmp

import pytest
import torch

from bench import write_fastq
from quorum_tpu.cli import create_database as jcdb_cli
from quorum_tpu.cli import error_correct_reads as jec_cli
from quorum_tpu.cli import quorum as jquorum
from quorum_tpu.io import db_format as jdb
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.cli import quorum as tquorum
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.models import create_database as tcdb
from quorum_tpu_torch.ops import sketch as tsk
from test_torch_sketch import BATCH, K, memfrugal_reads

CDB = ["-s", "100k", "-m", str(K), "-b", "7", "-q", "38", "--batch-size",
       str(BATCH)]
CPU = ["--device", "cpu"]


def same_output(a, b):
    return all(filecmp.cmp(a + ext, b + ext, shallow=False)
               for ext in (".fa", ".log"))


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The reads as FASTQ, and their databases: the port's unfiltered
    and two-pass builds, and the JAX package's two-pass build."""
    d = tmp_path_factory.mktemp("prefilter")
    fq = str(d / "reads.fastq")
    write_fastq(fq, *memfrugal_reads(True))
    out = {"dir": d, "fastq": fq}
    for name, main, extra in (("plain", tcdb_cli.main, CPU),
                              ("port", tcdb_cli.main,
                               CPU + ["--prefilter", "two-pass"]),
                              ("jax", jcdb_cli.main,
                               ["--prefilter", "two-pass"])):
        out[name] = str(d / f"{name}.jf")
        assert main(CDB + extra + ["-o", out[name], fq]) == 0
    return out


def test_two_pass_database_matches_jax(dbs):
    assert tdb.db_payload_bytes(dbs["port"]) == \
        jdb.db_payload_bytes(dbs["jax"])
    ph, jh = tdb.read_header(dbs["port"]), jdb.read_header(dbs["jax"])
    assert ph["prefilter"] == jh["prefilter"]
    assert ph["poisson_stats"] == jh["poisson_stats"]
    pf = ph["prefilter"]
    assert pf["mode"] == "two-pass" and pf["min_obs"] == 2
    assert pf["dropped"] > 0 and pf["false_pass"] >= 0
    # the header's statistics are the unfiltered table's
    _s, _m, hp, (occ, distinct, total) = tdb.load_db(dbs["plain"])
    assert "prefilter" not in hp and "poisson_stats" not in hp
    assert ph["poisson_stats"] == {"distinct_hq": distinct,
                                   "total_hq": total}
    assert ph["n_entries"] == occ - pf["dropped"]


def test_floor_theorem_in_the_port(dbs):
    """Stage 2 on the two-pass database (its declared floor) equals
    stage 2 on the unfiltered one at --presence-floor 2, and the floor
    matters on these reads."""
    d, fq = dbs["dir"], dbs["fastq"]
    outs = {}
    for name, db, extra in (("pf", dbs["port"], []),
                            ("floor", dbs["plain"], ["--presence-floor", "2"]),
                            ("nofloor", dbs["plain"], [])):
        outs[name] = str(d / f"ec_{name}")
        assert tec_cli.main(CPU + extra + ["-o", outs[name], db, fq]) == 0
    assert same_output(outs["pf"], outs["floor"])
    assert not same_output(outs["pf"], outs["nofloor"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_prefiltered_database_corrects_alike_in_both_packages(dbs, writer):
    """Each package's stage 2 on the same prefiltered file: byte-equal.
    Both take the header's full-table statistics for the cutoff and the
    declared floor (an unfloored port stage 2 with the filtered table's
    own statistics gave other bytes)."""
    d, fq = dbs["dir"], dbs["fastq"]
    port, jax = str(d / f"{writer}_by_port"), str(d / f"{writer}_by_jax")
    assert tec_cli.main(CPU + ["-o", port, dbs[writer], fq]) == 0
    assert jec_cli.main(["-o", jax, dbs[writer], fq]) == 0
    assert same_output(port, jax)


@pytest.fixture(scope="module")
def drivers(dbs):
    d, fq = dbs["dir"], dbs["fastq"]
    args = ["-s", "100k", "-k", str(K), "-q", "33", "--batch-size",
            str(BATCH)]
    out = {}
    for name, main, extra in (
            ("port_two", tquorum.main, CPU + ["--prefilter", "two-pass"]),
            ("jax_two", jquorum.main, ["--prefilter", "two-pass"]),
            ("port_inline", tquorum.main, CPU + ["--prefilter", "inline"])):
        out[name] = str(d / f"drv_{name}")
        assert main(args + extra + ["-p", out[name], fq]) == 0
    return out


def test_two_pass_driver_matches_jax(drivers):
    """The driver hands stage 1 a factory (the second pass re-parses)
    and stage 2 the table in-process, which takes the build's header
    statistics and floor: the JAX driver's bytes."""
    assert same_output(drivers["port_two"], drivers["jax_two"])
    assert tdb.db_payload_bytes(drivers["port_two"] + "_mer_database.jf") \
        == jdb.db_payload_bytes(drivers["jax_two"] + "_mer_database.jf")


def test_inline_driver_declares_its_floor(drivers, dbs):
    db = drivers["port_inline"] + "_mer_database.jf"
    h = tdb.read_header(db)
    assert h["prefilter"]["mode"] == "inline" and h["prefilter"]["min_obs"] == 2
    # stage 2 run on its own from the file gives the driver's bytes
    out = str(dbs["dir"] / "inline_alone")
    assert tec_cli.main(CPU + ["-o", out, db, dbs["fastq"]]) == 0
    assert same_output(out, drivers["port_inline"])


def test_two_pass_build_that_grows_holds_the_floor_theorem(dbs):
    """-s 100: the two-pass build doubles its table several times; the
    grown database still corrects like the floored unfiltered one."""
    d, fq = dbs["dir"], dbs["fastq"]
    db = str(d / "grown.jf")
    handoff: dict = {}
    argv = ["-s", "100"] + CDB[2:] + CPU + ["--prefilter", "two-pass"]
    assert tcdb_cli.main(argv + ["-o", db, fq], handoff=handoff) == 0
    stats = handoff["db"][2]
    assert stats.grows >= 2
    assert tdb.read_header(db)["poisson_stats"] == \
        tdb.read_header(dbs["port"])["poisson_stats"]
    grown, floor = str(d / "ec_grown"), str(d / "ec_grown_floor")
    assert tec_cli.main(CPU + ["-o", grown, db, fq]) == 0
    assert tec_cli.main(CPU + ["--presence-floor", "2", "-o", floor,
                               dbs["plain"], fq]) == 0
    assert same_output(grown, floor)


def test_modes_resolve_and_refuse(dbs, tmp_path, monkeypatch, capsys):
    """`auto` takes QUORUM_PREFILTER when it names a mode (else off); an
    unknown mode is refused by the CLI and by the library."""
    monkeypatch.setenv("QUORUM_PREFILTER", "two-pass")
    assert tsk.prefilter_default() == "two-pass"
    out = str(tmp_path / "auto.jf")
    assert tcdb_cli.main(CDB + CPU + ["-o", out, dbs["fastq"]]) == 0
    assert tdb.db_payload_bytes(out) == tdb.db_payload_bytes(dbs["port"])
    monkeypatch.setenv("QUORUM_PREFILTER", "bogus")
    assert tsk.prefilter_default() == "off"
    with pytest.raises(SystemExit):
        tcdb_cli.main(CDB + CPU + ["--prefilter", "bogus", "-o", out,
                                   dbs["fastq"]])
    assert "invalid choice" in capsys.readouterr().err
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="unknown prefilter mode"):
        tcdb.build_database([dbs["fastq"]], tcdb.BuildConfig(
            device="cpu", prefilter="bogus"), cpu)
