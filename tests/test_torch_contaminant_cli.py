"""The port's contaminant and homo-trim path at the user surface, on the
CPU (--device cpu: the kernels' plain versions): quorum_error_correct_reads
with --contaminant (a FASTA, a v5 database written by the port, a
reference binary/quorum_db and a Jellyfish binary_dumper file, each
holding the same set), with --trim-contaminant and with --homo-trim, and
the quorum driver with all three, write the JAX package's bytes."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import pytest

from quorum_tpu.cli import error_correct_reads as jec_cli
from quorum_tpu.cli import quorum as jquorum
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.cli import quorum as tquorum
from test_torch_contaminant import K, READS, _same, golden  # noqa: F401


@pytest.fixture(scope="module")
def golden_db(golden):
    db = str(golden["dir"] / "golden.jf")
    assert tcdb_cli.main(["-s", "64k", "-m", str(K), "-b", "7", "-q", "38",
                          "-o", db, "--device", "cpu", READS]) == 0
    return db


# the port's runs take the golden reads in one batch of their own size
# (the bytes do not depend on the batch size; the default 8192-row batch
# is mostly padding); the JAX runs keep the default
BATCH = ["--batch-size", "256"]
# the JAX CLI's runs; the port's runs with the same set in another file
# kind compare against the FASTA run (test_torch_contaminant holds the
# kinds' membership equal)
JAX_RUNS = {"kill": ["--contaminant", "fasta"],
            "trim": ["--contaminant", "fasta", "--trim-contaminant"],
            "homo": ["--homo-trim", "3"]}


@pytest.fixture(scope="module")
def jax_out(golden, golden_db):
    """The JAX CLI's output prefix of each run, made once."""
    made = {}

    def get(run):
        if run not in made:
            argv = [golden["files"].get(f, f) for f in JAX_RUNS[run]]
            made[run] = str(golden["dir"] / f"jax_{run}")
            assert jec_cli.main(argv + ["-o", made[run], golden_db,
                                        READS]) == 0
        return made[run]
    return get


@pytest.mark.parametrize("run,kind", [
    ("kill", "fasta"), ("kill", "db"), ("kill", "ref"), ("kill", "jf"),
    ("trim", "fasta"), ("homo", None)])
def test_stage2_cli_matches_jax(golden, golden_db, jax_out, tmp_path, run,
                                kind):
    argv = [golden["files"][kind] if f == "fasta" else f
            for f in JAX_RUNS[run]]
    tout = str(tmp_path / "t")
    assert tec_cli.main(argv + BATCH + ["-o", tout, "--device", "cpu",
                                        golden_db, READS]) == 0
    for ext in (".fa", ".log"):
        assert _same(tout + ext, jax_out(run) + ext)
    if run == "kill":
        assert "Contaminated read" in open(tout + ".log").read()


def test_driver_with_every_flag_matches_jax(golden, tmp_path):
    argv = ["-s", "64k", "-k", str(K), "--contaminant",
            golden["files"]["fasta"], "--contaminant-trim", "--homo-trim",
            "3"]
    tout, jout = str(tmp_path / "t"), str(tmp_path / "j")
    assert tquorum.main(argv + BATCH + ["-p", tout, "--device", "cpu",
                                        READS]) == 0
    assert jquorum.main(argv + ["-p", jout, "--devices", "1", READS]) == 0
    for ext in (".fa", ".log"):
        assert _same(tout + ext, jout + ext)
