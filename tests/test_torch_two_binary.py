"""The two-binary path on the golden reads, on the CPU: the port's
quorum_create_database with a table small enough to double at least
twice (grow HK8, leftovers through HK1's keys entry, seal, export HK6),
then the port's quorum_error_correct_reads on its own from that file
(load HK7, stage-2 head HK5, extension HK4). The outputs equal the
golden fixtures and the JAX package's stand-alone stage 2 on the same
file, and grown databases load both ways."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import filecmp
import os

import pytest

from quorum_tpu.cli import create_database as jcdb_cli
from quorum_tpu.cli import error_correct_reads as jec_cli
from quorum_tpu.io import db_format as jdb
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.ops import ctable as tct

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLDEN, "reads.fastq")
SMALL = "100"  # 16 rows: the golden reads' table doubles several times
CDB = ["-s", SMALL, "-m", "13", "-b", "7", "-q", "38"]
VARIANTS = {"p4": (["-p", "4"], ""), "auto": ([], "_auto")}


def _golden(out, suffix):
    return all(filecmp.cmp(out + ext,
                           os.path.join(GOLDEN, f"expected{suffix}{ext}"),
                           shallow=False) for ext in (".fa", ".log"))


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The golden reads' database built with -s 100 by each package."""
    d = tmp_path_factory.mktemp("two_binary")
    handoff: dict = {}
    port = str(d / "port.jf")
    assert tcdb_cli.main(CDB + ["-o", port, "--device", "cpu", READS],
                         handoff=handoff) == 0
    jax = str(d / "jax.jf")
    assert jcdb_cli.main(CDB + ["-o", jax, READS]) == 0
    return d, port, jax, handoff["db"][2]


def test_build_grows_and_writes_the_jax_payload(dbs):
    _d, port, jax, stats = dbs
    assert stats.grows >= 2
    assert tdb.read_header(port)["rb_log2"] == \
        tct.tile_rb_for(100, 13, 7) + stats.grows
    assert tdb.db_payload_bytes(port) == jdb.db_payload_bytes(jax)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_standalone_stage2_reproduces_golden(dbs, variant):
    d, port, _jax, _stats = dbs
    extra, suffix = VARIANTS[variant]
    out = str(d / f"port_{variant}")
    assert tec_cli.main(extra + [port, READS, "-o", out, "--device",
                                 "cpu"]) == 0
    assert _golden(out, suffix)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_jax_stage2_on_the_port_database(dbs, variant):
    d, port, _jax, _stats = dbs
    extra, suffix = VARIANTS[variant]
    out = str(d / f"jax_{variant}")
    assert jec_cli.main(extra + ["-o", out, port, READS]) == 0
    assert _golden(out, suffix)


def test_port_stage2_on_the_jax_database(dbs):
    d, _port, jax, stats = dbs
    out = str(d / "port_on_jax")
    assert tec_cli.main([jax, READS, "-o", out, "--device", "cpu"]) == 0
    assert _golden(out, "_auto")
    # the load's statistics are the build's
    _s, _m, _h, load_stats = tdb.load_db(jax, device="cpu")
    assert load_stats == (stats.distinct, stats.distinct_hq, stats.total_hq)
