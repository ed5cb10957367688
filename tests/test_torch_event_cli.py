"""The port's stage 2 through its CLI in its default, event mode, on an
N-rich seeded set where the JAX package's event mode departs from its
plain loop, against the JAX stage-2 CLI (whose default is event mode):
byte-equal .fa/.log on one device and in both --devices layouts on a
CPU mesh (replicated; routed with the replicate cap at 1k). The port's
plain walk (event_driven=False) stays equal to JAX's plain loop on the
same set. Inputs: 400 reads of 40-300 bp from a 5 kbp genome, 1%
substitutions, 0.3% N, ~10% low-quality bases (k = 17, cutoff 3, qual
cutoff 70), counted by the port's stage-1 CLI on the CPU."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import filecmp

import pytest
import torch

from quorum_tpu.cli import error_correct_reads as jec_cli
from quorum_tpu.io import db_format as jdb
from quorum_tpu.models import corrector as jcorr
from quorum_tpu.models.ec_config import ECConfig as JECConfig
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.models import corrector as tcorr
from quorum_tpu_torch.models.ec_config import ECConfig as TECConfig
from test_torch_corrector_ns import _reads

K = 17
EC = ["-p", "3", "-q", "70", "--batch-size", "512"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops: one thread, so the
    suite's parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nrich(tmp_path_factory):
    """The set as a FASTQ, its port-built database, and the JAX stage-2
    CLI's output on them."""
    d = tmp_path_factory.mktemp("event_cli")
    codes, quals, lengths = _reads(seed=1, n=400, gsize=5000)
    fq = str(d / "reads.fastq")
    with open(fq, "w") as f:
        for i, ln in enumerate(lengths):
            seq = "".join("ACGT"[c] if c >= 0 else "N" for c in codes[i, :ln])
            f.write(f"@r{i}\n{seq}\n+\n{quals[i, :ln].tobytes().decode()}\n")
    db = str(d / "db.jf")
    assert tcdb_cli.main(["-s", "100k", "-m", str(K), "-b", "7", "-q", "38",
                          "--device", "cpu", "-o", db, fq]) == 0
    jout = str(d / "jax")
    assert jec_cli.main(EC + ["-o", jout, db, fq]) == 0
    return dict(d=d, fq=fq, db=db, jout=jout, codes=codes, quals=quals,
                lengths=lengths)


def _records(prefix):
    with open(prefix + ".fa") as f:
        lines = f.read().split("\n")
    return {h.split()[0][1:]: (h, s) for h, s in zip(lines[0::2],
                                                     lines[1::2]) if h}


def _rendered(results):
    return {f"r{i}": (f">r{i} {r.fwd_log} {r.bwd_log}", r.seq)
            for i, r in enumerate(results) if r.ok}


def _same(a, b):
    return all(filecmp.cmp(a + ext, b + ext, shallow=False)
               for ext in (".fa", ".log"))


@pytest.fixture(scope="module")
def plain(nrich):
    """Both packages' plain walks on the set, from the database's table:
    (JAX's reads, the port's reads) as finish_batch gives them."""
    state, meta, _h, _st = tdb.load_db(nrich["db"], "cpu")
    jstate, jmeta, _jh = jdb.read_db(nrich["db"])
    codes, quals, lengths = nrich["codes"], nrich["quals"], nrich["lengths"]
    n = len(lengths)
    jcfg = JECConfig(k=K, cutoff=3, qual_cutoff=70)
    jres = jcorr.correct_batch(jstate, jmeta, codes, quals, lengths, jcfg,
                               event_driven=False)
    tcfg = TECConfig(k=K, cutoff=3, qual_cutoff=70)
    tres = tcorr.correct_batch(state, meta, codes, quals, lengths, tcfg,
                               event_driven=False)
    return (jcorr.finish_batch(jres, n, jcfg, codes=codes),
            tcorr.finish_batch(tres, n, codes, tcfg))


def test_jax_event_mode_departs_from_its_plain_loop(nrich, plain):
    """The set holds reads where JAX's event mode (its CLI) and its plain
    loop write different records, so the tests below compare the mode
    that departs."""
    jax_plain, _port_plain = plain
    event = _records(nrich["jout"])
    differ = [h for h, rec in _rendered(jax_plain).items()
              if event.get(h) != rec]
    assert len(differ) >= 1


def test_stage2_cli_event_mode_is_byte_equal_to_jax(nrich, tmp_path):
    out = str(tmp_path / "port")
    assert tec_cli.main(EC + ["--device", "cpu", "-o", out, nrich["db"],
                              nrich["fq"]]) == 0
    assert _same(out, nrich["jout"])


def test_plain_walk_equals_jax_plain_loop(plain):
    def fields(rs):
        return [(r.ok, r.error, r.seq, r.fwd_log, r.bwd_log) for r in rs]

    jax_plain, port_plain = plain
    assert fields(port_plain) == fields(jax_plain)


@pytest.mark.parametrize("layout", ["replicated", "routed"])
def test_devices_layouts_are_byte_equal_to_one_device_and_jax(
        nrich, tmp_path, monkeypatch, layout):
    """--devices 2 on a mesh naming the CPU twice, in the replicated
    layout and, with the replicate cap under the table, the routed one
    (HK16's and HK4's event sharded-table entries as plain versions)."""
    if layout == "routed":
        monkeypatch.setenv("QUORUM_REPLICATE_TABLE_BYTES", "1k")
    out = str(tmp_path / layout)
    assert tec_cli.main(EC + ["--device", "cpu", "--devices", "2", "-o", out,
                              nrich["db"], nrich["fq"]]) == 0
    assert _same(out, nrich["jout"])
