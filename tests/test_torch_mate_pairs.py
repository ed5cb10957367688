"""The port's paired-end mode against the JAX package's, on the golden
reads split into two mate files: merge_mate_pairs and split_mate_pairs
byte for byte (FASTA mates included) and their refusals; the quorum
driver's -P (merge | correct | split in process) at -t 1 and -t 4
against the JAX driver's -P; -P forcing --no-discard and keeping no
replay cache; --debug's command lines and vlog lines, --version and
--verify-db forwarded to stage 2."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import contextlib
import filecmp
import io
import os
import re

import pytest
import torch

from quorum_tpu.cli import merge_mate_pairs as jmerge
from quorum_tpu.cli import quorum as jquorum
from quorum_tpu.cli import split_mate_pairs as jsplit
from quorum_tpu.utils import vlog as jvlog
from quorum_tpu_torch.cli import merge_mate_pairs as tmerge
from quorum_tpu_torch.cli import quorum as tquorum
from quorum_tpu_torch.cli import split_mate_pairs as tsplit
from quorum_tpu_torch.utils import vlog as tvlog

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLDEN, "reads.fastq")
# the port's plain versions run one 256-row batch; JAX keeps its default
PORT = ["--device", "cpu", "--batch-size", "256"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet():
    """A MonkeyPatch that turns both packages' vlog off (a -v or --debug
    run turns it on for the rest of the process)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jvlog, "verbose", False)
    mp.setattr(tvlog, "verbose", False)
    return mp


def _run(main, argv):
    """rc and stderr of main(argv), vlog turned off again after it."""
    err = io.StringIO()
    mp = _quiet()
    try:
        with contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        mp.undo()
    return rc, err.getvalue()


def _vlog_lines(err: str) -> list:
    """The vlog lines of a run's stderr, their time stamps and JAX's
    stage-timer lines left out."""
    out = []
    for line in err.splitlines():
        m = re.match(r"^\[\d{4}/\d\d/\d\d \d\d:\d\d:\d\d\] (.*)$", line)
        if m and not m.group(1).startswith(("stage ", "total ")):
            out.append(m.group(1))
    return out


def _same(a, b):
    return filecmp.cmp(a, b, shallow=False)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """The golden reads dealt alternately into two mate files, as FASTQ
    and as FASTA."""
    d = tmp_path_factory.mktemp("pairs")
    with open(READS) as f:
        lines = f.read().splitlines(True)
    recs = [lines[i:i + 4] for i in range(0, len(lines), 4)]
    paths = {}
    for mate in (1, 2):
        mine = recs[mate - 1::2]
        paths[f"fq{mate}"] = str(d / f"r_{mate}.fastq")
        with open(paths[f"fq{mate}"], "w") as f:
            f.write("".join("".join(r) for r in mine))
        paths[f"fa{mate}"] = str(d / f"r_{mate}.fa")
        with open(paths[f"fa{mate}"], "w") as f:
            f.write("".join(">" + r[0][1:] + r[1] for r in mine))
    paths["dir"] = d
    return paths


@pytest.fixture(scope="module")
def drivers(pairs):
    """The JAX driver's -P once (-t 1, --debug), the port's at -t 1
    (--debug) and -t 4."""
    d = pairs["dir"]
    mates = [pairs["fq1"], pairs["fq2"]]
    base = ["-s", "64k", "-k", "13", "-P"]
    runs = {"jax": _run(jquorum.main,
                        base + ["-t", "1", "--devices", "1", "--debug",
                                "-p", str(d / "jax")] + mates)}
    for t in (1, 4):
        extra = ["--debug"] if t == 1 else []
        runs[f"port{t}"] = _run(tquorum.main,
                                base + PORT + extra + ["-t", str(t), "-p",
                                                       str(d / f"port{t}")]
                                + mates)
    for rc, err in runs.values():
        assert rc == 0, err
    return d, runs


@pytest.mark.parametrize("kind", ["fq", "fa"])
def test_merge_matches_jax(pairs, tmp_path, kind):
    """Interleaved records byte for byte; FASTA mates get '*' quals."""
    mates = [pairs[f"{kind}1"], pairs[f"{kind}2"]]
    got, want = str(tmp_path / "t.fq"), str(tmp_path / "j.fq")
    assert tmerge.main(["-o", got] + mates) == 0
    assert jmerge.main(["-o", want] + mates) == 0
    assert _same(got, want)
    with open(got) as f:
        text = f.read()
    assert text.count("\n") == 4 * 242
    if kind == "fa":
        assert "\n+\n" + "*" * 60 + "\n" in text


@pytest.mark.parametrize("case", ["odd", "unpaired"])
def test_merge_refusals_match_jax(pairs, tmp_path, case):
    if case == "odd":
        files = [pairs["fq1"], pairs["fq2"], pairs["fq1"]]
    else:
        short = str(tmp_path / "short.fastq")
        with open(pairs["fq2"]) as f:
            lines = f.read().splitlines(True)
        with open(short, "w") as f:
            f.write("".join(lines[:-4]))
        files = [pairs["fq1"], short]
    got = _run(tmerge.main, ["-o", str(tmp_path / "t.fq")] + files)
    want = _run(jmerge.main, ["-o", str(tmp_path / "j.fq")] + files)
    assert got == want
    assert got[0] == 1
    assert got[1] == ("Must give a even number files\n" if case == "odd"
                      else "Input files are not paired reads.\n")


@pytest.mark.parametrize("source", ["file", "stdin"])
def test_split_matches_jax(drivers, tmp_path, monkeypatch, source):
    """split_mate_pairs of an interleaved .fa, from -i or from stdin."""
    d, _runs = drivers
    fa = str(tmp_path / "both.fa")
    with open(str(d / "jax_1.fa")) as f:
        one = f.read().splitlines(True)
    with open(str(d / "jax_2.fa")) as f:
        two = f.read().splitlines(True)
    with open(fa, "w") as out:
        for i in range(0, len(one), 2):
            out.write("".join(one[i:i + 2] + two[i:i + 2]))
    got, want = str(tmp_path / "t"), str(tmp_path / "j")
    for main, prefix in ((tsplit.main, got), (jsplit.main, want)):
        if source == "file":
            assert main(["-i", fa, prefix]) == 0
        else:
            monkeypatch.setattr("sys.stdin", open(fa))
            assert main([prefix]) == 0
    for mate in ("_1.fa", "_2.fa"):
        assert _same(got + mate, want + mate)
        assert _same(got + mate, str(d / ("jax" + mate)))


@pytest.mark.parametrize("threads", [1, 4])
def test_driver_paired_matches_jax(drivers, threads):
    d, _runs = drivers
    for suffix in ("_1.fa", "_2.fa", ".log"):
        assert _same(str(d / f"port{threads}{suffix}"),
                     str(d / f"jax{suffix}"))
    # the merged .fa is split and removed
    assert not os.path.exists(str(d / f"port{threads}.fa"))


def test_paired_forces_no_discard(drivers):
    """Every mate gives one record, a skipped one an N, in its file."""
    d, _runs = drivers
    for mate in ("_1.fa", "_2.fa"):
        with open(str(d / f"port1{mate}")) as f:
            lines = f.read().splitlines()
        assert len(lines) == 2 * 121
        assert all(h.startswith(">") for h in lines[0::2])
    with open(str(d / "port1.log")) as f:
        skipped = [ln.split()[1].rstrip(":") for ln in f]
    assert skipped
    both = ""
    for mate in ("_1.fa", "_2.fa"):
        with open(str(d / f"port1{mate}")) as f:
            both += f.read()
    for hdr in skipped:
        assert f">{hdr}\nN\n" in both


def test_paired_keeps_no_replay_cache(pairs, tmp_path, monkeypatch):
    """Stage 2 reads the merged mates, never the cache of stage 1's
    batches (which holds the files' order)."""
    calls = []
    monkeypatch.setattr(tquorum, "_drain", lambda items: calls.append(1))
    rc, err = _run(tquorum.main, ["-s", "64k", "-k", "13", "-P"] + PORT
                   + ["-p", str(tmp_path / "q"), pairs["fq1"], pairs["fq2"]])
    assert rc == 0, err
    assert calls == []
    assert _same(str(tmp_path / "q_1.fa"),
                 str(pairs["dir"] / "jax_1.fa"))


def test_paired_debug_vlog_lines_match_jax(drivers):
    _d, runs = drivers
    got, want = _vlog_lines(runs["port1"][1]), _vlog_lines(runs["jax"][1])
    assert got == want
    assert "Done. 241 corrected, 1 skipped of 242 reads" in got


def test_paired_debug_command_lines(drivers):
    d, runs = drivers
    err = runs["port1"][1]
    cmds = [ln for ln in err.splitlines() if ln.startswith("+ ")]
    assert len(cmds) == 2
    assert cmds[0].startswith("+ quorum_create_database ")
    assert " -v " in cmds[0] and cmds[0].endswith("r_1.fastq "
                                                  + str(d / "r_2.fastq"))
    want = re.compile(
        r"^\+ merge_mate_pairs \S+r_1\.fastq \S+r_2\.fastq \| "
        r"quorum_error_correct_reads .*--verify-db full .*--no-discard -v "
        r"\S+port1_mer_database\.jf /dev/fd/0 \| split_mate_pairs "
        r"\S+port1$")
    assert want.match(cmds[1]), cmds[1]


def test_odd_file_count_refused_as_jax(pairs, tmp_path):
    argv = ["-s", "64k", "-k", "13", "-P", "-p", str(tmp_path / "q"),
            pairs["fq1"]]
    got = _run(tquorum.main, argv + ["--device", "cpu"])
    want = _run(jquorum.main, argv)
    assert got == want
    assert got == (1, "With --paired-files an even number of input files "
                      "is required.\n")


@pytest.mark.parametrize("mode", ["unpaired", "paired"])
def test_verify_db_and_debug_forwarded(pairs, tmp_path, monkeypatch, mode):
    """--verify-db reaches stage 2 in both modes; --debug prints the
    stage command lines and passes -v; --on-bad-read reaches stage 1,
    and stage 2 only unpaired (a read skipped in one mate file would
    unpair the rest)."""
    seen = {}

    def fake_cdb(argv, handoff=None, batches_factory=None):
        seen["cdb"] = list(argv)
        handoff["stats"] = None
        return 0

    def fake_ec(argv, db=None, prepacked=None, records=None, report=None):
        seen["ec"], seen["records"] = list(argv), records
        if records is not None:
            out = argv[argv.index("-o") + 1]
            with open(out + ".fa", "w") as f:
                f.write("".join(f">{h}\nN\n" for h, _s, _q in records))
        return 0

    monkeypatch.setattr(tquorum.cdb_cli, "main", fake_cdb)
    monkeypatch.setattr(tquorum.ec_cli, "main", fake_ec)
    prefix = str(tmp_path / "q")
    argv = (["-s", "64k", "-k", "13", "--device", "cpu", "--verify-db",
             "sample", "--debug", "--on-bad-read", "skip", "-p", prefix]
            + (["-P"] if mode == "paired" else [])
            + [pairs["fq1"], pairs["fq2"]])
    rc, err = _run(tquorum.main, argv)
    assert rc == 0, err
    cdb = seen["cdb"][:-2]  # the reads follow the flags
    assert cdb[-1] == "-v"
    assert cdb[cdb.index("--on-bad-read") + 1] == "skip"
    assert f"+ quorum_create_database {' '.join(seen['cdb'])}\n" in err
    ec = seen["ec"]
    assert ec[ec.index("--verify-db") + 1] == "sample"
    assert "-v" in ec
    if mode == "unpaired":
        assert "--no-discard" not in ec and seen["records"] is None
        assert ec[ec.index("--on-bad-read") + 1] == "skip"
        assert f"+ quorum_error_correct_reads {' '.join(ec)}\n" in err
    else:
        assert "--no-discard" in ec and "--on-bad-read" not in ec
        assert "--verify-db sample" in err and "--no-discard -v" in err
        with open(prefix + "_1.fa") as f:
            assert f.read().count(">") == 121


def test_version(capsys):
    with pytest.raises(SystemExit) as e:
        tquorum.main(["--version"])
    assert e.value.code == 0
    out = capsys.readouterr().out.strip()
    assert out == tquorum.VERSION
    assert re.match(r"^1\.1\.1\+torch\.\d+\.\d+\.\d+$", out)
    assert jquorum.VERSION.startswith("1.1.1+")


def test_paired_default_device_needs_a_card(pairs, tmp_path):
    """-P under the default --device cuda fails where the unpaired
    driver fails without a card: before any stage runs."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for extra in (["-P"], []):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tquorum.main(["-s", "64k", "-k", "13", "-p", str(tmp_path / "q")]
                         + extra + [pairs["fq1"], pairs["fq2"]])
    assert os.listdir(tmp_path) == []
