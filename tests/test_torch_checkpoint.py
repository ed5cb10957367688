"""Crash safety of the port (quorum_tpu_torch/io/checkpoint.py and its
hooks in both stages and the driver), on the CPU at golden size (242
reads, k = 13, 64-read batches: four batches): a build killed after a
checkpoint and resumed gives JAX's uninterrupted payload (one card,
two-pass, --partitions 2, --devices 2); a stage 2 killed after a
journal commit and resumed gives tests/golden/expected.*, at the
default render workers and at one; mismatched or damaged artifacts are
refused with rc 3 (or a torn tail truncated); each package resumes the
other's stage-1 snapshot and stage-2 journal; the driver's replay cache
keeps JAX's format; and one real process kill (a hard_exit plan in
QUORUM_FAULT_PLAN) resumes to the same bytes."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quorum_tpu.cli import create_database as jcdb_cli
from quorum_tpu.cli import error_correct_reads as jec_cli
from quorum_tpu.io import checkpoint as jck
from quorum_tpu.io import db_format as jdb
from quorum_tpu.io import fastq as jfastq
from quorum_tpu.io import packing as jpacking
from quorum_tpu.models.ec_config import ECConfig as JECConfig
from quorum_tpu.utils import faults as jfaults
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.cli import quorum as tquorum
from quorum_tpu_torch.io import checkpoint as tck
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.io import fastq as tfastq
from quorum_tpu_torch.io import packing as tpacking
from quorum_tpu_torch.models.ec_config import ECConfig, jax_repr
from quorum_tpu_torch.utils import faults as tfaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
READS = os.path.join(GOLDEN, "reads.fastq")
CDB = ["-s", "64k", "-m", "13", "-b", "7", "-q", "38", "--batch-size", "64"]
EC = ["-p", "4", "--batch-size", "64"]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops: one thread, so the
    suite's parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_plan():
    for mod in (tfaults, jfaults):
        mod.reset()
    yield
    for mod in (tfaults, jfaults):
        mod.reset()


def _plan(site, batch, action="error"):
    return json.dumps([{"site": site, "batch": batch, "action": action}])


def _same(a, b):
    return open(a, "rb").read() == open(b, "rb").read()


@pytest.fixture(scope="module")
def jax_dbs(tmp_path_factory):
    """JAX's uninterrupted builds: plain and two-pass prefiltered."""
    d = tmp_path_factory.mktemp("jax_dbs")
    out = {}
    for tag, extra in (("plain", []), ("two-pass", ["--prefilter",
                                                    "two-pass"])):
        out[tag] = str(d / f"{tag}.jf")
        assert jcdb_cli.main(CDB + extra + ["-o", out[tag], READS]) == 0
    return out


# ------------------------------------------------ stage 1: kill, resume


# (extra flags, the insert batch the kill lands on, the artifact the
# kill leaves, the JAX reference); --partitions 2 numbers pass 1's
# batches 4-7
STAGE1_CASES = {
    "single": ([], 2, tck.Stage1Checkpoint, "plain"),
    "two-pass": (["--prefilter", "two-pass"], 2, None, "two-pass"),
    "partitions2": (["--partitions", "2"], 5, tck.Stage1PartitionCursor,
                    "plain"),
    "devices2": (["--devices", "2"], 2, tck.Stage1ShardedCheckpoint,
                 "plain"),
}


@pytest.mark.parametrize("case", sorted(STAGE1_CASES))
def test_stage1_kill_resume_equals_jax_build(jax_dbs, tmp_path, case):
    extra, batch, art, ref = STAGE1_CASES[case]
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "db.jf")
    argv = CDB + CPU + extra + ["-o", out, "--checkpoint-dir", ck,
                                "--checkpoint-every", "1"]
    assert tcdb_cli.main(argv + ["--fault-plan",
                                 _plan("stage1.insert", batch), READS]) == 1
    assert not os.path.exists(out)
    if art is not None:
        assert art(ck).cursor() == (1 if art is tck.Stage1PartitionCursor
                                    else batch)
    else:
        assert os.path.exists(os.path.join(ck, "stage1.sketch.ckpt"))
    m = str(tmp_path / "m.json")
    assert tcdb_cli.main(argv + ["--resume", "--fault-plan", "",
                                 "--metrics", m, READS]) == 0
    assert tdb.db_payload_bytes(out) == jdb.db_payload_bytes(jax_dbs[ref])
    # a finished build leaves no checkpoint behind
    assert [f for f in os.listdir(ck) if not f.startswith("replay")] == []
    doc = json.load(open(m))
    if case in ("single", "devices2"):
        assert doc["meta"]["resumed"] is True
        assert doc["meta"]["resumed_from_batch"] == batch
        assert doc["counters"]["resume_skipped_reads"] == 64 * batch
        assert doc["counters"]["reads"] == 242
        assert doc["counters"]["checkpoint_writes_total"] == 4 - batch


@pytest.mark.parametrize("argv,want", [
    (["-m", "15"], "k="),
    (["--batch-size", "32"], "batch_size="),
    (["INPUTS"], "covers inputs"),
])
def test_stage1_resume_refuses_a_mismatch(tmp_path, capsys, argv, want):
    ck = str(tmp_path / "ck")
    base = CDB + CPU + ["--checkpoint-dir", ck, "--checkpoint-every", "1",
                        "-o", str(tmp_path / "db.jf")]
    assert tcdb_cli.main(base + ["--fault-plan", _plan("stage1.insert", 2),
                                 READS]) == 1
    capsys.readouterr()
    reads = [READS]
    if argv == ["INPUTS"]:
        other = tmp_path / "other.fastq"
        other.write_bytes(open(READS, "rb").read())
        argv, reads = [], [str(other)]
    rc = tcdb_cli.main(base + argv + ["--resume", "--fault-plan", ""] + reads)
    assert rc == tck.NON_RETRYABLE_RC
    assert want in capsys.readouterr().err


@pytest.mark.parametrize("damage", ["payload", "header", "truncate"])
def test_stage1_damaged_snapshot_refused(tmp_path, damage):
    ck = str(tmp_path / "ck")
    argv = CDB + CPU + ["--checkpoint-dir", ck, "--checkpoint-every", "1",
                        "-o", str(tmp_path / "db.jf")]
    assert tcdb_cli.main(argv + ["--fault-plan", _plan("stage1.insert", 2),
                                 READS]) == 1
    path = tck.Stage1Checkpoint(ck).path
    data = bytearray(open(path, "rb").read())
    hlen = data.index(b"\n") + 1
    if damage == "payload":
        data[hlen + 100] ^= 0xFF
    elif damage == "header":
        data[data.index(b'"cursor": 2') + 10] = ord("1")
    else:
        del data[-4096:]
    open(path, "wb").write(bytes(data))
    rc = tcdb_cli.main(argv + ["--resume", "--fault-plan", "", READS])
    assert rc == tck.NON_RETRYABLE_RC


def test_inline_prefilter_does_not_checkpoint(tmp_path, capsys):
    assert tcdb_cli.main(CDB + CPU + ["--prefilter", "inline",
                                      "--checkpoint-dir", str(tmp_path),
                                      "-o", str(tmp_path / "db.jf"),
                                      READS]) == 1
    assert "nor --checkpoint-dir" in capsys.readouterr().err


# ------------------------------------------------ stage 2: kill, resume


@pytest.fixture(scope="module")
def golden_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_db")
    db = str(d / "db.jf")
    assert tcdb_cli.main(CDB + CPU + ["-o", db, READS]) == 0
    return db


@pytest.mark.parametrize("workers", ["0", "1"])
def test_stage2_kill_resume_equals_golden(golden_db, tmp_path, workers):
    out = str(tmp_path / "out")
    argv = EC + CPU + ["--render-workers", workers, "--checkpoint-every",
                       "1", "-o", out, golden_db, READS]
    assert tec_cli.main(["--fault-plan", _plan("stage2.correct", 2)]
                        + argv) == 1
    j = tck.Stage2Journal(out)
    assert j.batches_done() == 2
    assert os.path.exists(out + ".fa.partial")
    assert not os.path.exists(out + ".fa")
    m = str(tmp_path / "m.json")
    assert tec_cli.main(["--resume", "--fault-plan", "", "--metrics", m]
                        + argv) == 0
    assert _same(out + ".fa", os.path.join(GOLDEN, "expected.fa"))
    assert _same(out + ".log", os.path.join(GOLDEN, "expected.log"))
    assert not os.path.exists(j.path) and not os.path.exists(j.fa_partial)
    doc = json.load(open(m))
    assert doc["meta"]["resumed"] is True
    assert doc["counters"]["resume_skipped_reads"] == 128
    assert doc["counters"]["reads_in"] == 242


def test_stage2_resume_truncates_a_torn_tail(golden_db, tmp_path):
    out = str(tmp_path / "out")
    argv = EC + CPU + ["--checkpoint-every", "2", "-o", out, golden_db,
                       READS]
    assert tec_cli.main(["--fault-plan", _plan("stage2.correct", 3)]
                        + argv) == 1
    with open(out + ".fa.partial", "ab") as f:
        f.write(b">torn record past the commit\nACG")
    assert tec_cli.main(["--resume", "--fault-plan", ""] + argv) == 0
    assert _same(out + ".fa", os.path.join(GOLDEN, "expected.fa"))


@pytest.mark.parametrize("change,want", [
    (["--batch-size", "32"], "batch_size="),
    (["-p", "5"], "config="),
    (["DB"], "db="),
])
def test_stage2_resume_refuses_a_mismatch(golden_db, tmp_path, capsys,
                                          change, want):
    out = str(tmp_path / "out")
    db = golden_db
    base = ["--checkpoint-every", "1", "-o", out] + CPU
    assert tec_cli.main(EC + base + ["--fault-plan",
                                     _plan("stage2.correct", 2), db,
                                     READS]) == 1
    capsys.readouterr()
    argv = EC + change
    if change == ["DB"]:
        db = str(tmp_path / "copy.jf")
        open(db, "wb").write(open(golden_db, "rb").read())
        argv = EC
    rc = tec_cli.main(argv + base + ["--resume", "--fault-plan", "", db,
                                     READS])
    assert rc == tck.NON_RETRYABLE_RC
    assert want in capsys.readouterr().err


def test_stage2_damaged_partial_refused(golden_db, tmp_path):
    out = str(tmp_path / "out")
    argv = EC + CPU + ["--checkpoint-every", "1", "-o", out, golden_db,
                       READS]
    assert tec_cli.main(["--fault-plan", _plan("stage2.correct", 2)]
                        + argv) == 1
    data = bytearray(open(out + ".fa.partial", "rb").read())
    data[10] ^= 0x20
    open(out + ".fa.partial", "wb").write(bytes(data))
    assert tec_cli.main(["--resume", "--fault-plan", ""] + argv) == \
        tck.NON_RETRYABLE_RC


@pytest.mark.parametrize("argv", [[], ["--gzip", "-o", "{d}/z"]])
def test_stage2_checkpoint_flag_validation(golden_db, tmp_path, argv):
    argv = [a.format(d=tmp_path) for a in argv]
    assert tec_cli.main(EC + CPU + ["--checkpoint-every", "1"] + argv
                        + [golden_db, READS]) == 1


@pytest.mark.parametrize("cfg", [
    dict(k=13, cutoff=4),
    dict(k=13, cutoff=4, trim_contaminant=True, homo_trim=6),
])
def test_journal_identity_is_jax_repr(cfg):
    assert jax_repr(ECConfig(**cfg)) == repr(JECConfig(**cfg))


# ------------------------------------------------ cross-package resumes


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stage1_snapshot_resumed_by_the_other_package(jax_dbs, tmp_path,
                                                      writer):
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "db.jf")
    argv = CDB + ["-o", out, "--checkpoint-dir", ck, "--checkpoint-every",
                  "1"]
    kill = ["--fault-plan", _plan("stage1.insert", 2)]
    resume = ["--resume", "--fault-plan", ""]
    if writer == "jax":
        assert jcdb_cli.main(argv + kill + [READS]) == 1
        assert tcdb_cli.main(argv + CPU + resume + [READS]) == 0
    else:
        assert tcdb_cli.main(argv + CPU + kill + [READS]) == 1
        assert jcdb_cli.main(argv + resume + [READS]) == 0
    assert tdb.db_payload_bytes(out) == jdb.db_payload_bytes(
        jax_dbs["plain"])


def test_stage1_snapshot_bits_equal_jax_layout(tmp_path):
    """The port's snapshot is JAX's format: JAX's loader reads it, and
    the planes are the port's build table's bits."""
    ck = str(tmp_path / "ck")
    assert tcdb_cli.main(CDB + CPU + ["-o", str(tmp_path / "db.jf"),
                                      "--checkpoint-dir", ck,
                                      "--checkpoint-every", "1",
                                      "--fault-plan",
                                      _plan("stage1.insert", 1),
                                      READS]) == 1
    j = jck.Stage1Checkpoint(ck).load()
    t = tck.Stage1Checkpoint(ck).load()
    assert j.header == t.header and j.header["format"] == tck.STAGE1_FORMAT
    for a, b in ((j.tag, t.tag), (j.hq, t.hq), (j.lq, t.lq)):
        assert a.dtype == b.dtype == np.uint32
        assert np.array_equal(a, b)
    bs = t.build_state("cpu")
    assert bs.tag.dtype == torch.int32
    assert np.array_equal(bs.tag.numpy().view(np.uint32), t.tag)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stage2_journal_resumed_by_the_other_package(golden_db, tmp_path,
                                                     writer):
    out = str(tmp_path / "out")
    argv = EC + ["--checkpoint-every", "1", "-o", out, golden_db, READS]
    kill = ["--fault-plan", _plan("stage2.correct", 2)]
    resume = ["--resume", "--fault-plan", ""]
    if writer == "jax":
        assert jec_cli.main(kill + argv) == 1
        assert tec_cli.main(resume + CPU + argv) == 0
    else:
        assert tec_cli.main(kill + CPU + argv) == 1
        assert jec_cli.main(resume + argv) == 0
    assert _same(out + ".fa", os.path.join(GOLDEN, "expected.fa"))
    assert _same(out + ".log", os.path.join(GOLDEN, "expected.log"))


# ------------------------------------------------ the driver


def test_replay_cache_is_jax_format(tmp_path):
    """A capture either package writes, the other replays."""
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=(8, 20)).astype(np.int8)
    quals = rng.integers(40, 70, size=codes.shape).astype(np.uint8)
    lengths = np.full((8,), 20, np.int32)
    ident = {"inputs": ["x.fastq"], "batch_size": 8, "qual_cutoff": 64,
             "on_bad_read": "abort"}
    headers = [f"r{i}" for i in range(8)]
    tpk = tpacking.pack_reads(codes, quals, lengths, thresholds=(64,))
    jpk = jpacking.pack_reads(codes, quals, lengths,
                              thresholds=(64,)).compact()
    for wmod, rmod, batch, pk in (
            (tck, jck, tfastq.ReadBatch(codes, None, lengths, headers, 8),
             tpk),
            (jck, tck, jfastq.ReadBatch(codes, None, lengths, headers, 8),
             jpk)):
        d = str(tmp_path / wmod.__name__.split(".")[0])
        w = wmod.ReplayCache(d).start(ident, 1 << 30)
        w.add(batch, pk)
        assert wmod.ReplayCache(d).load(ident) is None  # not committed
        assert w.finish()
        rd = rmod.ReplayCache(d).load(ident)
        (b2, pk2), = list(rd.batches())
        assert np.array_equal(b2.codes, codes) and b2.headers == headers
        assert np.array_equal(pk2.to_wire(), tpk.to_wire())
        assert pk2.n_reads == 8 and 64 in pk2.hq
        assert rmod.ReplayCache(d).load(dict(ident, batch_size=16)) is None
    # over budget: the capture aborts and removes itself
    w = tck.ReplayCache(str(tmp_path / "cap")).start(ident, 1)
    w.add(tfastq.ReadBatch(codes, None, lengths, headers, 8), tpk)
    assert not w.finish()
    assert tck.ReplayCache(str(tmp_path / "cap")).load(ident) is None


def test_driver_resume_replays_without_reparse(tmp_path, monkeypatch):
    """Kill the driver's stage 2, resume: stage 1's database is reused
    and the reads replay from the capture, with no FASTQ parse."""
    from quorum_tpu_torch.models import create_database as tcdb
    from quorum_tpu_torch.models import error_correct as tec

    prefix = str(tmp_path / "qc")
    ck = str(tmp_path / "ck")
    args = ["-s", "64k", "-k", "13", "-p", prefix, "--batch-size", "64",
            "--checkpoint-dir", ck, "--checkpoint-every", "1"] + CPU
    assert tquorum.main(args + ["--fault-plan", _plan("stage2.correct", 2),
                                READS]) == 1
    assert tck.ReplayCache(ck).manifest() is not None

    def no_parse(*a, **kw):  # pragma: no cover - the guard
        raise AssertionError("the resumed driver parsed the FASTQ")

    for mod in (tquorum, tcdb, tec):
        monkeypatch.setattr(mod.fastq, "read_batches", no_parse)
    m = str(tmp_path / "m.json")
    assert tquorum.main(args + ["--resume", "--fault-plan", "", "--metrics",
                                m, READS]) == 0
    assert _same(prefix + ".fa", os.path.join(GOLDEN, "expected_auto.fa"))
    assert _same(prefix + ".log", os.path.join(GOLDEN, "expected_auto.log"))
    doc = json.load(open(m))
    assert doc["meta"]["stage1_resumed_db"] == prefix + "_mer_database.jf"
    assert doc["meta"]["replay_cache_resumed"] is True
    assert not os.path.exists(os.path.join(ck, "replay"))


def test_driver_resume_rebuilds_a_damaged_database(tmp_path, capsys):
    prefix = str(tmp_path / "qc")
    args = ["-s", "64k", "-k", "13", "-p", prefix, "--batch-size", "64",
            "--checkpoint-dir", str(tmp_path / "ck")] + CPU
    assert tquorum.main(args + ["--fault-plan", _plan("stage2.correct", 0),
                                READS]) == 1
    db = prefix + "_mer_database.jf"
    data = bytearray(open(db, "rb").read())
    data[data.index(b"\n") + 40] ^= 0xFF
    open(db, "wb").write(bytes(data))
    capsys.readouterr()
    assert tquorum.main(args + ["--resume", "--fault-plan", "", READS]) == 0
    assert "failed verification" in capsys.readouterr().err
    assert _same(prefix + ".fa", os.path.join(GOLDEN, "expected_auto.fa"))


# ------------------------------------------------ one real kill


def test_hard_exit_kill_then_resume(golden_db, tmp_path):
    """A real process kill (os._exit at stage 2's batch 2, from a plan in
    QUORUM_FAULT_PLAN), then --resume: the golden bytes."""
    out = str(tmp_path / "out")
    # one torch thread, as in this process (many small ops)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("QUORUM_FAULT_PLAN", None)
    ec = [sys.executable, "-m", "quorum_tpu_torch.cli.error_correct_reads"]
    run = dict(cwd=str(tmp_path), capture_output=True, text=True,
               timeout=300)
    argv = EC + CPU + ["--checkpoint-every", "1", "-o", out, golden_db,
                       READS]
    killed = subprocess.run(
        ec + argv, env=dict(env, QUORUM_FAULT_PLAN=json.dumps(
            [{"site": "stage2.correct", "batch": 2, "action": "exit"}])),
        **run)
    assert killed.returncode == tfaults.DEFAULT_EXIT_CODE
    assert "hard exit (41) at stage2.correct@batch=2" in killed.stderr
    assert tck.Stage2Journal(out).batches_done() == 2
    assert subprocess.run(ec + argv + ["--resume"], env=env,
                          **run).returncode == 0
    assert _same(out + ".fa", os.path.join(GOLDEN, "expected.fa"))
    assert _same(out + ".log", os.path.join(GOLDEN, "expected.log"))


# ------------------------------------------------ the artifacts themselves


class _Stats:
    reads = corrected = skipped = bases_in = bases_out = 0


def _flip(path, offset):
    data = bytearray(open(path, "rb").read())
    data[offset] ^= 0xFF
    open(path, "wb").write(bytes(data))


PACKAGES = pytest.mark.parametrize("ck", [jck, tck], ids=["jax", "port"])


@PACKAGES
def test_journal_committed_range_digest(ck, tmp_path):
    """A torn tail truncates away; a flipped byte inside the committed
    range refuses; a tampered journal fails its seal."""
    j = ck.Stage2Journal(str(tmp_path / "out"))
    out, log = j.open_outputs(None)
    out.write("the committed record\n")
    out.flush()
    j.commit(1, _Stats(), out.tell(), log.tell(), 64, {"db": "a"})
    out.write("torn tail past the commit")
    out.close()
    log.close()
    st = j.load()
    out2, log2 = j.open_outputs(st)
    out2.close()
    log2.close()
    assert open(j.fa_partial).read() == "the committed record\n"
    _flip(j.fa_partial, 4)
    with pytest.raises(ck.CheckpointError, match="committed"):
        j.open_outputs(st)
    doc = json.load(open(j.path))
    doc["fa_bytes"] = 999
    json.dump(doc, open(j.path, "w"))
    with pytest.raises(ck.CheckpointError, match="self-digest"):
        j.load()


@PACKAGES
def test_journal_resume_from_pre_digest_journal(ck, tmp_path):
    """A journal without digests (an old JAX release's) resumes,
    commits, and resumes again: the streams seed from the file."""
    prefix = str(tmp_path / "out")
    j = ck.Stage2Journal(prefix)
    out, log = j.open_outputs(None)
    out.write("first half\n")
    j.commit(1, _Stats(), out.tell(), log.tell(), 64)
    out.close()
    log.close()
    doc = json.load(open(j.path))
    for key in ("fa_crc32c", "log_crc32c", "crc32c"):
        doc.pop(key, None)
    json.dump(doc, open(j.path, "w"))
    for n, text in ((2, "second half\n"), (3, "")):
        jn = ck.Stage2Journal(prefix)
        out, log = jn.open_outputs(jn.load())
        out.write(text)
        jn.commit(n, _Stats(), out.tell(), log.tell(), 64)
        out.close()
        log.close()
    assert open(j.fa_partial).read() == "first half\nsecond half\n"


def test_replay_cache_batch_digest(tmp_path):
    cache = tck.ReplayCache(str(tmp_path))
    ident = {"inputs": ["r.fastq"], "batch_size": 4}
    codes = np.zeros((4, 20), np.int8)
    lengths = np.full(4, 20, np.int32)
    pk = tpacking.pack_reads(codes, np.full((4, 20), 60, np.uint8), lengths,
                             thresholds=(38,))
    w = cache.start(ident, cap_bytes=1 << 30)
    w.add(tfastq.ReadBatch(codes, None, lengths, list("abcd"), 4), pk)
    assert w.finish()
    assert len(list(cache.load(ident).batches())) == 1
    _flip(cache._batch_path(0), 100)
    with pytest.raises(tck.CheckpointError, match="digest"):
        list(cache.load(ident).batches())
    doc = json.load(open(cache.manifest_path))
    doc["n_batches"] = 2
    json.dump(doc, open(cache.manifest_path, "w"))
    with pytest.raises(tck.CheckpointError, match="self-digest"):
        cache.load(ident)


def test_sharded_checkpoint_consistency(tmp_path):
    """Per-shard snapshots under one manifest round-trip; a second save
    keeps one generation; a truncated or missing shard refuses."""
    from quorum_tpu_torch.models.create_database import (BuildConfig,
                                                          BuildStats)
    from quorum_tpu_torch.parallel import tile_sharded as ts

    mesh = ["cpu", "cpu"]
    meta = ts.TileShardedMeta(k=13, bits=7, rb_log2=6, n_shards=2)
    bstate = ts.make_build_state(meta, mesh)
    bstate.shards[1].tag[3, :4] = torch.tensor([5, 6, 7, 8],
                                               dtype=torch.int32)
    cfg = BuildConfig(k=13, qual_thresh=53, batch_size=64, devices=2)
    stats = BuildStats(reads=10, bases=480, batches=3)
    ck = tck.Stage1ShardedCheckpoint(str(tmp_path))
    ck.save(bstate, meta, cfg, 3, stats, ["a.fastq"])
    snap = ck.load()
    assert snap.cursor == 3 and snap.n_shards == 2
    back = snap.build_state(mesh)
    for a, b in zip(back.shards, bstate.shards):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    snap.check_config(13, 7, 53, 64, ["a.fastq"], 2)
    with pytest.raises(tck.CheckpointError, match="n_shards"):
        snap.check_config(13, 7, 53, 64, ["a.fastq"], 4)
    ck.save(bstate, meta, cfg, 4, stats, ["a.fastq"])
    assert ck.load().cursor == 4
    shards = sorted(p for p in os.listdir(tmp_path)
                    if p.startswith("stage1.shard") and p.endswith(".ckpt"))
    assert len(shards) == 2
    victim = os.path.join(tmp_path, shards[0])
    open(victim, "wb").write(open(victim, "rb").read()[:-4])
    with pytest.raises(tck.CheckpointError, match="corrupt"):
        ck.load()
    os.remove(victim)
    with pytest.raises(tck.CheckpointError, match="missing"):
        ck.load()
    ck.clear()
    assert ck.load() is None


def test_sharded_resume_batch_index_is_global(tmp_path):
    """A resumed sharded build numbers its batches from the cursor: a
    plan pinned to batch 1 fires again on the resume."""
    ck = str(tmp_path / "ck")
    plan = json.dumps([{"site": "stage1.insert", "batch": 1, "count": -1,
                        "action": "error"}])
    argv = CDB + CPU + ["--devices", "2", "-o", str(tmp_path / "g.jf"),
                        "--checkpoint-dir", ck, "--checkpoint-every", "1",
                        "--fault-plan", plan]
    assert tcdb_cli.main(argv + [READS]) == 1
    assert tck.Stage1ShardedCheckpoint(ck).cursor() == 1
    assert tcdb_cli.main(argv + ["--resume", READS]) == 1
    assert tck.Stage1ShardedCheckpoint(ck).cursor() == 1


def test_partition_kill_resume_reruns_only_torn(jax_dbs, tmp_path):
    """A kill after the second partition's cursor commit; the resume runs
    only partitions 2 and 3, restores every partition's gauge, and gives
    the single-pass payload."""
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "db.jf")
    m = str(tmp_path / "m.json")
    argv = CDB + CPU + ["--partitions", "4", "-o", out, "--checkpoint-dir",
                        ck, "--metrics", m]
    plan = json.dumps([{"site": "partition.commit", "at": 2,
                        "action": "error"}])
    assert tcdb_cli.main(argv + ["--fault-plan", plan, READS]) == 1
    cur = json.load(open(os.path.join(ck, "stage1.partitions.json")))
    assert [r["shard"] for r in cur["completed"]] == [0, 1]
    assert tcdb_cli.main(argv + ["--resume", "--fault-plan", "",
                                 READS]) == 0
    assert tdb.db_payload_bytes(out) == jdb.db_payload_bytes(
        jax_dbs["plain"])
    doc = json.load(open(m))
    assert doc["counters"]["partition_passes_total"] == 2
    for p in range(4):
        assert f'partition_distinct{{partition="{p}"}}' in doc["gauges"]
    assert not os.path.exists(os.path.join(ck, "stage1.partitions.json"))
