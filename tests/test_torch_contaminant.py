"""The port's contaminant and homo-trim path against the JAX package, on
the CPU (the kernels' plain versions): the contaminant loaders give the
same membership for every file kind, refuse a k mismatch with the same
message, the adapter data are the same, correct_batch with a contaminant
gives the same BatchResult (the JAX plain loop, event_driven=False,
which the oracle pins) and finish_batch with --homo-trim renders the
same reads (the CLIs: test_torch_contaminant_cli.py). Integer work:
every comparison is exact."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu import data as jdata
from quorum_tpu.io import contaminant as jcontam
from quorum_tpu.io import fastq as jfastq
from quorum_tpu.io import jf_binary as jjf
from quorum_tpu.io import packing as jpacking
from quorum_tpu.io import quorum_db as jqdb
from quorum_tpu.models import corrector as jcorr
from quorum_tpu.models import create_database as jcdb
from quorum_tpu.models.ec_config import ECConfig as JECConfig
from quorum_tpu.ops import ctable as jctable
from quorum_tpu.ops import mer as jmer
from quorum_tpu_torch import data as tdata
from quorum_tpu_torch import kernels
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.io import contaminant as tcontam
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.io import quorum_db as tqdb
from quorum_tpu_torch.models import corrector as tcorr
from quorum_tpu_torch.models.ec_config import ECConfig as TECConfig
from quorum_tpu_torch.ops import mer as tmer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLDEN, "reads.fastq")
K = 13
KINDS = ("fasta", "db", "ref", "jf")


def _same(a, b):
    return filecmp.cmp(a, b, shallow=False)


def _canonical(codes, k):
    """Every valid window's canonical mer of int8 codes [B, L] (int64)."""
    f, r, valid = tmer.rolling_kmers(torch.from_numpy(codes), k)
    return tmer.canonical(f, r)[valid]


def _split(keys):
    k = keys.numpy().astype(np.uint64)
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden reads' batch, their stage-1 table built by the JAX
    package (k = 13) and carried into the port, and a contaminant FASTA
    of two 2k-base windows of golden reads (as test_ec_cli_contaminant)
    with the same set in every other file kind."""
    d = tmp_path_factory.mktemp("contam")
    batches = [(b, jpacking.pack_reads(b.codes, b.quals, b.lengths,
                                       thresholds=(38,)))
               for b in jfastq.read_batches([READS], 256)]
    cfg = jcdb.BuildConfig(k=K, bits=7, qual_thresh=38, initial_size=64000,
                           batch_size=256)
    jstate, jmeta, _stats = jcdb.build_database([], cfg, batches=batches)
    tstate, tmeta = tdb.tile_state_from_numpy(
        np.asarray(jstate.rows), jmeta.k, jmeta.bits, jmeta.rb_log2, "cpu")
    g = batches[0][0]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = [acgt[g.codes[i, :g.lengths[i]]].tobytes().decode()
            for i in (3, 40)]
    windows = [seqs[0][10:10 + 2 * K], seqs[1][20:20 + 2 * K]]
    fa = str(d / "adapter.fa")
    with open(fa, "w") as f:
        f.write("".join(f">a{i}\n{w}\n" for i, w in enumerate(windows)))
    wc = np.full((2, 2 * K), -2, np.int8)
    for i, w in enumerate(windows):
        wc[i] = [{"A": 0, "C": 1, "G": 2, "T": 3}[c] for c in w]
    ckeys = torch.unique(_canonical(wc, K))
    khi, klo = _split(ckeys)
    files = {"fasta": fa, "db": str(d / "contam.jf"),
             "ref": str(d / "contam.qdb"), "jf": str(d / "contam.bin")}
    assert tcdb_cli.main(["-s", "1k", "-m", str(K), "-b", "7", "-q", "0",
                          "-o", files["db"], "--device", "cpu", fa]) == 0
    jqdb.write_ref_db(files["ref"], khi, klo,
                      np.full(len(khi), 2, np.uint32), K, 7)
    jjf.write_jf_binary(files["jf"], khi, klo,
                        np.ones(len(khi), np.uint64), K)
    probe = torch.unique(torch.cat([_canonical(g.codes[:g.n], K), ckeys]))
    return dict(dir=d, jstate=jstate, jmeta=jmeta, tstate=tstate,
                tmeta=tmeta, g=g, files=files, probe=probe,
                n_contam=ckeys.numel())


# ----------------------------------------------------------- loaders


def _jax_member(state, meta, keys):
    khi, klo = _split(keys)
    v = jctable.tile_lookup(state, meta, jnp.asarray(khi), jnp.asarray(klo))
    return np.asarray(v) != 0


@pytest.mark.parametrize("kind", KINDS)
def test_loaders_agree_on_membership(golden, kind):
    path = golden["files"][kind]
    tstate, tmeta = tcontam.load_contaminant(path, K, "cpu")
    jstate, jmeta = jcontam.load_contaminant(path, K)
    probe = golden["probe"]
    got = kernels.tile_lookup(tstate.rows, tmeta, probe).numpy() != 0
    want = _jax_member(jstate, jmeta, probe)
    assert np.array_equal(got, want)
    assert int(got.sum()) == golden["n_contam"]


@pytest.mark.parametrize("kind", ["db", "ref", "jf", "batch"])
def test_k_mismatch_message_matches_jax(golden, kind):
    if kind == "batch":
        # a FASTA set at another k, handed to correct_batch
        g = golden["g"]
        cs, cm = tcontam.load_contaminant(golden["files"]["fasta"], K - 2,
                                          "cpu")
        js, jm = jcontam.load_contaminant(golden["files"]["fasta"], K - 2)
        args = (g.codes[:4], g.quals[:4], g.lengths[:4])
        with pytest.raises(ValueError) as te:
            tcorr.correct_batch(golden["tstate"], golden["tmeta"], *args,
                                TECConfig(k=K, cutoff=4), contam=(cs, cm))
        with pytest.raises(ValueError) as je:
            jcorr.correct_batch(golden["jstate"], golden["jmeta"], *args,
                                JECConfig(k=K, cutoff=4), contam=(js, jm))
    else:
        path = golden["files"][kind]
        with pytest.raises(ValueError) as te:
            tcontam.load_contaminant(path, K + 2, "cpu")
        with pytest.raises(ValueError) as je:
            jcontam.load_contaminant(path, K + 2)
    assert str(te.value) == str(je.value)
    assert "different than correction mer length" in str(te.value)


def test_ref_db_truncation_is_reported(golden, tmp_path):
    src = golden["files"]["ref"]
    bad = str(tmp_path / "short.qdb")
    data = open(src, "rb").read()
    open(bad, "wb").write(data[:-8])
    assert tqdb.verify_ref_db(src) == []
    (section, _off, msg), = tqdb.verify_ref_db(bad)
    assert section == "payload" and "truncated" in msg
    assert jqdb.verify_ref_db(bad)[0][0] == section


def test_adapter_data_match_jax(tmp_path):
    assert list(tdata.adapter_records()) == list(jdata.adapter_records())
    a, b = str(tmp_path / "t.fa"), str(tmp_path / "j.fa")
    assert tdata.adapter_fasta(a) == a
    jdata.adapter_fasta(b)
    assert _same(a, b)


# ----------------------------------------------------------- batches


def _compare(jres, tres, n):
    """Every BatchResult field: status, start, end for every read, out
    inside [start, end) for corrected reads, each log's n and its first
    n entries."""
    status = np.asarray(jres.status)[:n]
    assert np.array_equal(tres.status.numpy()[:n], status)
    assert np.array_equal(tres.start.numpy()[:n], np.asarray(jres.start)[:n])
    assert np.array_equal(tres.end.numpy()[:n], np.asarray(jres.end)[:n])
    jout, tout = np.asarray(jres.out), tres.out.numpy()
    start, end = np.asarray(jres.start), np.asarray(jres.end)
    for i in np.nonzero(status == 0)[0]:
        assert np.array_equal(tout[i, start[i]:end[i]],
                              jout[i, start[i]:end[i]]), i
    for jl, tl in ((jres.fwd_log, tres.fwd_log), (jres.bwd_log, tres.bwd_log)):
        jn = np.asarray(jl.n)[:n]
        assert np.array_equal(tl.n.numpy()[:n], jn)
        jp, jm = np.asarray(jl.pos), np.asarray(jl.meta)
        for i in np.nonzero(jn)[0]:
            assert np.array_equal(tl.pos.numpy()[i, :jn[i]], jp[i, :jn[i]])
            assert np.array_equal(tl.meta.numpy()[i, :jn[i]], jm[i, :jn[i]])


def _dict_table(seqs, k, cnt):
    """(JAX table, port table) holding every canonical k-mer of `seqs`
    with count `cnt` and the hq bit (test_corrector.table_from_dict)."""
    keys = set()
    for s in seqs:
        for i in range(len(s) - k + 1):
            hi, lo = jmer.pack_kmer(s[i:i + k], k)
            keys.add(jmer.canonical_py(hi, lo, k))
    khi = np.array([h for h, _l in sorted(keys)], np.uint32)
    klo = np.array([lo for _h, lo in sorted(keys)], np.uint32)
    js, jm = jctable.tile_from_entries(
        khi, klo, np.full(len(khi), (cnt << 1) | 1, np.uint32), k, 7)
    ts, tm = tdb.tile_state_from_numpy(np.asarray(js.rows), jm.k, jm.bits,
                                       jm.rb_log2, "cpu")
    return (js, jm), (ts, tm)


def _codes(reads, quals):
    b, l = len(reads), max(len(r) for r in reads)
    codes = np.full((b, l), -2, np.int8)
    q = np.zeros((b, l), np.uint8)
    for i, (r, qq) in enumerate(zip(reads, quals)):
        codes[i, :len(r)] = [{"A": 0, "C": 1, "G": 2, "T": 3}.get(c, -1)
                             for c in r]
        q[i, :len(r)] = np.frombuffer(qq.encode(), np.uint8)
    return codes, q, np.array([len(r) for r in reads], np.int32)


def _rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _rand_quals(rng, n):
    return "".join(chr(c) for c in rng.integers(38, 74, n))


def _seeded_batch(seed):
    """Reads of a 300-base genome, 40% with 10 bases of a 20-base
    adapter inserted, some with an N or a substitution
    (test_corrector.test_contaminants); k = 9."""
    rng = np.random.default_rng(seed)
    g = _rand_seq(rng, 300)
    adapter = _rand_seq(rng, 20)
    reads, quals = [], []
    for _ in range(64):
        start = int(rng.integers(0, 260))
        r = list(g[start:start + min(300 - start, 35)])
        if rng.random() < 0.4:
            ins = int(rng.integers(0, len(r) - 5))
            r[ins:ins] = adapter[:10]
        if rng.random() < 0.3:
            r[int(rng.integers(0, len(r)))] = "ACGTN"[int(rng.integers(0, 5))]
        reads.append("".join(r))
        quals.append(_rand_quals(rng, len(r)))
    return [g], [adapter], reads, quals


def _seeded_pair(seed, trim, event_driven):
    """The seeded batch through both packages' corrector in one mode."""
    genome, adapter, reads, quals = _seeded_batch(seed)
    (js, jm), (ts, tm) = _dict_table(genome, 9, 5)
    (jcs, jcm), (tcs, tcm) = _dict_table(adapter, 9, 1)
    codes, q, lengths = _codes(reads, quals)
    jres = jcorr.correct_batch(
        js, jm, codes, q, lengths,
        JECConfig(k=9, cutoff=8, trim_contaminant=trim),
        contam=(jcs, jcm), event_driven=event_driven)
    tres = tcorr.correct_batch(ts, tm, codes, q, lengths,
                               TECConfig(k=9, cutoff=8, trim_contaminant=trim),
                               contam=(tcs, tcm), event_driven=event_driven)
    return jres, tres, reads


@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("seed", [7, 8])
def test_seeded_batch_matches_jax(trim, seed):
    """The port's plain walk (event_driven=False) against JAX's plain
    loop."""
    jres, tres, reads = _seeded_pair(seed, trim, False)
    _compare(jres, tres, len(reads))
    status = tres.status.numpy()
    if trim:
        assert not (status == tcorr.ST_CONTAMINANT).any()
        trunc = [(m & 1).any() for m in tres.fwd_log.meta.numpy()]
        assert any(trunc)
    else:
        assert (status == tcorr.ST_CONTAMINANT).any()
        assert (status == 0).any()


@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("seed", [7, 8])
def test_seeded_batch_event_mode_matches_jax(trim, seed):
    """The port's default, event mode (HK16's and HK4's contaminant
    entries as plain versions), against JAX's event mode."""
    jres, tres, reads = _seeded_pair(seed, trim, True)
    _compare(jres, tres, len(reads))


def _golden_pair(golden, trim, event_driven):
    g = golden["g"]
    jcs, jcm = jcontam.load_contaminant(golden["files"]["fasta"], K)
    tcs, tcm = tcontam.load_contaminant(golden["files"]["fasta"], K, "cpu")
    jres = jcorr.correct_batch(
        golden["jstate"], golden["jmeta"], g.codes, g.quals, g.lengths,
        JECConfig(k=K, cutoff=4, trim_contaminant=trim), contam=(jcs, jcm),
        event_driven=event_driven)
    tres = tcorr.correct_batch(
        golden["tstate"], golden["tmeta"], g.codes, g.quals, g.lengths,
        TECConfig(k=K, cutoff=4, trim_contaminant=trim), contam=(tcs, tcm),
        event_driven=event_driven)
    return jres, tres, g


@pytest.mark.parametrize("trim", [False, True])
def test_golden_batch_with_read_windows_matches_jax(golden, trim):
    jres, tres, g = _golden_pair(golden, trim, False)
    _compare(jres, tres, g.n)
    hit = (tres.status.numpy()[:g.n] == tcorr.ST_CONTAMINANT).sum()
    assert (hit == 0) if trim else (hit >= 2)


@pytest.mark.parametrize("trim", [False, True])
def test_golden_batch_with_read_windows_event_mode_matches_jax(golden, trim):
    jres, tres, g = _golden_pair(golden, trim, True)
    _compare(jres, tres, g.n)
    hit = (tres.status.numpy()[:g.n] == tcorr.ST_CONTAMINANT).sum()
    assert (hit == 0) if trim else (hit >= 2)


def _homo_case():
    rng = np.random.default_rng(11)
    g = _rand_seq(rng, 150) + "A" * 30 + _rand_seq(rng, 40)
    reads, quals = [], []
    for _ in range(48):
        start = int(rng.integers(0, 170))
        r = list(g[start:start + min(len(g) - start, 45)])
        if rng.random() < 0.5:
            r[int(rng.integers(0, len(r)))] = "ACGT"[int(rng.integers(0, 4))]
        reads.append("".join(r))
        quals.append(_rand_quals(rng, len(r)))
    return _dict_table([g], 9, 8), reads, quals


def _homo_pair(event_driven):
    ((js, jm), (ts, tm)), reads, quals = _homo_case()
    codes, q, lengths = _codes(reads, quals)
    jcfg = JECConfig(k=9, cutoff=30, homo_trim=3)
    tcfg = TECConfig(k=9, cutoff=30, homo_trim=3)
    jres = jcorr.correct_batch(js, jm, codes, q, lengths, jcfg,
                               event_driven=event_driven)
    tres = tcorr.correct_batch(ts, tm, codes, q, lengths, tcfg,
                               event_driven=event_driven)
    return jres, tres, reads, codes, jcfg, tcfg


def test_finish_with_homo_trim_matches_jax():
    """A genome with a 30-base poly-A run (test_corrector.test_homo_trim):
    JAX finish_batch's lean path against the port's on the same reads,
    homo-trim (threshold 3) and its force-truncate included (plain
    walks)."""
    jres, tres, reads, codes, jcfg, tcfg = _homo_pair(False)
    want = jcorr.finish_batch(jres, len(reads), jcfg, codes=codes)
    got = tcorr.finish_batch(tres, len(reads), codes, tcfg)
    for w, t in zip(want, got):
        assert (t.ok, t.error, t.seq, t.fwd_log, t.bwd_log) == \
            (w.ok, w.error, w.seq, w.fwd_log, w.bwd_log)
    untrimmed = tcorr.finish_batch(tres, len(reads), codes)
    assert any(a.seq != b.seq for a, b in zip(got, untrimmed))


def test_finish_with_homo_trim_event_mode_matches_jax():
    """The same reads in event mode, the default of both packages."""
    jres, tres, reads, codes, jcfg, tcfg = _homo_pair(True)
    want = jcorr.finish_batch(jres, len(reads), jcfg, codes=codes)
    got = tcorr.finish_batch(tres, len(reads), codes, tcfg)
    for w, t in zip(want, got):
        assert (t.ok, t.error, t.seq, t.fwd_log, t.bwd_log) == \
            (w.ok, w.error, w.seq, w.fwd_log, w.bwd_log)
