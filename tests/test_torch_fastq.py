"""The port's reader (quorum_tpu_torch/io/fastq.py and its native parser,
quorum_tpu_torch/native/) against the JAX package's, batch for batch:
headers, n, codes, quals, lengths and batching, for one and four
threads, through the native and the Python parser, over the span path,
two pooled files, gzip, FASTA, CRLF, a missing last newline, wrapped
records and a read longer than the native parser's first stride; the
bad-read policies keep the same survivors and write the same
quarantine bytes; the native library builds under
quorum_tpu_torch/_build/, and concurrently."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import gzip
import os
import shutil
import threading

import numpy as np
import pytest

from quorum_tpu.io import fastq as jfastq
from quorum_tpu.native import binding as jbinding
from quorum_tpu_torch.io import fastq as tfastq
from quorum_tpu_torch.native import binding as tbinding

GXX = shutil.which("g++") is not None
BASES = "ACGTN"
PORT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    tfastq.__file__)))


def _write_fastq(path, rng, n, minlen=40, maxlen=120, crlf=False,
                 trailing_newline=True, prefix="r"):
    with open(path, "w", newline="") as f:
        eol = "\r\n" if crlf else "\n"
        for i in range(n):
            m = int(rng.integers(minlen, maxlen))
            seq = "".join(BASES[c] for c in rng.integers(0, 5, m))
            qual = "".join(chr(int(c)) for c in rng.integers(33, 74, m))
            tail = eol if (trailing_newline or i < n - 1) else ""
            f.write(f"@{prefix}{i} extra{eol}{seq}{eol}+{eol}{qual}{tail}")


def _inputs(d, kind):
    """The files of input `kind` under directory d (seeded)."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    path = os.path.join(d, kind + ".fastq")
    if kind == "plain":
        _write_fastq(path, rng, 300)
    elif kind == "crlf":
        _write_fastq(path, rng, 200, crlf=True)
    elif kind == "no_newline":
        _write_fastq(path, rng, 150, trailing_newline=False)
    elif kind == "gzip":
        _write_fastq(path, rng, 200)
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
            g.write(f.read())
        path += ".gz"
    elif kind == "fasta":
        path = os.path.join(d, "r.fa")
        with open(path, "w") as f:
            for i in range(120):
                seq = "".join(BASES[c] for c in rng.integers(0, 5, 70))
                f.write(f">f{i} x\n{seq[:40]}\n{seq[40:]}\n")
    elif kind == "wrapped":
        with open(path, "w") as f:
            for i in range(120):
                seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 60))
                qual = "".join(chr(int(c)) for c in rng.integers(33, 74, 60))
                f.write(f"@w{i}\n{seq[:30]}\n{seq[30:]}\n+\n"
                        f"{qual[:30]}\n{qual[30:]}\n")
    elif kind == "oversized":
        with open(path, "w") as f:
            f.write("@short\nACGT\n+\nIIII\n")
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 6000))
            f.write(f"@long\n{seq}\n+\n{'I' * 6000}\n")
            f.write("@after\nACGTAC\n+\nIIIIII\n")
    elif kind == "two_files":
        second = os.path.join(d, "second.fastq")
        _write_fastq(path, rng, 100)
        _write_fastq(second, rng, 90, prefix="s")
        return [path, second]
    return [path]


KINDS = ("plain", "crlf", "no_newline", "gzip", "fasta", "wrapped",
         "oversized", "two_files")


@pytest.fixture(scope="module", autouse=True)
def private_jax_binding_cache(tmp_path_factory):
    """Build the JAX parser into this module's own directory.

    The JAX binding builds into one shared ~/.cache/quorum_tpu under a
    fixed temporary name, and keeps a failed build for the rest of the
    process. Test workers that build it at once on a cold cache race,
    and the losers see the native parser as missing. Pointing the cache
    at a private directory, with the memo reset, lets it build once
    here with nothing to race."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jbinding, "_CACHE", str(tmp_path_factory.mktemp("jaxlib")))
    mp.setattr(jbinding, "_TRIED", False)
    mp.setattr(jbinding, "_LIB", None)
    yield
    mp.undo()


@pytest.fixture(params=["native", "python"])
def parser(request, monkeypatch):
    """Both packages through the native parser, or both through Python."""
    if request.param == "native":
        if not GXX:
            pytest.skip("no g++: the native parser cannot build")
        assert jbinding.available() and tbinding.available()
    else:
        monkeypatch.setattr(jbinding, "available", lambda: False)
        monkeypatch.setattr(tbinding, "available", lambda: False)
    return request.param


def _same_batches(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.headers == y.headers
        assert x.n == y.n
        np.testing.assert_array_equal(x.codes, y.codes)
        np.testing.assert_array_equal(x.quals, y.quals)
        np.testing.assert_array_equal(x.lengths, y.lengths)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_read_batches_match_jax(tmp_path, parser, kind, threads):
    paths = _inputs(str(tmp_path), kind)
    native0 = dict(tbinding.STATS)
    got = list(tfastq.read_batches(paths, 64, threads=threads))
    want = list(jfastq.read_batches(paths, 64, threads=threads))
    _same_batches(got, want)
    assert sum(b.n for b in got) > 1
    strict = kind not in ("fasta", "wrapped")
    used_native = tbinding.STATS["batches"] > native0["batches"]
    assert used_native == (parser == "native" and strict)


@pytest.fixture()
def span_file(tmp_path, monkeypatch):
    """A FASTQ with '@'-leading quality bytes, large enough to split once
    both packages' span threshold is lowered."""
    monkeypatch.setattr(jfastq, "PARALLEL_SPAN_MIN_BYTES", 1024)
    monkeypatch.setattr(tfastq, "PARALLEL_SPAN_MIN_BYTES", 1024)
    rng = np.random.default_rng(11)
    path = tmp_path / "big.fastq"
    with open(path, "wb") as f:
        for i in range(400):
            m = int(rng.integers(30, 120))
            seq = bytes(b"ACGT"[c] for c in rng.integers(0, 4, m))
            qual = bytes(int(q) for q in rng.integers(33, 75, m))
            f.write(b"@r%d desc\n" % i + seq + b"\n+\n" + qual + b"\n")
    return str(path)


@pytest.mark.parametrize("threads", [2, 4])
def test_span_path_matches_jax(span_file, monkeypatch, threads):
    """Without the native parser, one file with threads > 1 parses in
    record-aligned spans: the same spans and batches as JAX's."""
    monkeypatch.setattr(jbinding, "available", lambda: False)
    monkeypatch.setattr(tbinding, "available", lambda: False)
    spans = tfastq._single_file_spans(span_file, threads)
    assert spans and len(spans) > 1
    assert spans == jfastq._single_file_spans(span_file, threads)
    used = []
    real = tfastq._iter_records_spans
    monkeypatch.setattr(tfastq, "_iter_records_spans",
                        lambda *a: used.append(1) or real(*a))
    got = list(tfastq.read_batches([span_file], 48, threads=threads))
    assert used
    _same_batches(got, list(jfastq.read_batches([span_file], 48,
                                                threads=threads)))
    _same_batches(got, list(tfastq.read_batches([span_file], 48)))


def test_span_probe_matches_jax_on_unsplittable(tmp_path, monkeypatch):
    monkeypatch.setattr(jfastq, "PARALLEL_SPAN_MIN_BYTES", 16)
    monkeypatch.setattr(tfastq, "PARALLEL_SPAN_MIN_BYTES", 16)
    for kind in ("fasta", "wrapped", "gzip"):
        (path,) = _inputs(str(tmp_path), kind)
        assert tfastq._single_file_spans(path, 4) is None
        assert jfastq._single_file_spans(path, 4) is None


def _damaged(d):
    """A FASTQ with a torn quality line, a junk line and a second torn
    record, mid-file."""
    rng = np.random.default_rng(5)
    path = os.path.join(d, "bad.fastq")
    _write_fastq(path, rng, 200)
    lines = open(path, "rb").read().split(b"\n")
    lines[4 * 60 + 3] = lines[4 * 60 + 3][:-3]
    lines.insert(4 * 120, b"garbage line")
    lines[4 * 150 + 4] = lines[4 * 150 + 4][:-1]
    with open(path, "wb") as f:
        f.write(b"\n".join(lines))
    return path


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("mode", ["skip", "quarantine"])
def test_bad_read_policy_matches_jax(tmp_path, mode, threads):
    path = _damaged(str(tmp_path))
    tq, jq = str(tmp_path / "port.q"), str(tmp_path / "jax.q")
    tpol = tfastq.BadReadPolicy(mode, tq if mode == "quarantine" else None)
    jpol = jfastq.BadReadPolicy(mode, jq if mode == "quarantine" else None)
    got = list(tfastq.read_batches([path, path], 64, threads=threads,
                                   policy=tpol))
    want = list(jfastq.read_batches([path, path], 64, threads=threads,
                                    policy=jpol))
    _same_batches(got, want)
    assert tpol.bad == jpol.bad >= 2
    if mode == "quarantine":
        got_q, want_q = open(tq, "rb").read(), open(jq, "rb").read()
        assert want_q
        if threads == 1:
            assert got_q == want_q
        else:
            # pooled files quarantine concurrently (in both packages):
            # the same lines, interleaved as the workers ran
            assert sorted(got_q.splitlines()) == sorted(want_q.splitlines())
    with pytest.raises(ValueError):
        list(tfastq.read_batches([path], 64, threads=threads))


def test_policy_refuses_bad_modes(tmp_path):
    with pytest.raises(ValueError):
        tfastq.BadReadPolicy("ignore")
    with pytest.raises(ValueError):
        tfastq.BadReadPolicy("quarantine")
    pol = tfastq.BadReadPolicy("quarantine", str(tmp_path / "q"))
    pol.close()
    pol.handle("x", ValueError("late"), [b"@late\n"])
    assert pol.bad == 1 and not os.path.exists(tmp_path / "q")


def test_abandoned_pooled_read_joins_its_workers(tmp_path):
    paths = _inputs(str(tmp_path), "two_files") * 3
    it = tfastq.read_batches(paths, 8, threads=3)
    next(it)
    it.close()
    assert not [t for t in threading.enumerate() if t.name == "parse"]


def test_pooled_reader_stress(tmp_path):
    """More parse workers than cores, switching threads every
    microsecond: every batch in file order, the native batch count
    exact (a lost update would break either)."""
    import sys
    paths = []
    for i in range(12):
        p = str(tmp_path / f"s{i}.fastq")
        _write_fastq(p, np.random.default_rng(i), 50 + i, prefix=f"f{i}_")
        paths.append(p)
    want = list(tfastq.read_batches(paths, 16))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = tbinding.STATS["batches"]
        got = list(tfastq.read_batches(paths, 16, threads=16))
        native = tbinding.STATS["batches"] - before
    finally:
        sys.setswitchinterval(old)
    _same_batches(got, want)
    assert native == (len(got) if tbinding.available() else 0)
    assert not [t for t in threading.enumerate() if t.name == "parse"]


@pytest.mark.skipif(not GXX, reason="no g++")
def test_native_library_lands_in_the_build_dir():
    assert tbinding.available()
    path = tbinding.library_path()
    assert os.path.exists(path)
    assert os.path.commonpath([path, PORT_ROOT]) == PORT_ROOT
    assert os.sep + "_build" + os.sep in path
    assert os.path.basename(os.path.dirname(path)).startswith("native-")


@pytest.mark.skipif(not GXX, reason="no g++")
def test_concurrent_builds_agree(tmp_path, monkeypatch):
    """Builders racing on one build directory each write a temporary
    name and rename it over the library: every one ends with a library
    that loads."""
    monkeypatch.setattr(tbinding, "BUILD_ROOT", str(tmp_path))
    out = []
    ts = [threading.Thread(target=lambda: out.append(tbinding._build()))
          for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(set(out)) == 1 and out[0].startswith(str(tmp_path))
    import ctypes
    ctypes.CDLL(out[0]).qt_parse  # noqa: B018
    leftovers = os.listdir(os.path.dirname(out[0]))
    assert leftovers == ["libqtfastq.so"]


@pytest.mark.skipif(not GXX, reason="no g++")
@pytest.mark.parametrize("case", ["lf", "crlf", "no_newline", "fasta",
                                  "gzip", "oversized"])
def test_binding_matches_jax_binding(tmp_path, case):
    """tests/test_native_fastq.py's cases, through both bindings."""
    rng = np.random.default_rng(1)
    path = str(tmp_path / "r.fastq")
    bs = 256
    if case in ("lf", "crlf", "no_newline"):
        _write_fastq(path, rng, 1000, crlf=case == "crlf",
                     trailing_newline=case != "no_newline")
    elif case == "fasta":
        path = str(tmp_path / "r.fa")
        with open(path, "w") as f:
            f.write(">a\nACGTACGTACGT\nACGT\n>b\nTTTT\n")
        bs = 8
    elif case == "gzip":
        _write_fastq(path, rng, 100)
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
            g.write(f.read())
        path += ".gz"
        bs = 64
    else:
        (path,) = _inputs(str(tmp_path), "oversized")
        bs = 4
    got = list(tbinding.read_batches([path], batch_size=bs))
    _same_batches(got, list(jbinding.read_batches([path], batch_size=bs)))
    if case == "oversized":
        assert sorted(int(n) for b in got for n in b.lengths[:b.n]) == \
            [4, 6, 6000]
