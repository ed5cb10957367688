"""The port's reference-format writer and its legacy database reads
against the JAX package's: make_matrix; write_ref_db's bytes (the
header's `time`, where there is one, masked) and map; stage 1's
--ref-format read both ways, its bytes equal to JAX's, and -p/--reprobe
reaching the writer; stage 2 on a reference-format file; version 1-3
files built from the golden table load to JAX's map, stage 2 on them
gives JAX's bytes, and a corrupt v3 address is refused as JAX refuses
it; the stage CLIs' -v lines are JAX's, timings aside."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import contextlib
import filecmp
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from quorum_tpu.cli import create_database as jcdb_cli
from quorum_tpu.cli import error_correct_reads as jec_cli
from quorum_tpu.io import db_format as jdb
from quorum_tpu.io import quorum_db as jqdb
from quorum_tpu.ops import ctable as jct
from quorum_tpu.utils import vlog as jvlog
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.io import quorum_db as tqdb
from quorum_tpu_torch.ops import ctable as tct
from quorum_tpu_torch.utils import vlog as tvlog

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLDEN, "reads.fastq")
CDB = ["-s", "64k", "-m", "13", "-b", "7", "-q", "38"]
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


def _run(main, argv):
    """rc and stderr of main(argv); vlog is off again after it."""
    err = io.StringIO()
    mp = pytest.MonkeyPatch()
    mp.setattr(jvlog, "verbose", False)
    mp.setattr(tvlog, "verbose", False)
    try:
        with contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        mp.undo()
    assert rc == 0, err.getvalue()
    return err.getvalue()


def _vlog_lines(err: str) -> list:
    """A run's vlog lines without their stamps and JAX's stage timers."""
    out = []
    for line in err.splitlines():
        m = re.match(r"^\[\d{4}/\d\d/\d\d \d\d:\d\d:\d\d\] (.*)$", line)
        if m and not m.group(1).startswith(("stage ", "total ")):
            out.append(m.group(1))
    return out


def _same_output(a, b):
    return all(filecmp.cmp(a + ext, b + ext, shallow=False)
               for ext in (".fa", ".log"))


def _ref_parts(path):
    """(header without `time`, payload bytes) of a binary/quorum_db
    file: the header is the JSON object the file starts with."""
    with open(path, "rb") as f:
        data = f.read()
    header, end = json.JSONDecoder().raw_decode(data.decode("latin-1"))
    header.pop("time", None)
    return header, data[end:]


def _entries(khi, klo, vals):
    return sorted(zip(np.asarray(khi).tolist(), np.asarray(klo).tolist(),
                      np.asarray(vals).tolist()))


def _port_map(path):
    state, meta, _h, _s = tdb.load_db(path, device="cpu")
    return _entries(*tct.tile_iterate(state, meta))


def _jax_map(path):
    state, meta, _h = jdb.read_db(path, to_device=False)
    return _entries(*jct.tile_iterate(state, meta))


@pytest.mark.parametrize("key_len", [2, 26, 48, 62])
def test_make_matrix_matches_jax(key_len):
    assert tqdb.make_matrix(key_len) == jqdb.make_matrix(key_len)


@pytest.mark.parametrize("k,n,max_reprobe", [
    (24, 3000, 126), (13, 300, 126), (31, 1500, 126), (15, 64, 5),
    (24, 0, 126), (20, 20000, 3), (1, 3, 126)])
def test_write_ref_db_matches_jax(tmp_path, k, n, max_reprobe):
    rng = np.random.default_rng(1000 * k + n)
    keys = np.unique(rng.integers(0, 1 << (2 * k), n, dtype=np.uint64))
    khi = (keys >> np.uint64(32)).astype(np.uint32)
    klo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    vals = rng.integers(1, 1 << 10, len(keys)).astype(np.uint32)
    got, want = str(tmp_path / "t.db"), str(tmp_path / "j.db")
    for mod, path in ((tqdb, got), (jqdb, want)):
        mod.write_ref_db(path, khi, klo, vals, k, 7, max_reprobe=max_reprobe,
                         cmdline=["quorum_create_database", "--ref-format"])
    assert _ref_parts(got) == _ref_parts(want)
    want_map = _entries(khi, klo, vals & 0xFF)
    for path in (got, want):
        for mod in (tqdb, jqdb):
            rhi, rlo, rvals, rk, rbits = mod.read_ref_db(path)
            assert (rk, rbits) == (k, 7)
            assert _entries(rhi, rlo, rvals) == want_map
    assert not os.path.exists(got + ".tmp")


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """Stage 1 of the golden reads by both packages with --ref-format
    and -v (and -p 20 by the port), JAX's v5 file, and stage 2 with -v
    on JAX's reference-format file by both."""
    d = tmp_path_factory.mktemp("ref")
    p = {name: str(d / f"{name}.jf")
         for name in ("port", "jax", "port_p20", "jax_v5")}
    err = {"cdb_port": _run(tcdb_cli.main, CDB + ["--ref-format", "-v",
                                                  "-o", p["port"], READS]
                            + PORT[:2]),
           "cdb_jax": _run(jcdb_cli.main, CDB + ["--ref-format", "-v", "-o",
                                                 p["jax"], READS])}
    _run(tcdb_cli.main, CDB + ["--ref-format", "-p", "20", "-o",
                               p["port_p20"], READS] + PORT[:2])
    _run(jcdb_cli.main, CDB + ["-o", p["jax_v5"], READS])
    for who, main, extra in (("port", tec_cli.main, PORT),
                             ("jax", jec_cli.main, [])):
        err[f"ec_{who}"] = _run(main, ["-v", p["jax"], READS, "-o",
                                       str(d / f"ec_{who}")] + extra)
    return d, p, err


def test_ref_stage1_bytes_match_jax(ref_runs):
    """Both packages' stage 1 write the same file (same command line in
    one process)."""
    _d, p, _err = ref_runs
    assert _ref_parts(p["port"]) == _ref_parts(p["jax"])


def test_ref_stage1_read_both_ways(ref_runs):
    _d, p, _err = ref_runs
    want = _jax_map(p["jax_v5"])
    assert len(want) == 3525
    assert _jax_map(p["port"]) == want
    assert _port_map(p["jax"]) == want
    assert _port_map(p["port"]) == want


def test_reprobe_reaches_the_writer(ref_runs):
    _d, p, _err = ref_runs
    header, _payload = _ref_parts(p["port_p20"])
    assert header["max_reprobe"] == 20
    assert header["reprobes"] == [i * (i + 1) // 2 for i in range(21)]
    assert _ref_parts(p["port"])[0]["max_reprobe"] == 126
    assert _port_map(p["port_p20"]) == _port_map(p["port"])


def test_ref_stage2_matches_jax(ref_runs):
    d, _p, _err = ref_runs
    assert _same_output(str(d / "ec_port"), str(d / "ec_jax"))
    assert _same_output(str(d / "ec_port"),
                        os.path.join(GOLDEN, "expected_auto"))


@pytest.mark.parametrize("stage", ["cdb", "ec"])
def test_verbose_lines_match_jax(ref_runs, stage):
    _d, _p, err = ref_runs
    got = _vlog_lines(err[f"{stage}_port"])
    assert got == _vlog_lines(err[f"{stage}_jax"])
    assert got[-1] == ("Counted 242 reads, 14520 bases, 3525 distinct mers"
                       if stage == "cdb" else
                       "Done. 241 corrected, 1 skipped of 242 reads")


def _legacy_files(d, v5):
    """Version 1, 2 and 3 files of the JAX table in `v5`, as the JAX
    package's readers take them: v1 wide keys with empty slots between,
    v2 the raw row plane, v3 (address, lo, hi) triplets in a shuffled
    order."""
    state, meta, _h = jdb.read_db(v5, to_device=False)
    rows = np.ascontiguousarray(np.asarray(state.rows), np.uint32)
    base = {"format": jdb.FORMAT, "key_len": 2 * meta.k, "bits": meta.bits}
    rng = np.random.default_rng(3)
    paths = {}

    def write(name, header, *planes):
        paths[name] = str(d / f"{name}.qdb")
        with open(paths[name], "wb") as f:
            f.write((json.dumps(header) + "\n").encode())
            for plane in planes:
                f.write(np.ascontiguousarray(plane).tobytes())

    khi, klo, vals = (np.asarray(x) for x in jct.tile_iterate(state, meta))
    size = len(vals) + 37
    at = np.sort(rng.choice(size, len(vals), replace=False))
    wide = np.zeros((3, size), np.uint32)
    wide[0, at], wide[1, at], wide[2, at] = khi, klo, vals
    write("v1", dict(base, version=1, size=size), *wide)
    write("v2", dict(base, version=2, rb_log2=meta.rb_log2, rows=meta.rows),
          rows)
    lo = rows[:, 0::2]
    r, s = np.nonzero(lo & np.uint32(meta.max_val))
    order = rng.permutation(len(r))
    write("v3", dict(base, version=3, rb_log2=meta.rb_log2, rows=meta.rows,
                     n_entries=len(r)),
          r[order].astype(np.int32), lo[r, s][order],
          rows[:, 1::2][r, s][order])
    return paths


@pytest.fixture(scope="module")
def legacy(ref_runs):
    d, p, _err = ref_runs
    paths = _legacy_files(d, p["jax_v5"])
    for name, path in paths.items():
        _run(tec_cli.main, [path, READS, "-o", str(d / f"t_{name}")] + PORT)
        _run(jec_cli.main, [path, READS, "-o", str(d / f"j_{name}")])
    return d, paths


@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
def test_legacy_loads_to_jax_map(ref_runs, legacy, version):
    _d, p, _err = ref_runs
    _d, paths = legacy
    got = _port_map(paths[version])
    assert got == _jax_map(paths[version])
    assert got == _jax_map(p["jax_v5"])


@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
def test_legacy_stage2_matches_jax(legacy, version):
    d, _paths = legacy
    assert _same_output(str(d / f"t_{version}"), str(d / f"j_{version}"))
    assert _same_output(str(d / f"t_{version}"),
                        os.path.join(GOLDEN, "expected_auto"))


@pytest.mark.parametrize("case", ["past_rows", "negative", "crowded"])
def test_corrupt_v3_refused_as_jax(legacy, tmp_path, case):
    _d, paths = legacy
    with open(paths["v3"], "rb") as f:
        raw = f.read()
    nl = raw.index(b"\n") + 1
    header = json.loads(raw[:nl])
    n = header["n_entries"]
    addr = np.frombuffer(raw[nl:nl + 4 * n], np.int32).copy()
    lo = np.frombuffer(raw[nl + 4 * n:nl + 8 * n], np.uint32)
    hi = np.frombuffer(raw[nl + 8 * n:nl + 12 * n], np.uint32)
    if case == "crowded":
        # 65 copies of entry 0, one bucket
        header["n_entries"] = n = 65
        addr, lo, hi = (np.tile(x[:1], 65) for x in (addr, lo, hi))
    else:
        addr[0] = header["rows"] + 3 if case == "past_rows" else -2
    bad = str(tmp_path / "bad.qdb")
    with open(bad, "wb") as f:
        f.write((json.dumps(header) + "\n").encode())
        f.write(addr.tobytes() + lo.tobytes() + hi.tobytes())
    with pytest.raises(ValueError) as want:
        jdb.read_db(bad, to_device=False)
    with pytest.raises(ValueError) as got:
        tdb.load_db(bad, device="cpu")
    assert str(got.value) == str(want.value)
    assert ("bucket address" in str(got.value)) != (case == "crowded")
