"""The partitioned multi-pass stage 1 (--partitions P) and the sharded
database manifest on the CPU: the port's K20 (partition_mask, HK1's and
HK11's partition filter, HK13 tile_departition) and K22 (HK6's compact
entry) through their plain versions, its manifest writer and loader,
and its CLIs and driver, against the JAX package on the same inputs.

Inputs: the golden reads (242 reads, k = 13) for the CLIs, and seeded
numpy reads at k = 24 with a local geometry of 2^15 rows, where the
local remainder's high part takes 2 bytes and the global one 1 byte.
Integer work throughout: every comparison is exact."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import filecmp
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quorum_tpu.cli import create_database as jcdb_cli
from quorum_tpu.cli import error_correct_reads as jec_cli
from quorum_tpu.io import db_format as jdb
from quorum_tpu.models import create_database as jcdb
from quorum_tpu.ops import ctable as jct
from quorum_tpu_torch import kernels
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.cli import quorum as tquorum
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.io import integrity
from quorum_tpu_torch.io import packing as tpacking
from quorum_tpu_torch.io.integrity import IntegrityError
from quorum_tpu_torch.models import create_database as tcdb
from quorum_tpu_torch.ops import ctable as tct

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
READS = os.path.join(GOLDEN, "reads.fastq")
CDB = ["-m", "13", "-b", "7", "-q", "38"]
CPU = ["--device", "cpu"]
QT = 38
P, G = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_output(a, b):
    return all(filecmp.cmp(a + ext, b + ext, shallow=False)
               for ext in (".fa", ".log"))


def golden_output(prefix, suffix=""):
    return all(filecmp.cmp(prefix + ext,
                           os.path.join(GOLDEN, f"expected{suffix}{ext}"),
                           shallow=False) for ext in (".fa", ".log"))


# ------------------------------------------------ kernels at k = 24


@pytest.fixture(scope="module")
def local_planes():
    """Seeded reads at k = 24 and, for each of the 4 passes at the local
    geometry 2^15 rows, the JAX package's sealed local plane (uint32
    numpy) and the port's (int32 torch, its own insert: other slot
    positions)."""
    rng = np.random.default_rng(24)
    genome = rng.integers(0, 4, size=3000, dtype=np.int8)
    starts = rng.integers(0, len(genome) - 80, size=192)
    codes = genome[starts[:, None] + np.arange(80)[None, :]]
    errs = rng.random(codes.shape) < 0.02
    codes = np.where(errs, (codes + 1) % 4, codes).astype(np.int8)
    quals = np.where(rng.random(codes.shape) < 0.1, 35, 70).astype(np.uint8)
    lengths = np.full(codes.shape[0], 80, np.int32)
    tpk = tpacking.pack_reads(codes, quals, lengths, thresholds=(QT,))
    wire = torch.from_numpy(tpk.to_wire())
    jmeta = jct.TileMeta(k=24, bits=7, rb_log2=15)
    tmeta = tct.TileMeta(k=24, bits=7, rb_log2=15)
    chi, clo, q, valid = jcdb.extract_observations(
        jnp.asarray(codes), jnp.asarray(quals), 24, QT)
    jrows, trows = [], []
    for p in range(P):
        # the JAX package's partition filter, as its fused insert folds
        # it into `valid` (ctable.py:1258-1260)
        own = valid & jct.partition_mask(chi, clo, jmeta, p, P)
        bs, full, _placed = jct.tile_insert_observations(
            jct.make_tile_build(jmeta), jmeta, chi, clo, q, own)
        assert not bool(full)
        jrows.append(np.asarray(jct.tile_finalize(bs, jmeta).rows))
        tb = tct.make_tile_build(tmeta, "cpu")
        full, _left = kernels.tile_insert_reads(
            tb, tmeta, wire, tpk.n_reads, tpk.length, tpk.thresholds, QT,
            p, P)
        assert not full
        trows.append(tct.tile_seal(tb, tmeta)[0].rows)
    return dict(jmeta=jmeta, tmeta=tmeta, jrows=jrows, trows=trows,
                tpk=tpk, wire=wire)


def _port(rows_u32):
    return torch.from_numpy(np.ascontiguousarray(rows_u32).view(np.int32)
                            .copy())


def _entries(rows_u32):
    """A sealed plane's content whatever its slot order: the occupied
    slots' (row, hi, lo), sorted."""
    r, s = np.nonzero(rows_u32[:, 0::2] & 127)
    e = np.stack([r, rows_u32[r, 2 * s + 1], rows_u32[r, 2 * s]], 1)
    return e[np.lexsort(e.T[::-1])]


def test_geometry_hi_bytes_differ(local_planes):
    gmeta = tct.GlobalMeta(24, 7, 15 + G)
    assert (local_planes["tmeta"].hi_bytes, gmeta.hi_bytes) == (2, 1)


@pytest.mark.parametrize("k,rb,n_parts,bits", [
    (13, 8, 4, 7), (24, 15, 4, 7), (24, 15, 8, 7),
    # rlo holds fewer than log2(n_parts) bits: the filter reads rhi too
    (13, 8, 4, 30), (24, 15, 256, 25)])
def test_partition_mask_matches_jax(k, rb, n_parts, bits):
    keys = torch.from_numpy(np.random.default_rng(k + rb).integers(
        0, 1 << (2 * k), size=4096, dtype=np.int64))
    tmeta = tct.TileMeta(k=k, bits=bits, rb_log2=rb)
    jmeta = jct.TileMeta(k=k, bits=bits, rb_log2=rb)
    chi = jnp.asarray((keys.numpy() >> 32).astype(np.uint32))
    clo = jnp.asarray((keys.numpy() & 0xFFFFFFFF).astype(np.uint32))
    hits = torch.zeros(keys.numel(), dtype=torch.int64)
    for p in range(n_parts):
        own = tct.partition_mask(keys, tmeta, p, n_parts)
        assert np.array_equal(
            own.numpy(), np.asarray(jct.partition_mask(chi, clo, jmeta, p,
                                                       n_parts)))
        hits += own
    assert bool((hits == 1).all())  # disjoint and exhaustive


@pytest.mark.parametrize("p", range(P))
def test_departition_matches_jax(local_planes, p):
    """On the JAX package's own sealed local plane: the same global
    plane bit for bit; on the port's plane (other slot positions): the
    same content."""
    lp = local_planes
    jstate, jbad = jct.tile_departition_rows(
        jct.TileState(jnp.asarray(lp["jrows"][p])), lp["jmeta"], G, p)
    assert not bool(jbad)
    want = np.asarray(jstate.rows)
    rows = _port(lp["jrows"][p])
    state, bad = tct.tile_departition_rows(tct.TileState(rows),
                                           lp["tmeta"], G, p)
    assert not bad and state.rows is rows  # in place
    assert np.array_equal(rows.numpy().view(np.uint32), want)
    own = lp["trows"][p].clone()
    tct.tile_departition_rows(tct.TileState(own), lp["tmeta"], G, p)
    got = _entries(own.numpy().view(np.uint32))
    assert got.shape[0] > 0 and np.array_equal(got, _entries(want))


def test_departition_flags_a_foreign_entry(local_planes):
    """An entry of pass 1 planted into an empty slot of pass 0's plane
    sets `bad` in both packages."""
    lp = local_planes
    rows = lp["jrows"][0].copy()
    other = lp["jrows"][1]
    r, s = np.argwhere(other[:, 0::2] & 127 != 0)[0]
    empty = np.argwhere(rows[r, 0::2] & 127 == 0)[0][0]
    rows[r, 2 * empty:2 * empty + 2] = other[r, 2 * s:2 * s + 2]
    _js, jbad = jct.tile_departition_rows(jct.TileState(jnp.asarray(rows)),
                                          lp["jmeta"], G, 0)
    _ts, tbad = tct.tile_departition_rows(tct.TileState(_port(rows)),
                                          lp["tmeta"], G, 0)
    assert bool(jbad) and tbad


def test_passes_reassemble_the_single_pass_payload(local_planes):
    """The four departitioned port planes, exported as shards at the
    global geometry (HK6 on a row range), concatenate section by section
    into the single-pass payload (the CLI tests hold that one to the JAX
    package's)."""
    lp = local_planes
    gm = tct.TileMeta(k=24, bits=7, rb_log2=15 + G)
    shards = []
    for p in range(P):
        rows = lp["trows"][p].clone()
        tct.tile_departition_rows(tct.TileState(rows), lp["tmeta"], G, p)
        shards.append(kernels.tile_export(rows, gm).numpy())
    rl = lp["tmeta"].rows
    n = [int(s[:rl].sum()) for s in shards]
    parts = [s[:rl] for s in shards] + [s[rl:rl + 4 * m]
                                        for s, m in zip(shards, n)]
    parts += [s[rl + 4 * m:] for s, m in zip(shards, n)]  # hi_bytes = 1
    whole = tct.make_tile_build(gm, "cpu")
    tpk = lp["tpk"]
    full, _left = kernels.tile_insert_reads(
        whole, gm, lp["wire"], tpk.n_reads, tpk.length, tpk.thresholds, QT)
    assert not full
    want = kernels.tile_export(tct.tile_seal(whole, gm)[0].rows, gm).numpy()
    assert np.array_equal(np.concatenate(parts), want)


@pytest.mark.parametrize("cap", ["below", "above", "zero", "exact",
                                 "empty"])
def test_compact_matches_jax(local_planes, cap):
    """K22 (HK6's compact entry's plain version) against JAX's
    tile_compact_device: caps that drop entries (below, zero), fit them
    exactly or leave zero lanes (above), and an all-empty row range."""
    lp = local_planes
    rows = lp["jrows"][2]
    if cap == "empty":
        rows = np.zeros_like(rows[:1024])
    n = int((rows[:, 0::2] & 127 != 0).sum())
    c = {"below": n - 7, "above": n + 9, "zero": 0, "exact": n,
         "empty": 5}[cap]
    ja, jlo, jhi, jn = jct.tile_compact_device(
        jct.TileState(jnp.asarray(rows)), lp["jmeta"], c)
    ta, tlo, thi, tn = tct.tile_compact_device(tct.TileState(_port(rows)),
                                               lp["tmeta"], c)
    assert int(tn) == int(jn) == n
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tlo.numpy().view(np.uint32), np.asarray(jlo))
    assert np.array_equal(thi.numpy().view(np.uint32), np.asarray(jhi))


@pytest.mark.parametrize("p", range(P))
def test_filtered_insert_matches_jax(local_planes, p):
    """HK1's plain filter: the port's pass-p plane holds the JAX
    package's pass-p content (slot positions aside)."""
    lp = local_planes
    assert np.array_equal(_entries(lp["trows"][p].numpy().view(np.uint32)),
                          _entries(lp["jrows"][p]))


# ------------------------------------------------ CLIs on golden reads


@pytest.fixture(scope="module")
def golden_dbs(tmp_path_factory):
    """Golden-read databases: the port's single-file, --partitions 4,
    --db-layout sharded, --partitions 4 --prefilter two-pass and
    single-pass two-pass builds; the JAX package's --partitions 4 and
    --partitions 4 --prefilter two-pass builds; each package's -s 100
    --partitions 4 build (geometry restarts), with its stats."""
    d = tmp_path_factory.mktemp("partitions")
    out = {"dir": d}
    for name, main, extra in (
            ("single", tcdb_cli.main, CPU),
            ("part", tcdb_cli.main, CPU + ["--partitions", "4"]),
            ("sharded", tcdb_cli.main, CPU + ["--db-layout", "sharded"]),
            ("part_two", tcdb_cli.main,
             CPU + ["--partitions", "4", "--prefilter", "two-pass"]),
            ("two", tcdb_cli.main, CPU + ["--prefilter", "two-pass"]),
            ("jax_part", jcdb_cli.main, ["--partitions", "4"]),
            ("jax_part_two", jcdb_cli.main,
             ["--partitions", "4", "--prefilter", "two-pass"])):
        out[name] = str(d / f"{name}.jf")
        assert main(["-s", "64k"] + CDB + extra + ["-o", out[name],
                                                   READS]) == 0
    for name, mod, cfg in (
            ("jax_restart", jcdb, jcdb.BuildConfig(
                k=13, bits=7, qual_thresh=QT, initial_size=100,
                partitions=P, db_layout="sharded")),
            ("restart", tcdb, tcdb.BuildConfig(
                k=13, bits=7, qual_thresh=QT, initial_size=100,
                partitions=P, db_layout="sharded", device="cpu"))):
        out[name] = str(d / f"{name}.jf")
        out[name + "_stats"] = mod.create_database_main([READS], out[name],
                                                        cfg)
    return out


def test_partitioned_payload_at_wide_values(tmp_path):
    """-b 30 leaves rlo one bit: the passes still split the mers and
    reassemble the single-pass payload."""
    out = {}
    for name, extra in (("single", []), ("part", ["--partitions", "4"])):
        out[name] = str(tmp_path / f"{name}.jf")
        assert tcdb_cli.main(["-s", "64k", "-m", "13", "-b", "30", "-q",
                              "38"] + CPU + extra + ["-o", out[name],
                                                     READS]) == 0
    assert tdb.db_payload_bytes(out["part"]) == \
        tdb.db_payload_bytes(out["single"])


def test_partitioned_payload_matches_single_and_jax(golden_dbs):
    pay = tdb.db_payload_bytes(golden_dbs["part"])
    assert pay == tdb.db_payload_bytes(golden_dbs["single"])
    assert pay == jdb.db_payload_bytes(golden_dbs["jax_part"])
    h = tdb.read_header(golden_dbs["part"])
    assert h["format"] == tdb.MANIFEST_FORMAT and h["n_shards"] == P
    assert sorted(h) == sorted(jdb.read_header(golden_dbs["jax_part"]))
    shard = tdb.read_header(tdb.shard_file_name(golden_dbs["part"], 2, P))
    jshard = jdb.read_header(jdb.shard_file_name(golden_dbs["jax_part"], 2,
                                                 P))
    assert sorted(shard) == sorted(jshard)
    assert {k: shard[k] for k in ("rb_log2", "rows", "rows_local",
                                  "n_entries", "hi_bytes")} == \
        {k: jshard[k] for k in ("rb_log2", "rows", "rows_local",
                                "n_entries", "hi_bytes")}


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_manifest_corrects_to_golden_in_both_packages(golden_dbs, writer,
                                                      reader):
    db = golden_dbs["part" if writer == "port" else "jax_part"]
    out = str(golden_dbs["dir"] / f"ec_{writer}_by_{reader}")
    main, extra = (jec_cli.main, []) if reader == "jax" else (tec_cli.main,
                                                             CPU)
    assert main(extra + ["-p", "4", "-o", out, db, READS]) == 0
    assert golden_output(out)


def test_jax_read_db_loads_the_port_manifest(golden_dbs):
    js, jm, jh = jdb.read_db(golden_dbs["part"])
    ss, sm, sh = jdb.read_db(golden_dbs["single"])
    assert (jm.rb_log2, jh["n_entries"]) == (sm.rb_log2, sh["n_entries"])
    assert np.array_equal(np.asarray(js.rows), np.asarray(ss.rows))


def test_two_pass_partitions_match_jax_and_single_pass(golden_dbs):
    pay = tdb.db_payload_bytes(golden_dbs["part_two"])
    assert pay == jdb.db_payload_bytes(golden_dbs["jax_part_two"])
    assert pay == tdb.db_payload_bytes(golden_dbs["two"])
    h = tdb.read_header(golden_dbs["part_two"])
    for other in (jdb.read_header(golden_dbs["jax_part_two"]),
                  tdb.read_header(golden_dbs["two"])):
        assert h["prefilter"] == other["prefilter"]
        assert h["poisson_stats"] == other["poisson_stats"]
    assert h["prefilter"]["dropped"] > 0
    # stage 2 takes the floor and the cutoff from the manifest header
    out = str(golden_dbs["dir"] / "ec_part_two")
    two = str(golden_dbs["dir"] / "ec_two")
    for db, o in ((golden_dbs["part_two"], out), (golden_dbs["two"], two)):
        assert tec_cli.main(CPU + ["-o", o, db, READS]) == 0
    assert same_output(out, two)


def test_geometry_restart_matches_jax(golden_dbs):
    st, jst = golden_dbs["restart_stats"], golden_dbs["jax_restart_stats"]
    assert st.grows == jst.grows >= 1
    assert (st.reads, st.bases, st.distinct) == \
        (jst.reads, jst.bases, jst.distinct) == (242, st.bases, 3525)
    assert tdb.db_payload_bytes(golden_dbs["restart"]) == \
        jdb.db_payload_bytes(golden_dbs["jax_restart"])


def test_sharded_layout_writes_one_shard(golden_dbs):
    h = tdb.read_header(golden_dbs["sharded"])
    assert h["n_shards"] == 1 and len(h["shards"]) == 1
    assert tdb.db_payload_bytes(golden_dbs["sharded"]) == \
        tdb.db_payload_bytes(golden_dbs["single"])
    out = str(golden_dbs["dir"] / "ec_sharded")
    assert tec_cli.main(CPU + ["-o", out, golden_dbs["sharded"], READS]) == 0
    assert golden_output(out, "_auto")


# ------------------------------------------------ refusals


@pytest.mark.parametrize("argv,msg", [
    (["--partitions", "3"], "power of two in [1, 256], got 3"),
    (["--partitions", "512"], "power of two in [1, 256], got 512"),
    (["--partitions", "4", "--prefilter", "inline"],
     "supports neither --partitions"),
    (["--devices", "3"], "--devices must be a power of two"),
    (["--prefilter", "inline", "--checkpoint-dir", "ck"],
     "nor --checkpoint-dir"),
])
def test_stage1_cli_refuses(tmp_path, capsys, argv, msg):
    out = str(tmp_path / "db.jf")
    assert tcdb_cli.main(["-s", "64k"] + CDB + CPU + argv
                         + ["-o", out, READS]) == 1
    assert msg in capsys.readouterr().err
    assert not os.path.exists(out)


@pytest.mark.parametrize("entry,prefilter,msg", [
    ("main", "inline", "not pass-stable"),
    ("build", "off", "through create_database_main")])
def test_library_refuses(tmp_path, entry, prefilter, msg):
    cfg = tcdb.BuildConfig(k=13, qual_thresh=QT, initial_size=64000,
                           partitions=P, prefilter=prefilter, device="cpu")
    with pytest.raises(ValueError, match=msg):
        if entry == "main":
            tcdb.create_database_main([READS], str(tmp_path / "db.jf"), cfg)
        else:
            tcdb.build_database([READS], cfg, torch.device("cpu"))


def _copy_db(src, dst):
    """A manifest and its shard files under a new prefix; returns the
    new manifest's (sealed) document."""
    h = json.loads(open(src, "rb").readline())
    h.pop(integrity.SEAL_FIELD)
    for rec in h["shards"]:
        new = rec["path"].replace(os.path.basename(src),
                                  os.path.basename(dst))
        with open(os.path.join(os.path.dirname(src), rec["path"]), "rb") as f:
            data = f.read()
        with open(os.path.join(os.path.dirname(dst), new), "wb") as f:
            f.write(data)
        rec["path"] = new
    h = integrity.seal(h)
    with open(dst, "w") as f:
        f.write(json.dumps(h) + "\n")
    return h


def test_loader_refuses_missing_tampered_and_lone_shards(golden_dbs,
                                                         tmp_path):
    src = golden_dbs["part"]
    # a shard file on its own
    with pytest.raises(ValueError, match="load the sharded database"):
        tdb.load_db(tdb.shard_file_name(src, 1, P))
    # a tampered manifest (a shard digest changed, the seal kept)
    bad = str(tmp_path / "tampered.jf")
    h = _copy_db(src, bad)
    tdb.load_db(bad)  # the copy itself loads
    h["shards"][1]["file_crc32c"] ^= 1
    with open(bad, "w") as f:
        f.write(json.dumps(h) + "\n")
    with pytest.raises(IntegrityError, match="altered after it was written"):
        tdb.load_db(bad)
    # ... and the seal recomputed: the manifest's shard digest refuses
    h.pop(integrity.SEAL_FIELD)
    with open(bad, "w") as f:
        f.write(json.dumps(integrity.seal(h)) + "\n")
    with pytest.raises(IntegrityError, match="swapped or regenerated"):
        tdb.load_db(bad)
    # a missing shard, at the loader and at the stage-2 CLI (rc 3)
    gone = str(tmp_path / "gone.jf")
    _copy_db(src, gone)
    os.remove(tdb.shard_file_name(gone, 3, P))
    with pytest.raises(IntegrityError, match="missing shard 3"):
        tdb.load_db(gone)
    assert tec_cli.main(CPU + ["-o", str(tmp_path / "o"), gone, READS]) == 3


def test_loader_refuses_a_manifest_past_one_card(tmp_path):
    path = str(tmp_path / "wide.jf")
    tdb.write_db_manifest(path, [], tct.GlobalMeta(24, 7, 26), P)
    with pytest.raises(ValueError, match="--devices N"):
        tdb.load_db(path)


# ------------------------------------------------ the driver


@pytest.mark.parametrize("extra", [["--partitions", "4"],
                                   ["--partitions", "4", "-s", "100"]])
def test_driver_partitions_give_the_same_bytes(tmp_path, extra):
    """The driver with --partitions 4 (stage 2 loads the manifest and
    replays the first pass's batches), and with a -s that restarts the
    passes (the first pass is cut short, so stage 2 re-parses), gives
    the bytes of the driver without it on these reads:
    tests/golden/expected_auto.fa/.log (the cutoff from the table)."""
    part = str(tmp_path / "part")
    report: dict = {}
    assert tquorum.main(["-s", "64k", "-k", "13"] + CPU + extra
                        + ["-p", part, READS], report=report) == 0
    assert golden_output(part, "_auto")
    assert report["build"].reads == 242
    assert report["build"].grows == (1 if "100" in extra else 0)
    assert tdb.read_header(part + "_mer_database.jf")["n_shards"] == P
