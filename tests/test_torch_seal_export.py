"""HK2 (tile_seal) and HK6's export (tile_export) through their plain
versions, against the JAX package, at the shapes their control flow can
get wrong: duplicate tag pairs in one half of a row, across its halves
and in a row of three occupied slots; a repeated pair whose second slot
has no count, or whose hi word is all ones (no duplicate, as JAX's sort
has it); dense rows of 64 occupied slots, with and without a repeat; an
empty table; tables of 1, 2 and 4 rows (lo words unaligned when rows %
4 != 0) and one shard of a table; the export with the caller's entry
count, without it, and with a wrong one (it raises, and write_db writes
nothing).

Inputs: seeded numpy build planes at k = 13, 24 and 31 (16, 16 and 64
rows at -b 7), each table built once per module on each side. Integer
work throughout: every comparison is exact."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quorum_tpu.ops import ctable as jct
from quorum_tpu.ops import sketch as jsketch
from quorum_tpu_torch import kernels
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.ops import ctable as tct

BITS = 7
RB = {13: 4, 24: 4, 31: 6}  # 31: the least rows its layout allows
EMPTY = 0xFFFFFFFF
PAIR = (0x5A5A5, 3)  # a planted tag pair (rlo, rhi)
# each table: (its rows' occupancy, planted (row, slot, slot) repeats,
# whether the seal must flag a duplicate)
TABLES = {
    "dup_same_half": (0.25, "half", True),
    "dup_across_halves": (0.25, "across", True),
    "dup_row_of_three": (0.25, "three", True),
    "no_dup_repeats": (0.25, "repeats", False),
    "dense": (1.0, None, False),
    "dense_dup": (1.0, "dense", True),
    "empty": (0.0, None, False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(k: int, name: str):
    """A seeded build table (tag u32 [rows, 128], hq, lq u32 [rows * 64])
    at k's geometry, with TABLES[name]'s occupancy and planted pairs."""
    meta = tct.TileMeta(k, BITS, RB[k])
    occupancy, plant, _dup = TABLES[name]
    rng = np.random.default_rng(k * 100 + sorted(TABLES).index(name))
    rows, hi_bits = meta.rows, min(31, max(0, meta.rem_bits - meta.rlo_bits))
    occ = rng.random((rows, 64)) < occupancy
    # the slot in tlo's top bits: no repeat but the planted ones
    tlo = (np.arange(64, dtype=np.uint64)[None] << (meta.rlo_bits - 6)) \
        | rng.integers(0, 1 << (meta.rlo_bits - 6), (rows, 64),
                       dtype=np.uint64)
    thi = rng.integers(0, 1 << hi_bits, (rows, 64), dtype=np.uint64)
    hq = rng.integers(0, 200, (rows, 64), dtype=np.uint64)
    lq = rng.integers(0, 4, (rows, 64), dtype=np.uint64)
    hq[rng.random((rows, 64)) < 0.3] = 0  # lq only, or (both 0) phantoms
    one = rng.random((rows, 64)) < 0.1  # single observations
    hq[one], lq[one] = 1, 0
    if occupancy == 1.0:  # every slot counted
        lq[hq == 0] |= 1
    tlo, thi = tlo.astype(np.uint32), thi.astype(np.uint32)
    hq, lq = hq.astype(np.uint32), lq.astype(np.uint32)

    def put(r, s, pair=PAIR, h=5, q=1):
        occ[r, s] = True
        tlo[r, s], thi[r, s] = pair
        hq[r, s], lq[r, s] = h, q

    if plant == "half":  # slots of one half of the row
        put(0, 3)
        put(0, 10)
    elif plant == "across":  # slot 0 and slot 63
        put(1, 0)
        put(1, 63)
    elif plant == "three":  # the pair and one more occupied slot
        occ[2] = False
        put(2, 7)
        put(2, 40)
        put(2, 21, pair=(77, 0))
    elif plant == "repeats":  # no count in the second slot; hi all ones
        put(0, 5)
        put(0, 40, h=0, q=0)
        put(1, 2, pair=(99, EMPTY))
        put(1, 50, pair=(99, EMPTY))
    elif plant == "dense":  # a repeat in a row of 64 occupied slots
        put(3, 1)
        put(3, 62)
    tag = np.stack([np.where(occ, tlo, EMPTY), np.where(occ, thi, EMPTY)],
                   axis=2).reshape(rows, 128).astype(np.uint32)
    return (meta, tag, np.where(occ, hq, 0).reshape(-1).astype(np.uint32),
            np.where(occ, lq, 0).reshape(-1).astype(np.uint32))


def _port_state(tag, hq, lq):
    return tct.TBuildState(*(torch.from_numpy(x.view(np.int32).copy())
                             for x in (tag, hq, lq)))


def _jax_payload(rows_u32, meta) -> np.ndarray:
    """JAX's v4/v5 payload of a sealed row plane (the table or a row
    range of it at meta's geometry)."""
    jm = jct.TileMeta(meta.k, meta.bits, meta.rb_log2)
    counts, lo_b, hi_pl, n = jct.tile_export_v4(
        jct.TileState(jnp.asarray(rows_u32)), jm, 64 * jm.rows)
    n = int(n)
    parts = [np.asarray(counts), np.asarray(lo_b)[:4 * n]]
    parts += [np.asarray(hi_pl)[j, :n] for j in range(hi_pl.shape[0])]
    return np.concatenate(parts)


@pytest.fixture(scope="module", params=sorted(RB))
def sealed(request):
    """Each table of TABLES at k, sealed by JAX (tile_seal, and
    singleton_entries for the fifth statistic) and by the port's plain
    version through its wrapper: {name: (meta, tag, hq, lq, JAX rows u32,
    JAX stats [5], port rows, port stats)}."""
    k = request.param
    out = {}
    for name in TABLES:
        meta, tag, hq, lq = _planes(k, name)
        jm = jct.TileMeta(k, BITS, RB[k])
        jb = jct.TBuildState(jnp.asarray(tag), jnp.asarray(hq),
                             jnp.asarray(lq))
        js, dup, occ, distinct, total = jct.tile_seal(jb, jm)
        singles = jsketch.singleton_entries(jb)
        jstats = [int(bool(dup)), int(occ), int(distinct), int(total),
                  int(singles)]
        rows, stats = kernels.tile_seal(_port_state(tag, hq, lq), meta)
        out[name] = (meta, tag, hq, lq, np.asarray(js.rows), jstats, rows,
                     stats)
    return out


@pytest.mark.parametrize("name", list(TABLES))
def test_seal_matches_jax(sealed, name):
    meta, tag, hq, lq, jrows, jstats, rows, stats = sealed[name]
    assert np.array_equal(rows.numpy().view(np.uint32), jrows)
    assert stats.tolist() == jstats
    assert jstats[0] == int(TABLES[name][2])
    st, dup, occ, distinct, total, singles = tct.tile_seal(
        _port_state(tag, hq, lq), meta)
    assert torch.equal(st.rows, rows)
    assert [int(dup), occ, distinct, total, singles] == jstats
    if name == "empty":
        assert jstats[1:] == [0, 0, 0, 0]
    if name.startswith("dense"):
        assert jstats[1] == 64 * meta.rows


@pytest.mark.parametrize("name", list(TABLES))
def test_export_matches_jax(sealed, name):
    meta, _tag, _hq, _lq, jrows, jstats, rows, _stats = sealed[name]
    n = jstats[1]
    want = _jax_payload(jrows, meta)
    assert want.shape[0] == meta.rows + (4 + meta.hi_bytes) * n
    got = kernels.tile_export(rows, meta, n).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(kernels.tile_export(rows, meta).numpy(), want)
    assert np.array_equal(tct.tile_export_v4(tct.TileState(rows), meta, n),
                          want)


@pytest.mark.parametrize("part", ["rows1", "rows2", "rows4", "shard"])
def test_export_row_range_matches_jax(sealed, part):
    """A row range of the no-duplicate table at its geometry: the first
    1, 2 or 4 rows (lo words unaligned below 4), or the second quarter
    (one shard of four)."""
    meta, _tag, _hq, _lq, jrows, _jstats, rows, _stats = \
        sealed["no_dup_repeats"]
    q = meta.rows // 4
    a, b = (q, 2 * q) if part == "shard" else (0, int(part[4:]))
    sub = rows[a:b]
    want = _jax_payload(jrows[a:b], meta)
    n = int(want[:b - a].sum())
    assert n > 0
    assert np.array_equal(kernels.tile_export(sub, meta, n).numpy(), want)
    assert np.array_equal(kernels.tile_export(sub, meta).numpy(), want)


def test_export_refuses_a_wrong_count(sealed, tmp_path):
    """A count the table does not hold raises (the export drops what
    lies past it), and write_db then leaves no file."""
    meta, _tag, _hq, _lq, _jrows, jstats, rows, _stats = sealed["dense_dup"]
    n = jstats[1]
    for wrong in (n - 1, n + 1):
        with pytest.raises(RuntimeError, match="entries"):
            kernels.tile_export(rows, meta, wrong)
    with pytest.raises(RuntimeError):
        kernels.tile_export(sealed["empty"][6], meta, 1)
    path = str(tmp_path / "stale.qdb")
    with pytest.raises(RuntimeError):
        tdb.write_db(path, tct.TileState(rows), meta, n_entries=n + 1)
    assert not os.path.exists(path)
    with pytest.raises(ValueError):
        kernels.tile_export(rows, meta, -1)


def test_seal_into_a_row_range(sealed):
    """The seal written into one shard's rows of a larger plane (`out=`,
    as tile_sharded.finalize passes it) equals the seal alone, and the
    rows around it stay as they were."""
    meta, tag, hq, lq, jrows, jstats, _rows, _stats = sealed["dense_dup"]
    whole = torch.full((4 * meta.rows, 128), 7, dtype=torch.int32)
    out = whole[meta.rows:2 * meta.rows]
    rows, stats = kernels.tile_seal(_port_state(tag, hq, lq), meta, out=out)
    assert rows.data_ptr() == out.data_ptr()
    assert np.array_equal(out.numpy().view(np.uint32), jrows)
    assert stats.tolist() == jstats
    assert int((whole[:meta.rows] != 7).sum()) == 0
    assert int((whole[2 * meta.rows:] != 7).sum()) == 0
    skew = whole.view(-1)[2:2 + 128 * meta.rows].view(meta.rows, 128)
    with pytest.raises(ValueError, match="aligned"):  # 8 bytes off
        kernels.tile_seal(_port_state(tag, hq, lq), meta, out=skew)
