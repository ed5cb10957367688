"""The port's multi-device path (--devices N, parallel/tile_sharded) on
the CPU: HK15's, HK1's shard entry's and HK8's shard entry's plain
versions, the sharded build (routing, exchange, grow, seal) and the
replicated stage 2, on meshes that name the CPU N times, against the
JAX package's tile_sharded on its virtual CPU mesh and against the
port's own one-card path.

Inputs: the JAX tests' reads (tests/test_tile_sharded.py: k = 9, 40 bp,
seeded numpy), each JAX configuration built once per module. Integer
work throughout: every comparison is exact."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import collections

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quorum_tpu.models import corrector as jcorr
from quorum_tpu.models.create_database import extract_observations
from quorum_tpu.models.ec_config import ECConfig as JECConfig
from quorum_tpu.ops import ctable as jct
from quorum_tpu.parallel import tile_sharded as jts
from quorum_tpu_torch import kernels
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.io import packing as tpacking
from quorum_tpu_torch.io.fastq import ReadBatch
from quorum_tpu_torch.kernels import reference as ref
from quorum_tpu_torch.models import corrector as tcorr
from quorum_tpu_torch.models import create_database as tcdb
from quorum_tpu_torch.models.ec_config import ECConfig as TECConfig
from quorum_tpu_torch.ops import ctable as tct
from quorum_tpu_torch.parallel import tile_sharded as tts

K = 9
RLEN = 40
QT = 53
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; under the suite's
    parallel workers, torch's intra-op threads only contend for the
    cores (a golden driver run: about 3 s in a process of its own,
    100-150 s beside five other loaded xdist workers on 8 cores with
    the default thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _reads(rng, n_reads, genome_size=600, err=0.03):
    """tests/test_tile_sharded.py's generator."""
    genome = rng.integers(0, 4, size=genome_size, dtype=np.int8)
    starts = rng.integers(0, genome_size - RLEN, size=n_reads)
    codes = genome[starts[:, None] + np.arange(RLEN)[None, :]].astype(np.int8)
    e = rng.random(codes.shape) < err
    codes = np.where(e, (codes + rng.integers(1, 4, size=codes.shape)) % 4,
                     codes).astype(np.int8)
    quals = np.full(codes.shape, 70, np.uint8)
    quals[rng.random(codes.shape) < 0.05] = 34
    return codes, quals


def _pack(codes, quals):
    lengths = np.full(codes.shape[0], codes.shape[1], np.int32)
    return tpacking.pack_reads(codes, quals, lengths, thresholds=(QT,))


def _u32(rows: torch.Tensor) -> np.ndarray:
    return rows.numpy().view(np.uint32)


def _entry_map(rows_u32, k, rb):
    khi, klo, vals = jct.tile_iterate(jct.TileState(jnp.asarray(rows_u32)),
                                      jct.TileMeta(k=k, bits=7, rb_log2=rb))
    return {(int(h), int(lo)): int(v) for h, lo, v in zip(khi, klo, vals)}


def _port_sharded_build(codes, quals, S, rb):
    """The port's sharded stage 1 on a CPU mesh of S shards from a
    global geometry of 2^rb rows."""
    mesh = tts.make_mesh(S, device="cpu")
    meta = tts.TileShardedMeta(k=K, bits=7, rb_log2=rb, n_shards=S)
    bstate = tts.make_build_state(meta, mesh)
    bstate, meta, grows = tts.build_step_wire(bstate, meta, mesh,
                                              _pack(codes, quals), QT)
    state, seal = tts.finalize(bstate, meta, mesh)
    return state, meta, seal, grows, bstate


def _port_single_build(codes, quals, rb, tmp_path, S=1, layout="single"):
    """The port's stage 1 through create_database_main (devices=S) from
    -s sized for 2^rb rows; returns (database path, handoff)."""
    pk = _pack(codes, quals)
    tmp_path.mkdir(parents=True, exist_ok=True)
    cfg = tcdb.BuildConfig(k=K, bits=7, qual_thresh=QT, initial_size=24 << rb,
                           batch_size=pk.n_reads, device="cpu", devices=S,
                           db_layout=layout)
    path = str(tmp_path / f"db_{S}_{layout}.jf")
    handoff: dict = {}
    tcdb.create_database_main(
        [], path, cfg, handoff=handoff,
        batches_factory=lambda: [(ReadBatch(None, None, pk.lengths, [],
                                            pk.n_reads), pk)])
    return path, handoff


# ------------------------------------------------ HK15, key parts


@pytest.mark.parametrize("S", [2, 8])
def test_shard_route_matches_jax_owner_and_row(S):
    """HK15's key parts (kernels.reference.shard_key_parts) equal JAX's
    tile_key_parts under its
    TileShardedMeta, split into owner and local row; HK15's plain
    version buckets every observation of the wire by that owner, in
    observation order, with its qual bit."""
    codes, quals = _reads(np.random.default_rng(S), 8 * S)
    chi, clo, q, valid = (np.asarray(x) for x in extract_observations(
        jnp.asarray(codes), jnp.asarray(quals), K, QT))
    jmeta = jts.TileShardedMeta(k=K, bits=7, rb_log2=8, n_shards=S)
    addr, rlo, rhi = (np.asarray(x).astype(np.int64)[valid] for x in
                      jct.tile_key_parts(jnp.asarray(chi), jnp.asarray(clo),
                                         jmeta))
    keys = (chi.astype(np.int64) << 32 | clo.astype(np.int64))[valid]
    meta = tts.TileShardedMeta(k=K, bits=7, rb_log2=8, n_shards=S)
    owner, row, trlo, trhi = (x.numpy() for x in ref.shard_key_parts(
        torch.from_numpy(keys), meta))
    assert np.array_equal(owner, addr >> meta.local_rb)
    assert np.array_equal(row, addr & ((1 << meta.local_rb) - 1))
    assert np.array_equal(trlo, rlo) and np.array_equal(trhi, rhi)
    assert len(set(owner.tolist())) == S

    pk = _pack(codes, quals)
    [(lanes, sizes)] = kernels.shard_route(
        [(torch.from_numpy(pk.to_wire()), pk.n_reads, pk.length,
          pk.thresholds)], QT, meta)
    want = (keys << 1) | q[valid].astype(np.int64)
    order = np.argsort(owner, kind="stable")
    assert np.array_equal(lanes.numpy(), want[order])
    assert sizes == np.bincount(owner, minlength=S).tolist()
    # the lanes entry routes them again to the same buckets
    [(again, sizes2)] = kernels.shard_route_lanes([torch.from_numpy(want)],
                                                  meta)
    assert np.array_equal(again.numpy(), want[order]) and sizes2 == sizes


def test_grow_shard_matches_jax_entries_and_rehash():
    """HK8's shard entry on a 4-shard build table: its lanes, as a
    multiset of (new shard, row, rlo, rhi, hq, lq), equal JAX's
    _entries_host entries of the same table (keys decoded, raw hq/lq)
    rehashed at the doubled geometry; the place pass then holds every
    entry once."""
    S = 4
    codes, quals = _reads(np.random.default_rng(77), 64, genome_size=3000)
    _state, meta, _seal, _g, bstate = _port_sharded_build(codes, quals, S, 7)
    jb = jct.TBuildState(
        np.concatenate([_u32(b.tag) for b in bstate.shards]),
        np.concatenate([b.hq.numpy().view(np.uint32) for b in bstate.shards]),
        np.concatenate([b.lq.numpy().view(np.uint32) for b in bstate.shards]))
    jmeta = jts.TileShardedMeta(k=K, bits=7, rb_log2=meta.rb_log2,
                                n_shards=S)
    khi, klo, hq, lq = jts._entries_host(jb, jmeta)
    nmeta = jts.TileShardedMeta(k=K, bits=7, rb_log2=meta.rb_log2 + 1,
                                n_shards=S)
    addr, rlo, rhi = (np.asarray(x).astype(np.int64) for x in
                      jct.tile_key_parts(jnp.asarray(khi), jnp.asarray(klo),
                                         nmeta))
    lrb = nmeta.local_rb
    want = collections.Counter(zip(
        (addr >> lrb).tolist(), (addr & ((1 << lrb) - 1)).tolist(),
        rlo.tolist(), rhi.tolist(), hq.astype(np.int64).tolist(),
        lq.astype(np.int64).tolist()))
    got = collections.Counter()
    for lanes, sizes in kernels.tile_grow_shard(list(bstate.shards), meta):
        at = np.cumsum([0] + sizes)
        x = lanes.numpy().view(np.uint32).astype(np.int64)
        for d in range(S):
            got.update(zip([d] * sizes[d], *(x[at[d]:at[d + 1], j].tolist()
                                              for j in range(5))))
    assert got == want and len(khi) > 0
    grown, gmeta = tts.grow(bstate, meta, tts.make_mesh(S, device="cpu"))
    assert gmeta.rb_log2 == meta.rb_log2 + 1
    occupied = sum(int((b.tag[:, 0::2] != -1).sum()) for b in grown.shards)
    assert occupied == len(khi)


# ------------------------------------------------ sharded build


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """Per S in {1, 2, 8}, from one read set each at 2^8 global rows
    (tests/test_tile_sharded.py's geometry): JAX's tile_sharded build
    (entry map, per-shard occupancy), the port's sharded build (the
    library, and for S > 1 create_database_main with devices=S in both
    layouts), and the port's one-card build of the set."""
    d = tmp_path_factory.mktemp("sharded_builds")
    out = {}
    for S in (1, 2, 8):
        codes, quals = _reads(np.random.default_rng(S), 8 * S * 4)
        rb = max(8, 3 + (S - 1).bit_length())
        mesh = jts.make_mesh(S, conftest.cpu_devices(S))
        jmeta = jts.TileShardedMeta(k=K, bits=7, rb_log2=rb, n_shards=S)
        jstate, jmeta = jts.build_database_tile_sharded(
            [(jnp.asarray(codes), jnp.asarray(quals))], mesh, jmeta, QT)
        gstate, gmeta = jts.gather_table(jstate, jmeta)
        sd = d / str(S)
        single, _h = _port_single_build(codes, quals, rb, sd)
        state, meta, seal, _g, _b = _port_sharded_build(codes, quals, S, rb)
        paths = {"lib_sharded": str(sd / "lib_sharded.jf"),
                 "lib_single": str(sd / "lib_single.jf")}
        tdb.write_db_sharded(paths["lib_sharded"], state, meta)
        tdb.write_db(paths["lib_single"], *tts.gather_table(state, meta))
        handoff = None
        if S > 1:
            for layout in ("single", "sharded"):
                paths[layout], handoff = _port_single_build(
                    codes, quals, rb, sd, S, layout)
        out[S] = dict(
            jax_map=_entry_map(np.asarray(gstate.rows), K, gmeta.rb_log2),
            jax_occ=jts.shard_occupancy(jstate, jmeta), single=single,
            paths=paths, lib=(state, meta, seal), handoff=handoff)
    return out


@pytest.mark.parametrize("S", [1, 2, 8])
def test_sharded_build_matches_jax_and_one_card(builds, S):
    b = builds[S]
    state, meta, seal = b["lib"]
    (rows,), tmeta = tts.gather_table(state, meta)
    assert _entry_map(_u32(rows), K, tmeta.rb_log2) == b["jax_map"]
    assert tts.shard_occupancy(seal) == b["jax_occ"]
    assert sum(b["jax_occ"]) == len(b["jax_map"])
    want = tdb.db_payload_bytes(b["single"])
    for layout, path in b["paths"].items():
        assert tdb.db_payload_bytes(path) == want, layout
        h = tdb.read_header(path)
        if "sharded" in layout:
            assert h["n_shards"] == S and len(h["shards"]) == S
    if S > 1:  # the stage-1 entry point hands off the sharded table
        hstate, hmeta, stats = b["handoff"]["db"]
        assert isinstance(hstate, tct.ShardedTileState)
        assert hmeta.n_shards == S and stats.shard_occupancy == b["jax_occ"]
        assert stats.distinct == sum(b["jax_occ"])


def test_sharded_grow_matches_jax_and_one_card(tmp_path):
    """From an undersized table (2^4 global rows over 4 shards, JAX's
    test_build_grow_parity) the port's sharded build grows to JAX's
    final geometry with JAX's content, and its payload equals the
    port's one-card build from 2^4 rows."""
    S = 4
    codes, quals = _reads(np.random.default_rng(77), 64, genome_size=3000)
    mesh = jts.make_mesh(S, conftest.cpu_devices(S))
    jmeta = jts.TileShardedMeta(k=K, bits=7, rb_log2=4, n_shards=S)
    jstate, jmeta = jts.build_database_tile_sharded(
        [(jnp.asarray(codes), jnp.asarray(quals))], mesh, jmeta, QT)
    gstate, gmeta = jts.gather_table(jstate, jmeta)
    state, meta, seal, grows, _b = _port_sharded_build(codes, quals, S, 4)
    assert grows >= 1 and meta.rb_log2 == jmeta.rb_log2 == 4 + grows
    (rows,), tmeta = tts.gather_table(state, meta)
    assert (_entry_map(_u32(rows), K, tmeta.rb_log2)
            == _entry_map(np.asarray(gstate.rows), K, gmeta.rb_log2))
    assert tts.shard_occupancy(seal) == jts.shard_occupancy(jstate, jmeta)
    single, h1 = _port_single_build(codes, quals, 4, tmp_path)
    assert h1["stats"].grows == grows
    path = str(tmp_path / "grown.jf")
    tdb.write_db(path, tct.TileState(rows), tmeta)
    assert tdb.db_payload_bytes(path) == tdb.db_payload_bytes(single)


# ------------------------------------------------ replicated stage 2


def _sharded_against_one_card(S, event_driven):
    """ShardedCorrector in one mode on a sharded build's table, held to
    the port's one-card result in that mode field by field and buffer
    word by word; returns (its result, JAX's one-card result in that
    mode, the reads' codes)."""
    rng = np.random.default_rng(S + 10)
    codes, quals = _reads(rng, 16 * S)
    state, meta, _seal, _g, _b = _port_sharded_build(codes, quals, S, 8)
    (rows,), tmeta = tts.gather_table(state, meta)
    codes[rng.random(codes.shape) < 0.02] = -1
    pk = tpacking.pack_reads(codes, quals,
                             np.full(codes.shape[0], RLEN, np.int32),
                             thresholds=(70,))
    cfg = TECConfig(k=K, cutoff=2, qual_cutoff=70)
    mesh = tts.make_mesh(S, device="cpu")
    res = tts.ShardedCorrector(mesh, state, meta, cfg,
                               event_driven=event_driven)(pk)
    one = tcorr.correct_batch_packed(
        tct.TileState(rows), tmeta, pk, cfg,
        tcorr.make_keep_table(tmeta, cfg, CPU), event_driven=event_driven)
    for name in ("out", "start", "end", "status", "packed"):
        assert torch.equal(getattr(res, name), getattr(one, name)), name
    for a, b in ((res.fwd_log, one.fwd_log), (res.bwd_log, one.bwd_log)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    jres = jcorr.correct_batch(
        jct.TileState(jnp.asarray(_u32(rows))),
        jct.TileMeta(k=K, bits=7, rb_log2=tmeta.rb_log2), codes, quals,
        np.full(codes.shape[0], RLEN, np.int32),
        JECConfig(k=K, cutoff=2, qual_cutoff=70), event_driven=event_driven)
    return res, jres, codes


def _matches_jax(res, jres, codes):
    """The reads' fields (status, start, end, each log's n and live
    entries) equal JAX's, on reads with Ns that some anchored read
    keeps."""
    for name in ("status", "start", "end"):
        assert np.array_equal(getattr(res, name).numpy(),
                              np.asarray(getattr(jres, name))), name
    for tl, jl in ((res.fwd_log, jres.fwd_log), (res.bwd_log, jres.bwd_log)):
        n = np.asarray(jl.n)
        assert np.array_equal(tl.n.numpy(), n)
        live = np.arange(tl.pos.shape[1])[None, :] < n[:, None]
        for f in ("pos", "meta"):
            assert np.array_equal(
                np.where(live, getattr(tl, f).numpy(), 0),
                np.where(live, np.asarray(getattr(jl, f))[:, :live.shape[1]],
                         0))
    assert (res.status.numpy() == 0).any()
    assert int((codes[res.status.numpy() == 0] == -1).sum()) > 0


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_corrector_matches_one_card_and_jax_plain(S):
    """ShardedCorrector on a sharded build's table, plain walks
    (event_driven=False): every BatchResult field and HK14's buffer
    equal the port's one-card result, and the reads' fields JAX's
    one-card plain loop, on reads with Ns."""
    _matches_jax(*_sharded_against_one_card(S, False))


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_corrector_event_mode_matches_one_card_and_jax(S):
    """The same in event mode, the default of both packages (HK16 and
    HK17 on each shard's rows, HK4's event entry)."""
    _matches_jax(*_sharded_against_one_card(S, True))


def test_replicated_table_is_one_copy_per_device():
    """On a mesh naming one device four times the sealed shards are row
    ranges of one plane, and the replicated table is that plane."""
    codes, quals = _reads(np.random.default_rng(3), 32)
    state, meta, _seal, _g, _b = _port_sharded_build(codes, quals, 4, 8)
    mesh = tts.make_mesh(4, device="cpu")
    reps = tts.replicate_table(state, mesh)
    assert all(r is state.whole for r in reps)
    assert all(s.data_ptr() == state.whole[i * 64].data_ptr()
               for i, s in enumerate(state.shards))


def test_routed_layout_is_refused():
    """No longer refused: over replicate_max_bytes ShardedCorrector takes
    the routed layout (the table row-sharded, read in place by HK5's and
    HK4's sharded-table entries) and gives the one-card result."""
    codes, quals = _reads(np.random.default_rng(4), 16)
    state, meta, _seal, _g, _b = _port_sharded_build(codes, quals, 2, 8)
    cfg = TECConfig(k=K, cutoff=2)
    corr = tts.ShardedCorrector(tts.make_mesh(2, device="cpu"), state, meta,
                                cfg, replicate_max_bytes=1000)
    assert corr.layout == "routed" and corr.rows is state
    pk = tpacking.pack_reads(codes, quals,
                             np.full(codes.shape[0], RLEN, np.int32),
                             thresholds=(cfg.qual_cutoff,))
    (rows,), tmeta = tts.gather_table(state, meta)
    one = tcorr.correct_batch_packed(tct.TileState(rows), tmeta, pk, cfg,
                                     tcorr.make_keep_table(tmeta, cfg, CPU))
    assert torch.equal(corr(pk).packed, one.packed)
