"""The port's unpacked --devices entries (quorum_tpu_torch/parallel/
tile_sharded.py: build_database_tile_sharded, correct_step,
correct_step_routed, dryrun) on the CPU, on meshes that name the CPU N
times, against the JAX package's tile_sharded on its virtual CPU mesh.

Stage 1 inputs are tests/test_tile_sharded.py's reads (k = 9, 40 bp,
seeded numpy); stage 2 takes the dryrun's (seed 11, k = 15, 48 bp
reads of a 512 bp genome, 3% errors). Each JAX configuration is built
once per module. Integer work throughout: every comparison is exact."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quorum_tpu.models import corrector as jcorr
from quorum_tpu.models.ec_config import ECConfig as JECConfig
from quorum_tpu.ops import ctable as jct
from quorum_tpu.parallel import tile_sharded as jts
from quorum_tpu_torch.models.ec_config import ECConfig as TECConfig
from quorum_tpu_torch.parallel import tile_sharded as tts

K = 9
RLEN = 40
QT = 53


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _entry_map(rows_u32, k, rb):
    khi, klo, vals = jct.tile_iterate(jct.TileState(jnp.asarray(rows_u32)),
                                      jct.TileMeta(k=k, bits=7, rb_log2=rb))
    return {(int(h), int(lo)): int(v) for h, lo, v in zip(khi, klo, vals)}


BUILDS = {"S1": (1, 8, 1), "S2": (2, 8, 2), "S8": (8, 8, 8),
          "grow": (4, 4, 77)}  # (shards, rb_log2, seed)


@pytest.fixture(scope="module")
def builds():
    """Per case, JAX's build_database_tile_sharded and the port's from
    the same unpacked batches (two, so the second meets a table that
    holds the first; one from 2^4 rows, where the first grows): entry
    maps and shard occupancy."""
    out = {}
    for name, (S, rb, seed) in BUILDS.items():
        rng = np.random.default_rng(seed)
        grow = name == "grow"
        batches = [_reads(rng, 8 * S * 2, genome_size=3000 if grow else 600)
                   for _ in range(1 if grow else 2)]
        jmesh = jts.make_mesh(S, conftest.cpu_devices(S))
        jstate, jmeta = jts.build_database_tile_sharded(
            [(jnp.asarray(c), jnp.asarray(q)) for c, q in batches], jmesh,
            jts.TileShardedMeta(k=K, bits=7, rb_log2=rb, n_shards=S), QT)
        gstate, gmeta = jts.gather_table(jstate, jmeta)
        mesh = tts.make_mesh(S, device="cpu")
        state, meta = tts.build_database_tile_sharded(
            batches, mesh,
            tts.TileShardedMeta(k=K, bits=7, rb_log2=rb, n_shards=S), QT)
        (rows,), tmeta = tts.gather_table(state, meta)
        out[name] = dict(
            jax_map=_entry_map(np.asarray(gstate.rows), K, gmeta.rb_log2),
            jax_occ=jts.shard_occupancy(jstate, jmeta), jrb=jmeta.rb_log2,
            map=_entry_map(rows.numpy().view(np.uint32), K, tmeta.rb_log2),
            occ=[int((r[:, 0::2] != 0).sum()) for r in state.shards],
            rb=meta.rb_log2, S=len(state.shards))
    return out


@pytest.mark.parametrize("case", list(BUILDS))
def test_unpacked_build_matches_jax(builds, case):
    b = builds[case]
    assert b["rb"] == b["jrb"] and b["S"] == BUILDS[case][0]
    assert b["map"] == b["jax_map"] and len(b["map"]) > 0
    assert b["occ"] == b["jax_occ"]
    if case == "grow":
        assert b["rb"] > BUILDS[case][1]


def _dryrun_inputs(n_devices):
    """The dryrun's reads (tile_sharded.dryrun: seed 11)."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, size=512, dtype=np.int8)
    n_reads = 8 * n_devices
    starts = rng.integers(0, len(genome) - 48, size=n_reads)
    codes = genome[starts[:, None] + np.arange(48)[None, :]].astype(np.int8)
    err = rng.random(codes.shape) < 0.03
    codes = np.where(err, (codes + rng.integers(1, 4, size=codes.shape)) % 4,
                     codes).astype(np.int8)
    quals = np.full(codes.shape, 70, np.uint8)
    quals[err] = 34
    return codes, quals, np.full((n_reads,), 48, np.int32)


@pytest.fixture(scope="module")
def stage2():
    """JAX's own correct_step_routed on dryrun(mesh, 4)'s reads against
    JAX's sharded build of them, compiled once, at S = 4: it runs JAX's
    default, the event-driven corrector, which the port's steps run too.
    JAX's dryrun holds its correct_step (replicated) and
    correct_step_routed equal to its one-card corrector on out, start,
    end and status, so that result depends on neither the layout nor S:
    the port's steps, both layouts at S = 2 and 4, are held to it (one
    JAX compile, where a second for JAX's replicated step would cost
    the test budget ~5 s and check the same answer)."""
    codes, quals, lengths = _dryrun_inputs(4)
    jmesh = jts.make_mesh(4, conftest.cpu_devices(4))
    jstate, jmeta = jts.build_database_tile_sharded(
        [(jnp.asarray(codes), jnp.asarray(quals))], jmesh,
        jts.TileShardedMeta(k=15, bits=7, rb_log2=8, n_shards=4), 53)
    jres = jts.correct_step_routed(jmesh, jmeta, JECConfig(k=15, cutoff=2))(
        jstate, codes, quals, lengths)
    return dict(reads=(codes, quals, lengths),
                jax={f: np.asarray(getattr(jres, f))
                     for f in ("out", "start", "end", "status")})


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("layout", ["replicated", "routed"])
def test_correct_steps_match_jax(stage2, S, layout):
    codes, quals, lengths = stage2["reads"]
    mesh = tts.make_mesh(S, device="cpu")
    meta = tts.TileShardedMeta(k=15, bits=7, rb_log2=8, n_shards=S)
    state, meta = tts.build_database_tile_sharded([(codes, quals)], mesh,
                                                  meta, 53)
    cfg = TECConfig(k=15, cutoff=2)
    if layout == "replicated":
        gstate, gmeta = tts.gather_table(state, meta)
        res = tts.correct_step(mesh, gmeta, cfg)(gstate, codes, quals,
                                                  lengths)
    else:
        res = tts.correct_step_routed(mesh, meta, cfg)(state, codes, quals,
                                                        lengths)
    want = stage2["jax"]
    for f in ("out", "start", "end", "status"):
        assert np.array_equal(getattr(res, f).numpy(), want[f]), f
    assert (want["status"] == jcorr.OK).any()


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_passes_on_cpu_meshes(n, capsys):
    tts.dryrun(tts.make_mesh(n, device="cpu"), n)
    assert "parity vs single-chip OK" in capsys.readouterr().out
