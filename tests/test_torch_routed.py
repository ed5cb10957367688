"""The port's routed stage-2 layout and HK15's partition entry on the
CPU (the kernels' plain versions, meshes naming the CPU S times) against
the JAX package on its virtual CPU mesh: HK3's shard entry
(query_step), HK5's and HK4's sharded-table entries through the routed
corrector (every BatchResult field and HK14's buffer, with and without a
contaminant), HK15's partition entry (against ctable.partition_mask, at
-b 7 and at -b 30 where the filter's bits reach the high tag word), and
the routed layout's peer-access check. The CLIs' routed and partitioned
mesh runs: tests/test_torch_routed_cli.py. Inputs: the golden reads
(k = 13) and seeded reads (k = 9). Integer work throughout: every
comparison is exact."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from quorum_tpu.io import contaminant as jcontam
from quorum_tpu.io import fastq as jfastq
from quorum_tpu.io import packing as jpacking
from quorum_tpu.models import create_database as jcdb
from quorum_tpu.models.create_database import extract_observations
from quorum_tpu.models.ec_config import ECConfig as JECConfig
from quorum_tpu.ops import ctable as jct
from quorum_tpu.parallel import tile_sharded as jts
from quorum_tpu_torch import kernels
from quorum_tpu_torch.io import contaminant as tcontam
from quorum_tpu_torch.io import db_format as tdb
from quorum_tpu_torch.io import packing as tpacking
from quorum_tpu_torch.models import corrector as tcorr
from quorum_tpu_torch.models.ec_config import ECConfig as TECConfig
from quorum_tpu_torch.ops import mer as tmer
from quorum_tpu_torch.parallel import tile_sharded as tts

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
READS = os.path.join(GOLDEN, "reads.fastq")
K = 13


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



@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden reads' batch (256 rows), their stage-1 table built by
    the JAX package and carried into the port, and a contaminant FASTA
    of two 2k-base windows of golden reads loaded by both packages."""
    d = tmp_path_factory.mktemp("routed")
    batch = next(iter(jfastq.read_batches([READS], 256)))
    jpk = jpacking.pack_reads(batch.codes, batch.quals, batch.lengths,
                              thresholds=(38,))
    cfg = jcdb.BuildConfig(k=K, bits=7, qual_thresh=38, initial_size=64000,
                           batch_size=256)
    jstate, jmeta, _stats = jcdb.build_database([], cfg,
                                                batches=[(batch, jpk)])
    tstate, tmeta = tdb.tile_state_from_numpy(
        np.asarray(jstate.rows), jmeta.k, jmeta.bits, jmeta.rb_log2, "cpu")
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = [acgt[batch.codes[i, :batch.lengths[i]]].tobytes().decode()
            for i in range(batch.n)]
    fa = str(d / "contam.fa")
    with open(fa, "w") as f:
        for j, at in enumerate((3, 40)):
            f.write(f">c{j}\n{''.join(seqs[at:at + 20])[:2000]}\n")
    return dict(batch=batch, jstate=jstate, jmeta=jmeta, tstate=tstate,
                tmeta=tmeta,
                jcontam=jcontam.load_contaminant(fa, K),
                tcontam=tcontam.load_contaminant(fa, K, "cpu"))


def _jax_routed(jstate, S):
    mesh = jts.make_mesh(S, conftest.cpu_devices(S))
    rows = jax.device_put(jstate.rows,
                          NamedSharding(mesh, PartitionSpec(jts.AXIS)))
    return mesh, jct.TileState(rows)


# ------------------------------------------------ HK3's shard entry


@pytest.mark.parametrize("S", [2, 4])
def test_query_step_matches_jax(golden, S):
    """tile_sharded.query_step (HK3's shard entry on row-sharded planes)
    answers the golden batch's window mers and as many random keys as
    JAX's query_step on its mesh does, and as one card's lookup."""
    b, meta1 = golden["batch"], golden["tmeta"]
    f, r, valid = tmer.rolling_kmers(torch.from_numpy(b.codes), K)
    sweep = tmer.canonical(f, r)[valid]
    rnd = torch.from_numpy(np.random.default_rng(S).integers(
        0, 1 << (2 * K), sweep.numel(), dtype=np.int64))
    keys = torch.cat([sweep, rnd])
    keys = keys[:keys.numel() // S * S]
    meta = tts.TileShardedMeta(k=K, bits=7, rb_log2=meta1.rb_log2,
                               n_shards=S)
    mesh = tts.make_mesh(S, device="cpu")
    state = tts.row_shards(golden["tstate"], meta, mesh)
    got = tts.query_step(mesh, meta)(state, keys)
    jmesh, jstate = _jax_routed(golden["jstate"], S)
    jmeta = jts.TileShardedMeta(k=K, bits=7, rb_log2=meta1.rb_log2,
                                n_shards=S)
    k64 = keys.numpy().astype(np.uint64)
    want = np.asarray(jts.query_step(jmesh, jmeta)(
        jstate, jnp.asarray((k64 >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((k64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert torch.equal(got, kernels.tile_lookup(golden["tstate"].rows, meta1,
                                                keys))
    assert int((got[:sweep.numel()] != 0).sum()) > sweep.numel() // 2


# ------------------------------------------------ HK5/HK4 sharded tables


# S = 2 without a contaminant: test_torch_sharded_cli.py's
# test_routed_layout_is_refused holds it to the golden (JAX) bytes
@pytest.mark.parametrize("S,contam", [(2, "kill"), (4, None), (4, "trim")])
def test_routed_corrector_matches_jax(golden, monkeypatch, S, contam):
    """The routed layout's ShardedCorrector (HK5's and HK4's
    sharded-table entries on row-sharded planes) gives JAX's routed
    correct_step_wire every BatchResult field and HK14's buffer word for
    word, with and without a contaminant (kill, trim), and the port's
    one-card result."""
    monkeypatch.setattr(tcorr, "_LEAN_CAP_CACHE", {})
    b = golden["batch"]
    trim = contam == "trim"
    kw = dict(k=K, cutoff=4, trim_contaminant=trim)
    tcfg, jcfg = TECConfig(**kw), JECConfig(**kw)
    pk = tpacking.pack_reads(b.codes, b.quals, b.lengths,
                             thresholds=(tcfg.qual_cutoff,))
    tc = golden["tcontam"] if contam else None
    mesh = tts.make_mesh(S, device="cpu")
    corr = tts.ShardedCorrector(mesh, golden["tstate"], golden["tmeta"], tcfg,
                                tc, replicate_max_bytes=0)
    assert corr.layout == "routed"
    assert isinstance(corr.meta, tts.RoutedTileMeta)
    res = corr(pk)
    jmesh = jts.make_mesh(S, conftest.cpu_devices(S))
    jcorr = jts.ShardedCorrector(jmesh, golden["jstate"], golden["jmeta"],
                                 jcfg, contam=golden["jcontam"] if contam
                                 else None, replicate_max_bytes=0)
    assert jcorr.layout == "routed"
    jpk = jpacking.pack_reads(b.codes, b.quals, b.lengths,
                              thresholds=(jcfg.qual_cutoff,))
    jres, jbuf = jcorr(jpk, 16384)
    for name in ("out", "start", "end", "status"):
        t = getattr(res, name).numpy()
        j = np.asarray(getattr(jres, name))
        if name == "out":  # inside each anchored read's kept range
            pos = np.arange(t.shape[1])[None, :]
            live = ((t.shape[0] > 0) & (pos >= res.start.numpy()[:, None])
                    & (pos < res.end.numpy()[:, None])
                    & (res.status.numpy() == 0)[:, None])
            t, j = np.where(live, t, 0), np.where(live, j, 0)
        assert np.array_equal(t, j), name
    for tl, jl in ((res.fwd_log, jres.fwd_log), (res.bwd_log, jres.bwd_log)):
        n = np.asarray(jl.n)
        assert np.array_equal(tl.n.numpy(), n)
        live = np.arange(tl.pos.shape[1])[None, :] < n[:, None]
        for f in ("pos", "meta"):
            assert np.array_equal(
                np.where(live, getattr(tl, f).numpy(), 0),
                np.where(live, np.asarray(getattr(jl, f))[:, :live.shape[1]],
                         0))
    assert np.array_equal(res.packed.numpy().view(np.uint32),
                          np.asarray(jbuf).astype(np.uint32))
    one = tcorr.correct_batch_packed(
        golden["tstate"], golden["tmeta"], pk, tcfg,
        tcorr.make_keep_table(golden["tmeta"], tcfg, "cpu"), tc)
    assert torch.equal(res.packed, one.packed)
    if contam == "kill":
        assert bool((res.status == 1).any())


# ------------------------------------------------ HK15's partition entry


def _reads(rng, n_reads, rlen=40, genome_size=600, err=0.03):
    genome = rng.integers(0, 4, size=genome_size, dtype=np.int8)
    starts = rng.integers(0, genome_size - rlen, size=n_reads)
    codes = genome[starts[:, None] + np.arange(rlen)[None, :]].astype(np.int8)
    e = rng.random(codes.shape) < err
    codes = np.where(e, (codes + rng.integers(1, 4, size=codes.shape)) % 4,
                     codes).astype(np.int8)
    quals = np.full(codes.shape, 70, np.uint8)
    quals[rng.random(codes.shape) < 0.05] = 34
    return codes, quals


@pytest.mark.parametrize("bits", [7, 30])
def test_shard_route_partition_entry_matches_partition_mask(bits):
    """HK15's partition entry routes exactly the observations JAX's
    partition_mask gives pass p of 4 at the pass's global geometry, in
    the plain entry's buckets; the four passes together route every
    observation once. At -b 30 the remainder's low tag holds one bit, so
    the filter needs the high word too."""
    k, S, P, qt = 9, 4, 4, 53
    codes, quals = _reads(np.random.default_rng(bits), 64)
    chi, clo, q, valid = (np.asarray(x) for x in extract_observations(
        jnp.asarray(codes), jnp.asarray(quals), k, qt))
    keys = (chi.astype(np.int64) << 32 | clo.astype(np.int64))
    meta = tts.TileShardedMeta(k=k, bits=bits, rb_log2=8, n_shards=S)
    jmeta = jts.TileShardedMeta(k=k, bits=bits, rb_log2=8, n_shards=S)
    pk = tpacking.pack_reads(codes, quals,
                             np.full(codes.shape[0], 40, np.int32),
                             thresholds=(qt,))
    job = (torch.from_numpy(pk.to_wire()), pk.n_reads, pk.length,
           pk.thresholds)
    [(every, _sizes)] = kernels.shard_route([job], qt, meta)
    routed = []
    for part in range(P):
        own = np.asarray(jct.partition_mask(jnp.asarray(chi), jnp.asarray(clo),
                                            jmeta, part, P)) & valid
        assert own.any() and not own.all()
        [(lanes, sizes)] = kernels.shard_route([job], qt, meta, part, P)
        want = (keys[own] << 1) | q[own].astype(np.int64)
        [(plain, psizes)] = kernels.shard_route_lanes(
            [torch.from_numpy(want)], meta)
        assert torch.equal(lanes, plain) and sizes == psizes
        routed.append(lanes)
    assert torch.equal(torch.sort(torch.cat(routed)).values,
                       torch.sort(every).values)


# ------------------------------------------------ peer access


def test_peer_check_refuses_cards_without_peer_access(monkeypatch):
    """The routed layout needs peer access between every ordered pair of
    the mesh's distinct cards; the check asks torch only (nothing is
    allocated) and a mesh naming one card, or the CPU, needs none."""
    asked = []

    def no_peer(a, b):
        asked.append((a, b))
        return False

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", no_peer)
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    why = tts.peer_reason([c0, c1])
    assert why is not None and "cuda:0 -> cuda:1 lacks" in why
    assert asked == [(c0, c1)]
    assert tts.peer_reason([c0, c0, c0]) is None
    assert tts.peer_reason([torch.device("cpu")] * 4) is None
    with pytest.raises(RuntimeError, match="needs peer access"):
        tts.ShardedCorrector([c0, c1], None, tts.TileShardedMeta(
            k=K, bits=7, rb_log2=25, n_shards=2), TECConfig(k=K, cutoff=4))
