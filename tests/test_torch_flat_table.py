"""The port's flat bucket-4 table (K25: quorum_tpu_torch/ops/ctable.py's
last section; HK18-HK20's plain versions) on the CPU against the JAX
package's (quorum_tpu/ops/ctable.py:51-560).

The port claims slots with a CAS whose winner differs from XLA's
scatter pick, so it is held to JAX on the table as a key -> value map,
`full` and the placed mask when not full, table_stats, lookups and
tile_from_build's entry map; never on slot positions. Inputs are seeded
numpy (tests/test_ctable.py's generators); each JAX configuration is
built once per module. Integer work throughout: every comparison is
exact."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quorum_tpu.ops import ctable as jct
from quorum_tpu_torch.ops import ctable as tct


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain versions run many small torch ops; under the suite's
    parallel workers torch's intra-op threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(keys):
    keys = np.asarray(keys, np.uint64)
    return (jnp.asarray((keys >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def _jax_build(meta, keys, quals, batch):
    """JAX's insert_observations with the grow-retry protocol; returns
    (bstate, meta, the `full` of every insert, the placed masks of the
    inserts that were not full)."""
    bstate = jct.make_build_table(meta)
    fulls, placed_ok = [], []
    for s in range(0, len(keys), batch):
        khi, klo = _split(keys[s:s + batch])
        q = jnp.asarray(quals[s:s + batch].astype(np.int32))
        pend = jnp.ones(len(keys[s:s + batch]), bool)
        while True:
            bstate, full, placed = jct.insert_observations(
                bstate, meta, khi, klo, q, pend)
            fulls.append(full)
            if not full:
                placed_ok.append(np.asarray(placed))
                break
            pend = jnp.asarray(np.asarray(pend) & ~np.asarray(placed))
            bstate, meta = jct.grow_build(bstate, meta)
    return bstate, meta, fulls, placed_ok


def _port_build(meta, keys, quals, batch):
    bstate = tct.make_build_table(meta, "cpu")
    fulls, placed_ok = [], []
    for s in range(0, len(keys), batch):
        kk = torch.from_numpy(np.asarray(keys[s:s + batch]).astype(np.int64))
        q = torch.from_numpy(quals[s:s + batch].astype(bool))
        pend = torch.ones(kk.shape, dtype=torch.bool)
        while True:
            bstate, full, placed = tct.insert_observations(bstate, meta, kk,
                                                           q, pend)
            fulls.append(full)
            if not full:
                placed_ok.append(placed.numpy())
                break
            pend = pend & ~placed
            bstate, meta = tct.grow_build(bstate, meta)
    return bstate, meta, fulls, placed_ok


def _jmap(state, meta):
    khi, klo, vals = jct.iterate_entries(state, meta)
    return {(int(h) << 32) | int(lo): int(v)
            for h, lo, v in zip(khi, klo, vals)}


def _tmap(state, meta):
    khi, klo, vals = tct.iterate_entries(state, meta)
    return {(int(h) << 32) | int(lo): int(v)
            for h, lo, v in zip(khi, klo, vals)}


def _obs(seed, k, n_pool, n_obs):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << (2 * k), size=n_pool, dtype=np.uint64)
    return pool[rng.integers(0, n_pool, size=n_obs)], \
        rng.integers(0, 2, size=n_obs)


CASES = [(bits, nb) for bits in (3, 7) for nb in (2, 6, 10)]


@pytest.fixture(scope="module")
def builds():
    """test_ctable.py's build configurations (k = 12, a pool of 60 keys,
    800 observations, here in batches of 100: one batch shape, so JAX
    compiles each geometry once), each built by JAX and by the port and
    sealed."""
    out = {}
    for bits, nb in CASES:
        keys, quals = _obs(nb * 100 + bits, 12, 60, 800)
        jb, jm, jf, jp = _jax_build(jct.CTableMeta(12, bits, nb), keys, quals,
                                    100)
        tb, tm, tf, tp = _port_build(tct.CTableMeta(12, bits, nb), keys, quals,
                                     100)
        out[(bits, nb)] = dict(
            keys=keys, jbuild=jb, jstate=jct.finalize_build(jb, jm), jmeta=jm,
            jfull=jf, jplaced=jp, tbuild=tb, tstate=tct.finalize_build(tb, tm),
            tmeta=tm, tfull=tf, tplaced=tp)
    return out


@pytest.mark.parametrize("k", [9, 16, 24, 27])
def test_bucket_rem_and_keys_from_table_match_jax(k):
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 1 << (2 * k), size=2000, dtype=np.uint64)
    nb = max(5, tct.min_nb_log2(k, 7))
    jm, tm = jct.CTableMeta(k, 7, nb), tct.CTableMeta(k, 7, nb)
    khi, klo = _split(keys)
    jb, jr = jax.jit(jct.bucket_rem, static_argnums=2)(khi, klo, jm)
    tb, tr = tct.bucket_rem(torch.from_numpy(keys.astype(np.int64)), tm)
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    back = tct.keys_from_table(tb, tr, tm)
    assert np.array_equal(back.numpy(), keys.astype(np.int64))
    jhi, jlo = jct.keys_from_table(jb, jr, jm)
    assert np.array_equal(back.numpy() >> 32, np.asarray(jhi))
    for i in range(0, 2000, 97):
        assert tct.bucket_rem_np(khi[i], klo[i], tm) == \
            jct.bucket_rem_np(khi[i], klo[i], jm)


def test_rehash_grow_matches_jax_and_rehashing():
    k, nb = 11, 6
    keys = np.random.default_rng(4).integers(0, 1 << (2 * k), size=3000,
                                             dtype=np.uint64)
    m1, m2 = tct.CTableMeta(k, 7, nb), tct.CTableMeta(k, 7, nb + 1)
    tk = torch.from_numpy(keys.astype(np.int64))
    b1, r1 = tct.bucket_rem(tk, m1)
    gb, gr = tct.rehash_grow(b1, r1, nb)
    b2, r2 = tct.bucket_rem(tk, m2)
    assert torch.equal(gb, b2) and torch.equal(gr, r2)
    jb, jr = jct.rehash_grow(jnp.asarray(b1.numpy().astype(np.int32)),
                             jnp.asarray(r1.numpy().astype(np.uint32)), nb)
    assert np.array_equal(gb.numpy(), np.asarray(jb))
    assert np.array_equal(gr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("bits,nb", CASES)
def test_build_matches_jax_as_a_map(builds, bits, nb):
    b = builds[(bits, nb)]
    assert b["tfull"] == b["jfull"]
    assert b["tmeta"] == tct.CTableMeta(12, bits, b["jmeta"].nb_log2)
    for t, j in zip(b["tplaced"], b["jplaced"]):
        assert np.array_equal(t, j)
    assert _tmap(b["tstate"], b["tmeta"]) == _jmap(b["jstate"], b["jmeta"])


def test_duplicate_flood_saturates_like_jax():
    """One key in 2,960 of 3,000 observations beside a few others: its count
    saturates at max_val, an hq observation outranks every lq one (the
    (bits 3, nb_log2 6) build's geometry and batches)."""
    bits = 3
    rng = np.random.default_rng(9)
    keys = np.concatenate([np.full(2960, 12345, np.uint64),
                           rng.integers(0, 1 << 24, size=40,
                                        dtype=np.uint64)])
    quals = np.concatenate([np.zeros(2950, np.int64), np.ones(10, np.int64),
                            rng.integers(0, 2, size=40)])
    order = rng.permutation(len(keys))
    keys, quals = keys[order], quals[order]
    jb, jm, jf, _p = _jax_build(jct.CTableMeta(12, bits, 6), keys, quals, 100)
    tb, tm, tf, _p = _port_build(tct.CTableMeta(12, bits, 6), keys, quals, 100)
    assert tf == jf
    jmap = _jmap(jct.finalize_build(jb, jm), jm)
    assert _tmap(tct.finalize_build(tb, tm), tm) == jmap
    assert jmap[12345] == (((1 << bits) - 1) << 1) | 1


def test_grow_from_an_undersized_table_matches_jax(builds):
    """From 2^2 buckets for 60 keys the build doubles until every bucket
    holds its keys, at the same inserts as JAX's, to JAX's geometry and
    map (the (bits 3, nb_log2 2) build)."""
    b = builds[(3, 2)]
    assert b["tfull"] == b["jfull"] and sum(b["tfull"]) >= 3
    assert b["tmeta"].nb_log2 == b["jmeta"].nb_log2 >= 5
    assert _tmap(b["tstate"], b["tmeta"]) == _jmap(b["jstate"], b["jmeta"])


@pytest.mark.parametrize("bits,nb", CASES[:3:2])
def test_finalize_and_table_stats_match_jax(builds, bits, nb):
    b = builds[(bits, nb)]
    jo, jd, jt = jct.table_stats(b["jstate"], b["jmeta"])
    want = (int(jo), int(jd), int(jt))
    assert tct.table_stats(b["tstate"], b["tmeta"]) == want
    # entries as JAX packs them: the same word for each key, found in its
    # bucket
    tent = b["tstate"].entries.numpy().view(np.uint32)
    jent = np.asarray(b["jstate"].entries)
    assert np.array_equal(np.sort(tent[tent != 0]), np.sort(jent[jent != 0]))


@pytest.mark.parametrize("bits,nb", CASES[3:5])
def test_lookup_present_and_absent_and_lookup_np(builds, bits, nb):
    b = builds[(bits, nb)]
    jmap = _jmap(b["jstate"], b["jmeta"])
    rng = np.random.default_rng(nb)
    absent = [int(a) for a in rng.integers(0, 1 << 24, size=200,
                                           dtype=np.uint64)
              if int(a) not in jmap]
    keys = np.array(sorted(jmap) + absent, np.uint64)
    khi, klo = _split(keys)
    want = np.asarray(jct.lookup(b["jstate"], b["jmeta"], khi, klo))
    got = tct.lookup(b["tstate"], b["tmeta"],
                     torch.from_numpy(keys.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert not want[len(jmap):].any() and want[:len(jmap)].all()
    tent = b["tstate"].entries.numpy()
    for i in range(0, len(keys), 7):
        assert tct.lookup_np(tent, b["tmeta"], khi[i], klo[i]) == int(want[i])


def test_tile_from_build_matches_jax_entry_map(builds):
    """tile_from_build (HK20, host ranks, HK7) holds JAX's tile entry map
    and statistics (the (bits 7, nb_log2 6) build)."""
    b = builds[(7, 6)]
    jts_, jtm = jct.tile_from_build(b["jbuild"], b["jmeta"])
    tts_, ttm, stats = tct.tile_from_build(b["tbuild"], b["tmeta"])
    assert ttm.rb_log2 == jtm.rb_log2

    def entry_map(rows, meta):
        khi, klo, vals = jct.tile_iterate(jct.TileState(jnp.asarray(rows)),
                                          meta)
        return {(int(h), int(lo)): int(v) for h, lo, v in zip(khi, klo, vals)}

    want = entry_map(np.asarray(jts_.rows), jtm)
    assert entry_map(tts_.rows.numpy().view(np.uint32), jtm) == want
    assert len(want) == 60
    o, d, t = jct.tile_stats(jts_, jtm)
    assert stats == (int(o), int(d), int(t))


def test_infeasible_layout_is_refused_with_jax_message():
    with pytest.raises(ValueError) as jerr:
        jct.CTableMeta(k=24, bits=7, nb_log2=10)
    with pytest.raises(ValueError) as terr:
        tct.CTableMeta(k=24, bits=7, nb_log2=10)
    assert str(terr.value) == str(jerr.value)
    assert tct.layout_fits(24, 7, 24) and not tct.layout_fits(24, 7, 23)
    assert tct.required_nb_log2(100, 24, 7) == \
        jct.required_nb_log2(100, 24, 7) == 24
    assert tct.min_nb_log2(24, 7) == jct.min_nb_log2(24, 7)
