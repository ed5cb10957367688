"""The plain version of HK14 (quorum_tpu_torch/kernels/reference.py:
pack_finish) against the JAX package's corrector._pack_finish_lean on
the same seeded batch results, buffer word for word (entries past the
capacity dropped alike); the host's exact re-pack on overflow and its
monotone capacity per shape; empty logs; the 16-bit position guard; and
HK4's overflow flag carried to the host."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.models import corrector as jcorr
from quorum_tpu_torch import kernels
from quorum_tpu_torch.models import corrector as tcorr

L = 160


def _lanes(seed, b, maxe, empty=False):
    """Seeded per-lane results: statuses (the anchor's on both lanes,
    contaminant hits on either), start/end, and logs of 0..maxe entries
    with positions in [-1, L] and metas of a truncation or a substitution
    between codes 0..4 (4 = N)."""
    rng = np.random.default_rng(seed)
    anchor = rng.choice([0, 0, 0, 0, 1, 2], b)
    sf = np.where((anchor == 0) & (rng.random(b) < 0.1), 1, anchor)
    sb = np.where((anchor == 0) & (rng.random(b) < 0.1), 1, anchor)
    n = np.zeros((2, b), np.int32) if empty else \
        rng.integers(0, maxe + 1, (2, b)).astype(np.int32)
    return dict(
        start=rng.integers(-12, L // 2, b).astype(np.int32),
        end=rng.integers(L // 2, L + 1, b).astype(np.int32),
        sf=sf.astype(np.int32), sb=sb.astype(np.int32), n=n,
        lwin=np.zeros((2, b), np.int32),
        pos=rng.integers(-1, L + 1, (2, b, maxe)).astype(np.int32),
        meta=(rng.integers(0, 2, (2, b, maxe))
              | (rng.integers(0, 5, (2, b, maxe)) << 1)
              | (rng.integers(0, 5, (2, b, maxe)) << 4)).astype(np.int32))


def _jax_pack(x, cap):
    merged = np.where(x["sf"] != 0, x["sf"], x["sb"])
    logs = [jcorr.LogState(*(jnp.asarray(x[f][d]) for f in
                             ("n", "lwin", "pos", "meta"))) for d in (0, 1)]
    res = jcorr.BatchResult(jnp.zeros((len(merged), L), jnp.int32),
                            jnp.asarray(x["start"]), jnp.asarray(x["end"]),
                            jnp.asarray(merged), logs[0], logs[1])
    return np.asarray(jcorr._pack_finish_lean(res, cap)), merged


def _port_logs(x):
    return [tcorr.LogState(*(torch.from_numpy(x[f][d]) for f in
                             ("n", "lwin", "pos", "meta"))) for d in (0, 1)]


def _port_pack(x, cap, overflow=0):
    fwd, bwd = _port_logs(x)
    return kernels.pack_finish(
        torch.from_numpy(x["start"]), torch.from_numpy(x["end"]),
        torch.from_numpy(x["sf"]), torch.from_numpy(x["sb"]),
        (fwd.n, fwd.pos, fwd.meta), (bwd.n, bwd.pos, bwd.meta),
        torch.tensor([overflow], dtype=torch.int32), length=L, cap=cap)


def _result(x, buf, status):
    fwd, bwd = _port_logs(x)
    return tcorr.BatchResult(torch.zeros((len(x["start"]), L), dtype=torch.int8),
                             torch.from_numpy(x["start"]),
                             torch.from_numpy(x["end"]), status, fwd, bwd,
                             buf)


@pytest.mark.parametrize("cap", ["exact", "roomy", "short"])
@pytest.mark.parametrize("seed", [1, 2])
def test_plain_pack_finish_matches_jax(seed, cap):
    x = _lanes(seed, 96, 12)
    total = int(x["n"].sum())
    c = {"exact": total, "roomy": 4096, "short": total // 3}[cap]
    want, merged = _jax_pack(x, c)
    buf, status = _port_pack(x, c)
    assert np.array_equal(buf.numpy().view(np.uint32), want)
    assert np.array_equal(status.numpy(), merged)
    assert int(want[1]) == total and int(want[0]) == int(x["n"].max())
    # the forward lane's failure wins; a backward one shows where it is OK
    assert ((x["sf"] == 0) & (x["sb"] == 1)).any()
    assert (status.numpy()[(x["sf"] != 0)] == x["sf"][x["sf"] != 0]).all()


def test_overflow_packs_again_exactly_and_the_cap_only_grows(monkeypatch):
    monkeypatch.setattr(tcorr, "_LEAN_CAP_CACHE", {})
    x = _lanes(3, 512, 24)
    total = int(x["n"].sum())
    cap = 4096  # the re-pack doubles 4096 until the entries fit
    while cap < total:
        cap *= 2
    assert cap > 4096
    short, status = _port_pack(x, total // 2)
    res = _result(x, short, status)
    buf = tcorr.fetch_finish(res)
    want, _merged = _jax_pack(x, cap)
    assert np.array_equal(buf, want)
    assert tcorr._LEAN_CAP_CACHE[(512, 24)] == cap
    codes = np.zeros((512, L), np.int8)
    exact = _result(x, *_port_pack(x, total))
    assert tcorr.finish_batch(res, 512, codes) == \
        tcorr.finish_batch(exact, 512, codes)
    # a later batch that needs less keeps the larger capacity
    small = _lanes(4, 512, 24, empty=True)
    tcorr.fetch_finish(_result(small, *_port_pack(small, 16)))
    assert tcorr._LEAN_CAP_CACHE[(512, 24)] == cap


def test_empty_logs():
    x = _lanes(5, 64, 10, empty=True)
    want, _merged = _jax_pack(x, 128)
    buf, status = _port_pack(x, 128)
    got = buf.numpy().view(np.uint32)
    assert np.array_equal(got, want)
    assert got[0] == 0 and got[1] == 0 and not got[2 + 3 * 64:].any()
    out = tcorr.finish_batch(_result(x, buf, status), 64,
                             np.zeros((64, L), np.int8))
    assert all(r.fwd_log == r.bwd_log == "" for r in out if r.ok)


def test_u16_position_guard_raises():
    x = _lanes(6, 8, 4)
    fwd, bwd = _port_logs(x)
    args = (torch.from_numpy(x["start"]), torch.from_numpy(x["end"]),
            torch.from_numpy(x["sf"]), torch.from_numpy(x["sb"]),
            (fwd.n, fwd.pos, fwd.meta), (bwd.n, bwd.pos, bwd.meta),
            torch.zeros(1, dtype=torch.int32))
    kernels.pack_finish(*args, length=(1 << 15) - 5, cap=64)
    with pytest.raises(ValueError, match="overflows the int16"):
        kernels.pack_finish(*args, length=(1 << 15) - 4, cap=64)


def test_log_overflow_reaches_the_host():
    x = _lanes(7, 32, 6)
    buf, status = _port_pack(x, 256, overflow=1)
    assert int(buf[0]) == 7  # past maxe
    with pytest.raises(RuntimeError, match="log overflow"):
        tcorr.finish_batch(_result(x, buf, status), 32,
                           np.zeros((32, L), np.int8))
