"""The port's minimizer (K23: quorum_tpu_torch/ops/mer.minimizer_kmers,
HK21's plain version) on the CPU against the JAX package's
mer.minimizer_kmers and the host twins minimizer_py. Seeded numpy reads
with Ns, a short read (past its length the parser's -2 padding) and
one long run of one base; exact (integer) comparisons."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from quorum_tpu.ops import mer as jmer
from quorum_tpu_torch.ops import mer as tmer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, size=(24, 90)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.02] = -1  # Ns
    codes[3, 30:] = -2  # a 30-base read
    codes[4, 8:] = -2  # a read shorter than every k below
    codes[5, :] = 0  # poly-A
    return codes


@pytest.mark.parametrize("k,m", [(24, 7), (15, 15), (9, 1)])
def test_minimizer_matches_jax(reads, k, m):
    jv, jk = jax.jit(jmer.minimizer_kmers, static_argnums=(1, 2))(
        jnp.asarray(reads), k, m)
    tv, tk = tmer.minimizer_kmers(torch.from_numpy(reads), k, m)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy().view(np.uint32), np.asarray(jv))
    assert tk.any() and not tk[4].any()
    assert (tv.numpy().view(np.uint32)[~tk.numpy()] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("k,m", [(24, 7), (13, 5)])
def test_minimizer_matches_the_host_twins(reads, k, m):
    tv, tk = tmer.minimizer_kmers(torch.from_numpy(reads), k, m)
    vals = tv.numpy().view(np.uint32)
    checked = 0
    for r in range(reads.shape[0]):
        for p in np.nonzero(tk[r].numpy())[0][::5]:
            seq = "".join("ACGT"[c] for c in reads[r, p - k + 1:p + 1])
            assert tmer.minimizer_py(seq, m) == jmer.minimizer_py(seq, m) \
                == int(vals[r, p])
            checked += 1
    assert checked > 50


@pytest.mark.parametrize("m", [0, 16, 25])
def test_bad_m_is_refused_with_jax_message(reads, m):
    with pytest.raises(ValueError) as jerr:
        jmer.minimizer_kmers(jnp.asarray(reads), 24, m)
    with pytest.raises(ValueError) as terr:
        tmer.minimizer_kmers(torch.from_numpy(reads), 24, m)
    assert str(terr.value) == str(jerr.value)
