"""Poisson terms for the ambiguity test and the cutoff computation
(counterpart of quorum_tpu/ops/poisson.py; reference
error_correct_reads.cc:53-61).

The corrector's keep test ``poisson_term(lam, c_ori) < threshold`` is
evaluated in float32 with ``lam = (sum of the 4 kept counts) *
collision_prob``. Both arguments are small bounded integers (the sum is
at most 4 * max_val, c_ori at most max_val), so the port tabulates the
boolean outcome once on the host (`keep_table`) and the kernel and its
plain version read the same table: no float arithmetic runs on the card
and no ULP difference between libraries can move a read.
"""

from __future__ import annotations

import numpy as np

_FACTS = np.array(
    [1, 1, 2, 6, 24, 120, 720, 5040, 40320, 362880, 3628800], dtype=np.float64
)
_TAU = 6.283185307179583


def poisson_term_np(lam: float, i: int) -> float:
    """Host scalar version (float64, matches the reference C++ double)."""
    if i < 11:
        return float(np.exp(-lam) * lam**i / _FACTS[int(i)])
    return float(np.exp(-lam + i) * (lam / i) ** i / np.sqrt(_TAU * i))


def poisson_term_f32(lam, i):
    """float32 term over numpy arrays: the formula of the JAX device
    version (small-i factorial table, Stirling with correction above)."""
    lam = np.asarray(lam, np.float32)
    ii = np.clip(np.asarray(i, np.int64), 0, None)
    facts = _FACTS.astype(np.float32)
    with np.errstate(over="ignore", under="ignore", divide="ignore",
                     invalid="ignore"):
        f_small = (np.exp(-lam) * lam ** ii.astype(np.float32)
                   / facts[np.clip(ii, 0, 10)])
        i_f = np.maximum(ii.astype(np.float32), np.float32(1.0))
        f_big = (np.exp(-lam + i_f) * (lam / i_f) ** i_f
                 / np.sqrt(np.float32(_TAU) * i_f))
    return np.where(ii < 11, f_small, f_big).astype(np.float32)


def keep_table(max_val: int, collision_prob: float,
               threshold: float) -> np.ndarray:
    """uint8 [4*max_val + 1, max_val + 1]: entry [s, c] is 1 iff
    poisson_term(float32(s) * float32(collision_prob), c) < threshold,
    all in float32 as on the JAX device path."""
    s = np.arange(4 * max_val + 1, dtype=np.float32)[:, None]
    c = np.arange(max_val + 1, dtype=np.int64)[None, :]
    lam = s * np.float32(collision_prob)
    term = poisson_term_f32(lam, np.broadcast_to(c, (s.shape[0], c.shape[1])))
    return (term < np.float32(threshold)).astype(np.uint8)


def compute_poisson_cutoff(distinct: int, total: int, collision_prob: float,
                           poisson_threshold: float) -> int:
    """Auto cutoff from DB coverage stats (error_correct_reads.cc:650-668).
    Returns 0 on failure, like the reference."""
    if distinct == 0:
        return 0
    coverage = float(total) / float(distinct)
    lam = coverage * collision_prob
    for x in range(2, 1000):
        if poisson_term_np(lam, x) < poisson_threshold:
            return x + 1
    return 0
