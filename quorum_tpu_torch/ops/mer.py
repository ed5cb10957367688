"""2-bit packed k-mer arithmetic on torch tensors (counterpart of
quorum_tpu/ops/mer.py).

A k-mer (k <= 31) is a 2k-bit integer held in ONE int64 (at most 62
bits, so it never reaches the sign bit). ``shift_left`` appends the new
base at the least-significant 2 bits, so integer order is lexicographic
order and ``canonical = min(fwd, revcomp)``. Base codes: A=0, C=1, G=2,
T=3, complement(x) = 3-x, non-ACGT = -1, padding past a read = -2.

Direction-generic helpers take ``d`` = +1 (5'->3') or -1 (3'->5') as a
tensor of per-lane directions, so one lockstep loop can step both
extension directions at once.
"""

from __future__ import annotations

import numpy as np
import torch

_CODE_TABLE = np.full(256, -1, dtype=np.int8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _CODE_TABLE[ord(_c)] = _v
    _CODE_TABLE[ord(_c.lower())] = _v


def seq_to_codes(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> int8 code array (-1 for non-ACGT)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _CODE_TABLE[np.frombuffer(seq, dtype=np.uint8)]


MAX_K = 31


# ------------------------------------------------- host helpers (Python ints)
# k-mers as (hi, lo) unsigned 32-bit halves held in Python ints, for the
# inspection CLIs (quorum_tpu/ops/mer.py:60-100).

def pack_kmer(seq: str, k: int | None = None) -> tuple[int, int]:
    """String of ACGT -> (hi, lo) u32 halves. The leftmost base is the
    most significant (base index k - 1), as repeated shift_left."""
    k = len(seq) if k is None else k
    assert len(seq) == k <= MAX_K
    v = 0
    for ch in seq:
        code = int(_CODE_TABLE[ord(ch)])
        assert code >= 0, f"non-ACGT base {ch!r}"
        v = (v << 2) | code
    return (v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF


def unpack_kmer(hi: int, lo: int, k: int) -> str:
    v = (int(hi) << 32) | int(lo)
    return "".join("ACGT"[(v >> (2 * (k - 1 - i))) & 3] for i in range(k))


def revcomp_py(hi: int, lo: int, k: int) -> tuple[int, int]:
    v = (int(hi) << 32) | int(lo)
    r = 0
    for _ in range(k):
        r = (r << 2) | (3 - (v & 3))
        v >>= 2
    return (r >> 32) & 0xFFFFFFFF, r & 0xFFFFFFFF


def canonical_py(hi: int, lo: int, k: int) -> tuple[int, int]:
    """min(fwd, revcomp) of a (hi, lo) k-mer, compared unsigned."""
    rhi, rlo = revcomp_py(hi, lo, k)
    m = min((int(hi) << 32) | int(lo), (rhi << 32) | rlo)
    return (m >> 32) & 0xFFFFFFFF, m & 0xFFFFFFFF


def mer_mask(k: int) -> int:
    return (1 << (2 * k)) - 1


def canonical(f: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """min(fwd, revcomp) (src/kmer.hpp:43)."""
    return torch.minimum(f, r)


def dir_shift(f, r, code, d, k: int):
    """Shift `code` in at the direction of travel d (per lane); the
    revcomp lane takes the complement at the opposite end."""
    mask = mer_mask(k)
    top = 2 * k - 2
    fwd = d > 0
    nf = torch.where(fwd, ((f << 2) | code) & mask, (f >> 2) | (code << top))
    nr = torch.where(fwd, (r >> 2) | ((3 - code) << top),
                     ((r << 2) | (3 - code)) & mask)
    return nf, nr


def _base_index(d, k: int):
    return torch.where(d > 0, 0, k - 1)


def dir_base0(f, d, k: int):
    """Code of the most recently shifted-in base in direction d."""
    return (f >> (2 * _base_index(d, k))) & 3


def dir_replace0(f, r, code, d, k: int):
    """Replace base 0 (direction d) in both lanes."""
    i = _base_index(d, k)
    ri = (k - 1) - i
    nf = (f & ~(3 << (2 * i))) | (code << (2 * i))
    nr = (r & ~(3 << (2 * ri))) | ((3 - code) << (2 * ri))
    return nf, nr


def _shift_cols(x: torch.Tensor, j: int) -> torch.Tensor:
    """out[:, p] = x[:, p - j], zero where p < j."""
    if j == 0:
        return x
    out = torch.zeros_like(x)
    out[:, j:] = x[:, :-j]
    return out


def rolling_kmers(codes: torch.Tensor, k: int):
    """Every k-mer window of a [B, L] code batch, built from k shifted
    taps: the base at p-j lands at bit 2j of the forward mer and bit
    2(k-1-j) of the reverse complement. Positions before the window
    fills see zero taps and non-ACGT bases enter as code 0, exactly as
    quorum_tpu.ops.mer.rolling_kmers. Returns (f, r) int64 [B, L] and
    valid bool [B, L] (window holds k consecutive ACGT bases)."""
    b, l = codes.shape
    ok = codes >= 0
    c = torch.where(ok, codes, 0).to(torch.int64)
    rc = 3 - c
    f = torch.zeros((b, l), dtype=torch.int64, device=codes.device)
    r = torch.zeros_like(f)
    for j in range(k):
        f |= _shift_cols(c, j) << (2 * j)
        r |= _shift_cols(rc, j) << (2 * (k - 1 - j))
    return f, r, run_at_least(~ok, k)


def run_at_least(reset: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] bool: at least k positions since the last `reset` (or the
    row start) up to and including p."""
    b, l = reset.shape
    pos = torch.arange(l, device=reset.device).expand(b, l)
    last = torch.cummax(torch.where(reset, pos, -1), dim=1).values
    return (pos - last) >= k


# ------------------------------------------------- packed-wire widening
# Counterparts of mer.wire_parts_device / unpack_codes_device /
# synth_quals_device: the fused u8 wire (io/packing.PackedReads.to_wire)
# widened back to codes and the qual>=threshold predicate plane.


def wire_parts(wire: torch.Tensor, b: int, length: int, thresholds):
    """Slice the fused wire into (pcodes, nmask, {t: hq_plane},
    lengths) views. Layout: pcodes | nmask | hq planes (ascending
    threshold) | lengths as little-endian u8x4."""
    c4 = -(-length // 4)
    c8 = -(-length // 8)
    o = 0
    pcodes = wire[o:o + b * c4].view(b, c4)
    o += b * c4
    nmask = wire[o:o + b * c8].view(b, c8)
    o += b * c8
    hq = {}
    for t in sorted(int(x) for x in thresholds):
        hq[t] = wire[o:o + b * c8].view(b, c8)
        o += b * c8
    lb = wire[o:o + 4 * b].view(b, 4).to(torch.int32)
    lengths = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)
    return pcodes, nmask, hq, lengths


def unpack_bits(plane: torch.Tensor, length: int) -> torch.Tensor:
    """uint8 [B, ceil(L/8)] -> bool [B, L] (little bit order)."""
    shifts = torch.arange(8, device=plane.device, dtype=torch.int32)
    y = (plane.to(torch.int32)[:, :, None] >> shifts) & 1
    return y.reshape(plane.shape[0], -1)[:, :length].bool()


def unpack_codes(pcodes, nmask, lengths, length: int) -> torch.Tensor:
    """Wire planes -> int8 codes: 0..3 bases, -1 at N-mask bits, -2 at
    and after each row's length."""
    shifts = torch.tensor([0, 2, 4, 6], device=pcodes.device,
                          dtype=torch.int32)
    y = (pcodes.to(torch.int32)[:, :, None] >> shifts) & 3
    codes = y.reshape(pcodes.shape[0], -1)[:, :length].to(torch.int8)
    codes = torch.where(unpack_bits(nmask, length), -1, codes)
    pos = torch.arange(length, device=pcodes.device)[None, :]
    return torch.where(pos >= lengths[:, None], -2, codes).to(torch.int8)


# ------------------------------------------------- minimizers (K23)
# KMC 2's bin key (arxiv 1407.1507), quorum_tpu/ops/mer.py:246-328.

MAX_MINIMIZER_M = 15  # 2m <= 30 bits: one u32 value per m-mer


def _mix32_mer(x: torch.Tensor) -> torch.Tensor:
    """The invertible 32-bit mix that orders m-mers (int64 holding u32
    values; every product taken mod 2^32 without leaving int64): the raw
    lexicographic order is skewed (poly-A wins most windows), the mix
    gives a pseudo-random total order with the same semantics."""

    def mul32(v, c: int):
        return ((v * (c & 0xFFFF)) + (((v * (c >> 16)) & 0xFFFF) << 16)) \
            & 0xFFFFFFFF

    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def minimizer_kmers(codes: torch.Tensor, k: int, m: int):
    """Canonical m-mer minimizer of every k-window of an int8 code batch
    [B, L] (HK21 on the card, its plain version on the CPU): at position
    p (the window of bases [p-k+1, p]) the minimum over the window's
    k - m + 1 m-mers of mix32(min(fwd m-mer, revcomp m-mer)), a mixed
    value equal to 0xFFFFFFFF pinned to 0xFFFFFFFE. Returns (minval
    int32 [B, L] holding the u32 values, kvalid bool [B, L]: the window
    holds k consecutive ACGT bases); 0xFFFFFFFF where not kvalid."""
    from .. import kernels

    if not 1 <= m <= min(k, MAX_MINIMIZER_M):
        raise ValueError(f"minimizer m={m} must be in [1, "
                         f"min(k, {MAX_MINIMIZER_M})]")
    return kernels.minimizer(codes, k, m)


def minimizer_py(seq: str, m: int) -> int:
    """Host twin for one k-mer string: the mixed canonical m-mer
    minimizer (minimizer_kmers' value at the window's last position)."""
    k = len(seq)
    assert 1 <= m <= min(k, MAX_MINIMIZER_M)
    codes = seq_to_codes(seq)
    assert (codes >= 0).all(), f"non-ACGT base in {seq!r}"
    best = 0xFFFFFFFF
    for i in range(k - m + 1):
        f = r = 0
        for c in codes[i:i + m].tolist():
            f = (f << 2) | c
        for c in codes[i:i + m][::-1].tolist():
            r = (r << 2) | (3 - c)
        v = int(_mix32_mer(torch.tensor(min(f, r), dtype=torch.int64)))
        best = min(best, 0xFFFFFFFE if v == 0xFFFFFFFF else v)
    return best
