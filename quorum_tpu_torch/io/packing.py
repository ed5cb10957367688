"""Bit-packed read transport (counterpart of quorum_tpu/io/packing.py).

Both stages use a base's quality only as one predicate ``qual >= t``,
so a batch crosses to the card as 2 bits/base of sequence, 1 bit/base
of N mask and 1 bit/base per quality threshold, fused into ONE u8
buffer: ``pcodes | nmask | hq planes (ascending threshold) | lengths
(little-endian u8x4)`` — byte-identical to the JAX package's wire.
The card widens it back (ops/mer.unpack_codes / unpack_bits, or HK1
directly from the wire).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PackedReads:
    """Wire-format read batch. `hq[t]` is the 1-bit plane of
    ``qual >= t`` for each threshold t requested at pack time."""

    pcodes: np.ndarray   # uint8 [B, ceil(L/4)], base i at bits 2*(i%4)
    nmask: np.ndarray    # uint8 [B, ceil(L/8)], bit: code < 0
    hq: dict             # {threshold: uint8 [B, ceil(L/8)]}
    lengths: np.ndarray  # int32 [B]
    length: int          # L (unpacked row width)
    _wire: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_reads(self) -> int:
        return self.pcodes.shape[0]

    @property
    def thresholds(self) -> tuple:
        return tuple(sorted(self.hq))

    def require_plane(self, threshold: int) -> None:
        if int(threshold) not in self.hq:
            raise KeyError(
                f"packed batch lacks the qual>={threshold} plane "
                f"(has {sorted(self.hq)})")

    def to_wire(self) -> np.ndarray:
        """Every plane in ONE flat u8 buffer (cached)."""
        if self._wire is None:
            parts = [self.pcodes.reshape(-1), self.nmask.reshape(-1)]
            parts += [self.hq[t].reshape(-1) for t in self.thresholds]
            parts.append(np.ascontiguousarray(self.lengths, np.int32)
                         .view(np.uint8))
            self._wire = np.concatenate(parts)
        return self._wire


def pack_reads(codes: np.ndarray, quals: np.ndarray, lengths: np.ndarray,
               thresholds=()) -> PackedReads:
    """Pack int8 codes [B, L] (-1 non-ACGT, -2 pad) + uint8 quals
    [B, L] into the wire format, with one predicate plane per entry of
    `thresholds`."""
    codes = np.asarray(codes, np.int8)
    b, l = codes.shape
    c = np.clip(codes, 0, 3).astype(np.uint8)
    pad4 = (-l) % 4
    if pad4:
        c = np.pad(c, ((0, 0), (0, pad4)))
    c = c.reshape(b, -1, 4)
    pcodes = (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
              | (c[:, :, 3] << 6)).astype(np.uint8)
    nmask = np.packbits(codes < 0, axis=1, bitorder="little")
    q = np.asarray(quals, np.uint8)
    hq = {int(t): np.packbits(q >= t, axis=1, bitorder="little")
          for t in thresholds}
    return PackedReads(pcodes=pcodes, nmask=nmask, hq=hq,
                       lengths=np.asarray(lengths, np.int32), length=l)


def from_wire(wire: np.ndarray, b: int, length: int,
              thresholds) -> PackedReads:
    """The PackedReads whose to_wire() is `wire` (b rows of width
    `length`, one plane a threshold): the planes are views of it, in
    the wire's order (a replay-cache batch, io/checkpoint)."""
    wire = np.asarray(wire, np.uint8)
    c4, c8 = (length + 3) // 4, (length + 7) // 8
    sizes = [b * c4, b * c8] + [b * c8 for _ in thresholds] + [4 * b]
    if sum(sizes) != wire.shape[0]:
        raise ValueError(f"a wire of {wire.shape[0]} bytes is not {b} "
                         f"rows of width {length} with "
                         f"{len(thresholds)} planes")
    parts = np.split(wire, np.cumsum(sizes)[:-1])
    return PackedReads(
        pcodes=parts[0].reshape(b, c4), nmask=parts[1].reshape(b, c8),
        hq={int(t): p.reshape(b, c8)
            for t, p in zip(sorted(thresholds), parts[2:-1])},
        lengths=parts[-1].view(np.int32), length=length, _wire=wire)


def split_rows(pk: PackedReads, n: int) -> list[PackedReads]:
    """The batch's rows in `n` equal contiguous ranges, each a packed
    batch of its own with every plane of `pk` (a shard's reads under
    --devices N, as each shard of the JAX package's mesh widens its row
    range of the wire). The batch's rows must divide by n."""
    b = pk.n_reads
    if n < 1 or b % n:
        raise ValueError(f"batch rows {b} not divisible by {n} shards — "
                         "round --batch-size up to a multiple of --devices")
    step = b // n
    return [PackedReads(pcodes=pk.pcodes[i:i + step],
                        nmask=pk.nmask[i:i + step],
                        hq={t: p[i:i + step] for t, p in pk.hq.items()},
                        lengths=pk.lengths[i:i + step], length=pk.length)
            for i in range(0, b, step)]
