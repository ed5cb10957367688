"""Size arguments with k/M/G/T suffixes (decimal, as the reference's -s
switch and the driver's \\d+[kMGT] check read them)."""

from __future__ import annotations

_SUFFIX = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12}


def parse_size(s: str) -> int:
    """Size with an optional decimal k/M/G/T suffix."""
    s = s.strip()
    if s and s[-1] in _SUFFIX:
        return int(s[:-1]) * _SUFFIX[s[-1]]
    return int(s)
