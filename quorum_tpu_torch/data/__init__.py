"""Built-in contaminant data: the Illumina adapter set (counterpart of
quorum_tpu/data/__init__.py).

The reference ships `data/adapter.fa` and builds `data/adapter.jf` from
it with `jellyfish count -m 24 -s 5k -C` (Makefile.am:50-56) for the
corrector's `--contaminant`. Its FASTA holds the standard Illumina
TruSeq/PE adapter and primer sequences and every single-base
substitution variant of each, so one sequencing error in an adapter
still hits. This module keeps the canonical sequences and regenerates
the expansion; `adapter_fasta()` writes it, and `--contaminant` takes
the FASTA directly (io/contaminant), so `--contaminant $(python -m
quorum_tpu_torch.data)` runs the reference's workflow.
"""

from __future__ import annotations

import hashlib
import os

# Standard Illumina adapter / sequencing-primer sequences (public
# Illumina documentation): TruSeq universal/indexed adapter stems, the
# PE flow-cell P5/P7-extended primers and the multiplexing read-2
# primer region.
ADAPTERS = (
    "GATCGGAAGAGCTCGTATGCCGTCTTCTGCTTG",
    "ACACTCTTTCCCTACACGACGCTCTTCCGATCT",
    "AATGATACGGCGACCACCGAGATCTACACTCTTTCCCTACACGACGCTCTTCCGATCT",
    "CAAGCAGAAGACGGCATACGAGCTCTTCCGATCT",
    "GATCGGAAGAGCGGTTCAGCAGGAATGCCGAG",
    "CAAGCAGAAGACGGCATACGAGATCGGTCTCGGCATTCCTGCTGAACCGCTCTTCCGATCT",
    "CGGTCTCGGCATTCCTGCTGAACCGCTCTTCCGATCT",
)


def adapter_records():
    """Yield (header, sequence) for the error-tolerant set: each
    canonical adapter ("1".."7"), then every 1-substitution variant
    ("v0".."vN"), each sequence once, originals first."""
    seen = set()
    for i, s in enumerate(ADAPTERS):
        if s not in seen:
            seen.add(s)
            yield str(i + 1), s
    n = 0
    for s in ADAPTERS:
        for j, c in enumerate(s):
            for x in "ACGT":
                if x == c:
                    continue
                v = s[:j] + x + s[j + 1:]
                if v in seen:
                    continue
                seen.add(v)
                yield f"v{n}", v
                n += 1


def adapter_fasta(path: str | None = None) -> str:
    """Write the adapter FASTA to `path` and return it. Without a path
    it goes to ~/.cache/quorum_tpu_torch/adapters-<digest>.fa, the
    digest being that of the content, and an existing file is reused."""
    text = "".join(f">{h}\n{s}\n" for h, s in adapter_records())
    if path is None:
        digest = hashlib.sha256(text.encode()).hexdigest()[:10]
        cache = os.path.expanduser("~/.cache/quorum_tpu_torch")
        os.makedirs(cache, exist_ok=True)
        path = os.path.join(cache, f"adapters-{digest}.fa")
        if os.path.exists(path):
            return path
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path
