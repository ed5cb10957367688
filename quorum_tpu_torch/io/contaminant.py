"""Contaminant k-mer sets (counterpart of quorum_tpu/io/contaminant.py).

The reference loads a Jellyfish `binary_dumper` database into a mer set
(contaminant_database, error_correct_reads.cc:66-99, :693-708). The
port accepts, in this order: one of the port's or the JAX package's
`binary/quorum_tpu_db` files or a reference `binary/quorum_db` file
(io/db_format.load_db); a Jellyfish `binary_dumper` file (io/jf_binary,
placed through ctable.tile_from_entries); else a FASTA/FASTQ file of
contaminant sequences, counted on the device by stage 1's own build.
Either way the result is a sealed table on the device whose value word
is nonzero exactly for member mers; the corrector's kernels probe it
beside the main table.
"""

from __future__ import annotations

import json

import numpy as np

from . import db_format, jf_binary, quorum_db


def _is_quorum_db(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            line = f.readline(1 << 16)
        return json.loads(line).get("format") == db_format.FORMAT
    except (OSError, ValueError, UnicodeDecodeError, AttributeError):
        return False


def _check_k(got: int, k: int) -> None:
    if got != k:
        raise ValueError(
            f"Contaminant mer length ({got}) different than correction "
            f"mer length ({k})")


def build_kmer_set(paths, k: int, device):
    """Count every canonical k-mer of the sequence files into a
    membership table: stage 1's build (HK1, HK2, HK8 if it grows) with
    bits=1 and qual_thresh=0 (every base high quality: only window
    validity matters for membership). Returns (TileState, TileMeta)."""
    from ..models.create_database import BuildConfig, build_database

    cfg = BuildConfig(k=k, bits=1, qual_thresh=0,
                      initial_size=1 << 16, batch_size=512)
    state, meta, _stats = build_database(list(paths), cfg, device)
    return state, meta


def load_contaminant(path: str, k: int, device):
    """The contaminant set of `path` for correction at mer length k, on
    `device`. Returns (TileState, TileMeta); raises ValueError on a k
    mismatch (the reference's message, error_correct_reads.cc:703-705)."""
    from ..ops import ctable

    if _is_quorum_db(path) or quorum_db.is_ref_db(path):
        state, meta, _header, _stats = db_format.load_db(path, device=device)
        _check_k(meta.k, k)
        return state, meta
    if jf_binary.is_jf_binary(path):
        khi, klo, counts, kk = jf_binary.read_jf_binary(path)
        _check_k(kk, k)
        vals = np.where(counts > 0, 2, 0).astype(np.uint32)  # member bit
        state, meta, _stats = ctable.tile_from_entries(khi, klo, vals, k, 7,
                                                       device)
        return state, meta
    return build_kmer_set([path], k, device)
