"""The environment-lever catalog: every ``QUORUM_*`` variable the port
reads, declared in one place (counterpart of quorum_tpu/utils/levers.py,
with the rows of the levers the port reads).

Each lever is declared here with its name, type, default and a one-line
doc, copied from the JAX catalog. Every read inside `quorum_tpu_torch/`
goes through :func:`raw` (or :func:`get_bool`), which refuses a name
the catalog does not declare, so a misspelled lever fails at its read
site instead of silently steering nothing. `tests/test_torch_telemetry.py`
walks the package and fails on a ``QUORUM_*`` read outside this module.

The catalog does not own resolution semantics: sizes take k/M/G/T
suffixes (utils/sizes), and the call sites interpret the raw string as
before.
"""

from __future__ import annotations

import os


class Lever:
    """One declared environment lever: the catalog row."""

    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name: str, type_: str, default: str, doc: str):
        self.name = name
        self.type = type_
        self.default = default
        self.doc = doc


CATALOG: dict[str, Lever] = {}


def _declare(name: str, type_: str, default: str, doc: str) -> None:
    CATALOG[name] = Lever(name, type_, default, doc)


# -- the catalog (alphabetical; the JAX catalog's rows, verbatim) ---------

_declare(
    "QUORUM_FAULT_PLAN", "json", "(none)",
    "Deterministic fault-injection plan (JSON, @file, or path) — the "
    "env fallback behind `--fault-plan`, how subprocesses under test "
    "inherit a plan (utils/faults.py).")
_declare(
    "QUORUM_PREFETCH_QUEUE_BYTES", "size", "1G",
    "Byte budget for the producer prefetch queues (utils/pipeline."
    "prefetch) alongside their count bound: the producer blocks once "
    "queued batches exceed it, so RSS tracks the budget instead of "
    "batch-size x depth.")
_declare(
    "QUORUM_PREFILTER", "str", "off",
    "Default stage-1 singleton-prefilter mode when --prefilter is "
    "'auto': off, two-pass, or inline; env > autotune profile > off "
    "(ops/sketch.prefilter_default).")
_declare(
    "QUORUM_QUALITY_EWMA_ALPHA", "float", "0.2",
    "Smoothing factor for the quality scorecard's EWMA drift "
    "baselines in (0, 1]; higher adapts faster but pages less "
    "(telemetry/quality.py).")
_declare(
    "QUORUM_QUALITY_WINDOW_READS", "int", "2048",
    "Minimum reads_in delta before the quality scorecard closes a "
    "rate window and refreshes the quality_* gauges the drift alert "
    "rules read (telemetry/quality.py).")
_declare(
    "QUORUM_REPLICATE_TABLE_BYTES", "size", "4G",
    "Stage-2 multi-device layout threshold: tables at or under this "
    "replicate per device, bigger ones row-shard with routed "
    "lookups (parallel/tile_sharded.py).")
_declare(
    "QUORUM_SKETCH_BITS", "int", "auto",
    "log2 of the prefilter sketch's two-bit cell count; env > "
    "autotune profile > auto-sized at ~8 cells per expected distinct "
    "mer from -s (ops/sketch.cells_log2_for).")
_declare(
    "QUORUM_TPU_VERBOSE", "bool", "0",
    "Timestamped verbose logging (vlog) for library callers that "
    "never run a CLI parser; the CLIs' --verbose ORs into it.")
_declare(
    "QUORUM_WRITER_QUEUE_BYTES", "size", "256M",
    "Byte budget for the AsyncWriter pending buffer (utils/"
    "pipeline.AsyncWriter) alongside its count bound: submitters "
    "block once queued output text exceeds it.")


# -- readers --------------------------------------------------------------

def raw(name: str, default: str | None = None) -> str | None:
    """The catalogued environment read: ``os.environ.get`` for a
    declared lever; an undeclared name raises KeyError."""
    if name not in CATALOG:
        raise KeyError(f"undeclared lever {name!r}: declare it in "
                       "quorum_tpu_torch/utils/levers.py")
    return os.environ.get(name, default)


def get_bool(name: str, default: bool = False) -> bool:
    """Boolean truthiness: unset/empty -> `default`; "0", "false",
    "no" (any case) -> False; anything else -> True."""
    val = raw(name)
    if val is None or val.strip() == "":
        return default
    return val.strip().lower() not in ("0", "false", "no")


def names() -> list[str]:
    return sorted(CATALOG)
