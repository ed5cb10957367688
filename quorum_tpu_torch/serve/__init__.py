"""The persistent correction service (counterpart of quorum_tpu/serve/,
without the live ingestion tier: ROADMAP Queue 1 item 8).

The offline CLIs pay the full cost of every invocation: load the mer
database, correct, exit. `quorum_tpu_torch.serve` is the warm
alternative: a process that loads the database ONCE and then batches
many small requests onto the card.

* `engine.py`  — CorrectionEngine: a loaded database and the stage-2
  corrector (HK7 to load, HK5, HK16, HK17, HK4's event entry and HK14
  a step), reused across requests at fixed shapes.
* `batcher.py` — DynamicBatcher: a bounded two-lane request queue
  feeding a dispatcher thread that coalesces waiting requests up to
  `--max-batch` reads or `--max-wait-ms`, runs one engine step, and
  demuxes per-request results back through futures; the step watchdog,
  bisection and hedging of a failed batch, engine swaps and drain.
* `server.py`  — the stdlib-HTTP front end: `POST /correct` (FASTQ in,
  corrected FASTA out, byte-identical to the offline CLI), `/healthz`,
  the live `/metrics` exposition, admission control, deadlines, hot
  `POST /reload` with rollback, and graceful drain on SIGTERM or
  `POST /quiesce`.
* `admission.py` — TokenBucketQuota: per-client token buckets keyed on
  the `X-Quorum-Client` header.
* `client.py`  — a minimal stdlib client plus the `quorum-serve-bench`
  closed-loop load generator (`python -m quorum_tpu_torch.serve.client`).

The entry point is `python -m quorum_tpu_torch.cli.serve`.
"""

from .admission import TokenBucketQuota
from .batcher import (PRIORITIES, DeadlineExceeded, Draining,
                      DynamicBatcher, EngineStepTimeout, QueueFull)
from .engine import CorrectionEngine
from .server import CorrectionServer

__all__ = [
    "CorrectionEngine", "DynamicBatcher", "CorrectionServer",
    "QueueFull", "Draining", "DeadlineExceeded", "EngineStepTimeout",
    "TokenBucketQuota", "PRIORITIES",
]
