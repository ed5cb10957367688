"""Timestamped verbose logging, gated by --verbose (counterpart of
quorum_tpu/utils/vlog.py).

The reference's vlog (src/verbose_log.hpp:26-63): "[YYYY/MM/DD
HH:MM:SS] message" on stderr when enabled. Library callers that run no
CLI parser enable it with the QUORUM_TPU_VERBOSE environment variable
(any value but empty, 0, false or no); the CLIs' --verbose and --debug
flags OR into it and never turn it off.
"""

from __future__ import annotations

import sys
import time

from . import levers

verbose = levers.get_bool("QUORUM_TPU_VERBOSE")


def vlog(*parts) -> None:
    if not verbose:
        return
    stamp = time.strftime("[%Y/%m/%d %H:%M:%S]")
    print(stamp, "".join(str(p) for p in parts), file=sys.stderr, flush=True)
