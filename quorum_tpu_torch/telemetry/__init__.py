"""Structured telemetry (counterpart of quorum_tpu/telemetry): the metrics
registry and its JSONL events, span tracing, the quality scorecard,
devtrace and the document schema.

`registry_for(path, heartbeat_s)` is what the CLIs' `--metrics PATH`
builds; with no path it returns the no-op NULL singleton, so disabled
instrumentation costs nothing. `tracer_for(path)` is the same for
`--trace-spans` (spans.py). The documents follow schema.py (version
`quorum-tpu-metrics/1`), the same schema as the JAX package's.
"""

from . import quality
from .quality import QualityScorecard
from .registry import (Counter, Gauge, Histogram, MetricsRegistry, NULL,
                       NullRegistry, atomic_write, labeled,
                       observe_dispatch_wait, registry_for)
from .schema import (SCHEMA_VERSION, check_file, validate_chrome_trace,
                     validate_events_line, validate_metrics,
                     validate_quality, validate_span_line)
from .spans import NULL_TRACER, NullTracer, SpanTracer, tracer_for

__all__ = [
    "quality", "QualityScorecard",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL",
    "NullRegistry", "atomic_write", "labeled", "observe_dispatch_wait",
    "registry_for",
    "SCHEMA_VERSION", "check_file", "validate_chrome_trace",
    "validate_events_line", "validate_metrics", "validate_quality",
    "validate_span_line",
    "NULL_TRACER", "NullTracer", "SpanTracer", "tracer_for",
]
