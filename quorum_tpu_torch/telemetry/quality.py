"""A copy of quorum_tpu/telemetry/quality.py (the arithmetic unchanged,
so the port's `quality` section equals JAX's byte for byte).

Correction-quality scorecard: data-plane telemetry for the
*product*.

Every observability tier before this one watched the machine —
latency, kernels, alerts, crashes — while "did we correct reads
well?" was three scalar counters. This module turns the per-read
outcome tallies the render path already produces
(models/error_correct.render_result -> record_outcome, the single
choke point shared by the offline drain loop and the serve engine)
into distributions and drift signals:

* a substitution-position spectrum per read cycle (fixed-cardinality
  bucketed via :func:`bounded` — the classic Illumina 3'-decay
  signature is a rising tail in the last buckets);
* 3'/5' truncation-cycle histograms (the cut position of each
  ``pos:3_trunc`` / ``pos:5_trunc`` edit-log entry; for a 3' cut the
  cycle IS the surviving read length, so the histogram doubles as a
  truncation-length distribution);
* the skip-reason breakdown (one ``skipped_<slug>`` counter per
  ``REASON_SLUGS`` entry, pre-created so zeros land — the PR-7
  zero-count lesson);
* data-plane rates per batch window — corrections/read, skip rate,
  truncation rate, contaminant-hit rate, anchor (trusted-k-mer hit)
  rate vs the coverage the DB header's ``poisson_stats`` predicts —
  with EWMA drift scores feeding the default drift alert rules
  (``quality_drift`` / ``contam_spike`` / ``coverage_drop``,
  telemetry/alerts.DEFAULT_QUALITY_RULES).

Two read surfaces:

* **live** — the ``quality_*`` gauges a :class:`QualityScorecard`
  refreshes on the heartbeat cadence (windowed rates + drift score),
  which the alert engine evaluates and the flight ring
  snapshots when a ``dump: true`` rule fires;
* **final** — the ``quality`` section of every final metrics
  document, computed by :func:`section_from_doc` as a PURE function
  of the document's own counters/histograms — no wall-clock inputs —
  so two runs over the same input produce byte-identical sections
  (the determinism `tools/quality_diff.py` gates CI on).
"""

from __future__ import annotations

import math
import threading
import time

from ..utils import levers

# the quality section's own schema stamp (telemetry/schema.py
# validates the shape; tools/quality_diff.py keys its extraction on it)
QUALITY_SCHEMA = "quorum-tpu-quality/1"

# Fixed-cardinality position bucketing (satellite: no unbounded
# label/value cardinality reaches Prometheus exposition). 64 buckets
# of 8 cycles cover reads up to 512 cycles; longer reads fold their
# tail into the last bucket — well inside Histogram.MAX_KEYS (512).
SPECTRUM_BUCKETS = 64
SPECTRUM_CYCLES_PER_BUCKET = 8

# the live gauges a scorecard pre-creates (telemetry/contract.py
# QUALITY_GAUGES mirrors this — keep in sync, quorum-lint insists on
# the catalogs, metrics_check requires them when meta.quality is set)
RATE_GAUGES = ("quality_corrections_per_read", "quality_skip_rate",
               "quality_trunc_rate", "quality_contam_rate")
# pre-created at their QUIET values: anchor/coverage start at 1.0 so
# the `coverage_drop` rule (fires on `< 0.5`) cannot page before the
# first data window
UNIT_GAUGES = ("quality_anchor_rate", "quality_coverage_ratio")
DRIFT_GAUGE = "quality_drift_score"

# the cumulative outcome counters a window samples (all pre-created
# by models/error_correct.precreate_outcome_counters)
_WINDOW_COUNTERS = ("reads_in", "reads_corrected", "reads_skipped",
                    "substitutions", "truncations_3p",
                    "truncations_5p", "skipped_contaminant",
                    "skipped_no_anchor")


def bounded(value, cap) -> int:
    """THE shared bucketing clamp: a non-negative int no greater than
    `cap`. Reused by the substitution-position spectrum, the
    truncation-cycle histograms, and the `substitutions_per_read`
    value bound at the config `maxe` — one helper so no surface can
    drift into unbounded cardinality."""
    v = int(value)
    cap = int(cap)
    if v < 0:
        return 0
    return cap if v > cap else v


def position_bucket(pos) -> int:
    """Read-cycle position -> fixed spectrum bucket (the per-cycle
    substitution spectrum's x axis)."""
    return bounded(int(pos) // SPECTRUM_CYCLES_PER_BUCKET,
                   SPECTRUM_BUCKETS - 1)


def _ratio(num, den) -> float:
    return round(float(num) / float(den), 6) if den else 0.0


def _sorted_counts(hist: dict | None) -> dict:
    """A histogram `counts` map re-keyed deterministically: numeric
    keys ascending, the cardinality-guard "overflow" key last."""
    if not hist:
        return {}
    counts = hist.get("counts", {})

    def key(kv):
        k = kv[0]
        try:
            return (0, int(k), "")
        except (TypeError, ValueError):
            return (1, 0, str(k))

    return {str(k): int(n) for k, n in sorted(counts.items(), key=key)}


def predicted_anchor_rate(coverage_mean: float) -> float:
    """The anchor-rate the DB header's coverage statistics predict: a
    mer drawn from the sequenced genome is trusted unless its site
    went unsampled, so P(a read finds at least one trusted anchor
    k-mer) >= 1 - e^-c for mean high-quality coverage c (Poisson
    sampling; a lower bound because a read holds many mers). The
    `coverage_drop` rule compares the OBSERVED anchor rate to this."""
    c = float(coverage_mean)
    if c <= 0:
        return 0.0
    return round(1.0 - math.exp(-c), 6)


def section_from_doc(doc: dict) -> dict:
    """The `quality` section, derived from a final metrics document's
    own counters/histograms/meta — a PURE function with no wall-clock
    inputs, so two deterministic runs produce byte-identical sections
    (what `tools/quality_diff.py` and the golden tests compare)."""
    c = doc.get("counters", {})
    h = doc.get("histograms", {})
    meta = doc.get("meta", {})
    reads = int(c.get("reads_in", 0))
    corrected = int(c.get("reads_corrected", 0))
    skipped = int(c.get("reads_skipped", 0))
    subs = int(c.get("substitutions", 0))
    t3 = int(c.get("truncations_3p", 0))
    t5 = int(c.get("truncations_5p", 0))
    no_anchor = int(c.get("skipped_no_anchor", 0))
    skip_reasons = {k[len("skipped_"):]: int(v)
                    for k, v in sorted(c.items())
                    if k.startswith("skipped_")}
    section = {
        "schema": QUALITY_SCHEMA,
        "reads": reads,
        "corrected": corrected,
        "skipped": skipped,
        "substitutions": subs,
        "truncations_3p": t3,
        "truncations_5p": t5,
        "rates": {
            "anchor_rate": (round(1.0 - no_anchor / reads, 6)
                            if reads else 1.0),
            "contam_rate": _ratio(c.get("skipped_contaminant", 0),
                                  reads),
            "corrections_per_read": _ratio(subs, corrected),
            "skip_rate": _ratio(skipped, reads),
            "trunc_rate_3p": _ratio(t3, corrected),
            "trunc_rate_5p": _ratio(t5, corrected),
        },
        "skip_reasons": skip_reasons,
        "spectrum_cycles_per_bucket": SPECTRUM_CYCLES_PER_BUCKET,
        "sub_pos_spectrum": _sorted_counts(h.get("sub_pos_bucket")),
        "substitutions_per_read":
            _sorted_counts(h.get("substitutions_per_read")),
        "trunc_cycle_3p": _sorted_counts(h.get("trunc_cycle_3p")),
        "trunc_cycle_5p": _sorted_counts(h.get("trunc_cycle_5p")),
    }
    cm = meta.get("coverage_mean")
    if isinstance(cm, (int, float)) and not isinstance(cm, bool) \
            and cm > 0:
        section["coverage"] = {
            "predicted_mean": round(float(cm), 4),
            "predicted_anchor_rate": predicted_anchor_rate(cm),
        }
    return section


def summarize_results(results) -> dict:
    """A per-request quality summary derived from the (fa_text,
    log_text) render pairs the serve engine returns — the
    ``X-Quorum-Quality`` response header's payload and the request
    ledger's quality fields. Counting ``:sub:`` etc. in the rendered
    text is exact: the edit-log entries live in the `.fa` header
    lines and colons cannot appear in sequence data, so the header
    sums reconcile against the final document's outcome counters
    (the serve/offline parity check)."""
    corrected = skipped = subs = t3 = t5 = 0
    for fa, lg in results:
        if lg:
            # render_result's contract: skipped reads are exactly the
            # ones that contribute a `.log` line (no-discard reads
            # also emit a placeholder `.fa` record, so `fa` alone
            # cannot classify)
            skipped += 1
        else:
            corrected += 1
            subs += fa.count(":sub:")
            t3 += fa.count(":3_trunc")
            t5 += fa.count(":5_trunc")
    return {"reads": len(results), "corrected": corrected,
            "skipped": skipped, "subs": subs, "t3": t3, "t5": t5}


def coverage_from_histo(bins) -> float:
    """Fit the mean trusted-mer coverage from a mer-count histogram
    (`quorum_histo_mer_database --json` sidecar rows:
    ``[count, n_lowqual, n_highqual]``): the high-quality spectrum's
    mode PAST the first valley — the error/signal split every k-mer
    spectrum shows (errors pile up at count 1-2, real coverage peaks
    near c). Returns 0.0 when no valley exists (error-dominated or
    flat histograms), so callers fall back to the header's
    `poisson_stats`."""
    hq: dict[int, int] = {}
    for row in bins or ():
        count, _low, high = int(row[0]), int(row[1]), int(row[2])
        if count > 0 and high > 0:
            hq[count] = hq.get(count, 0) + high
    if not hq:
        return 0.0
    xs = sorted(hq)
    valley = None
    for a, b in zip(xs, xs[1:]):
        if hq[b] > hq[a]:
            valley = a
            break
    if valley is None:
        return 0.0
    past = [x for x in xs if x > valley]
    mode = max(past, key=lambda x: (hq[x], -x))
    return float(mode)


class QualityScorecard:
    """The live half: windowed data-plane rates + EWMA drift scores
    over ONE registry's outcome counters.

    Installed by `cli/observability.observability()` on every enabled
    registry (all four entry points). Hooks:

    * `registry.quality = self` — `MetricsRegistry.as_dict` calls
      :meth:`snapshot_from` so every final document carries the
      `quality` section;
    * `registry.add_exporter` — :meth:`tick` runs on the heartbeat
      cadence (and once at the final write), closing a rate window
      whenever at least `window_reads` new reads arrived and
      refreshing the `quality_*` gauges the drift alert rules read.

    `now` is injectable for mocked-clock tests (the AlertEngine
    precedent); `alpha`/`window_reads` default to the
    ``QUORUM_QUALITY_*`` levers.
    """

    def __init__(self, registry, alpha: float | None = None,
                 window_reads: int | None = None, now=time.monotonic):
        self.registry = registry
        self._now = now
        if alpha is None:
            raw = levers.raw("QUORUM_QUALITY_EWMA_ALPHA")
            alpha = float(raw) if raw else 0.2
        if window_reads is None:
            raw = levers.raw("QUORUM_QUALITY_WINDOW_READS")
            window_reads = int(raw) if raw else 2048
        if not 0.0 < alpha <= 1.0:
            raise ValueError("EWMA alpha must be in (0, 1]")
        self.alpha = float(alpha)
        self.window_reads = max(1, int(window_reads))
        self._lock = threading.Lock()
        self._prev: dict[str, int] = {}
        self._ewma: dict[str, float] = {}
        self.windows = 0
        reg = registry
        if getattr(reg, "enabled", False):
            # the gauge surface exists from setup (zeros / quiet
            # values included) so metrics_check can require the names
            # whenever meta declares the scorecard installed
            for g in RATE_GAUGES:
                reg.gauge(g).set(0)
            for g in UNIT_GAUGES:
                reg.gauge(g).set(1.0)
            reg.gauge(DRIFT_GAUGE).set(0)
            reg.set_meta(quality=True)
            reg.quality = self
            reg.add_exporter(self._exporter)

    # -- final-document hook ----------------------------------------------
    def snapshot_from(self, sections: dict) -> dict:
        """Called by MetricsRegistry.as_dict with the already-built
        document sections (under the registry lock — this must not
        call back into registry accessors)."""
        return section_from_doc(sections)

    # -- live windowing ---------------------------------------------------
    def _exporter(self, reg, final: bool = False) -> None:
        self.tick(final=final)

    def _read(self, name: str) -> int:
        # direct map read, no get-or-create: the alerts._read_metric
        # precedent — a tick must not materialize absent counters
        m = self.registry._counters.get(name)
        return 0 if m is None else int(m.value)

    def tick(self, final: bool = False) -> bool:
        """Close a rate window if enough reads arrived (always, at
        the final write, when any arrived): refresh the windowed
        `quality_*` gauges, fold the window into the EWMA baselines,
        and publish the worst normalized drift score. Returns True
        when a window closed."""
        reg = self.registry
        if not getattr(reg, "enabled", False):
            return False
        with self._lock:
            cur = {k: self._read(k) for k in _WINDOW_COUNTERS}
            d = {k: cur[k] - self._prev.get(k, 0) for k in cur}
            reads = d["reads_in"]
            if reads <= 0 or (reads < self.window_reads and not final):
                return False
            self._prev = cur
            self.windows += 1
            corrected = max(d["reads_corrected"], 1)
            window = {
                "quality_corrections_per_read":
                    d["substitutions"] / corrected,
                "quality_skip_rate": d["reads_skipped"] / reads,
                "quality_trunc_rate":
                    (d["truncations_3p"] + d["truncations_5p"])
                    / corrected,
                "quality_contam_rate":
                    d["skipped_contaminant"] / reads,
                "quality_anchor_rate":
                    1.0 - d["skipped_no_anchor"] / reads,
            }
            drift = 0.0
            for name, v in window.items():
                reg.gauge(name).set(round(v, 6))
                m = self._ewma.get(name)
                if m is None:
                    # first window seeds the baseline — drift is
                    # change AGAINST history, so a short run that
                    # only ever closes one window cannot page
                    self._ewma[name] = v
                    continue
                # normalized deviation from the smoothed baseline;
                # the 0.02 floor keeps a near-zero baseline (clean
                # data) from turning rounding noise into a page
                drift = max(drift, abs(v - m) / max(abs(m), 0.02))
                self._ewma[name] = (self.alpha * v
                                    + (1.0 - self.alpha) * m)
            reg.gauge(DRIFT_GAUGE).set(round(drift, 4))
            cm = reg.meta.get("coverage_mean")
            if isinstance(cm, (int, float)) \
                    and not isinstance(cm, bool) and cm > 0:
                predicted = predicted_anchor_rate(cm)
                if predicted > 0.05:
                    reg.gauge("quality_coverage_ratio").set(
                        round(min(window["quality_anchor_rate"]
                                  / predicted, 2.0), 4))
            return True
