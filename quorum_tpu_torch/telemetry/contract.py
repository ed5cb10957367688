"""A copy of quorum_tpu/telemetry/contract.py, plus `missing_names`,
the port's copy of tools/metrics_check.py's dispatch on meta for the
surfaces the port's documents declare.

The telemetry metric-name contract: the required-counter catalogs
that `tools/metrics_check.py` gates CI documents against, single-
sourced here.

These lists used to live in the checker tool, which meant the
contract and the code that fulfils it could drift: a counter renamed
in `quorum_tpu/serve/` kept passing local tests while the CI gate
went quietly vacuous (the PR-7 SERVE_FEATURE_COUNTERS lesson was
exactly this shape — feature counters exist only if the serve layers
pre-create them at setup, so a missing name must FAIL the document,
which only works while the checker's list matches the creators).

Now three consumers import ONE catalog:

* ``tools/metrics_check.py`` — requires the names in produced
  documents (dispatching on meta, as before);
* ``quorum_tpu/analysis`` — the ``counter-not-precreated`` rule
  statically verifies every counter named here is created by a
  literal ``.counter("name")`` call somewhere in ``quorum_tpu/``, so
  a rename or deletion breaks the lint, not just the late CI gate;
* the telemetry layers themselves, as the canonical spelling.

Keep entries appendable: removing or renaming one is a contract
change and must update the creators, the goldens, and this file in
the same PR (quorum-lint will insist).
"""

from __future__ import annotations

# The serve request/batch metric surface (quorum_tpu/serve/): a final
# metrics document stamped `meta.stage == "serve"` must carry these.
# Counters appear once the first request is admitted; the histograms
# once the first batch dispatches.
SERVE_REQUIRED_COUNTERS = (
    "requests_accepted",
    "requests_completed",
    "reads_in",
    "reads_corrected",
    "batches",
    "engine_compiles",
)
SERVE_REQUIRED_HISTOGRAMS = (
    "batch_reads",
    "queue_wait_us",
    "request_us",
    "request_reads",
    "serve_dispatch_us",
    "serve_wait_us",
)

# The serve resilience surface: a serve document whose meta
# declares one of these features enabled must carry its counter (the
# serve layers create them at setup, so value 0 counts).
#   meta.step_timeout_ms > 0 -> engine_restarts_total (watchdog)
#   meta.max_hedges > 0      -> hedges_total
#   meta.reload truthy       -> reload_total
#   meta.quota_rps > 0       -> quota_rejections_total
SERVE_FEATURE_COUNTERS = (
    ("step_timeout_ms", "engine_restarts_total"),
    ("max_hedges", "hedges_total"),
    ("reload", "reload_total"),
    ("quota_rps", "quota_rejections_total"),
)

# The fault-tolerance metric surface: documents that declare
# the corresponding feature in meta must carry its counters.
#   meta.checkpoint_every > 0  -> checkpoint_writes_total
#   meta.resumed truthy        -> resume_skipped_reads
#   meta.on_bad_read in
#     ("skip", "quarantine")   -> bad_reads_total
#   meta.driver == "quorum"    -> stage_retries_total
FAULT_COUNTERS = ("checkpoint_writes_total", "resume_skipped_reads",
                  "bad_reads_total", "stage_retries_total")

# The data-integrity surface: a document whose meta declares
# a checksummed database (db_version >= 5) or a verification mode
# (verify_db) must carry the integrity counters.
INTEGRITY_COUNTERS = ("integrity_errors_total",
                      "integrity_bytes_verified_total")

# The device-truth telemetry surface: a document whose
# meta declares a `profile` directory must carry the devtrace metrics
# (cli/observability.py records them post-run, zeros included).
DEVTRACE_COUNTERS = ("device_kernel_us_total", "device_step_us_total",
                     "device_idle_us_total",
                     "device_kernel_unattributed_us_total")
DEVTRACE_GAUGES = ("devtrace_steps",)
DEVTRACE_HISTOGRAMS = ("device_kernel_us",)
DEVTRACE_META = ("devtrace_source",)

# The push transport surface: a document whose meta
# declares `metrics_push_url` must carry the pusher's counters.
PUSH_COUNTERS = ("metrics_push_total", "metrics_push_failures_total")
PUSH_META = ("metrics_push_host",)

# The alerting surface: a document whose meta declares
# alert rules active must carry the engine's counters and gauges.
ALERT_COUNTERS = ("alerts_fired_total", "alert_rule_errors_total")
ALERT_GAUGES = ("alert_rules_active",)

# The memory-frugal counting surface: a stage-1 document
# whose meta declares a prefilter mode must carry the prefilter
# counters (pre-created at setup, so 0 counts); one declaring
# partitions > 1 must carry the pass counter plus one
# `partition_distinct{partition="K"}` gauge per partition — a missing
# gauge means a pass's telemetry (or the pass itself) was dropped.
PREFILTER_COUNTERS = ("prefilter_dropped_total",
                      "prefilter_false_pass_total")
PARTITION_COUNTERS = ("partition_passes_total",)
PARTITION_GAUGE_PREFIX = "partition_distinct{partition="

# The compile-sentinel surface: a document whose meta
# declares `compile_sentinel` was produced under
# QUORUM_COMPILE_SENTINEL=1 and must carry the ledger export — the
# total compile counter plus the per-site map (the per-site
# `compiles{site="..."}` labeled counters ride along but are not
# individually required: the set of sites a run touches is workload-
# shaped).
COMPILE_COUNTERS = ("compile_events",)
COMPILE_META = ("compile_sites",)

# The flight-recorder surface: a document whose meta
# declares `flight` (the recorder was installed and enabled) must
# carry the dump/drop counters — pre-created by FlightRecorder at
# construction, so a clean zero-dump run still proves the black box
# was armed.
FLIGHT_COUNTERS = ("flight_dumps_total", "flight_events_dropped_total")

# The correction-quality surface: the data-plane outcome
# names every stage-2 path (offline drain loop and serve engine)
# pre-creates via models/error_correct.precreate_outcome_counters —
# one `skipped_<slug>` counter per REASON_SLUGS slug plus the
# "other" fallback, so zero-count reasons still land in the final
# document (the PR-7 zero-count lesson). A document whose
# meta.stage is "error_correct" or "serve" must carry all of them.
QUALITY_COUNTERS = (
    "substitutions",
    "truncations_3p",
    "truncations_5p",
    "skipped_contaminant",
    "skipped_no_anchor",
    "skipped_homopolymer",
    "skipped_other",
)
QUALITY_HISTOGRAMS = ("substitutions_per_read", "sub_pos_bucket",
                      "trunc_cycle_3p", "trunc_cycle_5p")
# The live scorecard surface: a document whose meta declares
# `quality` (a QualityScorecard was installed) must carry the
# windowed-rate/drift gauges the quality alert rules read — the
# scorecard sets them to quiet values at construction, so they exist
# before the first window closes — plus a top-level `quality`
# section (schema-validated by telemetry/schema.validate_quality).
QUALITY_GAUGES = (
    "quality_corrections_per_read",
    "quality_skip_rate",
    "quality_trunc_rate",
    "quality_contam_rate",
    "quality_anchor_rate",
    "quality_coverage_ratio",
    "quality_drift_score",
)

# The live ingestion surface: a serve document whose meta
# declares `live_ingest` (quorum-serve --ingest) must carry the
# ingest/epoch counters (pre-created by IngestDispatcher at
# construction, so a zero-chunk run still proves the tier was armed)
# and the cursor/floor gauges (set at construction and advanced by
# the worker).
LIVE_INGEST_COUNTERS = (
    "ingest_requests_total",
    "ingest_reads_total",
    "epoch_swaps_total",
    "epoch_swap_failures_total",
)
LIVE_INGEST_GAUGES = ("ingest_cursor", "live_floor")

# The resource-guard surface: a document whose meta
# declares `resource_guard` (utils/resources.install armed a disk
# monitor over the run's artifact filesystems) must carry the guard
# counters — pre-created by install() so a clean run still proves the
# guard was armed (the PR-7 zero-count lesson) — plus the monitor's
# scalar gauges (published at the synchronous first tick, so they
# exist even if the run finishes inside one interval). The per-path
# `disk_free_bytes{path="..."}` labeled gauges ride along: at least
# one must exist (the watched-path set is run-shaped, so individual
# paths are not required by name).
RESOURCE_COUNTERS = ("writer_degraded_total",
                     "preflight_refusals_total",
                     "stall_aborts_total")
RESOURCE_GAUGES = ("disk_free_bytes_min", "host_rss_bytes")
RESOURCE_GAUGE_PREFIX = "disk_free_bytes{path="

# The multi-host fleet surface: a document whose meta
# declares `host_process_count > 1` is the ONE aggregated fleet
# document multihost.aggregate_metrics writes on process 0. It must
# carry the per-host shard documents under top-level `hosts` (exactly
# host_process_count of them, meta.aggregated_hosts agreeing), the
# fleet-reduced resource gauges (free-space gauges min-reduced across
# hosts — see merge_host_docs — so the document reports the TIGHTEST
# disk anywhere in the fleet), and, for every host shard whose meta
# declares compile_sentinel, at least one per-site
# `compiles{site="..."}` counter in that shard (a sentinel host whose
# compile ledger vanished is a host whose compile telemetry was
# dropped, not a host that compiled nothing — stage CLIs always jit).
FLEET_META = ("host_process_count", "aggregated_hosts")
FLEET_GAUGES = RESOURCE_GAUGES
FLEET_COMPILE_PREFIX = "compiles{site="

# The sharded (--devices N) metric surface: a stage-1
# document built over more than one shard must carry the per-shard
# telemetry parallel/tile_sharded.record_shard_metrics writes.
SHARD_REQUIRED_COUNTERS = ("shard_batches", "shard_reads",
                           "shard_inserts_total", "distinct_mers")
SHARD_REQUIRED_GAUGES = ("n_shards", "shard_distinct_min",
                         "shard_distinct_max", "shard_inserts_min",
                         "shard_inserts_max")
SHARD_REQUIRED_META_LISTS = ("shard_distinct_mers", "shard_inserts")


def precreate_serve_metrics(registry) -> None:
    """Zero-fill the unconditional serve surface on a registry so a
    serve process that drains before its FIRST /correct request (an
    ingest-only warm-up period, an operator bounce) still writes a
    final document metrics_check accepts — the same pre-creation
    discipline as precreate_outcome_counters. Lazy creation at
    first-request time remains the writer of record; this only
    guarantees the names exist at zero."""
    for name in SERVE_REQUIRED_COUNTERS:
        registry.counter(name)
    for name in SERVE_REQUIRED_HISTOGRAMS:
        registry.histogram(name)


def precreated_counter_names() -> tuple[str, ...]:
    """Every counter name the contract expects quorum_tpu code to
    create with a LITERAL ``.counter("name")`` call — the analyzer's
    pre-creation catalog (quorum-lint `counter-not-precreated`).
    Union of the per-surface lists above, deduplicated, sorted."""
    names: set[str] = set()
    names.update(SERVE_REQUIRED_COUNTERS)
    names.update(name for _, name in SERVE_FEATURE_COUNTERS)
    names.update(FAULT_COUNTERS)
    names.update(INTEGRITY_COUNTERS)
    names.update(DEVTRACE_COUNTERS)
    names.update(PUSH_COUNTERS)
    names.update(ALERT_COUNTERS)
    names.update(COMPILE_COUNTERS)
    names.update(FLIGHT_COUNTERS)
    names.update(SHARD_REQUIRED_COUNTERS)
    names.update(PREFILTER_COUNTERS)
    names.update(PARTITION_COUNTERS)
    names.update(QUALITY_COUNTERS)
    names.update(LIVE_INGEST_COUNTERS)
    names.update(RESOURCE_COUNTERS)
    return tuple(sorted(names))


def missing_names(doc: dict) -> list[str]:
    """The names a final metrics document lacks under the rules
    tools/metrics_check.py applies, dispatching on what its meta
    declares: a quorum driver (`stage_retries_total`), a bad-read
    policy, checkpoints and a resume, the resource guards, a
    checksummed load (`db_version >= 5` or `verify_db`), a
    `--profile` directory (DEVTRACE_*), a prefilter or partitions, a
    sharded build (`n_shards > 1`), the quality scorecard and a stage-2
    data plane. Empty = every required name is present."""
    meta = doc.get("meta", {})
    counters = doc.get("counters", {})
    gauges = doc.get("gauges", {})
    hists = doc.get("histograms", {})
    errs: list[str] = []

    def need(names, section: dict, kind: str, why: str) -> None:
        for name in names:
            if name not in section:
                errs.append(f"document with {why} missing {kind} "
                            f"{name!r}")

    if meta.get("driver") == "quorum":
        need(("stage_retries_total",), counters, "counter",
             "meta.driver=quorum")
    if meta.get("on_bad_read") in ("skip", "quarantine"):
        need(("bad_reads_total",), counters, "counter",
             f"meta.on_bad_read={meta['on_bad_read']!r}")
    if int(meta.get("checkpoint_every") or 0) > 0:
        need(("checkpoint_writes_total",), counters, "counter",
             "meta.checkpoint_every > 0")
    if meta.get("resumed"):
        need(("resume_skipped_reads",), counters, "counter", "meta.resumed")
    if meta.get("resource_guard"):
        need(RESOURCE_COUNTERS, counters, "counter", "meta.resource_guard")
        need(RESOURCE_GAUGES, gauges, "gauge", "meta.resource_guard")
        if not any(g.startswith(RESOURCE_GAUGE_PREFIX) for g in gauges):
            errs.append("document with meta.resource_guard missing a "
                        f"gauge {RESOURCE_GAUGE_PREFIX}...}}")
    if int(meta.get("db_version") or 0) >= 5 or meta.get("verify_db"):
        need(INTEGRITY_COUNTERS, counters, "counter",
             "a checksummed database")
    if meta.get("profile"):
        why = f"meta.profile={meta['profile']!r}"
        need(DEVTRACE_COUNTERS, counters, "counter", why)
        need(DEVTRACE_GAUGES, gauges, "gauge", why)
        need(DEVTRACE_HISTOGRAMS, hists, "histogram", why)
        need(DEVTRACE_META, meta, "meta", why)
    if meta.get("prefilter") and meta["prefilter"] != "off":
        need(PREFILTER_COUNTERS, counters, "counter",
             f"meta.prefilter={meta['prefilter']!r}")
    parts = int(meta.get("partitions") or 1)
    if parts > 1:
        why = f"meta.partitions={parts}"
        need(PARTITION_COUNTERS, counters, "counter", why)
        need([f'{PARTITION_GAUGE_PREFIX}"{p}"}}' for p in range(parts)],
             gauges, "gauge", why)
    n_shards = int(gauges.get("n_shards", 1))
    if meta.get("stage") == "create_database" and n_shards > 1:
        why = f"n_shards={n_shards}"
        need(SHARD_REQUIRED_COUNTERS, counters, "counter", why)
        need(SHARD_REQUIRED_GAUGES, gauges, "gauge", why)
        for name in SHARD_REQUIRED_META_LISTS:
            val = meta.get(name)
            if not isinstance(val, list) or len(val) != n_shards:
                errs.append(f"document with {why}: meta.{name} must be "
                            f"a list of {n_shards} values, got {val!r}")
    if meta.get("quality"):
        need(QUALITY_GAUGES, gauges, "gauge", "meta.quality")
        if not isinstance(doc.get("quality"), dict):
            errs.append("document with meta.quality missing its "
                        "'quality' section")
    if meta.get("stage") in ("error_correct", "serve"):
        why = f"meta.stage={meta['stage']!r}"
        need(QUALITY_COUNTERS, counters, "counter", why)
        need(QUALITY_HISTOGRAMS, hists, "histogram", why)
    return errs
