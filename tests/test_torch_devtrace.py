"""telemetry/devtrace.py on Kineto's Chrome trace, and utils/profiling.trace,
on the CPU: a small synthetic trace in Kineto's shape (kernel, gpu_memcpy,
gpu_memset, cuda_runtime, user_annotation and gpu_user_annotation
events; a kernel that runs after its step's host window closed, a
kernel launched outside every step, a wrapper's launch range nested in
a step) gives exact per-step kernel, idle and unattributed microseconds,
top kernels and launch attribution from the launch calls' correlation,
whatever Kineto's device-side projections of the ranges say; a trace
whose device activity no launch call claims, and a CPU --profile run,
land the devtrace names at zero with their source named."""

import conftest  # noqa: F401  (pins JAX to CPU devices)

import json
import os

import pytest
import torch

from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.kernels.loader import STATS
from quorum_tpu_torch.telemetry import contract, devtrace, registry
from quorum_tpu_torch.utils import profiling

READS = os.path.join(os.path.dirname(__file__), "golden", "reads.fastq")
INSERT = "void insert_reads_kernel<24>(Wire, int, int)"
SEAL = "void seal_kernel(uint4*, long long)"
EXPORT = "void export_kernel()"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(cat, name, ts, dur, pid=0, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _host(cat, name, ts, dur, **args):
    return _x(cat, name, ts, dur, pid=1, tid=1, **args)


def _events(runtime: bool = True, unclaimed: tuple = ()) -> list:
    """Two steps on one host thread. Step 0 launches HK1 (inside its
    wrapper's range), an H2D copy and a second HK1 that runs after the
    step's host window closed; step 1 a seal and a set; an export kernel
    is launched outside every step. The launch calls of the correlation
    ids in `unclaimed` are left out."""
    launched = [  # (correlation, host ts, device event)
        (1, 106, ("kernel", INSERT, 110, 30)),
        (2, 130, ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 140,
                  20)),
        (3, 145, ("kernel", INSERT, 170, 30)),
        (4, 310, ("kernel", SEAL, 320, 40)),
        (5, 340, ("gpu_memset", "Memset (Device)", 380, 10)),
        (6, 400, ("kernel", EXPORT, 500, 25)),
    ]
    ev = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
           "args": {"name": "python"}},
          _host("user_annotation", "stage1_batch", 95, 60),
          _host("user_annotation", "stage1_insert#0", 100, 50),
          _host("user_annotation", "launch:tile_insert", 105, 15),
          _host("user_annotation", "stage1_insert#1", 300, 50)]
    for corr, host_ts, (cat, name, ts, dur) in launched:
        if runtime and corr not in unclaimed:
            ev.append(_host("cuda_runtime", "cudaLaunchKernel", host_ts, 2,
                            correlation=corr))
            ev.append(_x(cat, name, ts, dur, correlation=corr))
        else:
            ev.append(_x(cat, name, ts, dur, correlation=corr))
    # Kineto's projections of the ranges: each holds only what its own
    # range launched, so step 0's leaves out its nested wrapper's kernel
    ev += [_x("gpu_user_annotation", "stage1_insert#0", 140, 60),
           _x("gpu_user_annotation", "stage1_insert#1", 320, 70),
           _x("gpu_user_annotation", "launch:tile_insert", 110, 30)]
    return ev


def _write(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


def _rows(s):
    return [(w.name, w.step, w.dur_us, w.kernel_us, w.idle_us, w.n_kernels)
            for w in s.steps]


def test_launch_correlation_gives_exact_attribution():
    """Each activity joins the step whose host range holds the call that
    launched it, also when it runs after that range closed; the step's
    device window spans its activities, first to last."""
    s = devtrace.summarize_events(_events())
    assert s.source == devtrace.SOURCE_LAUNCH
    assert _rows(s) == [("stage1_insert", 0, 90, 60, 10, 2),
                        ("stage1_insert", 1, 70, 40, 20, 1)]
    assert s.total_kernel_us == 125
    assert s.unattributed_kernel_us == 25
    assert (s.total_step_us, s.total_idle_us) == (160, 30)
    assert (s.memcpy_us, s.memset_us) == (20, 10)
    assert s.top_kernels() == [("insert_reads_kernel<24>", 60),
                               ("seal_kernel", 40), ("export_kernel", 25)]
    assert s.top_kernels(1) == [("insert_reads_kernel<24>", 60)]
    assert s.stage_kernel_us() == {"stage1_insert": 100}
    assert s.stage_steps() == {"stage1_insert": 2}
    assert s.launches == {"tile_insert": {"calls": 1, "host_us": 15,
                                          "device_us": 30,
                                          "kernel_us": 30}}


def test_activity_no_launch_call_claims_is_unattributed():
    """Without the late kernel's launch call, it joins no step: step 0's
    window shrinks to its copy and first kernel."""
    s = devtrace.summarize_events(_events(unclaimed=(3,)))
    assert s.source == devtrace.SOURCE_LAUNCH
    assert _rows(s) == [("stage1_insert", 0, 50, 30, 0, 1),
                        ("stage1_insert", 1, 70, 40, 20, 1)]
    assert s.unattributed_kernel_us == 55
    assert s.launches["tile_insert"]["kernel_us"] == 30


def test_device_activity_without_launch_calls_lands_zeros(tmp_path):
    """No fallback join: device activity that no launch call claims
    lands zeros, its source named, and still satisfies the contract."""
    s = devtrace.summarize_events(_events(runtime=False))
    assert s.source == devtrace.SOURCE_NO_LAUNCH
    assert not s.steps and not s.kernels and not s.launches
    assert s.total_kernel_us == 0 == s.total_step_us == s.memcpy_us
    root = str(tmp_path / "prof")
    _write(os.path.join(root, profiling.TRACE_NAME), _events(runtime=False))
    reg = registry.MetricsRegistry()
    reg.set_meta(profile=root)
    devtrace.record_profile_metrics(reg, root)
    doc = reg.as_dict()
    assert doc["meta"]["devtrace_source"] == devtrace.SOURCE_NO_LAUNCH
    assert doc["counters"]["device_kernel_us_total"] == 0
    assert doc["gauges"]["devtrace_steps"] == 0
    assert contract.missing_names(doc) == []


def test_profile_directory_names_every_source_it_joined(tmp_path):
    """A stage whose trace has no launch calls is not hidden behind the
    other stage's join: the directory's source names both."""
    root = str(tmp_path / "prof")
    _write(os.path.join(root, "stage1", profiling.TRACE_NAME), _events())
    _write(os.path.join(root, "stage2", profiling.TRACE_NAME),
           _events(runtime=False))
    s = devtrace.summarize_profile(root)
    assert s.source == "+".join(sorted((devtrace.SOURCE_LAUNCH,
                                        devtrace.SOURCE_NO_LAUNCH)))
    assert s.total_kernel_us == 125


def test_no_device_activity_lands_zeros():
    ev = [e for e in _events() if e.get("cat") not in (
        "kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")]
    s = devtrace.summarize_events(ev)
    assert s.source == devtrace.SOURCE_NO_DEVICE
    assert not s.steps and s.total_kernel_us == 0 == s.total_step_us


def test_profile_directory_is_joined_per_file_and_recorded(tmp_path):
    """The driver's layout: stage1/ and stage2/ each hold a trace (each
    joined on its own), and the span twins are not device truth."""
    root = str(tmp_path / "prof")
    _write(os.path.join(root, "stage1", profiling.TRACE_NAME), _events())
    _write(os.path.join(root, "stage2", profiling.TRACE_NAME),
           [dict(e, name=e["name"].replace("stage1_insert",
                                           "stage2_device"))
            for e in _events()])
    _write(os.path.join(root, "spans.trace.json"),
           [_x("kernel", "not_a_kernel", 0, 1e6)])
    assert len(devtrace.find_trace_files(root)) == 2
    reg = registry.MetricsRegistry()
    reg.set_meta(profile=root)
    assert devtrace.record_profile_metrics(reg, root)
    doc = reg.as_dict()
    assert doc["counters"]["device_kernel_us_total"] == 250
    assert doc["counters"]["device_kernel_unattributed_us_total"] == 50
    assert doc["counters"]["device_step_us_total"] == 320
    assert doc["counters"]["device_idle_us_total"] == 60
    assert doc["gauges"]["devtrace_steps"] == 4
    assert doc["histograms"]["device_kernel_us"]["counts"] == \
        {"40": 2, "60": 2}
    meta = doc["meta"]
    assert meta["devtrace_source"] == devtrace.SOURCE_LAUNCH
    assert meta["devtrace_stage_kernel_us"] == {"stage1_insert": 100.0,
                                                "stage2_device": 100.0}
    assert meta["devtrace_stage_steps"] == {"stage1_insert": 2,
                                            "stage2_device": 2}
    assert meta["devtrace_top_kernels"][0] == "insert_reads_kernel<24>=120.0"
    assert meta["devtrace_launch_kernel_us"] == {"tile_insert": 60.0}
    assert contract.missing_names(doc) == []


def test_empty_directory_lands_the_names_at_zero(tmp_path):
    reg = registry.MetricsRegistry()
    reg.set_meta(profile=str(tmp_path))
    devtrace.record_profile_metrics(reg, str(tmp_path))
    doc = reg.as_dict()
    assert doc["meta"]["devtrace_source"] == devtrace.SOURCE_NONE
    assert contract.missing_names(doc) == []
    assert doc["counters"]["device_kernel_us_total"] == 0


def test_cpu_profile_run_lands_devtrace_names_at_zero(tmp_path):
    prof = str(tmp_path / "prof")
    m = str(tmp_path / "m.json")
    assert tcdb_cli.main(["-s", "64k", "-m", "13", "-b", "7", "-q", "38",
                          "-o", str(tmp_path / "db.jf"), "--device", "cpu",
                          "--profile", prof, "--metrics", m, READS]) == 0
    assert os.path.exists(os.path.join(prof, profiling.TRACE_NAME))
    assert os.path.exists(os.path.join(prof, "spans.trace.json"))
    assert STATS.annotate is False
    with open(m) as f:
        doc = json.load(f)
    assert doc["meta"]["profile"] == prof
    assert doc["meta"]["devtrace_source"] == devtrace.SOURCE_NO_DEVICE
    for name in contract.DEVTRACE_COUNTERS:
        assert doc["counters"][name] == 0
    assert doc["gauges"]["devtrace_steps"] == 0
    assert contract.missing_names(doc) == []


def test_trace_writes_when_the_body_raises(tmp_path, capsys, monkeypatch):
    from quorum_tpu_torch.utils import vlog

    monkeypatch.setattr(vlog, "verbose", True)
    d = str(tmp_path / "p")
    with pytest.raises(ValueError, match="body"):
        with profiling.trace(d):
            assert STATS.annotate
            raise ValueError("body")
    assert STATS.annotate is False
    assert os.path.exists(os.path.join(d, profiling.TRACE_NAME))
    assert "Wrote profiler trace" in capsys.readouterr().err


def test_cuda_profile_needs_cuda_activity(monkeypatch):
    from torch import profiler

    monkeypatch.setattr(profiler, "supported_activities",
                        lambda: {profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUPTI"):
        profiling.trace_activities("cuda")
    monkeypatch.setattr(profiler, "supported_activities",
                        lambda: {profiler.ProfilerActivity.CPU,
                                 profiler.ProfilerActivity.CUDA})
    assert profiling.trace_activities("cuda") == [
        profiler.ProfilerActivity.CPU, profiler.ProfilerActivity.CUDA]
    assert profiling.trace_activities("cpu") == [
        profiler.ProfilerActivity.CPU]
