"""The port stands alone: no file of quorum_tpu_torch/ (nor
chip_smoke.py, kernel_ab.py or host_ab.py) imports jax or quorum_tpu,
the entry points default to the card, and without a card they raise instead of running on the
CPU. The ctypes signatures of the kernels' launchers match their C
declarations."""

import ast
import ctypes
import os
import re

import pytest
import torch

import quorum_tpu_torch
from quorum_tpu_torch.cli import create_database as tcdb_cli
from quorum_tpu_torch.cli import error_correct_reads as tec_cli
from quorum_tpu_torch.cli import histo_mer_database as thisto
from quorum_tpu_torch.cli import query_mer_database as tquery
from quorum_tpu_torch.cli import quorum as tquorum
from quorum_tpu_torch.cli import serve as tserve_cli
from quorum_tpu_torch.kernels import loader
from quorum_tpu_torch.models import create_database as tcdb
from quorum_tpu_torch.models import error_correct as tec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "quorum_tpu_torch")
READS = os.path.join(ROOT, "tests", "golden", "reads.fastq")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "kernel_ab.py"),
           os.path.join(ROOT, "host_ab.py")]
    for d, _dirs, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("module", ["io/checkpoint.py", "utils/faults.py",
                                    "utils/resources.py"])
def test_crash_safety_modules_are_walked(module):
    """The crash-safety modules (the JAX package's own import no jax)
    are among the files the import check walks."""
    assert os.path.join(PKG, module) in _port_files()


@pytest.mark.parametrize("module", [
    "serve/__init__.py", "serve/admission.py", "serve/batcher.py",
    "serve/engine.py", "serve/server.py", "serve/client.py",
    "cli/serve.py", "telemetry/export.py"])
def test_serve_modules_are_walked(module):
    """The correction service's modules (JAX's admission.py and
    batcher.py import no jax; the port keeps its own copies) are among
    the files the import check walks."""
    assert os.path.join(PKG, module) in _port_files()


@pytest.mark.parametrize("forbidden", ["jax", "quorum_tpu"])
def test_port_imports_neither_jax_nor_the_jax_package(forbidden):
    files = _port_files()
    assert len(files) > 20
    bad = [(f, m) for f in files for m in _imported(f)
           if m == forbidden or m.startswith(forbidden + ".")]
    assert not bad


def test_default_device_is_cuda():
    assert quorum_tpu_torch.DEFAULT_DEVICE == "cuda"
    for parser in (tcdb_cli.build_parser(), tec_cli.build_parser(),
                   tquorum.build_parser(), thisto.build_parser(),
                   tquery.build_parser(), tserve_cli.build_parser()):
        assert parser.get_default("device") == "cuda"
    assert tcdb.BuildConfig().device == "cuda"
    assert tec.ECOptions().device == "cuda"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["create_database", "error_correct",
                                   "quorum", "library", "serve",
                                   "serve_engine"])
def test_entry_points_raise_without_a_card(no_card, tmp_path, entry):
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "create_database":
            tcdb_cli.main(["-s", "64k", "-m", "13", "-b", "7", "-q", "38",
                           "-o", out, READS])
        elif entry == "error_correct":
            tec_cli.main(["-p", "4", out, READS, "-o", out])
        elif entry == "quorum":
            tquorum.main(["-s", "64k", "-k", "13", "-p", out, READS])
        elif entry == "serve":
            tserve_cli.main(["--port", "0", out])
        elif entry == "serve_engine":
            from quorum_tpu_torch.serve import CorrectionEngine
            CorrectionEngine(out)
        else:
            tcdb.create_database_main([READS], out, tcdb.BuildConfig(k=13))
    assert not os.path.exists(out + ".fa")


def _c_launchers(name):
    """{launcher: [ctypes type per parameter]} from csrc/<name>.cu."""
    src = open(os.path.join(loader.CSRC, f"{name}.cu")).read()
    out = {}
    for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            types.append(ctypes.c_void_p if "*" in p
                         else ctypes.c_longlong if p.startswith("long long")
                         else ctypes.c_int)
        out[fn] = types
    return out


@pytest.mark.parametrize("name", loader.KERNELS)
def test_launcher_signatures_match_the_sources(name):
    # a short argtypes list passes the stream as a C int: a crash on
    # the card, invisible here without this check
    assert _c_launchers(name) == loader.SIGNATURES[name]
