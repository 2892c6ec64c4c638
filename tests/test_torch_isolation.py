"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

* importing every module of ``loongcollector_tpu_torch`` (in a fresh
  subprocess) loads neither ``jax`` nor ``loongcollector_tpu``;
* an AST scan of the port and of ``chip_smoke.py`` finds no import of
  either;
* entry points asked for no device default to CUDA and raise on a machine
  without one, rather than running on the CPU;
* ``ExtractKernel`` sends a CUDA tensor to the kernel launch, never to the
  plain version, and the kernel build raises when it cannot build.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "loongcollector_tpu_torch")

_PROBE = """
import importlib, json, pkgutil, sys
import loongcollector_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "loongcollector_tpu"))
print(json.dumps({"modules": len(names), "bad": bad}))
"""


def test_import_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["modules"] > 20
    assert res["bad"] == []


STREAMING_MODULES = [
    "ops.xprof", "ops.compile_watch", "ops.device_plane", "ops.device_stream",
    "ops.regex.engine", "processor.parse_regex", "pipeline.plugin.interface",
    "pipeline.pipeline", "pipeline.queue.bounded_queue",
    "pipeline.queue.process_queue_manager", "pipeline.pipeline_manager",
    "runner.processor_runner", "input.file.input_file", "input.file.reader",
    "application",
]

_PROBE_EACH = """
import importlib, json, sys
out = {}
for name in sys.argv[1:]:
    importlib.import_module("loongcollector_tpu_torch." + name)
    out[name] = sorted(m for m in sys.modules if m.split(".")[0] in
                       ("jax", "jaxlib", "loongcollector_tpu"))
print(json.dumps(out))
"""


def test_streaming_modules_load_no_jax():
    """The modules of the streaming main path, imported one after the
    other in a fresh interpreter, load neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _PROBE_EACH,
                          *STREAMING_MODULES], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(res) == sorted(STREAMING_MODULES)
    assert all(bad == [] for bad in res.values()), res


def _sources():
    for root, _dirs, files in os.walk(PORT):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(root, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_jax_imports_in_port_sources():
    offenders = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib",
                                          "loongcollector_tpu"):
                    offenders.append((os.path.relpath(path, REPO), name))
    assert offenders == []


def test_entry_points_without_device_raise(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is valid")
    from loongcollector_tpu_torch.application import main
    from loongcollector_tpu_torch.ops.regex.engine import (RegexEngine,
                                                           get_engine)
    from loongcollector_tpu_torch.pipeline.pipeline import CollectionPipeline
    from loongcollector_tpu_torch.utils.device import NoCudaDevice
    from loongcollector_tpu_torch.testdata import APACHE
    with pytest.raises(NoCudaDevice):
        get_engine(APACHE)
    with pytest.raises(NoCudaDevice):
        RegexEngine(APACHE)
    cfg = {"inputs": [{"Type": "input_file", "FilePaths": ["/nonexistent"]}],
           "processors": [{"Type": "processor_parse_regex_tpu",
                           "Regex": APACHE}],
           "flushers": [{"Type": "flusher_stdout"}]}
    with pytest.raises(NoCudaDevice):
        CollectionPipeline("p", cfg, device=None)
    (tmp_path / "p.json").write_text(json.dumps(cfg))
    assert main(["--config", str(tmp_path), "--once"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert main(["--config", str(tmp_path)]) == 2      # tail mode: not yet


class _FakeCudaTensor:
    device = torch.device("cuda", 0)


def test_cuda_tensor_launches_kernel_never_plain(monkeypatch):
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels.field_extract import \
        ExtractKernel
    from loongcollector_tpu_torch.ops.regex.program import compile_tier1
    kern = ExtractKernel(compile_tier1(r"(\d+)-(\w+)"))

    def plain(*a):
        raise AssertionError("plain version ran for a CUDA tensor")

    calls = []
    kern.plain = plain
    monkeypatch.setattr(kern, "device_program", lambda dev: "prog")
    monkeypatch.setattr(fxc, "launch",
                        lambda *a: calls.append(a) or ("ok", "off", "len"))
    rows = _FakeCudaTensor()
    assert kern(rows, rows) == ("ok", "off", "len")
    assert kern.launches == 1 and len(calls) == 1


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    monkeypatch.setattr(fxc, "_lib", None)
    monkeypatch.setattr(fxc, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(fxc.shutil, "which", lambda name: None)
    monkeypatch.setattr(fxc.os.path, "exists",
                        lambda p: False if "nvcc" in p else os.path.isfile(p))
    with pytest.raises(RuntimeError, match="nvcc"):
        fxc.build()
