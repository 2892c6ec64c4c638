"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

* importing every module of ``loongcollector_tpu_torch`` (in a fresh
  subprocess) loads neither ``jax`` nor ``loongcollector_tpu``;
* an AST scan of the port and of ``chip_smoke.py`` finds no import of
  either; nor does importing the sharded parse plane (``parallel.mesh``)
  or the chip lanes (``ops.chip_lanes``) on their own, nor the eBPF
  input plane, the input-runner registry or the classify and field
  processors, nor tail mode's modules (the file server, polling, inotify,
  checkpoints, the acked-offset tracker, recovery, the flags), nor the
  send path (the Batcher, sender queues and limiters, codecs, spill
  encryption, disk buffer, breaker, HTTP sink, flusher runner, the SLS
  serializer, ``flusher_http`` and ``flusher_prometheus``);
* entry points asked for no device default to CUDA and raise on a machine
  without one, rather than running on the CPU;
* ``ExtractKernel`` sends a CUDA tensor to the kernel launch, never to the
  plain version, and the kernel build raises when it cannot build; so does
  ``FusedProgramKernel`` (K7) and its build, ``SegmentReduceKernel``
  (K6) and its build, and ``StructIndexKernel`` (K5) and its build;
* each kernel library's source hash covers the headers its source
  includes, so a header edit rebuilds every library that includes it;
  ``segment_reduce.cu`` includes none, and only its own edits rebuild it;
  ``struct_walk.cuh`` rebuilds K5 and K7 and nothing else.
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
    "application", "ops.fused_pipeline", "ops.kernels.fused_program_cuda",
    "pipeline.fused_chain",
]

ROLLUP_MODULES = [
    "ops.kernels.segment_reduce", "ops.kernels.segment_reduce_cuda",
    "native", "processor.parse_json", "processor.parse_telemetry",
    "monitor.metrics", "monitor.ledger", "aggregator.base",
    "aggregator.metric_rollup", "pipeline.batch.timeout_flush_manager",
    "pipeline.plugin.registry", "testdata",
]

STRUCT_MODULES = [
    "ops.kernels.struct_index", "ops.kernels.struct_index_cuda",
    "processor.parse_delimiter", "processor.common", "native",
    "ops.fused_pipeline", "ops.kernels.fused_program_cuda", "application",
    "testdata",
]

MESH_MODULES = [
    "parallel", "parallel.mesh", "ops.chip_lanes", "ops.regex.engine",
    "ops.fused_pipeline", "runner.processor_runner", "ops.xprof",
    "application",
]

EBPF_MODULES = [
    "input.ebpf", "input.ebpf.protocol_http", "input.ebpf.protocol_redis",
    "input.ebpf.protocol_mysql", "input.ebpf.connections",
    "input.ebpf.proc_tree", "input.ebpf.adapter", "input.ebpf.server",
    "input", "runner.input_registry", "processor.classify_url",
    "processor.field_ops", "processor", "application", "testdata",
]

TAIL_MODULES = [
    "utils.flags", "runner.ack_watermark", "recovery",
    "input.file.reader", "input.file.checkpoint", "input.file.polling",
    "input.file.event_listener", "input.file.file_server",
    "input.file.input_file", "runner.input_registry",
    "pipeline.batch.timeout_flush_manager", "flusher.file",
    "flusher.stdout", "pipeline.pipeline", "application", "native",
]

SEND_MODULES = [
    "pipeline.batch.flush_strategy", "pipeline.batch.batcher",
    "pipeline.queue.limiter", "pipeline.queue.sender_queue",
    "pipeline.compression", "utils.payload_crypto", "runner.disk_buffer",
    "runner.circuit", "runner.http_sink", "runner.flusher_runner",
    "pipeline.serializer.sls_serializer", "flusher.http",
    "flusher.http_base", "flusher.prometheus_rw", "monitor.alarm_counts",
    "flusher", "application", "native",
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


def test_rollup_modules_load_no_jax():
    """The modules of the metric-rollup path, imported one after the other
    in a fresh interpreter, load neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _PROBE_EACH,
                          *ROLLUP_MODULES], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(res) == sorted(ROLLUP_MODULES)
    assert all(bad == [] for bad in res.values()), res


def test_struct_index_modules_load_no_jax():
    """The modules of the structural-index slice (K5, the quote-mode
    delimiter, K7's struct_index stage), imported one after the other in a
    fresh interpreter, load neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _PROBE_EACH,
                          *STRUCT_MODULES], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(res) == sorted(STRUCT_MODULES)
    assert all(bad == [] for bad in res.values()), res


def test_mesh_modules_load_no_jax():
    """The modules of the multiple-device slice (the sharded parse plane,
    the chip lanes and their callers), imported one after the other in a
    fresh interpreter, load neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _PROBE_EACH,
                          *MESH_MODULES], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(res) == sorted(MESH_MODULES)
    assert all(bad == [] for bad in res.values()), res


def test_ebpf_and_classify_modules_load_no_jax():
    """The modules of the eBPF and URL-classification slice (the eBPF
    input plane, the input-runner registry, the classify and field
    processors), imported one after the other in a fresh interpreter, load
    neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _PROBE_EACH,
                          *EBPF_MODULES], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(res) == sorted(EBPF_MODULES)
    assert all(bad == [] for bad in res.values()), res


def test_tail_modules_load_no_jax():
    """Tail mode's modules (the file server and its readers, discovery and
    inotify, checkpoints, the acked-offset tracker, recovery, the flags,
    the flushers' and the pipeline's ack hooks), imported one after the
    other in a fresh interpreter, load neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _PROBE_EACH,
                          *TAIL_MODULES], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(res) == sorted(TAIL_MODULES)
    assert all(bad == [] for bad in res.values()), res


def test_send_modules_load_no_jax():
    """The send path's modules, imported one after the other in a fresh
    interpreter, load neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _PROBE_EACH,
                          *SEND_MODULES], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(res) == sorted(SEND_MODULES)
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
    assert main(["--config", str(tmp_path), "--data-dir",
                 str(tmp_path / "data")]) == 2      # tail mode too
    assert not (tmp_path / "data").exists()


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


def test_fused_program_sends_cuda_tensors_to_k7_never_plain(monkeypatch):
    from loongcollector_tpu_torch import testdata as td
    from loongcollector_tpu_torch.ops import fused_pipeline as fp
    from loongcollector_tpu_torch.ops.kernels import fused_program_cuda as fpc
    specs = dict((n, s) for n, s, _ in td.fused_stage_lists())["apache_filter"]
    program = fp.FusedProgramKernel(specs, "iso")

    def plain(*a):
        raise AssertionError("plain version ran for a CUDA tensor")

    calls = []
    program.plain = plain
    monkeypatch.setattr(program, "device_blob", lambda dev: "blob")
    monkeypatch.setattr(fpc, "launch",
                        lambda *a: calls.append(a) or "flat")
    rows = _FakeCudaTensor()
    rows.shape = (8, 128)
    assert program(rows, rows) == ("flat",)
    assert program.launches == 1 and program.dispatch_count == 1
    (args,) = calls
    assert args[2] == "blob" and args[3] is program.descriptor


def test_fused_program_build_failure_raises(monkeypatch, tmp_path):
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels import fused_program_cuda as fpc
    monkeypatch.setattr(fpc, "_lib", None)
    monkeypatch.setattr(fxc, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(fxc.shutil, "which", lambda name: None)
    monkeypatch.setattr(fxc.os.path, "exists",
                        lambda p: False if "nvcc" in p else os.path.isfile(p))
    with pytest.raises(RuntimeError, match="nvcc"):
        fpc.build()


def test_source_hashes_cover_the_shared_headers(tmp_path):
    import shutil
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    src = os.path.join(PORT, "ops", "kernels", "csrc")
    dst = tmp_path / "csrc"
    shutil.copytree(src, dst)
    libs = {name: str(dst / name) for name in
            ("field_extract.cu", "dfa_scan.cu", "fused_program.cu",
             "struct_index.cu")}
    assert [os.path.basename(p) for p in fxc.source_files(
        libs["fused_program.cu"])] == ["fused_program.cu", "dfa_walk.cuh",
                                       "extract_walk.cuh", "struct_walk.cuh"]
    assert [os.path.basename(p) for p in fxc.source_files(
        libs["struct_index.cu"])] == ["struct_index.cu", "struct_walk.cuh"]

    def hashes():
        return {name: fxc.source_hash(path) for name, path in libs.items()}

    before = hashes()
    assert before == {name: fxc.source_hash(os.path.join(src, name))
                      for name in libs}
    with open(dst / "extract_walk.cuh", "a") as f:
        f.write("// edited\n")
    after_extract = hashes()
    assert after_extract["field_extract.cu"] != before["field_extract.cu"]
    assert after_extract["fused_program.cu"] != before["fused_program.cu"]
    assert after_extract["dfa_scan.cu"] == before["dfa_scan.cu"]
    with open(dst / "dfa_walk.cuh", "a") as f:
        f.write("// edited\n")
    after_dfa = hashes()
    assert after_dfa["dfa_scan.cu"] != before["dfa_scan.cu"]
    assert after_dfa["fused_program.cu"] != after_extract["fused_program.cu"]
    assert after_dfa["field_extract.cu"] == after_extract["field_extract.cu"]
    assert after_dfa["struct_index.cu"] == before["struct_index.cu"]
    with open(dst / "struct_walk.cuh", "a") as f:
        f.write("// edited\n")
    after_struct = hashes()
    assert after_struct["struct_index.cu"] != before["struct_index.cu"]
    assert after_struct["fused_program.cu"] != after_dfa["fused_program.cu"]
    assert after_struct["field_extract.cu"] == after_dfa["field_extract.cu"]
    assert after_struct["dfa_scan.cu"] == after_dfa["dfa_scan.cu"]


def test_struct_index_sends_cuda_tensors_to_k5_never_plain(monkeypatch):
    from loongcollector_tpu_torch.ops.kernels import struct_index as si
    from loongcollector_tpu_torch.ops.kernels import struct_index_cuda
    kern = si.StructIndexKernel(si.MODE_DELIM, 0x7C)

    def plain(*a):
        raise AssertionError("plain version ran for a CUDA tensor")

    calls = []
    kern._plain = plain
    out = torch.arange(4 * 8 * 2, dtype=torch.int32).reshape(4, 8, 2)
    monkeypatch.setattr(struct_index_cuda, "launch",
                        lambda *a: calls.append(a) or out)
    rows = _FakeCudaTensor()
    got = kern(rows, "lengths")
    assert len(got) == 4 and all(torch.equal(g, o) for g, o in zip(got, out))
    assert kern.launches == 1 and kern.dispatch_count == 1
    (args,) = calls
    assert args == (rows, "lengths", si.MODE_DELIM, 0x7C, None)


def test_struct_index_build_failure_raises(monkeypatch, tmp_path):
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels import struct_index_cuda
    monkeypatch.setattr(struct_index_cuda, "_lib", None)
    monkeypatch.setattr(fxc, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(fxc.shutil, "which", lambda name: None)
    monkeypatch.setattr(fxc.os.path, "exists",
                        lambda p: False if "nvcc" in p else os.path.isfile(p))
    with pytest.raises(RuntimeError, match="nvcc"):
        struct_index_cuda.build()


def test_struct_index_entry_points_without_device_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is valid")
    import numpy as np
    from loongcollector_tpu_torch.ops.kernels import struct_index as si
    from loongcollector_tpu_torch.utils.device import NoCudaDevice
    with pytest.raises(NoCudaDevice):
        si.device_kernel(si.MODE_DELIM, 0x2C)
    with pytest.raises(NoCudaDevice):
        si.StructIndexKernel(si.MODE_DELIM, 0x2C).index_batch(
            np.frombuffer(b"a,b", np.uint8), np.zeros(1, np.int64),
            np.array([3], np.int32))


def test_segment_reduce_sends_cuda_tensors_to_k6_never_plain(monkeypatch):
    from loongcollector_tpu_torch.ops.kernels import segment_reduce as sr
    from loongcollector_tpu_torch.ops.kernels import segment_reduce_cuda
    kern = sr.SegmentReduceKernel(n_hist=3)

    def plain(*a):
        raise AssertionError("plain version ran for a CUDA tensor")

    calls = []
    kern.plain = plain
    flat = torch.arange(5 * 16 + 16 * 3, dtype=torch.int32)
    monkeypatch.setattr(segment_reduce_cuda, "launch",
                        lambda *a: calls.append(a) or flat)
    vals = _FakeCudaTensor()
    out = kern(vals, "seg", "buckets", "valid", 16)
    assert len(out) == 6 and out[5].shape == (16, 3)
    assert kern.launches == 1 and kern.dispatch_count == 1
    (args,) = calls
    assert args[:6] == (vals, "seg", "buckets", "valid", 16, 3)


def test_segment_reduce_build_failure_raises(monkeypatch, tmp_path):
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    from loongcollector_tpu_torch.ops.kernels import segment_reduce_cuda
    monkeypatch.setattr(segment_reduce_cuda, "_lib", None)
    monkeypatch.setattr(fxc, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(fxc.shutil, "which", lambda name: None)
    monkeypatch.setattr(fxc.os.path, "exists",
                        lambda p: False if "nvcc" in p else os.path.isfile(p))
    with pytest.raises(RuntimeError, match="nvcc"):
        segment_reduce_cuda.build()


def test_segment_reduce_source_hash(tmp_path):
    import shutil
    from loongcollector_tpu_torch.ops.kernels import field_extract_cuda as fxc
    src = os.path.join(PORT, "ops", "kernels", "csrc")
    dst = tmp_path / "csrc"
    shutil.copytree(src, dst)
    k6 = str(dst / "segment_reduce.cu")
    assert [os.path.basename(p) for p in fxc.source_files(k6)] == [
        "segment_reduce.cu"]
    before = fxc.source_hash(k6)
    assert before == fxc.source_hash(os.path.join(src, "segment_reduce.cu"))
    others = {name: fxc.source_hash(str(dst / name)) for name in
              ("field_extract.cu", "dfa_scan.cu", "fused_program.cu")}
    assert before not in others.values()
    for header in ("extract_walk.cuh", "dfa_walk.cuh"):
        with open(dst / header, "a") as f:
            f.write("// edited\n")
    assert fxc.source_hash(k6) == before
    with open(k6, "a") as f:
        f.write("// edited\n")
    assert fxc.source_hash(k6) != before
    assert {name: fxc.source_hash(str(dst / name))
            for name in others} != others       # the headers' edits
