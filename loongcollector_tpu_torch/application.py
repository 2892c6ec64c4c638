"""Agent entry point: ``python -m loongcollector_tpu_torch --config DIR``.

Reference: core/application/Application.cpp.  The port's slice takes
``--config``, ``--once`` and ``--cpu`` as the JAX CLI does: every pipeline
config in the directory (one pipeline per ``.yaml``/``.yml``/``.json``
file, named by its stem) runs once over the existing content of its inputs
and the process exits.  Tail mode comes with the file-server slice.

The pipelines run on the CUDA device unless ``--cpu`` is given; with no
CUDA device and no ``--cpu`` the CLI exits with an error.  ``--stats PATH``
writes the run's counts (events, kernel launches and their geometry,
device batches, rows routed to Python ``re``, kernel seconds) as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import asdict
from typing import Any, Dict, List, Optional, Tuple

from .utils.device import NoCudaDevice, resolve_device
from .utils.logger import get_logger

log = get_logger("application")


def load_config_dir(config_dir: str) -> List[Tuple[str, Dict[str, Any]]]:
    """(name, config) of every pipeline file in the directory, by name."""
    out = []
    for fn in sorted(os.listdir(config_dir)):
        stem, ext = os.path.splitext(fn)
        path = os.path.join(config_dir, fn)
        if ext in (".yaml", ".yml"):
            import yaml
            with open(path) as f:
                cfg = yaml.safe_load(f)
        elif ext == ".json":
            with open(path) as f:
                cfg = json.load(f)
        else:
            continue
        out.append((stem, cfg))
    return out


def run_once(config_dir: str, device) -> Dict[str, Any]:
    """Run every pipeline of the directory once; returns the run's counts."""
    from .ops.kernels import field_extract_cuda as fxc
    from .ops.regex.engine import cached_engines
    from .pipeline.pipeline import CollectionPipeline
    configs = load_config_dir(config_dir)
    if not configs:
        raise FileNotFoundError(f"no pipeline config in {config_dir}")
    pipelines = [CollectionPipeline(name, cfg, device)
                 for name, cfg in configs]
    engines = cached_engines()
    fxc.reset_launch_shapes()
    for eng in engines:
        eng.reset_counts()
        if eng.kernel is not None:
            eng.kernel.record_times = device.type == "cuda"
    t0 = time.perf_counter()
    n_events = 0
    stages: Dict[str, float] = {}
    for p in pipelines:
        n_events += p.run_once()
        for k, v in p.stage_seconds.items():
            stages[k] = stages.get(k, 0.0) + v
    seconds = time.perf_counter() - t0
    kernel_s = [eng.kernel.kernel_seconds() for eng in engines
                if eng.kernel is not None]
    return {
        "device": str(device),
        "events": n_events,
        "seconds": seconds,
        "stage_seconds": stages,
        "launches": sum(e.kernel.launches for e in engines
                        if e.kernel is not None),
        "launch_shapes": [dict(asdict(shape), launches=n)
                          for shape, n in fxc.launch_shapes.items()],
        "device_batches": sum(e.device_batches for e in engines),
        "re_oversize_rows": sum(e.re_oversize_rows for e in engines),
        "re_tier_rows": sum(e.re_tier_rows for e in engines),
        "kernel_seconds": (sum(s for s in kernel_s if s is not None)
                           if any(s is not None for s in kernel_s) else None),
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="loongcollector_tpu_torch")
    parser.add_argument("--config", required=True,
                        help="pipeline config directory")
    parser.add_argument("--once", action="store_true",
                        help="process available data then exit")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--stats", default="",
                        help="write the run's counts as JSON to this path")
    args = parser.parse_args(argv)
    if not args.once:
        print("loongcollector_tpu_torch: only --once is supported; tail mode "
              "comes with the file-server slice", file=sys.stderr)
        return 2
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except NoCudaDevice as e:
        print(f"loongcollector_tpu_torch: {e}", file=sys.stderr)
        return 2
    stats = run_once(args.config, device)
    log.info("run complete: %s", json.dumps(stats))
    if args.stats:
        with open(args.stats, "w") as f:
            json.dump(stats, f)
    return 0
