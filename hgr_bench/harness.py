"""One run of one cell: find the cell's configuration, traffic mix,
driver and per-layer readers by name, run the driver, and assemble the
result line.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* the configuration file named by the ``configs`` entry (``file``);
* ``traffic/<traffic>.json``, whose ``driver`` names
  ``drivers/<driver>.py``;
* for each per-layer metric, ``metrics/<name>.py``, else
  ``metrics/<stem>.py`` with the stem the part of the name before its
  first dot.

A driver's ``run(ctx)`` returns an ``Outcome``; a reader's
``read(record, metric)`` returns a number or None (nothing to read).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "hgr_tpu")


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell's entry, its configuration and traffic
    (parsed JSON), the run's arguments, the device, and the process's
    start on ``time.monotonic``'s clock."""

    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    started: float


@dataclasses.dataclass
class Outcome:
    """What a driver returns. ``metrics``: end-to-end values by name;
    ``checks``: name -> (value, limit), each value at or under its limit
    for ``correct``; ``record``: what the per-layer readers read;
    ``memory_peak_bytes``: the allocator's peak when the window closed."""

    attempted: int
    failed: int
    metrics: Dict[str, float]
    checks: Dict[str, tuple]
    record: Dict[str, Any]
    memory_peak_bytes: int


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device, reset: bool = False) -> int:
    """The allocator's peak on ``device`` (0 off the card); ``reset``
    starts a new peak after reading."""
    if device.type != "cuda":
        return 0
    out = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return int(out)


def free(device) -> None:
    """Return what nothing references any more to the device."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Optional[Path] = None) -> Dict[str, Any]:
    return load_json(path or REPO / "BENCHMARK.json")


def cell(bench: Dict, name: str):
    """(workload entry, configuration, traffic) of the cell ``name``."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return (w, load_json(REPO / conf["file"]),
            load_json(ROOT / "traffic" / f"{w['traffic']}.json"))


def driver(traffic: Dict) -> Callable[[Ctx], Outcome]:
    return importlib.import_module(
        f"hgr_bench.drivers.{traffic['driver']}").run


def reader(metric_name: str) -> Callable:
    """The ``read`` of the metric's own file, else of its stem's."""
    for stem in (metric_name, metric_name.split(".")[0]):
        path = ROOT / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"hgr_bench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {metric_name!r}")


def cell_metrics(bench: Dict, name: str, kind: str):
    """The ``end_to_end`` or ``per_layer`` entries that cell ``name``
    reports: those listing it, and those with no list."""
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result_line(bench: Dict, ctx: Ctx, out: Outcome, device_name: str,
                count: int) -> Dict[str, Any]:
    """The contract's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics`` (end to end with ``--trace 0``, per layer with
    ``--trace 1``), ``device``, with a trace ``breakdown``, and last the
    compared numbers with their limits (``checks``)."""
    name = ctx.workload["name"]
    metrics = {}
    if ctx.trace:
        for m in cell_metrics(bench, name, "per_layer"):
            value = reader(m["name"])(out.record, m)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": count,
              "memory_peak_bytes": int(out.memory_peak_bytes),
              "power_limit_w": power_limit_w()}
    line = {"correct": bool(out.checks) and all(
                v <= lim for v, lim in out.checks.values()),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    summary = out.record.get("trace")
    if ctx.trace and summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line
