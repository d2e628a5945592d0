"""Profiling and timing hooks (port of hgr_tpu/utils/profiling.py).

``trace`` records ``torch.profiler`` (the card's kernels through CUPTI
when the card is in use) into ``log_dir``: ``trace.json`` (Chrome trace
format) and ``profile_summary.json`` (device time by kernel name and the
device's idle share, ``summarize``), the files that
``fit(profile_steps=...)`` writes. ``StepTimer`` is the JAX package's
wall-clock timer with the same ``summary()`` keys; ``median_ms`` times a
call on the card with CUDA events (the attribution tools); ``flops_of``
counts a call's FLOPs with ``torch.utils.flop_counter.FlopCounterMode``
where the JAX package asks XLA's cost analysis.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


def summarize(prof, top: int = 15) -> Dict[str, Any]:
    """Device time by kernel name and the device's idle share over a
    profiled window, from the trace's device events (kernels, copies and
    sets; not the ranges that ``record_function`` annotations draw on the
    device timeline): busy = the union of their intervals, window = first
    to last event of the trace (host and device events share one clock)."""
    cuda = torch.autograd.DeviceType.CUDA
    by_name: Dict[str, list] = {}
    spans, first, last = [], None, None
    for ev in prof.events():
        s, t = ev.time_range.start, ev.time_range.end
        first = s if first is None else min(first, s)
        last = t if last is None else max(last, t)
        if ev.device_type == cuda and not getattr(ev, "is_user_annotation",
                                                   False):
            spans.append((s, t))
            row = by_name.setdefault(ev.name[:160], [0.0, 0])
            row[0] += (t - s) / 1e3
            row[1] += 1
    busy, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    window = (last - first) if first is not None else 0.0
    rows = sorted(({"name": k, "device_ms": v[0], "count": v[1]}
                   for k, v in by_name.items()), key=lambda r: -r["device_ms"])
    return {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": (1.0 - busy / window) if spans and window
            else None,
            "device_events": len(spans), "top_device_ops": rows[:top]}


def start(device: torch.device):
    """A running ``torch.profiler`` over the host and, for a card, the
    card's kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    return prof


def stop(prof, device: torch.device, log_dir: str) -> Dict[str, Any]:
    """End ``prof`` (after the card's queued work) and write
    ``trace.json`` and ``profile_summary.json`` into ``log_dir``; returns
    the summary."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    summary = summarize(prof)
    with open(os.path.join(log_dir, "profile_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


@contextlib.contextmanager
def trace(log_dir: str, device="cuda") -> Iterator[Any]:
    """Profile the block on ``device`` into ``log_dir`` (view
    ``trace.json`` in Perfetto or chrome://tracing)."""
    device = torch.device(device)
    prof = start(device)
    try:
        yield prof
    finally:
        stop(prof, device, log_dir)


class StepTimer:
    """Wall-clock step timing with percentile summary. Work on the card
    must end in ``torch.cuda.synchronize()`` inside the timed block, or
    the timer reads the launch, not the work."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "steps": len(t),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p90_ms": float(np.percentile(t, 90) * 1e3),
            "p99_ms": float(np.percentile(t, 99) * 1e3),
        }


def median_ms(fn: Callable, *args, iters: int = 20, warmup: int = 3,
              device="cuda") -> float:
    """Median milliseconds of ``fn(*args)`` over ``iters`` calls after
    ``warmup``: each call between two CUDA events on the card, by
    ``perf_counter`` on the CPU."""
    device = torch.device(device)
    for _ in range(warmup):
        fn(*args)
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn(*args)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def flops_of(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one call ``fn(*args)`` as torch's FLOP counter counts
    them (matmuls, convolutions and attention; 2 per multiply-add), or
    None where the call fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:  # noqa: BLE001 — the JAX function's contract
        return None
