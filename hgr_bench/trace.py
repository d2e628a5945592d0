"""The traced slice of a run: ``torch.profiler`` over the card's kernels
and the host's operations, reduced to what the per-layer readers and
the ``breakdown`` need (a copy of the device-event arithmetic of the
package's ``utils/profiling.summarize``: busy time is the union of the
device events' intervals, the window spans every event of the trace).
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

import torch


class Slice:
    """A profiler over a bounded slice of the window, synchronized at both
    ends so that it holds its own work only; ``started`` and ``stopped``
    on ``time.monotonic``'s clock. The events are reduced after the
    window (``summary``)."""

    def __init__(self):
        self.prof = None
        self.started = self.stopped = None
        self._summary: Optional[Dict] = None

    @property
    def running(self) -> bool:
        return self.started is not None and self.stopped is None

    def start(self) -> None:
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.started = time.monotonic()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.stopped = time.monotonic()
        self.prof.__exit__(None, None, None)

    def summary(self) -> Optional[Dict]:
        if self.stopped is None:
            return None
        if self._summary is None:
            self._summary = summarize(self.prof.events())
        return self._summary


def _union(spans: List[Tuple[float, float]]):
    """Merged, sorted intervals."""
    out = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def summarize(events, top: int = 10) -> Dict:
    """Seconds: ``busy_s`` and ``window_s``; ``kernels`` {name: [seconds,
    count]} of every device event; ``device_ops`` the ``top`` longest by
    name; ``idle_gaps`` the ``top`` longest gaps between busy intervals,
    each named by the host operation that overlaps it most (the shortest
    such, where several cover it)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    kernels: Dict[str, list] = {}
    first = last = None
    for ev in events:
        s, t = ev.time_range.start, ev.time_range.end
        first = s if first is None else min(first, s)
        last = t if last is None else max(last, t)
        if ev.device_type == cuda:
            if getattr(ev, "is_user_annotation", False):
                continue
            dev.append((s, t))
            row = kernels.setdefault(ev.name, [0.0, 0])
            row[0] += (t - s) / 1e6
            row[1] += 1
        else:
            host.append((s, t, ev.name))
    busy = _union(dev)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:top]
    named = []
    for length, s, t in gaps:
        best = None
        for hs, ht, name in host:
            ov = min(t, ht) - max(s, hs)
            if ov > 0:
                key = (ov, -(ht - hs))
                if best is None or key > best[0]:
                    best = (key, name)
        named.append([best[1] if best else "(no host op)", length / 1e6])
    ops = sorted(([k, v[0]] for k, v in kernels.items()),
                 key=lambda r: -r[1])[:top]
    window = (last - first) / 1e6 if first is not None else 0.0
    return {"busy_s": sum(t - s for s, t in busy) / 1e6, "window_s": window,
            "kernels": kernels, "device_ops": [[k[:200], v] for k, v in ops],
            "idle_gaps": named}


def kernel_seconds(summary: Dict, *prefixes: str) -> float:
    """Device seconds of the kernels whose function names start with a
    prefix: a demangled name puts a return type or a namespace before
    the function's name and its template arguments after it."""
    pat = re.compile(r"(^|[\s:])(" + "|".join(map(re.escape, prefixes))
                     + r")")
    return sum(v[0] for k, v in summary["kernels"].items() if pat.search(k))
