"""Closed-loop clients (after the client loop of the package's
``tools/serve_bench.py``, timed from the clients' side): each client
keeps one request outstanding, sends the next when the last resolves,
and stops sending when the window closes. A request's latency is from
its submit to its future's resolution. One thread drives every client
(each resolution is queued by the future's callback), so the load
generator holds few threads of the host the service runs on."""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Tuple

import numpy as np

from hgr_bench.harness import peak_bytes, sync
from hgr_bench.trace import Slice
from hgr_bench.weights import subseed


def run(submit: Callable, make_request: Callable, clients: int,
        seed: int, seconds: float, during: Callable = None,
        timeout: float = 120.0) -> Dict:
    """Run ``clients`` closed-loop clients from a common start for
    ``seconds``. ``make_request(rng)`` gives (request key, payload) from
    the client's own seeded generator; ``submit(payload)`` a future.
    ``during(start)``, if given, runs on a thread of its own while the
    clients run. Returns ``start``, ``end`` (the window's close), and
    ``done``: (submitted, resolved, key, result or None, error or None)
    of every request."""
    rngs = [np.random.RandomState(subseed(seed, f"client{i}") % 2**32)
            for i in range(clients)]
    resolved: "queue.Queue" = queue.Queue()
    done: List[tuple] = []

    def send(i: int) -> None:
        key, payload = make_request(rngs[i])
        t0 = time.monotonic()
        try:
            fut = submit(payload)
        except Exception as exc:  # noqa: BLE001 — a refused request
            done.append((t0, time.monotonic(), key, None, repr(exc)))
            return
        fut.add_done_callback(lambda f, i=i, key=key, t0=t0: resolved.put(
            (i, key, t0, time.monotonic(), f)))

    start = time.monotonic()
    end = start + seconds
    helper = (threading.Thread(target=during, args=(start,), daemon=True)
              if during is not None else None)
    if helper is not None:
        helper.start()
    for i in range(clients):
        send(i)
    outstanding = clients - len(done)
    while outstanding:
        i, key, t0, t1, fut = resolved.get(timeout=timeout)
        outstanding -= 1
        exc = fut.exception()
        done.append((t0, t1, key, None if exc else fut.result(),
                     None if exc is None else repr(exc)))
        if time.monotonic() < end:
            before = len(done)
            send(i)
            outstanding += len(done) == before
    if helper is not None:
        helper.join(timeout=seconds + 60)
        if helper.is_alive():
            raise RuntimeError("the traced slice did not finish")
    return {"start": start, "end": end, "done": done}


def window_stats(res: Dict, items_per_request: int) -> Dict:
    """Requests and items resolved inside the window, the 95th percentile
    of their latencies (a failed request counts as missing: +inf), and
    the attempted and failed counts of the window's requests."""
    inside = [d for d in res["done"] if d[1] <= res["end"]]
    ok = [d for d in inside if d[4] is None]
    failed = [d for d in res["done"] if d[4] is not None]
    lat = np.array([d[1] - d[0] for d in ok] + [np.inf] * len(failed))
    length = res["end"] - res["start"]
    return {"length_s": length, "requests": len(ok),
            "items": len(ok) * items_per_request,
            "items_per_s": len(ok) * items_per_request / length,
            "p95_ms": float(np.percentile(lat, 95) * 1e3) if lat.size
            else float("inf"),
            "attempted": len(res["done"]), "failed": len(failed)}


def outside(res: Dict, sl, items_per_request: int):
    """(items resolved in the window outside the traced slice, the
    window's seconds outside it): the slice's profiler slows the host."""
    n = sum(1 for d in res["done"] if d[4] is None and d[1] <= res["end"]
            and not sl.started <= d[1] <= sl.stopped)
    return (n * items_per_request,
            res["end"] - res["start"] - (sl.stopped - sl.started))


def serve_window(svc, submit: Callable, make_request: Callable, ctx,
                 per: int, launches: Callable) -> Tuple[Dict, Dict, Dict, int]:
    """A serving cell's window on the service ``svc``, which it warms
    first and stops last: the allocator's peak restarted, the closed-loop clients of
    ``run`` for ``ctx.seconds``, and with ``--trace 1`` a slice of the
    traffic's ``trace_seconds`` from ``trace_after_s`` into the window,
    the service's counters and ``launches()`` (the attention forward's
    launch counter) read at its ends. ``per``: items a request. Returns
    ``run``'s result, ``window_stats``, the record that the per-layer
    readers read, and the memory peak."""
    tr, dev = ctx.traffic, ctx.device
    sl = Slice() if ctx.trace else None
    traced = {}

    def during(start):
        time.sleep(max(0.0, start + tr["trace_after_s"] - time.monotonic()))
        traced["m0"], traced["l0"] = svc.metrics.snapshot(), launches()
        sl.start()
        time.sleep(tr["trace_seconds"])
        sl.stop()
        traced["m1"], traced["l1"] = svc.metrics.snapshot(), launches()

    try:
        svc.warm()
        sync(dev)
        setup_peak = peak_bytes(dev, reset=True)
        m0 = svc.metrics.snapshot()
        res = run(submit, make_request, tr["clients"], ctx.seed, ctx.seconds,
                  during if sl is not None else None)
        m1 = svc.metrics.snapshot()
        sync(dev)
        memory_peak = max(setup_peak, peak_bytes(dev))
    finally:
        svc.stop()
    stats = window_stats(res, per)
    record = {"window_s": stats["length_s"], "items": stats["items"],
              "serve": (m0, m1), "max_batch": tr["max_batch"],
              "p95_ms": stats["p95_ms"], "flops_per_item": 1.0}
    if sl is not None and sl.summary() is not None:
        record.update(trace=sl.summary(), outside_trace=outside(res, sl, per),
                      serve_traced=(traced["m0"], traced["m1"]),
                      attention_fwd_launches=traced["l1"] - traced["l0"])
    return res, stats, record, memory_peak
