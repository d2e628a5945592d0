"""Serving load benchmark: an offered-load run against ClassifierService
(port of hgr_tpu/tools/serve_bench.py).

Concurrent clients submit crops to the micro-batching classifier; the
tool reports the achieved throughput, the request latency percentiles
and the batch-size histogram the batcher formed (``ServeMetrics``), and
the bare forward's ceiling at the largest batch, so the batcher's
overhead is their difference.

    python -m hgr_tpu_torch.tools.serve_bench [--ckpt run/weight/best.pt]
        [--requests 2048] [--clients 64] [--max_batch 128]
        [--max_wait_ms 5] [--pipeline_depth 4] [--window 1] [--bulk]
        [--device_pool] [--quantize] [--out result.json]

``--device_pool`` stages a pool of 64 crops on the card once; requests
carry int32 indices and each batch gathers its crops on the card, so the
host-to-card upload leaves the path and the full batcher machinery
remains. ``--quantize`` serves the int8 backbone, calibrated on 256
seeded noise crops as the JAX tool does. The bare ceiling: K batches at
``--max_batch`` dispatched, then read back, K = 2 and 10; the slope
between them cancels the fixed costs (``torch.cuda.synchronize`` through
the read-back, ``perf_counter``).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

POOL = 64  # crops in the pool the clients draw from


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default="",
                    help="classifier weights (the port's .pt, .npz, "
                         "reference .ckpt, orbax dir); empty = random "
                         "weights (throughput only)")
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--max_batch", type=int, default=128)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--quantize", action="store_true",
                    help="serve the int8 backbone (calibrated on noise)")
    ap.add_argument("--pipeline_depth", type=int, default=4,
                    help="batches kept in flight on the card (1 = "
                         "blocking dispatch)")
    ap.add_argument("--window", type=int, default=1,
                    help="outstanding requests per client")
    ap.add_argument("--bulk", action="store_true",
                    help="submit each client window through ONE aggregate "
                         "future (MicroBatcher.submit_many)")
    ap.add_argument("--device_pool", action="store_true",
                    help="stage the crop pool on the card once and submit "
                         "indices through the full MicroBatcher")
    ap.add_argument("--out", default="")
    ap.add_argument("--image_size", type=int, default=192)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def run_load(service, n_requests: int, n_clients: int, crops: np.ndarray,
             window: int = 1, bulk: bool = False) -> dict:
    """``n_clients`` threads submit ``n_requests`` items drawn from
    ``crops``, ``window`` outstanding per client (one aggregate future per
    window under ``bulk``); the service's metrics snapshot with the wall
    time and the achieved rate."""
    done = threading.Barrier(n_clients + 1)
    counter = {"i": 0}
    lock = threading.Lock()
    errors = []

    def client():
        try:
            rng = np.random.RandomState(threading.get_ident() % 2**31)
            while True:
                with lock:
                    take = min(window, n_requests - counter["i"])
                    if take <= 0:
                        break
                    counter["i"] += take
                picks = [crops[rng.randint(len(crops))] for _ in range(take)]
                if bulk:
                    service.submit_many(picks).result(timeout=120.0)
                    continue
                for f in [service.submit(c) for c in picks]:
                    f.result(timeout=120.0)
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)
        finally:
            done.wait()

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    done.wait()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    snap = service.metrics.snapshot()
    snap["wall_s"] = wall
    snap["achieved_rps"] = n_requests / wall
    return snap


class DevicePoolService:
    """``base``'s forward behind a MicroBatcher whose requests are int32
    indices into a crop pool staged on the card once: each batch gathers
    its crops there and runs ``base.forward_u8``."""

    def __init__(self, base, crops: np.ndarray, args):
        from hgr_tpu_torch.serve import MicroBatcher

        self.pool = torch.from_numpy(crops).to(base.device)

        def dispatch_batch(stacked_idx: np.ndarray):
            idx = torch.from_numpy(stacked_idx).to(base.device)
            return base.forward_u8(self.pool.index_select(0, idx))

        self.batcher = MicroBatcher(
            dispatch_batch=dispatch_batch, materialize=base._materialize,
            pipeline_depth=args.pipeline_depth, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, name="device-pool-serve")
        self.metrics = self.batcher.metrics

    def submit(self, idx):
        return self.batcher.submit(np.asarray(idx))

    def submit_many(self, idxs):
        return self.batcher.submit_many(idxs)

    def stop(self):
        self.batcher.stop()


def summarize(args, snap: dict, bare_fwd_rps: float) -> dict:
    """The JAX tool's result keys from the run's flags, the load's metrics
    snapshot and the bare forward ceiling (crops/s)."""
    return {
        "requests": args.requests,
        "clients": args.clients,
        "max_batch": args.max_batch,
        "max_wait_ms": args.max_wait_ms,
        "pipeline_depth": args.pipeline_depth,
        "device_pool": args.device_pool,
        "window": args.window,
        "bulk": args.bulk,
        "quantized": args.quantize,
        "bare_fwd_crops_s": round(bare_fwd_rps),
        "batcher_overhead_pct": round(
            100.0 * (1.0 - snap["achieved_rps"] / bare_fwd_rps), 1),
        **snap,
    }


def _bare_rate(dispatch, materialize, batch: int) -> float:
    """Crops/s of the bare forward at ``batch``: K batches dispatched, then
    read back, for K = 2 and 10; the slope cancels the fixed costs."""
    def seconds(k):
        for h in [dispatch() for _ in range(k)]:
            materialize(h)
        t0 = time.perf_counter()
        for h in [dispatch() for _ in range(k)]:
            materialize(h)
        return time.perf_counter() - t0

    per_batch = max((seconds(10) - seconds(2)) / 8, 1e-9)
    return batch / per_batch


def run(args) -> Tuple[dict, int]:
    """The result and the forwards the model ran (calibration and warm-up
    included)."""
    from hgr_tpu_torch.infer.weights import (
        build_classifier,
        load_classifier_weights,
    )
    from hgr_tpu_torch.serve import ClassifierService

    size = (args.image_size, args.image_size)
    model = build_classifier(load_classifier_weights(args.ckpt, size), size,
                             torch.bfloat16, device=args.device)
    calib = []
    if args.quantize:
        from hgr_tpu_torch.infer.quant import quantize_model

        rng = np.random.RandomState(0)
        calib = [torch.from_numpy(rng.uniform(
            -2.1, 2.6, (256,) + size + (3,)).astype(np.float32)
        ).to(args.device)]
        quantize_model(model, calib, need_attnmap=False)
    service = ClassifierService(
        model, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        pipeline_depth=args.pipeline_depth)
    crops = np.random.RandomState(1).randint(
        0, 255, (POOL,) + size + (3,), dtype=np.uint8)
    try:
        if args.device_pool:
            base, service = service, DevicePoolService(service, crops, args)
            service.batcher.warm(np.int32(0))
            idx = np.zeros((args.max_batch,), np.int32)
            bare = lambda: service.batcher.dispatch_batch(idx)  # noqa: E731
            crops = np.arange(POOL, dtype=np.int32)  # requests are indices
        else:
            base = service
            service.warm()
            batch = np.random.RandomState(2).randint(
                0, 255, (args.max_batch,) + size + (3,), dtype=np.uint8)
            bare = lambda: service._dispatch(batch)  # noqa: E731
        rate = _bare_rate(bare, base._materialize, args.max_batch)
        print(f"bare fwd ceiling: {rate:.0f} crops/s at batch "
              f"{args.max_batch}", flush=True)
        snap = run_load(service, args.requests, args.clients, crops,
                        window=args.window, bulk=args.bulk)
    finally:
        service.stop()
    return summarize(args, snap, rate), base.forwards + len(calib)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    result, _ = run(args)
    print(json.dumps(result, indent=2), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
