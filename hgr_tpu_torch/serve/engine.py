"""Online serving: dynamic micro-batching around the model's forward
(port of hgr_tpu/serve/engine.py: ServeMetrics :35, _AggState/_Slot
:87-137, MicroBatcher :149, ClassifierService :477).

``MicroBatcher`` is the standard dynamic-batching loop: requests queue; a
dispatcher thread drains up to ``max_batch`` of them or waits at most
``max_wait_ms`` for stragglers; the batch pads up to the nearest
power-of-two bucket and runs as ONE forward; per-request futures resolve
with their slice. In pipelined mode the dispatcher only enqueues the
forward on the card (CUDA runs asynchronously) and a completion thread
blocks on the results in FIFO order, so host staging of the next batch
overlaps the card's work on the previous ones.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from hgr_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from hgr_tpu_torch.models.multitasknet import heatmaps_to_nchw
from hgr_tpu_torch.ops.heatmap import get_max_preds


class ServeMetrics:
    """Thread-safe request/batch counters with latency percentiles."""

    def __init__(self, max_samples: int = 8192):
        self._lock = threading.Lock()
        self._latencies: List[float] = []
        self._max_samples = max_samples
        self.requests = 0
        self.batches = 0
        self.errors = 0
        self.padded_items = 0
        self.batch_hist: Dict[int, int] = {}
        self._t0 = time.monotonic()

    def record_batch(self, n_real: int, n_padded: int,
                     request_latencies: Sequence[float]) -> None:
        with self._lock:
            self.requests += n_real
            self.batches += 1
            self.padded_items += n_padded - n_real
            self.batch_hist[n_padded] = self.batch_hist.get(n_padded, 0) + 1
            self._latencies.extend(request_latencies)
            if len(self._latencies) > self._max_samples:
                self._latencies = self._latencies[-self._max_samples:]

    def record_error(self, n: int = 1) -> None:
        with self._lock:
            self.errors += n

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            out: Dict[str, Any] = {
                "requests": self.requests,
                "batches": self.batches,
                "errors": self.errors,
                "padded_items": self.padded_items,
                "batch_hist": dict(sorted(self.batch_hist.items())),
                "requests_per_s": self.requests / elapsed,
            }
            if lat.size:
                out["latency_ms"] = {
                    "p50": float(np.percentile(lat, 50) * 1e3),
                    "p90": float(np.percentile(lat, 90) * 1e3),
                    "p99": float(np.percentile(lat, 99) * 1e3),
                    "mean": float(lat.mean() * 1e3),
                }
            return out


class _AggState:
    """Shared completion state behind one ``submit_many`` aggregate
    Future: results filled by slot index and a lock-guarded remaining
    counter; the aggregate resolves once, when the last slot lands (first
    recorded exception wins)."""

    __slots__ = ("agg", "results", "remaining", "error", "lock")

    def __init__(self, agg: Future, n: int):
        self.agg = agg
        self.results: List[Any] = [None] * n
        self.remaining = n
        self.error: Optional[BaseException] = None
        self.lock = threading.Lock()

    def land(self, i: int, value: Any, exc: Optional[BaseException]) -> None:
        with self.lock:
            if exc is not None and self.error is None:
                self.error = exc
            elif exc is None:
                self.results[i] = value
            self.remaining -= 1
            done = self.remaining == 0
        if done:
            if self.error is not None:
                self.agg.set_exception(self.error)
            else:
                self.agg.set_result(self.results)


class _Slot:
    """Future-shaped handle for one ``submit_many`` item: the subset of
    concurrent.futures.Future the dispatcher and completer touch."""

    __slots__ = ("state", "i")

    def __init__(self, state: _AggState, i: int):
        self.state = state
        self.i = i

    @staticmethod
    def cancelled() -> bool:
        return False

    def set_result(self, value: Any) -> None:
        self.state.land(self.i, value, None)

    def set_exception(self, exc: BaseException) -> None:
        self.state.land(self.i, None, exc)


def _buckets_upto(max_batch: int) -> List[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class MicroBatcher:
    """Dynamic micro-batching dispatcher around a batched runner.

    ``run_batch(inputs) -> outputs`` takes a stacked ``(B, ...)`` numpy
    array whose B is always one of ``buckets`` and returns a sequence
    indexable per item.

    Pipelined mode (``pipeline_depth`` > 1): pass ``dispatch_batch`` +
    ``materialize`` instead. ``dispatch_batch(stacked)`` must not block on
    the device; ``materialize(handle)`` blocks on the result and returns
    the per-item outputs. Up to ``pipeline_depth`` batches stay in flight.
    """

    def __init__(
        self,
        run_batch: Optional[Callable[[np.ndarray], Any]] = None,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        buckets: Optional[Sequence[int]] = None,
        metrics: Optional[ServeMetrics] = None,
        name: str = "microbatcher",
        dispatch_batch: Optional[Callable[[np.ndarray], Any]] = None,
        materialize: Optional[Callable[[Any], Any]] = None,
        pipeline_depth: int = 1,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if (dispatch_batch is None) != (materialize is None):
            raise ValueError("dispatch_batch and materialize come as a pair")
        if run_batch is None and dispatch_batch is None:
            raise ValueError("need run_batch or dispatch_batch+materialize")
        if pipeline_depth > 1 and dispatch_batch is None:
            raise ValueError(
                "pipeline_depth > 1 requires dispatch_batch+materialize "
                "(run_batch blocks, so there is nothing to overlap)")
        self.run_batch = run_batch
        self.dispatch_batch = dispatch_batch
        self.materialize = materialize
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.buckets = sorted(set(buckets or _buckets_upto(max_batch)))
        if self.buckets[-1] < max_batch:
            self.buckets.append(max_batch)
        self.metrics = metrics or ServeMetrics()
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # Hard shutdown: a dispatcher waiting on a full _inflight queue
        # fails its batch, and the completer exits without a sentinel.
        self._hard_stop = threading.Event()
        # Orders submit()'s stop-check+enqueue against stop()'s flag-set,
        # so no Future is enqueued after stop() drained the queue.
        self._submit_lock = threading.Lock()
        # Orders the dispatcher's enqueue into _inflight against stop()'s
        # hard-stop flag and final drain: once stop() holds it after
        # setting the flag, no batch can enter _inflight unseen. (The JAX
        # engine leaves a window there, hgr_tpu/serve/engine.py:296: a
        # dispatch finishing after the drain left its futures unresolved.)
        self._inflight_lock = threading.Lock()
        # In-flight pipeline: (handle, futs, t_in, n_real, n_bucket),
        # bounded at pipeline_depth (backpressure on the dispatcher).
        self._inflight: "queue.Queue" = queue.Queue(
            maxsize=self.pipeline_depth)
        self._completer: Optional[threading.Thread] = None
        if self.dispatch_batch is not None:
            self._completer = threading.Thread(
                target=self._complete_loop, name=name + "-complete",
                daemon=True)
            self._completer.start()
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True)
        self._thread.start()

    # -- client API ------------------------------------------------------

    def submit(self, x: np.ndarray) -> Future:
        """Enqueue one item; resolves to its per-item output."""
        fut: Future = Future()
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("MicroBatcher is stopped")
            self._q.put((np.asarray(x), fut, time.monotonic()))
        return fut

    def submit_many(self, xs: Sequence[np.ndarray]) -> Future:
        """Enqueue a window of items behind ONE aggregate Future that
        resolves to the list of per-item outputs (first error wins).
        Items still batch individually with other clients' items."""
        xs = [np.asarray(x) for x in xs]
        agg: Future = Future()
        if not xs:
            agg.set_result([])
            return agg
        shared = _AggState(agg, len(xs))
        now = time.monotonic()
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("MicroBatcher is stopped")
            for i, x in enumerate(xs):
                self._q.put((x, _Slot(shared, i), now))
        return agg

    def __call__(self, x: np.ndarray, timeout: Optional[float] = None):
        return self.submit(x).result(timeout=timeout)

    def warm(self, example: np.ndarray) -> None:
        """Run every bucket size once, so the first real request pays no
        one-time cost (kernel build, cuDNN algorithm choice)."""
        for b in self.buckets:
            stacked = np.broadcast_to(
                example, (b,) + tuple(example.shape)).copy()
            if self.dispatch_batch is not None:
                self.materialize(self.dispatch_batch(stacked))
            else:
                self.run_batch(stacked)

    def stop(self, timeout: float = 5.0) -> None:
        with self._submit_lock:
            self._stop.set()  # no submit can enqueue past this point
        self._q.put(None)  # wake the dispatcher
        self._thread.join(timeout=timeout)
        if self._completer is not None:
            with self._inflight_lock:
                self._hard_stop.set()
            if not self._thread.is_alive():
                try:
                    self._inflight.put_nowait(None)
                except queue.Full:
                    pass  # the completer exits via hard-stop after draining
            self._completer.join(timeout=timeout)
            # fail anything still in flight (completer exited/timed out)
            with self._inflight_lock:
                while True:
                    try:
                        item = self._inflight.get_nowait()
                    except queue.Empty:
                        break
                    if item is not None:
                        self._fail(item[1], item[3],
                                   RuntimeError("server stopped"))
        # fail any requests still queued
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("server stopped"))

    # -- dispatcher ------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    break
                batch.append(item)
            self._run(batch)

    def _run(self, batch) -> None:
        xs = [b[0] for b in batch]
        futs = [b[1] for b in batch]
        t_in = [b[2] for b in batch]
        n = len(xs)
        nb = self._bucket(n)
        stacked = np.stack(xs + [xs[-1]] * (nb - n))
        if self.dispatch_batch is not None:
            try:
                handle = self.dispatch_batch(stacked)
            except Exception as exc:
                self._fail(futs, n, exc)
                return
            item = (handle, futs, t_in, n, nb)
            while True:
                with self._inflight_lock:
                    if self._hard_stop.is_set():
                        self._fail(futs, n, RuntimeError("server stopped"))
                        return
                    try:
                        self._inflight.put(item, timeout=0.05)
                        return
                    except queue.Full:
                        pass
        try:
            outputs = self.run_batch(stacked)
        except Exception as exc:  # propagate to every caller in the batch
            self._fail(futs, n, exc)
            return
        self._resolve(outputs, futs, t_in, n, nb)

    def _complete_loop(self) -> None:
        """FIFO completion: block on the oldest in-flight batch, resolve
        its futures, while the dispatcher assembles the next batches."""
        while True:
            try:
                item = self._inflight.get(timeout=0.1)
            except queue.Empty:
                if self._hard_stop.is_set():
                    return
                continue
            if item is None:
                return
            handle, futs, t_in, n, nb = item
            try:
                outputs = self.materialize(handle)
            except Exception as exc:
                self._fail(futs, n, exc)
                continue
            self._resolve(outputs, futs, t_in, n, nb)

    def _fail(self, futs, n, exc) -> None:
        self.metrics.record_error(n)
        for f in futs:
            if not f.cancelled():
                f.set_exception(exc)

    def _resolve(self, outputs, futs, t_in, n, nb) -> None:
        done = time.monotonic()
        for i, f in enumerate(futs):
            if not f.cancelled():
                f.set_result(outputs[i])
        self.metrics.record_batch(n, nb, [done - t for t in t_in])


class ClassifierService:
    """Serves pre-cropped BGR uint8 gesture crops through the model's
    2-output forward with dynamic batching.

    Input per request: (H, W, 3) uint8 BGR crop at the model's image size.
    Output: dict(label, label_name, probs, landmarks), landmarks in crop
    pixel coordinates (heatmap argmax x image_size // heatmap_size).

    ``model`` is a ``MultiTaskNet`` holding its weights, in eval mode, on
    the device the service runs on. The forward is: /255 -> ImageNet
    normalize applied to the BGR channels with the RGB stats (a reference
    quirk kept for weight parity) -> model -> f32 softmax -> argmax decode.
    ``forwards`` counts the forwards dispatched (warm-up included).
    """

    def __init__(
        self,
        model: nn.Module,
        class_names: Optional[Dict[str, int]] = None,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        metrics: Optional[ServeMetrics] = None,
        pipeline_depth: int = 4,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self.image_size = tuple(model.image_size)
        self.id_to_name = ({v: k for k, v in class_names.items()}
                           if class_names else {})
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, device=self.device)
        self.forwards = 0
        self.batcher = MicroBatcher(
            dispatch_batch=self._dispatch, materialize=self._materialize,
            pipeline_depth=pipeline_depth, max_batch=max_batch,
            max_wait_ms=max_wait_ms, metrics=metrics,
            name="classifier-serve")
        self.metrics = self.batcher.metrics

    def _dispatch(self, stacked: np.ndarray):
        """Stage the uint8 batch and enqueue the forward; runs on the
        dispatcher thread, where inference mode must be entered (it is
        thread-local)."""
        with torch.inference_mode():
            x = torch.from_numpy(stacked)
            if self.device.type == "cuda":
                x = x.pin_memory().to(self.device, non_blocking=True)
            x = x.float() / 255.0
            x = (x - self._mean) / self._std
            logits, hmap, _ = self.model(x, need_attnmap=False)
            probs = torch.softmax(logits.float(), dim=-1)
            hm = heatmaps_to_nchw(hmap)
            lm, _ = get_max_preds(hm)
            scale = self.image_size[0] // hm.shape[-2]  # x4 at 192 -> 48
            self.forwards += 1
            return probs, lm * scale

    def _materialize(self, handle) -> List[Dict[str, Any]]:
        probs, lm = handle
        probs = probs.cpu().numpy()  # blocks until the forward is done
        lm = lm.cpu().numpy()
        labels = probs.argmax(-1)
        return [
            {
                "label": int(labels[i]),
                "label_name": self.id_to_name.get(int(labels[i]),
                                                  str(int(labels[i]))),
                "probs": probs[i],
                "landmarks": lm[i],
            }
            for i in range(len(probs))
        ]

    def _check(self, crop: np.ndarray) -> None:
        h, w = self.image_size
        if crop.shape != (h, w, 3):
            raise ValueError(
                f"expected ({h}, {w}, 3) uint8 crop, got {crop.shape}")

    def warm(self) -> None:
        h, w = self.image_size
        self.batcher.warm(np.zeros((h, w, 3), np.uint8))

    def submit(self, crop_u8: np.ndarray) -> Future:
        self._check(crop_u8)
        return self.batcher.submit(crop_u8)

    def submit_many(self, crops_u8: Sequence[np.ndarray]) -> Future:
        """One aggregate future for a window of crops."""
        for c in crops_u8:
            self._check(c)
        return self.batcher.submit_many(crops_u8)

    def classify(self, crop_u8: np.ndarray,
                 timeout: Optional[float] = None) -> Dict[str, Any]:
        return self.submit(crop_u8).result(timeout=timeout)

    def stop(self) -> None:
        self.batcher.stop()
