"""Serving in the port (hgr_tpu_torch/serve, hgr_tpu_torch/cli/serve.py):
the micro-batcher's semantics, the classifier service against the JAX
package's on the same weights, and the HTTP front end.
"""

import argparse
import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgr_tpu.models import MultiTaskNet as JaxMultiTaskNet
from hgr_tpu.serve import ClassifierService as JaxClassifierService
from hgr_tpu_torch.cli import serve as cli_serve
from hgr_tpu_torch.config import DEFAULT_NAMES
from hgr_tpu_torch.models import MultiTaskNet
from hgr_tpu_torch.serve import ClassifierService, MicroBatcher, ServeMetrics
from hgr_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

NAMES = {"fist": 2, "palm": 8}


def _sum_runner(calls):
    def run_batch(stacked):
        calls.append(stacked.shape[0])
        return [float(x.sum()) for x in stacked]

    return run_batch


# -- micro-batcher (tests/test_serve.py semantics) -------------------------


def test_batch_pads_to_bucket_and_orders_results():
    calls = []
    mb = MicroBatcher(_sum_runner(calls), max_batch=8, max_wait_ms=200.0)
    try:
        time.sleep(0.05)  # let the dispatcher block on an empty queue
        futs = [mb.submit(np.full((1,), float(i))) for i in range(3)]
        assert [f.result(timeout=10.0) for f in futs] == [0.0, 1.0, 2.0]
        assert 4 in calls  # 3 requests padded up to the 4-bucket
        assert mb.metrics.snapshot()["padded_items"] >= 1
    finally:
        mb.stop()


def test_concurrent_requests_share_a_batch():
    calls = []
    release = threading.Event()

    def run_batch(stacked):
        release.wait(5.0)
        calls.append(stacked.shape[0])
        return [float(x.sum()) for x in stacked]

    mb = MicroBatcher(run_batch, max_batch=16, max_wait_ms=50.0)
    try:
        futs = [mb.submit(np.full((2,), float(i))) for i in range(8)]
        release.set()
        assert [f.result(timeout=10.0) for f in futs] == [
            2.0 * i for i in range(8)]
        assert sum(calls) >= 8 and len(calls) <= 2
        assert all(c in (1, 2, 4, 8, 16) for c in calls)
    finally:
        mb.stop()


@pytest.mark.parametrize("pipelined", [False, True])
def test_runner_error_propagates_to_every_future(pipelined):
    def boom(stacked):
        raise RuntimeError("boom")

    kw = (dict(dispatch_batch=lambda s: s, materialize=boom,
               pipeline_depth=2) if pipelined else dict(run_batch=boom))
    mb = MicroBatcher(max_batch=4, max_wait_ms=20.0, **kw)
    try:
        futs = [mb.submit(np.zeros((1,))) for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=10.0)
        assert mb.metrics.snapshot()["errors"] == 3
    finally:
        mb.stop()


def test_submit_many_roundtrip_and_error():
    calls = []
    mb = MicroBatcher(_sum_runner(calls), max_batch=8, max_wait_ms=50.0)
    try:
        fut = mb.submit_many([np.full((2,), float(i)) for i in range(5)])
        assert fut.result(timeout=10.0) == [2.0 * i for i in range(5)]
        assert mb.metrics.snapshot()["requests"] == 5
        assert mb.submit_many([]).result(timeout=1.0) == []
    finally:
        mb.stop()

    def run_batch(stacked):
        raise RuntimeError("boom")

    mb = MicroBatcher(run_batch, max_batch=4, max_wait_ms=20.0)
    try:
        fut = mb.submit_many([np.zeros((1,)) for _ in range(6)])
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=10.0)
    finally:
        mb.stop()


def test_stop_rejects_new_and_fails_queued():
    started, block = threading.Event(), threading.Event()

    def run_batch(stacked):
        started.set()
        block.wait(5.0)
        return [0.0] * stacked.shape[0]

    mb = MicroBatcher(run_batch, max_batch=1, max_wait_ms=1.0)
    f1 = mb.submit(np.zeros((1,)))
    assert started.wait(5.0)
    f2 = mb.submit(np.zeros((1,)))
    block.set()
    mb.stop()
    assert f1.result(timeout=10.0) == 0.0
    with pytest.raises(RuntimeError, match="stopped"):
        mb.submit(np.zeros((1,)))
    with pytest.raises(RuntimeError, match="stopped"):
        mb.submit_many([np.zeros((1,))])
    if f2.exception(timeout=10.0) is not None:
        assert "stopped" in str(f2.exception())


def test_stop_fails_a_batch_dispatched_after_the_drain():
    """A dispatch still running when stop() gives up waiting for it must
    not leave its futures unresolved once it returns (the window noted
    at hgr_tpu/serve/engine.py:296)."""
    entered, release = threading.Event(), threading.Event()

    def dispatch_batch(stacked):
        entered.set()
        release.wait(10.0)
        return stacked

    mb = MicroBatcher(dispatch_batch=dispatch_batch,
                      materialize=lambda h: [float(x.sum()) for x in h],
                      pipeline_depth=2, max_batch=1, max_wait_ms=1.0)
    f = mb.submit(np.ones((2,)))
    assert entered.wait(5.0)
    mb.stop(timeout=0.2)  # dispatcher still inside dispatch_batch
    release.set()
    with pytest.raises(RuntimeError, match="stopped"):
        f.result(timeout=5.0)


def test_hard_stop_unwedges_blocked_dispatcher():
    release, dispatched = threading.Event(), threading.Event()

    def dispatch_batch(stacked):
        dispatched.set()
        return stacked

    def materialize(handle):
        release.wait(20.0)
        return [float(x.sum()) for x in handle]

    mb = MicroBatcher(dispatch_batch=dispatch_batch,
                      materialize=materialize, pipeline_depth=1,
                      max_batch=2, max_wait_ms=1.0)
    f1 = mb.submit(np.full((2,), 1.0))
    assert dispatched.wait(5.0)
    dispatched.clear()
    f2 = mb.submit(np.full((2,), 2.0))
    assert dispatched.wait(5.0)
    t0 = time.monotonic()
    mb.stop(timeout=0.5)
    assert time.monotonic() - t0 < 5.0
    with pytest.raises(RuntimeError, match="stopped"):
        f2.result(timeout=10.0)
    release.set()
    f1.exception(timeout=10.0)


def test_metrics_snapshot_fields():
    m = ServeMetrics()
    m.record_batch(3, 4, [0.001, 0.002, 0.003])
    snap = m.snapshot()
    assert (snap["requests"], snap["batches"], snap["padded_items"]) == (
        3, 1, 1)
    assert snap["batch_hist"] == {4: 1}
    assert snap["latency_ms"]["p50"] == pytest.approx(2.0, abs=0.5)


# -- classifier service ----------------------------------------------------


@pytest.fixture(scope="module")
def weights48():
    model = JaxMultiTaskNet(image_size=(48, 48),
                            precision=jax.lax.Precision.HIGHEST)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 48, 48, 3)),
                           train=False)
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def service48(weights48):
    model = MultiTaskNet(image_size=(48, 48)).eval()
    model.load_state_dict(from_flax(weights48[1]), strict=True)
    svc = ClassifierService(model, class_names=NAMES, max_batch=4,
                            max_wait_ms=5.0)
    svc.warm()
    yield svc
    svc.stop()


def test_service_matches_jax_service(weights48, service48):
    """Same converted weights, same crops: probs within 1e-4 (f32,
    summation order), same labels and landmarks."""
    crops = list(np.random.RandomState(1).randint(
        0, 256, (4, 48, 48, 3), dtype=np.uint8))
    jax_svc = JaxClassifierService(*weights48, class_names=NAMES,
                                   max_batch=4, max_wait_ms=200.0)
    try:
        want = jax_svc.submit_many(crops).result(timeout=300.0)
    finally:
        jax_svc.stop()
    got = service48.submit_many(crops).result(timeout=60.0)
    for g, w in zip(got, want):
        assert set(g) == {"label", "label_name", "probs", "landmarks"}
        np.testing.assert_allclose(g["probs"], w["probs"], atol=1e-4)
        assert g["label"] == w["label"]
        assert g["label_name"] == w["label_name"]
        np.testing.assert_array_equal(g["landmarks"], w["landmarks"])


def test_service_output_contract_and_bad_shape(service48):
    crop = np.random.RandomState(0).randint(0, 256, (48, 48, 3), np.uint8)
    out = service48.classify(crop, timeout=30.0)
    assert out["probs"].shape == (19,)
    assert np.isclose(out["probs"].sum(), 1.0, atol=1e-5)
    assert out["landmarks"].shape == (21, 2)
    assert (out["landmarks"] >= 0).all() and (out["landmarks"] < 48).all()
    assert out["label"] == int(out["probs"].argmax())
    assert service48.forwards >= len(service48.batcher.buckets) + 1
    with pytest.raises(ValueError, match="expected"):
        service48.submit(np.zeros((32, 32, 3), np.uint8))


# -- HTTP front end --------------------------------------------------------


def _post(base, body):
    req = urllib.request.Request(f"{base}/classify", data=body,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def test_http_classify_end_to_end(service48):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                cli_serve.make_handler(service48))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True}
        crop = np.random.RandomState(2).randint(0, 256, (48, 48, 3),
                                                np.uint8)
        code, body = _post(base, _npy(crop))
        assert code == 200
        direct = service48.classify(crop, timeout=30.0)
        assert body["label"] == direct["label"]
        np.testing.assert_allclose(body["probs"], direct["probs"], atol=1e-6)
        assert np.asarray(body["landmarks"]).shape == (21, 2)
        # integral-valued float pixels are accepted
        assert _post(base, _npy(crop.astype(np.float64)))[1]["label"] == \
            body["label"]

        code, err = _post(base, b"\xff\xd8\xff\xe0 a jpeg body")
        assert code == 400 and "JPEG" in err["error"]
        code, err = _post(base, _npy(crop.astype(np.float32) / 255.0))
        assert code == 400 and "uint8" in err["error"]
        code, err = _post(base, _npy(np.zeros((64, 64, 3), np.uint8)))
        assert code == 400 and "geometry" in err["error"]
        assert _post(base, b"not an npy")[0] == 400

        with urllib.request.urlopen(f"{base}/stats", timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["requests"] >= 1 and "latency_ms" in stats
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5.0)


# -- CLI device selection --------------------------------------------------


def test_cli_device_defaults_to_cuda():
    args = cli_serve.build_parser().parse_args([])
    assert args.device == "cuda"
    assert args.weights == "" and args.dtype == "bfloat16"


def test_build_service_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli_serve.build_parser().parse_args(["--image_size", "48", "48"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_serve.build_service(args)


def test_build_service_on_cpu_when_asked():
    args = cli_serve.build_parser().parse_args(
        ["--device", "cpu", "--image_size", "48", "48", "--dtype", "float32",
         "--max_batch", "2"])
    svc = cli_serve.build_service(args)
    try:
        assert svc.device.type == "cpu"
        out = svc.classify(np.zeros((48, 48, 3), np.uint8), timeout=30.0)
        assert out["label_name"] in DEFAULT_NAMES
    finally:
        svc.stop()


def test_cli_main_parses_all_flags():
    ns = cli_serve.build_parser().parse_args(
        ["--weights", "w.npz", "--backbone", "gelanl", "--port", "0",
         "--max_wait_ms", "2", "--pipeline_depth", "2"])
    assert isinstance(ns, argparse.Namespace)
    assert (ns.weights, ns.backbone, ns.port, ns.pipeline_depth) == (
        "w.npz", "gelanl", 0, 2)
