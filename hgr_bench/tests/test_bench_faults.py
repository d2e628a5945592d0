"""A run of each cell's driver on the CPU at a small size, with the timed
path broken underneath, comes out not correct: a step that leaves the
state unchanged, a step over half of its batch, an answer altered where
it is produced. The configurations run in float32 here, where the
package and the reference compute the same mathematics, so each fault
shows against the cells' own limits."""

import copy
import time

import numpy as np
import pytest
import torch

from hgr_bench import harness
from hgr_bench.drivers import classifier_service as C
from hgr_bench.drivers import detector_service as Dt
from hgr_bench.drivers import train_epoch as T
from hgr_bench.tests.test_bench_reference import (MTN, PIPE, f32,
                                                  small_detect, small_train)

CPU = torch.device("cpu")


def correct(out) -> bool:
    return all(v <= lim for v, lim in out.checks.values())


@pytest.fixture(autouse=True)
def twopass(monkeypatch):
    import hgr_tpu_torch.data.pipeline as P

    monkeypatch.setattr(P, "auto_warp_method", lambda dev, shape: "kernel")


def train_run():
    return T.run(harness.Ctx({"name": "t"}, f32(MTN), small_train(),
                             2**31 + 31, 1.0, False, CPU, time.monotonic()))


def test_state_left_unchanged(monkeypatch):
    from hgr_tpu_torch.train.state import TrainState

    def frozen(self, grads):
        self.step += 1
        return self

    monkeypatch.setattr(TrainState, "apply_gradients", frozen)
    out = train_run()
    assert out.checks["change"][0] == pytest.approx(1.0)
    assert not correct(out)


def test_half_the_batch(monkeypatch):
    import hgr_tpu_torch.train.steps as S

    on = S._on

    def half(batch, device):
        full = on(batch, device)
        return {k: v[:len(v) // 2] for k, v in full.items()}

    monkeypatch.setattr(S, "_on", half)
    assert not correct(train_run())


def test_classify_answer_altered(monkeypatch):
    from hgr_tpu_torch.serve.engine import ClassifierService

    real = ClassifierService._materialize

    def altered(self, handle):
        out = real(self, handle)
        out[0]["probs"] = np.roll(out[0]["probs"], 1)
        return out

    monkeypatch.setattr(ClassifierService, "_materialize", altered)
    tr = copy.deepcopy(harness.load_json(harness.ROOT / "traffic"
                                         / "classify_b256.json"))
    tr.update(image_size=64, pool=16, clients=1, window_crops=4, max_batch=4,
              check_requests=50)
    out = C.run(harness.Ctx({"name": "c"}, f32(MTN), tr, 7, 1.0, False, CPU,
                            time.monotonic()))
    assert not correct(out)


def test_detect_answer_altered(monkeypatch):
    from hgr_tpu_torch.infer.detect import HandGesturePipeline

    real = HandGesturePipeline.finish_frames

    def altered(self, handle):
        out = real(self, handle)
        for r in out:
            if r is not None:
                r["box"] = r["box"] + 12
        return out

    monkeypatch.setattr(HandGesturePipeline, "finish_frames", altered)
    out = Dt.run(harness.Ctx({"name": "d"}, *small_detect(f32(PIPE)), 13,
                             2.0, False, CPU, time.monotonic()))
    assert not correct(out)
