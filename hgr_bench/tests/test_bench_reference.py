"""The plain reference held against the package at small sizes on the CPU
(in float32 the two compute the same mathematics), and the comparisons
that decide ``correct`` failing a computation in int8, the precision
below the configurations' bf16."""

import copy
import time

import pytest
import torch

from hgr_bench import control, harness, weights
from hgr_bench.drivers import classifier_service as C
from hgr_bench.drivers import detector_service as Dt
from hgr_bench.drivers import train_epoch as T
from hgr_bench.reference import Precision, mtn, yolo
from hgr_bench.reference import augment as A
from hgr_bench.reference import serve as S

MTN = harness.load_json(harness.ROOT / "configs" / "mtn_small.json")
PIPE = harness.load_json(harness.ROOT / "configs" / "hand_pipeline.json")
CPU = torch.device("cpu")


def f32(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["model"]["compute_dtype"] = "float32"
    return cfg


def small_train(**kw):
    tr = copy.deepcopy(harness.load_json(harness.ROOT / "traffic"
                                         / "train_b256.json"))
    tr.update(batch_size=4, image_size=64, canvas_size=96, rows=40,
              orig_hw_range=[64, 160], **kw)
    return tr


@pytest.fixture
def twopass_on_cpu(monkeypatch):
    """The package's plain two-pass warp on the CPU (the card's kernel's
    algorithm; the CPU's default is the exact 4-tap warp)."""
    import hgr_tpu_torch.data.pipeline as P

    monkeypatch.setattr(P, "auto_warp_method", lambda dev, shape: "kernel")


@pytest.mark.parametrize("train", [False, True])
def test_mtn_matches_package(train):
    from hgr_tpu_torch.models import MultiTaskNet

    state = weights.mtn_state(MTN, (64, 64), 3, CPU)
    port = MultiTaskNet(image_size=(64, 64))
    port.load_state_dict(state)
    ref = mtn.from_config(MTN, (64, 64))
    ref.load_state_dict(state)
    port.train(train)
    ref.train(train)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b, _ = port(x, need_attnmap=False)
        c, d = ref(x)
    torch.testing.assert_close(c, a, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d, b, rtol=1e-5, atol=1e-5)
    assert sum(p.numel() for p in ref.parameters()) == 2_406_000 + 5_003_000


def test_seeded_weights_follow_the_package_init():
    state = weights.mtn_state(MTN, (192, 192), 2**31 + 3, CPU)
    assert sum(v.numel() for k, v in state.items()
               if not k.endswith((".mean", ".var"))) == 7_409_000
    w = state["encoder.conv1.conv.weight"]
    assert float(w.abs().max()) <= 1 / 27 ** 0.5
    assert torch.equal(state["encoder.conv1.bn.weight"], torch.ones(64))
    again = weights.mtn_state(MTN, (192, 192), 2**31 + 3, CPU)
    assert all(torch.equal(state[k], again[k]) for k in state)


def test_augment_matches_package():
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.data.pipeline import (apply_augment_batch,
                                             draw_augment_params)

    aug = MTN["train"]["augments"]
    rows = T.make_rows(16, 96, T.staging_window(aug), [64, 160],
                       weights.generator(1, "rows", CPU), CPU)
    b = {k: v.reshape((16,) + T.spec(96)[k][1]) for k, v in rows.items()}
    p = draw_augment_params(weights.generator(1, "a", CPU), 16,
                            b["sizes_hw"], AugmentConfig(**aug))
    r = A.draw(weights.generator(1, "a", CPU), 16, b["sizes_hw"], aug)
    got = apply_augment_batch(
        b["canvas"], b["orig_to_canvas"], b["sizes_hw"], b["joints"],
        b["joints_vis"], p, image_size=(64, 64), heatmap_size=(16, 16),
        warp_method="kernel")
    want = A.augment(b, r, (64, 64), 2.0)
    for k in ("image", "target", "target_weight"):
        torch.testing.assert_close(want[k], got[k], rtol=0, atol=1e-6)


def test_yolo_matches_package():
    from hgr_tpu_torch.infer.weights import load_detector_weights
    from hgr_tpu_torch.models.yolo import (YOLOv7Tiny, best_box,
                                           decode_predictions)

    path = Dt.detector_path(PIPE)
    port = YOLOv7Tiny()
    port.load_state_dict(load_detector_weights(path))
    port.eval()
    ref = yolo.load_npz(yolo.YOLOv7Tiny(), path).eval()
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        outs = port(x)
        routs = ref(x.permute(0, 3, 1, 2))
        for a, b in zip(outs, routs):
            torch.testing.assert_close(b.permute(0, 2, 3, 1), a, rtol=1e-4,
                                       atol=1e-4)
        boxes, scores = best_box(decode_predictions(outs))
        rb, rs = yolo.xyxy_scores(yolo.decode(routs))
        k = rs.argmax(-1)
        torch.testing.assert_close(rb[torch.arange(2), k], boxes, rtol=1e-4,
                                   atol=1e-3)


def test_detect_pipeline_parts_match_package():
    from hgr_tpu_torch.infer.detect import HandGesturePipeline
    from hgr_tpu_torch.infer.weights import load_detector_weights
    from hgr_tpu_torch.ops.affine import build_affine
    from hgr_tpu_torch.ops.warp import batched_affine_warp

    frames = torch.randint(0, 256, (2, 96, 160, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    state = weights.mtn_state(PIPE, (64, 64), 5, CPU)
    pipe = HandGesturePipeline(state, load_detector_weights(
        Dt.detector_path(PIPE)), {"a": 0}, det_img_size=128,
        cls_img_size=(64, 64), dtype=torch.float32, device="cpu")
    want, _, _ = S.letterbox(frames, 128)
    got = pipe.letterbox(frames.float())
    torch.testing.assert_close(want, got.permute(0, 3, 1, 2), rtol=0,
                               atol=1e-5)
    boxes = torch.tensor([[10.0, 20.0, 70.0, 90.0], [-5.0, 30.0, 40.0, 60.0]])
    side = torch.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    c = torch.stack([(boxes[:, 0] + boxes[:, 2]) / 2,
                     (boxes[:, 1] + boxes[:, 3]) / 2], -1)
    m = build_affine(c, torch.ones(2), torch.zeros(2), side, (64.0, 64.0))
    # positions from the affine's solve against the closed form: a few
    # ulps apart, 0.02 on the 0-255 scale (the warps' tolerance)
    torch.testing.assert_close(
        S.crop_warp(frames.float(), boxes, 64),
        batched_affine_warp(frames.float(), m, (64, 64)), rtol=0, atol=0.02)


def test_train_follows_package_in_float32(twopass_on_cpu):
    tr = small_train()
    ctx = harness.Ctx({"name": "t"}, f32(MTN), tr, 2**31 + 9, 1.0, False,
                      CPU, time.monotonic())
    out = T.run(ctx)
    assert out.attempted >= tr["check_steps"]
    # the first gradient: f32 sums in other orders
    assert out.checks["grad"][0] < 1e-5
    # Adam divides by the root of the second moment, which turns those
    # rounding differences into steps of the learning rate's size where a
    # gradient is near 0, and the later steps follow the changed weights
    for k, (v, lim) in out.checks.items():
        assert v < lim / 10, (k, v)


def test_serving_follows_package_in_float32():
    tr = copy.deepcopy(harness.load_json(harness.ROOT / "traffic"
                                         / "classify_b256.json"))
    tr.update(image_size=64, pool=16, clients=2, window_crops=4, max_batch=8,
              check_requests=3)
    out = C.run(harness.Ctx({"name": "c"}, f32(MTN), tr, 5, 1.0, False,
                            CPU, time.monotonic()))
    assert out.attempted > 0 and out.failed == 0
    for k, (v, _) in out.checks.items():
        assert v < 1e-5, (k, v)
    out = Dt.run(harness.Ctx({"name": "d"}, *small_detect(f32(PIPE)), 11,
                             2.0, False, CPU, time.monotonic()))
    assert out.attempted > 0 and out.failed == 0
    for k, (v, _) in out.checks.items():
        assert v < 1e-4, (k, v)


def small_detect(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["detector"]["image_size"] = 128
    cfg["classifier"]["image_size"] = 64
    tr = copy.deepcopy(harness.load_json(harness.ROOT / "traffic"
                                         / "detect_b64.json"))
    tr.update(frame_hw=[96, 160], hand_side=[40, 90], pool=8, clients=2,
              max_batch=4, check_frames=6)
    return cfg, tr


def test_fp8_fails_training():
    tr = small_train()
    out = control.train_numbers(MTN, tr, 2**31 + 21, CPU, "fp8")
    assert any(v > tr["limits"][k] for k, v in out.items()
               if k in tr["limits"]), out


def fails(out, limits) -> bool:
    return any(v > limits[k] for k, v in out.items() if k in limits)


def test_fp8_fails_classify():
    tr = copy.deepcopy(harness.load_json(harness.ROOT / "traffic"
                                         / "classify_b256.json"))
    tr.update(image_size=64, pool=32, window_crops=8, check_requests=4)
    out = control.classify_numbers(MTN, tr, 2**31 + 22, CPU, "fp8")
    assert fails(out, tr["limits"]), out


def test_fp8_fails_detect():
    """The detector at the cell's 416 px and frames (a few of them)."""
    cfg = copy.deepcopy(PIPE)
    cfg["classifier"]["image_size"] = 64
    tr = copy.deepcopy(harness.load_json(harness.ROOT / "traffic"
                                         / "detect_b64.json"))
    tr.update(pool=4, check_frames=4)
    out = control.detect_numbers(cfg, tr, 2**31 + 23, CPU, "fp8")
    assert fails(out, tr["limits"]), out


def test_precision_rounds_to_fp8():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = Precision("fp8").q(x)
    scale = 3 / 448  # the absolute maximum onto e4m3's largest value
    grid = (y / scale).to(torch.float8_e4m3fn).float() * scale
    assert torch.equal(y.detach(), grid)
    assert 0 < float((y - x).abs().max()) <= 3 * 2 ** -4
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(101))
    assert torch.equal(Precision().q(x), x)
    with pytest.raises(ValueError):
        Precision("int4")


def test_heatmap_gap_zero_rule():
    hm = -torch.rand(1, 4, 4) - 0.1  # every value below 0
    first = torch.zeros(4, 4, dtype=torch.bool)
    first[0, 0] = True
    assert float(S.heatmap_gap(hm, [first])[0]) == 0.0
    hm = torch.zeros(1, 4, 4)
    hm[0, 2, 3] = 1.0
    at = torch.zeros(4, 4, dtype=torch.bool)
    at[2, 3] = True
    assert float(S.heatmap_gap(hm, [at])[0]) == 0.0
    assert float(S.heatmap_gap(hm, [first])[0]) == pytest.approx(
        1.0 / float(hm.flatten().std()))
