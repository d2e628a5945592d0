"""The two-stage path of the port (hgr_tpu_torch/infer/detect.py,
serve/engine.py:DetectorService, cli/serve.py's /detect, cli/detect.py,
cli/convert.py, utils/draw.py) held against the JAX package on the CPU.

The JAX pipeline is one jitted graph; its models are swapped for
``precision=HIGHEST`` ones before the first call (its default f32 matmul
precision is low even on the CPU). Both packages get the same weights:
the repository's detector fixture and a seeded classifier init, through
``from_flax``. Frames are seeded noise at 180x320, the detector at 160
px and the classifier at 64 px (tests/test_yolo_infer.py:91's sizes),
with the score gate off (-1) so that every frame is answered.
"""

import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgr_tpu.config import DEFAULT_NAMES
from hgr_tpu.infer import detect as jdetect
from hgr_tpu.infer.weights import load_classifier_weights as jax_cls_weights
from hgr_tpu.models import MultiTaskNet as JaxMultiTaskNet
from hgr_tpu.models import yolo as jyolo
from hgr_tpu_torch.infer import detect as tdetect
from hgr_tpu_torch.models import yolo as tyolo
from hgr_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)
HI = jax.lax.Precision.HIGHEST
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "yolo_smoke_weights.npz")
DET, CLS, FRAME_HW = 160, (64, 64), (180, 320)
# Landmarks: the JAX pipeline's crop is its exact warp under jax.jit,
# which misreads whole pixels where a sample lands on the grid (ROADMAP
# C findings; the port equals the eager warp, test_crop_stage_...). A
# misread pixel can move a heatmap's argmax by one cell, and a cell is
# side / 16 frame pixels at 64 px (16 x 16 heatmaps); with the int32 cast
# that is at most ceil(side / 16) + 1 px. Everything else is held tight.
LANDMARK_CELLS = 1


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def weights():
    """(classifier tree, detector tree): a seeded small classifier at
    64 px and the detector fixture, float32 Flax trees."""
    return (_f32(jax_cls_weights("", image_size=CLS)),
            _f32(jyolo.load_npz_weights(FIXTURE)))


def _jax_pipeline(weights, score_thresh=-1.0):
    pipe = jdetect.HandGesturePipeline(
        weights[0], weights[1], DEFAULT_NAMES, det_img_size=DET,
        cls_img_size=CLS, score_thresh=score_thresh, dtype=jnp.float32)
    pipe.classifier = JaxMultiTaskNet(dtype=jnp.float32, image_size=CLS,
                                      backbone="small", precision=HI)
    pipe.detector = jyolo.YOLOv7Tiny(num_classes=1, dtype=jnp.float32,
                                     precision=HI)
    return pipe


def _port_pipeline(weights, score_thresh=-1.0):
    return tdetect.HandGesturePipeline(
        from_flax(weights[0]), from_flax(weights[1]), DEFAULT_NAMES,
        det_img_size=DET, cls_img_size=CLS, score_thresh=score_thresh,
        dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def pipelines(weights):
    return _jax_pipeline(weights), _port_pipeline(weights)


def _frames(seed, n=4):
    return np.random.RandomState(seed).randint(0, 256, (n,) + FRAME_HW + (3,),
                                               np.uint8)


def _assert_results_match(got, want, note=""):
    """Labels and boxes equal, scores 1e-5, landmarks within
    LANDMARK_CELLS heatmap cells."""
    assert (got is None) == (want is None), note
    if got is None:
        return
    assert got["label"] == want["label"], note
    assert got["label_name"] == want["label_name"]
    np.testing.assert_array_equal(np.asarray(got["box"]),
                                  np.asarray(want["box"]), err_msg=note)
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-5,
                               rtol=1e-5, err_msg=note)
    box = np.asarray(want["box"], np.float64).reshape(-1)
    side = max(box[2] - box[0], box[3] - box[1])
    cell = side / (CLS[0] // 4)
    d = np.abs(np.asarray(got["landmarks"], np.float64)
               - np.asarray(want["landmarks"], np.float64))
    assert d.max() <= LANDMARK_CELLS * np.ceil(cell) + 1, (note, d.max())


# -- stages ------------------------------------------------------------------

def _jax_det_input(frames, h, w):
    """The JAX graph's letterbox (hgr_tpu/infer/detect.py:115-126), run
    eagerly with the JAX package's functions."""
    from hgr_tpu.ops.resize import resize_bilinear

    r, dw, dh, uw, uh = jdetect.letterbox_params(h, w, DET)
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    resized = resize_bilinear(jnp.asarray(frames, jnp.float32)[..., ::-1],
                              (uh, uw))
    canvas = jnp.pad(resized, ((0, 0), (top, DET - uh - top),
                               (left, DET - uw - left), (0, 0)),
                     constant_values=114.0)
    return np.asarray(canvas / 255.0)


def test_letterbox_and_detector_stages_match_jax(weights, pipelines):
    """The letterboxed detector input within one f32 ulp of the JAX
    graph's (the resize, tests/test_torch_yolo.py), then on the same
    input: raw heads 1e-4, decoded best boxes 1e-4 px, scores 1e-5."""
    _, tp = pipelines
    frames = _frames(1)
    want_in = _jax_det_input(frames, *FRAME_HW)
    got_in = tp.letterbox(torch.from_numpy(frames).float()).numpy()
    np.testing.assert_allclose(got_in, want_in, rtol=2**-22, atol=0)

    jm = jyolo.YOLOv7Tiny(num_classes=1, precision=HI)
    j_outs = jm.apply(weights[1], jnp.asarray(want_in), train=False)
    with torch.no_grad():
        t_outs = tp.detector(torch.from_numpy(want_in))
    for g, w in zip(t_outs, j_outs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
    jb, js = jyolo.best_box(jyolo.decode_predictions(j_outs))
    tb, ts = tyolo.best_box(tyolo.decode_predictions(t_outs))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_crop_stage_matches_eager_jax_warp(pipelines):
    """The classifier crop of the ORIGINAL frame from the square box:
    the port's affine and exact warp against the JAX package's
    build_affine and batched_affine_warp run eagerly (not jitted), on
    boxes of even and odd sides: affine 1e-6, crop pixels 0.02 on the
    0-255 scale (the warp tests' tolerance, tests/test_warp_pallas.py:35:
    the inverse affine rounds differently by an ulp, which moves a sample
    position by ~1e-5 px at these scales)."""
    from hgr_tpu.ops.affine import build_affine as jaffine
    from hgr_tpu.ops.warp import batched_affine_warp as jwarp
    from hgr_tpu_torch.ops.affine import build_affine
    from hgr_tpu_torch.ops.warp import batched_affine_warp

    frames = _frames(2).astype(np.float32)
    boxes = np.array([[17, -20, 201, 150], [60, 30, 121, 92],
                      [-40, 10, 90, 175], [100, 2, 300, 179]], np.float32)
    side = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    center = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2,
                       (boxes[:, 1] + boxes[:, 3]) / 2], -1)
    jm = np.asarray(jaffine(jnp.asarray(center), jnp.ones(4), jnp.zeros(4),
                            jnp.asarray(side), (64.0, 64.0)))
    tm = build_affine(torch.from_numpy(center), torch.ones(4),
                      torch.zeros(4), torch.from_numpy(side), (64.0, 64.0))
    np.testing.assert_allclose(tm.numpy(), jm, atol=1e-6, rtol=1e-6)
    want = np.asarray(jwarp(jnp.asarray(frames), jnp.asarray(jm), CLS))
    got = batched_affine_warp(torch.from_numpy(frames),
                              torch.from_numpy(jm), CLS).numpy()
    np.testing.assert_allclose(got, want, atol=0.02)


def test_classifier_stage_matches_jax(weights, pipelines):
    """The classifier head of the pipeline on the same normalized crops:
    logits 1e-4, heatmap argmax landmarks equal."""
    from hgr_tpu.models.multitasknet import heatmaps_to_nchw as jnchw
    from hgr_tpu.ops.heatmap import get_max_preds as jmax
    from hgr_tpu_torch.models.multitasknet import heatmaps_to_nchw
    from hgr_tpu_torch.ops.heatmap import get_max_preds

    _, tp = pipelines
    x = np.random.RandomState(3).randn(4, *CLS, 3).astype(np.float32)
    jm = JaxMultiTaskNet(dtype=jnp.float32, image_size=CLS, precision=HI)
    jl, jh, _ = jm.apply(weights[0], jnp.asarray(x), train=False,
                         need_attnmap=False)
    with torch.no_grad():
        tl, th, _ = tp.classifier(torch.from_numpy(x), need_attnmap=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(
        get_max_preds(heatmaps_to_nchw(th))[0].numpy(),
        np.asarray(jmax(jnchw(jh))[0]))


# -- the whole pipeline -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_infer_frames_matches_jax_pipeline(pipelines, seed):
    """HandGesturePipeline.infer_frames on 4 frames, port against the JAX
    pipeline: labels and boxes equal, scores 1e-5, landmarks within one
    heatmap cell (LANDMARK_CELLS: the jitted JAX warp's misread pixels)."""
    jp, tp = pipelines
    frames = _frames(seed)
    want = jp.infer_frames(frames)
    got = tp.infer_frames(frames)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["box"].dtype == np.int32 and g["box"].shape == (4,)
        assert g["landmarks"].dtype == np.int32
        assert g["landmarks"].shape == (21, 2)
        _assert_results_match(g, w, f"frame {i}")
    assert tp.infer_frame(frames[0])["label"] == got[0]["label"]


def test_score_gate_geometry_cache_and_annotate(weights, pipelines):
    """The gate drops a frame at or below the threshold (None, as the JAX
    pipeline); the geometry cache holds at most 8 entries; annotate
    draws what the JAX package's annotate draws."""
    jp, tp = pipelines
    frames = _frames(6, n=1)
    gated = _port_pipeline(weights, score_thresh=2.0)
    assert gated.infer_frames(frames) == [None]
    for k in range(10):
        tp.geometry(64 + 32 * k, 96)
    assert len(tp._geometries) == 8 and (64, 96) not in tp._geometries
    result = tp.infer_frame(frames[0])
    want = jp.annotate(frames[0].copy(), result)
    got = tp.annotate(frames[0].copy(), result)
    np.testing.assert_array_equal(got, want)
    frame = frames[0]
    assert tp.annotate(frame, None) is frame


@pytest.mark.parametrize("use_cv2", [True, False])
def test_draw_matches_jax(monkeypatch, use_cv2):
    """draw_bones / draw_joints equal the JAX package's, through cv2 and
    through the numpy fallback."""
    from hgr_tpu.utils import draw as jdraw
    from hgr_tpu_torch.utils import draw as tdraw

    if not use_cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)  # ImportError
    rng = np.random.RandomState(7)
    img = rng.randint(0, 256, (90, 120, 3), np.uint8)
    pts = rng.randint(-5, 125, (21, 2))
    for fn in ("draw_bones", "draw_joints"):
        want = getattr(jdraw, fn)(img.copy(), pts)
        got = getattr(tdraw, fn)(img.copy(), pts)
        np.testing.assert_array_equal(got, want, err_msg=fn)


def test_pipeline_refuses_cuda_without_a_card(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cpu'"):
        tdetect.HandGesturePipeline(
            from_flax(weights[0]), from_flax(weights[1]), DEFAULT_NAMES,
            det_img_size=DET, cls_img_size=CLS)


# -- serving: DetectorService and POST /detect -------------------------------

def test_detector_service_matches_direct_pipeline(pipelines):
    """Frames through the batcher (pipelined) equal the direct pipeline's
    answers; a frame of another geometry is refused."""
    from hgr_tpu_torch.serve import DetectorService

    _, tp = pipelines
    svc = DetectorService(tp, frame_hw=FRAME_HW, max_batch=4,
                          max_wait_ms=20.0)
    try:
        frames = _frames(8, n=3)
        results = [f.result(timeout=120.0)
                   for f in [svc.submit(f) for f in frames]]
        many = svc.submit_many(list(frames)).result(timeout=120.0)
        direct = tp.infer_frames(frames)
        for got, agg, want in zip(results, many, direct):
            assert got["label"] == want["label"] == agg["label"]
            np.testing.assert_array_equal(got["box"], want["box"])
            np.testing.assert_array_equal(got["landmarks"],
                                          want["landmarks"])
        with pytest.raises(ValueError, match="expected"):
            svc.submit(np.zeros((64, 64, 3), np.uint8))
        assert svc.metrics.snapshot()["requests"] == 6
    finally:
        svc.stop()


def _serve(make_handler, service, detector):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                make_handler(service, detector))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(base, path, body):
    req = urllib.request.Request(f"{base}{path}", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _jpeg(a, quality=90):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(a[..., ::-1])).save(
        buf, format="JPEG", quality=quality)
    return buf.getvalue()


def test_http_detect_matches_jax_server(weights, pipelines):
    """POST /detect through the port's handler and through the JAX
    package's (cli/serve.py), same weights and bodies: a .npy frame, a
    JPEG frame (both decode natively here), and an off-size .npy and
    JPEG (resized on the host, cv2's INTER_LINEAR arithmetic in both; the
    answer mapped back to the client's geometry). Labels and label names
    equal, boxes 1e-6 (both scale the same integers), scores 1e-5,
    landmarks within one heatmap cell scaled to the client; /stats has
    the detect block."""
    from cli.serve import make_handler as jax_make_handler
    from hgr_tpu.serve import DetectorService as JaxDetectorService
    from hgr_tpu_torch.cli.serve import make_handler
    from hgr_tpu_torch.serve import DetectorService

    jp, tp = pipelines
    frame = _frames(9, n=1)[0]
    big = np.random.RandomState(10).randint(0, 256, (270, 480, 3), np.uint8)
    bodies = {"npy": _npy(frame), "jpeg": _jpeg(frame),
              "npy_off_size": _npy(big), "jpeg_off_size": _jpeg(big)}
    answers = {}
    for name, handler, det in (
            ("port", make_handler,
             DetectorService(tp, FRAME_HW, max_batch=2, max_wait_ms=5.0)),
            ("jax", jax_make_handler,
             JaxDetectorService(jp, FRAME_HW, max_batch=2,
                                max_wait_ms=5.0))):
        httpd, thread, base = _serve(handler, _NullService(), det)
        try:
            answers[name] = {k: _post(base, "/detect", b)
                             for k, b in bodies.items()}
            answers[name]["bad"] = _post(base, "/detect", b"not an npy")
            with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
                answers[name]["stats"] = json.loads(r.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=5.0)
            det.stop()
    port, ref = answers["port"], answers["jax"]
    for k in bodies:
        assert port[k][0] == ref[k][0] == 200, (k, port[k], ref[k])
        g, w = port[k][1]["detection"], ref[k][1]["detection"]
        assert g["label"] == w["label"] and g["label_name"] == w["label_name"]
        np.testing.assert_allclose(g["box"], w["box"], atol=1e-6)
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-5,
                                   rtol=1e-5)
        scale = 1.5 if "off_size" in k else 1.0
        side = max(w["box"][2] - w["box"][0], w["box"][3] - w["box"][1])
        d = np.abs(np.asarray(g["landmarks"]) - np.asarray(w["landmarks"]))
        assert d.max() <= (np.ceil(side / scale / 16) + 1) * scale, (k, d)
    assert port["bad"][0] == ref["bad"][0] == 400
    assert port["stats"]["detect"]["requests"] == 4
    assert set(port["stats"]["detect"]) == set(ref["stats"]["detect"])


class _NullService:
    """The classifier service slot of the handlers in the /detect test
    (only its metrics are read)."""

    class metrics:  # noqa: N801 — mirrors the service attribute
        @staticmethod
        def snapshot():
            return {}


# -- the CLIs -----------------------------------------------------------------

def _jax_flags(module, capsys, monkeypatch):
    """The option strings of a root CLI, from its --help (its parser is
    built inside main)."""
    import re

    monkeypatch.setattr(sys, "argv", [module.__file__, "--help"])
    with pytest.raises(SystemExit):
        module.main()
    return set(re.findall(r"(--\w+)", capsys.readouterr().out))


def test_cli_flag_surfaces_match_the_jax_clis(capsys, monkeypatch):
    """cli.detect's and cli.convert's options are the JAX CLIs', with
    --device in place of --host_device_count, and the same defaults."""
    import cli.convert as jconvert
    import cli.detect as jdetect_cli
    from hgr_tpu_torch.cli import convert, detect

    port = {a for action in detect.build_parser()._actions
            for a in action.option_strings if a.startswith("--")}
    want = _jax_flags(jdetect_cli, capsys, monkeypatch)
    assert port == (want - {"--host_device_count"}) | {"--device"}
    args = detect.build_parser().parse_args(["--data_config", "x.yaml"])
    assert (args.det_img_size, args.score_thresh, args.dtype,
            args.batch_frames, args.pipeline_depth, args.device) == (
        416, 0.2, "bfloat16", 1, 3, "cuda")
    port = {a for action in convert.build_parser()._actions
            for a in action.option_strings if a.startswith("--")}
    assert port == _jax_flags(jconvert, capsys, monkeypatch)


def test_cli_detect_writes_the_video(tmp_path, weights):
    """cli.detect on a directory of JPEG frames on the CPU: every frame
    through the pipeline into an mp4v video of out_size frames."""
    cv2 = pytest.importorskip("cv2")
    from hgr_tpu_torch.cli import detect
    from hgr_tpu_torch.utils.convert import save_weights_npz

    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(_frames(11, n=3)):
        (frames_dir / f"{i:03d}.jpg").write_bytes(_jpeg(f))
    cls_path, det_path = str(tmp_path / "cls.npz"), str(tmp_path / "d.npz")
    save_weights_npz(weights[0], cls_path)
    save_weights_npz(weights[1], det_path)
    cfg = tmp_path / "data.yaml"
    cfg.write_text("names:\n  fist: 0\n  palm: 1\nnum_joints: 21\n"
                   "num_classes: 19\n")
    out = str(tmp_path / "out.mp4")
    args = detect.build_parser().parse_args([
        "--data_config", str(cfg), "--cls_weight", cls_path,
        "--det_weight", det_path, "--data_path", str(frames_dir),
        "--save_path", out, "--det_img_size", str(DET), "--cls_img_size",
        "64", "64", "--dtype", "float32", "--score_thresh", "-1",
        "--batch_frames", "2", "--device", "cpu"])
    assert detect.run(args) == 3
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 3


def test_cli_convert_writes_what_the_jax_cli_writes(tmp_path, capsys,
                                                    monkeypatch):
    """cli.convert --classifier on a reference .ckpt: the same .npz (keys
    and arrays) as the JAX package's cli/convert.py; --verify reloads it
    and prints a zero logit difference."""
    import cli.convert as jconvert
    from hgr_tpu_torch.cli import convert
    from hgr_tpu_torch.models.multitasknet import MultiTaskNet
    from hgr_tpu_torch.utils.torch_port import _key_map

    sd = MultiTaskNet(generator=torch.Generator().manual_seed(4)).state_dict()
    to_ref = {p: r for r, p in _key_map({}, 4, 1).items()}
    ckpt = str(tmp_path / "best.ckpt")
    torch.save({"state_dict": {"model." + to_ref[k]: v
                               for k, v in sd.items()}}, ckpt)
    mine, theirs = str(tmp_path / "mine.npz"), str(tmp_path / "theirs.npz")
    convert.main(["--classifier", ckpt, "--out", mine, "--verify"])
    assert "max |d logits| = 0.00e+00" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["convert.py", "--classifier", ckpt,
                                      "--out", theirs])
    jconvert.main()
    with np.load(mine) as a, np.load(theirs) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resolve_image_size_matches_jax(tmp_path):
    """The crop geometry of an inference entry point: the flag, then the
    run's recorded run_meta.json (beside the weights or one level up),
    then the default; as hgr_tpu.infer.weights.resolve_image_size."""
    from hgr_tpu.infer.weights import resolve_image_size as jresolve
    from hgr_tpu_torch.infer.weights import resolve_image_size

    weight = tmp_path / "weight"
    (weight / "best").mkdir(parents=True)
    (weight / "run_meta.json").write_text(json.dumps(
        {"image_size": [256, 224], "backbone": "small"}))
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "run_meta.json").write_text("{not json")
    cases = [(str(weight / "best"), None), (str(weight / "x.npz"), None),
             (str(weight / "best"), [128, 128]), ("", None),
             (str(tmp_path / "bad" / "w.npz"), None)]
    for path, flag in cases:
        assert resolve_image_size(path, flag) == tuple(jresolve(path, flag))
    assert resolve_image_size(str(weight / "best"), None) == (256, 224)
