"""Serve the gesture classifier, and the two-stage detector, over HTTP with
dynamic micro-batching (port of cli/serve.py). Endpoints:

  POST /classify   body = a JPEG (sniffed by its magic bytes; decoded by
                   the native decoder, else PIL) or .npy bytes of a
                   (H, W, 3) uint8 BGR crop; resized on the host to the
                   served image size when needed (the numpy copy of
                   cv2.resize INTER_LINEAR that data/pipeline.py stages
                   with); response = JSON {label, label_name, probs,
                   landmarks}. Coordinates (landmarks, and /detect's box)
                   are in the client's image geometry: the host resize is
                   undone before responding.
  POST /detect     (with --det_weight) body = a JPEG or .npy of a uint8
                   BGR FULL FRAME (resized to --frame_hw when needed);
                   runs detect -> crop -> classify (infer/detect.py);
                   response = JSON {detection: {label, label_name, score,
                   box, landmarks} | null} (null: the score gate failed,
                   reference detect.py:140)
  GET  /stats      serving metrics (latency percentiles, batch sizes; a
                   "detect" block when /detect is served)
  GET  /healthz    liveness

Usage:
  python -m hgr_tpu_torch.cli.serve --weights cls.npz [--device cuda]
      [--dtype bfloat16] [--image_size H W] [--quantize calib.npy]
      [--det_weight det.npz --frame_hw 360 640]
      [--port 8000] [--max_batch 64] [--max_wait_ms 5]

``--weights`` takes a .npz written by the JAX package (save_weights_npz,
cli/convert.py), a reference .ckpt, a training checkpoint .pt of the
port or an orbax directory of the JAX package (read with tensorstore,
``infer/weights.py``); an empty value serves a seeded random init.
The crop size is ``--image_size``, else the ``image_size`` of the
``run_meta.json`` a training run wrote beside the checkpoint, else
192 x 192 (the JAX server's rule, cli/serve.py:94).
``--quantize`` takes a .npy/.npz of calibration crops (N, H, W, 3) uint8
BGR (an .npz's first array): the GELAN backbone is quantized to int8
(infer/quant.py) from them, and /classify and /detect both serve the
int8 backbone.
``--det_weight`` takes a .npz of Flax-path arrays or a yolov7-tiny .onnx;
an empty value serves a seeded random detector.
"""

from __future__ import annotations

import argparse
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

import numpy as np
import torch

_JPEG_MAGIC = b"\xff\xd8\xff"


def build_service(args):
    """Load the weights and start a warmed ``ClassifierService`` on
    ``args.device`` (the card unless ``--device cpu``)."""
    from hgr_tpu_torch.config import (
        DEFAULT_NAMES,
        DataConfig,
        load_data_config,
    )
    from hgr_tpu_torch.infer.quant import quantize_from_crops
    from hgr_tpu_torch.infer.weights import (
        build_classifier,
        load_classifier_weights,
        resolve_image_size,
    )
    from hgr_tpu_torch.serve.engine import ClassifierService

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device} but torch sees no CUDA card; pass "
            "--device cpu to serve on the CPU")
    data_cfg = (load_data_config(args.data) if args.data
                else DataConfig(names=dict(DEFAULT_NAMES)))
    image_size = resolve_image_size(args.weights, args.image_size)
    args.image_size = list(image_size)  # the detector service reuses it
    backbone = {"auto": "auto", "gelans": "small",
                "gelanl": "large"}[args.backbone]
    state = load_classifier_weights(args.weights, image_size,
                                    backbone=backbone)
    model = build_classifier(
        state, image_size,
        torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        device=device, num_joints=data_cfg.num_joints,
        num_classes=data_cfg.num_classes)
    if args.quantize:
        quantize_from_crops(model, args.quantize)
    service = ClassifierService(
        model, class_names=data_cfg.names, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, pipeline_depth=args.pipeline_depth)
    service.warm()
    return service


def build_detector_service(args, service):
    """A warmed ``DetectorService`` on ``args.device`` around the
    two-stage pipeline, with the classifier weights of ``service`` (one
    frame geometry per server, serve/engine.py): under ``--quantize``
    its int8 state too, so /detect serves the backbone /classify serves
    (cli/serve.py:131-135)."""
    from hgr_tpu_torch.config import DEFAULT_NAMES, load_data_config
    from hgr_tpu_torch.infer.detect import HandGesturePipeline
    from hgr_tpu_torch.infer.weights import load_detector_weights
    from hgr_tpu_torch.serve.engine import DetectorService

    names = (load_data_config(args.data).names if args.data
             else dict(DEFAULT_NAMES))
    pipeline = HandGesturePipeline(
        service.model.state_dict(), load_detector_weights(args.det_weight),
        names,
        cls_img_size=tuple(args.image_size),
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        device=args.device)
    detector = DetectorService(pipeline, frame_hw=tuple(args.frame_hw),
                               max_batch=args.det_max_batch,
                               max_wait_ms=args.max_wait_ms)
    detector.warm()
    return detector


def _decode_jpeg(body: bytes) -> np.ndarray:
    """JPEG bytes -> BGR uint8 (the loader's decode: native, else PIL);
    undecodable bytes are the client's error (a 400)."""
    from hgr_tpu_torch.data.loader import decode_image_bytes

    try:
        return decode_image_bytes(body)
    except OSError as exc:
        raise ValueError(f"undecodable JPEG body: {exc}") from exc


def read_image(body: bytes, target_hw) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Parse a request body as a (H, W, 3) uint8 BGR image: a JPEG (by its
    magic bytes) or .npy. An image of another geometry than
    ``target_hw`` is resized on the host (cv2.resize INTER_LINEAR's
    arithmetic, data/pipeline.py:_host_resize), as the JAX server does.
    Returns the image and the client's (H, W); anything else raises
    ValueError (a 400)."""
    from hgr_tpu_torch.data.pipeline import _host_resize

    if body[:3] == _JPEG_MAGIC:
        img = _decode_jpeg(body)
    else:
        img = np.load(io.BytesIO(body), allow_pickle=False)
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) image, got shape {img.shape}")
    if img.dtype != np.uint8:
        # A float-normalized crop cast to uint8 would be all 0s/1s; accept
        # only values that ARE uint8 pixels (cli/serve.py:201-212).
        if img.size == 0 or img.min() < 0 or img.max() > 255 or (
                np.issubdtype(img.dtype, np.floating)
                and not np.array_equal(img, np.round(img))):
            raise ValueError(
                f"expected uint8 pixels in [0, 255], got dtype {img.dtype} "
                "(float images must be sent as uint8, not normalized "
                "floats)")
    img = img.astype(np.uint8)
    orig_hw = (int(img.shape[0]), int(img.shape[1]))
    if orig_hw != tuple(target_hw):
        img = _host_resize(img, tuple(target_hw))
    return img, orig_hw


def to_client_space(pts, compiled_hw, orig_hw) -> list:
    """(..., 2) x, y points, or a flat x0, y0, x1, y1 box, from the served
    geometry back to the client's image geometry (cli/serve.py
    ``_to_client_space``)."""
    pts = np.asarray(pts, np.float64)
    sx = orig_hw[1] / compiled_hw[1]
    sy = orig_hw[0] / compiled_hw[0]
    if pts.ndim == 1:  # box [x0, y0, x1, y1]
        return (pts * np.array([sx, sy, sx, sy])).tolist()
    out = pts.copy()
    out[..., 0] *= sx
    out[..., 1] *= sy
    return out.tolist()


def make_handler(service, detector=None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet per-request stderr lines
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/stats":
                stats = service.metrics.snapshot()
                if detector is not None:
                    stats["detect"] = detector.metrics.snapshot()
                self._send(200, stats)
            else:
                self._send(404, {"error": "unknown path"})

        def _body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length",
                                                        "0")))

        def do_POST(self):
            try:
                if self.path == "/classify":
                    img, orig_hw = read_image(self._body(),
                                              service.image_size)
                    result = service.classify(img, timeout=30.0)
                    self._send(200, {
                        "label": result["label"],
                        "label_name": result["label_name"],
                        "probs": np.asarray(result["probs"]).tolist(),
                        "landmarks": to_client_space(
                            result["landmarks"], service.image_size,
                            orig_hw),
                    })
                elif self.path == "/detect" and detector is not None:
                    img, orig_hw = read_image(self._body(),
                                              detector.frame_hw)
                    result = detector.detect(img, timeout=30.0)
                    if result is None:
                        self._send(200, {"detection": None})
                        return
                    self._send(200, {"detection": {
                        "label": result["label"],
                        "label_name": result["label_name"],
                        "score": result["score"],
                        "box": to_client_space(
                            np.asarray(result["box"]).reshape(-1),
                            detector.frame_hw, orig_hw),
                        "landmarks": to_client_space(
                            result["landmarks"], detector.frame_hw,
                            orig_hw),
                    }})
                else:
                    self._send(404, {"error": "unknown path"})
            except (ValueError, EOFError) as exc:
                # EOFError: np.load on an empty/truncated body — client
                # input errors, not server faults
                self._send(400, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001 — report, don't crash
                self._send(500, {"error": str(exc)})

    return Handler


def serve_forever(service, host: str, port: int, detector=None):
    httpd = ThreadingHTTPServer((host, port),
                                make_handler(service, detector))
    eps = "POST /classify" + (", POST /detect" if detector else "")
    print(f"serving on http://{host}:{httpd.server_address[1]}  "
          f"({eps}, GET /stats)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.stop()
        if detector is not None:
            detector.stop()
    return httpd


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", default="",
                    help=".npz written by the JAX package, a reference "
                         ".ckpt, the port's .pt or a JAX orbax directory; "
                         "empty = random init from seed 0")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card, cuda "
                         "raises instead of running on the CPU")
    ap.add_argument("--data", default=None,
                    help="YAML data config (class names); default: the 19 "
                         "HaGRID classes")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--backbone", default="auto",
                    choices=["auto", "gelans", "gelanl"],
                    help="GELAN variant of the weights; auto detects it")
    ap.add_argument("--image_size", nargs=2, type=int, default=None,
                    help="crop geometry the weights were trained at; "
                         "default: the checkpoint's run_meta.json, else "
                         "192 192")
    ap.add_argument("--quantize", default=None,
                    help="calibration crops (.npy/.npz, (N, H, W, 3) uint8 "
                         "BGR): serve an int8 backbone (PTQ)")
    ap.add_argument("--det_weight", default=None,
                    help="detector weights (.npz / .onnx; empty = random "
                         "init from seed 0): enables POST /detect for "
                         "full frames")
    ap.add_argument("--frame_hw", nargs=2, type=int, default=[360, 640],
                    help="full-frame geometry for /detect (one geometry "
                         "per server)")
    ap.add_argument("--det_max_batch", type=int, default=16)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max_batch", type=int, default=64)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--pipeline_depth", type=int, default=4,
                    help="batches kept in flight on the device")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    service = build_service(args)
    detector = (build_detector_service(args, service)
                if args.det_weight is not None else None)
    serve_forever(service, args.host, args.port, detector)


if __name__ == "__main__":
    main()
