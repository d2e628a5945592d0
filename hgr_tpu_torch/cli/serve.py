"""Serve the gesture classifier over HTTP with dynamic micro-batching
(port of cli/serve.py). Endpoints:

  POST /classify   body = .npy bytes of a (H, W, 3) uint8 BGR crop at the
                   served image size; response = JSON
                   {label, label_name, probs, landmarks} (landmarks in
                   crop pixels). A JPEG body gets a 400 until the native
                   decoder is ported; a crop of another size gets a 400
                   (the host resize needs cv2, which the port does not
                   use).
  GET  /stats      serving metrics (latency percentiles, batch sizes)
  GET  /healthz    liveness

Usage:
  python -m hgr_tpu_torch.cli.serve --weights cls.npz [--device cuda]
      [--dtype bfloat16] [--port 8000] [--max_batch 64] [--max_wait_ms 5]

``--weights`` takes a .npz written by the JAX package (save_weights_npz,
cli/convert.py); an empty value serves a seeded random init. ``/detect``
and ``--quantize`` are not ported yet.
"""

from __future__ import annotations

import argparse
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

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
    from hgr_tpu_torch.infer.weights import (
        infer_backbone_variant,
        load_classifier_weights,
    )
    from hgr_tpu_torch.models.multitasknet import MultiTaskNet
    from hgr_tpu_torch.serve.engine import ClassifierService

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device} but torch sees no CUDA card; pass "
            "--device cpu to serve on the CPU")
    data_cfg = (load_data_config(args.data) if args.data
                else DataConfig(names=dict(DEFAULT_NAMES)))
    image_size = tuple(args.image_size)
    backbone = {"auto": "auto", "gelans": "small",
                "gelanl": "large"}[args.backbone]
    state = load_classifier_weights(args.weights, image_size,
                                    backbone=backbone)
    model = MultiTaskNet(
        num_joints=data_cfg.num_joints,
        num_classes=data_cfg.num_classes,
        image_size=image_size,
        backbone=infer_backbone_variant(state),
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
    )
    model.load_state_dict(state, strict=True)
    model = model.eval().to(device)
    service = ClassifierService(
        model, class_names=data_cfg.names, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, pipeline_depth=args.pipeline_depth)
    service.warm()
    return service


def _read_crop(body: bytes, target_hw) -> np.ndarray:
    """Parse a request body as a (H, W, 3) uint8 BGR crop of the served
    size; raise ValueError (a 400) on anything else."""
    if body[:3] == _JPEG_MAGIC:
        raise ValueError(
            "JPEG bodies are not supported by this server yet (the native "
            "decoder is not ported); send the crop as .npy bytes")
    img = np.asarray(np.load(io.BytesIO(body), allow_pickle=False))
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
    if tuple(img.shape[:2]) != tuple(target_hw):
        raise ValueError(
            f"image is {tuple(img.shape[:2])} but this server serves "
            f"{tuple(target_hw)}; send the exact geometry")
    return img.astype(np.uint8)


def make_handler(service):
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
                self._send(200, service.metrics.snapshot())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                if self.path != "/classify":
                    self._send(404, {"error": "unknown path"})
                    return
                length = int(self.headers.get("Content-Length", "0"))
                img = _read_crop(self.rfile.read(length), service.image_size)
                result = service.classify(img, timeout=30.0)
                self._send(200, {
                    "label": result["label"],
                    "label_name": result["label_name"],
                    "probs": np.asarray(result["probs"]).tolist(),
                    "landmarks": np.asarray(result["landmarks"]).tolist(),
                })
            except (ValueError, EOFError) as exc:
                # EOFError: np.load on an empty/truncated body — client
                # input errors, not server faults
                self._send(400, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001 — report, don't crash
                self._send(500, {"error": str(exc)})

    return Handler


def serve_forever(service, host: str, port: int):
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    print(f"serving on http://{host}:{httpd.server_address[1]}  "
          "(POST /classify, GET /stats)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.stop()
    return httpd


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", default="",
                    help=".npz written by the JAX package; empty = random "
                         "init from seed 0")
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
    ap.add_argument("--image_size", nargs=2, type=int, default=[192, 192])
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
    serve_forever(service, args.host, args.port)


if __name__ == "__main__":
    main()
