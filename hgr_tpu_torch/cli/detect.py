"""Video / image-directory inference (port of cli/detect.py; reference
detect.py:210-249): detect -> crop -> classify on every frame, annotated
into an mp4v video.

    python -m hgr_tpu_torch.cli.detect --data_config configs/hagrid.yaml \
        --cls_weight cls.npz --det_weight detector.npz \
        --data_path data/test.mov --save_path result.mp4 [--device cuda]

The JAX CLI's flags, with ``--device`` (the card unless ``cpu``) in place
of ``--host_device_count``. Needs cv2 for the video writer.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_config", type=str, required=True)
    parser.add_argument("--cls_weight", type=str, default="",
                        help="classifier weights: .npz, reference .ckpt, "
                             "the port's .pt or a JAX orbax directory "
                             "(empty: a seeded random init)")
    parser.add_argument("--det_weight", type=str, default="",
                        help="detector weights: .npz (Flax paths) or .onnx "
                             "(empty: a seeded random init)")
    parser.add_argument("--data_path", type=str, default="data/test.mov")
    parser.add_argument("--save_path", type=str, default="result.mp4")
    parser.add_argument("--det_img_size", type=int, default=416)
    parser.add_argument("--cls_img_size", nargs="+", type=int, default=None,
                        help="classifier crop geometry; default: the "
                             "checkpoint's recorded run_meta.json, else "
                             "192 192")
    parser.add_argument("--score_thresh", type=float, default=0.2)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--batch_frames", type=int, default=1,
                        help="batch N frames per device call (offline "
                             "throughput mode)")
    parser.add_argument("--pipeline_depth", type=int, default=3,
                        help="frame batches kept in flight on the device "
                             "while host decode/annotate/encode runs")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; without a card, cuda "
                             "raises instead of running on the CPU")
    parser.add_argument("--show", action="store_true",
                        help="interactive preview window ('q' quits)")
    return parser


def build_pipeline(args):
    """The ``HandGesturePipeline`` that ``args`` describe."""
    import torch

    from hgr_tpu_torch.config import load_data_config
    from hgr_tpu_torch.infer.detect import HandGesturePipeline
    from hgr_tpu_torch.infer.weights import (
        load_classifier_weights,
        load_detector_weights,
        resolve_image_size,
    )

    data_cfg = load_data_config(args.data_config)
    cls_img_size = resolve_image_size(args.cls_weight, args.cls_img_size)
    return HandGesturePipeline(
        load_classifier_weights(args.cls_weight, image_size=cls_img_size),
        load_detector_weights(args.det_weight), data_cfg.names,
        det_img_size=args.det_img_size, cls_img_size=cls_img_size,
        score_thresh=args.score_thresh,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        device=args.device)


def run(args, pipeline=None) -> int:
    """Write the video of ``args.data_path`` through ``pipeline`` (built
    from ``args`` when not given); returns the frames processed."""
    from hgr_tpu_torch.infer.detect import detect_to_video

    if pipeline is None:
        pipeline = build_pipeline(args)
    return detect_to_video(pipeline, args.data_path, args.save_path,
                           batch_frames=args.batch_frames, show=args.show,
                           pipeline_depth=args.pipeline_depth)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    n = run(args)
    print(f"processed {n} frames -> {args.save_path}")


if __name__ == "__main__":
    main()
