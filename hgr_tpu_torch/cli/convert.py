"""Weight conversion (port of cli/convert.py): a reference Lightning
``.ckpt`` classifier or a YOLOv7-tiny ``.onnx`` detector into the
``collection/path/leaf`` .npz that both packages load.

    python -m hgr_tpu_torch.cli.convert --classifier best.ckpt --out w.npz
    python -m hgr_tpu_torch.cli.convert --detector yolov7-tiny.onnx \
        --out det.npz

``--verify`` reloads the written file and runs one forward of the ported
classifier and of the reloaded one on the CPU, printing the largest
logit difference (the JAX CLI compares with the reference's own torch
model, which the repository does not hold).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--classifier", type=str, default="",
                        help="reference Lightning .ckpt to convert")
    parser.add_argument("--detector", type=str, default="",
                        help="YOLOv7-tiny .onnx to convert (read by the "
                             "port's own ONNX reader)")
    parser.add_argument("--out", type=str, required=True,
                        help="output .npz path")
    parser.add_argument("--verify", action="store_true",
                        help="reload the output and check a forward "
                             "(classifier only)")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    from hgr_tpu_torch.utils.convert import save_weights_npz, to_flax

    if args.classifier:
        from hgr_tpu_torch.utils.torch_port import load_reference_checkpoint

        state = load_reference_checkpoint(args.classifier)
        save_weights_npz(to_flax(state), args.out)
        print(f"ported classifier -> {args.out}")
        if args.verify:
            print(f"forward parity max |d logits| = "
                  f"{_verify(state, args.out):.2e}")
    elif args.detector:
        from hgr_tpu_torch.utils.onnx_port import port_yolov7_tiny_onnx

        save_weights_npz(port_yolov7_tiny_onnx(args.detector), args.out)
        print(f"ported detector -> {args.out}")
    else:
        parser.error("provide --classifier or --detector")


def _verify(state, path: str) -> float:
    """Largest |logit| difference between the ported state and the .npz
    at ``path`` reloaded, one seeded 192 px input, f32 on the CPU."""
    import numpy as np
    import torch

    from hgr_tpu_torch.infer.weights import load_classifier_weights
    from hgr_tpu_torch.models.multitasknet import MultiTaskNet

    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 192, 192, 3).astype(np.float32))
    logits = []
    for sd in (state, load_classifier_weights(path)):
        model = MultiTaskNet()
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            logits.append(model.eval()(x, need_attnmap=False)[0])
    return float((logits[0] - logits[1]).abs().max())


if __name__ == "__main__":
    main()
