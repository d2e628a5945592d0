"""Export CLI (port of cli/export.py; flag surface of the reference's
export.py:49-57): write a deployable artifact of a classifier checkpoint,
then evaluate the test split through the artifact as it was loaded back
(macro F1 and mean latency per image).

  python -m hgr_tpu_torch.cli.export --data_config x.yaml \\
      --weight_path run/weight/best.pt [--format pt2|onnx] [--out m.pt2] \\
      [--batch 1] [--device cuda] [--skip_eval]

``--format pt2`` (the default): a ``torch.export`` program of the
2-output forward (``infer/export.py``) on the card unless ``--device
cpu``, float32 at a static batch, plus ``<out>.weights.npz`` beside it
(the format both packages load). Load it with
``hgr_tpu_torch.infer.export.load_program`` (or import
``hgr_tpu_torch.ops.attention``, then ``torch.export.load``): the graph
holds the port's attention operator. The eval runs through the loaded
program. ``--format onnx``: the reference's 2-output .onnx
(``infer/onnx_export.py``); the eval runs through the module the
exporter traced (no onnxruntime). ``--weight_path`` takes a .npz, a
reference .ckpt, a training checkpoint .pt of the port or an orbax
directory of the JAX package; ``--device
cpu`` takes the place of the JAX CLI's ``--host_device_count``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data_config", type=str, required=True)
    ap.add_argument("--image_size", nargs="+", type=int, default=None,
                    help="crop geometry; default: the checkpoint's recorded "
                         "run_meta.json, else 192 192")
    ap.add_argument("--weight_path", type=str, required=True,
                    help=".npz, reference .ckpt, the port's training "
                         "checkpoint .pt, or a JAX orbax directory")
    ap.add_argument("--out", type=str, default="",
                    help="output artifact path (default: <weight_path>.pt2 "
                         "or .onnx)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--backbone", choices=["auto", "gelans", "gelanl"],
                    default="auto",
                    help="GELAN variant of the checkpoint; auto detects it "
                         "from the weights")
    ap.add_argument("--skip_eval", action="store_true")
    ap.add_argument("--canvas_size", type=int, default=256)
    ap.add_argument("--format", choices=["pt2", "onnx"], default="pt2",
                    help="pt2: a torch.export program (eval through the "
                         "loaded program); onnx: the reference's 2-output "
                         "file (eval through the traced module)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card, cuda "
                         "raises instead of running on the CPU")
    return ap


def run(args: argparse.Namespace, data_cfg) -> Optional[dict]:
    """Export (and unless ``--skip_eval`` evaluate) with ``data_cfg``;
    returns the eval's result, or None."""
    import torch

    from hgr_tpu_torch.infer.detect import resolve_device
    from hgr_tpu_torch.infer.export import (
        eval_exported,
        export_program,
        load_program,
        split_loader,
    )
    from hgr_tpu_torch.infer.weights import (
        build_classifier,
        infer_backbone_variant,
        load_classifier_weights,
        resolve_image_size,
    )
    from hgr_tpu_torch.utils.convert import save_weights_npz, to_flax

    device = resolve_device(args.device)
    image_size = resolve_image_size(args.weight_path, args.image_size)
    backbone = {"auto": "auto", "gelans": "small",
                "gelanl": "large"}[args.backbone]
    state = load_classifier_weights(args.weight_path, image_size,
                                    backbone=backbone)
    backbone = infer_backbone_variant(state)
    res = None

    if args.format == "onnx":
        from hgr_tpu_torch.infer.onnx_export import export_onnx

        out = args.out or (args.weight_path.rstrip("/") + ".onnx")
        module = export_onnx(state, out, num_joints=data_cfg.num_joints,
                             num_classes=data_cfg.num_classes,
                             image_size=image_size, batch=args.batch,
                             backbone=backbone)
        print(f"exported ONNX artifact -> {out}")
        if not args.skip_eval:
            module = module.to(device)

            def fn(images):
                return module(images.permute(0, 3, 1, 2))

            print("Testing the traced module on the test split (the module "
                  "torch.onnx.export serialized; no onnxruntime here)...")
            res = eval_exported(fn, split_loader(data_cfg, data_cfg.test,
                                                 args.batch,
                                                 args.canvas_size),
                                data_cfg.num_classes, image_size, device)
            print("Test F1 Score: {:.4f}".format(res["test_f1"]))
        return res

    out = args.out or (args.weight_path.rstrip("/") + ".pt2")
    model = build_classifier(state, image_size, torch.float32, backbone,
                             device, num_joints=data_cfg.num_joints,
                             num_classes=data_cfg.num_classes)
    export_program(model, out, batch=args.batch)
    save_weights_npz(to_flax(state), out + ".weights.npz")
    print(f"exported torch.export program -> {out}")
    print(f"weights bundle -> {out}.weights.npz")
    if not args.skip_eval:
        fn = load_program(out)
        print("Testing the exported model on the test split...")
        res = eval_exported(fn, split_loader(data_cfg, data_cfg.test,
                                             args.batch, args.canvas_size),
                            data_cfg.num_classes, image_size, device)
        print("Test F1 Score: {:.4f}".format(res["test_f1"]))
        print("Average time taken to process one image: {:.4f} seconds"
              .format(res["mean_latency_s"]))
    return res


def main(argv: Optional[Sequence[str]] = None):
    from hgr_tpu_torch.config import load_data_config

    args = build_parser().parse_args(argv)
    return run(args, load_data_config(args.data_config))


if __name__ == "__main__":
    main()
