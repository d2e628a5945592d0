"""Dataset inspection tool (port of hgr_tpu/tools/display_data.py;
reference display_data.py:17-76).

Iterates the train split as training sees it: the loader's staged
canvases, then the train augment drawn from a seeded ``torch.Generator``
and applied on the device (``apply_augment_batch``: the fused jitter +
warp kernel on the card). Each crop is un-normalized, its skeleton drawn
and the max-over-joints target heatmap blended over it (0.8 / 0.2).
Interactive cv2 windows with ``--interactive`` ('q' quits); otherwise
one JPEG per crop, ``<out_dir>/sample_<batch>_<row>.jpg``.

    python -m hgr_tpu_torch.tools.display_data --data_config x.yaml \\
        [--out_dir display_out] [--batch_size 32] [--num_batches 1] \\
        [--interactive] [--device cuda]

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch


def contact_sheets(images: np.ndarray, joints: np.ndarray,
                   targets: np.ndarray) -> List[np.ndarray]:
    """One uint8 BGR sheet per crop of the augment's output: ``images``
    (B, H, W, 3) normalized, ``joints`` (B, J, 2) in crop pixels,
    ``targets`` (B, J, H/4, W/4), upsampled x4 to the crop (align
    corners, as the reference does, display_data.py:45-47)."""
    from hgr_tpu_torch.ops.resize import upsample_bilinear_align_corners
    from hgr_tpu_torch.utils.draw import draw_bones, draw_joints
    from hgr_tpu_torch.utils.vis import _colormap_jet, _unnormalize

    hm = upsample_bilinear_align_corners(torch.from_numpy(
        np.ascontiguousarray(targets.transpose(0, 2, 3, 1))), 4).numpy()
    imgs = _unnormalize(images)
    out = []
    for j in range(imgs.shape[0]):
        img = np.clip(imgs[j] * 255, 0, 255).astype(np.uint8).copy()
        lm = joints[j].astype(np.int32)
        img = draw_bones(img, lm)
        img = draw_joints(img, lm)
        # the max-over-joints heatmap, blended over the crop
        heat = _colormap_jet(
            np.clip(hm[j].max(axis=-1) * 255, 0, 255).astype(np.uint8))
        out.append((img * 0.8 + heat * 0.2).astype(np.uint8))
    return out


def augment_batch(batch, aug_cfg, generator: torch.Generator, image_size,
                  sigma: float):
    """A staged batch through the train augment on the generator's device:
    (images, joints, targets) as host numpy."""
    from hgr_tpu_torch.data.pipeline import (
        apply_augment_batch,
        draw_augment_params,
    )

    dev = generator.device
    t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()
         if k != "valid"}
    params = draw_augment_params(generator, t["canvas"].shape[0],
                                 t["sizes_hw"], aug_cfg)
    out = apply_augment_batch(
        t["canvas"], t["orig_to_canvas"], t["sizes_hw"], t["joints"],
        t["joints_vis"], params, image_size=image_size,
        heatmap_size=(image_size[0] // 4, image_size[1] // 4), sigma=sigma)
    return tuple(out[k].cpu().numpy() for k in ("image", "joints", "target"))


def display_data(data_config: str, out_dir: str = "",
                 image_size=(192, 192), batch_size: int = 32,
                 sigma: float = 2.0, num_batches: int = 1,
                 interactive: bool = False, device: str = "cuda") -> int:
    """Write (or show) the sheets of ``num_batches`` train batches; the
    number of sheets written. ``data_config``: a YAML path or a
    ``DataConfig``. The augment draws from a generator seeded 0, as the
    JAX tool's key is."""
    from hgr_tpu_torch.config import load_data_config
    from hgr_tpu_torch.data.dataset import read_annotations
    from hgr_tpu_torch.data.loader import BatchLoader
    from hgr_tpu_torch.train.state import resolve_device
    from hgr_tpu_torch.utils.vis import _imwrite

    dev = resolve_device(device)
    cfg = (load_data_config(data_config) if isinstance(data_config, str)
           else data_config)
    idx = read_annotations(os.path.join(cfg.path, cfg.train), cfg.names)
    loader = BatchLoader(idx, batch_size=batch_size, shuffle=True,
                         num_joints=cfg.num_joints, num_workers=4)
    generator = torch.Generator(device=dev).manual_seed(0)
    out_dir = out_dir or "display_out"
    written = 0
    for bi, batch in enumerate(loader):
        if bi >= num_batches:
            break
        sheets = contact_sheets(*augment_batch(
            batch, cfg.augments, generator, image_size, sigma))
        for j, display in enumerate(sheets):
            if interactive:
                import cv2

                cv2.imshow("img", display)
                if cv2.waitKey(0) == ord("q"):
                    return written
            else:
                os.makedirs(out_dir, exist_ok=True)
                _imwrite(os.path.join(out_dir, f"sample_{bi}_{j}.jpg"),
                         display)
                written += 1
    return written


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument('--data_config', type=str,
                        default='configs/hagrid.yaml')
    parser.add_argument('--out_dir', type=str, default='display_out')
    parser.add_argument('--batch_size', type=int, default=32)
    parser.add_argument('--num_batches', type=int, default=1)
    parser.add_argument('--interactive', action='store_true')
    parser.add_argument('--device', type=str, default='cuda',
                        help='cuda (default) or cpu')
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    n = display_data(args.data_config, args.out_dir,
                     batch_size=args.batch_size,
                     num_batches=args.num_batches,
                     interactive=args.interactive, device=args.device)
    print(f"wrote {n} inspection images to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
