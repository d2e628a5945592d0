"""Training CLI (port of cli/train.py; flag surface of the reference
train.py:244-283 plus the JAX package's extensions and ``--device``).

    python -m hgr_tpu_torch.cli.train --data_config configs/hagrid.yaml \\
        --suffix run1 --batch_size 32 --epochs 50 --lr 1e-3 [--device cpu]

Trains on the card unless ``--device cpu``. ``HGR_TPU_FUSED_BN=on`` routes
the train-mode BatchNorm(+SiLU) layers through the fused two-pass
backward (ops/bn_act.py). Every flag of the JAX CLI is accepted; the ones
whose feature is not ported yet raise ``NotImplementedError`` naming
their ROADMAP item. ``main`` reads the YAML data config and calls
``run(args, data_cfg)``, which does everything after it.
"""

from __future__ import annotations

import argparse
import hashlib
import os
from typing import Optional, Sequence

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument('--data_config', type=str, required=True,
                        help='path to the data config')
    parser.add_argument('--suffix', type=str, default='run',
                        help='suffix of the model name')
    parser.add_argument('--backbone', type=str, default='gelans',
                        choices=['gelans', 'gelanl'],
                        help='GELAN backbone variant')
    parser.add_argument('--batch_size', type=int, default=32)
    parser.add_argument('--epochs', type=int, default=50)
    parser.add_argument('--lr', type=float, default=0.001)
    parser.add_argument('--lr_step', nargs='+', type=int, default=[30, 40],
                        help='learning rate milestones (epochs)')
    parser.add_argument('--lr_factor', type=float, default=0.1)
    parser.add_argument('--image_size', nargs='+', type=int,
                        default=[192, 192],
                        help='image size (only square supported)')
    parser.add_argument('--sigma', type=int, default=2)
    parser.add_argument('--class_loss_weight', type=float, default=0.001,
                        help='classification loss weight (the reference '
                             'hard-codes 0.001, train.py:63)')
    parser.add_argument('--log_dir', type=str, default='logs')
    parser.add_argument('--save_dir', type=str, default='output')
    parser.add_argument('--num_workers', type=int, default=8)
    parser.add_argument('--seed', type=int, default=42)
    parser.add_argument('--dtype', type=str, default='bfloat16',
                        choices=['bfloat16', 'float32', 'mixed'],
                        help="compute dtype ('mixed' is not ported yet, "
                             "ROADMAP A13)")
    parser.add_argument('--decoder_dtype', type=str, default='',
                        choices=['', 'float32', 'bfloat16'],
                        help='not ported yet (ROADMAP A13)')
    parser.add_argument('--early_dtype', type=str, default='',
                        choices=['', 'float32', 'bfloat16'],
                        help='not ported yet (ROADMAP A13)')
    parser.add_argument('--early_units', type=int, default=3)
    parser.add_argument('--grad_demix', type=str, default='auto',
                        choices=['auto', 'on', 'off', 'batched'],
                        help='de-mixed per-task gradient pullbacks (auto = '
                             "on under bf16); 'batched' is not ported yet "
                             '(ROADMAP A15)')
    parser.add_argument('--mesh', type=str, default='',
                        help='not ported yet (ROADMAP A12)')
    parser.add_argument('--canvas_size', type=int, default=256)
    parser.add_argument('--resume', action='store_true',
                        help='resume from the last checkpoint if present')
    parser.add_argument('--host_device_count', type=int, default=0,
                        help='not ported yet (ROADMAP A12)')
    parser.add_argument('--distributed', type=str, default='',
                        metavar='HOST:PORT,NPROC,PID',
                        help='not ported yet (ROADMAP A12)')
    parser.add_argument('--profile', type=int, default=0, metavar='N',
                        help='trace the first N train steps with '
                             'torch.profiler into <save_dir>/<run>/profile')
    parser.add_argument('--device_cache', action='store_true',
                        help='stage the train/val splits on the device once '
                             'and serve epochs by gathering there')
    parser.add_argument('--cache_snapshot', default='', metavar='DIR',
                        help='with --device_cache: keep the staged rows in '
                             'DIR and refill the device cache from them on '
                             'later runs')
    parser.add_argument('--remat', action='store_true',
                        help='not ported yet (ROADMAP A13)')
    parser.add_argument('--grad_accum', type=int, default=1,
                        help='sequential microbatches per optimizer step')
    parser.add_argument('--debug_images', action='store_true',
                        help='not ported yet (ROADMAP A14)')
    parser.add_argument('--device', type=str, default='cuda',
                        help='cuda (default) or cpu; without a card, cuda '
                             'raises instead of running on the CPU')
    return parser


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def _refuse_unported(args: argparse.Namespace) -> None:
    unported = [
        (args.mesh, "--mesh", "A12"),
        (args.distributed, "--distributed", "A12"),
        (args.host_device_count, "--host_device_count", "A12"),
        (args.remat, "--remat", "A13"),
        (args.early_dtype, "--early_dtype", "A13"),
        (args.decoder_dtype, "--decoder_dtype", "A13"),
        (args.dtype == "mixed", "--dtype mixed", "A13"),
        (args.grad_demix == "batched", "--grad_demix batched", "A15"),
        (args.debug_images, "--debug_images", "A14"),
    ]
    for value, flag, item in unported:
        if value:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {item})")


def snapshot_dir(root: str, split_dir: str) -> str:
    """The snapshot directory of one split under ``root``: its basename
    and a hash of its absolute path, so splits of several datasets (all
    named 'train'/'val') do not share one (cli/train.py:270-280)."""
    abspath = os.path.abspath(os.path.normpath(split_dir))
    return os.path.join(root, os.path.basename(abspath) + "-"
                        + hashlib.sha256(abspath.encode()).hexdigest()[:8])


def run(args: argparse.Namespace, data_cfg):
    """Build the loaders, the model and its train state from ``args`` and
    ``data_cfg`` (a ``DataConfig``), resume if asked, and ``fit``. Returns
    (the final TrainState, the run's save path)."""
    from hgr_tpu_torch.config import ModelConfig, TrainConfig
    from hgr_tpu_torch.data.dataset import read_annotations
    from hgr_tpu_torch.data.device_cache import DeviceCacheLoader
    from hgr_tpu_torch.data.loader import BatchLoader
    from hgr_tpu_torch.data.pipeline import staging_window_fraction
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.train.checkpoint import CheckpointManager
    from hgr_tpu_torch.train.loop import fit
    from hgr_tpu_torch.train.state import create_train_state, resolve_device

    _refuse_unported(args)
    if args.image_size[0] != args.image_size[-1]:
        raise ValueError("only square images are supported")
    device = resolve_device(args.device)
    # the recipe's one source from here on (train_cfg, not args)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
        lr_step=tuple(args.lr_step), lr_factor=args.lr_factor,
        sigma=float(args.sigma), seed=args.seed,
        class_loss_weight=args.class_loss_weight,
        num_workers=args.num_workers, log_dir=args.log_dir,
        save_dir=args.save_dir, canvas_size=args.canvas_size,
        grad_accum=args.grad_accum, grad_demix=args.grad_demix)
    if train_cfg.batch_size % train_cfg.grad_accum:
        raise SystemExit(f"--batch_size {train_cfg.batch_size} must divide "
                         f"by --grad_accum {train_cfg.grad_accum}")
    model_name = "{}_{}x{}_{}".format(
        args.backbone, args.image_size[0], args.image_size[-1], args.suffix)
    save_path = os.path.join(train_cfg.save_dir, model_name)
    os.makedirs(save_path, exist_ok=True)
    image_size = (args.image_size[0], args.image_size[-1])
    model_cfg = ModelConfig(
        num_joints=data_cfg.num_joints, num_classes=data_cfg.num_classes,
        image_size=image_size,
        backbone='large' if args.backbone == 'gelanl' else 'small',
        compute_dtype=args.dtype, early_units=args.early_units)
    window_frac = staging_window_fraction(data_cfg.augments)

    def make_loader(split, shuffle, cache=False):
        split_dir = os.path.join(data_cfg.path, split)
        idx = read_annotations(split_dir, data_cfg.names)
        kw = dict(batch_size=train_cfg.batch_size,
                  canvas_size=train_cfg.canvas_size,
                  num_joints=data_cfg.num_joints, shuffle=shuffle,
                  seed=train_cfg.seed, drop_last=False,
                  num_workers=train_cfg.num_workers, window_frac=window_frac)
        if cache and args.device_cache:
            snap = (snapshot_dir(args.cache_snapshot, split_dir)
                    if args.cache_snapshot else "")
            return idx, DeviceCacheLoader(idx, snapshot_dir=snap,
                                          device=device, **kw)
        return idx, BatchLoader(idx, **kw)

    # No split drops its tail (the reference's loaders keep it,
    # libs/load.py:280-305): the tail batch is padded and masked. The test
    # split streams even under --device_cache: it runs once.
    train_idx, train_loader = make_loader(data_cfg.train, True, cache=True)
    _, val_loader = make_loader(data_cfg.val, False, cache=True)
    _, test_loader = make_loader(data_cfg.test, False)

    model = MultiTaskNet(
        num_joints=model_cfg.num_joints, num_classes=model_cfg.num_classes,
        image_size=image_size, backbone=model_cfg.backbone,
        dtype=getattr(torch, model_cfg.compute_dtype),
        generator=torch.Generator().manual_seed(train_cfg.seed))
    steps_per_epoch = len(train_loader)
    milestones = [m * steps_per_epoch for m in train_cfg.lr_step]
    state = create_train_state(model, lr=train_cfg.lr,
                               milestones_steps=milestones,
                               lr_factor=train_cfg.lr_factor, device=device)
    if args.resume:
        ckpt = CheckpointManager(os.path.join(save_path, "weight"))
        if ckpt.has("last"):
            state = ckpt.restore(state, "last")
            print(f"resumed from step {state.step}", flush=True)
    print(f"{len(train_idx)} train samples, {steps_per_epoch} steps/epoch",
          flush=True)
    state = fit(model_cfg, train_cfg, data_cfg, state, train_loader,
                val_loader, test_loader, save_path=save_path,
                log_dir=train_cfg.log_dir, run_name=model_name,
                lr_fn=state.schedule, profile_steps=args.profile)
    return state, save_path


def main(argv: Optional[Sequence[str]] = None):
    from hgr_tpu_torch.config import load_data_config

    args = parse_args(argv)
    return run(args, load_data_config(args.data_config))


if __name__ == "__main__":
    main()
