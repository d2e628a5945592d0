"""Training CLI (port of cli/train.py; flag surface of the reference
train.py:244-283 plus the JAX package's extensions and ``--device``).

    python -m hgr_tpu_torch.cli.train --data_config configs/hagrid.yaml \\
        --suffix run1 --batch_size 32 --epochs 50 --lr 1e-3 [--device cpu]

Trains on the card unless ``--device cpu``. ``HGR_TPU_FUSED_BN=on`` routes
the train-mode BatchNorm(+SiLU) layers through the fused two-pass
backward (ops/bn_act.py). Every flag of the JAX CLI is accepted and
runs: ``--grad_demix batched`` takes the two de-mixed pullbacks as one
batched backward, ``--debug_images`` writes the reference's debug images
under ``<save_dir>/<run>/debug`` (not under a mesh, as in JAX). ``main``
reads the YAML data config and calls ``run(args, data_cfg)``, which does
everything after it.

Meshes (parallel/), with the JAX CLI's meaning and refusals; every rank
is a process:

- ``--mesh data=D,model=M``: this process starts the D·M ranks of one
  host (``spawn``) and joins them; a rank that fails fails the run. Each
  CUDA rank needs a card of its own (nccl) unless
  ``--host_device_count`` says the ranks share the host's card(s).
- ``--host_device_count N``: N simulated devices on this host: the ranks
  run on the CPU under ``--device cpu`` or share the card(s) under
  ``--device cuda``, always over gloo.
- ``--distributed HOST:PORT,NPROC,PID``: this process is rank PID of
  NPROC, one per host; pure data parallelism, as in JAX.

Each rank writes its kernel launch counts to
``<save_dir>/<run>/ranks/rank<r>.json`` (a run without a mesh is rank 0),
so a parent process can read what a run launched.
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
                        help="compute dtype; 'mixed' = bf16 backbone + f32 "
                             "decoder (ModelConfig.decoder_dtype)")
    parser.add_argument('--decoder_dtype', type=str, default='',
                        choices=['', 'float32', 'bfloat16'],
                        help='explicit decoder dtype override (--dtype '
                             'mixed is the supported recipe)')
    parser.add_argument('--early_dtype', type=str, default='',
                        choices=['', 'float32', 'bfloat16'],
                        help='dtype of the first --early_units GELAN units '
                             '(ModelConfig.early_dtype)')
    parser.add_argument('--early_units', type=int, default=3)
    parser.add_argument('--grad_demix', type=str, default='auto',
                        choices=['auto', 'on', 'off', 'batched'],
                        help='de-mixed per-task gradient pullbacks (auto = '
                             "on under bf16); 'batched' takes both as one "
                             'batched backward')
    parser.add_argument('--mesh', type=str, default='',
                        help="mesh spec, e.g. 'data=8' or 'data=4,model=2'; "
                             'empty = single device')
    parser.add_argument('--canvas_size', type=int, default=256)
    parser.add_argument('--resume', action='store_true',
                        help='resume from the last checkpoint if present')
    parser.add_argument('--host_device_count', type=int, default=0,
                        help='simulate N devices on this host: the mesh '
                             'ranks run on the CPU (--device cpu) or share '
                             'the card(s), over gloo')
    parser.add_argument('--distributed', type=str, default='',
                        metavar='HOST:PORT,NPROC,PID',
                        help='multi-host data parallelism: this process is '
                             'rank PID of NPROC (one per host); --mesh '
                             'data=NPROC')
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
                        help='recompute the backbone body and the pose '
                             'head in the backward (less memory, one more '
                             'backbone forward)')
    parser.add_argument('--grad_accum', type=int, default=1,
                        help='sequential microbatches per optimizer step')
    parser.add_argument('--debug_images', action='store_true',
                        help='dump GT/pred/heatmap grids every debug_every '
                             'train batches and one val batch with the '
                             'attention overlay per epoch')
    parser.add_argument('--device', type=str, default='cuda',
                        help='cuda (default) or cpu; without a card, cuda '
                             'raises instead of running on the CPU')
    return parser


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def model_config(args: argparse.Namespace, data_cfg, fused_attention=True):
    """The ModelConfig of the flags, as the JAX CLI builds it
    (cli/train.py:179-191): ``--dtype mixed`` is a bf16 compute dtype with
    a float32 decoder unless ``--decoder_dtype`` names another."""
    from hgr_tpu_torch.config import ModelConfig

    mixed = args.dtype == "mixed"
    return ModelConfig(
        num_joints=data_cfg.num_joints, num_classes=data_cfg.num_classes,
        image_size=(args.image_size[0], args.image_size[-1]),
        backbone='large' if args.backbone == 'gelanl' else 'small',
        compute_dtype='bfloat16' if mixed else args.dtype,
        decoder_dtype=args.decoder_dtype or ('float32' if mixed else None),
        early_dtype=args.early_dtype or None,
        early_units=args.early_units, fused_attention=fused_attention,
        remat=args.remat)


def snapshot_dir(root: str, split_dir: str) -> str:
    """The snapshot directory of one split under ``root``: its basename
    and a hash of its absolute path, so splits of several datasets (all
    named 'train'/'val') do not share one (cli/train.py:270-280)."""
    abspath = os.path.abspath(os.path.normpath(split_dir))
    return os.path.join(root, os.path.basename(abspath) + "-"
                        + hashlib.sha256(abspath.encode()).hexdigest()[:8])


def _check_mesh(args: argparse.Namespace, mesh_shape, nproc: int) -> None:
    """The JAX CLI's refusals for a mesh (cli/train.py:201-253)."""
    data, tp = mesh_shape.get("data", 1), mesh_shape.get("model", 1) > 1
    if args.grad_accum > 1 and args.batch_size % (args.grad_accum * data):
        raise SystemExit(f"--batch_size {args.batch_size} must divide by "
                         f"grad_accum x data-axis ({args.grad_accum * data})")
    if args.batch_size % data:
        raise SystemExit(f"--batch_size {args.batch_size} must divide by "
                         f"the data axis {data}")
    if args.device_cache and tp:
        raise SystemExit("--device_cache supports single-device and pure-DP "
                         "meshes; tensor-parallel meshes would replicate the "
                         "cache across 'model'")
    if nproc > 1:
        if tp:
            raise SystemExit("--distributed supports pure-DP meshes "
                             "(data=N); tensor parallelism is single-host")
        if args.device_cache:
            raise SystemExit("--device_cache is single-host; use the "
                             "streaming loader under --distributed")
        if not mesh_shape:
            raise SystemExit(f"--distributed requires --mesh data=N over the "
                             f"global rank count ({nproc})")
        if data != nproc:
            raise SystemExit(f"--distributed: mesh data axis must equal the "
                             f"global rank count {nproc}, got {mesh_shape}")
        if args.batch_size % (nproc * max(1, args.grad_accum)):
            raise SystemExit(f"--batch_size {args.batch_size} must divide by "
                             f"num_processes x grad_accum "
                             f"({nproc} x {args.grad_accum})")


def run(args: argparse.Namespace, data_cfg):
    """Build the loaders, the model and its train state from ``args`` and
    ``data_cfg`` (a ``DataConfig``), resume if asked, and ``fit``. Returns
    (the final TrainState, the run's save path); when the ranks of a mesh
    ran in processes of their own, the state is None."""
    from hgr_tpu_torch.parallel import distributed
    from hgr_tpu_torch.parallel.mesh import parse_mesh
    from hgr_tpu_torch.train.state import resolve_device

    if args.image_size[0] != args.image_size[-1]:
        raise ValueError("only square images are supported")
    device = resolve_device(args.device)
    mesh_shape = parse_mesh(args.mesh)
    nproc = 1
    if args.distributed:
        addr, nproc, pid = distributed.parse_spec(args.distributed)
    _check_mesh(args, mesh_shape, nproc)
    shared = args.host_device_count > 0
    if args.distributed:
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        if device.type == "cuda" and not shared and cards < 1:
            raise RuntimeError("--distributed on CUDA needs a card per rank")
        backend = distributed.backend_for(device.type, shared)
        distributed.initialize(addr, nproc, pid, backend)
        try:
            return _train(args, data_cfg, mesh_shape, device)
        finally:
            distributed.shutdown()
    world = mesh_shape.get("data", 1) * mesh_shape.get("model", 1)
    if world == 1:
        return _train(args, data_cfg, mesh_shape, device)
    if shared and world > args.host_device_count:
        raise ValueError(f"mesh {mesh_shape} needs {world} devices, have "
                         f"{args.host_device_count}")
    if device.type == "cuda" and not shared \
            and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"mesh {mesh_shape} needs {world} cards (one per rank), this "
            f"host has {torch.cuda.device_count()}; pass --host_device_count "
            f"{world} for ranks that share them")
    backend = distributed.backend_for(device.type, shared)
    import torch.multiprocessing as mp

    port = distributed.free_port()
    mp.start_processes(_rank_main, args=(args, data_cfg, mesh_shape, world,
                                         port, backend),
                       nprocs=world, join=True, start_method="spawn")
    return None, _save_path(args)


def _rank_main(rank: int, args, data_cfg, mesh_shape, world: int, port: int,
               backend: str) -> None:
    """One local rank of a mesh: join the group, train, write the counts."""
    from hgr_tpu_torch.parallel import distributed

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, backend)
    try:
        _train(args, data_cfg, mesh_shape, device)
    finally:
        distributed.shutdown()


def _save_path(args: argparse.Namespace) -> str:
    return os.path.join(args.save_dir, "{}_{}x{}_{}".format(
        args.backbone, args.image_size[0], args.image_size[-1], args.suffix))


def _train(args: argparse.Namespace, data_cfg, mesh_shape, device):
    """The run of one rank (or of the one process without a mesh)."""
    from hgr_tpu_torch.config import ModelConfig, TrainConfig
    from hgr_tpu_torch.data.dataset import read_annotations
    from hgr_tpu_torch.data.device_cache import (
        DeviceCacheLoader,
        ShardedDeviceCacheLoader,
    )
    from hgr_tpu_torch.data.loader import BatchLoader
    from hgr_tpu_torch.data.pipeline import staging_window_fraction
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.parallel import distributed
    from hgr_tpu_torch.parallel.mesh import attention_route, make_mesh
    from hgr_tpu_torch.parallel.steps import shard_state
    from hgr_tpu_torch.train.checkpoint import CheckpointManager
    from hgr_tpu_torch.train.loop import fit
    from hgr_tpu_torch.train.state import create_train_state
    from hgr_tpu_torch.utils import launches

    main = distributed.is_coordinator()
    # the recipe's one source from here on (train_cfg, not args)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
        lr_step=tuple(args.lr_step), lr_factor=args.lr_factor,
        sigma=float(args.sigma), seed=args.seed,
        class_loss_weight=args.class_loss_weight,
        num_workers=args.num_workers, log_dir=args.log_dir,
        save_dir=args.save_dir, canvas_size=args.canvas_size,
        grad_accum=args.grad_accum, grad_demix=args.grad_demix,
        mesh_shape=mesh_shape or None)
    if train_cfg.batch_size % train_cfg.grad_accum:
        raise SystemExit(f"--batch_size {train_cfg.batch_size} must divide "
                         f"by --grad_accum {train_cfg.grad_accum}")
    save_path = _save_path(args)
    model_name = os.path.basename(save_path)
    os.makedirs(save_path, exist_ok=True)
    mesh_shape = train_cfg.mesh_shape or {}
    model_cfg = model_config(args, data_cfg, attention_route(
        mesh_shape, ModelConfig.heads))
    mesh = make_mesh(mesh_shape) if mesh_shape else None
    tensor_parallel = mesh is not None and mesh.tensor_parallel
    if mesh is not None and main:
        print(f"mesh: {mesh_shape} over {distributed.process_count()} "
              f"ranks, backend {distributed.backend() or 'none'}",
              flush=True)
    window_frac = staging_window_fraction(data_cfg.augments)
    ranks = {}
    if mesh is not None:
        ranks = dict(process_count=mesh.data_size,
                     process_index=mesh.data_index)

    def make_loader(split, shuffle, cache=False):
        split_dir = os.path.join(data_cfg.path, split)
        idx = read_annotations(split_dir, data_cfg.names)
        micro = train_cfg.grad_accum if shuffle else 1
        kw = dict(batch_size=train_cfg.batch_size,
                  canvas_size=train_cfg.canvas_size,
                  num_joints=data_cfg.num_joints, shuffle=shuffle,
                  seed=train_cfg.seed, drop_last=False,
                  num_workers=train_cfg.num_workers, window_frac=window_frac)
        if cache and args.device_cache:
            snap = (snapshot_dir(args.cache_snapshot, split_dir)
                    if args.cache_snapshot else "")
            if mesh is not None:
                return idx, ShardedDeviceCacheLoader(
                    idx, shard_index=mesh.data_index,
                    shard_count=mesh.data_size, snapshot_dir=snap,
                    device=device, group=mesh.data_group,
                    microbatches=micro, **kw)
            return idx, DeviceCacheLoader(idx, snapshot_dir=snap,
                                          device=device, **kw)
        return idx, BatchLoader(idx, microbatches=micro, **ranks, **kw)

    # No split drops its tail (the reference's loaders keep it,
    # libs/load.py:280-305): the tail batch is padded and masked. The test
    # split streams even under --device_cache: it runs once.
    train_idx, train_loader = make_loader(data_cfg.train, True, cache=True)
    _, val_loader = make_loader(data_cfg.val, False, cache=True)
    _, test_loader = make_loader(data_cfg.test, False)

    model = MultiTaskNet.from_config(
        model_cfg, generator=torch.Generator().manual_seed(train_cfg.seed))
    steps_per_epoch = len(train_loader)
    milestones = [m * steps_per_epoch for m in train_cfg.lr_step]
    state = create_train_state(model, lr=train_cfg.lr,
                               milestones_steps=milestones,
                               lr_factor=train_cfg.lr_factor, device=device)
    if mesh is not None:
        state = shard_state(state, mesh, tensor_parallel)
    if args.resume:
        ckpt = CheckpointManager(os.path.join(save_path, "weight"), mesh=mesh)
        if ckpt.has("last"):
            state = ckpt.restore(state, "last")
            if main:
                print(f"resumed from step {state.step}", flush=True)
    if main:
        print(f"{len(train_idx)} train samples, {steps_per_epoch} "
              "steps/epoch", flush=True)
    state = fit(model_cfg, train_cfg, data_cfg, state, train_loader,
                val_loader, test_loader, save_path=save_path,
                log_dir=train_cfg.log_dir, run_name=model_name,
                debug_images=args.debug_images, mesh=mesh,
                tensor_parallel=tensor_parallel, lr_fn=state.schedule,
                profile_steps=args.profile)
    launches.write(os.path.join(
        save_path, "ranks", f"rank{distributed.process_index()}.json"),
        step=state.step, mesh=mesh_shape or None,
        rank=mesh.rank if mesh is not None else None, device=str(device),
        backend=distributed.backend())
    return state, save_path


def main(argv: Optional[Sequence[str]] = None):
    from hgr_tpu_torch.config import load_data_config

    args = parse_args(argv)
    return run(args, load_data_config(args.data_config))


if __name__ == "__main__":
    main()
