"""Rank processes for tests/test_torch_cache_accum.py: torch and the port
only (a spawned child imports this module, not the test module).

``spawn(ann_dir, cases, out_dir)`` starts the two ranks of a {'data': 2}
mesh over gloo on the CPU. For every case each rank builds its
``ShardedDeviceCacheLoader`` of the split with the case's loader keywords
and ``microbatches``, and writes the batches of two epochs (numpy) to
``<out_dir>/<case>_rank<r>.pt``.
"""

import os

import numpy as np
import torch


def _rank(rank, world, port, ann_dir, cases, out_dir):
    from hgr_tpu_torch.config import DEFAULT_NAMES
    from hgr_tpu_torch.data.dataset import read_annotations
    from hgr_tpu_torch.data.device_cache import ShardedDeviceCacheLoader
    from hgr_tpu_torch.parallel import distributed
    from hgr_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, "gloo")
    try:
        mesh = make_mesh({"data": world})
        index = read_annotations(ann_dir, DEFAULT_NAMES)
        for case in cases:
            loader = ShardedDeviceCacheLoader(
                index, shard_index=mesh.data_index,
                shard_count=mesh.data_size, group=mesh.data_group,
                microbatches=case["microbatches"], device="cpu",
                **case["kw"])
            batches = [{k: (v.numpy() if isinstance(v, torch.Tensor)
                            else np.asarray(v)) for k, v in b.items()}
                       for _ in range(2) for b in loader]
            torch.save(batches, os.path.join(
                out_dir, f"{case['name']}_rank{rank}.pt"))
    finally:
        distributed.shutdown()


def spawn(ann_dir, cases, out_dir, world=2):
    """{case name: [rank 0's batches, rank 1's batches]}."""
    import torch.multiprocessing as mp

    from hgr_tpu_torch.parallel.distributed import free_port

    mp.start_processes(_rank, args=(world, free_port(), ann_dir, cases,
                                    out_dir),
                       nprocs=world, join=True, start_method="spawn")
    return {c["name"]: [torch.load(os.path.join(
        out_dir, f"{c['name']}_rank{r}.pt"), weights_only=False)
        for r in range(world)] for c in cases}
