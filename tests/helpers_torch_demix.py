"""Rank processes for tests/test_torch_demix_batched.py: torch and the
port only (a spawned child imports this module, not the test module).

``spawn(mesh_shape, inputs, variants, out_dir)`` runs every variant on
every rank of the mesh (gloo, the CPU), as
``helpers_torch_parallel.spawn_mesh`` does, with two more kinds: a train
variant with ``spy`` records, for every call of the kernel boundaries'
CPU implementations, whether each tensor it was handed has storage
(``data_ptr()`` works); an ``attnmap`` variant returns the eval step's
attention map, gathered over the data group into the global batch's.
"""

import os

import torch

import helpers_torch_parallel as H


def install_spies(record):
    """Wrap the CPU implementations of the batched backward's kernel and
    collective boundaries: the split attention backward, the two bn
    passes and the all-reduce under ``all_sum``. Each call appends, under
    its name, whether every tensor argument's ``data_ptr()`` worked.
    Returns the function that takes the spies out again."""
    import torch.distributed as dist

    from hgr_tpu_torch.ops import attention, bn_act

    def spied(name, fn):
        def call(*args, **kwargs):
            ok = True
            for a in list(args) + list(kwargs.values()):
                if isinstance(a, torch.Tensor):
                    try:
                        a.data_ptr()
                    except RuntimeError:
                        ok = False
            record.setdefault(name, []).append(ok)
            return fn(*args, **kwargs)
        return call

    targets = [(attention, "attention_split_bwd_reference"),
               (bn_act, "bn_act_reduce_reference"),
               (bn_act, "bn_act_elem_reference"),
               (dist, "all_reduce")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in targets]
    for mod, attr, fn in saved:
        setattr(mod, attr, spied(attr, fn))

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return undo


def attention_map(full_state, batch, mesh=None):
    """The eval step's attention map of the global batch (B, heads, N, N):
    under a mesh every rank's rows, gathered over the data group."""
    from hgr_tpu_torch.parallel import steps as psteps
    from hgr_tpu_torch.parallel.collectives import gather_cat
    from hgr_tpu_torch.parallel.mesh import shard_batch
    from hgr_tpu_torch.train import steps

    fused = "split" if mesh is not None and mesh.tensor_parallel else True
    state = H.build_state(full_state, fused_attention=fused)
    kw = dict(H.STEP_KW, return_outputs=True, with_attnmap=True)
    if mesh is None:
        return steps.make_eval_step(**kw)(state, batch)[1]["attnmap"]
    state = psteps.shard_state(state, mesh, mesh.tensor_parallel)
    _, out = psteps.make_parallel_eval_step(mesh, **kw)(
        state, shard_batch(batch, mesh))
    return gather_cat(out["attnmap"], mesh.data_group, dim=0)


def _rank(rank, world, port, mesh_shape, in_path, variants, out_dir):
    from hgr_tpu_torch.parallel import distributed
    from hgr_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, "gloo")
    try:
        inputs = torch.load(in_path, weights_only=False)
        H.inject(inputs["params"])
        mesh = make_mesh(mesh_shape)
        for v in variants:
            if v["kind"] == "attnmap":
                out = attention_map(inputs["state"], inputs["batch"], mesh)
            else:
                record = {}
                undo = install_spies(record) if v.get("spy") else None
                try:
                    out = H.run_variant(v, inputs["state"], inputs["batch"],
                                        mesh)
                finally:
                    if undo is not None:
                        undo()
                out = out + (record,)
            if rank == 0:
                torch.save(out, os.path.join(out_dir, v["name"] + ".pt"))
    finally:
        distributed.shutdown()


def spawn(mesh_shape, inputs, variants, out_dir):
    """Run ``variants`` on the ranks of ``mesh_shape``; returns {variant
    name: rank 0's output}."""
    import torch.multiprocessing as mp

    from hgr_tpu_torch.parallel.distributed import free_port

    world = mesh_shape.get("data", 1) * mesh_shape.get("model", 1)
    in_path = os.path.join(out_dir, "inputs.pt")
    torch.save(inputs, in_path)
    mp.start_processes(_rank, args=(world, free_port(), mesh_shape, in_path,
                                    variants, out_dir),
                       nprocs=world, join=True, start_method="spawn")
    return {v["name"]: torch.load(os.path.join(out_dir, v["name"] + ".pt"),
                                  weights_only=False) for v in variants}
