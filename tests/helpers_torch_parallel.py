"""Rank processes for tests/test_torch_parallel.py: torch and the port
only (a spawned child imports this module, not the test module).

``spawn_mesh(mesh_shape, inputs, variants, out_dir)`` starts one process
per rank of the mesh over gloo on the CPU; every rank runs every variant
on its rows of the global batch (a variant may name another full state
of ``inputs`` under 'state' and the model's widths under 'model_kw') and
rank 0 writes what the tests compare
(the gathered full gradients, parameters, AdamW moments and BatchNorm
statistics, and the global metrics) to ``<out_dir>/<variant>.pt``.
"""

import os

import numpy as np
import torch

IMAGE, CANVAS, B = 64, 96, 8
STEP_KW = dict(image_size=(IMAGE, IMAGE), heatmap_size=(IMAGE // 4,
                                                        IMAGE // 4))
LR = 1e-3


def staged_batch(seed=0, b=B):
    """Staged 60x60 images shifted by (2 1/3, 1 1/3) into the canvas: with
    the injected scale IMAGE/21 (crop 0.35·60 = 21 px) one output pixel
    steps one canvas pixel, so at multiples of 90° every sample lies a
    third of a pixel off the grid (tests/test_torch_train.py)."""
    rng = np.random.RandomState(seed)
    a = np.tile(np.array([[1.0, 0.0, 2.0 + 1.0 / 3.0],
                          [0.0, 1.0, 1.0 + 1.0 / 3.0]], np.float32),
                (b, 1, 1))
    valid = np.ones(b, np.float32)
    valid[-2] = 0.0  # a padded row on each rank of a {'data': 2} mesh
    valid[b // 2 - 1] = 0.0
    return {
        "canvas": rng.randint(0, 256, (b, CANVAS, CANVAS, 3)).astype(
            np.uint8),
        "orig_to_canvas": a,
        "sizes_hw": np.full((b, 2), 60.0, np.float32),
        "joints": rng.uniform(10, 50, (b, 21, 2)).astype(np.float32),
        "joints_vis": (rng.rand(b, 21) > 0.1).astype(np.float32),
        "label": rng.randint(0, 19, (b,)).astype(np.int32),
        "valid": valid,
    }


def draw_params(b=B):
    """An augment draw of the global batch, no jitter (the tight f32
    comparisons, tests/test_torch_train.py)."""
    return dict(
        scale=np.full(b, IMAGE / 21.0, np.float32),
        rot=np.tile(np.array([0.0, 90.0, 180.0, -90.0], np.float32), b // 4),
        translate=np.tile(np.array([[1.0, -2.0], [0.0, 0.0], [-1.0, 0.0],
                                    [2.0, 1.0]], np.float32), (b // 4, 1)),
        flip=np.tile(np.array([0.0, 1.0, 1.0, 0.0], np.float32), b // 4),
        jitter_gains=np.ones((b, 3), np.float32),
        do_jitter=np.zeros(b, np.float32),
    )


def inject(params):
    """Make the port's train step draw ``params`` (numpy, global batch)."""
    from hgr_tpu_torch.data.pipeline import AugmentParams
    from hgr_tpu_torch.train import steps

    def draw(generator, batch, sizes_hw, cfg):
        return AugmentParams(**{k: torch.from_numpy(v[:batch].copy())
                                for k, v in params.items()})

    steps.draw_augment_params = draw


def build_state(full_state, dtype=torch.float32, fused_attention=True,
                **model_kw):
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.train.state import create_train_state

    model = MultiTaskNet(image_size=(IMAGE, IMAGE), dtype=dtype,
                         fused_attention=fused_attention, **model_kw)
    model.load_state_dict(full_state, strict=True)
    return create_train_state(model, lr=LR, milestones_steps=(1000,),
                              device="cpu")


def moments(payload):
    """{parameter name: (exp_avg, exp_avg_sq)} of a state payload's AdamW
    state (the optimizer holds the parameters in state-dict order)."""
    names = [k for k in payload["model"] if not k.endswith((".mean", ".var"))]
    opt = payload["optimizer"]
    return {names[i]: (opt["state"][pid]["exp_avg"],
                       opt["state"][pid]["exp_avg_sq"])
            for i, pid in enumerate(opt["param_groups"][0]["params"])
            if pid in opt["state"]}


def run_variant(v, full_state, batch, mesh=None, model_kw=None):
    """One variant on this process (``mesh``: its rows, with the data
    ranks' hooks) of the model of ``model_kw`` (MultiTaskNet's widths):
    (metrics, grads, state payload), full trees; the payload holds the
    step, the model state dict, the AdamW moments and the attention route
    of the first layer. With ``v['save']`` a directory, the state after
    the step is saved there as checkpoint 'last'."""
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.models import layers
    from hgr_tpu_torch.parallel import steps as psteps
    from hgr_tpu_torch.parallel.mesh import attention_route, shard_batch
    from hgr_tpu_torch.parallel.tp import gather_state, layouts
    from hgr_tpu_torch.train import steps
    from hgr_tpu_torch.train.checkpoint import CheckpointManager, state_payload

    model_kw = model_kw or {}
    layers._FUSED_BN = bool(v.get("fused_bn"))
    try:
        fused = attention_route(mesh.shape if mesh else {},
                                model_kw.get("heads", 8))
        state = build_state(full_state, fused_attention=v.get("attn", fused),
                            **model_kw)
        kw = dict(STEP_KW)
        micro = v.get("grad_accum", 1)
        if mesh is not None:
            state = psteps.shard_state(state, mesh, mesh.tensor_parallel)
            batch = shard_batch(batch, mesh, microbatches=micro
                                if v["kind"] == "train" else 1)
        if v["kind"] == "eval":
            fn = (psteps.make_parallel_eval_step(mesh, **kw) if mesh
                  else steps.make_eval_step(**kw))
            metrics = fn(state, batch)
            grads = {}
        else:
            kw.update(grad_demix=v.get("demix", False), grad_accum=micro,
                      debug_return_grads=True)
            fn = (psteps.make_parallel_train_step(mesh, AugmentConfig(), **kw)
                  if mesh else steps.make_train_step(AugmentConfig(), **kw))
            state, metrics = fn(state, batch, torch.Generator())
            grads = metrics.pop("_grads")
        payload = state_payload(state)
        if mesh is not None:
            grads = gather_state({"step": 0, "model": grads}, mesh,
                                 state.model)["model"]
            payload = gather_state(payload, mesh, state.model)
        if v.get("save"):
            ckpt = CheckpointManager(v["save"], mesh=mesh)
            ckpt.save_last(state)
            ckpt.wait()
    finally:
        layers._FUSED_BN = None
    metrics = {k: v.detach().clone() for k, v in metrics.items()}
    attn = state.model.decoder.transformer.layers_0_attn
    return metrics, grads, {"step": payload["step"],
                            "model": dict(payload["model"]),
                            "moments": moments(payload),
                            "attention": (attn.fused, attn.heads),
                            "cuts": layouts(state.model)}


def roundtrip(full_state, mesh, model_kw=None):
    """A full state with AdamW moments (one update from seeded gradients),
    cut to this rank's share and gathered back."""
    from hgr_tpu_torch.parallel import steps as psteps
    from hgr_tpu_torch.parallel.tp import gather_state, shard_state
    from hgr_tpu_torch.train.checkpoint import state_payload

    model_kw = model_kw or {}
    state = build_state(full_state, **model_kw)
    gen = torch.Generator().manual_seed(0)
    state.apply_gradients({k: torch.randn(p.shape, generator=gen)
                           for k, p in state.model.named_parameters()})
    full = state_payload(state)
    rank = psteps.shard_state(build_state(full_state, **model_kw), mesh,
                              True).model  # the layouts of this rank's cut
    return {"full": full, "back": gather_state(shard_state(full, mesh, rank),
                                               mesh, rank)}


def _rank(rank, world, port, mesh_shape, in_path, variants, out_dir):
    from hgr_tpu_torch.parallel import distributed
    from hgr_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, "gloo")
    try:
        inputs = torch.load(in_path, weights_only=False)
        inject(inputs["params"])
        mesh = make_mesh(mesh_shape)
        for v in variants:
            full, kw = inputs[v.get("state", "state")], v.get("model_kw")
            out = (roundtrip(full, mesh, kw) if v["kind"] == "roundtrip"
                   else run_variant(v, full, inputs["batch"], mesh, kw))
            if rank == 0:
                torch.save(out, os.path.join(out_dir, v["name"] + ".pt"))
    finally:
        distributed.shutdown()


def spawn_mesh(mesh_shape, inputs, variants, out_dir):
    """Run ``variants`` on the ranks of ``mesh_shape`` (processes over
    gloo); returns {variant name: (metrics, grads, payload)}."""
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
