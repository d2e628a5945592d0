"""The batched de-mixed train step of the port (``grad_demix='batched'``,
hgr_tpu_torch/train/steps.py; the JAX package's hgr_tpu/train/steps.py
:221-230) on the CPU: one ``torch.autograd.grad`` with
``is_grads_batched=True`` over the cotangent basis of (CE, joints).

Held against the port's two-pullback step on the same batch and draw
(tests/helpers_torch_parallel.py: 64 px, B = 8, the depth-4 ViT at the
published widths), against the JAX package's batched step on the same
Flax variables (tests/test_torch_train.py's 48 px step), and on a
{data: 2} and a 2x2 mesh against the single process.

Tolerances and why:
- batched vs two pullbacks: the JAX package's own (tests/
  test_grad_demix.py:125-135): each gradient's difference within 1e-5 of
  its norm in f32, 3e-2 in bf16; the loss to rtol 1e-6. Both run the
  same operators on the same rows (the legacy vmap loops over them), so
  the f32 gradients are mostly equal bit for bit;
- against JAX: tests/test_torch_train.py's for the de-mixed f32 step
  (gradients 1e-4, metrics 1e-5, BatchNorm statistics 1e-5, parameters
  2·lr);
- meshes against the single process: tests/test_torch_parallel.py's
  (per-tensor relative gradient error 5e-5, metrics 1e-5), and the
  tensor-parallel attention map within 1e-6 (f32 sums over the head
  group's own features: the same products).

The spy test is the CPU's guard for the card: a kernel launch or an
all-reduce reads memory by pointer, and a batched wrapper has none. On
the CPU plain torch ops accept the wrapper, so only a spy on the
boundaries' CPU implementations shows what a kernel would be handed.
"""

import numpy as np
import pytest
import torch

import helpers_torch_demix as HD
import helpers_torch_parallel as H
from hgr_tpu_torch.config import AugmentConfig
from hgr_tpu_torch.models import MultiTaskNet, layers
from hgr_tpu_torch.train import state as port_state
from hgr_tpu_torch.train import steps as port_steps
from hgr_tpu_torch.utils.cuda_build import require_storage
from test_torch_train import (  # noqa: F401 — the fixtures
    _compare_grads,
    _compare_metrics,
    _compare_state,
    _one_step,
    inject,
    jax_variables,
)

torch.set_num_threads(1)

DP, TP = {"data": 2}, {"data": 2, "model": 2}
DEMIX_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
VARIANTS = {"plain": {}, "grad_accum": {"grad_accum": 2},
            "remat": {"remat": True}, "fused_bn": {"fused_bn": True},
            "dense_grad": {"stride2_impl": "dense_grad"}}


def _step(dtype, demix, variant):
    """One step of a seeded 64 px model on the helpers' batch and draw:
    (metrics with '_grads', the step)."""
    kw = dict(VARIANTS[variant])
    layers._FUSED_BN = kw.pop("fused_bn", False)
    accum = kw.pop("grad_accum", 1)
    try:
        model = MultiTaskNet(image_size=(H.IMAGE, H.IMAGE),
                             dtype=getattr(torch, dtype),
                             generator=torch.Generator().manual_seed(0),
                             **kw)
        state = port_state.create_train_state(model, device="cpu")
        step = port_steps.make_train_step(
            AugmentConfig(), grad_demix=demix, grad_accum=accum,
            debug_return_grads=True, **H.STEP_KW)
        _, m = step(state, H.staged_batch(), torch.Generator())
    finally:
        layers._FUSED_BN = None
    return m, step


@pytest.fixture
def helpers_draw(monkeypatch):
    monkeypatch.setattr(port_steps, "draw_augment_params",
                        port_steps.draw_augment_params)
    H.inject(H.draw_params())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_step_matches_two_pullbacks(helpers_draw, dtype, variant):
    m0, _ = _step(dtype, True, variant)
    m1, step = _step(dtype, "batched", variant)
    # one batched backward a microbatch: it ran, not two pullbacks
    assert step.batched_backwards == VARIANTS[variant].get("grad_accum", 1)
    np.testing.assert_allclose(float(m1["total_loss"]),
                               float(m0["total_loss"]), rtol=1e-6)
    g0, g1 = m0["_grads"], m1["_grads"]
    assert g0.keys() == g1.keys()
    tol = DEMIX_TOL[dtype]
    for k, a in g0.items():
        assert torch.isfinite(g1[k]).all(), k
        na, nd = float(a.norm()), float((g1[k] - a).norm())
        assert nd <= tol * max(na, 1e-6), (k, na, nd)


def test_f32_batched_step_matches_jax_batched_step(jax_variables, inject):
    tx_state, m_j, ps, m_p = _one_step(jax_variables, "float32", "batched")
    _compare_grads(m_p.pop("_grads"), m_j.pop("_grads"), atol=1e-4,
                   rtol=1e-4)
    _compare_metrics(m_p, m_j)
    _compare_state(ps, tx_state)


# -- meshes ------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_inputs():
    model = MultiTaskNet(image_size=(H.IMAGE, H.IMAGE),
                         generator=torch.Generator().manual_seed(1))
    return {"state": model.state_dict(), "batch": H.staged_batch(),
            "params": H.draw_params()}


ARMS = [dict(name="demix", kind="train", demix=True),
        dict(name="batched", kind="train", demix="batched")]


@pytest.fixture(scope="module")
def mesh_runs(mesh_inputs, tmp_path_factory):
    """{mesh name: {variant: rank 0's output}}, one spawn per mesh; the
    2x2 mesh also runs the spied batched step with fused BN on and the
    attention map."""
    extra = {"dp": [], "tp": [
        dict(name="spied", kind="train", demix="batched", fused_bn=True,
             spy=True),
        dict(name="attnmap", kind="attnmap")]}
    return {name: HD.spawn(shape, mesh_inputs, ARMS + extra[name],
                           str(tmp_path_factory.mktemp(name)))
            for name, shape in (("dp", DP), ("tp", TP))}


@pytest.fixture(scope="module")
def single(mesh_inputs):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_steps, "draw_augment_params",
                   port_steps.draw_augment_params)
        H.inject(mesh_inputs["params"])
        for v in ARMS:
            out[v["name"]] = H.run_variant(v, mesh_inputs["state"],
                                           mesh_inputs["batch"])
        out["attnmap"] = HD.attention_map(mesh_inputs["state"],
                                          mesh_inputs["batch"])
    return out


def _rel_errors(got, want):
    return {k: float((got[k].float() - w.float()).norm()
                     / w.float().norm().clamp_min(1e-12))
            for k, w in want.items()}


@pytest.mark.parametrize("arm", ["demix", "batched"])
@pytest.mark.parametrize("mesh_name", ["dp", "tp"])
def test_mesh_batched_step_matches_single_process(mesh_runs, single,
                                                  mesh_name, arm):
    """Each arm of the mesh against the single process's batched step,
    and the mesh's two arms against each other."""
    m_r, g_r = mesh_runs[mesh_name][arm][:2]
    m_s, g_s = single["batched"][:2]
    _compare_metrics(m_r, m_s, tol=1e-5)
    assert g_r.keys() == g_s.keys()
    errs = _rel_errors(g_r, g_s)
    assert max(errs.values()) <= 5e-5, max(errs.items(), key=lambda x: x[1])
    errs = _rel_errors(mesh_runs[mesh_name]["batched"][1],
                       mesh_runs[mesh_name]["demix"][1])
    assert max(errs.values()) <= 1e-5, max(errs.items(), key=lambda x: x[1])


def test_batched_backward_hands_every_boundary_real_tensors(mesh_runs):
    """On the 2x2 mesh with fused BN on, the batched step calls the split
    attention backward, both bn passes and the all-reduce, each only with
    tensors that have storage; the attention backward runs once per
    cotangent row (4 layers x 2)."""
    _, _, payload, record = mesh_runs["tp"]["spied"]
    assert payload["attention"][0] == "split"
    for name in ("attention_split_bwd_reference", "bn_act_reduce_reference",
                 "bn_act_elem_reference", "all_reduce"):
        assert record.get(name), name
        assert all(record[name]), (name, record[name].count(False))
    assert len(record["attention_split_bwd_reference"]) == 4 * 2
    assert (len(record["bn_act_reduce_reference"])
            == len(record["bn_act_elem_reference"]))


def test_tp_attention_map_equals_the_single_process_map(mesh_runs, single):
    got, want = mesh_runs["tp"]["attnmap"], single["attnmap"]
    assert got.shape == want.shape == (H.B, 8, 17, 17)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


class _Guarded(torch.autograd.Function):
    """Doubles its input; its backward hands the cotangent to the storage
    guard that every backward kernel launch runs first."""

    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        require_storage("guarded_op", g)
        return g * 2


def test_storage_guard_raises_naming_the_op_on_a_batched_cotangent():
    """Under ``is_grads_batched`` an ``autograd.Function``'s backward gets
    the legacy vmap's batched wrapper, which has no storage: the guard
    raises naming the op, before any pointer is read. One cotangent row
    at a time passes."""
    x = torch.randn(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="guarded_op .*without storage"):
        torch.autograd.grad(_Guarded.apply(x), x, torch.eye(3),
                            is_grads_batched=True)
    (g,) = torch.autograd.grad(_Guarded.apply(x), x, torch.ones(3))
    torch.testing.assert_close(g, torch.full((3,), 2.0), rtol=0, atol=0)
