"""A model axis that does not divide the ViT decoder's 8 heads
({'data': 1, 'model': 3}): the port's three gloo ranks held against the
JAX mesh step, whose attention is the GSPMD-sharded chain
(hgr_tpu/parallel/mesh.py:29-45, ``fused=False``), and against the
port's own single-process step.

Each leaf is sharded only where its dimension divides by the model axis
(JAX's ``param_shardings``). At the published widths (dim 256, 8 heads of
32, mlp 256) that is to_qkv alone, in contiguous column thirds: each rank
computes its third of qkv, the ranks gather the whole of it, and every
rank runs the packed attention on all 8 heads. A narrow decoder (4 heads
of 6, mlp 24) has inner and mlp widths that divide by 3 while its heads do
not, so to_out, fc1 and fc2 are sharded too.

Tolerances are those of tests/test_torch_parallel.py: against JAX (f32,
``Precision.HIGHEST``) the loss to rtol 2e-4, gradients 1e-4, metrics and
BatchNorm statistics 1e-5; against the port's single-process step the
loss and metrics 1e-5 and the per-tensor relative gradient error 5e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import helpers_torch_parallel as H
from hgr_tpu_torch.cli import train as cli
from hgr_tpu_torch.models import MultiTaskNet
from hgr_tpu_torch.parallel import mesh
from hgr_tpu_torch.train import steps as port_steps
from hgr_tpu_torch.train.checkpoint import CheckpointManager
from hgr_tpu_torch.train.state import create_train_state
from hgr_tpu_torch.utils.convert import from_flax
from test_torch_parallel import (  # noqa: F401 — data_cfg is a fixture
    HIGHEST,
    JaxMultiTaskNet,
    _argv,
    _assert_changes,
    _flax_leaves,
    _grad_units,
    _jax_mesh_step,
    _np,
    _rel_errors,
    data_cfg,
)
from test_torch_train import _compare_grads, _compare_metrics

torch.set_num_threads(1)

MODEL3 = {"data": 1, "model": 3}
NARROW = dict(heads=4, head_dim=6, mlp_dim=24, depth=2)
PUBLISHED = [dict(name="merged", kind="train")]
NARROWED = [dict(name="narrow_demix", kind="train", demix=True,
                 state="narrow", model_kw=NARROW),
            dict(name="narrow_batched", kind="train", demix="batched",
                 state="narrow", model_kw=NARROW),
            dict(name="narrow_roundtrip", kind="roundtrip", state="narrow",
                 model_kw=NARROW)]


@pytest.fixture(scope="module")
def variables():
    """The published widths' Flax variables (a jitted init: the eager one
    takes three times as long on the CPU)."""
    model = JaxMultiTaskNet(image_size=(H.IMAGE, H.IMAGE), precision=HIGHEST)
    return jax.jit(lambda key: model.init(
        key, jnp.zeros((1, H.IMAGE, H.IMAGE, 3)), train=False))(
            jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def inputs(variables):
    return {"state": from_flax(variables), "batch": H.staged_batch(),
            "params": H.draw_params()}


@pytest.fixture(scope="module")
def narrow_state():
    return MultiTaskNet(image_size=(H.IMAGE, H.IMAGE),
                        generator=torch.Generator().manual_seed(3),
                        **NARROW).state_dict()


@pytest.fixture(scope="module")
def ranks(inputs, narrow_state, tmp_path_factory):
    """{variant: rank 0's (metrics, grads, payload)} of one spawn of the
    three ranks; the narrow two-pullback run saves its checkpoint."""
    out = tmp_path_factory.mktemp("model3")
    variants = (PUBLISHED + [dict(NARROWED[0], save=str(out / "weight"))]
                + NARROWED[1:])
    got = H.spawn_mesh(MODEL3, dict(inputs, narrow=narrow_state), variants,
                       str(out))
    got["weight_dir"] = str(out / "weight")
    return got


@pytest.fixture(scope="module")
def single(inputs, narrow_state):
    """The port's single-process step of the narrow train variants."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_steps, "draw_augment_params",
                   port_steps.draw_augment_params)
        H.inject(inputs["params"])
        for v in NARROWED[:2]:
            out[v["name"]] = H.run_variant(v, narrow_state, inputs["batch"],
                                           model_kw=NARROW)
    return out


@pytest.fixture(scope="module")
def jax_step(variables, inputs):
    """The JAX mesh step on {'data': 1, 'model': 3}: (state, metrics,
    grads). Its train state starts from ``variables``, as the port's
    ranks do (the step's own eager init would take twice as long as the
    jitted one of the fixture)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxMultiTaskNet, "init", lambda *a, **k: variables)
        state, m = _jax_mesh_step(variables, inputs, MODEL3, False)
    m = dict(m)
    return state, m, m.pop("_grads")


def test_model3_step_matches_jax_mesh_step(ranks, jax_step):
    j_state, m_j, g_j = jax_step
    m_p, g_p, p_p = ranks["merged"]
    np.testing.assert_allclose(float(m_p["total_loss"]),
                               float(m_j["total_loss"]), rtol=2e-4)
    _compare_grads(g_p, g_j, atol=1e-4, rtol=1e-4)
    _compare_metrics(m_p, m_j, tol=1e-5)
    want = from_flax({"params": j_state.params,
                      "batch_stats": j_state.batch_stats})
    for k, w in want.items():
        stats = k.endswith((".mean", ".var"))
        np.testing.assert_allclose(
            _np(p_p["model"][k]), w.numpy(), err_msg=k,
            atol=1e-5 if stats else 2 * H.LR, rtol=1e-5 if stats else 0)
    assert p_p["step"] == int(j_state.step)


def test_model3_update_matches_jax_mesh_update(ranks, jax_step, inputs):
    """The AdamW moments and the parameter changes of every leaf, the
    sharded qkv gathered, against the JAX mesh step's."""
    j_state, _, g_j = jax_step
    _, g_p, p_p = ranks["merged"]
    adam = next(s for s in j_state.opt_state
                if isinstance(s, optax.ScaleByAdamState))
    want = _grad_units({k: (m, v) for (k, m), v in zip(
        _flax_leaves(adam.mu).items(), _flax_leaves(adam.nu).values())})
    for got, w in zip(_grad_units(p_p["moments"]), want):
        assert got.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(got[k].numpy(), w[k].numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=k)
    _assert_changes(p_p["model"], _flax_leaves(j_state.params),
                    inputs["state"], g_p, _flax_leaves(g_j))


@pytest.mark.parametrize("variant", ["narrow_demix", "narrow_batched"])
def test_model3_step_matches_single_process_step(ranks, single, variant):
    m_r, g_r, p_r = ranks[variant]
    m_s, g_s, p_s = single[variant]
    _compare_metrics(m_r, m_s, tol=1e-5)
    errs = _rel_errors(g_r, g_s)
    worst = max(errs, key=errs.get)
    assert g_r.keys() == g_s.keys() and errs[worst] <= 5e-5, (worst,
                                                              errs[worst])
    for k, w in p_s["model"].items():
        stats = k.endswith((".mean", ".var"))
        np.testing.assert_allclose(
            _np(p_r["model"][k]), _np(w), err_msg=k,
            atol=1e-5 if stats else 2 * H.LR, rtol=1e-5 if stats else 0)
    for got, want in zip(_grad_units(p_r["moments"]),
                         _grad_units(p_s["moments"])):
        errs = _rel_errors(got, want)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 5e-5, (worst, errs[worst])


@pytest.mark.parametrize("variant,want", [
    ("merged", {"to_qkv.weight": "rows"}),
    ("narrow_demix", {"to_qkv.weight": "rows", "to_out.weight": "cols",
                      "fc1.weight": "rows", "fc1.bias": "rows",
                      "fc2.weight": "cols"})])
def test_model3_ranks_shard_the_leaves_that_divide(ranks, variant, want):
    """Every rank attends over every head (the packed kernel's route) and
    holds the shards of the leaves whose dimension divides by 3."""
    _, _, payload = ranks[variant]
    heads = NARROW["heads"] if variant.startswith("narrow") else 8
    assert payload["attention"] == (True, heads)
    got = {}
    for name, kind in payload["cuts"].items():
        assert name.startswith("decoder.transformer.layers_"), name
        got.setdefault(name.split("_", 2)[-1].split(".", 1)[1], set()).add(
            kind)
    assert got == {k: {v} for k, v in want.items()}


def test_narrow_shard_then_gather_is_the_identity(ranks):
    rt = ranks["narrow_roundtrip"]
    full, back = rt["full"], rt["back"]
    assert back["model"].keys() == full["model"].keys()
    for k, v in full["model"].items():
        assert torch.equal(back["model"][k], v), k
    for pid, st in full["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(back["optimizer"]["state"][pid][k], v), (pid,
                                                                        k)


def test_narrow_checkpoint_restores_strictly_into_one_rank(ranks):
    """The three ranks' checkpoint holds the full tree: it loads strictly
    into a one-rank model and equals the gathered state, AdamW moments
    included."""
    _, _, payload = ranks["narrow_demix"]
    one = create_train_state(MultiTaskNet(image_size=(H.IMAGE, H.IMAGE),
                                          **NARROW), device="cpu")
    one = CheckpointManager(ranks["weight_dir"]).restore(one, "last")
    assert one.step == payload["step"] == 1
    for k, v in one.model.state_dict().items():
        assert torch.equal(v, payload["model"][k]), k
    assert H.moments({"model": one.model.state_dict(),
                      "optimizer": one.optimizer.state_dict()}).keys() \
        == payload["moments"].keys()
    for k, (m, v) in H.moments({"model": one.model.state_dict(),
                                "optimizer": one.optimizer.state_dict()}
                               ).items():
        assert torch.equal(m, payload["moments"][k][0]), k
        assert torch.equal(v, payload["moments"][k][1]), k


def test_cli_model3_mesh_trains_and_restores_on_one_rank(data_cfg,
                                                          tmp_path):
    state, save = cli.run(cli.parse_args(_argv(
        tmp_path, "--epochs", "1", "--mesh", "data=1,model=3",
        "--host_device_count", "3")), data_cfg)
    assert state is None
    for r in range(3):
        with open(os.path.join(save, "ranks", f"rank{r}.json")) as f:
            rec = json.load(f)
        assert rec["step"] == 2 and rec["mesh"] == {"data": 1, "model": 3}
    with open(os.path.join(str(tmp_path / "logs"), os.path.basename(save),
                           "metrics.jsonl")) as f:
        epochs = [x for x in map(json.loads, f) if "epoch" in x]
    assert len(epochs) == 1 and np.isfinite(epochs[0]["train/total_loss"])
    one = create_train_state(MultiTaskNet(image_size=(64, 64)), device="cpu")
    one = CheckpointManager(os.path.join(save, "weight")).restore(one, "best")
    assert one.step == 2


def test_layouts_follow_jax_param_shardings_at_every_model_size():
    """Sharded exactly where the dimension divides: at 16 every leaf
    (while 8 heads do not divide), at 5 none, at 3 and 6 to_qkv only."""
    full = MultiTaskNet(image_size=(H.IMAGE, H.IMAGE)).state_dict()

    def sharded(size):
        return {k.split(".")[-2] + "." + k.split(".")[-1]
                for k, v in full.items()
                if mesh.tp_layout(k, v.shape, size, 8)}
    every = {"to_qkv.weight", "to_out.weight", "fc1.weight", "fc1.bias",
             "fc2.weight"}
    assert sharded(16) == sharded(2) == every
    assert sharded(3) == sharded(6) == {"to_qkv.weight"}
    assert sharded(5) == set()
    assert mesh.tp_layout("decoder.transformer.layers_0_attn.to_qkv.weight",
                          (768, 256), 16, 8) == "rows"
    assert mesh.tp_layout("decoder.transformer.layers_0_attn.to_qkv.weight",
                          (768, 256), 2, 8) == "qkv"
