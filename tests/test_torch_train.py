"""The port's training path (hgr_tpu_torch/models in train mode,
ops/losses.py, ops/metrics.py, train/state.py, train/steps.py) held
against the JAX package's.

Both sides start from the same Flax variables (converted with
``from_flax``) and take the same staged numpy batch; torch cannot replay
``jax.random``, so the augment draw is injected on both sides by
monkeypatching each package's ``train.steps.draw_augment_params`` with
the same numpy-made ``AugmentParams``. JAX runs with
``precision=HIGHEST`` (its default f32 matmul precision is reduced even
on the CPU).

Tolerances and why:
- f32 pre-update gradients (``debug_return_grads``) 1e-4, the JAX
  package's own gradient tolerance (tests/test_attention_pallas.py);
  losses and metrics ~1e-5; BatchNorm running statistics 1e-5.
- Updated parameters: atol 2·lr. Adam's first update is lr·g/(|g|+eps),
  which flips sign wherever a gradient sits at rounding level, so the
  parameters can differ by up to 2·lr even where the gradients agree.
- bf16 is held loosely (relative gradient norms): off the TPU the JAX
  model's fused attention takes ``_xla_attention_core``, which rounds the
  scores to bf16, while the port follows the Pallas kernel (f32 scores);
  and XLA keeps fused elementwise chains in f32 where torch rounds each
  op's output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hgr_tpu.config import AugmentConfig as JaxAugmentConfig
from hgr_tpu.data.pipeline import AugmentParams as JaxAugmentParams
from hgr_tpu.models import MultiTaskNet as JaxMultiTaskNet
from hgr_tpu.models.layers import ConvBnAct as JaxConvBnAct
from hgr_tpu.ops import losses as jax_losses
from hgr_tpu.ops import metrics as jax_metrics
from hgr_tpu.train import state as jax_state
from hgr_tpu.train import steps as jax_steps
from hgr_tpu_torch.config import AugmentConfig, ModelConfig, TrainConfig
from hgr_tpu_torch.data.pipeline import AugmentParams
from hgr_tpu_torch.models import MultiTaskNet
from hgr_tpu_torch.models.layers import ConvBnAct
from hgr_tpu_torch.ops import losses, metrics
from hgr_tpu_torch.train import state as port_state
from hgr_tpu_torch.train import steps as port_steps
from hgr_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)

HIGHEST = jax.lax.Precision.HIGHEST
IMAGE, CANVAS, HEATMAP, B = 48, 64, 12, 4
LR = 1e-3
MILESTONES = (2,)
STEP_KW = dict(image_size=(IMAGE, IMAGE), heatmap_size=(HEATMAP, HEATMAP))


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _staged_batch(seed=0):
    """Staged 60x60 images, shifted by (2 1/3, 1 1/3) into the canvas.

    With the crop size 0.35·60 = 21 and the injected scale 48/21, one
    output pixel steps one canvas pixel, so at multiples of 90° every
    sample lands a third of a pixel off the grid on both axes: each
    output is (4a + 2b + 2c + d) / 9 of four pixels, at least 0.05 of a
    level from a rounding tie, and both sides round it alike. (On the
    grid, the jitted JAX warp can floor a position and take its fraction
    from two differently contracted copies and misread a whole pixel,
    hgr_tpu/ops/warp_pallas.py:100-111; off it, a one-ulp difference can
    move a rounding by a level.) The augment itself is held at general
    geometry in tests/test_torch_augment.py."""
    rng = np.random.RandomState(seed)
    a = np.tile(np.array([[1.0, 0.0, 2.0 + 1.0 / 3.0],
                          [0.0, 1.0, 1.0 + 1.0 / 3.0]], np.float32),
                (B, 1, 1))
    return {
        "canvas": rng.randint(0, 256, (B, CANVAS, CANVAS, 3)).astype(
            np.uint8),
        "orig_to_canvas": a,
        "sizes_hw": np.full((B, 2), 60.0, np.float32),
        "joints": rng.uniform(10, 50, (B, 21, 2)).astype(np.float32),
        "joints_vis": (rng.rand(B, 21) > 0.1).astype(np.float32),
        "label": rng.randint(0, 19, (B,)).astype(np.int32),
        "valid": np.array([1, 1, 1, 0], np.float32),
    }


# The tight f32 comparisons draw no jitter: inside the jitted JAX step
# the HSV LUT's floor lands a level apart from the eager arithmetic at a
# few pixels (the port agrees with the eager one, and the jitter is held
# in tests/test_torch_augment.py). The loose bf16 step and the trajectory
# draw it (``JITTER``).
PARAMS = dict(
    scale=np.full(B, 48.0 / 21.0, np.float32),
    rot=np.array([0.0, 90.0, 180.0, -90.0], np.float32),
    translate=np.array([[1.0, -2.0], [0.0, 0.0], [-1.0, 0.0], [2.0, 1.0]],
                       np.float32),
    flip=np.array([0.0, 1.0, 1.0, 0.0], np.float32),
    jitter_gains=np.ones((B, 3), np.float32),
    do_jitter=np.zeros(B, np.float32),
)
JITTER = dict(
    PARAMS,
    jitter_gains=np.array([[1.01, 1.3, 0.8], [1.0, 1.0, 1.0],
                           [0.99, 0.7, 1.2], [1.0, 0.8, 1.1]], np.float32),
    do_jitter=np.array([1.0, 0.0, 1.0, 1.0], np.float32),
)


def _inject(monkeypatch, params):
    """The same numpy augment draw on both sides (first ``batch`` rows)."""
    def jax_draw(key, batch, sizes_hw, cfg):
        return JaxAugmentParams(**{k: jnp.asarray(v[:batch])
                                   for k, v in params.items()})

    def port_draw(generator, batch, sizes_hw, cfg):
        return AugmentParams(**{k: torch.from_numpy(v[:batch].copy())
                                for k, v in params.items()})

    monkeypatch.setattr(jax_steps, "draw_augment_params", jax_draw)
    monkeypatch.setattr(port_steps, "draw_augment_params", port_draw)


@pytest.fixture
def inject(monkeypatch):
    _inject(monkeypatch, PARAMS)


@pytest.fixture
def inject_jitter(monkeypatch):
    _inject(monkeypatch, JITTER)


@pytest.fixture(scope="module")
def jax_variables():
    """jax_variables(dtype) -> (Flax module, its variables), built once;
    the variables do not depend on the dtype."""
    built = {}

    def get(dtype):
        if dtype not in built:
            model = JaxMultiTaskNet(image_size=(IMAGE, IMAGE),
                                    dtype=getattr(jnp, dtype),
                                    precision=HIGHEST)
            variables = model.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, IMAGE, IMAGE, 3)),
                                   train=False)
            built[dtype] = (model, variables)
        return built[dtype]

    return get


def _states(jax_variables, dtype):
    model, variables = jax_variables(dtype)
    tx_state, _ = jax_state.create_train_state(
        model, jax.random.PRNGKey(0), (1, IMAGE, IMAGE, 3), lr=LR,
        milestones_steps=MILESTONES)
    pm = MultiTaskNet(image_size=(IMAGE, IMAGE), dtype=getattr(torch, dtype))
    pm.load_state_dict(from_flax(variables), strict=True)
    ps = port_state.create_train_state(pm, lr=LR, milestones_steps=MILESTONES,
                                       device="cpu")
    return tx_state, ps


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _compare_grads(g_port, g_jax, **tol):
    want = from_flax({"params": jax.tree_util.tree_map(np.asarray, g_jax)})
    assert g_port.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(_np(g_port[k]), want[k].numpy(),
                                   err_msg=k, **tol)


def _compare_state(ps, tx_state, stats_tol=1e-5, param_atol=2 * LR):
    want = from_flax({"params": tx_state.params,
                      "batch_stats": tx_state.batch_stats})
    got = ps.model.state_dict()
    for k, w in want.items():
        tol = stats_tol if k.endswith((".mean", ".var")) else param_atol
        np.testing.assert_allclose(_np(got[k]), w.numpy(), atol=tol,
                                   rtol=1e-5 if tol == stats_tol else 0,
                                   err_msg=k)
    assert ps.step == int(tx_state.step)


def _compare_metrics(m_port, m_jax, tol=1e-5):
    for k in ("total_loss", "class_loss", "joints_loss", "cls_f1score",
              "pose_acc", "pose_cnt", "valid_cnt"):
        np.testing.assert_allclose(_np(m_port[k]), _np(m_jax[k]), atol=tol,
                                   rtol=tol, err_msg=k)
    np.testing.assert_array_equal(_np(m_port["conf_update"]),
                                  _np(m_jax["conf_update"]))


# -- layers and model in train mode ------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_bn_act_train_mode_matches_flax(dtype):
    jm = JaxConvBnAct(16, 3, 2, dtype=getattr(jnp, dtype), precision=HIGHEST)
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 12, 12, 3) * 2 + 0.5).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(1), x)
    want, mutated = jm.apply(variables, x, train=True,
                             mutable=["batch_stats"])
    tm = ConvBnAct(3, 16, 3, 2, dtype=getattr(torch, dtype))
    tm.load_state_dict(from_flax(variables), strict=True)
    got = tm.train()(torch.from_numpy(x))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    stats = from_flax({"params": {}, **mutated})
    for k in ("bn.mean", "bn.var"):
        np.testing.assert_allclose(_np(tm.state_dict()[k]), stats[k].numpy(),
                                   atol=1e-5, rtol=1e-5)
    # eval mode reads the updated statistics, as flax does
    want_e = jm.apply({**variables, **mutated}, x, train=False)
    np.testing.assert_allclose(_np(tm.eval()(torch.from_numpy(x))),
                               _np(want_e), atol=tol, rtol=tol)


def test_batchnorm_fast_variance_and_one_update_per_forward():
    from hgr_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(4).train()
    x = torch.from_numpy(np.random.RandomState(2).randn(5, 3, 3, 4)
                         .astype(np.float32) * 3 + 1)
    bn(x)
    mean = x.mean((0, 1, 2))
    var = (x * x).mean((0, 1, 2)) - mean * mean  # biased, fast variance
    torch.testing.assert_close(bn.mean, 0.1 * mean, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * var, atol=1e-5,
                               rtol=1e-5)
    # a constant channel: mean(x²) - mean² rounds below 0 -> clipped
    const = torch.full((2, 2, 2, 4), 3.3)
    y = BatchNorm(4).train()(const)
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multitasknet_train_forward_matches_flax(jax_variables, dtype):
    model, variables = jax_variables(dtype)
    x = np.random.RandomState(3).randn(2, IMAGE, IMAGE, 3).astype(np.float32)
    (jl, jh, _), mutated = model.apply(variables, x, train=True,
                                       need_attnmap=False,
                                       mutable=["batch_stats"])
    tm = MultiTaskNet(image_size=(IMAGE, IMAGE), dtype=getattr(torch, dtype))
    tm.load_state_dict(from_flax(variables), strict=True)
    tl, th, ta = tm.train()(torch.from_numpy(x), need_attnmap=False)
    assert ta is None
    tol = ({"atol": 1e-4, "rtol": 1e-4} if dtype == "float32"
           else {"atol": 1e-1})
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    np.testing.assert_allclose(_np(th), _np(jh), **tol)
    want = from_flax({"params": {}, **mutated})
    got = tm.state_dict()
    stats_tol = 1e-5 if dtype == "float32" else 2e-2
    for k in want:
        np.testing.assert_allclose(_np(got[k]), want[k].numpy(),
                                   atol=stats_tol, rtol=stats_tol,
                                   err_msg=k)


# -- losses, metrics, schedule, optimizer ------------------------------------


def test_losses_match_with_and_without_mask():
    rng = np.random.RandomState(4)
    logits = rng.randn(5, 19).astype(np.float32) * 3
    labels = rng.randint(0, 19, 5).astype(np.int32)
    hm = rng.rand(5, 21, 12, 12).astype(np.float32)
    tgt = rng.rand(5, 21, 12, 12).astype(np.float32)
    w = (rng.rand(5, 21) > 0.3).astype(np.float32)
    t = torch.from_numpy
    for mask in (None, np.array([1, 0, 1, 1, 0], np.float32)):
        tm = None if mask is None else t(mask)
        total, parts = losses.multitask_loss(t(logits), t(hm), t(labels),
                                             t(tgt), t(w), sample_mask=tm)
        jt, jparts = jax_losses.multitask_loss(logits, hm, labels, tgt, w,
                                               sample_mask=mask)
        for k in jparts:
            np.testing.assert_allclose(_np(parts[k]), _np(jparts[k]),
                                       rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        _np(losses.joints_mse_loss(t(hm), t(tgt))),
        _np(jax_losses.joints_mse_loss(hm, tgt)), rtol=1e-6)


def test_metrics_match():
    rng = np.random.RandomState(5)
    out = rng.randn(4, 21, 12, 12).astype(np.float32)
    tgt = rng.randn(4, 21, 12, 12).astype(np.float32)
    tgt[0, :3] = -1.0  # no peak > 0: decoded at (0, 0), not a valid joint
    mask = np.array([1, 1, 0, 1], np.float32)
    t = torch.from_numpy
    for m in (None, mask):
        got = metrics.pck_accuracy(t(out), t(tgt), sample_mask=None
                                   if m is None else t(m))
        want = jax_metrics.pck_accuracy(out, tgt, sample_mask=m)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-6)
    labels = rng.randint(0, 6, 9).astype(np.int32)
    preds = rng.randint(0, 6, 9).astype(np.int32)
    m9 = (rng.rand(9) > 0.3).astype(np.float32)
    conf = metrics.confusion_update(torch.zeros(6, 6), t(labels), t(preds),
                                    t(m9))
    want_conf = jax_metrics.confusion_update(jnp.zeros((6, 6)), labels,
                                             preds, m9)
    np.testing.assert_array_equal(_np(conf), _np(want_conf))
    np.testing.assert_allclose(_np(metrics.macro_f1_from_confusion(conf)),
                               _np(jax_metrics.macro_f1_from_confusion(
                                   want_conf)), rtol=1e-6)
    np.testing.assert_allclose(
        _np(metrics.batch_macro_f1(t(labels), t(preds), 6)),
        _np(jax_metrics.batch_macro_f1(labels, preds, 6)), rtol=1e-6)


def test_multistep_lr_boundary_matches_optax():
    """optax scales once count >= milestone, count = updates before this
    one: update 0 takes the base lr, update m is the first scaled one."""
    want = jax_state.multistep_lr(1e-3, (3, 5), 0.1)
    got = port_state.multistep_lr(1e-3, (3, 5), 0.1)
    for count in range(8):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6)
    assert got(2) == 1e-3 and got(3) != 1e-3


def test_one_adamw_update_matches_optax():
    rng = np.random.RandomState(6)
    p0 = rng.randn(7, 5).astype(np.float32)
    grads = [rng.randn(7, 5).astype(np.float32) for _ in range(3)]
    grads[0][0, :2] = [1e-9, -1e-9]  # rounding-level: Adam's sign flip zone
    tx = optax.adamw(jax_state.multistep_lr(1e-2, (2,), 0.1), b1=0.9,
                     b2=0.999, eps=1e-8, weight_decay=0.01)
    p_j, opt = jnp.asarray(p0), None
    opt = tx.init(p_j)
    model = torch.nn.Linear(5, 7, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(p0))
    st = port_state.create_train_state(model, lr=1e-2, milestones_steps=(2,),
                                       device="cpu")
    for g in grads:  # across the milestone at update 2
        upd, opt = tx.update(jnp.asarray(g), opt, p_j)
        p_j = optax.apply_updates(p_j, upd)
        st.apply_gradients({"weight": torch.from_numpy(g)})
        np.testing.assert_allclose(_np(model.weight), np.asarray(p_j),
                                   atol=1e-6, rtol=1e-6)
    assert st.step == 3


def test_training_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_state.create_train_state(torch.nn.Linear(2, 2))


@pytest.mark.parametrize("field", [
    "batch_size", "epochs", "lr", "lr_step", "lr_factor", "sigma", "seed",
    "class_loss_weight", "num_workers", "log_dir", "save_dir",
    "canvas_size", "grad_accum", "grad_demix"])
def test_train_config_field_matches_jax(field):
    from hgr_tpu import config as jax_config

    assert (getattr(TrainConfig(), field)
            == getattr(jax_config.TrainConfig(), field))


def test_train_config_has_every_jax_field_but_the_mesh():
    """Every JAX field that something in the port reads: ``mesh_shape``
    waits for multi-GPU training (ROADMAP A12), ``debug_every`` for the
    debug images (A14), and the JAX package reads no ``steps_per_epoch``
    either."""
    import dataclasses

    from hgr_tpu import config as jax_config

    want = {f.name for f in dataclasses.fields(jax_config.TrainConfig)}
    got = {f.name for f in dataclasses.fields(TrainConfig)}
    assert got == want - {"mesh_shape", "debug_every", "steps_per_epoch"}


def test_train_config_and_grad_demix_resolution_match_jax():
    from hgr_tpu import config as jax_config

    for mode in ("auto", "on", "off", "batched"):
        for dt in ("float32", "bfloat16"):
            want = jax_steps.resolve_grad_demix(
                jax_config.TrainConfig(grad_demix=mode),
                jax_config.ModelConfig(compute_dtype=dt))
            got = port_steps.resolve_grad_demix(
                TrainConfig(grad_demix=mode), ModelConfig(compute_dtype=dt))
            assert got == want, (mode, dt)


def test_batched_demix_raises_naming_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="A15"):
        port_steps.make_train_step(AugmentConfig(), grad_demix="batched")


# -- the train step ----------------------------------------------------------


def _one_step(jax_variables, dtype, demix, grad_accum=1):
    tx_state, ps = _states(jax_variables, dtype)
    batch = _staged_batch()
    kw = dict(grad_demix=demix, grad_accum=grad_accum,
              debug_return_grads=True, **STEP_KW)
    j_step = jax_steps.make_train_step(JaxAugmentConfig(), donate=False,
                                       **kw)
    tx_state, m_j = j_step(tx_state, _jax_batch(batch),
                           jax.random.PRNGKey(7))
    p_step = port_steps.make_train_step(AugmentConfig(), **kw)
    ps, m_p = p_step(ps, batch, torch.Generator().manual_seed(7))
    return tx_state, m_j, ps, m_p


@pytest.mark.parametrize("demix", [False, True])
def test_f32_train_step_matches_jax(jax_variables, inject, demix):
    tx_state, m_j, ps, m_p = _one_step(jax_variables, "float32", demix)
    _compare_grads(m_p.pop("_grads"), m_j.pop("_grads"), atol=1e-4,
                   rtol=1e-4)
    _compare_metrics(m_p, m_j)
    _compare_state(ps, tx_state)


def test_bf16_demixed_train_step_matches_jax_loosely(jax_variables,
                                                   inject_jitter):
    """The CLI default (bf16, grad_demix 'auto' -> on), held loosely: see
    the module docstring for where the two frameworks round."""
    from hgr_tpu import config as jax_config

    demix = jax_steps.resolve_grad_demix(
        jax_config.TrainConfig(),
        jax_config.ModelConfig(compute_dtype="bfloat16"))
    assert demix is True and demix == port_steps.resolve_grad_demix(
        TrainConfig(), ModelConfig(compute_dtype="bfloat16"))
    tx_state, m_j, ps, m_p = _one_step(jax_variables, "bfloat16", demix)
    g_p = m_p.pop("_grads")
    want = from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                       m_j.pop("_grads"))})
    num = den = 0.0
    for k, w in want.items():
        g = _np(g_p[k])
        assert np.isfinite(g).all(), k
        num += float(np.sum((g - w.numpy()) ** 2))
        den += float(np.sum(w.numpy() ** 2))
    assert num ** 0.5 <= 0.1 * den ** 0.5, (num ** 0.5, den ** 0.5)
    for k in ("total_loss", "class_loss", "joints_loss"):
        np.testing.assert_allclose(_np(m_p[k]), _np(m_j[k]), rtol=2e-2,
                                   err_msg=k)
    _compare_state(ps, tx_state, stats_tol=2e-2)


def test_grad_accum_2_matches_jax(jax_variables, inject):
    tx_state, m_j, ps, m_p = _one_step(jax_variables, "float32", False,
                                       grad_accum=2)
    _compare_grads(m_p.pop("_grads"), m_j.pop("_grads"), atol=1e-4,
                   rtol=1e-4)
    _compare_metrics(m_p, m_j)
    _compare_state(ps, tx_state)


def test_three_step_trajectory_matches_jax(jax_variables, inject_jitter):
    """Three updates across the lr milestone at update 2; losses within
    5e-3 + 1e-2·|l| (__graft_entry__.py:156)."""
    tx_state, ps = _states(jax_variables, "float32")
    batch = _staged_batch(seed=1)
    j_step = jax_steps.make_train_step(JaxAugmentConfig(), donate=False,
                                       **STEP_KW)
    p_step = port_steps.make_train_step(AugmentConfig(), **STEP_KW)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        tx_state, m_j = j_step(tx_state, _jax_batch(batch),
                               jax.random.PRNGKey(i))
        ps, m_p = p_step(ps, batch, gen)
        lj, lp = float(m_j["total_loss"]), float(m_p["total_loss"])
        assert abs(lp - lj) < 5e-3 + 1e-2 * abs(lj), (i, lp, lj)
    assert ps.step == 3 and ps.optimizer.param_groups[0]["lr"] == LR * 0.1


def test_eval_step_matches_jax(jax_variables):
    tx_state, ps = _states(jax_variables, "float32")
    batch = _staged_batch(seed=2)
    m_j, out_j = jax_steps.make_eval_step(return_outputs=True, **STEP_KW)(
        tx_state, _jax_batch(batch))
    m_p, out_p = port_steps.make_eval_step(return_outputs=True, **STEP_KW)(
        ps, batch)
    _compare_metrics(m_p, m_j)
    for k in ("target", "target_weight", "heatmap", "attnmap"):
        np.testing.assert_allclose(_np(out_p[k]), _np(out_j[k]), atol=1e-4,
                                   err_msg=k)
    assert not ps.model.training
