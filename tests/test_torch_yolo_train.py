"""Detector training in the port (hgr_tpu_torch/models/yolo.py in train
mode, models/yolo_loss.py, tools/train_detector_smoke.py) held against
the JAX package on the CPU.

Inputs are made by numpy from a seed and fed to both sides; the JAX
detector runs at ``precision=HIGHEST``. Tolerances: batch statistics
1e-5, the loss of given heads and its parts 1e-5 and their gradients
1e-4; the whole train step is held against JAX and against a float64
evaluation (``test_one_detector_train_step_matches_jax`` says why).
Train-mode heads at B = 2 and 64 px are held at 2e-3: there the deepest BatchNorms normalize 8 values
a channel, and f32 alone moves the heads by up to 8e-4 (JAX's f32
forward against a float64 evaluation of the same module); the port is
also held to be no farther from that float64 evaluation than JAX is.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hgr_tpu.models import yolo as jyolo
from hgr_tpu.models import yolo_loss as jloss
from hgr_tpu.tools import train_detector_smoke as jtool
from hgr_tpu_torch.infer.weights import load_detector_weights
from hgr_tpu_torch.models import yolo as tyolo
from hgr_tpu_torch.models import yolo_loss as tloss
from hgr_tpu_torch.tools import train_detector_smoke as ttool
from hgr_tpu_torch.utils.convert import from_flax

torch.set_num_threads(1)
HI = jax.lax.Precision.HIGHEST
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "yolo_smoke_weights.npz")
SIZE, B = 64, 2


def _np(a):
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def jax_init():
    """A JAX detector (f32, HIGHEST) and its init variables (PRNGKey(0),
    64 px) as numpy arrays."""
    jm = jyolo.YOLOv7Tiny(num_classes=1, precision=HI)
    init = jax.jit(lambda key, x: jm.init(key, x, train=True))
    return jm, jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))


@pytest.fixture(scope="module")
def det_init(jax_init):
    """The JAX detector and its init variables with BN statistics and
    affine perturbed, so both train- and eval-mode BN do work."""
    jm, raw = jax_init
    v = jax.tree_util.tree_map(lambda a: a, raw)  # its own dicts
    rng = np.random.RandomState(0)

    def walk(node, in_bn):
        for k, x in node.items():
            if isinstance(x, dict):
                walk(x, in_bn or k == "bn")
            elif in_bn and k == "mean":
                node[k] = (0.1 * rng.randn(*x.shape)).astype(np.float32)
            elif in_bn and k == "var":
                node[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif in_bn and k == "scale":
                node[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    walk(v, False)
    return jm, v


def _port(variables, dtype=torch.float32):
    tm = tyolo.YOLOv7Tiny(num_classes=1, dtype=dtype)
    tm.load_state_dict(from_flax(variables), strict=True)
    return tm


def _frames(seed=1):
    return np.random.RandomState(seed).rand(B, SIZE, SIZE, 3).astype(
        np.float32)


def _float64_heads(variables, x):
    """The port's train-mode heads computed in float64 throughout, the
    yardstick of both f32 forwards."""
    tm = _port(variables, torch.float64).double().train()
    with torch.no_grad():
        return [o.numpy() for o in tm(torch.from_numpy(x).double())]


def test_train_mode_forward_matches_jax(det_init):
    """f32, B = 2 at 64 px: the heads and the new batch statistics
    (Flax's fast variance, momentum 0.97) against
    ``apply(train=True, mutable=['batch_stats'])``; eval mode then reads
    the updated statistics as Flax does."""
    jm, v = det_init
    x = _frames()
    want, mutated = jm.apply(v, x, train=True, mutable=["batch_stats"])
    tm = _port(v).train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    exact = _float64_heads(v, x)
    for s, (g, w, e) in enumerate(zip(got, want, exact)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=2e-3, rtol=0,
                                   err_msg=f"scale {s}")
        assert (np.abs(_np(g) - e).max()
                <= np.abs(_np(w) - e).max()), f"scale {s}"
    stats = from_flax({"params": {}, **mutated})
    sd = tm.state_dict()
    assert stats.keys() == {k for k in sd if k.endswith((".mean", ".var"))}
    for k, w in stats.items():
        np.testing.assert_allclose(_np(sd[k]), w.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    want_e = jm.apply({**v, **mutated}, x, train=False)
    with torch.no_grad():
        got_e = tm.eval()(torch.from_numpy(x))
    for g, w in zip(got_e, want_e):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)


def test_fresh_detector_draws_its_variables_as_jax_init(jax_init):
    """The port's fresh detector (generator seed 0) against the JAX
    module's ``init`` (PRNGKey(0), 64 px), variable by variable. torch
    cannot replay jax.random, so the draws differ but their distributions
    must not: zero exactly where JAX's variables are zero (the BN biases
    and means, the detect heads' biases), the std within 10% of JAX's for
    every variable of at least 1,000 elements (the ConvActs' U(+-1/
    sqrt(fan_in)), the detect heads' lecun_normal), and the detect
    kernels inside lecun_normal's truncation bound 2·s, s = sqrt(1/fan_in)
    / 0.8796 (Flax's variance_scaling divides by the std of a unit normal
    truncated to [-2, 2])."""
    _, raw = jax_init
    want = from_flax(raw)
    got = tyolo.YOLOv7Tiny(num_classes=1, generator=torch.Generator()
                           .manual_seed(0)).state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g == 0, w == 0, err_msg=k)
        if w.size >= 1000:
            assert abs(g.std() - w.std()) <= 0.1 * w.std(), (
                k, g.std(), w.std())
    for i in range(3):
        w = got[f"detect{i}.weight"]
        s = np.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
        assert float(w.abs().max()) <= 2.0 * s, i


def test_detector_trains_in_training_mode():
    """A module starts in training mode and runs: the forward updates
    every running statistic once (it raised before training was ported)."""
    tm = tyolo.YOLOv7Tiny()
    before = {k: v.clone() for k, v in tm.state_dict().items()
              if k.endswith(".mean")}
    outs = tm(torch.from_numpy(_frames(2)))
    assert tm.training and len(outs) == 3
    assert all(not torch.equal(tm.state_dict()[k], b)
               for k, b in before.items())


def _heads_and_boxes(seed=3):
    rng = np.random.RandomState(seed)
    outs = [(rng.randn(4, h, w, 18) * 1.5).astype(np.float32)
            for h, w in ((8, 8), (4, 4), (2, 2))]
    gt = np.array([[20.0, 30.0, 12.0, 14.0],    # P3
                   [40.0, 22.0, 60.0, 50.0],    # P4
                   [63.9, 0.2, 200.0, 180.0],   # P5, the edge cells
                   [10.0, 50.0, 0.0, 0.0]],     # a 9-way wh-IoU tie
                  np.float32)
    return outs, gt


def test_assign_targets_match_jax_with_a_tie():
    """The best (scale, anchor) by wh-IoU, the first on ties (a box of
    zero size ties every anchor at IoU 0), the clipped cell and the
    sigmoid-domain targets."""
    outs, gt = _heads_and_boxes()
    grid = [(o.shape[1], o.shape[2]) for o in outs]
    want = jloss.assign_targets(jnp.asarray(gt), grid)
    got = tloss.assign_targets(torch.from_numpy(gt), grid)
    masks = np.stack([np.asarray(m) for m, *_ in want])
    assert masks[:, 3].tolist() == [True, False, False]  # index 0 wins
    for (gm, ga, gc, gt_), (wm, wa, wc, wt) in zip(got, want):
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_allclose(gt_.numpy(), np.asarray(wt), atol=1e-6)


def test_single_box_loss_and_its_gradient_match_jax():
    outs, gt = _heads_and_boxes()

    def jtotal(o):
        return jloss.yolo_single_box_loss(o, jnp.asarray(gt))

    (jt, jparts), jgrads = jax.value_and_grad(jtotal, has_aux=True)(
        [jnp.asarray(o) for o in outs])
    t_outs = [torch.from_numpy(o).requires_grad_() for o in outs]
    tt, tparts = tloss.yolo_single_box_loss(t_outs, torch.from_numpy(gt))
    tgrads = torch.autograd.grad(tt, t_outs)
    np.testing.assert_allclose(_np(tt), _np(jt), atol=1e-5, rtol=1e-5)
    assert tparts.keys() == jparts.keys()
    for k in jparts:
        np.testing.assert_allclose(_np(tparts[k]), _np(jparts[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)


def _port_grads_float64(variables, frames, gt):
    """The port's loss gradients computed in float64 throughout: the
    yardstick of both f32 gradients."""
    tm = _port(variables, torch.float64).double().train()
    x = torch.from_numpy(frames).double() / 255.0
    total, _ = tloss.yolo_single_box_loss(tm(x), torch.from_numpy(
        gt).double())
    total.backward()
    return {k: p.grad.numpy() for k, p in tm.named_parameters()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_one_detector_train_step_matches_jax(det_init):
    """The tool's step (uint8 -> f32/255 -> train-mode forward -> loss ->
    backward -> Adam) against the JAX tool's step in f32: the loss, the
    batch statistics (1e-5), the gradients and the updated parameters.

    At B = 2 and 64 px f32 itself moves the gradients of the deep layers
    by percents (8 values a channel in the deepest BatchNorms): JAX's
    differ from a float64 evaluation by 0.38% in norm, 5% in the worst
    tensor, the port's by 0.18%. So the port's gradients are held to be
    no farther from float64 than JAX's, and within 0.1 of JAX's per
    tensor (1% overall); the parameters within 1e-5 plus the difference
    of Adam's first update lr·g/(|g| + eps) between the two gradients,
    (up to 2·lr where a gradient at rounding level flips sign, large
    where a gradient is near eps = 1e-8)."""
    jm, v = det_init
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    gt = np.array([[20.0, 24.0, 18.0, 22.0], [40.0, 36.0, 50.0, 44.0]],
                  np.float32)
    lr = 1e-3
    tx = optax.adam(lr)
    adam1 = lambda g: lr * g / (np.abs(g) + 1e-8)  # noqa: E731

    @jax.jit
    def jstep(params, stats):
        def loss_fn(p):
            x = jnp.asarray(frames).astype(jnp.float32) / 255.0
            outs, mut = jm.apply({"params": p, "batch_stats": stats}, x,
                                 train=True, mutable=["batch_stats"])
            total, _ = jloss.yolo_single_box_loss(outs, jnp.asarray(gt))
            return total, mut["batch_stats"]

        (total, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return total, new_stats, grads, optax.apply_updates(params, updates)

    jt, jstats, grads, jparams = jstep(v["params"], v["batch_stats"])
    tm = _port(v)
    step = ttool.make_detector_train_step(tm, ttool.adam(tm.parameters(),
                                                         lr))
    tt, _ = step(torch.from_numpy(frames), torch.from_numpy(gt))
    # the loss of the two forwards' heads: their f32 difference
    np.testing.assert_allclose(_np(tt), _np(jt), rtol=1e-4)
    jg = {k: t.numpy() for k, t in from_flax({"params": grads}).items()}
    pg = {k: _np(p.grad) for k, p in tm.named_parameters()}
    g64 = _port_grads_float64(v, frames, gt)
    cat = lambda d: np.concatenate([d[k].ravel() for k in g64])  # noqa
    assert _rel(cat(pg), cat(g64)) <= _rel(cat(jg), cat(g64))
    assert _rel(cat(pg), cat(jg)) <= 1e-2
    for k in g64:
        assert _rel(pg[k], jg[k]) <= 0.1, k
    want = from_flax({"params": jparams, "batch_stats": jstats})
    got = tm.state_dict()
    for k, w in want.items():
        diff = np.abs(_np(got[k]) - w.numpy())
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(_np(got[k]), w.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
            continue
        # Adam's first update of each side's own gradient
        gap = np.abs(adam1(pg[k]) - adam1(jg[k]))
        assert (diff <= 1e-5 + gap).all(), k


def test_make_scene_equals_the_jax_tool_bit_for_bit():
    """With shrink_prob=0 the frames and boxes are the JAX tool's for the
    same RandomState, scene after scene; with the default shrink (the JAX
    tool resizes with cv2's INTER_AREA here) they are too."""
    for kw in (dict(shrink_prob=0.0), {}):
        r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
        for _ in range(4):
            jf, jg = jtool.make_scene(r1, **kw)
            tf, tg = ttool.make_scene(r2, **kw)
            np.testing.assert_array_equal(tf, jf)
            np.testing.assert_array_equal(tg, jg)


def test_area_resize_matches_cv2_inter_area_at_every_size():
    """Every size the tool draws (416 · f, f in [0.55, 0.95]): within one
    level of cv2.resize(INTER_AREA), bit for bit in practice."""
    rng = np.random.RandomState(8)
    img = rng.randint(0, 256, (416, 416, 3)).astype(np.uint8)
    worst, differ = 0, 0
    for new in range(int(round(416 * 0.55)), int(round(416 * 0.95)) + 1):
        got = ttool.area_resize_u8(img, new).astype(np.int32)
        want = cv2.resize(img, (new, new),
                          interpolation=cv2.INTER_AREA).astype(np.int32)
        assert got.shape == want.shape
        worst = max(worst, int(np.abs(got - want).max()))
        differ += int((got != want).sum())
    assert worst <= 1
    assert differ == 0  # cv2 5.0's float32 order, reproduced


def test_npz_round_trip_through_both_loaders(tmp_path):
    """The tool writes float16 arrays under the JAX tool's Flax paths (the
    fixture's key set); the port's loader and the JAX loader read back the
    model's variables rounded to float16."""
    tm = tyolo.YOLOv7Tiny(num_classes=1)
    tm.train()(torch.from_numpy(_frames(4)))  # non-trivial statistics
    path = str(tmp_path / "det.npz")
    ttool.save_detector_npz(tm, path)
    with np.load(path) as f, np.load(FIXTURE) as fx:
        assert set(f.files) == set(fx.files)
        assert all(f[k].dtype == np.float16 for k in f.files)
    want = {k: v.half().float() for k, v in tm.state_dict().items()}
    got = load_detector_weights(path)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    via_jax = from_flax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jyolo.load_npz_weights(path)))
    for k in want:
        assert torch.equal(via_jax[k], want[k]), k


def test_tool_runs_end_to_end_and_never_writes_the_fixture(tmp_path):
    """Two steps at 224 px on the CPU: finite, falling-or-not losses, the
    eval, the .npz written where asked; the default --out is under build/,
    never tests/fixtures/."""
    assert os.path.join("build", "") in ttool.DEFAULT_OUT
    assert "fixtures" not in ttool.DEFAULT_OUT
    out = str(tmp_path / "w.npz")
    res = ttool.main(["--steps", "2", "--batch", "2", "--size", "224",
                      "--eval_n", "2", "--unique_batches", "1",
                      "--out", out, "--device", "cpu"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert res["pool_seconds"] > 0 and res["ms_per_step"] > 0
    assert res["ious"].shape == (2,) and os.path.exists(out)
    load_detector_weights(out)
