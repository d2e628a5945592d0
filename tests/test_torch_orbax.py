"""The JAX package's orbax checkpoints read into the port
(hgr_tpu_torch/utils/orbax_read.py, infer/weights.py,
train/checkpoint.py:payload_from_jax, cli/convert_orbax.py), held against
the JAX package's own writer and restore on the CPU.

A narrow MultiTaskNet (dim 64, one ViT layer) takes two JAX train steps,
so the Adam moments are not zero, and the JAX ``CheckpointManager``
saves it. The port's conversion must equal JAX's orbax restore exactly
(parameters, BN statistics, moments after the layout transposes, step,
and the lr of the update the restored state takes next), and one more
step on each side must agree at the train-step tolerances of
tests/test_torch_train.py, with the same injected augment draw. The weight loader is held against ``hgr_tpu.infer.weights`` for
both payload layouts and both backbones.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from hgr_tpu.config import AugmentConfig as JaxAugmentConfig
from hgr_tpu.infer import weights as jax_weights
from hgr_tpu.models import MultiTaskNet as JaxMultiTaskNet
from hgr_tpu.train import state as jax_state
from hgr_tpu.train import steps as jax_steps
from hgr_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from hgr_tpu_torch.cli import convert_orbax
from hgr_tpu_torch.cli import train as cli
from hgr_tpu_torch.config import DEFAULT_NAMES, AugmentConfig, DataConfig
from hgr_tpu_torch.data.synthetic import write_synthetic_split
from hgr_tpu_torch.infer.weights import load_classifier_weights
from hgr_tpu_torch.models import MultiTaskNet
from hgr_tpu_torch.train import checkpoint as port_ckpt
from hgr_tpu_torch.train import state as port_state
from hgr_tpu_torch.train import steps as port_steps
from hgr_tpu_torch.utils.convert import from_flax, to_flax
from hgr_tpu_torch.utils.orbax_read import read_orbax
from test_torch_train import (
    HIGHEST,
    IMAGE,
    LR,
    MILESTONES,
    PARAMS,
    STEP_KW,
    _compare_metrics,
    _compare_state,
    _inject,
    _jax_batch,
    _np,
    _staged_batch,
)

torch.set_num_threads(1)

NARROW = dict(dim=64, depth=1, heads=2, head_dim=32, mlp_dim=64)


def _port_narrow():
    return MultiTaskNet(image_size=(IMAGE, IMAGE), **NARROW)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two JAX train steps of the narrow model, saved as 'last' and 'best'
    by the JAX CheckpointManager; then JAX's own restore of 'last' and one
    more JAX step from it (the same batch and augment draw)."""
    root = str(tmp_path_factory.mktemp("jax_run") / "weight")
    model = JaxMultiTaskNet(image_size=(IMAGE, IMAGE), precision=HIGHEST,
                            **NARROW)
    state, _ = jax_state.create_train_state(
        model, jax.random.PRNGKey(0), (1, IMAGE, IMAGE, 3), lr=LR,
        milestones_steps=MILESTONES)
    batch = _jax_batch(_staged_batch())
    with pytest.MonkeyPatch.context() as mp:
        _inject(mp, PARAMS)
        step = jax_steps.make_train_step(JaxAugmentConfig(), donate=False,
                                         **STEP_KW)
        for i in range(2):
            state, _ = step(state, batch, jax.random.PRNGKey(i))
        manager = JaxCheckpoints(root)
        manager.save_last(state)
        assert manager.maybe_save_best(state, 0.25)
        manager.wait()
        restored = JaxCheckpoints(root).restore(state, "last")
        after, metrics = step(restored, batch, jax.random.PRNGKey(2))
    return {"dir": root, "restored": restored, "after": after,
            "metrics": metrics}


def _converted(jax_run):
    """The orbax tree, a CPU train state of the narrow model with the JAX
    run's schedule, and the tree converted for that state."""
    tree = read_orbax(os.path.join(jax_run["dir"], "last"))
    state = port_state.create_train_state(
        _port_narrow(), lr=LR, milestones_steps=MILESTONES, device="cpu")
    return tree, state, port_ckpt.payload_from_jax(tree, state)


def test_reader_returns_the_tree_orbax_restores(jax_run):
    """Every leaf of the train-state payload, in its saved dtype and
    shape; the optax chain as a list with its EmptyState as None."""
    tree = read_orbax(os.path.join(jax_run["dir"], "last"))
    want = ocp.StandardCheckpointer().restore(
        os.path.join(jax_run["dir"], "last"))
    got_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got_leaves) == len(want_leaves)
    got = {jax.tree_util.keystr(k): v for k, v in got_leaves}
    for k, w in want_leaves:
        g = got[jax.tree_util.keystr(k)]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w)
    assert tree["step"].dtype == np.int32 and int(tree["step"]) == 2
    assert tree["opt_state"][1] is None
    assert int(tree["opt_state"][2]["count"]) == 2


def test_converted_state_equals_the_orbax_restore_exactly(jax_run):
    tree, ps, payload = _converted(jax_run)
    model = ps.model
    restored = jax_run["restored"]
    want = from_flax({"params": restored.params,
                      "batch_stats": restored.batch_stats})
    assert payload["model"].keys() == want.keys()
    for k, w in want.items():
        assert torch.equal(payload["model"][k], w), k
    adam = restored.opt_state[0]
    mu = jax.tree_util.tree_map(np.asarray, adam.mu)
    nu = jax.tree_util.tree_map(np.asarray, adam.nu)
    names = [n for n, _ in model.named_parameters()]
    state = payload["optimizer"]["state"]
    assert sorted(state) == list(range(len(names)))
    for i, n in enumerate(names):
        p = payload["model"][n]
        assert state[i]["exp_avg"].shape == p.shape, n
        assert state[i]["exp_avg_sq"].shape == p.shape, n
        assert float(state[i]["step"]) == 2.0
    # the layout transposes, written out here for a conv, a dense layer
    # and the packed qkv, as their parameters take them
    by_name = {n: state[i] for i, n in enumerate(names)}
    conv = mu["encoder"]["conv1"]["conv"]["kernel"]  # HWIO -> OIHW
    np.testing.assert_array_equal(
        by_name["encoder.conv1.conv.weight"]["exp_avg"].numpy(),
        conv.transpose(3, 2, 0, 1))
    dense = nu["decoder"]["mlp_head_fc"]["kernel"]  # (in, out) -> (out, in)
    np.testing.assert_array_equal(
        by_name["decoder.mlp_head_fc.weight"]["exp_avg_sq"].numpy(), dense.T)
    qkv = mu["decoder"]["transformer"]["layers_0_attn"]["to_qkv"]["kernel"]
    np.testing.assert_array_equal(
        by_name["decoder.transformer.layers_0_attn.to_qkv.weight"]
        ["exp_avg"].numpy(), qkv.T)
    want_mu, want_nu = from_flax({"params": mu}), from_flax({"params": nu})
    for n, s in by_name.items():
        assert torch.equal(s["exp_avg"], want_mu[n]), n
        assert torch.equal(s["exp_avg_sq"], want_nu[n]), n
    assert payload["step"] == int(restored.step) == 2
    # the lr of the next update (apply_gradients sets the group's lr from
    # the schedule at the restored step): the port's schedule at the JAX
    # step exactly; optax computes the same schedule in float32
    # (test_multistep_lr_boundary_matches_optax)
    port_ckpt.load_payload(ps, payload)
    assert ps.step == 2
    lr = ps.schedule(ps.step)
    assert lr == port_state.multistep_lr(LR, MILESTONES, 0.1)(2)
    np.testing.assert_allclose(lr, float(jax_state.multistep_lr(
        LR, MILESTONES, 0.1)(int(restored.step))), rtol=1e-6)
    group = ps.optimizer.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.999), 1e-8, 0.01)


def test_one_more_step_from_the_converted_state_matches_jax(jax_run,
                                                            monkeypatch):
    _inject(monkeypatch, PARAMS)
    _, ps, payload = _converted(jax_run)
    port_ckpt.load_payload(ps, payload)
    step = port_steps.make_train_step(AugmentConfig(), **STEP_KW)
    ps, m_p = step(ps, _staged_batch(), torch.Generator().manual_seed(2))
    assert ps.optimizer.param_groups[0]["lr"] == port_state.multistep_lr(
        LR, MILESTONES, 0.1)(2)
    after = jax_run["after"]
    _compare_metrics(m_p, jax_run["metrics"])
    _compare_state(ps, after)
    # the moments in gradient units, at the gradient tolerance
    mu = from_flax({"params": jax.tree_util.tree_map(
        np.asarray, after.opt_state[0].mu)})
    opt = ps.optimizer.state_dict()["state"]
    for i, (n, _) in enumerate(ps.model.named_parameters()):
        np.testing.assert_allclose(_np(opt[i]["exp_avg"]), mu[n].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=n)
        assert float(opt[i]["step"]) == 3.0


@pytest.fixture(scope="module")
def orbax_dirs(tmp_path_factory):
    """backbone -> {layout: orbax dir}: the default-width model's bare
    variables (StandardCheckpointer) and its train-state payload (the
    JAX CheckpointManager)."""
    out = {}
    for backbone in ("small", "large"):
        root = tmp_path_factory.mktemp(f"orbax_{backbone}")
        model = JaxMultiTaskNet(image_size=(IMAGE, IMAGE), backbone=backbone)
        state, _ = jax_state.create_train_state(
            model, jax.random.PRNGKey(3), (1, IMAGE, IMAGE, 3))
        bare = str(root / "bare")
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(bare, {"params": state.params,
                          "batch_stats": state.batch_stats})
        ckptr.wait_until_finished()
        manager = JaxCheckpoints(str(root / "run"))
        manager.save_last(state)
        manager.wait()
        out[backbone] = {"bare": bare, "train_state": str(root / "run" /
                                                          "last")}
    return out


@pytest.mark.parametrize("layout", ["bare", "train_state"])
@pytest.mark.parametrize("backbone", ["small", "large"])
def test_load_classifier_weights_reads_orbax_as_jax_does(orbax_dirs, layout,
                                                         backbone):
    path = orbax_dirs[backbone][layout]
    want = from_flax(jax_weights.load_classifier_weights(
        path, image_size=(IMAGE, IMAGE), backbone="auto"))
    got = load_classifier_weights(path, (IMAGE, IMAGE), backbone="auto")
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    MultiTaskNet(image_size=(IMAGE, IMAGE), backbone=backbone
                 ).load_state_dict(got, strict=True)
    other = "large" if backbone == "small" else "small"
    with pytest.raises(ValueError, match=other):
        load_classifier_weights(path, (IMAGE, IMAGE), backbone=other)


@pytest.mark.parametrize("options", [
    {"use_ocdbt": False}, {"use_zarr3": True},
    {"use_ocdbt": True, "use_zarr3": False}])
def test_reader_follows_the_storage_options(tmp_path, options):
    """One array per directory or one OCDBT store; zarr v2 or v3; scalars
    keep their dtype; sequences come back as lists in index order."""
    tree = {"a": np.arange(6, dtype=np.int16).reshape(2, 3),
            "seq": [np.full(2, 1.5, np.float32), {"c": np.int32(3)},
                    np.float64(0.25)],
            "s": np.int32(7)}
    path = str(tmp_path / "ckpt")
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(**options)).save(path, tree)
    got = read_orbax(path)
    assert set(got) == {"a", "seq", "s"} and isinstance(got["seq"], list)
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["a"].dtype == np.int16
    np.testing.assert_array_equal(got["seq"][0], tree["seq"][0])
    assert got["seq"][1]["c"] == 3 and got["seq"][1]["c"].dtype == np.int32
    assert got["seq"][2] == 0.25 and got["seq"][2].dtype == np.float64
    assert got["s"] == 7 and got["s"].dtype == np.int32


def test_missing_tensorstore_raises_a_named_import_error(jax_run,
                                                         monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    last = os.path.join(jax_run["dir"], "last")
    for fn in (read_orbax, load_classifier_weights):
        with pytest.raises(ImportError, match="tensorstore.*convert_orbax"):
            fn(last)


def test_conversion_refuses_what_it_cannot_resume(jax_run, orbax_dirs,
                                                  tmp_path):
    tree = read_orbax(os.path.join(jax_run["dir"], "last"))
    wide = MultiTaskNet(image_size=(IMAGE, IMAGE))
    with pytest.raises(ValueError, match="does not fit"):
        port_ckpt.payload_from_jax(
            tree, port_state.create_train_state(wide, device="cpu"))
    run = tmp_path / "run"
    os.makedirs(run / "weight")
    os.symlink(orbax_dirs["small"]["bare"], run / "weight" / "last")
    with pytest.raises(ValueError, match="bare variables"):
        convert_orbax.convert_run(str(run))
    with pytest.raises(FileNotFoundError, match="orbax"):
        read_orbax(str(tmp_path))


class _Variables:
    """Stands in for a Flax model in ``create_train_state``: its ``init``
    gives a seeded port model's variables in the Flax layout (a JAX init
    at the CLI's widths costs seconds; the optimizer state is still
    optax's own)."""

    def __init__(self, model):
        self.variables = to_flax(model.state_dict())
        self.apply = None

    def init(self, *args, **kwargs):
        return self.variables


def test_converted_jax_run_resumes_through_the_port_cli(tmp_path, capsys):
    """A JAX run directory at the CLI's widths (two AdamW updates from
    seeded gradients, best metric 0.0123): convert_orbax writes last.pt
    and best.pt, and the port's --resume continues at the JAX step, keeps
    the best metric and its checkpoint."""
    image = 32
    save_dir = tmp_path / "out"
    save_path = save_dir / f"gelans_{image}x{image}_run"
    state, _ = jax_state.create_train_state(
        _Variables(MultiTaskNet(image_size=(image, image),
                                generator=torch.Generator().manual_seed(4))),
        jax.random.PRNGKey(4), (1, image, image, 3))
    rng = np.random.RandomState(4)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)),
            state.params)
        state = state.apply_gradients(grads, state.batch_stats)
    manager = JaxCheckpoints(str(save_path / "weight"))
    manager.save_last(state)
    assert manager.maybe_save_best(state, 0.0123)
    manager.wait()
    with open(save_path / "weight" / "run_meta.json", "w") as f:
        json.dump({"backbone": "small", "image_size": [image, image],
                   "num_joints": 21, "num_classes": 19}, f)

    assert convert_orbax.main([str(save_path)]) == {"last": 2, "best": 2}
    assert "-> last.pt (step 2)" in capsys.readouterr().out
    last = torch.load(save_path / "weight" / "last.pt", weights_only=True)
    want = from_flax({"params": state.params,
                      "batch_stats": state.batch_stats})
    for k, w in want.items():
        assert torch.equal(last["model"][k], w), k

    data = str(tmp_path / "data")
    for i, (split, n) in enumerate((("train", 8), ("val", 4), ("test", 4))):
        write_synthetic_split(data, split, n, image_size=64, seed=i)
    argv = ["--data_config", "x", "--device", "cpu", "--image_size",
            str(image), str(image), "--canvas_size", "48", "--batch_size",
            "4", "--epochs", "1", "--dtype", "float32", "--num_workers", "1",
            "--save_dir", str(save_dir), "--log_dir", str(tmp_path / "logs"),
            "--resume"]
    resumed, path = cli.run(cli.parse_args(argv),
                            DataConfig(path=data, names=dict(DEFAULT_NAMES)))
    assert path == str(save_path)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.step == 4
    assert (save_path / "weight" / "best_metric.txt").read_text() == "0.0123"
    best = torch.load(save_path / "weight" / "best.pt", weights_only=True)
    assert best["step"] == 2
