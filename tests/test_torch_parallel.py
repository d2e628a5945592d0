"""Multi-rank training of the port (hgr_tpu_torch/parallel/, the data-rank
hooks of train/steps.py, the global BatchNorm statistics, the rank
loaders and the mesh CLI) held against the JAX package's mesh steps on
the virtual CPU devices (tests/conftest.py) and against the port's own
single-process step at the global batch.

The port's ranks are processes over gloo on the CPU
(``helpers_torch_parallel.spawn_mesh``): one spawn per mesh shape, every
rank running every variant, rank 0 writing the gathered full trees that
module-scoped fixtures read. Both packages start from the same Flax
variables and take the same injected augment draw of the global batch.

Tolerances and why:
- against JAX (f32, ``Precision.HIGHEST``): the JAX mesh tests' own loss
  rtol 2e-4 and first-leaf parameter atol 2e-5 (tests/test_parallel.py
  :102-109); gradients 1e-4 and metrics 1e-5, BatchNorm statistics 1e-5,
  as tests/test_torch_train.py holds the single-device step;
- against the port's single-process step: the same sums taken in another
  order across ranks, so losses and metrics 1e-5, per-tensor relative
  gradient error 5e-5, BatchNorm statistics 1e-5.

The update of every parameter, sharded ones included, is held three
ways. Its AdamW moments, brought back to gradient units (exp_avg/(1−β1)
is the gradient, sqrt(exp_avg_sq/(1−β2)) its magnitude), at the gradient
tolerance. Its change in the step at the JAX tests' 2e-5 wherever the
first AdamW step lr·g/(|g|+eps) is decided: where the reference's
|g| is at least 100 times the two gradients' difference, the steps
differ by at most lr/100. Elsewhere the gradients agree only to rounding
and the sign of the first step may flip, so the parameter itself is
held at 2·lr.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import helpers_torch_parallel as H
from hgr_tpu.config import AugmentConfig as JaxAugmentConfig
from hgr_tpu.data import device_cache as jax_cache
from hgr_tpu.data import loader as jax_loader
from hgr_tpu.data.pipeline import AugmentParams as JaxAugmentParams
from hgr_tpu.models import MultiTaskNet as JaxMultiTaskNet
from hgr_tpu.parallel import mesh as jax_mesh
from hgr_tpu.parallel import steps as jax_psteps
from hgr_tpu.train import state as jax_state
from hgr_tpu.train import steps as jax_steps
from hgr_tpu_torch.cli import train as cli
from hgr_tpu_torch.config import DEFAULT_NAMES, DataConfig
from hgr_tpu_torch.data import device_cache, loader
from hgr_tpu_torch.models import MultiTaskNet
from hgr_tpu_torch.parallel import distributed, mesh
from hgr_tpu_torch.train import steps as port_steps
from hgr_tpu_torch.train.checkpoint import CheckpointManager
from hgr_tpu_torch.train.state import create_train_state
from hgr_tpu_torch.utils.convert import from_flax
from test_torch_data import (  # noqa: F401 — split is a fixture
    _assert_batches_equal,
    _epochs,
    _index_pair,
    split,
)
from test_torch_train import _compare_grads, _compare_metrics

torch.set_num_threads(1)

HIGHEST = jax.lax.Precision.HIGHEST
DP, TP = {"data": 2}, {"data": 2, "model": 2}
VARIANTS = [dict(name="merged", kind="train"),
            dict(name="demix", kind="train", demix=True),
            dict(name="fused_bn", kind="train", demix=True, fused_bn=True),
            dict(name="accum2", kind="train", grad_accum=2),
            dict(name="eval", kind="eval")]


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def variables():
    model = JaxMultiTaskNet(image_size=(H.IMAGE, H.IMAGE), precision=HIGHEST)
    return model.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, H.IMAGE, H.IMAGE, 3)), train=False)


@pytest.fixture(scope="module")
def inputs(variables):
    return {"state": from_flax(variables), "batch": H.staged_batch(),
            "params": H.draw_params()}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """{mesh name: {variant: (metrics, grads, payload)}} of the port's
    ranks, one spawn per mesh."""
    extra = {"dp": [], "tp": [dict(name="roundtrip", kind="roundtrip")]}
    return {name: H.spawn_mesh(shape, inputs, VARIANTS + extra[name],
                               str(tmp_path_factory.mktemp(name)))
            for name, shape in (("dp", DP), ("tp", TP))}


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-process step per variant, at the global batch."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_steps, "draw_augment_params",
                   port_steps.draw_augment_params)
        H.inject(inputs["params"])
        for v in VARIANTS:
            out[v["name"]] = H.run_variant(v, inputs["state"],
                                           inputs["batch"])
    return out


def _rel_errors(got, want):
    return {k: float((got[k].float() - w.float()).norm()
                     / w.float().norm().clamp_min(1e-12))
            for k, w in want.items()}


def _grad_units(moments):
    """The first update's AdamW moments in gradient units: (g, |g|)."""
    return ({k: m.float() / 0.1 for k, (m, _) in moments.items()},
            {k: torch.sqrt(v.float() / 1e-3) for k, (_, v) in moments.items()})


def _assert_changes(after, want_after, before, grads, want_grads):
    """Every parameter's change in the step against the reference's, at
    2e-5 where the first AdamW step is decided (the module docstring);
    that is at least 90% of every tensor's elements (here at worst 94.5%,
    a BatchNorm scale, and 99.75% of all elements)."""
    assert grads.keys() == want_grads.keys()
    for k, gw in want_grads.items():
        gw = torch.as_tensor(np.asarray(gw, np.float32))
        sure = gw.abs() >= 100 * (grads[k].float() - gw).abs()
        assert float(sure.float().mean()) >= 0.9, (k, sure.float().mean())
        p0 = before[k].float()
        got = after[k].float() - p0
        want = torch.as_tensor(np.asarray(want_after[k], np.float32)) - p0
        np.testing.assert_allclose(got[sure].numpy(), want[sure].numpy(),
                                   atol=2e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("variant", [v["name"] for v in VARIANTS])
@pytest.mark.parametrize("mesh_name", ["dp", "tp"])
def test_mesh_step_matches_single_process_step(ranks, single, mesh_name,
                                               variant):
    m_r, g_r, p_r = ranks[mesh_name][variant]
    m_s, g_s, p_s = single[variant]
    _compare_metrics(m_r, m_s, tol=1e-5)
    assert g_r.keys() == g_s.keys()
    errs = _rel_errors(g_r, g_s)
    worst = max(errs, key=errs.get) if errs else None
    assert not errs or errs[worst] <= 5e-5, (worst, errs[worst])
    assert p_r["step"] == p_s["step"]
    for k, w in p_s["model"].items():
        stats = k.endswith((".mean", ".var"))
        np.testing.assert_allclose(
            _np(p_r["model"][k]), _np(w), err_msg=k,
            atol=1e-5 if stats else 2 * H.LR, rtol=1e-5 if stats else 0)


@pytest.mark.parametrize("variant", [v["name"] for v in VARIANTS
                                     if v["kind"] == "train"])
@pytest.mark.parametrize("mesh_name", ["dp", "tp"])
def test_mesh_update_matches_single_process_update(ranks, single, inputs,
                                                   mesh_name, variant):
    """The AdamW moments and the parameter changes of every leaf, sharded
    ones gathered, against the single-process step's."""
    _, g_r, p_r = ranks[mesh_name][variant]
    _, g_s, p_s = single[variant]
    assert p_r["moments"].keys() == p_s["moments"].keys() == g_s.keys()
    for got, want in zip(_grad_units(p_r["moments"]),
                         _grad_units(p_s["moments"])):
        errs = _rel_errors(got, want)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 5e-5, (worst, errs[worst])
    _assert_changes(p_r["model"], p_s["model"], inputs["state"], g_r, g_s)


def test_tp_ranks_held_shards_and_ran_the_split_route(ranks, inputs):
    """Each TP rank's attention took the split route on its 4 of the 8
    heads, and the gathered trees have the full shapes."""
    _, _, payload = ranks["tp"]["merged"]
    assert payload["attention"] == ("split", 4)
    assert ranks["dp"]["merged"][2]["attention"] == (True, 8)
    full = inputs["state"]
    assert {k: tuple(v.shape) for k, v in payload["model"].items()} == {
        k: tuple(v.shape) for k, v in full.items()}


def test_shard_then_gather_is_the_identity(ranks):
    """Parameters, BatchNorm statistics and AdamW moments, cut to each
    rank's share of the 2x2 mesh and gathered back, bit for bit."""
    rt = ranks["tp"]["roundtrip"]
    full, back = rt["full"], rt["back"]
    assert back["step"] == full["step"] == 1
    assert back["model"].keys() == full["model"].keys()
    for k, v in full["model"].items():
        assert torch.equal(back["model"][k], v), k
    f_opt, b_opt = full["optimizer"], back["optimizer"]
    assert f_opt["param_groups"] == b_opt["param_groups"]
    for pid, st in f_opt["state"].items():
        for k, v in st.items():
            assert torch.equal(b_opt["state"][pid][k], v), (pid, k)


# -- against the JAX mesh steps ----------------------------------------------


def _jax_mesh_step(variables, inputs, mesh_shape, demix):
    tp = mesh_shape.get("model", 1) > 1
    model = JaxMultiTaskNet(
        image_size=(H.IMAGE, H.IMAGE), precision=HIGHEST,
        fused_attention=jax_mesh.resolve_fused_attention(mesh_shape))
    state, _ = jax_state.create_train_state(
        model, jax.random.PRNGKey(0), (1, H.IMAGE, H.IMAGE, 3), lr=H.LR,
        milestones_steps=(1000,))
    params = inputs["params"]

    def draw(key, batch, sizes_hw, cfg):
        return JaxAugmentParams(**{k: jnp.asarray(v[:batch])
                                   for k, v in params.items()})

    jmesh = jax_mesh.make_mesh(mesh_shape)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "draw_augment_params", draw)
        mp.setattr(jax_steps, "make_train_step", functools.partial(
            jax_steps.make_train_step, debug_return_grads=True))
        state = jax_psteps.shard_state(state, jmesh, tensor_parallel=tp)
        step = jax_psteps.make_parallel_train_step(
            jmesh, JaxAugmentConfig(), state, tensor_parallel=tp,
            grad_demix=demix, **H.STEP_KW)
        with jmesh:
            key = jax.device_put(jax.random.PRNGKey(7),
                                 jax.sharding.NamedSharding(
                                     jmesh, jax.sharding.PartitionSpec()))
            state, m = step(state, jax_mesh.shard_batch(inputs["batch"],
                                                        jmesh), key)
    return state, m


JAX_CASES = [("dp", "merged"), ("dp", "demix"), ("tp", "merged")]


@pytest.fixture(scope="module")
def jax_steps_out(variables, inputs):
    """{(mesh name, variant): (state, metrics, grads)} of the JAX mesh
    steps, each compiled once for the tests that read it."""
    out = {}
    for mesh_name, variant in JAX_CASES:
        state, m = _jax_mesh_step(variables, inputs,
                                  {"dp": DP, "tp": TP}[mesh_name],
                                  variant == "demix")
        m = dict(m)
        out[mesh_name, variant] = (state, m, m.pop("_grads"))
    return out


@pytest.mark.parametrize("mesh_name,variant", JAX_CASES)
def test_mesh_step_matches_jax_mesh_step(ranks, jax_steps_out, mesh_name,
                                         variant):
    j_state, m_j, g_j = jax_steps_out[mesh_name, variant]
    m_p, g_p, p_p = ranks[mesh_name][variant]
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
    # the JAX mesh tests' own leaf: the first of the Flax tree
    np.testing.assert_allclose(_np(p_p["model"]["decoder.cls_token"]),
                               want["decoder.cls_token"].numpy(), atol=2e-5)
    assert p_p["step"] == int(j_state.step)


def _flax_leaves(tree):
    return from_flax({"params": jax.tree_util.tree_map(np.asarray, tree)})


@pytest.mark.parametrize("mesh_name,variant", JAX_CASES)
def test_mesh_update_matches_jax_mesh_update(ranks, jax_steps_out, inputs,
                                             mesh_name, variant):
    """The AdamW moments (optax's mu, nu) and the parameter changes of
    every leaf, sharded ones gathered, against the JAX mesh step's."""
    j_state, _, g_j = jax_steps_out[mesh_name, variant]
    _, g_p, p_p = ranks[mesh_name][variant]
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


# -- mesh, rules, state layout -----------------------------------------------


@pytest.mark.parametrize("shape,heads", [
    ({}, 8), ({"data": 8}, 8), ({"data": 8, "model": 1}, 8),
    ({"data": 4, "model": 2}, 8), ({"data": 1, "model": 8}, 8),
    ({"data": 2, "model": 3}, 8), ({"model": 3}, 9)])
def test_resolve_fused_attention_matches_jax(shape, heads):
    assert (mesh.resolve_fused_attention(shape, heads)
            == jax_mesh.resolve_fused_attention(shape, heads))


def _sharded_leaves(variables, shape):
    """(the leaves the port shards on ``shape``, those JAX shards)."""
    jmesh = jax_mesh.make_mesh(shape)
    sh = jax_mesh.param_shardings(variables["params"], jmesh,
                                  jax_mesh.TP_RULES)
    marked = jax.tree_util.tree_map(
        lambda s, p: np.full(p.shape, float(any(a is not None
                                                for a in s.spec)),
                             np.float32), sh, variables["params"])
    want = {k for k, v in from_flax({"params": marked}).items()
            if float(v.sum())}
    got = {k for k, v in from_flax(variables).items()
           if mesh.tp_layout(k, v.shape, shape["model"], 8)}
    return got, want


def test_tp_rules_shard_the_jax_rules_parameters(variables):
    """The port shards exactly the leaves TP_RULES shards in JAX."""
    got, want = _sharded_leaves(variables, {"data": 4, "model": 2})
    assert got == want and len(got) == 5 * 4


@pytest.mark.parametrize("shape", [{"data": 2, "model": 3},
                                   {"data": 1, "model": 6}])
def test_tp_rules_shard_only_the_leaves_that_divide(variables, shape):
    """3 or 6 ranks divide to_qkv's 768 columns and none of the 256-wide
    leaves: JAX and the port shard to_qkv alone."""
    got, want = _sharded_leaves(variables, shape)
    assert got == want and len(got) == 4
    assert all(k.endswith("to_qkv.weight") for k in got)


def test_shard_rows_layout():
    np.testing.assert_array_equal(mesh.shard_rows(8, 2, 1), [4, 5, 6, 7])
    np.testing.assert_array_equal(mesh.shard_rows(8, 2, 1, 2),
                                  [2, 3, 6, 7])
    with pytest.raises(ValueError):
        mesh.shard_rows(6, 2, 0, 2)


def test_make_mesh_needs_every_rank():
    assert mesh.make_mesh({"data": 1}).data_group is None
    with pytest.raises(ValueError, match="needs 2 devices"):
        mesh.make_mesh({"data": 2})
    with pytest.raises(ValueError):
        mesh.parse_mesh("data=2,pipe=2")


def test_backend_rule_and_nccl_refusals():
    """nccl only where each rank has a card of its own: never on the CPU
    nor for ranks that share a card (no flag names a backend)."""
    assert distributed.backend_for("cpu") == "gloo"
    assert distributed.backend_for("cpu", shared_card=True) == "gloo"
    assert distributed.backend_for("cuda", shared_card=True) == "gloo"
    assert distributed.backend_for("cuda") == "nccl"


# -- loaders -----------------------------------------------------------------


@pytest.mark.parametrize("shuffle", [False, True])
def test_rank_slices_concat_to_global_and_match_jax(split, shuffle):
    p_idx, j_idx = _index_pair(split)
    kw = dict(batch_size=4, canvas_size=64, shuffle=shuffle, seed=5,
              drop_last=False, num_workers=1, window_frac=0.75)
    full = _epochs(loader.BatchLoader(p_idx, **kw))
    parts = [_epochs(loader.BatchLoader(p_idx, process_count=2,
                                        process_index=i, **kw))
             for i in range(2)]
    jax_parts = [_epochs(jax_loader.BatchLoader(j_idx, process_count=2,
                                                process_index=i, **kw))
                 for i in range(2)]
    for i in range(2):
        _assert_batches_equal(parts[i], jax_parts[i])
    _assert_batches_equal(
        [{k: np.concatenate([a[k], b[k]]) for k in a}
         for a, b in zip(*parts)], full)
    # with microbatches each rank holds its share of every microbatch
    micro = [_epochs(loader.BatchLoader(p_idx, process_count=2,
                                        process_index=i, microbatches=2,
                                        **kw)) for i in range(2)]
    for i in range(2):
        rows = mesh.shard_rows(4, 2, i, 2)
        _assert_batches_equal(micro[i], [{k: v[rows] for k, v in b.items()}
                                         for b in full])


@pytest.mark.parametrize("snapshot", [False, True])
def test_sharded_cache_blocks_equal_jax_global_batches(split, tmp_path,
                                                       snapshot):
    """Both ranks' blocks, concatenated, are the JAX sharded cache's
    global batches on a {'data': 2} mesh, every epoch, padded tail
    included."""
    p_idx, j_idx = _index_pair(split)
    kw = dict(batch_size=4, canvas_size=64, shuffle=True, seed=6,
              drop_last=False, num_workers=1, window_frac=0.75)
    snap = str(tmp_path / "snap") if snapshot else ""
    ranks_ = [device_cache.ShardedDeviceCacheLoader(
        p_idx, shard_index=i, shard_count=2, snapshot_dir=snap,
        device="cpu", **kw) for i in range(2)]
    ref = jax_cache.ShardedDeviceCacheLoader(
        j_idx, jax_mesh.make_mesh({"data": 2}), **kw)
    assert len(ranks_[0]) == len(ranks_[1]) == len(ref)
    got = [_epochs(r, 3) for r in ranks_]
    want = _epochs(ref, 3)
    _assert_batches_equal([{k: np.concatenate([_host(a[k]), _host(b[k])])
                            for k in a} for a, b in zip(*got)], want)
    assert sum(float(b["valid"].sum()) for b in want[:len(ref)]) == len(p_idx)


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# -- the CLI -----------------------------------------------------------------


@pytest.fixture(scope="module")
def data_cfg(tmp_path_factory):
    """8 train, 4 val and 4 test images of 64 px."""
    from hgr_tpu_torch.data.synthetic import write_synthetic_split

    root = str(tmp_path_factory.mktemp("mesh_data"))
    for i, (s, n) in enumerate((("train", 8), ("val", 4), ("test", 4))):
        write_synthetic_split(root, s, n, image_size=64, seed=i)
    return DataConfig(path=root, names=dict(DEFAULT_NAMES))


def _argv(tmp_path, *extra):
    return ["--data_config", "x", "--batch_size", "4", "--canvas_size", "64",
            "--image_size", "64", "64", "--dtype", "float32", "--seed", "0",
            "--num_workers", "1", "--device", "cpu", "--save_dir",
            str(tmp_path / "out"), "--log_dir", str(tmp_path / "logs"),
            *extra]


def test_cli_2x2_mesh_trains_and_its_checkpoint_restores_on_one_rank(
        data_cfg, tmp_path):
    state, save = cli.run(cli.parse_args(_argv(
        tmp_path, "--epochs", "1", "--mesh", "data=2,model=2",
        "--host_device_count", "4")), data_cfg)
    assert state is None  # the ranks ran in processes of their own
    per_rank = []
    for r in range(4):
        with open(os.path.join(save, "ranks", f"rank{r}.json")) as f:
            per_rank.append(json.load(f))
    assert all(p["step"] == 2 and p["backend"] == "gloo" for p in per_rank)
    with open(os.path.join(save, "weight", "run_meta.json")) as f:
        meta = json.load(f)
    assert meta["mesh"] == {"data": 2, "model": 2} and meta["backend"] == "gloo"
    with open(os.path.join(str(tmp_path / "logs"), os.path.basename(save),
                           "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert sum("epoch" in x for x in lines) == 1  # the coordinator's alone
    assert sum("test/epoch_f1" in x for x in lines) == 1
    # the full tree: restores strictly into a single-rank model
    one = create_train_state(MultiTaskNet(image_size=(64, 64)), device="cpu")
    one = CheckpointManager(os.path.join(save, "weight")).restore(one, "best")
    assert one.step == 2
    assert one.optimizer.state_dict()["state"]


@pytest.mark.parametrize("extra,error", [
    (["--mesh", "data=2,model=2", "--device_cache"], SystemExit),
    (["--distributed", "h:1,2,0", "--mesh", "data=2,model=2"], SystemExit),
    (["--distributed", "h:1,2,0", "--mesh", "data=2", "--device_cache"],
     SystemExit),
    (["--distributed", "h:1,2,0"], SystemExit),
    (["--distributed", "h:1,2,0", "--mesh", "data=4"], SystemExit),
    (["--mesh", "data=2", "--grad_accum", "4"], SystemExit),
    (["--mesh", "data=4", "--host_device_count", "2"], ValueError),
])
def test_cli_mirrors_the_jax_mesh_refusals(tmp_path, extra, error):
    with pytest.raises(error):
        cli.run(cli.parse_args(_argv(tmp_path, *extra)),
                DataConfig(names=dict(DEFAULT_NAMES)))


@pytest.mark.parametrize("extra", [
    ["--mesh", "data=1,model=3"],
    ["--mesh", "data=2,model=3"],
    ["--mesh", "data=2", "--device_cache", "--grad_accum", "2"]])
def test_cli_accepts_the_meshes_the_jax_cli_accepts(tmp_path, extra):
    """A model axis that does not divide the heads, and the sharded device
    cache with accumulation, pass the CLI's checks as in JAX (both run
    through ``cli.run`` in tests/test_torch_tp_uneven.py and
    tests/test_torch_cache_accum.py)."""
    args = cli.parse_args(_argv(tmp_path, *extra))
    assert cli._check_mesh(args, mesh.parse_mesh(args.mesh), 1) is None


def test_cuda_ranks_without_a_card_each_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = _argv(tmp_path, "--mesh", "data=2")
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="host_device_count"):
        cli.run(cli.parse_args(argv), DataConfig(names=dict(DEFAULT_NAMES)))
