"""The port's training loop, checkpoints, logging and CLI
(hgr_tpu_torch/train/loop.py, checkpoint.py, logging.py, cli/train.py),
on the CPU with a narrow model, held against the JAX package where the
two compute the same thing (the epoch metrics, the CLI flag surface,
the run metadata keys).
"""

import argparse
import contextlib
import functools
import importlib.util
import inspect
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgr_tpu.train import loop as jax_loop
from hgr_tpu_torch.cli import train as cli
from hgr_tpu_torch.config import DEFAULT_NAMES, DataConfig, ModelConfig
from hgr_tpu_torch.config import TrainConfig
from hgr_tpu_torch.data.dataset import read_annotations
from hgr_tpu_torch.data.loader import BatchLoader
from hgr_tpu_torch.data.synthetic import write_synthetic_split
from hgr_tpu_torch.models import MultiTaskNet
from hgr_tpu_torch.train import loop
from hgr_tpu_torch.train.checkpoint import CheckpointManager
from hgr_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = 32
# keys of run_meta.json written by the JAX fit (hgr_tpu/train/loop.py:336)
JAX_RUN_META = {"backbone", "image_size", "num_joints", "num_classes",
                "compute_dtype", "decoder_dtype", "early_dtype",
                "early_units", "grad_demix"}


@functools.lru_cache(maxsize=None)
def _jax_parser() -> argparse.ArgumentParser:
    """The parser cli/train.py builds inside its parse_args()."""
    spec = importlib.util.spec_from_file_location(
        "_jax_cli_train", os.path.join(REPO, "cli", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Built(Exception):
        pass

    def capture(self, *a, **k):
        raise Built(self)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        mod.parse_args()
    except Built as b:
        return b.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("cli/train.py built no parser")


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


JAX_FLAGS = sorted(_actions(_jax_parser()))


@pytest.mark.parametrize("dest", JAX_FLAGS)
def test_cli_flag_matches_jax(dest):
    want = _actions(_jax_parser())[dest]
    got = _actions(cli.build_parser()).get(dest)
    assert got is not None, f"--{dest} missing from the port's CLI"
    for field in ("option_strings", "default", "type", "choices", "nargs",
                  "required", "const"):
        assert getattr(got, field) == getattr(want, field), (dest, field)
    assert type(got) is type(want)


def test_cli_adds_only_device_defaulting_to_the_card():
    extra = set(_actions(cli.build_parser())) - set(JAX_FLAGS)
    assert extra == {"device"}
    assert cli.parse_args(["--data_config", "x"]).device == "cuda"


@pytest.mark.parametrize("argv,item", [
    (["--remat"], "A13"),
    (["--early_dtype", "float32"], "A13"),
    (["--decoder_dtype", "float32"], "A13"),
    (["--dtype", "mixed"], "A13"),
    (["--grad_demix", "batched"], "A15"),
    (["--debug_images"], "A14"),
])
def test_unported_flags_raise_naming_their_roadmap_item(argv, item):
    """Every flag of A13, A14 and A15 is ported now: each parses, names
    no ROADMAP item in its help, and builds what the JAX CLI builds. A13's
    build the JAX CLI's model (``--dtype mixed``: bf16 with an f32
    decoder); ``--grad_demix batched`` resolves to the batched step, which
    builds and has taken no batched backward; ``--debug_images`` reaches
    ``fit``'s debug dumps."""
    args = cli.parse_args(["--data_config", "x", "--device", "cpu"] + argv)
    data_cfg = DataConfig(names=dict(DEFAULT_NAMES))
    helps = {a.dest: a.help or "" for a in cli.build_parser()._actions}
    assert all("ROADMAP" not in h for h in helps.values()), helps
    cfg = cli.model_config(args, data_cfg)
    if item == "A15":
        from hgr_tpu_torch.train.steps import (
            make_train_step,
            resolve_grad_demix,
        )

        demix = resolve_grad_demix(TrainConfig(grad_demix=args.grad_demix),
                                   cfg)
        assert demix == "batched"
        step = make_train_step(data_cfg.augments, grad_demix=demix)
        assert step.batched_backwards == 0
        return
    if item == "A14":
        assert args.debug_images is True
        assert "debug_images" in inspect.signature(loop.fit).parameters
        return
    want = {"--remat": ("bfloat16", None, None, True),
            "--early_dtype": ("bfloat16", None, "float32", False),
            "--decoder_dtype": ("bfloat16", "float32", None, False),
            "--dtype": ("bfloat16", "float32", None, False)}[argv[0]]
    assert (cfg.compute_dtype, cfg.decoder_dtype, cfg.early_dtype,
            cfg.remat) == want


def test_cli_refuses_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.parse_args(["--data_config", "x", "--save_dir",
                           str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run(args, DataConfig(names=dict(DEFAULT_NAMES)))


# -- epoch metrics -----------------------------------------------------------


def _metric_dicts():
    rng = np.random.RandomState(0)
    out = []
    for valid in (4.0, 4.0, 3.0):
        conf = np.zeros((5, 5), np.float32)
        for t, p in rng.randint(0, 5, (int(valid), 2)):
            conf[t, p] += 1
        out.append({
            "total_loss": np.float32(rng.rand()),
            "class_loss": np.float32(rng.rand()),
            "joints_loss": np.float32(rng.rand()),
            "cls_f1score": np.float32(rng.rand()),
            "pose_acc": np.float32(rng.rand()),
            "pose_cnt": np.float32(rng.randint(0, 60)),
            "valid_cnt": np.float32(valid), "conf_update": conf,
        })
    return out


def test_epoch_metrics_match_jax():
    port, ref = loop.EpochMetrics(5), jax_loop.EpochMetrics(5)
    for m in _metric_dicts():
        port.update({k: torch.from_numpy(np.asarray(v)) for k, v in
                     m.items()})
        ref.update({k: jnp.asarray(v) for k, v in m.items()})
    got, want = port.snapshot(), ref.snapshot()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    port.reset()
    assert port.snapshot()["samples"] == 0.0


# -- fit, checkpoints, resume ------------------------------------------------


@pytest.fixture(scope="module")
def data_cfg(tmp_path_factory):
    """8 train, 4 val and 4 test images of 64 px."""
    root = str(tmp_path_factory.mktemp("loop_data"))
    for i, (s, n) in enumerate((("train", 8), ("val", 4), ("test", 4))):
        write_synthetic_split(root, s, n, image_size=64, seed=i)
    return DataConfig(path=root, names=dict(DEFAULT_NAMES))


def _loader(cfg, split, shuffle):
    idx = read_annotations(os.path.join(cfg.path, cfg.__dict__[split]),
                           cfg.names)
    return BatchLoader(idx, batch_size=4, canvas_size=48, shuffle=shuffle,
                       drop_last=False, num_workers=1)


def _narrow_model(seed):
    return MultiTaskNet(image_size=(IMAGE, IMAGE), dim=32, depth=1, heads=2,
                        mlp_dim=32, generator=torch.Generator().manual_seed(
                            seed))


def _fit(cfg, tmp_path, seed=0, profile_steps=0, debug_images=False,
         train_cfg=TrainConfig(epochs=1, batch_size=4)):
    state = create_train_state(_narrow_model(seed), device="cpu")
    mcfg = ModelConfig(image_size=(IMAGE, IMAGE), compute_dtype="float32")
    save = str(tmp_path / "run")
    state = loop.fit(mcfg, train_cfg, cfg, state,
                     _loader(cfg, "train", True), _loader(cfg, "val", False),
                     _loader(cfg, "test", False), save_path=save,
                     log_dir=str(tmp_path / "logs"), run_name="r",
                     lr_fn=state.schedule, profile_steps=profile_steps,
                     debug_images=debug_images)
    return state, save


def test_fit_writes_checkpoints_meta_logs_and_profile(data_cfg, tmp_path):
    state, save = _fit(data_cfg, tmp_path, profile_steps=1)
    assert state.step == 2  # 1 epoch of 2 steps
    weight = os.path.join(save, "weight")
    for name in ("last.pt", "best.pt", "best_metric.txt", "run_meta.json"):
        assert os.path.isfile(os.path.join(weight, name)), name
    with open(os.path.join(weight, "run_meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == JAX_RUN_META | {"fused_bn", "mesh", "backend"}
    assert meta["grad_demix"] is False and meta["fused_bn"] is False
    assert meta["mesh"] is None and meta["backend"] is None  # one process
    with open(tmp_path / "logs" / "r" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    epoch = [x for x in lines if "epoch" in x]
    assert len(epoch) == 1 and epoch[0]["step"] == 2
    for k in ("train/total_loss", "val/total_loss", "val/epoch_f1",
              "train/loader_wait_s", "epoch_time_s", "train_time_s", "lr"):
        assert np.isfinite(epoch[0][k]), k
    assert any("test/epoch_f1" in x for x in lines)
    assert (os.path.isfile(os.path.join(save, "confusion_matrix.png"))
            or os.path.isfile(os.path.join(save, "confusion_matrix.npy")))
    with open(os.path.join(save, "profile", "profile_summary.json")) as f:
        summary = json.load(f)
    assert summary["window_ms"] > 0 and summary["device_events"] == 0
    assert os.path.isfile(os.path.join(save, "profile", "trace.json"))


def test_resume_restores_params_and_step_exactly(data_cfg, tmp_path):
    state, save = _fit(data_cfg, tmp_path)
    fresh = create_train_state(_narrow_model(seed=1), device="cpu")
    ckpt = CheckpointManager(os.path.join(save, "weight"))
    assert ckpt.has("last") and ckpt.has("best")
    restored = ckpt.restore(fresh, "last")
    assert restored.step == state.step == 2
    want = state.model.state_dict()
    for k, v in restored.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    got_opt = restored.optimizer.state_dict()["state"]
    want_opt = state.optimizer.state_dict()["state"]
    assert got_opt.keys() == want_opt.keys()
    for i in want_opt:
        for k in want_opt[i]:
            torch.testing.assert_close(got_opt[i][k], want_opt[i][k],
                                       rtol=0, atol=0)


def test_best_checkpoint_kept_on_a_worse_epoch(tmp_path):
    model = torch.nn.Linear(2, 2)
    state = create_train_state(model, device="cpu")
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.maybe_save_best(state, 1.0)
    ckpt.wait()  # the write runs on a thread; a new manager reads the disk
    state.step = 5
    assert not CheckpointManager(str(tmp_path)).maybe_save_best(state, 2.0)
    assert ckpt.restore(state, "best").step == 0


def test_failed_best_save_keeps_the_recorded_metric(tmp_path, monkeypatch):
    """best_metric.txt describes the best.pt on disk: a save that fails
    before its rename leaves both as they were."""
    state = create_train_state(torch.nn.Linear(2, 2), device="cpu")
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.maybe_save_best(state, 2.0)
    ckpt.wait()

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", fail)
    state.step = 7
    assert ckpt.maybe_save_best(state, 1.0)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    monkeypatch.undo()
    assert (tmp_path / "best_metric.txt").read_text() == "2.0"
    again = CheckpointManager(str(tmp_path))
    assert not again.maybe_save_best(state, 3.0)
    assert again.maybe_save_best(state, 1.5)
    again.wait()
    assert again.restore(state, "best").step == 7


def test_cli_run_resumes_from_the_saved_step(data_cfg, tmp_path, capsys):
    argv = ["--data_config", "x", "--device", "cpu", "--image_size",
            str(IMAGE), str(IMAGE), "--canvas_size", "48", "--batch_size",
            "4", "--epochs", "1", "--dtype", "float32", "--num_workers", "1",
            "--save_dir", str(tmp_path / "out"), "--log_dir",
            str(tmp_path / "logs")]
    state, save = cli.run(cli.parse_args(argv), data_cfg)
    assert state.step == 2
    state2, save2 = cli.run(cli.parse_args(argv + ["--resume",
                                                   "--device_cache"]),
                            data_cfg)
    assert save2 == save
    assert "resumed from step 2" in capsys.readouterr().out
    assert state2.step == 4


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def test_nonfinite_loss_raises():
    state = create_train_state(torch.nn.Linear(2, 2), device="cpu")

    def step(st, batch, gen):
        return st, {"total_loss": torch.tensor(float("nan"))}

    batch = {"x": np.zeros((2,), np.float32)}
    with pytest.raises(loop.NonFiniteLossError, match="non-finite"):
        loop.train_epoch(state, step, _Loader([batch]), torch.Generator(),
                         loop.EpochMetrics(3))


def test_fit_refuses_mesh_and_debug_images(data_cfg, tmp_path):
    """fit runs meshes (tests/test_torch_parallel.py) and refuses tensor
    parallelism without a model axis; the debug images are ported: with
    ``debug_every`` 1 an epoch of 2 steps dumps the train batch after
    steps 1 and 2 (4 files each) and the first val batch (5 files, the
    attention overlay among them)."""
    state = create_train_state(torch.nn.Linear(2, 2), device="cpu")
    args = (ModelConfig(), TrainConfig(), data_cfg, state, [], [])
    with pytest.raises(ValueError, match="model axis"):
        loop.fit(*args, tensor_parallel=True)
    _, save = _fit(data_cfg, tmp_path, debug_images=True,
                   train_cfg=TrainConfig(epochs=1, batch_size=4,
                                         debug_every=1))
    kinds = ("gt", "pred", "hm_gt", "hm_pred")
    want = {f"train_{s}_{k}.jpg" for s in (1, 2) for k in kinds}
    want |= {f"val_0_{k}.jpg" for k in kinds + ("attn",)}
    assert set(os.listdir(os.path.join(save, "debug"))) == want


def test_mesh_flags_parse_as_the_jax_cli_reads_them():
    from hgr_tpu_torch.parallel.mesh import parse_mesh

    assert parse_mesh("") == {}
    assert parse_mesh("data=4,model=2") == {"data": 4, "model": 2}
    args = cli.parse_args(["--data_config", "x", "--mesh", "data=2",
                           "--host_device_count", "2", "--distributed",
                           "h:1,2,0"])
    assert (args.mesh, args.host_device_count, args.distributed) == (
        "data=2", 2, "h:1,2,0")


@pytest.mark.parametrize("spec,want", [
    ("10.0.0.1:9999,4,2", ("10.0.0.1:9999", 4, 2)),
    ("h:1,2,0", ("h:1", 2, 0))])
def test_distributed_spec_matches_jax(spec, want):
    from hgr_tpu.parallel.distributed import parse_spec as jax_parse_spec
    from hgr_tpu_torch.parallel.distributed import parse_spec

    assert parse_spec(spec) == jax_parse_spec(spec) == want


@pytest.mark.parametrize("spec", ["10.0.0.1:9999,4", "h:1,2,2"])
def test_distributed_spec_refusals_match_jax(spec):
    from hgr_tpu.parallel.distributed import parse_spec as jax_parse_spec
    from hgr_tpu_torch.parallel.distributed import parse_spec

    for fn in (parse_spec, jax_parse_spec):
        with pytest.raises(ValueError):
            fn(spec)


def test_single_process_helpers_answer_as_one_rank(tmp_path):
    """Without a process group: one rank, the coordinator, its own
    decision, a barrier that returns; checkpoints as before."""
    from hgr_tpu_torch.parallel import distributed

    assert distributed.process_count() == 1
    assert distributed.process_index() == 0 and distributed.is_coordinator()
    assert distributed.coordinator_decision(True) is True
    assert distributed.backend() is None
    distributed.barrier()


def test_confusion_falls_back_to_npy_without_matplotlib(tmp_path,
                                                        monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    conf = np.eye(3, dtype=np.float32)
    path = loop.save_confusion(conf, ["a", "b", "c"],
                               str(tmp_path / "confusion_matrix.png"))
    assert path.endswith(".npy")
    np.testing.assert_array_equal(np.load(path), conf)


def test_metric_logger_writes_json_lines(tmp_path):
    from hgr_tpu_torch.train.logging import MetricLogger

    with contextlib.closing(MetricLogger(str(tmp_path), "x")) as lg:
        lg.log(3, {"a": 1.5, "b": torch.tensor(2.0)})
    with open(tmp_path / "x" / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert rec["step"] == 3 and rec["a"] == 1.5 and rec["b"] == 2.0
