"""The port's measurement tools (hgr_tpu_torch/utils/profiling.py and
tools/{fwd,bwd}_attribution, serve_bench, video_bench, gen_synthetic,
bn_convergence_ab) on the CPU at tiny sizes, held against the JAX tools.

Each tool runs end to end and its output keys are the JAX tool's. Where a
tool's arithmetic is pure, the same inputs go through the JAX tool's own
code: the JAX attribution tools' ``main`` with their timer replaced by
given times, the expression that builds serve_bench's result (taken from
the JAX source), ``ServeMetrics`` and ``StepTimer``, and the chunked
synthetic writer.
"""

import ast
import contextlib
import functools
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hgr_tpu_torch.tools import (
    bn_convergence_ab,
    bwd_attribution,
    fwd_attribution,
    gen_synthetic,
    serve_bench,
    video_bench,
)
from hgr_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_main(module, argv, monkeypatch, times):
    """stdout of the JAX tool ``module``'s main under ``argv`` with its
    ``_timeit`` answering ``times`` in call order (no graph is run, so the
    models' variables need only their shapes)."""
    from hgr_tpu.models import MultiTaskNet
    from hgr_tpu.models.gelan import GELANNet

    for cls in (MultiTaskNet, GELANNet):
        init = cls.init
        monkeypatch.setattr(cls, "init", lambda self, *a, _init=init, **k:
                            jax.eval_shape(
                                functools.partial(_init, self, **k), *a))
    answers = iter(times)
    monkeypatch.setattr(module, "_timeit", lambda *a, **k: next(answers))
    monkeypatch.setenv("HGR_TPU_NO_CACHE", "1")
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main()
    return out.getvalue()


# -- the flags ---------------------------------------------------------------


@pytest.mark.parametrize("name,extra", [
    ("serve_bench", {"--image_size", "--device"}),
    ("video_bench", {"--workdir", "--device"}),
    ("fwd_attribution", {"--image_size", "--device"}),
    ("bwd_attribution", {"--image_size"}),
    ("bn_convergence_ab", {"--image_size", "--device"}),
    ("gen_synthetic", set()),
])
def test_tool_keeps_the_jax_tools_flags(name, extra, capsys, monkeypatch):
    """Every flag of the JAX tool (read from its --help: its parser is
    built inside main), plus only the named extras."""
    import importlib
    import re

    module = importlib.import_module(f"hgr_tpu.tools.{name}")
    monkeypatch.setattr(sys, "argv", [module.__file__, "--help"])
    with pytest.raises(SystemExit):
        module.main()
    want = set(re.findall(r"(--\w+)", capsys.readouterr().out)) - {"--help"}
    port = importlib.import_module(f"hgr_tpu_torch.tools.{name}")
    got = {a for action in port.build_parser()._actions
           for a in action.option_strings if a.startswith("--")} - {"--help"}
    assert got == want | extra


# -- profiling ---------------------------------------------------------------


def test_step_timer_summary_matches_jax():
    from hgr_tpu.utils.profiling import StepTimer as JaxStepTimer

    times = list(np.random.RandomState(0).rand(37) * 0.05)
    port, ref = profiling.StepTimer(), JaxStepTimer()
    port.times, ref.times = list(times), list(times)
    assert port.summary() == ref.summary()
    assert profiling.StepTimer().summary() == JaxStepTimer().summary() == {}
    with port.step():
        pass
    assert port.summary()["steps"] == 38


def test_flops_of_counts_what_xla_counts():
    from hgr_tpu.utils.profiling import flops_of as jax_flops_of

    a = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    b = np.random.RandomState(2).randn(16, 4).astype(np.float32)
    want = jax_flops_of(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    got = profiling.flops_of(lambda x, y: x @ y, torch.from_numpy(a),
                             torch.from_numpy(b))
    assert got == want == 2 * 8 * 16 * 4
    assert profiling.flops_of(lambda: 1 / 0) is None


def test_trace_writes_the_files_fit_writes(tmp_path):
    x = torch.randn(4, 4)
    with profiling.trace(str(tmp_path), device="cpu"):
        (x @ x).sum()
    with open(tmp_path / "profile_summary.json") as f:
        summary = json.load(f)
    assert set(summary) == {"window_ms", "device_busy_ms",
                            "device_idle_share", "device_events",
                            "top_device_ops"}
    assert summary["device_events"] == 0 and summary["window_ms"] > 0
    assert (tmp_path / "trace.json").is_file()


# -- attribution -------------------------------------------------------------


def test_fwd_attribution_runs_and_derives_as_jax(monkeypatch, capsys):
    from hgr_tpu.tools import fwd_attribution as jax_tool

    given = {"full": 100.0, "bb": 40.0, "bb_proj": 45.5, "pose": 12.25,
             "cls": 0.5}
    out = _jax_main(jax_tool, ["--batch", "2", "--iters", "1"], monkeypatch,
                    list(given.values()))
    want = json.loads(out.strip().splitlines()[-1])
    got = fwd_attribution.derive(given, 2)
    assert list(got) == list(want)
    for k, v in want.items():
        assert round(got[k], 2) == v, k

    res = fwd_attribution.main(["--batch", "2", "--iters", "1",
                                "--image_size", "64", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(printed) == list(want)
    assert all(res[k] > 0 for k in given) and res["batch"] == 2


def test_bwd_attribution_runs_and_derives_as_jax(monkeypatch, capsys):
    from hgr_tpu.tools import bwd_attribution as jax_tool

    names = ("fwd_loss", "grad_full", "fwd_bb", "grad_bb", "grad_head",
             "grad_evalbn")
    given = dict(zip(names, (0.0305, 0.0991, 0.012, 0.0457, 0.051, 0.0862)))
    out = _jax_main(jax_tool, ["--batch", "2", "--iters", "1",
                               "--platform", "cpu"], monkeypatch,
                    list(given.values()))
    want = [json.loads(line) for line in out.strip().splitlines()]
    ms = {k: v * 1e3 for k, v in given.items()}
    derived = bwd_attribution.derive(ms)
    got = {**ms, **derived}
    assert [w["metric"] for w in want] == list(got)
    for w in want:
        assert round(got[w["metric"]], 2) == w["value"], w["metric"]

    bwd_attribution.main(["--batch", "2", "--iters", "1", "--platform",
                          "cpu", "--image_size", "64"])
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [x["metric"] for x in lines] == [w["metric"] for w in want]
    for x, w in zip(lines, want):
        assert x.keys() == w.keys() and x["unit"] == "ms"
        assert x["batch"] == 2 and x["device"] == "cpu"
    assert all(x["value"] > 0 for x in lines[:len(names)])


def test_grad_head_leaves_the_encoder_trainable():
    from hgr_tpu_torch.models import MultiTaskNet

    model = MultiTaskNet(image_size=(32, 32), dim=32, depth=1, heads=1,
                         mlp_dim=32, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0))
    fns = bwd_attribution.graphs(model, 2, torch.device("cpu"))
    _, grads = fns["grad_head"]()
    head = [p for n, p in model.named_parameters()
            if not n.startswith("encoder.")]
    assert len(grads) == len(head)
    assert all(p.requires_grad for p in model.parameters())


# -- serve_bench -------------------------------------------------------------


def _jax_result_expr():
    """The dict expression the JAX serve_bench's main builds its result
    from (hgr_tpu/tools/serve_bench.py)."""
    path = os.path.join(REPO, "hgr_tpu", "tools", "serve_bench.py")
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", "") == "result"):
            return compile(ast.Expression(node.value), path, "eval")
    raise AssertionError("no result dict in the JAX serve_bench")


def test_serve_metrics_and_result_match_the_jax_tool():
    from hgr_tpu.serve.engine import ServeMetrics as JaxServeMetrics
    from hgr_tpu_torch.serve.engine import ServeMetrics

    rng = np.random.RandomState(3)
    port, ref = ServeMetrics(), JaxServeMetrics()
    for n in (8, 3, 8, 5, 1):
        lat = list(rng.rand(n) * 0.02)
        nb = 8 if n > 4 else 4 if n > 2 else n
        port.record_batch(n, nb, lat)
        ref.record_batch(n, nb, lat)
    got, want = port.snapshot(), ref.snapshot()
    assert got.keys() == want.keys()
    for k in want:
        if k != "requests_per_s":  # each divides by its own elapsed time
            assert got[k] == want[k], k
    args = serve_bench.build_parser().parse_args(
        ["--requests", "25", "--clients", "3", "--bulk", "--window", "4"])
    snap = {**want, "wall_s": 0.5, "achieved_rps": 50.0}
    expected = eval(_jax_result_expr(), {"round": round},
                    {"args": args, "snap": snap, "bare_fwd_rps": 77.7})
    assert serve_bench.summarize(args, snap, 77.7) == expected


@pytest.mark.parametrize("extra", [
    [], ["--device_pool", "--bulk", "--window", "4"], ["--quantize"]])
def test_serve_bench_runs_end_to_end(extra, tmp_path):
    from hgr_tpu.serve.engine import ServeMetrics as JaxServeMetrics

    out = str(tmp_path / "r.json")
    result = serve_bench.main(
        ["--requests", "24", "--clients", "3", "--max_batch", "4",
         "--pipeline_depth", "2", "--image_size", "32", "--device", "cpu",
         "--out", out] + extra)
    ref = JaxServeMetrics()
    ref.record_batch(1, 1, [0.001])
    snap = {**ref.snapshot(), "wall_s": 1.0, "achieved_rps": 1.0}
    args = serve_bench.build_parser().parse_args(extra)
    keys = eval(_jax_result_expr(), {"round": round},
                {"args": args, "snap": snap, "bare_fwd_rps": 1.0}).keys()
    assert result.keys() == keys
    assert result["requests"] == 24 and result["errors"] == 0
    assert sum(int(k) * v for k, v in result["batch_hist"].items()) \
        >= 24
    assert result["quantized"] == ("--quantize" in extra)
    with open(out) as f:
        assert json.load(f)["achieved_rps"] == result["achieved_rps"]


# -- video_bench -------------------------------------------------------------


# the keys of hgr_tpu/tools/video_bench.py's result
VIDEO_KEYS = ["frames", "batch_frames", "decode_floor_fps", "serial_fps",
              "overlapped_fps", "speedup"]


def test_video_bench_runs_end_to_end(tmp_path):
    pytest.importorskip("cv2")
    from hgr_tpu.tools import video_bench as jax_tool

    d = video_bench.build_frames(3, 48, 64, str(tmp_path / "port"))
    want = jax_tool.build_frames(3, 48, 64, str(tmp_path / "jax"))
    for name in sorted(os.listdir(want)):
        assert (open(os.path.join(d, name), "rb").read()
                == open(os.path.join(want, name), "rb").read()), name
    results, batches = video_bench.run(video_bench.build_parser().parse_args(
        ["--frames", "2", "--batch", "2", "--h", "48", "--w", "64",
         "--workdir", str(tmp_path / "run"), "--device", "cpu"]))
    assert list(results) == VIDEO_KEYS
    assert batches == 4  # one batch of two frames, 2 depths x 2 runs
    assert all(results[k] > 0 for k in VIDEO_KEYS)


# -- gen_synthetic -----------------------------------------------------------


def test_gen_synthetic_chunked_layout(tmp_path):
    """As tests/test_utils_tools.py's test of the JAX tool: the chunks'
    JSON in the shared split directory, every image resolved from its
    chunk's stem."""
    from hgr_tpu_torch.config import DEFAULT_NAMES
    from hgr_tpu_torch.data.dataset import read_annotations

    out = str(tmp_path / "ds")
    gen_synthetic.generate(out, {"train": 10, "val": 4}, image_size=64,
                           chunk_size=4, workers=2, base_seed=0)
    idx = read_annotations(os.path.join(out, "annotations", "train"),
                           DEFAULT_NAMES)
    assert len(idx) == 10  # 4 + 4 + 2 across three chunk files
    assert all(os.path.isfile(s.image_path) for s in idx.samples)
    dirs = {os.path.dirname(s.image_path) for s in idx.samples}
    assert len(dirs) == 3
    idx_val = read_annotations(os.path.join(out, "annotations", "val"),
                               DEFAULT_NAMES)
    assert len(idx_val) == 4


def test_gen_synthetic_writes_the_jax_tools_files(tmp_path):
    """The same seed and chunking: the JAX tool's annotation JSON byte for
    byte and its pixels (the port encodes with PIL, the JAX writer with
    cv2 where it is installed)."""
    from hgr_tpu.tools.gen_synthetic import generate as jax_generate

    counts = {"train": 6, "val": 3}
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    gen_synthetic.generate(port, counts, image_size=48, chunk_size=4,
                           workers=2)
    jax_generate(ref, counts, image_size=48, chunk_size=4, workers=2)
    files = sorted(os.path.relpath(os.path.join(r, f), ref)
                   for r, _, fs in os.walk(ref) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), port)
                           for r, _, fs in os.walk(port) for f in fs)
    assert len(files) == 9 + 3
    for f in files:
        a, b = os.path.join(port, f), os.path.join(ref, f)
        if f.endswith(".json"):
            assert open(a, "rb").read() == open(b, "rb").read(), f
        else:
            np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                          np.asarray(Image.open(b)),
                                          err_msg=f)
    assert gen_synthetic.build_parser().parse_args(
        ["--out_dir", "x"]).__dict__ == {
        "out_dir": "x", "train": 102_400, "val": 10_240, "test": 10_240,
        "image_size": 192, "chunk_size": 10_240, "workers": 8, "seed": 0}


# -- bn_convergence_ab -------------------------------------------------------


def _arm(f1):
    return {"bn_dtype": "x", "epochs": [
        {"epoch": 0, "train_loss": 1.0, "val_loss": 2.0, "val_f1": f1,
         "val_pose_acc": 0.5}], "test_f1": f1}


def test_bn_convergence_ab_parses_as_jax():
    from hgr_tpu.tools import bn_convergence_ab as jax_tool

    out = ("epoch 0: train_loss=1.2500 val_loss=2.0000 val_f1=0.1000 "
           "val_pose_acc=0.3000\nepoch 1: train_loss=1.0000 "
           "val_loss=1.5000 val_f1=0.2500 val_pose_acc=0.4000\n"
           "Test F1 Score: 0.3125\n")
    got = bn_convergence_ab.parse_arm("f32", out)
    assert got["epochs"][1] == {"epoch": 1, "train_loss": 1.0,
                                "val_loss": 1.5, "val_f1": 0.25,
                                "val_pose_acc": 0.4}
    assert got["test_f1"] == 0.3125
    assert jax_tool.EPOCH_RE.pattern == bn_convergence_ab.EPOCH_RE.pattern
    assert jax_tool.TEST_RE.pattern == bn_convergence_ab.TEST_RE.pattern
    with pytest.raises(RuntimeError, match="could not parse"):
        bn_convergence_ab.parse_arm("f32", "epoch 0: train_loss=nan\n")


def test_bn_convergence_ab_one_real_arm(tmp_path):
    """The f32 arm through the port's training CLI at the smallest recipe,
    the bf16 arm read back from its JSON; the summary's keys are the JAX
    tool's."""
    out = tmp_path / "out"
    out.mkdir()
    (out / "bf16.json").write_text(json.dumps(_arm(0.125)))
    summary = bn_convergence_ab.main(
        ["--train_n", "8", "--val_n", "4", "--test_n", "4", "--epochs", "1",
         "--batch", "4", "--workdir", str(tmp_path / "work"), "--out",
         str(out), "--arms", "f32", "--image_size", "32", "--device", "cpu"])
    assert list(summary) == ["recipe", "test_f1_f32bn", "test_f1_bf16bn",
                             "final_val_f32bn", "final_val_bf16bn"]
    assert summary["test_f1_bf16bn"] == 0.125
    assert summary["final_val_bf16bn"] == _arm(0.125)["epochs"][-1]
    f32 = json.loads((out / "f32.json").read_text())
    assert summary["test_f1_f32bn"] == f32["test_f1"]
    assert summary["final_val_f32bn"] == f32["epochs"][-1]
    assert f32["bn_dtype"] == "float32" and f32["steps"] == 2
    assert set(f32["launches"]) >= {"attention_qkv_fwd", "warp_twopass"}
    assert json.loads((out / "summary.json").read_text()) == summary
