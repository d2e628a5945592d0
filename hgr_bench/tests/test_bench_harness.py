"""The harness's plumbing on the CPU: discovery by name, the names and
units of ``BENCHMARK.json``, which cells report which metrics, the
refusal to run without a card, the shape of the last line, and the
modules the benchmark may import."""

import ast
import json
import re
import subprocess
import sys

import pytest
import torch

from hgr_bench import harness, run

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_discovery_by_name():
    for w in BENCH["workloads"]:
        work, cfg, tr = harness.cell(BENCH, w["name"])
        assert work is w and cfg["name"] == w["config"]
        assert callable(harness.driver(tr))
        for key in ("why", "limits"):
            assert key in tr
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
    with pytest.raises(KeyError):
        harness.cell(BENCH, "no.such.cell")
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.train")


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert c["file"].startswith("hgr_bench/")
        assert harness.load_json(harness.REPO / c["file"])["reduced"] == \
            c["reduced"]
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text


def test_each_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m
        for w in m.get("workloads", [x["name"] for x in BENCH["workloads"]]):
            reported = [x["name"] for x in harness.cell_metrics(
                BENCH, w, "end_to_end")]
            assert m["moves"] in reported, (m["name"], w)
    for w in BENCH["workloads"]:
        assert len(harness.cell_metrics(BENCH, w["name"], "end_to_end")) >= 2
        assert harness.cell_metrics(BENCH, w["name"], "per_layer")
        assert w["chips"] == 1


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed",
                   str(2**31 + 7), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def _fake(trace: bool, checks):
    ctx = harness.Ctx(BENCH["workloads"][1], {}, {}, 1, 1.0, trace,
                      torch.device("cpu"), 0.0)
    summary = {"busy_s": 0.5, "window_s": 1.0, "kernels": {},
               "device_ops": [["k", 0.4]], "idle_gaps": [["op", 0.01]]}
    out = harness.Outcome(
        attempted=10, failed=0,
        metrics={"detect_frames_per_s": 900.0, "setup_s": 30.0},
        checks=checks, record={"trace": summary, "serve": (
            {"requests": 0, "batches": 0}, {"requests": 640, "batches": 10}),
            "max_batch": 64, "window_s": 1.0, "frames": 640, "p95_ms": 180.0,
            "forward_flops": 1e10}, memory_peak_bytes=1 << 30)
    return harness.result_line(BENCH, ctx, out, "NVIDIA H100 80GB HBM3", 1)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_shape(trace):
    line = _fake(trace, {"det_score": (0.01, 0.05)})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] == 1 << 30
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["metrics"]["batch_fill.detect"]["value"] == 100.0
        assert line["metrics"]["request_p95_ms.detect"]["value"] == 180.0
        assert "detect_frames_per_s" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"detect_frames_per_s", "setup_s"}
    json.dumps(line)


@pytest.mark.parametrize("checks", [{"det_score": (0.2, 0.05)},
                                    {"det_score": (float("nan"), 0.05)}, {}])
def test_not_correct(checks):
    assert _fake(False, checks)["correct"] is False


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_imports_no_jax_and_reference_nothing_of_the_package():
    files = sorted(harness.ROOT.rglob("*.py"))
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "hgr_tpu"}, path
        if "reference" in path.parts:
            assert "hgr_tpu_torch" not in tops, path


def test_forbidden_modules_by_whole_top_level_name():
    code = ("import sys, types; sys.modules['hgr_tpu_torchx'] = "
            "types.ModuleType('x'); from hgr_bench import harness; "
            "import hgr_tpu_torch.config; "
            "print(harness.forbidden_modules()); "
            "sys.modules['hgr_tpu.x'] = types.ModuleType('y'); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.REPO, check=True).stdout
    assert out.split("\n")[:2] == ["[]", "['hgr_tpu.x']"]


@pytest.mark.gpu
def test_a_cell_on_the_card():
    """One short run of the first cell on the card, through the command
    line (on the card: python -m pytest -m gpu hgr_bench/tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = BENCH["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "-m", "hgr_bench.run", "--workload", w, "--seed",
         str(2**31 + 11), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.REPO, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().split("\n")[-1])["correct"]
