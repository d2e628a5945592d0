"""The port's head-to-head tools (hgr_tpu_torch/tools/headtohead.py,
h2h_stats.py) on the CPU, held against the JAX tools.

``h2h_stats`` reads the committed finals of the reference and the JAX
package (bench_artifacts/headtohead_r{3,4,5}): its pairs and statistics
equal the JAX tool's on them, to the JAX tool's rounding. The round-5
finals were committed flat, where the JAX tool read them from per-seed
workdirs: the test rebuilds those workdirs for the JAX tool.
``headtohead`` writes the JAX tool's fixture (same YAML, same JPEG
bytes) and runs the port's training CLI once at a tiny recipe.
"""

import importlib
import json
import math
import os
import re
import shutil
import sys

import numpy as np
import pytest

from hgr_tpu_torch.tools import h2h_stats, headtohead

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "bench_artifacts")
R4 = os.path.join(ART, "headtohead_r4")
R5 = os.path.join(ART, "headtohead_r5")
SEEDS = ["7", "42", "43", "123", "256", "999", "1337"]
RUN = os.path.join("ours_logs", "gelans_192x192_h2h")


@pytest.mark.parametrize("name,dropped,extra", [
    ("headtohead", {"--ours_platform"}, {"--device", "--reference_metrics"}),
    ("h2h_stats", set(), {"--r5_dir"}),
])
def test_tool_keeps_the_jax_tools_flags(name, dropped, extra, capsys,
                                        monkeypatch):
    """The JAX tool's flags (from its --help: its parser is built inside
    main), its platform flag replaced by --device, plus the named
    extras."""
    module = importlib.import_module(f"hgr_tpu.tools.{name}")
    monkeypatch.setattr(sys, "argv", [module.__file__, "--help"])
    with pytest.raises(SystemExit):
        module.main()
    want = set(re.findall(r"(--\w+)", capsys.readouterr().out)) - {"--help"}
    port = importlib.import_module(f"hgr_tpu_torch.tools.{name}")
    got = {a for action in port.build_parser()._actions
           for a in action.option_strings if a.startswith("--")} - {"--help"}
    assert got == (want - dropped) | extra


def _jax_r5_workdirs(root):
    """The round-5 finals in the JAX tool's r5 layout (s{SEED}/
    reference_metrics.jsonl and its run's metrics.jsonl)."""
    for seed in ("256", "999"):
        d = root / f"s{seed}"
        (d / RUN).mkdir(parents=True)
        shutil.copy(os.path.join(R5, f"reference_seed{seed}.jsonl"),
                    d / "reference_metrics.jsonl")
        shutil.copy(os.path.join(R5, f"ours_demix_seed{seed}.jsonl"),
                    d / RUN / "metrics.jsonl")
    return str(root / "s*")


def test_collect_pairs_the_committed_finals_as_jax(tmp_path):
    from hgr_tpu.tools import h2h_stats as jax_tool

    want = jax_tool.collect(R4, _jax_r5_workdirs(tmp_path))
    got = h2h_stats.collect(R4, "", R5)
    assert sorted(want, key=int) == sorted(got, key=int) == SEEDS
    for seed in SEEDS:
        assert got[seed] == {"ref": want[seed]["ref"],
                             "jax": want[seed]["ours"]}
    assert h2h_stats.DOCUMENTED_REF == jax_tool.DOCUMENTED_REF


def _stats_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) and math.isnan(a[k]):
            assert math.isnan(b[k]), k
        else:
            assert a[k] == b[k], k


def test_paired_stats_reproduce_the_committed_statistics():
    """The committed pairs through the port's paired_stats give the JAX
    tool's committed r5 statistics exactly (its rounding of each final
    first, then the diffs)."""
    with open(os.path.join(ART, "r5", "h2h_stats.json")) as f:
        committed = json.load(f)
    pairs = h2h_stats.collect(R4, "", R5)
    for metric, i in (("f1", 0), ("pose", 1)):
        diffs = np.array([round(pairs[s]["jax"][i], 4)
                          - round(pairs[s]["ref"][i], 4)
                          for s in sorted(pairs, key=int)])
        assert h2h_stats.paired_stats(diffs) == committed[metric]


@pytest.mark.parametrize("n", [1, 2, 7])
def test_paired_stats_equal_jax(n):
    from hgr_tpu.tools import h2h_stats as jax_tool

    diffs = np.random.RandomState(n).randn(n) * 0.05
    _stats_equal(h2h_stats.paired_stats(diffs), jax_tool.paired_stats(diffs))


def test_h2h_stats_pairs_the_port_runs(tmp_path):
    """Port workdirs (s{SEED}/, the headtohead layout) for two seeds: one
    holding the JAX run's own curve (every port - JAX diff 0), one a
    curve whose finals differ; the rows and both statistics are the JAX
    tool's paired_stats of the rounded finals."""
    from hgr_tpu.tools import h2h_stats as jax_tool

    runs = {"7": os.path.join(R4, "demix", "ours_demix_seed7.jsonl"),
            "999": os.path.join(R4, "ours_f32_seed42.jsonl")}
    for seed, src in runs.items():
        (tmp_path / f"s{seed}" / RUN).mkdir(parents=True)
        shutil.copy(src, tmp_path / f"s{seed}" / RUN / "metrics.jsonl")
    (tmp_path / "s43").mkdir()  # a workdir without a run is skipped
    out = tmp_path / "stats.json"
    result = h2h_stats.main(["--r4_dir", R4, "--r5_dir", R5, "--r5_glob",
                             str(tmp_path / "s*"), "--out", str(out)])
    assert json.loads(out.read_text())["seeds"] == result["seeds"]
    assert [r["seed"] for r in result["seeds"]] == [7, 999]
    pairs = h2h_stats.collect(R4, "", R5)
    for row, seed in zip(result["seeds"], ("7", "999")):
        port = jax_tool._final(jax_tool._read_jsonl(runs[seed]), ref=False)
        assert row == {
            "seed": int(seed),
            "ref_f1": round(pairs[seed]["ref"][0], 4),
            "jax_f1": round(pairs[seed]["jax"][0], 4),
            "port_f1": round(port[0], 4),
            "ref_pose": round(pairs[seed]["ref"][1], 4),
            "jax_pose": round(pairs[seed]["jax"][1], 4),
            "port_pose": round(port[1], 4)}
    for other in ("ref", "jax"):
        for metric in ("f1", "pose"):
            diffs = np.array([r[f"port_{metric}"] - r[f"{other}_{metric}"]
                              for r in result["seeds"]])
            _stats_equal(result[f"port_minus_{other}"][metric],
                         jax_tool.paired_stats(diffs))
    assert "not the init draws" in result["pairing"]


def test_build_fixture_writes_the_jax_fixture(tmp_path, monkeypatch):
    """The same data YAML (but its path) and the same JSON and JPEG bytes
    as the JAX tool's fixture (its JPEGs through PIL, cv2 blocked)."""
    from hgr_tpu.tools import headtohead as jax_tool

    monkeypatch.setitem(sys.modules, "cv2", None)
    roots = {k: str(tmp_path / k) for k in ("port", "jax")}
    cfgs = {"port": headtohead.build_fixture(roots["port"], 3, 2, 2,
                                             image_size=48),
            "jax": jax_tool.build_fixture(roots["jax"], 3, 2, 2,
                                          image_size=48)}
    texts = {k: open(cfgs[k]).read().replace(roots[k], "ROOT")
             for k in cfgs}
    assert texts["port"] == texts["jax"]
    for split in ("train", "val", "test"):
        ann = os.path.join("annotations", split, f"{split}.json")
        with open(os.path.join(roots["port"], ann)) as f, \
                open(os.path.join(roots["jax"], ann)) as g:
            assert json.load(f) == json.load(g)
        names = sorted(os.listdir(os.path.join(roots["jax"], split)))
        assert names == sorted(os.listdir(os.path.join(roots["port"],
                                                       split)))
        for name in names:
            with open(os.path.join(roots["port"], split, name), "rb") as f, \
                    open(os.path.join(roots["jax"], split, name), "rb") as g:
                assert f.read() == g.read()


def test_run_ours_on_the_cpu(tmp_path):
    """One port run through the training CLI (8 / 4 / 4 images, 1 epoch,
    f32 at B = 4), its metrics.jsonl read by both tools' ``_final``, the
    summary's keys the JAX tool's, the reference's columns from a
    committed curve."""
    from hgr_tpu.tools import h2h_stats as jax_tool

    workdir = tmp_path / "s7"
    ref = os.path.join(R4, "reference_seed7.jsonl")
    summary = headtohead.main(
        ["--workdir", str(workdir), "--seed", "7", "--train_n", "8",
         "--val_n", "4", "--test_n", "4", "--epochs", "1", "--batch_size",
         "4", "--ours_dtype", "float32", "--device", "cpu",
         "--reference_metrics", ref])
    rows = h2h_stats._read_jsonl(str(workdir / RUN / "metrics.jsonl"))
    final = h2h_stats._final(rows, ref=False)
    assert final == jax_tool._final(rows, ref=False)
    assert final == (summary["ours"]["test_f1"],
                     summary["ours"]["test_pose_acc"])
    assert all(0.0 <= v <= 1.0 for v in final)
    assert list(summary) == ["reference", "ours",
                             "test_f1_delta_ours_minus_ref"]
    assert summary["reference"]["test_f1"] == jax_tool._final(
        jax_tool._read_jsonl(ref), ref=True)[0]
    table = (workdir / "headtohead_table.md").read_text()
    assert table.count("\n| 0 |") == 1
    assert json.loads((workdir / "headtohead_summary.json").read_text()) \
        == summary
