"""The port's full-HaGRID cache fit (hgr_tpu_torch/tools/hagrid_fit.py)
and its epoch script (torch_artifacts/hagrid_fit/epoch.py) on the CPU at
a small size, held against the JAX tool and the JAX sharded cache where
they have a counterpart: the flags, the bytes of a row and of every
shard, the global batch's layout, the ladder's handling of an
out-of-memory rung, and the epoch's report."""

import importlib.util
import json
import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from hgr_tpu_torch.tools import hagrid_fit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, CANVAS, DEVICES, BATCH = 1000, 32, 8, 64
SMALL_CHIP = ["--mode", "chip", "--n", str(N), "--canvas", str(CANVAS),
              "--devices", str(DEVICES), "--batch", "8", "--iters", "1",
              "--device", "cpu"]


def _virtual(*extra):
    return hagrid_fit.main(
        ["--mode", "virtual", "--n", str(N), "--canvas", str(CANVAS),
         "--devices", str(DEVICES), "--batch", str(BATCH), "--device", "cpu",
         *extra])


def test_tool_keeps_the_jax_tools_flags(capsys, monkeypatch):
    """The JAX tool's flags (from its --help) without --donate, plus
    --device and --out."""
    from hgr_tpu.tools import hagrid_fit as jax_tool

    monkeypatch.setattr(sys, "argv", [jax_tool.__file__, "--help"])
    with pytest.raises(SystemExit):
        jax_tool.main()
    want = set(re.findall(r"(--\w+)", capsys.readouterr().out)) - {"--help"}
    got = {a for action in hagrid_fit.build_parser()._actions
           for a in action.option_strings if a.startswith("--")} - {"--help"}
    assert got == (want - {"--donate"}) | {"--device", "--out"}
    assert hagrid_fit.HAGRID_N == jax_tool.HAGRID_N == 410_800


@pytest.mark.parametrize("cs", [CANVAS, 192])
def test_row_bytes_equal_the_jax_flat_layout(cs):
    from hgr_tpu.data import device_cache

    want = sum(flat * np.dtype(dt).itemsize for flat, _, dt
               in device_cache._flat_shapes(1, cs, 21).values())
    assert hagrid_fit.row_bytes(cs) == want
    if cs == 192:
        assert want == 110_880


def _jax_sharded_loader(monkeypatch):
    """The JAX package's ShardedDeviceCacheLoader at N rows, canvas
    CANVAS, over the 8 host devices, built with no fill."""
    from hgr_tpu.data import device_cache
    from hgr_tpu.data.dataset import AnnotationIndex, Sample
    from hgr_tpu.parallel.mesh import make_mesh

    def fill(loader, cache, write, spec, n, mesh=None):
        return cache, False  # the allocation is what is counted

    monkeypatch.setattr(device_cache, "_fill_cache", fill)
    index = AnnotationIndex(
        samples=[Sample(image_path=f"mem://{i}", label=f"c{i % 19}",
                        landmark=[]) for i in range(N)],
        names={f"c{i}": i for i in range(19)})
    loader = device_cache.ShardedDeviceCacheLoader(
        index, make_mesh({"data": DEVICES}), batch_size=BATCH,
        canvas_size=CANVAS, shuffle=True, num_workers=0)
    loader._build_cache()
    return loader


def test_shard_bytes_and_global_batch_equal_the_jax_sharded_cache(
        monkeypatch):
    """Per shard, the port's bytes equal the JAX cache's addressable
    shards' at the same geometry, and the port's blocks in rank order
    name the JAX loader's first global batch (as global rows)."""
    jax_loader = _jax_sharded_loader(monkeypatch)
    per_dev = np.zeros(DEVICES, np.int64)
    for v in jax_loader._cache.values():
        for sh in v.addressable_shards:
            per_dev[sh.device.id] += sh.data.nbytes
    report = _virtual()
    assert report["per_device_bytes"] == per_dev.tolist()
    assert report["total_cache_gb"] == round(per_dev.sum() / 2**30, 2)

    jax_loader._epoch = 0
    idx, valid = next(jax_loader._epoch_plan())
    n_local = jax_loader.n_local
    want = idx.astype(np.int64) + np.repeat(
        np.arange(DEVICES) * n_local, BATCH // DEVICES)
    rows, valids = [], []
    for s in range(DEVICES):
        shard = hagrid_fit.VirtualShard(
            hagrid_fit.geometry_index(N), batch_size=BATCH, shard_index=s,
            shard_count=DEVICES, canvas_size=CANVAS, shuffle=True,
            num_workers=0, device="cpu")
        ids, v = next(shard._epoch_plan())
        rows.append(shard.lo + ids)
        valids.append(v)
    np.testing.assert_array_equal(np.concatenate(rows), want)
    np.testing.assert_array_equal(np.concatenate(valids), valid)


def test_virtual_mode_holds_its_invariants_at_shard_edges(monkeypatch):
    """40-row blocks at both edges of every shard (125 rows each): 16
    blocks, every written row read back, equal shards of the nominal
    size, a global batch of BATCH rows."""
    monkeypatch.setattr(hagrid_fit, "BLOCK_BYTES", 40 * CANVAS * CANVAS * 3)
    report = _virtual()
    row = hagrid_fit.row_bytes(CANVAS)
    assert report["row_bytes"] == row == 3360
    assert report["per_device_bytes"] == [row * 125] * DEVICES
    assert report["filled_blocks"] == 2 * DEVICES
    assert report["boundary_rows_checked"] == 2 * DEVICES * 40
    assert report["batch_canvas_shape"] == [BATCH, CANVAS, CANVAS, 3]
    assert report["valid_sum_first_batch"] == BATCH
    assert report["batches_iterated"] == 3
    assert report["batch_keys"] == sorted(
        ["canvas", "orig_to_canvas", "sizes_hw", "joints", "joints_vis",
         "label", "valid"])
    assert report["gather_ms_per_batch"] >= 0


def test_virtual_mode_fails_on_a_row_that_does_not_read_back(monkeypatch):
    """One byte changed on its way to the cache fails the tool."""
    real = hagrid_fit.VirtualShard._random_fill

    def corrupted(self, write, spec):
        def bad(block, start):
            block = {k: v.copy() for k, v in block.items()}
            block["canvas"][0, 0] ^= 1
            write(block, start)
        real(self, bad, spec)

    monkeypatch.setattr(hagrid_fit.VirtualShard, "_random_fill", corrupted)
    with pytest.raises(AssertionError, match="shard 0"):
        _virtual()


def _inject(monkeypatch, raising):
    """A 32 px model whose steps of ``grad_accum`` a raise
    ``raising[a][0]`` from their call number ``raising[a][1]`` on."""
    monkeypatch.setattr(hagrid_fit, "IMAGE_SIZE", 32)
    real = hagrid_fit.make_train_step

    def make(*args, grad_accum=1, **kw):
        step = real(*args, grad_accum=grad_accum, **kw)
        calls = []

        def maybe_raising(*a):
            calls.append(1)
            if grad_accum in raising and len(calls) > raising[grad_accum][1]:
                raise raising[grad_accum][0]
            return step(*a)
        return maybe_raising

    monkeypatch.setattr(hagrid_fit, "make_train_step", make)


def test_chip_mode_records_an_oom_rung_and_runs_the_next(monkeypatch):
    """The first rung's step runs out of memory: recorded as not fitting,
    the next rung (accum 4) fits; its headroom probe stops where the
    step beside the second slab runs out of memory, counting the one
    slab beside which a step ran."""
    oom = torch.cuda.OutOfMemoryError
    _inject(monkeypatch, {2: (oom("injected OOM"), 0),
                          4: (oom("probe OOM"), 3)})
    monkeypatch.setattr(hagrid_fit, "SLAB_BYTES", 1024)
    report = hagrid_fit.main(SMALL_CHIP + ["--probe_headroom"])
    first, second = report["ladder"]
    assert report["n_local_rows"] == 125
    assert first == {"canvas": CANVAS, "grad_accum": 2, "fits": False,
                     "error": "injected OOM"}
    assert second["fits"] and second["grad_accum"] == 4
    assert math.isfinite(second["loss"]) and second["steps"] == 2
    assert second["ballast_gb"] == round(125 * 3360 / 2**30, 2)
    assert second["probe_steps"] == 1 and not second["probe_lower_bound"]
    assert second["probed_headroom_gb"] == 1024 / 2**30
    assert "probe OOM" in second["probe_stopped_by"]


def test_chip_mode_propagates_other_errors(monkeypatch):
    _inject(monkeypatch, {2: (ValueError("not a memory error"), 0)})
    with pytest.raises(ValueError, match="not a memory error"):
        hagrid_fit.main(SMALL_CHIP)


def test_epoch_script_arms_report_time_wait_and_memory(tmp_path,
                                                       monkeypatch):
    """epoch.py at a tiny size: both arms run one epoch of fit from the
    filled caches and report their time, loader-wait share, val time,
    memory fields and control; the checks pass and the rule reads no
    fault."""
    path = os.path.join(REPO, "torch_artifacts", "hagrid_fit", "epoch.py")
    spec = importlib.util.spec_from_file_location("hagrid_epoch", path)
    epoch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(epoch)
    for name, value in (("CONTROL_WARMUP", 1), ("BATCH", 8), ("CANVAS", 32),
                        ("IMAGE_SIZE", 32)):
        monkeypatch.setattr(epoch, name, value)
    # fit's logger writes its JSON lines without TensorBoard (whose import
    # brings in TensorFlow here)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = tmp_path / "out"
    report = epoch.main([
        "--out", str(out), "--work", str(tmp_path / "work"), "--n_train",
        "24", "--n_val", "8", "--control_n", "16", "--control_steps", "1",
        "--device", "cpu"])
    assert report == json.loads((out / "epoch.json").read_text())
    assert report["fill"]["train"]["rows"] == 24
    assert report["fill"]["row_bytes"] == 3360
    assert report["checks"]["train_rows"]["read_back"]
    assert report["checks"]["val_rows"]["read_back"]
    assert report["checks"]["first_batch"]
    assert not report["rule"]["fault"]
    for name, fused in (("off", False), ("on", True)):
        arm = report["arms"][name]
        assert arm["fused_bn"] is fused and arm["steps"] == 3
        assert arm["train_time_s"] > 0 and arm["val_time_s"] >= 0
        assert arm["train_samples"] == 24 and arm["val_samples"] == 8
        assert 0 <= arm["loader_wait_share"] < 1
        assert arm["loader_wait_share"] == pytest.approx(
            arm["loader_wait_s"] / arm["train_time_s"])
        for key in ("max_memory_allocated_gb", "memory_reserved_gb",
                    "mem_free_gb", "mem_total_gb"):
            assert key in arm
        assert arm["control"]["steps"] == 1
        assert arm["control"]["ms_per_step"] > 0
        lines = (out / f"fused_{name}.metrics.jsonl").read_text().splitlines()
        assert json.loads(lines[-1])["train_time_s"] == arm["train_time_s"]
