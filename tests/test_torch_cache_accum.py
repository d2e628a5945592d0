"""``--device_cache`` with ``--grad_accum`` under a {'data': 2} mesh: each
rank's ``ShardedDeviceCacheLoader(microbatches=a)`` yields its rows
``shard_rows(B, 2, r, a)`` of the JAX sharded cache's global batch (the
ranks' blocks in rank order, hgr_tpu/data/device_cache.py:413-549), as
the streaming loader does for the same step; the rows are exchanged
between the ranks' caches by one all_to_all a batch. Held bit for bit,
``valid`` included, over two epochs of an 11-sample split (shard 1 holds
5 real samples, so its blocks carry padded rows), and through the
training CLI over gloo on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

import helpers_torch_cache
from hgr_tpu.data import device_cache as jax_cache
from hgr_tpu.parallel import mesh as jax_mesh
from hgr_tpu_torch.cli import train as cli
from hgr_tpu_torch.parallel import mesh
from test_torch_data import (  # noqa: F401 — split is a fixture
    _assert_batches_equal,
    _epochs,
    _index_pair,
    split,
)
from test_torch_parallel import _argv, data_cfg  # noqa: F401 — a fixture

torch.set_num_threads(1)

# (name, batch size, microbatches): with a = 1 each rank yields its own
# block (no exchange); at B = 12, a = 3 the ranks send each other unequal
# row counts (rank 0 keeps 4 of its 6 rows and takes 2)
CASES = [("b4_a1", 4, 1), ("b4_a2", 4, 2), ("b12_a3", 12, 3)]
KW = dict(canvas_size=64, shuffle=True, seed=6, drop_last=False,
          num_workers=1, window_frac=0.75)


@pytest.fixture(scope="module")
def ranks(split, tmp_path_factory):
    cases = [dict(name=n, microbatches=a, kw=dict(KW, batch_size=b))
             for n, b, a in CASES]
    return helpers_torch_cache.spawn(
        split, cases, str(tmp_path_factory.mktemp("cache_accum")))


@pytest.mark.parametrize("name,batch,micro", CASES)
def test_rank_rows_equal_shard_rows_of_jax_global_batches(
        split, ranks, name, batch, micro):
    _, j_idx = _index_pair(split)
    ref = jax_cache.ShardedDeviceCacheLoader(
        j_idx, jax_mesh.make_mesh({"data": 2}), batch_size=batch, **KW)
    want = [{k: np.asarray(v) for k, v in b.items()}
            for b in _epochs(ref, 2)]
    assert sum(float(b["valid"].sum()) for b in want) == 2 * len(j_idx)
    assert any(not b["valid"].all() for b in want)  # padded rows occur
    for r in range(2):
        rows = mesh.shard_rows(batch, 2, r, micro)
        _assert_batches_equal(ranks[name][r],
                              [{k: v[rows] for k, v in b.items()}
                               for b in want])


def test_cli_device_cache_with_grad_accum_under_a_mesh(data_cfg, tmp_path):
    state, save = cli.run(cli.parse_args(_argv(
        tmp_path, "--epochs", "1", "--mesh", "data=2", "--device_cache",
        "--grad_accum", "2", "--host_device_count", "2")), data_cfg)
    assert state is None
    for r in range(2):
        with open(os.path.join(save, "ranks", f"rank{r}.json")) as f:
            assert json.load(f)["step"] == 2
    with open(os.path.join(str(tmp_path / "logs"), os.path.basename(save),
                           "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    epochs = [x for x in lines if "epoch" in x]
    assert len(epochs) == 1
    assert all(np.isfinite(x[k]) for x in epochs
               for k in ("train/total_loss", "val/total_loss"))
