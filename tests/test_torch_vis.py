"""The port's debug images and inspection tools (hgr_tpu_torch/utils/
vis.py, the debug dumps of train/loop.py and cli/train.py,
tools/display_data.py, tools/extract_data.py) held against the JAX
package's on the same numpy inputs.

Tolerances and why:
- the joint grids and heatmap strips are host numpy and cv2 on the same
  arrays: equal exactly;
- the attention strip and the display sheet upsample in f32 (XLA's dot
  against torch's einsum, sums in another order), so a value at a
  rounding boundary of its uint8 level may land one level apart: the
  attention levels within 1 (and the strip equal wherever they agree;
  a level apart moves a jet color by up to 4, half of it through the
  0.5 blend), the display sheet within 1 (the 0.2 blend);
- extract_data: the landmarks to 1e-6 (f32 affine solves), and the crops
  byte for byte (the same cv2 warp and encoder on the same affine).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgr_tpu.ops.resize import upsample_bilinear_align_corners
from hgr_tpu.train import loop as jax_loop
from hgr_tpu.utils import vis as jax_vis
from hgr_tpu_torch.cli import train as cli
from hgr_tpu_torch.config import DEFAULT_NAMES, DataConfig, TrainConfig
from hgr_tpu_torch.data.synthetic import write_synthetic_split
from hgr_tpu_torch.utils import vis

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(1)

B, IMAGE, J, HEADS = 4, 64, 21, 8
FEAT = IMAGE // 16


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    n = FEAT * FEAT + 1
    logits = rng.randn(B, HEADS, n, n).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {
        "image": rng.randn(B, IMAGE, IMAGE, 3).astype(np.float32),
        "label": rng.randint(0, 19, B).astype(np.int32),
        "pred_label": rng.randint(0, 19, B).astype(np.int32),
        "joints": rng.uniform(0, IMAGE, (B, J, 2)).astype(np.float32),
        "target_weight": (rng.rand(B, J) > 0.2).astype(np.float32),
        "target": rng.rand(B, J, IMAGE // 4, IMAGE // 4).astype(np.float32),
        "heatmap": (rng.rand(B, J, IMAGE // 4, IMAGE // 4) * 1.2 - 0.1)
        .astype(np.float32),
        "attnmap": attn.astype(np.float32),
    }


def _captured(monkeypatch, module):
    """Route ``module._imwrite`` into a dict: file name -> array."""
    got = {}
    monkeypatch.setattr(module, "_imwrite",
                        lambda path, img: got.__setitem__(
                            os.path.basename(path), img.copy()))
    return got


def test_debug_images_match_jax_vis(monkeypatch):
    outputs = _arrays()
    want, got = _captured(monkeypatch, jax_vis), _captured(monkeypatch, vis)
    jax_vis.save_debug_images(outputs, "d/x", with_attention=True)
    vis.save_debug_images({k: torch.from_numpy(v) for k, v in
                           outputs.items()}, "d/x", with_attention=True)
    assert set(got) == set(want) == {
        f"x_{k}.jpg" for k in ("gt", "pred", "hm_gt", "hm_pred", "attn")}
    for name in ("x_gt.jpg", "x_pred.jpg", "x_hm_gt.jpg", "x_hm_pred.jpg"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the attention levels by JAX's arithmetic (hgr_tpu/utils/vis.py:
    # 125-141): within a level of the port's; where they agree, so does
    # every pixel of the strip
    attn = outputs["attnmap"]
    cls_attn = attn.mean(axis=1)[:, 0, 1:].reshape(B, FEAT, FEAT)
    up = np.asarray(upsample_bilinear_align_corners(
        jnp.asarray(cls_attn)[..., None], 4))[..., 0]
    want_levels = np.stack([((a - a.min()) / (a.max() - a.min() + 1e-8)
                             * 255).astype(np.uint8) for a in up])
    levels = vis.attention_levels(torch.from_numpy(attn))
    diff = np.abs(levels.astype(int) - want_levels.astype(int))
    assert diff.max() <= 1, diff.max()
    same = np.concatenate(list(diff == 0), axis=1)
    assert same.mean() > 0.9, same.mean()
    assert got["x_attn.jpg"].shape == want["x_attn.jpg"].shape
    np.testing.assert_array_equal(got["x_attn.jpg"][same],
                                  want["x_attn.jpg"][same])


def test_no_attention_dump_without_a_map(monkeypatch):
    outputs = dict(_arrays(1), attnmap=None)
    got = _captured(monkeypatch, vis)
    vis.save_debug_images(outputs, "y", with_attention=True)
    assert set(got) == {f"y_{k}.jpg" for k in ("gt", "pred", "hm_gt",
                                              "hm_pred")}


def _jax_cadence(n_steps, debug_every, start_step=0):
    """The steps at which the JAX loop's train_epoch fires its debug hook
    over ``n_steps`` batches (a stand-in step that only counts)."""
    fired = []
    state = types.SimpleNamespace(step=start_step)

    def step_fn(st, batch, key):
        return types.SimpleNamespace(step=st.step + 1), {
            "total_loss": np.float32(0.0)}

    metrics = types.SimpleNamespace(loader_wait_s=0.0,
                                    update=lambda m: None)
    jax_loop.train_epoch(state, step_fn, [{"x": np.zeros(1)}] * n_steps,
                         jax.random.PRNGKey(0), metrics,
                         debug_hook=lambda st, b, s: fired.append(s),
                         debug_every=debug_every)
    return fired


@pytest.fixture(scope="module")
def data_cfg(tmp_path_factory):
    """12 train and 4 val/test images of 64 px: 3 train steps at B = 4."""
    root = str(tmp_path_factory.mktemp("vis_data"))
    for i, (s, n) in enumerate((("train", 12), ("val", 4), ("test", 4))):
        write_synthetic_split(root, s, n, image_size=64, seed=i)
    return DataConfig(path=root, names=dict(DEFAULT_NAMES))


KINDS = ("gt", "pred", "hm_gt", "hm_pred")


def _want_files(train_steps, epochs):
    files = {f"train_{s}_{k}.jpg" for s in train_steps for k in KINDS}
    return files | {f"val_{e}_{k}.jpg" for e in range(epochs)
                    for k in KINDS + ("attn",)}


def test_fit_debug_images_follow_the_jax_cadence(data_cfg, tmp_path):
    from hgr_tpu_torch.config import ModelConfig
    from hgr_tpu_torch.data.dataset import read_annotations
    from hgr_tpu_torch.data.loader import BatchLoader
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.train import loop
    from hgr_tpu_torch.train.state import create_train_state

    def loader(split, shuffle):
        idx = read_annotations(os.path.join(data_cfg.path,
                                            data_cfg.__dict__[split]),
                               data_cfg.names)
        return BatchLoader(idx, batch_size=B, canvas_size=48,
                           shuffle=shuffle, drop_last=False, num_workers=1)

    model = MultiTaskNet(image_size=(32, 32), dim=32, depth=1, heads=2,
                         mlp_dim=32,
                         generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, device="cpu")
    save = str(tmp_path / "run")
    loop.fit(ModelConfig(image_size=(32, 32)),
             TrainConfig(epochs=2, batch_size=B, debug_every=2), data_cfg,
             state, loader("train", True), loader("val", False),
             save_path=save, log_dir=str(tmp_path / "logs"), run_name="r",
             debug_images=True)
    steps = _jax_cadence(3, 2) + _jax_cadence(3, 2, start_step=3)
    assert steps == [1, 3, 4, 6]
    assert set(os.listdir(os.path.join(save, "debug"))) == _want_files(
        steps, 2)


def test_cli_debug_images_follow_the_jax_cadence(data_cfg, tmp_path):
    """``--debug_images`` through the CLI: the default cadence of 100 dumps
    the first batch of each epoch (and the val batch after it)."""
    args = cli.parse_args([
        "--data_config", "x", "--batch_size", str(B), "--epochs", "2",
        "--image_size", "32", "32", "--canvas_size", "48", "--dtype",
        "float32", "--num_workers", "1", "--device", "cpu",
        "--debug_images", "--save_dir", str(tmp_path / "out"),
        "--log_dir", str(tmp_path / "logs")])
    _, save = cli.run(args, data_cfg)
    assert TrainConfig().debug_every == 100
    steps = _jax_cadence(3, 100) + _jax_cadence(3, 100, start_step=3)
    assert steps == [1, 4]
    assert set(os.listdir(os.path.join(save, "debug"))) == _want_files(
        steps, 2)


# -- the tools ---------------------------------------------------------------


def _yaml_config(tmp_path):
    import yaml

    root = str(tmp_path / "ds")
    write_synthetic_split(root, "train", 8, image_size=96, seed=0)
    cfg = {"path": root, "train": "annotations/train",
           "val": "annotations/train", "test": "annotations/train",
           "num_joints": 21, "num_classes": 19,
           "names": dict(DEFAULT_NAMES),
           "augments": {"rotate_factor": 10, "scale_factor": 0.2,
                        "translate_factor": 0.02, "horizontal_flip": True,
                        "color_jittering": True}}
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return path


def test_display_data_writes_the_jax_tools_files(tmp_path):
    """The JAX tool's test (tests/test_utils_tools.py): 8 images, 64 px
    crops, a batch of 4, one batch -> 4 sheets."""
    from hgr_tpu_torch.tools.display_data import display_data

    out_dir = str(tmp_path / "sheets")
    n = display_data(_yaml_config(tmp_path), out_dir, image_size=(64, 64),
                     batch_size=4, num_batches=1, device="cpu")
    assert n == 4
    assert sorted(os.listdir(out_dir)) == [f"sample_0_{j}.jpg"
                                           for j in range(4)]


def test_display_sheets_match_jax_arithmetic():
    """The sheets of one augment output against the JAX tool's arithmetic
    on the same output (hgr_tpu/tools/display_data.py:62-80)."""
    from hgr_tpu.utils.draw import draw_bones, draw_joints
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.tools.display_data import augment_batch, contact_sheets
    from test_torch_train import _staged_batch

    images, joints, targets = augment_batch(
        _staged_batch(seed=3), AugmentConfig(),
        torch.Generator().manual_seed(0), (48, 48), 2.0)
    got = contact_sheets(images, joints, targets)
    assert len(got) == B
    imgs = jax_vis._unnormalize(images)
    hm = np.asarray(upsample_bilinear_align_corners(
        jnp.transpose(jnp.asarray(targets), (0, 2, 3, 1)), 4))
    for j in range(B):
        img = np.clip(imgs[j] * 255, 0, 255).astype(np.uint8).copy()
        lm = joints[j].astype(np.int32)
        img = draw_joints(draw_bones(img, lm), lm)
        heat = jax_vis._colormap_jet(
            np.clip(hm[j].max(axis=-1) * 255, 0, 255).astype(np.uint8))
        want = (img * 0.8 + heat * 0.2).astype(np.uint8)
        diff = np.abs(got[j].astype(int) - want.astype(int))
        assert diff.max() <= 1, (j, diff.max())


def _extract(extractor_cls, estimator, root, out):
    extractor_cls(root, out, estimator=estimator,
                  num_workers=2).extract("annotations/train")


@pytest.mark.parametrize("region", [(24, 24, 48, 48), (0, 0, 8, 8)])
def test_extract_data_matches_jax(tmp_path, region):
    """The fake estimator and raw layout of tests/test_extract_tool.py:
    landmarks that match the box (IoU > 0.5) and ones that do not."""
    from hgr_tpu.tools.extract_data import HagridDataExtractor as JaxExtractor
    from hgr_tpu_torch.tools.extract_data import (
        HagridDataExtractor,
        calculate_iou,
    )
    from test_extract_tool import FakeEstimator, _make_raw_hagrid

    root = str(tmp_path / "raw")
    _make_raw_hagrid(root)
    _extract(JaxExtractor, FakeEstimator(region), root, str(tmp_path / "j"))
    _extract(HagridDataExtractor, FakeEstimator(region), root,
             str(tmp_path / "p"))
    assert calculate_iou([0, 0, 10, 10], [5, 0, 10, 10]) == 1 / 3
    for g in ("call", "like"):
        rel = os.path.join("annotations", "train", f"{g}.json")
        with open(tmp_path / "j" / rel) as f:
            want = json.load(f)
        with open(tmp_path / "p" / rel) as f:
            got = json.load(f)
        assert got.keys() == want.keys() and len(got) == 3
        for img_id, rec in want.items():
            assert got[img_id]["label"] == rec["label"]
            np.testing.assert_allclose(
                np.asarray(got[img_id]["landmark"]).reshape(-1, 2),
                np.asarray(rec["landmark"]).reshape(-1, 2), atol=1e-6)
            crop = os.path.join(g, img_id + ".jpg")
            with open(tmp_path / "j" / crop, "rb") as f:
                want_bytes = f.read()
            with open(tmp_path / "p" / crop, "rb") as f:
                assert f.read() == want_bytes, crop
