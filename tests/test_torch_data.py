"""The port's host data path (hgr_tpu_torch/data: dataset, staging,
native binding, loader, synthetic writer, device cache and its disk
snapshot) held against the JAX package's, on the CPU.

Both loaders read the same files; batches must agree exactly (same keys,
dtypes, shuffle, tail padding and ``valid``). Decode routes are pinned on
both sides: the native library (built from native/hgr_native.cpp by each
package), PIL (the JAX package's route once the native library and cv2
are unavailable), or the JAX package's cv2 route (cv2.imread and
cv2.resize) against the port's PIL decode and its numpy copy of cv2's
bilinear resize.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from hgr_tpu.config import AugmentConfig as JaxAugmentConfig
from hgr_tpu.data import dataset as jax_dataset
from hgr_tpu.data import device_cache as jax_cache
from hgr_tpu.data import loader as jax_loader
from hgr_tpu.data import native as jax_native
from hgr_tpu.data import pipeline as jax_pipeline
from hgr_tpu.data import synthetic as jax_synthetic
from hgr_tpu_torch.config import AugmentConfig, DEFAULT_NAMES
from hgr_tpu_torch.data import dataset, device_cache, loader, native
from hgr_tpu_torch.data import pipeline, synthetic

torch.set_num_threads(1)

N_TRAIN, BATCH, CANVAS, SIZE = 11, 4, 64, 80


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A synthetic split written by the port (PIL JPEGs): its annotation
    directory."""
    root = tmp_path_factory.mktemp("data")
    return synthetic.write_synthetic_split(str(root), "train", N_TRAIN,
                                           image_size=SIZE, seed=3)


def _index_pair(ann_dir):
    return (dataset.read_annotations(ann_dir, DEFAULT_NAMES),
            jax_dataset.read_annotations(ann_dir, DEFAULT_NAMES))


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_batches_equal(port_batches, jax_batches):
    assert len(port_batches) == len(jax_batches)
    for pb, jb in zip(port_batches, jax_batches):
        assert pb.keys() == jb.keys()
        for k in jb:
            p, j = _np(pb[k]), _np(jb[k])
            assert p.dtype == j.dtype, k
            np.testing.assert_array_equal(p, j, err_msg=k)


def _no_native(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "decode_jpeg_bgr", lambda path: None)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "decode_jpeg_bgr", lambda path: None)


def _pil_only(monkeypatch):
    """Both packages decode with PIL: no native library, no cv2."""
    _no_native(monkeypatch)
    monkeypatch.setitem(sys.modules, "cv2", None)


def _native_or_skip():
    if not (native.available() and jax_native.available()):
        pytest.skip("the native library does not build here (needs g++ and "
                    "libjpeg headers)")


# -- staging -----------------------------------------------------------------


@pytest.mark.parametrize("hw,canvas", [((224, 224), 256), ((300, 180), 256),
                                       ((97, 61), 64), ((600, 500), 256),
                                       ((40, 33), 32), ((1440, 1920), 256),
                                       ((1920, 1080), 256)])
def test_stage_image_bit_for_bit(hw, canvas):
    """Canvas, affine and size exactly. All but the first two cases
    downscale the window, which the JAX package does with cv2 (it imports
    here) and the port with its numpy copy of cv2's bilinear resize; the
    last two are HaGRID frame sizes (a 1436 px window into 256)."""
    pytest.importorskip("cv2")
    img = np.random.RandomState(sum(hw)).randint(0, 256, hw + (3,)).astype(
        np.uint8)
    frac = pipeline.staging_window_fraction(AugmentConfig())
    got = pipeline.stage_image(img, canvas, frac)
    want = jax_pipeline.stage_image(img, canvas, frac)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype and got[2] == want[2]


@pytest.mark.parametrize("src_hw,out_hw,channels", [
    ((1436, 1077), (256, 192), 3),  # a HaGRID window into the canvas
    ((512, 300), (256, 150), 3),  # exactly half: cv2 takes its area path
    ((700, 3), (256, 1), 3),  # one output column
    ((3, 700), (1, 256), 3),
    ((97, 73), (64, 48), 4),
    ((333, 257), (255, 197), 3),  # barely downscaled
])
def test_host_resize_matches_cv2(src_hw, out_hw, channels):
    """The port's resize against cv2.resize(INTER_LINEAR) itself, on a
    window view (strided rows) as ``stage_image`` passes it."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(sum(src_hw))
    big = rng.randint(0, 256, (src_hw[0] + 5, src_hw[1] + 9, channels))
    img = big.astype(np.uint8)[2:2 + src_hw[0], 4:4 + src_hw[1]]
    want = cv2.resize(img, out_hw[::-1], interpolation=cv2.INTER_LINEAR)
    got = pipeline._host_resize(img, out_hw)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("kw", [{}, {"translate_factor": 0.1},
                                {"scale_factor": 0.8},
                                {"translate_factor": 0.3,
                                 "scale_factor": 1.0}])
def test_staging_window_fraction_matches_jax(kw):
    assert (pipeline.staging_window_fraction(AugmentConfig(**kw))
            == jax_pipeline.staging_window_fraction(JaxAugmentConfig(**kw)))


# -- annotations and the synthetic writer ------------------------------------


def test_read_annotations_matches_jax(split):
    p, j = _index_pair(split)
    assert len(p) == len(j) == N_TRAIN
    for a, b in zip(p.samples, j.samples):
        assert (a.image_path, a.label, a.landmark) == (
            b.image_path, b.label, b.landmark)
    np.testing.assert_array_equal(p.labels(), j.labels())
    assert p.labels().dtype == j.labels().dtype


def test_read_annotations_raises_without_json(tmp_path):
    with pytest.raises(FileNotFoundError):
        dataset.read_annotations(str(tmp_path), DEFAULT_NAMES)


@pytest.mark.parametrize("size", [64, 224])
def test_synthetic_image_matches_jax(size):
    got = synthetic.make_hand_image(np.random.RandomState(size), size,
                                    blob_color=[10, 200, 90])
    want = jax_synthetic.make_hand_image(np.random.RandomState(size), size,
                                         blob_color=[10, 200, 90])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_synthetic_annotations_match_jax(tmp_path, monkeypatch):
    """Same JSON and JPEG bytes as the JAX writer for a seed (its JPEGs go
    through PIL here too, cv2 blocked)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    a = synthetic.write_synthetic_split(str(tmp_path / "p"), "val", 18,
                                        image_size=48, seed=5)
    b = jax_synthetic.write_synthetic_split(str(tmp_path / "j"), "val", 18,
                                            image_size=48, seed=5)
    with open(os.path.join(a, "val.json")) as f, \
            open(os.path.join(b, "val.json")) as g:
        assert json.load(f) == json.load(g)
    names = sorted(os.listdir(tmp_path / "j" / "val"))
    assert names == sorted(os.listdir(tmp_path / "p" / "val"))
    for name in names:
        assert ((tmp_path / "p" / "val" / name).read_bytes()
                == (tmp_path / "j" / "val" / name).read_bytes())


# -- the native library ------------------------------------------------------


def test_native_decode_and_stage_match_jax(split):
    _native_or_skip()
    idx, _ = _index_pair(split)
    paths = [s.image_path for s in idx.samples[:3]]
    for p in paths:
        np.testing.assert_array_equal(native.decode_jpeg_bgr(p),
                                      jax_native.decode_jpeg_bgr(p))
        with open(p, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(native.decode_jpeg_bgr_bytes(data),
                                      jax_native.decode_jpeg_bgr_bytes(data))
    for canvas in (CANVAS, 32):  # the 60 px window is downscaled into 32
        got = native.stage_batch(paths, canvas, num_threads=2,
                                 window_frac=0.75)
        want = jax_native.stage_batch(paths, canvas, num_threads=2,
                                      window_frac=0.75)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert native.decode_jpeg_bgr_bytes(b"not a jpeg") is None


def test_native_builds_into_the_port_build_directory():
    _native_or_skip()
    built = sorted(native.BUILD_DIR.glob("libhgr_native-*.so"))
    assert built and all(p.parent == native.BUILD_DIR for p in built)


# -- loaders -----------------------------------------------------------------


def _epochs(loader_obj, n=2):
    return [b for _ in range(n) for b in loader_obj]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("route", ["native", "pil", "cv2"])
def test_batch_loader_matches_jax(monkeypatch, split, route, shuffle):
    """Two epochs (two shuffles) with a padded tail batch. On the cv2
    route the 60 px windows are downscaled into a 32 px canvas."""
    if route == "native":
        _native_or_skip()
    elif route == "pil":
        _pil_only(monkeypatch)
    else:
        pytest.importorskip("cv2")
        _no_native(monkeypatch)
    p_idx, j_idx = _index_pair(split)
    kw = dict(batch_size=BATCH, canvas_size=32 if route == "cv2" else CANVAS,
              shuffle=shuffle, seed=7, drop_last=False, num_workers=2,
              window_frac=0.75)
    port = loader.BatchLoader(p_idx, **kw)
    ref = jax_loader.BatchLoader(j_idx, **kw)
    assert len(port) == len(ref) == 3
    got, want = _epochs(port), _epochs(ref)
    _assert_batches_equal(got, want)
    assert got[2]["valid"].tolist() == [1.0, 1.0, 1.0, 0.0]


def test_batch_loader_drop_last_and_early_exit(split):
    p_idx, _ = _index_pair(split)
    ld = loader.BatchLoader(p_idx, batch_size=BATCH, canvas_size=CANVAS,
                            drop_last=True, num_workers=1, prefetch=0)
    assert len(ld) == 2 and len(list(ld)) == 2
    first = next(iter(ld))  # abandoned iterator: producer stops and joins
    assert first["canvas"].shape == (BATCH, CANVAS, CANVAS, 3)


def test_batch_loader_reraises_producer_errors(tmp_path):
    idx = dataset.AnnotationIndex(
        samples=[dataset.Sample(str(tmp_path / "missing.jpg"), [], "call")],
        names=dict(DEFAULT_NAMES))
    ld = loader.BatchLoader(idx, batch_size=1, canvas_size=CANVAS,
                            num_workers=1)
    with pytest.raises(Exception):
        list(ld)


def test_device_cache_loader_matches_jax(split):
    p_idx, j_idx = _index_pair(split)
    kw = dict(batch_size=BATCH, canvas_size=CANVAS, shuffle=True, seed=2,
              drop_last=False, num_workers=2, window_frac=0.75)
    port = device_cache.DeviceCacheLoader(p_idx, device="cpu", **kw)
    ref = jax_cache.DeviceCacheLoader(j_idx, **kw)
    got, want = _epochs(port), _epochs(ref)
    _assert_batches_equal(got, want)
    # the cached epochs equal the streaming loader's
    stream = _epochs(loader.BatchLoader(p_idx, **kw))
    _assert_batches_equal(got, stream)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_written_by_one_package_serves_the_other(
        tmp_path, monkeypatch, split, writer):
    """Both packages write the same snapshot files; the one written by
    either serves the other's loader after every image file is gone (the
    annotation fingerprint alone then keys it)."""
    import shutil

    data = tmp_path / "data"
    shutil.copytree(os.path.dirname(os.path.dirname(split)), data)
    ann = str(data / "annotations" / "train")
    p_idx, j_idx = _index_pair(ann)
    kw = dict(batch_size=BATCH, canvas_size=CANVAS, shuffle=True, seed=4,
              drop_last=False, num_workers=2, window_frac=0.75)
    snap_p, snap_j = str(tmp_path / "snap_p"), str(tmp_path / "snap_j")
    first_p = _epochs(device_cache.DeviceCacheLoader(
        p_idx, device="cpu", snapshot_dir=snap_p, **kw), 1)
    first_j = _epochs(jax_cache.DeviceCacheLoader(j_idx, snapshot_dir=snap_j,
                                                  **kw), 1)
    _assert_batches_equal(first_p, first_j)
    for name in sorted(os.listdir(snap_j)):
        assert (open(os.path.join(snap_p, name), "rb").read()
                == open(os.path.join(snap_j, name), "rb").read()), name
    shutil.rmtree(data / "train")  # every image file gone
    snap = snap_p if writer == "port" else snap_j
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a stale snapshot would warn
        if writer == "port":
            reader = jax_cache.DeviceCacheLoader(j_idx, snapshot_dir=snap,
                                                 **kw)
        else:
            reader = device_cache.DeviceCacheLoader(
                p_idx, device="cpu", snapshot_dir=snap, **kw)
        got = _epochs(reader, 1)
    _assert_batches_equal(got, first_p)
    if writer == "jax":
        assert reader.loaded_from_snapshot
