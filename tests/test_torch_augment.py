"""The port's augmentation path (hgr_tpu_torch/ops/affine.py, color.py,
heatmap.py, warp.py, warp_fused.py and data/pipeline.py) held against the
JAX package's, with the same numpy inputs on both sides.

The fused jitter + warp kernel's plain version is held against the Pallas
kernel run in interpret mode (the chain: CUDA kernel -> plain version on
the card in tests/test_torch_gpu.py, plain version -> Pallas kernel
here). Tolerances are the JAX warp tests' own
(tests/test_warp_pallas.py): 0.02 on the 0-255 scale before rounding
(the two sum in another order), and with the jitter at most one level
and under 1% of pixels above 0.02 (a float-order difference can move
the LUT's floor by one level).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgr_tpu.data import pipeline as jax_pipeline
from hgr_tpu.ops import affine as jax_affine
from hgr_tpu.ops import color as jax_color
from hgr_tpu.ops import warp as jax_warp
from hgr_tpu.ops import warp_pallas
from hgr_tpu.ops.heatmap import generate_targets as jax_generate_targets
from hgr_tpu_torch.config import AugmentConfig
from hgr_tpu_torch.data import pipeline
from hgr_tpu_torch.ops import affine, color, warp, warp_fused
from hgr_tpu_torch.ops.heatmap import generate_targets

torch.set_num_threads(1)

ROTATIONS = [(0.0, 1.0), (30.0, 1.2), (-75.0, 0.8), (90.0, 1.0),
             (180.0, 1.35)]  # tests/test_warp_pallas.py:19-21


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _affines(b, s, out, rot, scale):
    """The same (B, 2, 3) crop affines for both sides, built by JAX."""
    m = jax_affine.build_affine(
        jnp.tile(jnp.asarray([s / 2.0, s / 2.0]), (b, 1)),
        jnp.full((b,), scale), jnp.full((b,), rot),
        jnp.full((b,), 0.35 * s), (out, out))
    return np.asarray(m)


def _assert_levels(got, want, what):
    """At most one level apart, and under 1% of pixels above 0.02."""
    diff = np.abs(_np(got) - _np(want))
    assert diff.max() <= 1.0 + 1e-5, (what, diff.max())
    assert (diff > 0.02).mean() < 0.01, (what, (diff > 0.02).mean())


# -- geometry ----------------------------------------------------------------


def test_build_affine_and_points_match():
    rng = np.random.RandomState(0)
    b = 6
    center = rng.uniform(50, 150, (b, 2)).astype(np.float32)
    scale = rng.uniform(0.7, 1.3, b).astype(np.float32)
    rot = rng.uniform(-40, 40, b).astype(np.float32)
    size = rng.uniform(60, 120, b).astype(np.float32)
    for inv in (False, True):
        want = jax_affine.build_affine(center, scale, rot, size, (192, 144),
                                       inv=inv)
        got = affine.build_affine(_t(center), _t(scale), _t(rot), _t(size),
                                  (192, 144), inv=inv)
        assert got.shape == (b, 2, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)
    m = np.asarray(want)
    pts = rng.uniform(0, 200, (b, 21, 2)).astype(np.float32)
    np.testing.assert_allclose(
        _np(affine.transform_points(_t(pts), _t(m))),
        _np(jax_affine.transform_points(pts, m)), rtol=1e-5, atol=1e-4)


def test_invert_and_compose_affine_match():
    rng = np.random.RandomState(1)
    m1 = rng.randn(4, 2, 3).astype(np.float32)
    m2 = rng.randn(4, 2, 3).astype(np.float32)
    np.testing.assert_allclose(_np(affine.invert_affine(_t(m1))),
                               _np(jax_affine.invert_affine(m1)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(affine.compose_affine(_t(m2), _t(m1))),
                               _np(jax_affine.compose_affine(m2, m1)),
                               rtol=1e-5, atol=1e-5)
    # m ∘ m⁻¹ is the identity
    eye = affine.compose_affine(_t(m1), affine.invert_affine(_t(m1)))
    np.testing.assert_allclose(_np(eye), np.tile([[1, 0, 0], [0, 1, 0]],
                                                 (4, 1, 1)), atol=1e-4)


# -- color -------------------------------------------------------------------


def test_hsv_jitter_matches_on_integer_pixels():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (3, 16, 24, 3)).astype(np.float32)
    img[0, 0, :3] = [[0, 0, 0], [255, 255, 255], [40, 40, 40]]  # grey: c=0
    gains = np.array([[1.01, 1.3, 0.8], [0.99, 0.7, 1.2], [1.0, 1.0, 1.0]],
                     np.float32)
    want = jax_color.hsv_jitter(jnp.asarray(img), jnp.asarray(gains))
    got = color.hsv_jitter(_t(img), _t(gains))
    assert got.shape == img.shape
    _assert_levels(got, want, "jitter")
    got_np = _np(got)
    assert np.array_equal(got_np, np.round(got_np))
    assert got_np.min() >= 0 and got_np.max() <= 255
    # the round trip BGR -> HSV -> BGR without gains
    hsv = color.bgr_to_hsv_u8(_t(img))
    np.testing.assert_allclose(_np(hsv), _np(jax_color.bgr_to_hsv_u8(img)),
                               atol=1e-4)
    np.testing.assert_allclose(_np(color.hsv_to_bgr_u8(hsv)), img, atol=1e-3)


def test_normalize_imagenet_keeps_bgr_quirk():
    img = np.random.RandomState(3).randint(0, 256, (2, 5, 5, 3)).astype(
        np.float32)
    got = color.normalize_imagenet(_t(img))
    np.testing.assert_allclose(_np(got),
                               _np(jax_color.normalize_imagenet(img)),
                               rtol=1e-6, atol=1e-6)
    # channel 0 (B of BGR) takes the R statistics, as the reference does
    np.testing.assert_allclose(_np(got)[..., 0],
                               (img[..., 0] / 255.0 - 0.485) / 0.229,
                               rtol=1e-5, atol=1e-5)


# -- targets -----------------------------------------------------------------


def test_generate_targets_matches_including_out_of_bounds():
    rng = np.random.RandomState(4)
    joints = rng.uniform(-20, 212, (3, 21, 2)).astype(np.float32)
    joints[0, 0] = [-30.0, 50.0]  # box left of the map: weight 0
    joints[0, 1] = [50.0, 400.0]  # below it
    joints[0, 2] = [-5.0, -5.0]  # trunc, not floor: box still overlaps
    joints[0, 3] = [191.9, 0.0]
    vis = (rng.rand(3, 21) > 0.2).astype(np.float32)
    want_t, want_w = jax_generate_targets(joints, vis, (192, 192), (48, 48),
                                          2.0)
    got_t, got_w = generate_targets(_t(joints), _t(vis), (192, 192),
                                    (48, 48), 2.0)
    assert got_t.shape == (3, 21, 48, 48)
    np.testing.assert_array_equal(_np(got_w), _np(want_w))
    np.testing.assert_allclose(_np(got_t), _np(want_t), atol=1e-6)
    assert got_w[0, 0] == 0 and got_w[0, 1] == 0


# -- warps -------------------------------------------------------------------


@pytest.mark.parametrize("rot,scale", ROTATIONS[:3])
def test_exact_warp_matches(rot, scale):
    rng = np.random.RandomState(5)
    imgs = rng.randint(0, 256, (2, 80, 72, 3)).astype(np.float32)
    m = _affines(2, 80, 48, rot, scale)
    want = jax_warp.batched_affine_warp(jnp.asarray(imgs), m, (48, 40))
    got = warp.batched_affine_warp(_t(imgs), _t(m), (48, 40))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-3)
    got_u8 = warp.batched_affine_warp(_t(imgs.astype(np.uint8)), _t(m),
                                      (48, 40))
    assert got_u8.dtype == torch.uint8
    assert np.abs(_np(got_u8) - np.round(_np(got))).max() <= 1


@pytest.mark.parametrize("rot,scale", ROTATIONS)
def test_twopass_reference_matches_pallas_kernel(rot, scale):
    b, s, out = 2, 128, 96
    imgs = np.random.RandomState(6).randint(0, 255, (b, s, s, 3)).astype(
        np.float32)
    m = _affines(b, s, out, rot, scale)
    want = warp_pallas.warp_twopass_pallas(jnp.asarray(imgs), m, (out, out),
                                           interpret=True)
    got = warp_fused.warp_twopass_reference(_t(imgs), _t(m), (out, out))
    assert got.shape == (b, out, out, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=0.02)
    # the XLA two-pass warp computes the same function
    np.testing.assert_allclose(
        _np(warp.batched_affine_warp_twopass(_t(imgs), _t(m), (out, out))),
        _np(jax_warp.batched_affine_warp_twopass(jnp.asarray(imgs), m,
                                                 (out, out))), atol=0.02)


def test_transpose_route_is_taken_at_90_degrees():
    m = _affines(2, 128, 96, 90.0, 1.0)
    use_t = warp.twopass_coefficients(_t(m))[1]
    assert bool(use_t.all())
    m0 = _affines(2, 128, 96, 0.0, 1.0)
    assert not bool(warp.twopass_coefficients(_t(m0))[1].any())


@pytest.mark.parametrize("rot,scale", [(20.0, 1.1), (90.0, 1.0)])
def test_twopass_reference_with_jitter_matches_pallas_kernel(rot, scale):
    b, s, out = 2, 128, 96
    imgs = np.random.RandomState(7).randint(0, 255, (b, s, s, 3)).astype(
        np.uint8)
    m = _affines(b, s, out, rot, scale)
    gains = np.array([[1.01, 1.3, 0.8], [0.99, 0.7, 1.2]], np.float32)
    do_j = np.array([1.0, 0.0], np.float32)
    # the default staging (packed uint8) returns rounded uint8 pixels
    want = warp_pallas.warp_twopass_pallas(
        jnp.asarray(imgs), m, (out, out), interpret=True,
        jitter_gains=jnp.asarray(gains), do_jitter=jnp.asarray(do_j),
        canvas_dtype=warp_pallas.PREFERRED_CANVAS_DTYPE)
    got = warp_fused.warp_twopass(_t(imgs), _t(m), (out, out),
                                  jitter_gains=_t(gains), do_jitter=_t(do_j))
    assert got.dtype == torch.uint8  # the canvas's dtype, as JAX returns
    _assert_levels(got, want, "u8 canvas, jitter")
    # f32 canvas, unrounded
    want_f = warp_pallas.warp_twopass_pallas(
        jnp.asarray(imgs, jnp.float32), m, (out, out), interpret=True,
        jitter_gains=jnp.asarray(gains), do_jitter=jnp.asarray(do_j))
    got_f = warp_fused.warp_twopass_reference(
        _t(imgs).float(), _t(m), (out, out), jitter_gains=_t(gains),
        do_jitter=_t(do_j))
    _assert_levels(got_f, want_f, "f32 canvas, jitter")


def test_canvas_types_give_the_same_warp():
    """uint8, float32 and bfloat16 canvases of 0-255 integers are the
    same function (bf16 holds every 0-255 integer exactly)."""
    imgs = np.random.RandomState(8).randint(0, 256, (2, 64, 64, 3))
    m = _t(_affines(2, 64, 48, 25.0, 1.1))
    gains = _t(np.array([[1.01, 1.3, 0.8], [0.99, 0.7, 1.2]], np.float32))
    outs = [warp_fused.warp_twopass(_t(imgs).to(dt), m, (48, 48),
                                    jitter_gains=gains, round_output=True)
            for dt in (torch.uint8, torch.float32, torch.bfloat16)]
    # a uint8 canvas gives a uint8 crop, float canvases f32: same levels
    assert [o.dtype for o in outs] == [torch.uint8, torch.float32,
                                       torch.float32]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0].float(), rtol=0, atol=0)


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("rot", [0.0, 90.0])
def test_uint8_crop_equals_jax_uint8_crop_bit_for_bit(rot, jitter):
    """A uint8 canvas with rounding gives a uint8 crop equal bit for bit
    to JAX's ``warp_twopass_pallas`` uint8 return (packed staging,
    interpret mode), at 0° and at 90° (the transpose route). With jitter
    JAX's side is its eager ``hsv_jitter`` ahead of the warp: the fused
    Pallas kernel's jitter runs jitted in interpret mode and lands a level
    off the eager LUT at ~0.1% of pixels (the JAX package's own finding,
    ROADMAP C), which the level test above covers."""
    b, s, out = 2, 128, 96
    imgs = np.random.RandomState(17).randint(0, 256, (b, s, s, 3)).astype(
        np.uint8)
    m = _affines(b, s, out, rot, 1.0)
    gains = np.array([[1.01, 1.3, 0.8], [0.99, 0.7, 1.2]], np.float32)
    do_j = np.array([1.0, 0.0], np.float32)
    src = imgs
    if jitter:
        src = np.where(do_j[:, None, None, None] > 0, np.asarray(
            jax_color.hsv_jitter(jnp.asarray(imgs, jnp.float32),
                                 jnp.asarray(gains))), imgs).astype(np.uint8)
    want = np.asarray(warp_pallas.warp_twopass_pallas(
        jnp.asarray(src), m, (out, out), interpret=True,
        canvas_dtype=warp_pallas.PREFERRED_CANVAS_DTYPE))
    kw = dict(jitter_gains=_t(gains), do_jitter=_t(do_j)) if jitter else {}
    got = warp_fused.warp_twopass(_t(imgs), _t(m), (out, out), **kw)
    assert want.dtype == np.uint8 and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # the plain version is what the CPU route runs, dtype included
    ref = warp_fused.warp_twopass_reference(_t(imgs), _t(m), (out, out),
                                            **kw)
    assert torch.equal(ref, got)


@pytest.mark.parametrize("canvas_dtype,round_output,want", [
    (torch.uint8, None, torch.uint8), (torch.uint8, True, torch.uint8),
    (torch.uint8, False, torch.float32),
    (torch.float32, None, torch.float32),
    (torch.float32, True, torch.float32),
    (torch.bfloat16, True, torch.float32)])
def test_warp_output_dtype_follows_the_canvas(canvas_dtype, round_output,
                                              want):
    """uint8 only for a uint8 canvas with rounding (the default for an
    integer canvas); float canvases and unrounded crops stay float32."""
    imgs = _t(np.random.RandomState(18).randint(0, 256, (2, 64, 64, 3))
              ).to(canvas_dtype)
    m = _t(_affines(2, 64, 48, 10.0, 1.0))
    got = warp_fused.warp_twopass(imgs, m, (48, 48),
                                  round_output=round_output)
    assert got.dtype == want and got.shape == (2, 48, 48, 3)
    ref = warp_fused.warp_twopass_reference(imgs, m, (48, 48),
                                            round_output=round_output)
    assert ref.dtype == want


def test_invert_affine_is_the_einsum_on_the_cpu():
    """The elementwise A^-1 b (the order the warp kernel inverts in)
    equals the batched product bit for bit on the CPU."""
    m = torch.from_numpy(np.random.RandomState(19).randn(4096, 2, 3)
                         .astype(np.float32)) * torch.tensor([1.0, 1.0,
                                                              300.0])
    got = affine.invert_affine(m)
    a, b = m[..., :2], m[..., 2]
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    inv_a = torch.stack([torch.stack([a[..., 1, 1], -a[..., 0, 1]], -1),
                         torch.stack([-a[..., 1, 0], a[..., 0, 0]], -1)],
                        -2) / det[..., None, None]
    assert torch.equal(got[..., :2], inv_a)
    assert torch.equal(got[..., 2],
                       -torch.einsum("...ij,...j->...i", inv_a, b))


def test_warp_wrapper_counts_no_launch_on_cpu_and_rejects_shapes():
    imgs = torch.zeros(2, 64, 64, 3, dtype=torch.uint8)
    m = _t(_affines(2, 64, 48, 0.0, 1.0))
    before = warp_fused.warp_twopass.launches
    warp_fused.warp_twopass(imgs, m, (48, 48))
    assert warp_fused.warp_twopass.launches == before
    with pytest.raises(ValueError, match="square"):
        warp_fused.warp_twopass(torch.zeros(2, 64, 60, 3), m, (48, 48))
    with pytest.raises(ValueError, match="fit"):
        warp_fused.warp_twopass(imgs, m, (80, 48))
    with pytest.raises(ValueError, match="cuda or cpu"):
        warp_fused.warp_twopass(imgs.to("meta"), m.to("meta"), (48, 48))


# -- pipeline ----------------------------------------------------------------


def _staged_batch(b=4, s=64, seed=9):
    rng = np.random.RandomState(seed)
    sizes = rng.uniform(60, 110, (b, 2)).astype(np.float32)
    scale = (s / sizes.max(axis=1) * 0.9).astype(np.float32)
    a = np.zeros((b, 2, 3), np.float32)
    a[:, 0, 0] = a[:, 1, 1] = scale
    a[:, :, 2] = rng.uniform(0, 4, (b, 2))
    joints = (rng.uniform(0.2, 0.8, (b, 21, 2)) * sizes[:, None, ::-1]
              ).astype(np.float32)
    return dict(canvas=rng.randint(0, 256, (b, s, s, 3)).astype(np.uint8),
                orig_to_canvas=a, sizes_hw=sizes, joints=joints,
                joints_vis=(rng.rand(b, 21) > 0.1).astype(np.float32))


def _params(b, seed=10):
    rng = np.random.RandomState(seed)
    return dict(
        scale=rng.uniform(0.8, 1.3, b).astype(np.float32),
        rot=np.array([0.0, 25.0, -80.0, 95.0][:b], np.float32),
        translate=rng.uniform(-3, 3, (b, 2)).astype(np.float32),
        flip=np.array([0.0, 1.0, 1.0, 0.0][:b], np.float32),
        jitter_gains=np.array([[1.01, 1.3, 0.8], [1.0, 1.0, 1.0],
                               [0.99, 0.7, 1.2], [1.0, 0.8, 1.1]][:b],
                              np.float32),
        do_jitter=np.array([1.0, 0.0, 1.0, 1.0][:b], np.float32))


@pytest.mark.parametrize("seed", [9, 11])
def test_crop_affines_match_the_jax_pipelines(seed):
    """crop_affines (the geometry apply_augment_batch warps with) against
    the JAX pipeline's inline m_orig and m_canvas (pipeline.py:231-258)."""
    batch = _staged_batch(seed=seed)
    p = _params(4, seed=seed + 1)
    o2c, sizes = batch["orig_to_canvas"], batch["sizes_hw"]
    h, w = sizes[:, 0], sizes[:, 1]
    center = np.stack([w / 2.0, h / 2.0], axis=-1) + p["translate"]
    flip = p["flip"] > 0
    center_f = np.stack([np.where(flip, w - center[:, 0] - 1.0,
                                  center[:, 0]), center[:, 1]], axis=-1)
    m_crop = jax_affine.build_affine(
        jnp.asarray(center_f), jnp.asarray(p["scale"]),
        jnp.asarray(p["rot"]), jnp.asarray(np.maximum(h, w) * 0.35),
        (48.0, 48.0))
    f_mat = np.zeros((4, 2, 3), np.float32)
    f_mat[:, 0, 0] = np.where(flip, -1.0, 1.0)
    f_mat[:, 0, 2] = np.where(flip, w - 1.0, 0.0)
    f_mat[:, 1, 1] = 1.0
    want_orig = jax_affine.compose_affine(m_crop, jnp.asarray(f_mat))
    want_canvas = jax_affine.compose_affine(
        want_orig, jax_affine.invert_affine(jnp.asarray(o2c)))
    got_orig, got_canvas = pipeline.crop_affines(
        _t(o2c), _t(sizes), pipeline.AugmentParams(
            **{k: _t(v) for k, v in p.items()}), (48, 48))
    np.testing.assert_allclose(_np(got_orig), _np(want_orig), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(_np(got_canvas), _np(want_canvas),
                               rtol=1e-5, atol=1e-4)


def test_warp_opaque_probe_removes_only_the_asm_statement():
    """tools/probe_warp_opaque builds the warp source as it is and with
    opaque() made the identity; every footprint bound goes through it."""
    import re

    from hgr_tpu_torch.tools import probe_warp_opaque as probe
    from hgr_tpu_torch.utils.cuda_build import CSRC_DIR

    text = (CSRC_DIR / "warp_twopass.cu").read_text()
    assert probe.variant_source(text, "opaque") == text
    identity = probe.variant_source(text, "identity")
    assert probe.OPAQUE_ASM not in identity
    assert len(text) - len(identity) == len(probe.OPAQUE_ASM)
    for name in ("kmin", "kmax", "nk", "cmin", "cmax", "nx"):
        assert re.search(rf"const int {name} = opaque\(", text), name
    with pytest.raises(ValueError):
        probe.variant_source(text, "fused")


@pytest.mark.parametrize("jax_method,port_method", [
    ("auto", "auto"),  # exact 4-tap on the CPU, both sides
    ("exact", "exact"),
    ("twopass", "kernel"),  # the kernel's wrapper: plain version on CPU
])
@pytest.mark.parametrize("jitter", [True, False])
def test_apply_augment_batch_matches_with_injected_params(
        jax_method, port_method, jitter):
    batch = _staged_batch()
    p = _params(4)
    kw = dict(image_size=(48, 48), heatmap_size=(12, 12),
              enable_jitter=jitter)
    want = jax_pipeline.apply_augment_batch(
        *(jnp.asarray(batch[k]) for k in ("canvas", "orig_to_canvas",
                                          "sizes_hw", "joints",
                                          "joints_vis")),
        jax_pipeline.AugmentParams(**{k: jnp.asarray(v)
                                      for k, v in p.items()}),
        warp_method=jax_method, **kw)
    got = pipeline.apply_augment_batch(
        *(_t(batch[k]) for k in ("canvas", "orig_to_canvas", "sizes_hw",
                                 "joints", "joints_vis")),
        pipeline.AugmentParams(**{k: _t(v) for k, v in p.items()}),
        warp_method=port_method, **kw)
    assert got["image"].shape == (4, 48, 48, 3)
    # pixels are rounded levels: a float-order difference can move one by
    # a level, 1/255/0.224 in normalized units
    level = 1.0 / 255.0 / 0.224
    diff = np.abs(_np(got["image"]) - _np(want["image"]))
    assert diff.max() <= level + 1e-4, diff.max()
    assert (diff > 1e-4).mean() < 0.01, (diff > 1e-4).mean()
    np.testing.assert_allclose(_np(got["joints"]), _np(want["joints"]),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(_np(got["target_weight"]),
                                  _np(want["target_weight"]))
    np.testing.assert_allclose(_np(got["target"]), _np(want["target"]),
                               atol=1e-5)


@pytest.mark.parametrize("port_method,jax_method", [("kernel", "twopass"),
                                                    ("exact", "exact")])
def test_unnormalized_image_is_f32_and_normalizes_to_the_same_bits(
        port_method, jax_method):
    """normalize=False returns the f32 crop of rounded levels (the
    kernel's crop of a uint8 canvas is uint8; the pipeline casts it, as
    JAX's does), within a level of JAX's, and normalizing it gives the
    normalize=True image bit for bit."""
    batch = _staged_batch()
    p = _params(4)
    args = [_t(batch[k]) for k in ("canvas", "orig_to_canvas", "sizes_hw",
                                   "joints", "joints_vis")]
    params = pipeline.AugmentParams(**{k: _t(v) for k, v in p.items()})
    kw = dict(image_size=(48, 48), heatmap_size=(12, 12),
              warp_method=port_method)
    raw = pipeline.apply_augment_batch(*args, params, normalize=False, **kw)
    norm = pipeline.apply_augment_batch(*args, params, **kw)
    assert raw["image"].dtype == torch.float32
    assert torch.equal(color.normalize_imagenet(raw["image"]), norm["image"])
    want = jax_pipeline.apply_augment_batch(
        *(jnp.asarray(batch[k]) for k in ("canvas", "orig_to_canvas",
                                          "sizes_hw", "joints",
                                          "joints_vis")),
        jax_pipeline.AugmentParams(**{k: jnp.asarray(v)
                                      for k, v in p.items()}),
        image_size=(48, 48), heatmap_size=(12, 12), normalize=False,
        warp_method=jax_method)
    _assert_levels(raw["image"], want["image"], port_method)


def test_identity_params_and_unknown_warp_method():
    p = pipeline.identity_params(3)
    assert p.scale.tolist() == [1.0] * 3 and float(p.do_jitter.sum()) == 0
    batch = _staged_batch(b=3)
    with pytest.raises(ValueError, match="warp_method"):
        pipeline.apply_augment_batch(
            *(_t(batch[k]) for k in ("canvas", "orig_to_canvas", "sizes_hw",
                                     "joints", "joints_vis")), p,
            warp_method="pallas")


def test_draw_params_distributions():
    """The checks of tests/test_pipeline.py:165, on the port's draw."""
    cfg = AugmentConfig()
    gen = torch.Generator().manual_seed(0)
    p = pipeline.draw_augment_params(gen, 2048, torch.full((2048, 2), 224.0),
                                     cfg)
    s = _np(p.scale)
    assert s.min() >= 1 - cfg.scale_factor - 1e-6
    assert s.max() <= 1 + cfg.scale_factor + 1e-6
    assert abs(s.mean() - 1.0) < 0.05
    r = _np(p.rot)
    assert np.abs(r).max() <= 2 * cfg.rotate_factor + 1e-5
    assert 0.5 < (r != 0).mean() < 0.7
    assert 0.4 < _np(p.flip).mean() < 0.6
    t = _np(p.translate)
    assert np.abs(t).max() <= 2 * cfg.translate_factor * 224 + 1e-4
    assert 0.4 < (np.abs(t).sum(-1) > 0).mean() < 0.6
    g = _np(p.jitter_gains)
    assert (g == 1.0).all(axis=-1).mean() > 0.4
    assert g[:, 1].min() >= 1 - cfg.hsv_s - 1e-6
    assert np.array_equal((g != 1.0).any(-1), _np(p.do_jitter) > 0)
    # one seed, one draw; the config's switches turn the flip and jitter off
    q = pipeline.draw_augment_params(torch.Generator().manual_seed(0), 2048,
                                     torch.full((2048, 2), 224.0), cfg)
    torch.testing.assert_close(q.rot, p.rot, rtol=0, atol=0)
    off = pipeline.draw_augment_params(
        gen, 64, torch.full((64, 2), 224.0),
        AugmentConfig(horizontal_flip=False, color_jittering=False))
    assert float(off.flip.sum()) == 0 and float(off.do_jitter.sum()) == 0


@pytest.mark.parametrize("device_type,shape,want", [
    ("cuda", (4, 64, 64, 3), "kernel"),
    ("cuda", (4, 64, 80, 3), "exact"),
    ("cuda", (4, 80, 64, 3), "exact"),
    ("cpu", (4, 64, 64, 3), "exact"),
    ("cpu", (4, 64, 80, 3), "exact"),
])
def test_auto_warp_takes_the_kernel_only_for_square_cuda_canvases(
        device_type, shape, want):
    """'auto' follows the JAX package's guard (pipeline.py:266-269): the
    two-pass kernel needs a square canvas, so a non-square one takes the
    exact warp on the card too."""
    assert pipeline.auto_warp_method(device_type, shape) == want


def test_auto_warp_on_a_non_square_canvas_matches_jax():
    """A non-square canvas through 'auto' on both sides: the exact warp,
    the same crop as the JAX package's."""
    b = 4
    batch = _staged_batch()
    rng = np.random.RandomState(31)
    batch["canvas"] = rng.randint(0, 256, (b, 64, 80, 3)).astype(np.uint8)
    p = _params(b)
    kw = dict(image_size=(48, 48), heatmap_size=(12, 12))
    names = ("canvas", "orig_to_canvas", "sizes_hw", "joints", "joints_vis")
    want = jax_pipeline.apply_augment_batch(
        *(jnp.asarray(batch[k]) for k in names),
        jax_pipeline.AugmentParams(**{k: jnp.asarray(v)
                                      for k, v in p.items()}),
        warp_method="auto", **kw)
    got = pipeline.apply_augment_batch(
        *(_t(batch[k]) for k in names),
        pipeline.AugmentParams(**{k: _t(v) for k, v in p.items()}),
        warp_method="auto", **kw)
    level = 1.0 / 255.0 / 0.224
    diff = np.abs(_np(got["image"]) - _np(want["image"]))
    assert diff.max() <= level + 1e-4, diff.max()
    assert (diff > 1e-4).mean() < 0.01, (diff > 1e-4).mean()
