"""Tests that need a CUDA card (marker ``gpu``): the port's kernels held
against their plain PyTorch versions on the card, and the model's forward
and a train step on the card against the same weights on the CPU.

Imports torch and the port only, so the card's machine (no JAX) runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card every test skips; whether there is one is decided inside
each test, so every pytest worker collects the same tests.
"""

import numpy as np
import pytest
import torch

from hgr_tpu_torch.ops import attention as A

H, D = 8, 32
SCALE = D**-0.5
# the JAX kernel tests' own tolerances (tests/test_attention_pallas.py)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2)}
# gradients: the JAX package's 1e-4 (tests/test_attention_pallas.py); a
# bf16 gradient is one rounding of an f32 sum taken in another order, so
# it may sit one bf16 ulp (2^-8 relative) away: atol 2e-2 plus rtol 2^-7
GRAD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
            "bfloat16": dict(atol=2e-2, rtol=2**-7)}


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _qkv(b, n, seed, dtype):
    x = np.random.RandomState(seed).randn(b, n, 3 * H * D).astype(np.float32)
    return torch.from_numpy(x).to("cuda", getattr(torch, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,dtype", [(64, 145, "bfloat16"),
                                       (64, 145, "float32"),
                                       (16, 145, "bfloat16"),
                                       (4, 145, "float32"),
                                       (1, 37, "bfloat16"),
                                       (1, 37, "float32"),
                                       (1024, 145, "bfloat16"),
                                       (1, 145, "bfloat16"),
                                       (1, 145, "float32"),
                                       (16, 145, "float32"),
                                       (128, 145, "bfloat16")])
def test_kernel_matches_plain_version(b, n, dtype):
    _cuda_or_skip()
    x = _qkv(b, n, 11, dtype)
    before = A.fused_attention_qkv.launches
    got = A.fused_attention_qkv(x, H, D, SCALE)
    torch.cuda.synchronize()
    assert A.fused_attention_qkv.launches == before + 1
    assert got.dtype == x.dtype and got.shape == (b, n, H * D)
    want = A.attention_qkv_reference(x, H, D, SCALE)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
    _cuda_or_skip()
    with pytest.raises(ValueError, match="head_dim >= 1"):
        A.fused_attention_qkv(torch.zeros(2, 10, 0, device="cuda"), H, 0,
                              SCALE)
    with pytest.raises(TypeError):
        A.fused_attention_qkv(torch.zeros(2, 10, 3 * H * D, device="cuda",
                                          dtype=torch.float16), H, D, SCALE)
    with pytest.raises(ValueError, match="contiguous"):
        A.fused_attention_qkv(
            torch.zeros(2, 3 * H * D, 10, device="cuda").transpose(1, 2),
            H, D, SCALE)
    with pytest.raises(ValueError, match="cotangent"):
        A.fused_attention_qkv_bwd(_qkv(2, 10, 0, "float32"),
                                  torch.zeros(2, 10, 3, device="cuda"),
                                  H, D, SCALE)


@pytest.mark.gpu
def test_model_forward_on_card_matches_cpu_and_launches_kernel():
    _cuda_or_skip()
    from hgr_tpu_torch.models import MultiTaskNet

    model = MultiTaskNet(image_size=(192, 192)).eval()
    x = torch.from_numpy(
        np.random.RandomState(0).randn(2, 192, 192, 3).astype(np.float32))
    with torch.inference_mode():
        want = model(x, need_attnmap=False)
        model = model.to("cuda")
        before = A.fused_attention_qkv.launches
        got = model(x.cuda(), need_attnmap=False)
        torch.cuda.synchronize()
    assert A.fused_attention_qkv.launches == before + 4
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,dtype", [(64, 145, "bfloat16"),
                                       (64, 145, "float32"),
                                       (1, 37, "bfloat16"),
                                       (1, 37, "float32")])
def test_backward_kernel_matches_plain_version(b, n, dtype):
    _cuda_or_skip()
    x = _qkv(b, n, 12, dtype)
    g = torch.from_numpy(np.random.RandomState(13).randn(b, n, H * D).astype(
        np.float32)).to("cuda", x.dtype)
    before = A.fused_attention_qkv_bwd.launches
    got = A.fused_attention_qkv_bwd(x, g, H, D, SCALE)
    torch.cuda.synchronize()
    assert A.fused_attention_qkv_bwd.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    want = A.attention_qkv_bwd_reference(x, g, H, D, SCALE)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **GRAD_TOL[dtype])
    # through autograd: the forward and backward kernels, one launch each
    xr = x.clone().requires_grad_()
    (via_autograd,) = torch.autograd.grad(
        A.fused_attention_qkv(xr, H, D, SCALE), xr, g)
    torch.testing.assert_close(via_autograd, got, rtol=0, atol=0)


def _warp_case(b, s, out, rot, scale, seed):
    """Canvas (B, S, S, 3) of 0-255 integers and (B, 2, 3) crop affines
    (ops/affine.build_affine around the canvas center)."""
    from hgr_tpu_torch.ops.affine import build_affine

    rng = np.random.RandomState(seed)
    canvas = torch.from_numpy(rng.randint(0, 256, (b, s, s, 3)).astype(
        np.uint8))
    m = build_affine(torch.full((b, 2), s / 2.0), torch.full((b,), scale),
                     torch.full((b,), rot), torch.full((b,), 0.35 * s),
                     (out, out))
    gains = torch.from_numpy(rng.uniform(0.7, 1.3, (b, 3)).astype(
        np.float32))
    do_j = torch.from_numpy((rng.rand(b) > 0.5).astype(np.float32))
    return canvas, m, gains, do_j


@pytest.mark.gpu
@pytest.mark.parametrize("canvas_dtype", ["uint8", "float32", "bfloat16"])
@pytest.mark.parametrize("rot,scale", [(0.0, 1.0), (30.0, 1.2),
                                       (-75.0, 0.8), (90.0, 1.0),
                                       (180.0, 1.35)])
@pytest.mark.parametrize("jitter", [False, True])
def test_warp_kernel_matches_plain_version(canvas_dtype, rot, scale, jitter):
    _cuda_or_skip()
    from hgr_tpu_torch.ops import warp_fused as W

    canvas, m, gains, do_j = _warp_case(8, 256, 192, rot, scale, seed=14)
    canvas = canvas.to("cuda", getattr(torch, canvas_dtype))
    kw = dict(jitter_gains=gains.cuda() if jitter else None,
              do_jitter=do_j.cuda())
    before = W.warp_twopass.launches
    got = W.warp_twopass(canvas, m.cuda(), (192, 192), **kw)
    torch.cuda.synchronize()
    assert W.warp_twopass.launches == before + 1
    # a uint8 canvas (rounded by default) gives a uint8 crop, as the JAX
    # wrapper returns the canvas's dtype; float canvases give f32
    want_dtype = torch.uint8 if canvas_dtype == "uint8" else torch.float32
    assert got.dtype == want_dtype and got.shape == (8, 192, 192, 3)
    want = W.warp_twopass_reference(canvas, m.cuda(), (192, 192), **kw)
    assert want.dtype == want_dtype
    # the kernel rounds every product, sum and quotient on its own
    # (-fmad=false), in the plain version's order, parameters included
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("canvas_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("jitter", [False, True])
def test_warp_kernel_matches_plain_version_on_a_shrinking_affine(
        canvas_dtype, jitter):
    """A src->dst affine of scale 0.25 (each output pixel four canvas
    pixels apart; rotations 0, 30, 75, 135 degrees): a 32 x 32 tile's
    footprint does not fit the block's shared memory, so the kernel
    takes smaller sub-tiles (the banded route), and matches bit for bit."""
    _cuda_or_skip()
    from hgr_tpu_torch.ops import warp_fused as W

    m = torch.from_numpy(_shrinking_affines(4, 256, 192, 0.25))
    rng = np.random.RandomState(3)
    canvas = torch.from_numpy(rng.randint(0, 256, (4, 256, 256, 3)).astype(
        np.uint8)).to("cuda", getattr(torch, canvas_dtype))
    gains = torch.from_numpy(rng.uniform(0.7, 1.3, (4, 3)).astype(
        np.float32)).cuda() if jitter else None
    got = W.warp_twopass(canvas, m.cuda(), (192, 192), jitter_gains=gains)
    want = W.warp_twopass_reference(canvas, m.cuda(), (192, 192),
                                    jitter_gains=gains)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(want.float().gt(0).float().mean()) > 0.05  # not all border


@pytest.mark.gpu
@pytest.mark.parametrize("b,out", [(256, 192), (64, 448), (16, 320)])
def test_warp_kernel_matches_plain_version_at_every_step_canvas(b, out):
    """The train step's own warp inputs at every canvas a path of
    chip_smoke.py warps (256 -> 192, 512 -> 448, 384 -> 320): staged uint8
    canvases of side out + 64 and an augment draw (about half the images
    jittered) through the pipeline's crop_affines. The kernel's crop
    equals the plain version's bit for bit, on the card and on the CPU."""
    _cuda_or_skip()
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.data.pipeline import crop_affines, draw_augment_params
    from hgr_tpu_torch.ops import warp_fused as W

    s = out + 64
    rng = np.random.RandomState(out)
    canvas = torch.from_numpy(rng.randint(0, 256, (b, s, s, 3)).astype(
        np.uint8)).cuda()
    sizes = torch.from_numpy(rng.uniform(200, 400, (b, 2)).astype(
        np.float32)).cuda()
    o2c = torch.zeros(b, 2, 3, device="cuda")
    o2c[:, 0, 0] = o2c[:, 1, 1] = s / sizes.max(dim=1).values
    gen = torch.Generator(device="cuda").manual_seed(out)
    params = draw_augment_params(gen, b, sizes, AugmentConfig())
    _, m = crop_affines(o2c, sizes, params, (out, out))
    kw = dict(jitter_gains=params.jitter_gains, do_jitter=params.do_jitter)
    got = W.warp_twopass(canvas, m, (out, out), **kw)
    want = W.warp_twopass_reference(canvas, m, (out, out), **kw)
    want_cpu = W.warp_twopass_reference(
        canvas.cpu(), m.cpu(), (out, out),
        **{k: v.cpu() for k, v in kw.items()})
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == (b, out, out, 3)
    assert float(params.do_jitter.sum()) > 0  # some images jitter
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), want_cpu)


def _shrinking_affines(b, s, out, scale):
    """(B, 2, 3) src->dst affines of ``scale`` times a rotation (0, 30,
    75, 135 degrees, repeated), the canvas center onto the output's."""
    m = np.zeros((b, 2, 3), np.float32)
    for i in range(b):
        a = np.deg2rad([0.0, 30.0, 75.0, 135.0][i % 4])
        lin = scale * np.array([[np.cos(a), -np.sin(a)],
                                [np.sin(a), np.cos(a)]])
        m[i, :, :2] = lin
        m[i, :, 2] = np.full(2, out / 2.0) - lin @ np.full(2, s / 2.0)
    return m


# the bn kernels against their plain versions (ops/bn_act.py): T1/T2 are
# f32 sums over M rows taken in another order, held at 1e-6 of the sum of
# the terms' magnitudes; dy is one rounding of f32 values that may differ
# by a few ulps (FMA contraction, expf): 1e-5 in f32, one bf16 ulp in bf16
BN_DY_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=2e-2, rtol=2**-7)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 33, 7, 64), (3, 17, 11, 64),
                                   (2, 5, 5, 20), (2, 9, 9, 512)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", [True, False])
def test_bn_act_kernels_match_plain_versions(shape, dtype, act):
    _cuda_or_skip()
    from hgr_tpu_torch.ops import bn_act as B

    rng = np.random.RandomState(16)
    c = shape[-1]
    dt = getattr(torch, dtype)
    y = torch.from_numpy((rng.randn(*shape) * 2 + 0.3).astype(
        np.float32)).to("cuda", dt).reshape(-1, c)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        "cuda", dt).reshape(-1, c)
    gamma = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).cuda()
    beta = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32)).cuda()
    _, mean, var = B.fwd_chain(y, gamma, beta, 1e-5, act)
    r = torch.rsqrt(var + 1e-5)
    before = (B.bn_act_reduce.launches, B.bn_act_elem.launches)
    t1, t2 = B.bn_act_reduce(y, g, mean, r, gamma, beta, act)
    p1, p2 = B.bn_act_reduce_reference(y, g, mean, r, gamma, beta, act)
    m = float(y.shape[0])
    dy = B.bn_act_elem(y, g, mean, r, gamma, beta, p1 / m, p2 / m, act)
    torch.cuda.synchronize()
    assert (B.bn_act_reduce.launches, B.bn_act_elem.launches) == (
        before[0] + 1, before[1] + 1)
    dz, xhat = B._dz_xhat(y, g, mean, r, gamma, beta, act)
    for got, want, mag in ((t1, p1, dz.abs().sum(0)),
                           (t2, p2, (dz * xhat).abs().sum(0))):
        assert bool(((got - want).abs() <= 1e-6 * mag + 1e-30).all())
    want = B.bn_act_elem_reference(y, g, mean, r, gamma, beta, p1 / m,
                                   p2 / m, act)
    assert dy.dtype == y.dtype and dy.shape == y.shape
    np.testing.assert_allclose(dy.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BN_DY_TOL[dtype])


@pytest.mark.gpu
def test_bn_act_kernels_reject_what_they_do_not_take():
    _cuda_or_skip()
    from hgr_tpu_torch.ops import bn_act as B

    v = torch.zeros(8, device="cuda")
    y = torch.zeros(4, 8, device="cuda")
    with pytest.raises(TypeError):
        B.bn_act_reduce(y.half(), y.half(), v, v, v, v)
    with pytest.raises(ValueError, match="contiguous"):
        B.bn_act_reduce(torch.zeros(8, 4, device="cuda").t(), y, v, v, v, v)
    with pytest.raises(ValueError, match="cotangent"):
        B.bn_act_elem(y, y[:2], v, v, v, v, v, v)


def _card_vs_cpu_step(monkeypatch, fused: bool):
    """One f32 de-mixed train step (TF32 off) at 48x48 on the card,
    through the kernels, against the same step on the CPU, which warps
    with the kernel's plain version. Both take the same injected augment
    draw (torch's random streams differ by device). Gradients: per-tensor
    relative error 1e-3 (f32 sums in other orders through ~30 layers,
    forward and backward)."""
    _cuda_or_skip()
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.data import pipeline
    from hgr_tpu_torch.models import MultiTaskNet, layers
    from hgr_tpu_torch.ops import bn_act as B
    from hgr_tpu_torch.ops import warp_fused as W
    from hgr_tpu_torch.train import steps
    from hgr_tpu_torch.train.state import create_train_state

    monkeypatch.setattr(layers, "_FUSED_BN", fused)
    # every warp sample a third of a pixel off the canvas grid: images of
    # 60 px shifted by (1/3, 1/3), crop 0.35·60 = 21 px scaled to 48 (one
    # canvas pixel per output pixel), rotations of multiples of 90°. Each
    # output pixel is (4a + 2b + 2c + d) / 9 of integers, 0.05 of a level
    # from a rounding tie, so a one-ulp difference in the affine (the
    # card's and the CPU's linalg.solve) cannot move a rounded pixel.
    b = 4
    params = pipeline.AugmentParams(
        scale=torch.full((b,), 48.0 / 21.0),
        rot=torch.tensor([0.0, 90.0, 180.0, -90.0]),
        translate=torch.tensor([[1.0, -2.0], [0.0, 0.0], [-1.0, 0.0],
                                [2.0, 1.0]]),
        flip=torch.tensor([0.0, 1.0, 1.0, 0.0]),
        jitter_gains=torch.tensor([[1.01, 1.3, 0.8], [1.0, 1.0, 1.0],
                                   [0.99, 0.7, 1.2], [1.0, 0.8, 1.1]]),
        do_jitter=torch.tensor([1.0, 0.0, 1.0, 1.0]))

    def draw(generator, batch, sizes_hw, cfg):
        return pipeline.AugmentParams(**{k: v.to(sizes_hw.device)
                                         for k, v in vars(params).items()})

    monkeypatch.setattr(steps, "draw_augment_params", draw)
    rng = np.random.RandomState(15)
    batch = {
        "canvas": rng.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8),
        "orig_to_canvas": np.tile(np.array([[1.0, 0, 1 / 3], [0, 1.0, 1 / 3]],
                                           np.float32), (b, 1, 1)),
        "sizes_hw": np.full((b, 2), 60.0, np.float32),
        "joints": rng.uniform(10, 50, (b, 21, 2)).astype(np.float32),
        "joints_vis": np.ones((b, 21), np.float32),
        "label": rng.randint(0, 19, (b,)).astype(np.int64),
    }

    def counts():
        return (A.fused_attention_qkv.launches,
                A.fused_attention_qkv_bwd.launches, W.warp_twopass.launches,
                B.bn_act_reduce.launches, B.bn_act_elem.launches)

    out = {}
    for dev in ("cpu", "cuda"):
        model = MultiTaskNet(image_size=(48, 48),
                             generator=torch.Generator().manual_seed(3))
        state = create_train_state(model, device=dev)
        step = steps.make_train_step(
            AugmentConfig(), image_size=(48, 48), heatmap_size=(12, 12),
            grad_demix=True, debug_return_grads=True, warp_method="kernel")
        before = counts()
        _, m = step(state, batch, torch.Generator(device=dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            # 22 ConvBnAct layers x 2 pullbacks on the fused route
            bn = 44 if fused else 0
            assert tuple(a - b for a, b in zip(counts(), before)) == (
                4, 8, 1, bn, bn)
        out[dev] = m
    for k in ("total_loss", "class_loss", "joints_loss"):
        np.testing.assert_allclose(float(out["cuda"][k]),
                                   float(out["cpu"][k]), rtol=1e-4)
    g_card, g_cpu = out["cuda"]["_grads"], out["cpu"]["_grads"]
    assert g_card.keys() == g_cpu.keys()
    for k, w in g_cpu.items():
        err = float((g_card[k].cpu() - w).norm() / w.norm().clamp_min(1e-12))
        assert err <= 1e-3, (k, err)


@pytest.mark.gpu
def test_f32_train_step_on_card_matches_cpu(monkeypatch):
    _card_vs_cpu_step(monkeypatch, fused=False)


@pytest.mark.gpu
def test_f32_fused_bn_train_step_on_card_matches_cpu(monkeypatch):
    _card_vs_cpu_step(monkeypatch, fused=True)


# -- the split-operand attention kernels (tensor-parallel form) ---------------


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [H, H // 2])
@pytest.mark.parametrize("layout", ["views", "contiguous", "unaligned"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_split_kernels_match_plain_versions_and_packed_kernels(heads, layout,
                                                              dtype):
    """Forward and backward against their plain versions, and bit for bit
    against the packed kernels on the same data (one kernel body). The
    unaligned operands (views one element into a tensor) take the
    kernels' element-wise staging instead of the 16-byte loads."""
    _cuda_or_skip()
    hd = heads * D
    rng = np.random.RandomState(heads + len(layout))
    dt = getattr(torch, dtype)
    base = torch.from_numpy(rng.randn(3, 37, 3 * hd + 1).astype(
        np.float32)).to("cuda", dt)
    qkv = base[..., 1:].contiguous()
    g = torch.from_numpy(rng.randn(3, 37, hd).astype(np.float32)).to(
        "cuda", dt)
    ops = {"views": qkv.chunk(3, dim=-1),
           "contiguous": tuple(t.contiguous() for t in qkv.chunk(3, dim=-1)),
           "unaligned": base[..., 1:].chunk(3, dim=-1)}[layout]
    before = (A.fused_attention_split.launches,
              A.fused_attention_split_bwd.launches)
    out = A.fused_attention_split(*ops, heads, D, SCALE)
    d = A.fused_attention_split_bwd(*ops, g, heads, D, SCALE)
    torch.cuda.synchronize()
    assert (A.fused_attention_split.launches,
            A.fused_attention_split_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        A.attention_split_reference(*ops, heads, D, SCALE).float().cpu()
        .numpy(), **TOL[dtype])
    for got, want in zip(d, A.attention_split_bwd_reference(*ops, g, heads,
                                                            D, SCALE)):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **GRAD_TOL[dtype])
    assert torch.equal(out, A.fused_attention_qkv(qkv, heads, D, SCALE))
    packed = A.fused_attention_qkv_bwd(qkv, g, heads, D, SCALE)
    for got, want in zip(d, packed.chunk(3, dim=-1)):
        assert torch.equal(got, want)


# -- the bf16 tensor-core bodies ---------------------------------------------


def _bf16(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to("cuda", torch.bfloat16)


def _assert_fwd_bwd_match_plain(ops, g, heads):
    """Split forward and backward on ``ops`` against their plain versions,
    outputs finite; returns the kernels' (out, (dq, dk, dv))."""
    out = A.fused_attention_split(*ops, heads, D, SCALE)
    d = A.fused_attention_split_bwd(*ops, g, heads, D, SCALE)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and all(torch.isfinite(t).all()
                                             for t in d)
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        A.attention_split_reference(*ops, heads, D, SCALE).float().cpu()
        .numpy(), **TOL["bfloat16"])
    for got, want in zip(d, A.attention_split_bwd_reference(*ops, g, heads,
                                                            D, SCALE)):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **GRAD_TOL["bfloat16"])
    return out, d


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 15, 16, 17, 37, 145, 160, 161, 384])
@pytest.mark.parametrize("heads", [4, 8])
@pytest.mark.parametrize("b", [1, 3])
def test_bf16_bodies_match_plain_versions_and_split_equals_packed(n, heads,
                                                                  b):
    """Every padding case of the 16-row tiles (n below, at and above a
    multiple of 16, one and several 160-key chunks of the forward): the
    packed kernels against their plain versions, and the split kernels on
    the chunk views equal to them bit for bit."""
    _cuda_or_skip()
    qkv = _bf16((b, n, 3 * heads * D), seed=n + 10 * heads + b)
    g = _bf16((b, n, heads * D), seed=n + 10 * heads + b + 1)
    out = A.fused_attention_qkv(qkv, heads, D, SCALE)
    d = A.fused_attention_qkv_bwd(qkv, g, heads, D, SCALE)
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        A.attention_qkv_reference(qkv, heads, D, SCALE).float().cpu()
        .numpy(), **TOL["bfloat16"])
    np.testing.assert_allclose(
        d.float().cpu().numpy(),
        A.attention_qkv_bwd_reference(qkv, g, heads, D, SCALE).float().cpu()
        .numpy(), **GRAD_TOL["bfloat16"])
    s_out, s_d = _assert_fwd_bwd_match_plain(qkv.chunk(3, dim=-1), g, heads)
    assert torch.equal(s_out, out)
    for got, want in zip(s_d, d.chunk(3, dim=-1)):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [17, 145])
def test_bf16_unaligned_operands_stage_element_wise_to_the_same_bits(n):
    """Operands one element into their storage (not 16-byte aligned, odd
    row stride) take the element-wise staging into the same shared layout
    as the cp.async copies: the same outputs bit for bit."""
    _cuda_or_skip()
    base = _bf16((2, n, 3 * H * D + 1), seed=n)
    g = _bf16((2, n, H * D), seed=n + 1)
    unaligned = base[..., 1:].chunk(3, dim=-1)
    aligned = tuple(t.contiguous() for t in unaligned)
    out_u, d_u = _assert_fwd_bwd_match_plain(unaligned, g, H)
    out_a, d_a = _assert_fwd_bwd_match_plain(aligned, g, H)
    assert torch.equal(out_u, out_a)
    for got, want in zip(d_u, d_a):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [15, 145])
def test_bf16_views_never_read_past_row_n(n):
    """q, k, v and g as views of the first n rows of buffers that hold NaN
    in every row beyond: the kernels read rows below n only and zero their
    own pad rows, so the outputs are finite and equal those of contiguous
    copies."""
    _cuda_or_skip()
    pad = 16
    qkv = _bf16((3, n, 3 * H * D), seed=2 * n)
    g = _bf16((3, n, H * D), seed=2 * n + 1)
    big = torch.full((3, n + pad, 3 * H * D), float("nan"), device="cuda",
                     dtype=torch.bfloat16)
    big[:, :n] = qkv
    big_g = torch.full((3, n + pad, H * D), float("nan"), device="cuda",
                       dtype=torch.bfloat16)
    big_g[:, :n] = g
    views = big[:, :n].chunk(3, dim=-1)
    out, d = _assert_fwd_bwd_match_plain(views, big_g[:, :n], H)
    assert torch.equal(out, A.fused_attention_qkv(qkv, H, D, SCALE))
    for got, want in zip(d, A.fused_attention_qkv_bwd(qkv, g, H, D, SCALE)
                         .chunk(3, dim=-1)):
        assert torch.equal(got, want)


def _last_whole(kernel, dtype, head_dim=D):
    """The largest n the whole-sequence route of ``kernel`` takes at
    ``head_dim`` (32: the model's) in ``dtype``."""
    n = 1
    while A.kernel_route(kernel, n + 1, head_dim, dtype) == 0:
        n += 1
    return n


# the bytes of dynamic shared memory one H100 SM offers its blocks, and
# what each resident block reserves (the kernels' route rule)
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024


def _holds_two(kernel, n, dtype, blocks=2):
    """Whether an SM holds two (or ``blocks``) whole-sequence blocks at
    length n: the whole route's shared memory per padded row (read at a
    length where that route runs) times pad16(n)."""
    lib = A._kernel() if kernel == "fwd" else A._bwd_kernel()
    smem = getattr(lib, f"attention_qkv_{kernel}_smem_bytes")
    per_row = smem(16, A._DTYPE_CODES[dtype], D) // 16
    whole = per_row * (-(-n // 16) * 16)
    return SMEM_PER_SM // (whole + SMEM_RESERVED) >= blocks


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_every_length_routes_and_matches(dtype):
    """No length is refused. The whole-sequence route runs where the rule
    says it pays: the forward while one register chunk holds the sequence
    (160 keys at head_dim 32), the backward while an SM holds two of its
    blocks (four in bf16, against the ring bodies: 160 keys at head_dim
    32); the model's N = 145 stays on it. At the last length each kernel
    takes whole, and one row more (the key-chunked route), both routes
    match the plain versions with a launch counted each, and give the
    same bits as each other (``launch_on_route``)."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    n_fwd, n_bwd = _last_whole("fwd", dt), _last_whole("bwd", dt)
    assert n_fwd == 160 and n_bwd >= 145
    blocks = 4 if dtype == "bfloat16" else 2
    assert _holds_two("bwd", n_bwd, dt, blocks) and not _holds_two(
        "bwd", n_bwd + 1, dt, blocks)
    for kernel, last in (("fwd", n_fwd), ("bwd", n_bwd)):
        for n in (last, last + 1):
            x = _qkv(1, n, 3, dtype)[..., :3 * D].contiguous()
            g = torch.randn(1, n, D, device="cuda").to(dt)
            counter = (A.fused_attention_qkv if kernel == "fwd"
                       else A.fused_attention_qkv_bwd)
            before = counter.launches
            if kernel == "fwd":
                got = A.fused_attention_qkv(x, 1, D, SCALE)
                want = A.attention_qkv_reference(x, 1, D, SCALE)
            else:
                got = A.fused_attention_qkv_bwd(x, g, 1, D, SCALE)
                want = A.attention_qkv_bwd_reference(x, g, 1, D, SCALE)
            assert counter.launches == before + 1
            np.testing.assert_allclose(
                got.float().cpu().numpy(), want.float().cpu().numpy(),
                **(TOL if kernel == "fwd" else GRAD_TOL)[dtype])
            routes = [A.launch_on_route(kernel, r, x, 1, D, SCALE,
                                        g if kernel == "bwd" else None)
                      for r in (0, 1)]
            assert torch.equal(routes[0], routes[1])
            assert torch.equal(got, routes[0])
        assert A.kernel_route(kernel, last, D, dt) == 0
        assert A.kernel_route(kernel, last + 1, D, dt) == 1


# the lengths of chip_smoke's route sweep (both routes timed there)
ROUTE_SWEEP = [("fwd", n) for n in (145, 193, 257, 401, 481, 577, 689, 785,
                                    961)
               ] + [("bwd", n) for n in (145, 161, 193, 257, 401, 481, 577,
                                         688)]
# lengths at the key-chunked ring bodies' edges: 16-row tiles and blocks
# (127-129, 255-257, 1025: a last tile of one query row; 785 = 7 x 112 +
# 1, in the sweep for the forward: a last block of one query row), the
# forward's 160-key chunks (160, 161, 321) and the backward's 64-row
# chunks (64, 65, 193), and ring buffers reused (every length past two
# chunks)
RING_EDGES = [(kernel, n) for kernel, lengths in (
    ("fwd", (127, 128, 129, 160, 161, 255, 321, 1025)),
    ("bwd", (64, 65, 127, 128, 129, 255, 785, 1025))) for n in lengths]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kernel,n", ROUTE_SWEEP + RING_EDGES)
def test_routes_give_the_same_bits_at_the_sweep_lengths(kernel, n, dtype):
    """At each length of the route sweep, 2 images of the model's 8 heads:
    the whole-sequence route (where one block holds the head) and the
    key-chunked route give the same bits, and the entry point gives
    those of the route it takes."""
    _cuda_or_skip()
    dt = getattr(torch, dtype)
    x = _qkv(2, n, n, dtype)
    g = torch.from_numpy(np.random.RandomState(n + 1).randn(2, n, H * D)
                         .astype(np.float32)).to("cuda", dt)
    cot = g if kernel == "bwd" else None
    outs = {}
    for r in (0, 1):
        try:
            outs[r] = A.launch_on_route(kernel, r, x, H, D, SCALE, cot)
        except ValueError:  # the head does not fit one block
            assert r == 0
    entry = (A.fused_attention_qkv(x, H, D, SCALE) if kernel == "fwd"
             else A.fused_attention_qkv_bwd(x, g, H, D, SCALE))
    assert torch.equal(entry, outs[A.kernel_route(kernel, n, D, dt)])
    if 0 in outs:
        assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
def test_routed_launch_refuses_a_route_that_does_not_exist():
    """``launch_on_route`` raises for a whole-sequence route at padded
    width 256 (none is built there), before any launch is counted."""
    _cuda_or_skip()
    x = torch.zeros(1, 17, 3 * 2 * 256, device="cuda")
    before = A.fused_attention_qkv.launches
    with pytest.raises(ValueError, match="route 0"):
        A.launch_on_route("fwd", 0, x, 2, 256, 256 ** -0.5)
    assert A.fused_attention_qkv.launches == before
    A.launch_on_route("fwd", 1, x, 2, 256, 256 ** -0.5)
    assert A.fused_attention_qkv.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("head_dim", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("n", [385, 401, 689, 785, 961, 1025, 127, 128, 129,
                               255, 257])
def test_kernels_match_plain_versions_at_any_length_and_width(n, head_dim,
                                                               dtype):
    """Packed and split, forward and backward, against the plain versions
    at lengths on both sides of each body's shared-memory limit and at
    every padded head width (48 pads to 64); the split kernels on the
    chunk views equal the packed ones bit for bit."""
    _cuda_or_skip()
    heads = 2
    hd = heads * head_dim
    scale = head_dim**-0.5
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(n * 7 + head_dim)
    qkv = torch.from_numpy(rng.randn(2, n, 3 * hd).astype(np.float32)).to(
        "cuda", dt)
    g = torch.from_numpy(rng.randn(2, n, hd).astype(np.float32)).to(
        "cuda", dt)
    out = A.fused_attention_qkv(qkv, heads, head_dim, scale)
    d = A.fused_attention_qkv_bwd(qkv, g, heads, head_dim, scale)
    ops = qkv.chunk(3, dim=-1)
    s_out = A.fused_attention_split(*ops, heads, head_dim, scale)
    s_d = A.fused_attention_split_bwd(*ops, g, heads, head_dim, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(d).all()
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        A.attention_qkv_reference(qkv, heads, head_dim, scale).float().cpu()
        .numpy(), **TOL[dtype])
    np.testing.assert_allclose(
        d.float().cpu().numpy(),
        A.attention_qkv_bwd_reference(qkv, g, heads, head_dim, scale)
        .float().cpu().numpy(), **GRAD_TOL[dtype])
    assert torch.equal(s_out, out)
    for got, want in zip(s_d, d.chunk(3, dim=-1)):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_split_equals_packed_at_the_448_px_shape(dtype):
    """At the 448 px path's (64, 785) with the model's 8 heads of 32 (the
    key-chunked route), the split kernels on the chunk views give the
    packed kernels' bits, forward and backward."""
    _cuda_or_skip()
    x = _qkv(64, 785, 785, dtype)
    g = torch.from_numpy(np.random.RandomState(786).randn(64, 785, H * D)
                         .astype(np.float32)).to("cuda", getattr(torch,
                                                                 dtype))
    assert A.kernel_route("fwd", 785, D, x.dtype) == 1
    assert A.kernel_route("bwd", 785, D, x.dtype) == 1
    ops = x.chunk(3, dim=-1)
    assert torch.equal(A.fused_attention_split(*ops, H, D, SCALE),
                       A.fused_attention_qkv(x, H, D, SCALE))
    d = A.fused_attention_qkv_bwd(x, g, H, D, SCALE)
    for got, want in zip(A.fused_attention_split_bwd(*ops, g, H, D, SCALE),
                         d.chunk(3, dim=-1)):
        assert torch.equal(got, want)


# the ring forward at padded head widths 16 and 64, at lengths on the
# edges of its chunks of keys (96 at Dp = 64: one chunk, a key past it,
# two chunks and a key; 160 at Dp = 16: one, a key past it, two and a
# key) and the 448 px path's 785 (5 and 9 chunks: every ring buffer
# reused, a last block of one query row)
RING_WIDTH_EDGES = [(64, n) for n in (95, 96, 97, 193, 785)] + [
    (16, n) for n in (160, 161, 321, 785)]


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim,n", RING_WIDTH_EDGES)
def test_ring_forward_at_head_widths_16_and_64(head_dim, n):
    """The bf16 key-chunked route at padded head widths 16 and 64 is the
    ring body. On that route (``launch_on_route``, also at lengths where
    the entry point takes the whole-sequence body) it matches the plain
    version; the whole-sequence route, where one exists, gives its bits;
    the entry point gives them, and so do the split operands."""
    _cuda_or_skip()
    heads, scale, bf = 2, head_dim**-0.5, torch.bfloat16
    rng = np.random.RandomState(n * 5 + head_dim)
    qkv = torch.from_numpy(rng.randn(2, n, 3 * heads * head_dim).astype(
        np.float32)).to("cuda", bf)
    route = A.kernel_route("fwd", n, head_dim, bf)
    assert A.forward_body(n, head_dim, bf) == (
        "attention_fwd_mma_ring_kernel" if route == 1
        else "attention_fwd_mma_kernel")
    before = A.fused_attention_qkv.launches
    ring = A.launch_on_route("fwd", 1, qkv, heads, head_dim, scale)
    torch.cuda.synchronize()
    assert A.fused_attention_qkv.launches == before + 1
    np.testing.assert_allclose(
        ring.float().cpu().numpy(),
        A.attention_qkv_reference(qkv, heads, head_dim, scale).float().cpu()
        .numpy(), **TOL["bfloat16"])
    try:
        whole = A.launch_on_route("fwd", 0, qkv, heads, head_dim, scale)
    except ValueError:  # the head does not fit one block
        whole = ring
    assert torch.equal(whole, ring)
    entry = A.fused_attention_qkv(qkv, heads, head_dim, scale)
    assert torch.equal(entry, ring)
    assert torch.equal(A.fused_attention_split(*qkv.chunk(3, dim=-1), heads,
                                               head_dim, scale), entry)


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim,last", [(16, 160), (64, 96)])
def test_forward_crossover_at_head_widths_16_and_64(head_dim, last):
    """chip_smoke's route sweep at 16 heads of 16 and 4 of 64 put the
    forward's crossover where the rule takes it: the whole-sequence body
    while one register chunk of keys (160 at padded width 16, 96 at 64)
    holds the sequence, the ring body from one key past it. At the last
    whole length and one past it both routes give the same bits and the
    entry point those of its route."""
    _cuda_or_skip()
    bf, scale = torch.bfloat16, head_dim**-0.5
    assert _last_whole("fwd", bf, head_dim) == last
    for n in (last, last + 1):
        x = torch.from_numpy(np.random.RandomState(n).randn(
            1, n, 3 * head_dim).astype(np.float32)).to("cuda", bf)
        routes = [A.launch_on_route("fwd", r, x, 1, head_dim, scale)
                  for r in (0, 1)]
        assert torch.equal(routes[0], routes[1])
        route = A.kernel_route("fwd", n, head_dim, bf)
        assert route == (0 if n == last else 1)
        assert torch.equal(A.fused_attention_qkv(x, 1, head_dim, scale),
                           routes[route])
        assert A.forward_body(n, head_dim, bf) == (
            "attention_fwd_mma_kernel" if n == last
            else "attention_fwd_mma_ring_kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim,body", [
    (16, "attention_fwd_mma_ring_kernel"),
    (32, "attention_fwd_mma_ring_kernel"),
    (48, "attention_fwd_mma_ring_kernel"),
    (64, "attention_fwd_mma_ring_kernel"),
    (128, "attention_fwd_mma_ring_kernel"),
    (256, "attention_fwd_mma_ring_kernel"), (320, "wide_fwd_kernel")])
def test_forward_body_at_the_448_px_length(head_dim, body):
    """At N = 785 the bf16 forward runs the ring body at every padded width
    up to 256, and route 2 above; f32 takes its key-chunked kernel below
    257."""
    _cuda_or_skip()
    assert A.forward_body(785, head_dim, torch.bfloat16) == body
    if head_dim <= 256:
        assert A.forward_body(785, head_dim, torch.float32) == (
            "attention_fwd_tf32_long_kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [16, 32, 64, 100, 128, 192, 256, 320])
def test_backward_body_at_the_448_px_length(head_dim):
    """At N = 785 the bf16 backward runs the ring pair at every padded
    width up to 256, and route 2's pair above; f32 its key-chunked pair."""
    _cuda_or_skip()
    wide = head_dim > 256
    assert A.backward_body(785, head_dim, torch.bfloat16) == (
        "wide_bwd_{q,k}_kernel" if wide
        else "attention_bwd_mma_ring_{q,k}_kernel")
    assert A.backward_body(785, head_dim, torch.float32) == (
        "wide_bwd_{q,k}_kernel" if wide
        else "attention_bwd_tf32_{q,k}_kernel")


# the ring pair at padded head widths 128 and 256 (100 pads to 128 and
# stages element by element; 192 pads to 256), at lengths on the edges of
# their chunks (48 keys in the forward at Dp = 128, 32 at 256; 32 rows in
# the backward at both), past the key kernel's blocks of 3 and 4 key
# tiles and the query kernels' 7 tiles (113: 8 tiles), at the 448 px
# path's 785 and chip_smoke's wide-head step's 145
RING_WIDE_EDGES = [(d, n) for d in (128, 256) for n in (
    31, 32, 33, 47, 48, 49, 97, 113, 145, 785)] + [
    (d, n) for d in (100, 192) for n in (33, 97, 145)]


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim,n", RING_WIDE_EDGES)
def test_ring_pair_at_head_widths_128_to_256(head_dim, n):
    """The bf16 key-chunked route at padded widths 128 and 256 is the ring
    forward and the ring backward pair. On that route they match the plain
    versions at the card's tolerances, the entry points give their bits,
    so do the split operands, and at padded width 128 the whole-sequence
    route, wherever it exists, gives the same bits forward and backward."""
    _cuda_or_skip()
    heads, scale, bf = 2, head_dim**-0.5, torch.bfloat16
    rng = np.random.RandomState(n * 11 + head_dim)
    hd = heads * head_dim
    qkv = torch.from_numpy(rng.randn(2, n, 3 * hd).astype(np.float32)).to(
        "cuda", bf)
    g = torch.from_numpy(rng.randn(2, n, hd).astype(np.float32)).to(
        "cuda", bf)
    outs = {}
    for kernel, cot in (("fwd", None), ("bwd", g)):
        for r in (0, 1):
            try:
                outs[kernel, r] = A.launch_on_route(kernel, r, qkv, heads,
                                                    head_dim, scale, cot)
            except ValueError:  # no whole-sequence route here
                assert r == 0
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        outs["fwd", 1].float().cpu().numpy(),
        A.attention_qkv_reference(qkv, heads, head_dim, scale).float().cpu()
        .numpy(), **TOL["bfloat16"])
    np.testing.assert_allclose(
        outs["bwd", 1].float().cpu().numpy(),
        A.attention_qkv_bwd_reference(qkv, g, heads, head_dim, scale)
        .float().cpu().numpy(), **GRAD_TOL["bfloat16"])
    for kernel in ("fwd", "bwd"):
        if (kernel, 0) in outs:
            assert head_dim <= 128
            assert torch.equal(outs[kernel, 0], outs[kernel, 1])
    out = A.fused_attention_qkv(qkv, heads, head_dim, scale)
    d = A.fused_attention_qkv_bwd(qkv, g, heads, head_dim, scale)
    assert torch.equal(out, outs["fwd", A.kernel_route("fwd", n, head_dim,
                                                       bf)])
    assert torch.equal(d, outs["bwd", A.kernel_route("bwd", n, head_dim,
                                                     bf)])
    ops = qkv.chunk(3, dim=-1)
    assert torch.equal(A.fused_attention_split(*ops, heads, head_dim, scale),
                       out)
    for got, want in zip(A.fused_attention_split_bwd(*ops, g, heads,
                                                     head_dim, scale),
                         d.chunk(3, dim=-1)):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [64, 16])
@pytest.mark.parametrize("heads,head_dim", [(16, 16), (4, 64)])
def test_split_equals_packed_at_the_448_px_length_at_widths_16_and_64(
        b, heads, head_dim):
    """At (64, 785) and (16, 785) with 16 heads of 16 and 4 of 64 (the ring
    forward, the ring backward pair), the split kernels on the chunk views
    give the packed kernels' bits, forward and backward, and the forward
    matches the plain version."""
    _cuda_or_skip()
    scale = head_dim**-0.5
    rng = np.random.RandomState(b + heads)
    x = torch.from_numpy(rng.randn(b, 785, 3 * heads * head_dim).astype(
        np.float32)).to("cuda", torch.bfloat16)
    g = torch.from_numpy(rng.randn(b, 785, heads * head_dim).astype(
        np.float32)).to("cuda", torch.bfloat16)
    ops = x.chunk(3, dim=-1)
    out = A.fused_attention_qkv(x, heads, head_dim, scale)
    assert torch.equal(A.fused_attention_split(*ops, heads, head_dim, scale),
                       out)
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        A.attention_qkv_reference(x, heads, head_dim, scale).float().cpu()
        .numpy(), **TOL["bfloat16"])
    d = A.fused_attention_qkv_bwd(x, g, heads, head_dim, scale)
    for got, want in zip(A.fused_attention_split_bwd(*ops, g, heads,
                                                     head_dim, scale),
                         d.chunk(3, dim=-1)):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_head_width_above_128_raises_naming_c2_before_any_launch():
    """Since ROADMAP C2 closed, widths above 256 launch (the bodies of
    attention_wide.cuh, route 2) and only a width below 1 raises, before
    any launch.
    (The name dates from the limit of 128; it is kept so that the test's
    record runs on.)"""
    _cuda_or_skip()
    before = (A.fused_attention_qkv.launches,
              A.fused_attention_split_bwd.launches)
    with pytest.raises(ValueError, match="head_dim >= 1"):
        A.fused_attention_qkv(torch.zeros(1, 9, 0, device="cuda"), 1, 0,
                              SCALE)
    assert (A.fused_attention_qkv.launches,
            A.fused_attention_split_bwd.launches) == before
    A.fused_attention_qkv(torch.zeros(1, 9, 3 * 257, device="cuda"), 1,
                          257, SCALE)
    z = torch.zeros(1, 9, 257, device="cuda")
    A.fused_attention_split_bwd(z, z, z, z, 1, 257, SCALE)
    torch.cuda.synchronize()
    assert (A.fused_attention_qkv.launches,
            A.fused_attention_split_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert A.kernel_route("fwd", 9, 257, torch.float32) == 2
    assert A.kernel_route("bwd", 9, 257, torch.bfloat16) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("head_dim", [160, 192, 256])
@pytest.mark.parametrize("n", [17, 145, 401, 785])
def test_kernels_match_plain_versions_at_head_widths_to_256(n, head_dim,
                                                            dtype):
    """Packed and split, forward and backward, at the widths that pad to
    256 (every length key-chunked there): against the plain versions, and
    the split kernels on the chunk views equal to the packed ones bit for
    bit."""
    _cuda_or_skip()
    heads = 2
    hd = heads * head_dim
    scale = head_dim**-0.5
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(n * 7 + head_dim)
    qkv = torch.from_numpy(rng.randn(2, n, 3 * hd).astype(np.float32)).to(
        "cuda", dt)
    g = torch.from_numpy(rng.randn(2, n, hd).astype(np.float32)).to(
        "cuda", dt)
    out = A.fused_attention_qkv(qkv, heads, head_dim, scale)
    d = A.fused_attention_qkv_bwd(qkv, g, heads, head_dim, scale)
    ops = qkv.chunk(3, dim=-1)
    s_out = A.fused_attention_split(*ops, heads, head_dim, scale)
    s_d = A.fused_attention_split_bwd(*ops, g, heads, head_dim, scale)
    torch.cuda.synchronize()
    assert A.kernel_route("fwd", n, head_dim, dt) == 1
    assert A.kernel_route("bwd", n, head_dim, dt) == 1
    assert torch.isfinite(out).all() and torch.isfinite(d).all()
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        A.attention_qkv_reference(qkv, heads, head_dim, scale).float().cpu()
        .numpy(), **TOL[dtype])
    np.testing.assert_allclose(
        d.float().cpu().numpy(),
        A.attention_qkv_bwd_reference(qkv, g, heads, head_dim, scale)
        .float().cpu().numpy(), **GRAD_TOL[dtype])
    assert torch.equal(s_out, out)
    for got, want in zip(s_d, d.chunk(3, dim=-1)):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("head_dim", [257, 264, 320, 384, 392, 512, 640,
                                      1040])
@pytest.mark.parametrize("n", [17, 145, 785])
def test_kernels_match_plain_versions_at_head_widths_above_256(n, head_dim,
                                                               dtype):
    """The bodies of head widths above 256 (route 2), packed and split,
    forward and backward, against the plain versions at the existing
    tolerances, and the split kernels on the chunk views equal to the
    packed ones bit for bit: widths staged element by element (257),
    bulk-copied with zero padding (264, 392: multiples of 8, not of 64),
    whole 64-feature slices (320, 384, 512), and wider than one staged
    row (640, 1040: the scores summed over feature groups, two and three
    output groups)."""
    _cuda_or_skip()
    heads = 2
    hd = heads * head_dim
    scale = head_dim**-0.5
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(n * 5 + head_dim)
    qkv = torch.from_numpy(rng.randn(2, n, 3 * hd).astype(np.float32)).to(
        "cuda", dt)
    g = torch.from_numpy(rng.randn(2, n, hd).astype(np.float32)).to(
        "cuda", dt)
    out = A.fused_attention_qkv(qkv, heads, head_dim, scale)
    d = A.fused_attention_qkv_bwd(qkv, g, heads, head_dim, scale)
    ops = qkv.chunk(3, dim=-1)
    s_out = A.fused_attention_split(*ops, heads, head_dim, scale)
    s_d = A.fused_attention_split_bwd(*ops, g, heads, head_dim, scale)
    torch.cuda.synchronize()
    assert A.kernel_route("fwd", n, head_dim, dt) == 2
    assert A.kernel_route("bwd", n, head_dim, dt) == 2
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        A.attention_qkv_reference(qkv, heads, head_dim, scale).float().cpu()
        .numpy(), **TOL[dtype])
    np.testing.assert_allclose(
        d.float().cpu().numpy(),
        A.attention_qkv_bwd_reference(qkv, g, heads, head_dim, scale)
        .float().cpu().numpy(), **GRAD_TOL[dtype])
    assert torch.equal(s_out, out)
    for got, want in zip(s_d, d.chunk(3, dim=-1)):
        assert torch.equal(got, want)


# -- the bn reduce kernel at the path's shapes ---------------------------------

# the distinct (H, W, C) of MultiTaskNet small's 22 ConvBnAct layers at
# 192 px (chip_smoke.py's _path_bn_layers lists them in order); each with
# and without the SiLU, as chip_smoke.py checks them
PATH_BN_SHAPES = [(96, 96, 64), (48, 48, 128), (48, 48, 64), (24, 24, 256),
                  (24, 24, 128), (12, 12, 512), (12, 12, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("h,w,c", PATH_BN_SHAPES)
def test_bn_reduce_matches_plain_version_at_path_shapes_deterministically(
        h, w, c, act, dtype):
    """The one-launch reduce at B=256 against its plain version (1e-6 of
    the sum of the terms' magnitudes), and the same bits from two calls."""
    _cuda_or_skip()
    from hgr_tpu_torch.ops import bn_act as B

    gen = torch.Generator(device="cuda").manual_seed(h * 1000 + c)
    dt = getattr(torch, dtype)
    m = 256 * h * w
    y = (torch.randn(m, c, device="cuda", generator=gen) * 2 + 0.3).to(dt)
    g = torch.randn(m, c, device="cuda", generator=gen).to(dt)
    gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
    beta = torch.randn(c, device="cuda", generator=gen) * 0.1
    _, mean, var = B.fwd_chain(y, gamma, beta, 1e-5, act)
    r = torch.rsqrt(var + 1e-5)
    before = B.bn_act_reduce.launches
    t1, t2 = B.bn_act_reduce(y, g, mean, r, gamma, beta, act)
    u1, u2 = B.bn_act_reduce(y, g, mean, r, gamma, beta, act)
    torch.cuda.synchronize()
    assert B.bn_act_reduce.launches == before + 2
    assert torch.equal(t1, u1) and torch.equal(t2, u2)
    p1, p2 = B.bn_act_reduce_reference(y, g, mean, r, gamma, beta, act)
    dz, xhat = B._dz_xhat(y, g, mean, r, gamma, beta, act)
    for got, want, mag in ((t1, p1, dz.abs().sum(0)),
                           (t2, p2, (dz * xhat).abs().sum(0))):
        assert bool(((got - want).abs() <= 1e-6 * mag + 1e-30).all())


# -- the warp routing (C1) -----------------------------------------------------


@pytest.mark.gpu
def test_auto_warp_on_the_card_takes_exact_for_non_square_kernel_for_square():
    """'auto' on a non-square CUDA canvas equals 'exact' (no warp kernel
    launch); on a square one it launches the kernel once."""
    _cuda_or_skip()
    from hgr_tpu_torch.data import pipeline
    from hgr_tpu_torch.ops import warp_fused as W

    rng = np.random.RandomState(41)
    b = 4
    p = pipeline.AugmentParams(
        scale=torch.full((b,), 1.1), rot=torch.tensor([0.0, 25.0, -80, 95]),
        translate=torch.zeros(b, 2), flip=torch.tensor([0.0, 1.0, 1.0, 0.0]),
        jitter_gains=torch.from_numpy(rng.uniform(0.8, 1.2, (b, 3)).astype(
            np.float32)), do_jitter=torch.tensor([1.0, 0.0, 1.0, 1.0]))
    p = pipeline.AugmentParams(**{k: v.cuda() for k, v in vars(p).items()})

    def run(canvas, method):
        return pipeline.apply_augment_batch(
            canvas, torch.eye(2, 3, device="cuda").expand(b, 2, 3),
            torch.full((b, 2), 60.0, device="cuda"),
            torch.full((b, 21, 2), 30.0, device="cuda"),
            torch.ones(b, 21, device="cuda"), p, image_size=(48, 48),
            heatmap_size=(12, 12), warp_method=method)

    wide = torch.from_numpy(rng.randint(0, 256, (b, 64, 80, 3)).astype(
        np.uint8)).cuda()
    before = W.warp_twopass.launches
    got, want = run(wide, "auto"), run(wide, "exact")
    assert W.warp_twopass.launches == before
    for k in got:
        assert torch.equal(got[k], want[k]), k
    square = wide[:, :, :64].contiguous()
    run(square, "auto")
    assert W.warp_twopass.launches == before + 1


# -- multi-rank steps on the card ----------------------------------------------

MESH_B = 8


def _mesh_inputs():
    """A staged batch of MESH_B and its augment draw: 60 px images a third
    of a pixel off the grid at one canvas pixel per output pixel (the
    step tests above), so the card and the CPU see the same images."""
    rng = np.random.RandomState(21)
    b = MESH_B
    batch = {
        "canvas": rng.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8),
        "orig_to_canvas": np.tile(np.array([[1.0, 0, 1 / 3], [0, 1.0, 1 / 3]],
                                           np.float32), (b, 1, 1)),
        "sizes_hw": np.full((b, 2), 60.0, np.float32),
        "joints": rng.uniform(10, 50, (b, 21, 2)).astype(np.float32),
        "joints_vis": np.ones((b, 21), np.float32),
        "label": rng.randint(0, 19, (b,)).astype(np.int64),
    }
    params = dict(
        scale=np.full(b, 48.0 / 21.0, np.float32),
        rot=np.tile(np.array([0.0, 90.0, 180.0, -90.0], np.float32), b // 4),
        translate=np.tile(np.array([[1.0, -2.0], [0.0, 0.0], [-1.0, 0.0],
                                    [2.0, 1.0]], np.float32), (b // 4, 1)),
        flip=np.tile(np.array([0.0, 1.0], np.float32), b // 2),
        jitter_gains=np.ones((b, 3), np.float32),
        do_jitter=np.zeros(b, np.float32))
    return batch, params


def _mesh_step(batch, params, mesh=None):
    """One f32 de-mixed step at 48x48 (the data ranks' hooks with a mesh):
    (loss, full gradients on the CPU)."""
    from hgr_tpu_torch.config import AugmentConfig
    from hgr_tpu_torch.data import pipeline
    from hgr_tpu_torch.models import MultiTaskNet
    from hgr_tpu_torch.parallel import steps as psteps
    from hgr_tpu_torch.parallel.mesh import shard_batch
    from hgr_tpu_torch.train import steps
    from hgr_tpu_torch.train.state import create_train_state

    steps.draw_augment_params = lambda gen, b, sizes, cfg: \
        pipeline.AugmentParams(**{k: torch.from_numpy(v[:b]).to(sizes.device)
                                  for k, v in params.items()})
    state = create_train_state(MultiTaskNet(
        image_size=(48, 48), generator=torch.Generator().manual_seed(3)),
        device=torch.device("cuda", torch.cuda.current_device()))
    kw = dict(image_size=(48, 48), heatmap_size=(12, 12), grad_demix=True,
              debug_return_grads=True, warp_method="kernel")
    if mesh is None:
        step = steps.make_train_step(AugmentConfig(), **kw)
    else:
        state = psteps.shard_state(state, mesh)
        step = psteps.make_parallel_train_step(mesh, AugmentConfig(), **kw)
        batch = shard_batch(batch, mesh)
    _, m = step(state, batch, torch.Generator(device=state.device))
    return float(m["total_loss"]), {k: v.cpu() for k, v in
                                    m["_grads"].items()}


def _dp_rank(rank, world, port, backend, out_path):
    from hgr_tpu_torch.parallel import distributed
    from hgr_tpu_torch.parallel.mesh import make_mesh

    _cuda_or_skip()
    torch.cuda.set_device(rank % torch.cuda.device_count())
    distributed.initialize(f"127.0.0.1:{port}", world, rank, backend)
    try:
        out = _mesh_step(*_mesh_inputs(), make_mesh({"data": world}))
        if rank == 0:
            torch.save(out, out_path)
    finally:
        distributed.shutdown()


def _dp_vs_single(tmp_path, backend):
    import torch.multiprocessing as mp

    from hgr_tpu_torch.parallel.distributed import free_port

    out_path = str(tmp_path / "rank0.pt")
    mp.start_processes(_dp_rank, args=(2, free_port(), backend, out_path),
                       nprocs=2, join=True, start_method="spawn")
    loss_r, g_r = torch.load(out_path, weights_only=False)
    loss_1, g_1 = _mesh_step(*_mesh_inputs())
    np.testing.assert_allclose(loss_r, loss_1, rtol=1e-5)
    assert g_r.keys() == g_1.keys()
    for k, w in g_1.items():
        err = float((g_r[k] - w).norm() / w.norm().clamp_min(1e-12))
        assert err <= 1e-3, (k, err)


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_match_the_single_process_step(tmp_path):
    """Two data ranks sharing the card over gloo (f32, TF32 off): the
    step equals the single-process step at the global batch; per-tensor
    relative gradient error 1e-3 (sums in another order)."""
    _cuda_or_skip()
    _dp_vs_single(tmp_path, "gloo")


@pytest.mark.gpu
def test_two_nccl_ranks_on_two_cards_match_the_single_process_step(tmp_path):
    _cuda_or_skip()
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs a card per rank; this host has fewer than 2")
    _dp_vs_single(tmp_path, "nccl")


# -- two-stage detection on the card -------------------------------------------

DET_FIXTURE = "tests/fixtures/yolo_smoke_weights.npz"


def _detect_pipelines(dtype):
    import os

    from hgr_tpu_torch.config import DEFAULT_NAMES
    from hgr_tpu_torch.infer.detect import HandGesturePipeline
    from hgr_tpu_torch.infer.weights import (
        load_classifier_weights,
        load_detector_weights,
    )

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cls = load_classifier_weights("", (64, 64), seed=0)
    det = load_detector_weights(os.path.join(here, DET_FIXTURE))
    return [HandGesturePipeline(cls, det, DEFAULT_NAMES, det_img_size=160,
                                cls_img_size=(64, 64), score_thresh=-1.0,
                                dtype=dtype, device=dev)
            for dev in ("cuda", "cpu")]


@pytest.mark.gpu
def test_detect_pipeline_on_card_matches_cpu():
    """The f32 pipeline on the card against the same pipeline on the CPU
    (TF32 off): the letterboxed input equal, detector heads 1e-3 (f32
    sums through ~58 convs in another order), boxes and labels equal;
    the classifier forward launches the attention kernel 4 times a
    batch."""
    _cuda_or_skip()
    card, cpu = _detect_pipelines(torch.float32)
    frames = np.random.RandomState(0).randint(0, 256, (4, 180, 320, 3),
                                              np.uint8)
    with torch.inference_mode():
        x_card = card.letterbox(torch.from_numpy(frames).cuda().float())
        x_cpu = cpu.letterbox(torch.from_numpy(frames).float())
        assert torch.equal(x_card.cpu(), x_cpu)
        for a, b in zip(card.detector(x_card), cpu.detector(x_cpu)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       atol=1e-3, rtol=1e-3)
    before = A.fused_attention_qkv.launches
    got, want = card.infer_frames(frames), cpu.infer_frames(frames)
    assert A.fused_attention_qkv.launches == before + 4
    for g, w in zip(got, want):
        assert g["label"] == w["label"]
        np.testing.assert_array_equal(g["box"], w["box"])


@pytest.mark.gpu
def test_detect_over_http_on_card_with_jpeg_and_npy_bodies():
    """POST /detect on the card, bf16, through the port's handler and a
    DetectorService: a .npy body and a PIL JPEG body of the same frame
    both answer 200 with a box and 21 landmarks, and the .npy answer is
    the direct pipeline's."""
    import io
    import json
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from PIL import Image

    from hgr_tpu_torch.cli.serve import make_handler
    from hgr_tpu_torch.serve import DetectorService

    _cuda_or_skip()
    card, _ = _detect_pipelines(torch.bfloat16)
    det = DetectorService(card, (180, 320), max_batch=2, max_wait_ms=5.0)

    class _Null:
        class metrics:  # noqa: N801 — the classifier service's slot
            snapshot = staticmethod(dict)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(_Null, det))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    frame = np.random.RandomState(1).randint(0, 256, (180, 320, 3),
                                             np.uint8)
    npy, jpeg = io.BytesIO(), io.BytesIO()
    np.save(npy, frame)
    Image.fromarray(np.ascontiguousarray(frame[..., ::-1])).save(
        jpeg, format="JPEG", quality=90)
    try:
        answers = []
        for body in (npy.getvalue(), jpeg.getvalue()):
            req = urllib.request.Request(f"{base}/detect", data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
                answers.append(json.loads(r.read())["detection"])
        for d in answers:
            assert len(d["box"]) == 4
            assert np.asarray(d["landmarks"]).shape == (21, 2)
        direct = card.infer_frame(frame)
        assert answers[0]["label"] == direct["label"]
        assert answers[0]["box"] == np.asarray(direct["box"],
                                               np.float64).tolist()
    finally:
        httpd.shutdown()
        httpd.server_close()
        det.stop()


# -- int8 serving and export -------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,cin,cout,k,s", [(1, 3, 3, 64, 3, 2),
                                              (2, 96, 3, 64, 3, 2),
                                              (2, 48, 128, 64, 3, 1),
                                              (1, 4, 64, 8, 1, 1),
                                              (4, 24, 256, 512, 3, 2)])
def test_int8_conv_on_card_equals_cpu_and_plain_version(b, h, cin, cout, k,
                                                        s):
    """torch._int_mm on the card (cuBLASLt) behind the route's padding:
    the same int32 accumulators as the CPU and the float64 plain version,
    at the stem's depth 27 and below 17 rows too."""
    _cuda_or_skip()
    from hgr_tpu_torch.ops.int8_conv import conv_int8, conv_int8_reference

    rng = np.random.RandomState(b + h + cin + k)
    xq = torch.from_numpy(rng.randint(-127, 128, (b, h, h, cin), np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (k, k, cin, cout),
                                      np.int8))
    cpu = conv_int8(xq, wq, s, k // 2)
    card = conv_int8(xq.cuda(), wq.cuda(), s, k // 2)
    plain = conv_int8_reference(xq.cuda(), wq.cuda(), s, k // 2)
    torch.cuda.synchronize()
    assert torch.equal(card.cpu(), cpu) and torch.equal(card, plain)


def _int8_model(px=64):
    from hgr_tpu_torch.infer.quant import quantize_model
    from hgr_tpu_torch.models import MultiTaskNet

    model = MultiTaskNet(image_size=(px, px)).eval()
    x = torch.from_numpy(np.random.RandomState(3).randn(
        4, px, px, 3).astype(np.float32))
    return quantize_model(model, [x], need_attnmap=False), x


@pytest.mark.gpu
def test_int8_model_on_card_matches_cpu_and_launches_kernel():
    _cuda_or_skip()
    model, x = _int8_model()
    with torch.inference_mode():
        want = model(x, need_attnmap=False)[0]
        model = model.to("cuda")
        before = A.fused_attention_qkv.launches
        got = model(x.cuda(), need_attnmap=False)[0]
        torch.cuda.synchronize()
    assert A.fused_attention_qkv.launches == before + 4
    # chip_smoke.py INT8_MODEL_TOL: the f32 card forward's 1e-3
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_exported_program_on_card_runs_the_kernel(tmp_path, int8):
    _cuda_or_skip()
    from hgr_tpu_torch.infer.export import (
        export_program,
        load_program,
        make_inference_fn,
        program_ops,
    )
    from hgr_tpu_torch.models import MultiTaskNet

    if int8:
        model, x = _int8_model()
    else:
        model = MultiTaskNet(image_size=(64, 64)).eval()
        x = torch.from_numpy(np.random.RandomState(3).randn(
            4, 64, 64, 3).astype(np.float32))
    model = model.to("cuda")
    path = export_program(model, str(tmp_path / "m.pt2"), batch=4)
    loaded = load_program(path)
    assert program_ops(loaded)["hgr_tpu_torch.attention_qkv_fwd.default"] \
        == 4
    with torch.inference_mode():
        want = make_inference_fn(model)(x.cuda())
        before = A.fused_attention_qkv.launches
        got = loaded(x.cuda())
        torch.cuda.synchronize()
    assert A.fused_attention_qkv.launches == before + 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   atol=1e-5)


@pytest.mark.gpu
def test_attention_operator_launches_the_kernel():
    _cuda_or_skip()
    x = _qkv(8, 145, 12, "bfloat16")
    before = A.fused_attention_qkv.launches
    got = torch.ops.hgr_tpu_torch.attention_qkv_fwd(x, H, D, SCALE)
    torch.cuda.synchronize()
    assert A.fused_attention_qkv.launches == before + 1
    assert torch.equal(got, A.fused_attention_qkv(x, H, D, SCALE))


@pytest.mark.gpu
def test_build_classifier_defaults_to_the_card():
    _cuda_or_skip()
    from hgr_tpu_torch.infer.weights import (
        build_classifier,
        load_classifier_weights,
    )

    m = build_classifier(load_classifier_weights("", (48, 48)), (48, 48))
    assert {p.device.type for p in m.parameters()} == {"cuda"}


def _rel_err(a, b):
    a, b = a.detach().float().cpu(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


@pytest.mark.gpu
def test_detector_train_step_on_card_matches_cpu():
    """An f32 detector step at B = 2, 416 px on the card (TF32 off)
    against the CPU from the same weights: the loss 1e-4 relative, the
    new running statistics 1e-4. f32 itself moves this model's gradients
    by percents at a fresh init (1.2% median, 3.3% worst on the CPU
    against float64), so the card's gradients are held to be as near the
    float64 step's as the CPU's are (a factor 2 in norm: two f32
    evaluations) and within 0.1 of the CPU's per tensor."""
    _cuda_or_skip()
    from hgr_tpu_torch.models.yolo import YOLOv7Tiny
    from hgr_tpu_torch.tools import train_detector_smoke as tool

    frames, gts = tool.make_batch(np.random.RandomState(0), 2, 416)
    out = {}
    for name, dev, dt in (("cpu", "cpu", torch.float32),
                          ("cuda", "cuda", torch.float32),
                          ("float64", "cpu", torch.float64)):
        m = YOLOv7Tiny(dtype=dt, generator=torch.Generator().manual_seed(1))
        m = m.to(dev, dt)
        out[name] = tool.detector_loss_and_grads(
            m, torch.from_numpy(frames).to(dev),
            torch.from_numpy(gts).to(dev)) + (m.state_dict(),)
    (lc, _, gc, sc), (lp, _, gp, sp) = out["cuda"], out["cpu"]
    g64 = out["float64"][2]
    assert abs(float(lc) - float(lp)) <= 1e-4 * abs(float(lp))

    def flat(g):
        return torch.cat([g[k].cpu().double().ravel() for k in gp])

    assert _rel_err(flat(gc), flat(g64)) <= 2 * _rel_err(flat(gp), flat(g64))
    for k in gp:
        assert _rel_err(gc[k], gp[k]) <= 0.1, k
    for k in sp:
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(sc[k].cpu().numpy(), sp[k].numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=k)


def _classifier_step(model, x, fused):
    from hgr_tpu_torch.models import layers

    layers._FUSED_BN = fused
    try:
        cls, hmap, _ = model.train()(x, need_attnmap=False)
        params = [p for _, p in model.named_parameters()]
        g1 = torch.autograd.grad(torch.logsumexp(cls, -1).mean(), params,
                                 retain_graph=True, allow_unused=True,
                                 materialize_grads=True)
        g2 = torch.autograd.grad(hmap.square().mean(), params,
                                 allow_unused=True, materialize_grads=True)
    finally:
        layers._FUSED_BN = None
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    return cls, hmap, [a + 1e-3 * b for a, b in zip(g2, g1)], stats


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_remat_on_card_updates_the_stats_once(fused):
    """bf16 MultiTaskNet small at 192 px, B = 8, the de-mixed pair of
    backwards: with remat the running statistics equal the plain model's
    within 1e-5, the outputs too, and the gradients within 1e-3 relative
    per tensor."""
    _cuda_or_skip()
    from hgr_tpu_torch.models import MultiTaskNet

    x = torch.from_numpy(np.random.RandomState(2).randn(
        8, 192, 192, 3).astype(np.float32)).cuda()
    runs = [_classifier_step(MultiTaskNet(
        dtype=torch.bfloat16, remat=remat,
        generator=torch.Generator().manual_seed(3)).cuda(), x, fused)
        for remat in (False, True)]
    (c0, h0, g0, s0), (c1, h1, g1, s1) = runs
    assert torch.equal(c0, c1) and torch.equal(h0, h1)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], atol=1e-5, rtol=1e-5)
    for a, b in zip(g1, g0):
        assert _rel_err(a, b.cpu()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["s2d", "dense_grad"])
def test_stride2_lowerings_on_card_match_plain(impl):
    """f32 MultiTaskNet small at 192 px, B = 4 (TF32 off): the lowered
    model's outputs and gradients against 'plain' on the card, 1e-3
    relative per tensor."""
    _cuda_or_skip()
    from hgr_tpu_torch.models import MultiTaskNet

    x = torch.from_numpy(np.random.RandomState(4).randn(
        4, 192, 192, 3).astype(np.float32)).cuda()
    runs = [_classifier_step(MultiTaskNet(
        stride2_impl=s2, generator=torch.Generator().manual_seed(5)).cuda(),
        x, False) for s2 in ("plain", impl)]
    (c0, h0, g0, _), (c1, h1, g1, _) = runs
    assert _rel_err(c1, c0.cpu()) <= 1e-3 and _rel_err(h1, h0.cpu()) <= 1e-3
    for a, b in zip(g1, g0):
        assert _rel_err(a, b.cpu()) <= 1e-3


# -- the batched backward's boundaries (custom ops) --------------------------


def _bn_inputs(dtype, shape=(2, 9, 9, 64), seed=21):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    dt = getattr(torch, dtype)
    y = torch.from_numpy((rng.randn(*shape) * 2 + 0.3).astype(
        np.float32)).to("cuda", dt)
    gamma = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).cuda()
    beta = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32)).cuda()
    return y, gamma, beta


@pytest.fixture
def one_rank_group():
    """A gloo group of this process alone (the sum over it is the tensor
    itself)."""
    import torch.distributed as dist

    from hgr_tpu_torch.parallel.distributed import free_port

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_new_operators_match_plain_versions(dtype, one_rank_group):
    """The operators the batched backward reaches the kernels through,
    called as operators on card tensors, against their plain versions."""
    _cuda_or_skip()
    from hgr_tpu_torch.ops import bn_act as B

    ops = torch.ops.hgr_tpu_torch
    qkv = _qkv(8, 145, 22, dtype)
    g = _qkv(8, 145, 23, dtype)[..., :H * D].contiguous()
    q, k, v = qkv.chunk(3, dim=-1)
    before = A.fused_attention_split_bwd.launches
    got = ops.attention_split_bwd(q, k, v, g, H, D, SCALE)
    assert A.fused_attention_split_bwd.launches == before + 1
    want = A.attention_split_bwd_reference(q, k, v, g, H, D, SCALE)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().cpu().numpy(), **GRAD_TOL[dtype])
    y, gamma, beta = _bn_inputs(dtype)
    y2 = y.reshape(-1, y.shape[-1])
    g2 = torch.randn(y2.shape, generator=torch.Generator().manual_seed(24)
                     ).to("cuda", y.dtype)
    _, mean, var = B.fwd_chain(y2, gamma, beta, 1e-5)
    r = torch.rsqrt(var + 1e-5)
    t1, t2 = ops.bn_act_reduce(y2, g2, mean, r, gamma, beta, True)
    p1, p2 = B.bn_act_reduce_reference(y2, g2, mean, r, gamma, beta)
    dz, xhat = B._dz_xhat(y2, g2, mean, r, gamma, beta, True)
    for a, b, mag in ((t1, p1, dz.abs().sum(0)),
                      (t2, p2, (dz * xhat).abs().sum(0))):
        assert bool(((a - b).abs() <= 1e-6 * mag + 1e-30).all())
    m = float(y2.shape[0])
    dy = ops.bn_act_elem(y2, g2, mean, r, gamma, beta, p1 / m, p2 / m, True)
    want = B.bn_act_elem_reference(y2, g2, mean, r, gamma, beta, p1 / m,
                                   p2 / m)
    np.testing.assert_allclose(dy.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BN_DY_TOL[dtype])
    s = ops.all_sum(y, one_rank_group.group_name)
    assert s.is_cuda and torch.equal(s, y) and s.data_ptr() != y.data_ptr()


def _batched_vs_rows(out, inputs, cotangents):
    """The gradients of ``out`` at ``inputs`` for a batch of cotangents by
    one batched backward, and by one backward per row."""
    batched = torch.autograd.grad(out, inputs, cotangents, retain_graph=True,
                                  is_grads_batched=True)
    rows = [torch.autograd.grad(out, inputs, c, retain_graph=True)
            for c in cotangents]
    return batched, rows


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_new_operators_under_a_batched_backward_equal_two_calls(
        dtype, one_rank_group):
    """Each operator reached from a batched backward of batch 2 runs its
    kernel once per row on real tensors, and equals two single backwards
    exactly: the same kernel on the same rows."""
    _cuda_or_skip()
    from hgr_tpu_torch.ops import bn_act as B
    from hgr_tpu_torch.parallel.collectives import copy_to_model

    qkv = _qkv(4, 145, 25, dtype).requires_grad_()
    q, k, v = qkv.chunk(3, dim=-1)
    out = A.fused_attention_split(q, k, v, H, D, SCALE)
    ct = torch.stack([_qkv(4, 145, s, dtype)[..., :H * D] for s in (26, 27)])
    before = A.fused_attention_split_bwd.launches
    batched, rows = _batched_vs_rows(out, (qkv,), ct)
    assert A.fused_attention_split_bwd.launches == before + 4
    for i in range(2):
        assert torch.equal(batched[0][i], rows[i][0]), i

    y, gamma, beta = _bn_inputs(dtype)
    ins = (y.requires_grad_(), gamma.requires_grad_(),
           beta.requires_grad_())
    out = B.bn_act(*ins)[0]
    ct = torch.randn((2,) + out.shape, generator=torch.Generator()
                     .manual_seed(28)).to("cuda", out.dtype)
    before = (B.bn_act_reduce.launches, B.bn_act_elem.launches)
    batched, rows = _batched_vs_rows(out, ins, ct)
    assert (B.bn_act_reduce.launches, B.bn_act_elem.launches) == (
        before[0] + 4, before[1] + 4)
    for i in range(2):
        for a, b in zip(batched, rows[i]):
            assert torch.equal(a[i], b), i

    x = torch.randn(3, 5, device="cuda", requires_grad=True)
    out = copy_to_model(x, one_rank_group) * 2.0
    ct = torch.randn(2, 3, 5, device="cuda")
    batched, rows = _batched_vs_rows(out, (x,), ct)
    for i in range(2):
        assert torch.equal(batched[0][i], rows[i][0])
        assert torch.equal(rows[i][0], 2.0 * ct[i])
