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
                                       (1, 37, "bfloat16"),
                                       (1, 37, "float32")])
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
    with pytest.raises(ValueError, match="head_dim"):
        A.fused_attention_qkv(torch.zeros(2, 10, 3 * H * 16, device="cuda"),
                              H, 16, SCALE)
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
    assert got.dtype == torch.float32 and got.shape == (8, 192, 192, 3)
    want = W.warp_twopass_reference(canvas, m.cuda(), (192, 192), **kw)
    # the kernel rounds every product and sum on its own (-fmad=false),
    # as the plain version does: the JAX warp tests' bounds hold with room
    diff = (got - want).abs()
    assert float(diff.max()) <= 1.0
    assert float((diff > 0.02).float().mean()) < 0.01


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
