"""Tests that need a CUDA card (marker ``gpu``): the port's kernels held
against their plain PyTorch versions on the card, and the model's forward
on the card against the same weights on the CPU.

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
    x = _qkv(1, 10, 0, "float32").requires_grad_()
    with pytest.raises(NotImplementedError, match="B2"):
        A.fused_attention_qkv(x, H, D, SCALE)


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
