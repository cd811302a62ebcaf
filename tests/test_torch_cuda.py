"""Hand-written CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere. This file
imports no jax, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ops():
    from repro_torch.kernels import ops, ref
    return ops, ref


@pytest.mark.parametrize("M,K", [(1, 16), (4, 4608), (37, 1000), (130, 18432)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quantize(dev, M, K, dtype):
    ops, ref = _ops()
    g = torch.Generator(device=dev).manual_seed(M + K)
    x = (torch.randn(M, K, generator=g, device=dev) * 3).to(dtype)
    bcol = torch.rand(K, generator=g, device=dev) + 0.5
    alpha = torch.tensor(0.15, device=dev)
    q, a = ops.act_quantize(x, bcol, alpha)
    qr, ar = ref.act_quantize_ref(x, bcol, 8, alpha)
    torch.cuda.synchronize()
    assert torch.equal(a, ar)
    assert (q.int() - qr.int()).abs().max().item() <= 1
    assert (q != qr).float().mean().item() <= 1e-5


@pytest.mark.parametrize("M,K,N", [(1, 32, 8), (4, 4608, 512), (70, 300, 130),
                                   (256, 1024, 384), (5, 18432, 64)])
def test_qgemm_w8a8_bitwise(dev, M, K, N):
    ops, ref = _ops()
    g = torch.Generator(device=dev).manual_seed(M * K + N)
    qx = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
    qw = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    a = torch.rand(M, 1, generator=g, device=dev) + 0.01
    sw = torch.rand(N, generator=g, device=dev) + 0.01
    out = ops.qgemm_w8a8(qx, qw, a, sw)
    want = ref.qgemm_w8a8_ref(qx, qw, a, sw)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("H,Hkv,S,D", [(4, 2, 128, 64), (9, 1, 200, 128), (2, 2, 70, 16)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_flash_attention(dev, H, Hkv, S, D, dtype, atol):
    ops, ref = _ops()
    g = torch.Generator(device=dev).manual_seed(H * S + D)
    q = torch.randn(2, H, S, D, generator=g, device=dev).to(dtype)
    k = torch.randn(2, Hkv, S, D, generator=g, device=dev).to(dtype)
    v = torch.randn(2, Hkv, S, D, generator=g, device=dev).to(dtype)
    kv_len = torch.tensor([S, S // 2 + 1], device=dev)
    out = ops.flash_attention(q, k, v, kv_len)
    want = ref.flash_attention_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=atol, rtol=0)
