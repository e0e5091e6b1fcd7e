"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Imports neither JAX nor the JAX package, so it runs on a GPU machine that
has only PyTorch (the tests' conftest imports JAX, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Without a GPU every test skips.  Tolerance rtol = atol = 1e-5 for outputs:
f32 on both sides, TF32 off, summation order only.  Gradients: rtol 1e-4 and
atol 1e-5 * max|g| (the JAX package's bar for its BST kernel,
tests/test_pallas_kernels.py), and 2e-2 for gradients from bf16-saved P.
"""

import numpy as np
import pytest
import torch

from recalgorithm_tpu_torch.ops.attention import DINAttention
from recalgorithm_tpu_torch.ops.cuda import bst_attention as bkern
from recalgorithm_tpu_torch.ops.cuda import din_attention as tkern

TOL = dict(rtol=1e-5, atol=1e-5)
T, H = 50, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _case(b, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, H)).astype(np.float32)
    k = rng.normal(size=(b, T, H)).astype(np.float32)
    lengths = rng.integers(0, T + 1, b).astype(np.int32)
    lengths[:3] = (0, T, 1)
    att = DINAttention(H, generator=torch.Generator().manual_seed(seed))
    weights = [p.detach().cuda() for p in (
        att.f1_att.weight, att.f1_att.bias, att.f2_att.weight,
        att.f2_att.bias, att.f3_att.weight, att.f3_att.bias)]
    return [torch.from_numpy(x).cuda() for x in (q, k, lengths)], weights


@pytest.mark.cuda
@pytest.mark.parametrize("b", [37, 1024])
@pytest.mark.parametrize("use_softmax", [False, True])
def test_din_attention_kernel_matches_twin(cuda, b, use_softmax):
    dev, weights = _case(b, seed=b)
    before = tkern.din_attention.launches
    got = tkern.din_attention(*dev, *weights, use_softmax=use_softmax)
    torch.cuda.synchronize()
    assert tkern.din_attention.launches == before + 1
    want = tkern.din_attention_reference(*dev, *weights, use_softmax=use_softmax)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    if not use_softmax:
        assert not got[0].any()  # len = 0 -> zeros


@pytest.mark.cuda
def test_din_attention_kernel_refuses_what_it_cannot_take(cuda):
    dev, weights = _case(8, seed=0)
    q, k, lengths = dev
    with pytest.raises(TypeError, match="lengths"):
        tkern.din_attention(q, k, lengths.long(), *weights)
    with pytest.raises(ValueError, match="not contiguous"):
        tkern.din_attention(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                            lengths, *weights)
    with pytest.raises(ValueError, match="on cpu"):
        tkern.din_attention(q, k, lengths.cpu(), *weights)


@pytest.mark.cuda
def test_din_attention_gradients_match_twin(cuda):
    """Kernel forward + recompute backward against autograd through the twin."""
    dev, weights = _case(64, seed=5)
    q, k, lengths = dev
    leaves = [x.clone().requires_grad_() for x in (q, k, *weights)]
    twin = [x.clone().requires_grad_() for x in (q, k, *weights)]
    before = tkern.din_attention.launches
    out = tkern.din_attention(leaves[0], leaves[1], lengths, *leaves[2:], use_softmax=True)
    assert tkern.din_attention.launches == before + 1
    ref = tkern.din_attention_reference(twin[0], twin[1], lengths, *twin[2:],
                                        use_softmax=True)
    g = torch.randn_like(ref)
    out.backward(g)
    ref.backward(g)
    for a, b in zip(leaves, twin):
        scale = float(b.grad.abs().max())
        np.testing.assert_allclose(a.grad.cpu().numpy(), b.grad.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5 * max(scale, 1.0))


def _bst_case(b, h, t, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, h, t, 16)).astype(np.float32)).cuda()
                  for _ in range(4))
    lengths = rng.integers(0, t + 1, b).astype(np.int32)
    lengths[:3] = (0, t, 1)
    return q, k, v, g, torch.from_numpy(lengths).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 3, 51), (256, 3, 51), (5, 2, 9)])
def test_bst_forward_kernels_match_twin(cuda, shape):
    q, k, v, _, lengths = _bst_case(*shape, seed=sum(shape))
    want = bkern.bst_mha_reference(q, k, v, lengths)
    probs = bkern.attention_probs_reference(q, k, lengths)
    n0, n1 = bkern.bst_attention_forward.launches, bkern.bst_attention_forward_save.launches
    got = bkern.bst_attention_forward(q, k, v, lengths)
    got_s, p32 = bkern.bst_attention_forward_save(q, k, v, lengths)
    got_b, p16 = bkern.bst_attention_forward_save(q, k, v, lengths, save_bf16=True)
    torch.cuda.synchronize()
    assert bkern.bst_attention_forward.launches == n0 + 1
    assert bkern.bst_attention_forward_save.launches == n1 + 2
    for out in (got, got_s, got_b):
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), **TOL)
    np.testing.assert_allclose(p32.cpu().numpy(), probs.cpu().numpy(), **TOL)
    assert p16.dtype == torch.bfloat16
    np.testing.assert_allclose(p16.float().cpu().numpy(), probs.cpu().numpy(),
                               rtol=0, atol=2e-2)
    # len = 0 attends uniformly over all T keys
    np.testing.assert_allclose(got[0].cpu().numpy(),
                               v[0].mean(dim=1, keepdim=True).expand_as(v[0]).cpu().numpy(),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("save_bf16", [False, True])
@pytest.mark.parametrize("shape", [(37, 3, 51), (256, 3, 51), (5, 2, 9)])
def test_bst_mha_gradients_match_twin(cuda, shape, save_bf16):
    q, k, v, g, lengths = _bst_case(*shape, seed=sum(shape) + 1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    twin = [x.clone().requires_grad_() for x in (q, k, v)]
    n1, n2 = bkern.bst_attention_forward_save.launches, bkern.bst_attention_backward.launches
    bkern.bst_mha(*leaves, lengths, save_bf16).backward(g)
    bkern.bst_mha_reference(*twin, lengths).backward(g)
    torch.cuda.synchronize()
    assert bkern.bst_attention_forward_save.launches == n1 + 1
    assert bkern.bst_attention_backward.launches == n2 + 1
    tol = 2e-2 if save_bf16 else None
    for a, b in zip(leaves, twin):
        scale = max(float(b.grad.abs().max()), 1.0)
        np.testing.assert_allclose(
            a.grad.cpu().numpy(), b.grad.cpu().numpy(),
            rtol=tol or 1e-4, atol=(tol or 1e-5) * scale)
    # len = 0: no gradient reaches q or k
    assert not leaves[0].grad[0].any() and not leaves[1].grad[0].any()


@pytest.mark.cuda
def test_bst_mha_refuses_what_it_cannot_take(cuda):
    q, k, v, _, lengths = _bst_case(4, 3, 51, seed=0)
    with pytest.raises(TypeError, match="lengths"):
        bkern.bst_mha(q, k, v, lengths.long())
    with pytest.raises(ValueError, match="not contiguous"):
        bkern.bst_mha(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, lengths)
    with pytest.raises(ValueError, match="sequence length"):
        z = torch.zeros(4, 3, 65, 16, device="cuda")
        bkern.bst_mha(z, z, z, lengths)
    with pytest.raises(ValueError, match="on cpu"):
        bkern.bst_mha(q, k, v, lengths.cpu())
