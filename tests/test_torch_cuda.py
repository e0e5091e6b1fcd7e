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
from recalgorithm_tpu_torch.ops.interactions import InteractingLayer

from torch_dist_common import result, run_world

TOL = dict(rtol=1e-5, atol=1e-5)
T, H = 50, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _case(b, seed, t=T, forced=(0, T, 1), full=0):
    """Lengths uniform in [0, t], then ``forced`` into the first rows and
    ``full`` rows of len = t after them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, H)).astype(np.float32)
    k = rng.normal(size=(b, t, H)).astype(np.float32)
    lengths = rng.integers(0, t + 1, b).astype(np.int32)
    forced = forced[:b]
    lengths[:len(forced)] = forced
    lengths[len(forced):len(forced) + full] = t
    att = DINAttention(H, generator=torch.Generator().manual_seed(seed))
    weights = [p.detach().cuda() for p in (
        att.f1_att.weight, att.f1_att.bias, att.f2_att.weight,
        att.f2_att.bias, att.f3_att.weight, att.f3_att.bias)]
    return [torch.from_numpy(x).cuda() for x in (q, k, lengths)], weights


# (B, T, forced lengths, rows of len = T after them).  The kernel packs the
# valid steps of E examples a block into chunks of 64 rows, E = B / (the
# blocks the card holds at once, 528 on an H100) rounded up and clamped to
# [1, 16]: B = 1, 8 and 37 give E = 1, 1024 E = 2, 4099 E = 8 and a short
# last group, 8448 E = 16; 0, 1, T, len > T and len < 0 (both clipped) are
# forced in; the full rows make whole groups of len = T that span several
# chunks (16 at T = 64, E = 16: the whole score buffer).
DIN_CASES = [
    (1, 50, (50,), 0), (1, 64, (0,), 0), (1, 1, (1,), 0), (8, 50, (0, 1, 50, 57, -3), 0),
    (37, 50, (0, 1, 50, 57, -3), 0), (37, 1, (0, 1, 1, 4, -1), 0),
    (1024, 50, (0, 1, 50, 57, -3), 0), (1024, 64, (0, 1, 64, 70, -2), 0),
    (4099, 50, (0, 1, 50, 57, -3), 40), (8448, 64, (0, 1, 64, 99, -5), 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,forced,full", DIN_CASES)
@pytest.mark.parametrize("use_softmax", [False, True])
def test_din_attention_kernel_matches_twin(cuda, b, t, forced, full, use_softmax):
    dev, weights = _case(b, seed=b + t, t=t, forced=forced, full=full)
    keys, lengths = dev[1], dev[2]
    before = tkern.din_attention.launches
    got = tkern.din_attention(*dev, *weights, use_softmax=use_softmax)
    torch.cuda.synchronize()
    assert tkern.din_attention.launches == before + 1
    want = tkern.din_attention_reference(*dev, *weights, use_softmax=use_softmax)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    empty = lengths <= 0
    if use_softmax:  # len = 0 attends uniformly: the mean of all T keys
        np.testing.assert_allclose(got[empty].cpu().numpy(),
                                   keys[empty].mean(dim=1).cpu().numpy(), **TOL)
    else:  # len = 0 -> zeros exactly
        assert not got[empty].any()


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


def _bst_case(b, h, t, seed, main_mix=False, forced=None):
    """Uniform lengths in [0, t], or with ``main_mix`` the BST train path's:
    history min(geometric(0.15), 50) + 1, clipped to t, with rows of n = 0,
    1, 31, 32, 33 and t forced in (one and two key chunks of a warp);
    ``forced`` replaces the lengths forced into the first rows."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, h, t, 16)).astype(np.float32)).cuda()
                  for _ in range(4))
    if main_mix:
        lengths = np.minimum(np.minimum(rng.geometric(0.15, b), 50) + 1, t).astype(np.int32)
        forced = (0, 1, 31, 32, 33, t) if forced is None else forced
    else:
        lengths = rng.integers(0, t + 1, b).astype(np.int32)
        forced = (0, t, 1) if forced is None else forced
    lengths[:len(forced)] = forced
    return q, k, v, g, torch.from_numpy(lengths).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,main_mix,forced", [
    ((37, 3, 51), False, None), ((256, 3, 51), False, None), ((5, 2, 9), False, None),
    ((4099, 3, 51), True, None),  # B not a multiple of the warps a block
    ((129, 3, 64), False, None), ((1027, 3, 9), False, None),
    ((1, 3, 51), False, (33,)),   # one pair's block, two key chunks
    ((1, 2, 64), False, (0,))])
def test_bst_forward_kernels_match_twin(cuda, shape, main_mix, forced):
    q, k, v, _, lengths = _bst_case(*shape, seed=sum(shape), main_mix=main_mix, forced=forced)
    t = shape[2]
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
    # masked keys get exactly 0; a len = 0 pair attends uniformly over all T
    # keys, P exactly 1/T (f32, and 1/T rounded to bf16)
    zero = lengths == 0
    masked = (torch.arange(t, device=q.device)[None, :] >= lengths[:, None]) & ~zero[:, None]
    masked = masked[:, None, None, :].expand_as(p32)
    assert not p32[masked].any() and not p16[masked].any()
    assert (p32[zero] == torch.tensor(1.0 / t)).all()
    assert (p16[zero] == torch.tensor(1.0 / t).to(torch.bfloat16)).all()
    np.testing.assert_allclose(got[zero].cpu().numpy(),
                               v[zero].mean(dim=2, keepdim=True).expand_as(v[zero]).cpu().numpy(),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("save_bf16", [False, True])
@pytest.mark.parametrize("shape,main_mix", [
    ((37, 3, 51), False), ((256, 3, 51), False), ((5, 2, 9), False),
    ((4099, 3, 51), True),  # B not a multiple of the backward's warps a block
    ((1027, 3, 9), False), ((129, 3, 64), False)])
def test_bst_mha_gradients_match_twin(cuda, shape, main_mix, save_bf16):
    q, k, v, g, lengths = _bst_case(*shape, seed=sum(shape) + 1, main_mix=main_mix)
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


@pytest.mark.cuda
@pytest.mark.parametrize("b", [37, 4096])
def test_bst_mha_at_autoint_shapes_matches_twin(cuda, b):
    """AutoInt's attention: T = 9 fields, H = 2, every key valid; the
    inference forward, then the saving forward and the backward."""
    q, k, v, g, lengths = _bst_case(b, 2, 9, seed=b, forced=(9,) * b)
    assert (lengths == 9).all()
    want = bkern.bst_mha_reference(q, k, v, lengths)
    n0 = bkern.bst_attention_forward.launches
    with torch.no_grad():
        got = bkern.bst_mha(q, k, v, lengths)
    assert bkern.bst_attention_forward.launches == n0 + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    twin = [x.clone().requires_grad_() for x in (q, k, v)]
    n1, n2 = bkern.bst_attention_forward_save.launches, bkern.bst_attention_backward.launches
    out = bkern.bst_mha(*leaves, lengths)
    out.backward(g)
    bkern.bst_mha_reference(*twin, lengths).backward(g)
    torch.cuda.synchronize()
    assert (bkern.bst_attention_forward_save.launches, bkern.bst_attention_backward.launches) \
        == (n1 + 1, n2 + 1)
    np.testing.assert_allclose(out.detach().cpu().numpy(), want.cpu().numpy(), **TOL)
    for a, t in zip(leaves, twin):
        scale = max(float(t.grad.abs().max()), 1.0)
        np.testing.assert_allclose(a.grad.cpu().numpy(), t.grad.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.cuda
def test_interacting_layer_on_cuda_matches_cpu(cuda):
    """One AutoInt InteractingLayer (the BST kernels) against the same layer
    on the CPU (the twin): value, the input's and every weight's gradient."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(512, 9, 16))
                         .astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(512, 9, 32))
                         .astype(np.float32))
    cpu = InteractingLayer(16, 2, 16, generator=torch.Generator().manual_seed(0))
    gpu = InteractingLayer(16, 2, 16).cuda()
    gpu.load_state_dict(cpu.state_dict())
    xc, xg = x.clone().requires_grad_(), x.cuda().requires_grad_()
    n1 = bkern.bst_attention_forward_save.launches
    out_g = gpu(xg)
    out_g.backward(g.cuda())
    out_c = cpu(xc)
    out_c.backward(g)
    assert bkern.bst_attention_forward_save.launches == n1 + 1
    np.testing.assert_allclose(out_g.detach().cpu().numpy(), out_c.detach().numpy(), **TOL)
    pairs = [(xg.grad, xc.grad)] + [(pg.grad, pc.grad) for pg, pc in
                                     zip(gpu.parameters(), cpu.parameters())]
    for a, b in pairs:
        scale = max(float(b.abs().max()), 1.0)
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-5 * scale)
    with pytest.raises(ValueError, match=r"\(B, H, T, 16\)"):
        InteractingLayer(16, 2, 8).cuda()(xg)  # the kernels take d = 16 only


@pytest.mark.cuda
def test_custom_ops_equal_the_raw_kernels(cuda):
    """The inference ops a traced graph holds launch the same kernels: bitwise
    equal to the raw launches, one count each."""
    dev, weights = _case(256, seed=3)
    for use_softmax in (False, True):
        n = tkern.din_attention.launches
        op = torch.ops.recalgorithm_torch.din_attention(*dev, *weights, use_softmax)
        raw = tkern._launch(*dev, tuple(weights), use_softmax)
        torch.cuda.synchronize()
        assert tkern.din_attention.launches == n + 2
        assert torch.equal(op, raw)
    q, k, v, _, lengths = _bst_case(256, 3, 51, seed=4, main_mix=True)
    n = bkern.bst_attention_forward.launches
    op = torch.ops.recalgorithm_torch.bst_mha_forward(q, k, v, lengths)
    raw = bkern.bst_attention_forward(q, k, v, lengths)
    torch.cuda.synchronize()
    assert bkern.bst_attention_forward.launches == n + 2
    assert torch.equal(op, raw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["DIN", "BST"])
def test_cpu_exported_artifact_moved_to_cuda_launches_the_kernels(cuda, tmp_path, name):
    """An artifact exported on the CPU, served by HLOPredictor on cuda: the
    whole program moves to the card, its kernel node launches the kernel
    once a batch, and the probabilities are the CPU's within TOL."""
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import get_model
    from recalgorithm_tpu_torch.serving.export import export_stablehlo
    from recalgorithm_tpu_torch.serving.predictor import HLOPredictor

    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=2, vocab_scale=0.05))
    cfg_cls, cls = get_model(name)
    model = cls(cfg_cls(hidden_units=(16,)), wechat_schema(gen.vocab_sizes()),
                torch.Generator().manual_seed(0))
    path = str(tmp_path / f"{name}.pt2")
    export_stablehlo(model, model.schema, 64, path)
    hb = gen.batch(40, 1)
    want = HLOPredictor(path, device="cpu").predict_batch(hb)["read_comment"]
    pred = HLOPredictor(path, device="cuda")
    counter = tkern.din_attention if name == "DIN" else bkern.bst_attention_forward
    n = counter.launches
    got = pred.predict_batch(hb)["read_comment"]
    assert counter.launches == n + 1
    assert all(t.device.type == "cuda" for t in pred.program.state_dict.values())
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.cuda
def test_sharded_lookup_on_cuda_over_gloo(cuda, tmp_path):
    """Two ranks sharing the card over gloo (NCCL refuses two ranks on one
    device), the table shards and ids CUDA tensors: the exchange's forward is
    the plain gather and its table gradient the scatter-add of 2 x out."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(256, 16)).astype(np.float32)
    ids = rng.integers(0, 256, size=(64,)).astype(np.int32)
    np.savez(tmp_path / "lookup.npz", table=table, ids=ids,
             ids_odd=rng.integers(0, 256, size=(4, 7)).astype(np.int32),
             rule_ids=rng.integers(0, 3000, 64).astype(np.int32))
    out = run_world(tmp_path, "lookup_cuda", 2, tmp_path)
    grad = np.zeros_like(table)
    np.add.at(grad, ids, 2 * table[ids])
    for rank in (0, 1):
        r = result(out, "lookup_m1", rank)
        np.testing.assert_array_equal(r["plain/forward"], table[ids])
        np.testing.assert_allclose(r["plain/grad"], grad, rtol=1e-6, atol=1e-6)
