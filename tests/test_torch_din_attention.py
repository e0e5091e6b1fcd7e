"""Port parity: DIN attention of recalgorithm_tpu_torch against the JAX
package (DINAttention, its pure reference and the Pallas kernel run in
interpret mode), and the CUDA kernel against its plain twin where a card is.

Tolerance rtol = atol = 1e-5: both sides compute in f32 on the CPU and
differ only in summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.ops.attention import DINAttention as JaxDINAttention
from recalgorithm_tpu.ops.pallas.din_attention import (
    din_attention_fused as jax_fused,
    din_attention_reference as jax_reference,
)
from recalgorithm_tpu_torch.ops import attention as tatt
from recalgorithm_tpu_torch.ops.cuda import _build
from recalgorithm_tpu_torch.ops.cuda import din_attention as tkern

B, T, H = 37, 50, 16  # odd batch, not a multiple of 128
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed=0, b=B):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, H)).astype(np.float32)
    k = rng.normal(size=(b, T, H)).astype(np.float32)
    lengths = np.concatenate(
        [[0, T, 1, T - 1], rng.integers(0, T + 1, b - 4)]).astype(np.int32)
    return q, k, lengths


@pytest.fixture(scope="module")
def case():
    q, k, lengths = _inputs()
    params = JaxDINAttention().init(
        jax.random.key(0), jnp.asarray(q), jnp.asarray(k), jnp.asarray(lengths)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    # torch Linear layout: weight = flax kernel transposed
    weights = []
    for name in ("f1_att", "f2_att", "f3_att"):
        weights += [torch.from_numpy(params[name]["kernel"].T.copy()),
                    torch.from_numpy(params[name]["bias"].copy())]
    return q, k, lengths, params, weights


def _torch_in(q, k, lengths):
    return torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(lengths)


@pytest.mark.parametrize("use_softmax", [False, True])
def test_reference_matches_jax(case, use_softmax):
    q, k, lengths, params, weights = case
    module = np.asarray(JaxDINAttention(use_softmax=use_softmax).apply(
        {"params": params}, q, k, lengths))
    ref = np.asarray(jax_reference(q, k, lengths, params, use_softmax))
    fused = np.asarray(jax_fused(q, k, lengths, params, use_softmax,
                                 interpret=True))
    got = tkern.din_attention_reference(*_torch_in(q, k, lengths), *weights,
                                        use_softmax=use_softmax).numpy()
    for want in (module, ref, fused):
        np.testing.assert_allclose(got, want, **TOL)
    # len = 0: zeros without softmax, the uniform mean of all T keys with it
    want0 = k[0].mean(axis=0) if use_softmax else np.zeros(H, np.float32)
    np.testing.assert_allclose(got[0], want0, **TOL)


@pytest.mark.parametrize("use_softmax", [False, True])
def test_module_path_matches_jax(case, use_softmax):
    """DINAttention on CPU tensors goes through the wrapper to the twin."""
    q, k, lengths, params, weights = case
    want = np.asarray(JaxDINAttention(use_softmax=use_softmax).apply(
        {"params": params}, q, k, lengths))
    att = tatt.DINAttention(H, use_softmax=use_softmax)
    att.load_state_dict({
        f"{n}.{leaf}": w for (n, leaf), w in zip(
            [(n, leaf) for n in ("f1_att", "f2_att", "f3_att")
             for leaf in ("weight", "bias")], weights)})
    before = tkern.din_attention.launches
    with torch.no_grad():
        got = att(*_torch_in(q, k, lengths)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert tkern.din_attention.launches == before  # CPU: no kernel launch


def test_sequence_mask():
    m = tatt.sequence_mask(torch.tensor([0, 2, 5], dtype=torch.int32), 4)
    np.testing.assert_array_equal(
        m.numpy(), [[0, 0, 0, 0], [1, 1, 0, 0], [1, 1, 1, 1]])


def test_wrapper_never_falls_back_off_cpu(case):
    """A device with no kernel raises; it does not take the plain twin."""
    q, k, lengths, _, weights = case
    meta = [x.to("meta") for x in (*_torch_in(q, k, lengths), *weights)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tkern.din_attention(*meta)


def test_wrapper_checks(case):
    q, k, lengths, _, weights = case
    tq, tk, tl = _torch_in(q, k, lengths)
    tkern._check(tq, tk, tl, weights)  # the main path's shapes pass
    with pytest.raises(TypeError, match="lengths"):
        tkern._check(tq, tk, tl.long(), weights)
    with pytest.raises(ValueError, match="query"):
        tkern._check(tq[:, :8], tk, tl, weights)
    with pytest.raises(ValueError, match="contiguous"):
        tkern._check(tq, tk.transpose(0, 1).contiguous().transpose(0, 1), tl,
                     weights)
    with pytest.raises(ValueError, match="sequence length"):
        tkern._check(tq, torch.zeros(B, 65, H), tl, weights)
    # inputs that want a gradient pass: the card takes the kernel forward and
    # autograd through the twin's recompute for the backward
    tkern._check(tq.requires_grad_(), tk, tl, weights)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No nvcc: the build raises; nothing drops to the twin quietly."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["din_attention"])
