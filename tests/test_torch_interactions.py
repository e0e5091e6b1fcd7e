"""Port parity for ``ops/interactions.py`` and ``ops/mlp.py``: every op
against the JAX op on the same numpy inputs, with the JAX parameters carried
across by ``convert.from_flax``; values, the gradients of the inputs and of
every parameter (autograd against ``jax.vjp`` with the same cotangent), and
the ``weight_l2`` losses the product layers sow.

Tolerances: values rtol = atol = 1e-5 (f32 on the CPU on both sides, JAX
matmuls at "highest" precision: summation order only); gradients rtol 1e-4
and atol 1e-5 * max|g|, the bar of the port's other parity tests.  The
3-layer InteractingLayer stack against the JAX Pallas kernel in interpret
mode takes rtol = atol = 1e-3 on gradients, the JAX package's own bar for
that comparison (tests/test_interactions.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.ops import interactions as J
from recalgorithm_tpu.ops import mlp as JM
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.ops import interactions as T
from recalgorithm_tpu_torch.ops import mlp as TM
from recalgorithm_tpu_torch.ops.cuda import bst_attention as bkern

TOL = dict(rtol=1e-5, atol=1e-5)
B, F, K = 12, 8, 6


def assert_grad_close(got, want, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _normal(*shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _leaf_tree(path, leaf):
    tree = node = {}
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = leaf
    return tree


def jax_value_and_vjp(fn, args, seed):
    """fn(*args) and its vjp of a random cotangent, jitted: one compile
    rather than one per eager op."""
    shape = jax.eval_shape(fn, *args).shape
    g = _normal(*shape, seed=seed)

    @jax.jit
    def run(args, g):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(g)

    with jax.default_matmul_precision("highest"):
        out, grads = run(args, jnp.asarray(g))
    return np.asarray(out), jax.device_get(grads), g


def check_module(jmod, tmod, inputs, params=None, seed=0):
    """jmod.apply(params, *inputs) against tmod(*inputs) with the JAX params
    (``params``, or jmod's init) loaded: the value, the input gradients and
    every parameter's gradient for one random cotangent.  Returns the torch
    module (with its gradients) and the JAX params."""
    jin = [jnp.asarray(x) for x in inputs]
    if params is None:
        params = jax.device_get(jax.jit(jmod.init)(jax.random.key(seed), *jin))["params"]
    out, (gp, *gx), g = jax_value_and_vjp(
        lambda p, *xs: jmod.apply({"params": p}, *xs), [params, *jin], seed + 100)
    tmod.load_state_dict(convert.from_flax({"params": params}))
    tin = [torch.from_numpy(x).requires_grad_() for x in inputs]
    tout = tmod(*tin)
    tout.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), out, **TOL)
    for a, b in zip(tin, gx):
        assert_grad_close(a.grad.numpy(), b)
    grads = {n: p.grad for n, p in tmod.named_parameters()}
    seen = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(gp):
        keys = tuple(p.key for p in path)
        (name, want), = convert.from_flax({"params": _leaf_tree(keys, leaf)}).items()
        assert_grad_close(grads[name].numpy(), want.numpy())
        seen.add(name)
    assert seen == set(grads)
    return tmod, params


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["fm_pool", "pairwise_hadamard", "pairwise_dot"])
def test_pooling_functions_match_jax(fn):
    x = _normal(B, F, K, seed=1)
    out, (gx,), g = jax_value_and_vjp(getattr(J, fn), [jnp.asarray(x)], seed=2)
    tx = torch.from_numpy(x).requires_grad_()
    tout = getattr(T, fn)(tx)
    tout.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), out, **TOL)
    assert_grad_close(tx.grad.numpy(), gx)


def test_pair_indices_are_row_major_upper_triangle():
    assert T.pair_indices(F) == J._pair_indices(F)
    assert T.pair_indices(4) == ((0, 0, 0, 1, 1, 2), (1, 2, 3, 2, 3, 3))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_afm_attention_matches_jax():
    p = _normal(B, F * (F - 1) // 2, K, seed=3)
    check_module(J.AFMAttention(attention_factor=5), T.AFMAttention(K, 5), [p])


@pytest.mark.parametrize("method", ["IPNN", "OPNN"])
@pytest.mark.parametrize("reg", [0.0, 0.05])
def test_product_layers_match_jax(method, reg):
    x = _normal(B, F, K, seed=4)
    if method == "IPNN":
        jmod, tmod = J.InnerProductLayer(7, reg), T.InnerProductLayer(F, 7, reg)
    else:
        jmod, tmod = J.OuterProductLayer(7, reg), T.OuterProductLayer(K, 7, reg)
    tmod, params = check_module(jmod, tmod, [x])
    _, sown = jmod.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    got = {k: float(v.detach()) for k, v in tmod.losses().items()}
    if reg == 0.0:
        assert got == {} and "losses" not in sown
    else:
        assert set(got) == set(sown["losses"]) == {"weight_l2"}
        np.testing.assert_allclose(got["weight_l2"], float(sown["losses"]["weight_l2"][0]),
                                   rtol=1e-6)


def test_outer_product_symmetrises_from_the_upper_triangle():
    """Only the upper triangle of each W_d counts (reference pnn.py:160-173)."""
    layer = T.OuterProductLayer(K, 3, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_normal(B, F, K, seed=5))
    before = layer(x)
    with torch.no_grad():
        layer.outer_product_w.copy_(torch.triu(layer.outer_product_w)
                                    + 7.0 * torch.tril(torch.ones(K, K), diagonal=-1))
    torch.testing.assert_close(layer(x), before, rtol=1e-5, atol=1e-5)


def test_cross_network_matches_jax():
    x = _normal(B, 10, seed=6)
    check_module(J.CrossNetwork(num_layers=3), T.CrossNetwork(10, 3), [x])


@pytest.mark.parametrize("low_rank,gated", [(0, False), (4, False), (0, True), (4, True)])
def test_cross_network_v2_matches_jax(low_rank, gated):
    x = _normal(B, 10, seed=7)
    jmod = J.CrossNetworkV2(num_layers=2, low_rank=low_rank, gated=gated)
    params = jax.device_get(jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(x)))["params"]
    # b starts at zero: plant values so its path is exercised
    params = {k: (_normal(*v.shape, seed=8) if k.startswith("b_") else v)
              for k, v in params.items()}
    check_module(jmod, T.CrossNetworkV2(10, 2, low_rank, gated), [x], params=params)


def test_cin_layer_matches_jax():
    """Two layers' shapes: x_k = x_0 (h_k = m), then h_k = 5 maps; the
    flattened filter index is i*m + j."""
    x0 = _normal(B, F, K, seed=9)
    check_module(J.CINLayer(5), T.CINLayer(F, F, 5), [x0, x0])
    xk = _normal(B, 5, K, seed=10)
    check_module(J.CINLayer(4), T.CINLayer(F, 5, 4), [x0, xk], seed=1)


@pytest.mark.parametrize("ratio", [2, 4])
def test_senet_matches_jax(ratio):
    x = _normal(B, F, K, seed=11)
    check_module(J.SENet(ratio), T.SENet(F, K, ratio), [x])


@pytest.mark.parametrize("kind", ["all", "each", "interaction"])
@pytest.mark.parametrize("drop_last_field", [True, False])
def test_bilinear_interaction_matches_jax(kind, drop_last_field):
    x = _normal(B, F, K, seed=12)
    tmod = T.BilinearInteraction(F, K, kind, drop_last_field)
    assert len(tmod.pairs[0]) == (21 if drop_last_field else 28)
    check_module(J.BilinearInteraction(kind, drop_last_field), tmod, [x])


def test_bilinear_interaction_rejects_unknown_type():
    with pytest.raises(ValueError, match="all/each/interaction"):
        T.BilinearInteraction(F, K, "field")


def test_mask_block_matches_jax():
    hidden, mask_input = _normal(B, 10, seed=13), _normal(B, 14, seed=14)
    tmod = T.MaskBlock(10, 14, 9, 6)
    check_module(J.MaskBlock(output_size=9, agg_size=6), tmod, [hidden, mask_input])
    assert "bias" not in dict(tmod.hidden.named_parameters())
    assert tmod.ln.eps == 1e-6


def test_bilinear_fusion_matches_jax():
    o1, o2 = _normal(B, 6, seed=15), _normal(B, 4, seed=16)
    jmod = J.BilinearFusion(num_heads=2)
    params = jax.device_get(jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(o1),
                                                   jnp.asarray(o2)))
    params = dict(params["params"], w3=_normal(2, 3, 2, seed=17), bias=_normal(1, seed=18))
    check_module(jmod, T.BilinearFusion(6, 4, num_heads=2), [o1, o2], params=params)
    with pytest.raises(ValueError, match="not divisible"):
        T.BilinearFusion(6, 4, num_heads=4)


# ---------------------------------------------------------------------------
# InteractingLayer: AutoInt's path onto the BST attention kernels
# ---------------------------------------------------------------------------

H, D, FI = 2, 16, 9  # AutoInt's heads, head dim and fields (8 + dense_field)


@pytest.mark.parametrize("k_in", [16, 32])
def test_interacting_layer_matches_jax_plain(k_in):
    x = _normal(B, FI, k_in, seed=19)
    tmod = T.InteractingLayer(k_in, H, D)
    before = bkern.bst_attention_forward_save.launches
    check_module(J.InteractingLayer(H, D), tmod, [x])
    assert bkern.bst_attention_forward_save.launches == before  # CPU: the twin


def test_interacting_layer_calls_bst_mha_through_its_module(monkeypatch):
    """q is scaled by sqrt(d) = 4 before the kernel and every field is a
    valid key; the call goes through ``bst_attention.bst_mha``, where a
    caller can wrap it."""
    seen = {}
    plain = bkern.bst_mha

    def wrap(q, k, v, lengths):
        seen.update(q=q, k=k, lengths=lengths)
        return plain(q, k, v, lengths)

    monkeypatch.setattr(bkern, "bst_mha", wrap)
    layer = T.InteractingLayer(16, H, D, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_normal(B, FI, 16, seed=20))
    layer(x)
    assert tuple(seen["q"].shape) == (B, H, FI, D) and seen["q"].is_contiguous()
    assert seen["lengths"].dtype == torch.int32 and (seen["lengths"] == FI).all()
    q0 = (x @ layer.w_query).reshape(B, FI, H, D).transpose(1, 2)
    assert torch.equal(seen["q"], q0 * 4.0)


def test_interacting_layer_stack_matches_jax_fused_interpret():
    """AutoInt's 3 stacked layers against the JAX Pallas kernel run in
    interpret mode, chained in its kernel layout (kernel_in / kernel_out),
    the wiring of the JAX package's own fused-vs-plain test; and against the
    JAX plain path."""
    bt = 16
    x = _normal(bt, FI, D, seed=21)
    plain = J.InteractingLayer(num_heads=H, head_dim=D)
    fused = J.InteractingLayer(num_heads=H, head_dim=D, fused=True, interpret=True)
    ps = [jax.device_get(jax.jit(plain.init)(jax.random.key(i), jnp.asarray(
        x if i == 0 else np.zeros((bt, FI, H * D), np.float32))))["params"]
        for i in range(3)]

    def stack_fused(pp, xx):
        for i in range(3):
            xx = fused.apply({"params": pp[i]}, xx, kernel_in=i > 0, kernel_out=i < 2)
        return xx

    def stack_plain(pp, xx):
        for i in range(3):
            xx = plain.apply({"params": pp[i]}, xx)
        return xx

    layers = [T.InteractingLayer(D if i == 0 else H * D, H, D) for i in range(3)]
    for layer, p in zip(layers, ps):
        layer.load_state_dict(convert.from_flax({"params": p}))
    tx = torch.from_numpy(x).requires_grad_()
    out = tx
    for layer in layers:
        out = layer(out)
    for stack, tol in ((stack_fused, 1e-3), (stack_plain, 1e-4)):
        want, (gps, gx), g = jax_value_and_vjp(stack, [ps, jnp.asarray(x)], seed=22)
        if tx.grad is None:
            out.backward(torch.from_numpy(g))
        np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=tol, atol=tol)
        for layer, gp in zip(layers, gps):
            for name, p in layer.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[name]),
                                           rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# ops/mlp.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("logits_dim", [None, 1])
def test_mlp_tower_matches_jax_eval_and_train(logits_dim):
    """Eval (running statistics) and train mode (batch statistics, updated
    running statistics); dropout 0."""
    x = _normal(B, 10, seed=23)
    jmod = JM.MLPTower(hidden_units=(8, 6), batch_norm=True, logits_dim=logits_dim)
    v = jax.device_get(jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(x)))
    rng = np.random.default_rng(24)
    v["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.3, 3.0, a.shape).astype(np.float32), v["batch_stats"])
    tmod = TM.MLPTower(10, (8, 6), batch_norm=True, logits_dim=logits_dim)
    tmod.load_state_dict(convert.from_flax(v))
    with jax.default_matmul_precision("highest"):
        jeval = jax.jit(jmod.apply)(v, jnp.asarray(x))
        jtrain, upd = jax.jit(lambda v, x: jmod.apply(v, x, train=True,
                                                      mutable=["batch_stats"]))(v, jnp.asarray(x))
    tmod.eval()
    np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(), jeval, **TOL)
    tmod.train()
    np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(), jtrain, **TOL)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **TOL),
                 convert.to_flax(tmod)["batch_stats"], jax.device_get(upd["batch_stats"]))
    assert tmod.out_features == (logits_dim or 6)


def test_mlp_tower_order_is_dense_relu_dropout_bn():
    tower = TM.MLPTower(10, (8, 6), dropout_rate=0.2, batch_norm=True, logits_dim=1)
    assert tower._order == ["dense_0", "relu_0", "dropout_0", "bn_0",
                            "dense_1", "relu_1", "dropout_1", "bn_1", "logits"]
    assert tower.bn_0.eps == 1e-3 and tower.bn_0.momentum == 0.01
    assert not hasattr(TM.MLPTower(10, (8,), dropout_rate=1.0), "dropout_0")


def test_residual_unit_matches_jax():
    x = _normal(B, 10, seed=25)
    check_module(JM.ResidualUnit(internal_dim=7), TM.ResidualUnit(10, 7), [x])


@pytest.mark.parametrize("bias", [True, False])
def test_dense_bias_free_round_trips(bias):
    """Dense(bias=False) is flax's use_bias=False: a kernel and no bias leaf,
    both ways through convert."""
    x = _normal(B, 10, seed=26)
    jmod = JM.Dense(3, use_bias=bias)
    tmod, params = check_module(jmod, TM.Dense(10, 3, bias=bias), [x])
    assert set(params) == ({"kernel", "bias"} if bias else {"kernel"})
    back = convert.to_flax(tmod)["params"]
    assert set(back) == set(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
