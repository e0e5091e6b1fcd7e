"""Port parity for BST: the attention twin and ``bst_mha`` (CPU path) against
the JAX package's ``mha_reference`` and its Pallas kernel run in interpret
mode, the transformer block and the whole model against the JAX plain and
fused-interpret paths, and the BST ``convert`` round trip.

Tolerances: forward rtol = atol = 1e-5 (f32 on the CPU on both sides,
summation order only; JAX matmuls at "highest" precision); gradients rtol
1e-4 and atol 1e-5 * max|g| (the JAX package's own bar for its BST kernel,
tests/test_pallas_kernels.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu.models.bst import BST as JaxBST, BSTConfig as JaxBSTConfig
from recalgorithm_tpu.ops.attention import BSTTransformerBlock as JaxBlock
from recalgorithm_tpu.ops.pallas.bst_attention import bst_mha_fused, mha_reference
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models import get_model
from recalgorithm_tpu_torch.models.bst import BST, BSTConfig
from recalgorithm_tpu_torch.ops.attention import BSTTransformerBlock
from recalgorithm_tpu_torch.ops.cuda import bst_attention as bkern

TOL = dict(rtol=1e-5, atol=1e-5)
HIDDEN = (32, 16)
SEQ = "his_read_comment_7d_seq"


def assert_grad_close(got, want, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _qkv(b, h, t, seed, lengths_from=1):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, h, t, 16)).astype(np.float32) for _ in range(4))
    lengths = rng.integers(lengths_from, t + 1, b).astype(np.int32)
    lengths[:2] = (1, t)
    return q, k, v, g, lengths


def _jax_grads(fn, q, k, v, g, lengths):
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, jnp.asarray(lengths)), q, k, v)
        return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch_grads(fn, q, k, v, g, lengths):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, torch.from_numpy(lengths))
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("shape,forced", [
    ((37, 3, 51), ()), ((130, 3, 51), ()), ((5, 2, 9), ()),
    ((6, 3, 64), ()),
    # where the CUDA forward changes branch: P's lanes a row (n <= 8, <= 16)
    # and a second key chunk (n > 32)
    ((9, 3, 51), (1, 8, 9, 16, 17, 31, 32, 33, 51))])
def test_bst_mha_matches_jax(shape, forced):
    q, k, v, g, lengths = _qkv(*shape, seed=sum(shape))
    lengths[:len(forced)] = forced
    want_ref, grads_ref = _jax_grads(mha_reference, q, k, v, g, lengths)
    want_fused, grads_fused = _jax_grads(
        lambda q, k, v, n: bst_mha_fused(q, k, v, n, interpret=True), q, k, v, g, lengths)
    before = (bkern.bst_attention_forward.launches,
              bkern.bst_attention_forward_save.launches, bkern.bst_attention_backward.launches)
    for fn in (bkern.bst_mha, bkern.bst_mha_reference):
        got, grads = _torch_grads(fn, q, k, v, g, lengths)
        for want, want_g in ((want_ref, grads_ref), (want_fused, grads_fused)):
            np.testing.assert_allclose(got, want, **TOL)
            for a, b in zip(grads, want_g):
                assert_grad_close(a, b)
    assert (bkern.bst_attention_forward.launches, bkern.bst_attention_forward_save.launches,
            bkern.bst_attention_backward.launches) == before  # CPU: the twin, no kernel


def test_bst_mha_len_zero_follows_mha_reference():
    """A len = 0 row attends uniformly over all T keys and passes no gradient
    to q or k, as mha_reference's autograd gives (the Pallas backward does
    not mask dl and differs there; no model path feeds len = 0)."""
    q, k, v, g, lengths = _qkv(6, 3, 51, seed=4)
    lengths[:3] = (0, 0, 51)
    want, grads = _jax_grads(mha_reference, q, k, v, g, lengths)
    got, tgrads = _torch_grads(bkern.bst_mha, q, k, v, g, lengths)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(axis=1, keepdims=True),
                                                       v[0].shape), **TOL)
    for a, b in zip(tgrads, grads):
        assert_grad_close(a, b)
    assert not tgrads[0][:2].any() and not tgrads[1][:2].any()


def test_probs_reference_rows_are_the_softmax():
    q, k, _, _, lengths = _qkv(8, 3, 51, seed=9)
    lengths[2] = 0
    p = bkern.attention_probs_reference(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=0, atol=1e-6)
    assert not p[0, :, :, 1:].any()            # len 1: all weight on key 0
    np.testing.assert_allclose(p[2], 1.0 / 51, rtol=1e-6)  # len 0: uniform


def test_bst_mha_refuses_other_devices():
    q, k, v, _, lengths = _qkv(4, 3, 51, seed=0)
    meta = [torch.from_numpy(x).to("meta") for x in (q, k, v, lengths)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bkern.bst_mha(*meta)


def test_bst_wrapper_checks():
    q, k, v, _, lengths = _qkv(4, 3, 51, seed=0)
    tq, tk, tv, tl = (torch.from_numpy(x) for x in (q, k, v, lengths))
    assert bkern._check(tl, q=tq, k=tk, v=tv) == (4, 3, 51)  # the main path's shapes
    with pytest.raises(TypeError, match="lengths"):
        bkern._check(tl.long(), q=tq, k=tk, v=tv)
    with pytest.raises(ValueError, match=r"\(B, H, T, 16\)"):
        bkern._check(tl, q=tq[..., :8], k=tk, v=tv)
    with pytest.raises(ValueError, match="not contiguous"):
        bkern._check(tl, q=tq, k=tk.transpose(1, 2).contiguous().transpose(1, 2), v=tv)
    with pytest.raises(ValueError, match="sequence length"):
        z = torch.zeros(4, 3, 65, 16)
        bkern._check(tl, q=z, k=z, v=z)
    with pytest.raises(TypeError, match="float32"):
        bkern._check(tl, q=tq, k=tk, v=tv.double())


# ---------------------------------------------------------------------------
# BSTTransformerBlock and BST
# ---------------------------------------------------------------------------

JAX_PATHS = {
    "plain": {},
    "fused": dict(fused=True, interpret=True),
    "fused_kernel_layout": dict(fused=True, interpret=True, kernel_layout=True),
}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def block_case():
    b, t, d = 24, 51, 16
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    lengths = rng.integers(1, t + 1, b).astype(np.int32)
    lengths[:2] = (1, t)
    g = rng.normal(size=(b, t, d)).astype(np.float32)
    params = jax.tree.map(np.asarray, JaxBlock(3, t).init(jax.random.key(0), x, lengths))
    return x, lengths, g, params


@pytest.mark.parametrize("path", sorted(JAX_PATHS))
def test_transformer_block_matches_jax(block_case, path):
    x, lengths, g, params = block_case
    jblock = JaxBlock(3, x.shape[1], **JAX_PATHS[path])
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(lambda p, xx: jblock.apply(p, xx, lengths), params, x)
        gp, gx = vjp(jnp.asarray(g))
    block = BSTTransformerBlock(16, 3, x.shape[1])
    block.load_state_dict(convert.from_flax(params))
    tx = torch.from_numpy(x).requires_grad_()
    tout = block(tx, torch.from_numpy(lengths))
    tout.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), **TOL)
    assert_grad_close(tx.grad.numpy(), gx)
    want = _flat(gp["params"])
    got = {k: p.grad.numpy() for k, p in block.named_parameters()}
    assert len(got) == len(want) == 11
    for path_, w in want.items():
        key = ".".join(path_[:-1] + ({"scale": "weight", "kernel": "weight"}
                                      .get(path_[-1], path_[-1]),))
        a = got[key].T if path_[-1] == "kernel" else got[key]
        assert_grad_close(a, w)


def test_block_init_is_flax_glorot():
    """glorot_uniform on (H, d, d) takes fan_in = fan_out = H*d: bound 0.25
    for H=3, d=16 (xavier_uniform_ would take 256 and 48)."""
    block = BSTTransformerBlock(16, 3, 51, generator=torch.Generator().manual_seed(0))
    for name, bound in (("w_q", 0.25), ("w_o", (6 / 64) ** 0.5),
                        ("position_embedding", (6 / 67) ** 0.5)):
        w = getattr(block, name).detach()
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.95 * bound
    assert block.ln1.eps == 1e-6 and block.ln2.eps == 1e-6


@pytest.fixture(scope="module")
def bst_data():
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=3, vocab_scale=0.002))
    hb = gen.batch(40, 7)
    hb[SEQ][0], hb[SEQ + "_len"][0] = 0, 0         # empty history: length 1 with the target
    hb[SEQ][1] = np.arange(1, 51, dtype=np.int32) % 200 + 1
    hb[SEQ + "_len"][1] = 50                       # full history
    return gen, hb


def _jax_bst(gen, **kw):
    cfg = JaxBSTConfig(hidden_units=HIDDEN, dropout_rate=0.0, **kw)
    return JaxBST(config=cfg, schema=wechat_schema(gen.vocab_sizes()))


def _variables(jmodel, hb, seed):
    v = jmodel.init(jax.random.key(seed), {k: jnp.asarray(x) for k, x in hb.items()},
                    train=False)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda x: rng.uniform(0.3, 3.0, x.shape).astype(np.float32),
                         v["batch_stats"])
    return {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}


BST_PATHS = {
    "plain": dict(use_fused_attention="false"),
    "fused": dict(use_fused_attention="true", attn_interpret=True),
    "fused_kernel_layout": dict(use_fused_attention="true", attn_interpret=True,
                                kernel_layout_attn=True),
}


@pytest.mark.parametrize("path", sorted(BST_PATHS))
def test_bst_matches_jax(bst_data, path):
    """Eval logits (running statistics), then train-mode logits, parameter
    gradients of the mean logit and the updated BN statistics."""
    gen, hb = bst_data
    jmodel = _jax_bst(gen, **BST_PATHS[path])
    variables = _variables(jmodel, hb, seed=1)
    jb = {k: jnp.asarray(x) for k, x in hb.items()}
    with jax.default_matmul_precision("highest"):
        jeval = jmodel.apply(variables, jb, train=False)["read_comment"]

        def train_loss(params):
            out, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    jb, train=True, mutable=["batch_stats"])
            return jnp.mean(out["read_comment"]), (out["read_comment"], upd)

        (_, (jtrain, upd)), jgrads = jax.value_and_grad(train_loss, has_aux=True)(
            variables["params"])

    model = BST(BSTConfig(hidden_units=HIDDEN, dropout_rate=0.0),
                t_wechat_schema(gen.vocab_sizes()))
    model.load_state_dict(convert.from_flax(variables))
    tb = {k: torch.from_numpy(x) for k, x in hb.items()}
    model.eval()
    with torch.no_grad():
        teval = model(tb)[0]["read_comment"]
    np.testing.assert_allclose(teval.numpy(), np.asarray(jeval), **TOL)
    model.train()
    logits, losses = model(tb)
    assert losses == {}
    np.testing.assert_allclose(logits["read_comment"].detach().numpy(), np.asarray(jtrain),
                               **TOL)
    logits["read_comment"].mean().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    seen = set()
    for path_, w in _flat(jgrads).items():  # each JAX gradient, carried to its torch name
        (name, want), = convert.from_flax({"params": _unflat({path_: w})}).items()
        assert_grad_close(grads[name].numpy(), want.numpy())
        seen.add(name)
    assert seen == set(grads)
    new_stats = _flat(upd["batch_stats"])
    got_stats = _flat(convert.to_flax(model)["batch_stats"])
    for k, w in new_stats.items():
        np.testing.assert_allclose(got_stats[k], w, **TOL)


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def test_bst_convert_round_trips_bit_exact(bst_data):
    gen, hb = bst_data
    model = BST(BSTConfig(hidden_units=HIDDEN), t_wechat_schema(gen.vocab_sizes()),
                torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean") or name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    sd = model.state_dict()
    back = convert.from_flax(convert.to_flax(model))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k

    variables = _variables(_jax_bst(gen), hb, seed=2)
    model.load_state_dict(convert.from_flax(variables))
    again = _flat(convert.to_flax(model))
    want = _flat(variables)
    assert set(again) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(again[path], leaf)
    blk = variables["params"]["transformer_0"]
    assert set(blk) == {"position_embedding", "w_q", "w_k", "w_v", "w_o", "ln1", "ffn", "ln2"}
    assert blk["w_o"].shape == (48, 16) and set(blk["ln1"]) == {"scale", "bias"}


def test_bst_full_width_shapes():
    """BSTConfig defaults at the real WeChat table sizes: the training slice's
    width."""
    cfg_cls, model_cls = get_model("BST")
    model = model_cls(cfg_cls(), t_wechat_schema(), torch.Generator().manual_seed(0))
    assert tuple(model.embedder.embed.tables["feedid"].shape) == (106496, 16)
    assert model.dense_0.in_features == 66  # dense + 6 category fields + pooled 16
    assert [getattr(model, f"dense_{i}").out_features for i in range(3)] == [512, 256, 128]
    blk = model.transformer_0
    assert tuple(blk.w_q.shape) == (3, 16, 16) and tuple(blk.w_o.shape) == (48, 16)
    assert tuple(blk.position_embedding.shape) == (51, 16)
    assert model.bn_0.eps == 1e-3 and model.bn_0.momentum == 0.01
    assert model.dropout_0.rate == 0.1 and not hasattr(model, "relu_0")
