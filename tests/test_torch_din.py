"""Port parity: the full DIN eval forward (logits and the MBA-L2 term) of
recalgorithm_tpu_torch against the JAX DIN, on weights the JAX model
initialised and carried across by ``convert.from_flax``, with non-trivial
BatchNorm statistics.  atol 1e-5: f32 on the CPU, summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu.models.din import DIN as JaxDIN, DINConfig as JaxDINConfig
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models import get_model
from recalgorithm_tpu_torch.models.din import DIN, DINConfig

HIDDEN = (32, 16)
B = 40


def _batch(gen):
    hb = gen.batch(B, 7)
    seq = "his_read_comment_7d_seq"
    hb[seq][0], hb[seq + "_len"][0] = 0, 0          # empty history
    full = np.arange(1, 51, dtype=np.int32) % 200 + 1
    hb[seq][1], hb[seq + "_len"][1] = full, 50      # full history
    hb["manual_tag_list"][2] = 0                    # no tags: mean -> zeros
    return hb


def jax_variables(model, batch, seed):
    v = model.init(jax.random.key(seed), {k: jnp.asarray(x) for k, x in batch.items()},
                   train=False)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(np.asarray, v["batch_stats"])

    def perturb(tree):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = perturb(x)
            elif k == "mean":
                out[k] = rng.normal(0, 0.5, x.shape).astype(np.float32)
            else:
                out[k] = rng.uniform(0.3, 3.0, x.shape).astype(np.float32)
        return out

    return {"params": jax.tree.map(np.asarray, v["params"]),
            "batch_stats": perturb(stats)}


@pytest.fixture(scope="module")
def data():
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=3, vocab_scale=0.002))
    return gen, _batch(gen)


@pytest.mark.parametrize("use_softmax", [False, True])
@pytest.mark.parametrize("activation", ["dice", "prelu"])
def test_din_eval_forward_matches_jax(data, activation, use_softmax):
    gen, hb = data
    jcfg = JaxDINConfig(hidden_units=HIDDEN, activation=activation,
                        use_softmax=use_softmax)
    jmodel = JaxDIN(config=jcfg, schema=wechat_schema(gen.vocab_sizes()))
    variables = jax_variables(jmodel, hb, seed=1)
    jlogits, jcoll = jmodel.apply(
        variables, {k: jnp.asarray(x) for k, x in hb.items()}, train=False,
        mutable=["losses"])

    model = DIN(DINConfig(hidden_units=HIDDEN, activation=activation,
                          use_softmax=use_softmax),
                t_wechat_schema(gen.vocab_sizes()))
    model.load_state_dict(convert.from_flax(variables))
    model.eval()
    with torch.no_grad():
        logits, losses = model({k: torch.from_numpy(x) for k, x in hb.items()})
    np.testing.assert_allclose(logits["read_comment"].numpy(),
                               np.asarray(jlogits["read_comment"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(losses["mba_l2"]),
                               float(jcoll["losses"]["mba_l2"][0]), rtol=1e-5, atol=1e-5)


def test_convert_round_trips_bit_exact(data):
    gen, hb = data
    schema = t_wechat_schema(gen.vocab_sizes())
    model = DIN(DINConfig(hidden_units=HIDDEN), schema, torch.Generator().manual_seed(0))
    with torch.no_grad():  # non-trivial running stats
        for name, buf in model.named_buffers():
            if name.endswith("running_mean") or name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    sd = model.state_dict()
    back = convert.from_flax(convert.to_flax(model))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k

    # flax -> torch -> flax keeps every JAX array, at the JAX key paths
    jmodel = JaxDIN(config=JaxDINConfig(hidden_units=HIDDEN),
                    schema=wechat_schema(gen.vocab_sizes()))
    variables = jax_variables(jmodel, hb, seed=2)
    model.load_state_dict(convert.from_flax(variables))
    again = convert.to_flax(model)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(again))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    assert again["params"]["attention"]["f1_att"]["kernel"].shape == (64, 64)


def test_full_width_shapes():
    """DINConfig defaults at the real WeChat table sizes: the width the
    README and the serving slice use."""
    cfg_cls, model_cls = get_model("DIN")
    model = model_cls(cfg_cls(), t_wechat_schema(), torch.Generator().manual_seed(0))
    tables = model.embedder.embed.tables
    assert tuple(tables["feedid"].shape) == (106496, 16)
    assert model.fcn.dense_0.in_features == 82
    assert [model.fcn.get_submodule(f"dense_{i}").out_features
            for i in range(3)] == [512, 256, 128]
    assert tuple(model.attention.f1_att.weight.shape) == (64, 64)


def test_bf16_precision_not_ported(data):
    """The name dates from before precision="bf16" was ported: DIN in bf16
    now builds, its fcn's dense layers run in bf16 (the logit stays f32),
    and its eval logits are f32, finite and within the JAX zoo test's rule
    (0.01 x max(1, max|logit|)) of the f32 model on the same weights; the
    parity with JAX's bf16 is tests/test_torch_precision.py's."""
    gen, hb = data
    schema = t_wechat_schema(gen.vocab_sizes())
    m32 = DIN(DINConfig(hidden_units=HIDDEN), schema, torch.Generator().manual_seed(0))
    m16 = DIN(DINConfig(hidden_units=HIDDEN, precision="bf16"), schema)
    m16.load_state_dict(m32.state_dict())
    assert m16.fcn.dense_0.compute_dtype is torch.bfloat16 and m16.fcn.logit.compute_dtype is None
    tb = {k: torch.from_numpy(v) for k, v in hb.items()}
    with torch.no_grad():
        a = m32.eval()(tb)[0]["read_comment"].numpy()
        b = m16.eval()(tb)[0]["read_comment"].numpy()
    assert b.dtype == np.float32 and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=0, atol=0.01 * max(1.0, float(np.abs(a).max())))
