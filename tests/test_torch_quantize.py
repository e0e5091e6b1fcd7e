"""Port parity for int8 serving tables (serving/quantize.py): ``quantize_table``
bit for bit against the JAX package's, its error bound; the tables
``quantize_model`` turns into int8 buffers for every registered model against
the JAX ``build_qtables``, values and scales bit for bit; and the quantized
forward of DIN, BST, DeepFM and Wide&Deep against the JAX model applied with
its ``qtables``, within rtol = atol = 1e-5 (f32 on both sides after the
same int8 rows and scales: summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu.serving import quantize as jqz
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models import MODEL_REGISTRY
from recalgorithm_tpu_torch.serving import quantize as qz
from recalgorithm_tpu_torch.serving.predictor import Predictor
from tests.torch_zoo_common import TOL, build_pair, flat, jax_variables

# vocab scale 0.05: feedid (5.3k rows), W&D's cross and the first-order
# feedid table take the gather rule and are quantized, the small tables stay
# dense and f32
SCALE = 0.05
SMALL = dict(hidden_units=(16,), dropout_rate=0.0)


def test_quantize_table_is_the_jax_function():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((512, 16)) * rng.gamma(1.0, 2.0, (512, 1))).astype(np.float32)
    x[7] = 0.0  # an all-zero row: scale 1.0, exact
    q, scale = qz.quantize_table(x)
    jq, jscale = jqz.quantize_table(x)
    assert q.dtype == np.int8 and scale.dtype == np.float32 and scale.shape == (512, 1)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale, jscale)
    dq = q.astype(np.float32) * scale
    assert np.all(np.abs(dq - x) <= scale / 2 + 1e-7)
    np.testing.assert_array_equal(dq[7], 0.0)
    x1 = rng.standard_normal((256, 1)).astype(np.float32)  # FM first-order weights
    q1, s1 = qz.quantize_table(x1)
    np.testing.assert_allclose(q1.astype(np.float32) * s1, x1, rtol=1e-6)


@pytest.fixture(scope="module")
def gen():
    return SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=11, vocab_scale=SCALE))


def _pair(name, gen, **kw):
    cfg_fields = MODEL_REGISTRY[name][0].__dataclass_fields__
    kw = {k: v for k, v in {**SMALL, **kw}.items() if k in cfg_fields}
    jmodel, model = build_pair(name, kw, {}, wechat_schema(gen.vocab_sizes()),
                               t_wechat_schema(gen.vocab_sizes()))
    hb = gen.batch(24, 7)
    hb["his_read_comment_7d_seq"][0], hb["his_read_comment_7d_seq_len"][0] = 0, 0
    variables = jax_variables(jmodel, hb, seed=1)  # zero-init tables drawn
    model.load_state_dict(convert.from_flax(variables))
    return jmodel, model, variables, hb


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_quantized_tables_match_jax_build_qtables(gen, name):
    """The same tables quantized, to the same int8 rows and scales; their f32
    parameters gone from the module."""
    _, model, variables, _ = _pair(name, gen)
    want = flat(jqz.build_qtables(variables["params"]))
    assert want, f"{name}: no table is large enough to quantize at scale {SCALE}"
    qtables = qz.quantize_model(model)
    got = flat(qtables)
    assert set(got) == set(want)
    for path, w in want.items():
        module = model.get_submodule(convert.torch_module_name(path[:-1]))
        buf = module.get_buffer(path[-1])
        np.testing.assert_array_equal(buf.numpy(), w)
        np.testing.assert_array_equal(got[path], w)
        assert buf.dtype == (torch.int8 if path[-1].endswith("__q") else torch.float32)
        assert path[-1].rsplit("__", 1)[0] not in module.tables
    assert qz.quantized_bytes(qtables) == jqz.quantized_bytes(jqz.build_qtables(
        variables["params"]))


@pytest.mark.parametrize("name", ["BST", "DIN", "DeepFM", "WideAndDeep"])
def test_quantized_forward_matches_jax(gen, name):
    jmodel, model, variables, hb = _pair(name, gen)
    qtables = jqz.build_qtables(variables["params"])
    jb = {k: jnp.asarray(v) for k, v in hb.items()}
    with jax.default_matmul_precision("highest"):
        jlogits, _ = jmodel.apply(
            {"params": jqz.strip_quantized(variables["params"], qtables),
             "batch_stats": variables["batch_stats"], "qtables": qtables},
            jb, train=False, mutable=["losses"])
    tb = {k: torch.from_numpy(v) for k, v in hb.items()}
    model.eval()
    with torch.no_grad():
        f32 = model(tb)[0]
        qz.quantize_model(model)
        got = model(tb)[0]
    for task, want in jlogits.items():
        np.testing.assert_allclose(got[task].numpy(), np.asarray(want), **TOL)
        assert not torch.equal(got[task], f32[task]), "the int8 tables were not read"
        p, p32 = torch.sigmoid(got[task]), torch.sigmoid(f32[task])
        assert float((p - p32).abs().max()) < 0.02  # the JAX package's bound


def test_predictor_quantize_flag(gen, tmp_path):
    """``Predictor(quantize=True)`` serves int8 tables: within 0.02 of f32,
    the JAX package's bound, and equal to the model quantized by hand."""
    _, model, _, hb = _pair("DIN", gen)
    export_dir = convert.save_export(str(tmp_path), 1, 0.5, model)
    schema = t_wechat_schema(gen.vocab_sizes())
    cfg_cls, cls = MODEL_REGISTRY["DIN"]
    cfg = cfg_cls(**SMALL)
    f32 = Predictor(cls(cfg, schema), export_dir, device="cpu").predict_batch(hb)
    qpred = Predictor(cls(cfg, schema), export_dir, device="cpu", quantize=True)
    assert flat(qpred.qtables)
    got = qpred.predict_batch(hb)["read_comment"]
    assert 0 < np.max(np.abs(got - f32["read_comment"])) < 0.02
    qz.quantize_model(model)
    with torch.no_grad():
        want = torch.sigmoid(model.eval()({k: torch.from_numpy(v) for k, v in hb.items()})[0][
            "read_comment"]).numpy()
    np.testing.assert_array_equal(got, want)
