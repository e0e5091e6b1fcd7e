"""Port parity for the models on PNN's field surface: AutoInt (and AutoInt+),
PNN (IPNN and OPNN, with the L2 regulariser), xDeepFM and FiBiNET against the
JAX models on the same batch with the JAX weights carried across; the
``convert`` round trips; the full-width shapes; the training CLI on the CPU.
Tolerances as tests/torch_zoo_common.py states them.  Dropout is 0 in the
parity runs, so neither side draws."""

import pytest
import torch

from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models import get_model
from tests.torch_zoo_common import (
    SMALL,
    build_pair,
    check_cli_raises_without_a_gpu,
    check_cli_run,
    check_matches_jax,
    check_round_trips,
    wechat_batch,
)

# case -> (registered name, config overrides for both packages, JAX-only overrides)
CASES = {
    "AutoInt": ("AutoInt", {}, dict(use_fused_attention="false")),
    "AutoInt+": ("AutoInt", dict(use_deep_tower=True, **SMALL),
                 dict(use_fused_attention="false")),
    "PNN-IPNN": ("PNN", dict(output_dimension=16, weight_regularizer=0.01, **SMALL), {}),
    "PNN-OPNN": ("PNN", dict(output_dimension=16, weight_regularizer=0.01,
                             product_method="OPNN", **SMALL), {}),
    "xDeepFM": ("xDeepFM", dict(hidden_units=(32, 16), cin_layer_feature_maps=(6, 5)), {}),
    "FiBiNET": ("FiBiNET", dict(SMALL), {}),
}


@pytest.fixture(scope="module")
def data():
    return wechat_batch()


def models(case, gen):
    return build_pair(*CASES[case], wechat_schema(gen.vocab_sizes()),
                      t_wechat_schema(gen.vocab_sizes()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(data, case):
    """Eval logits (running statistics), then train-mode logits, the
    regularisation losses, every parameter's gradient of mean(logit) + the
    losses, and the updated BN statistics."""
    gen, hb = data
    check_matches_jax(*models(case, gen), hb)


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_round_trips_bit_exact(data, case):
    gen, hb = data
    check_round_trips(*models(case, gen), hb)


def test_full_width_shapes():
    """The config defaults at the real WeChat table sizes."""
    schema = t_wechat_schema()
    n_dense = len(schema.dense)
    gen = torch.Generator().manual_seed(0)

    def build(name, **kw):
        cfg_cls, cls = get_model(name)
        return cls(cfg_cls(**kw), schema, gen)

    m = build("AutoInt")
    assert tuple(m.embedder.embed.tables["feedid"].shape) == (106496, 16)
    assert len(m.embedder.fields) == 8 and m.dense_field.in_features == n_dense
    assert tuple(m.interact_0.w_query.shape) == (16, 32)
    assert tuple(m.interact_2.w_res.shape) == (32, 32)
    assert m.logit.in_features == 9 * 32 and not hasattr(m, "deep")
    m = build("AutoInt", use_deep_tower=True)
    assert m.deep.dense_0.in_features == n_dense + 9 * 16  # dense_field included
    assert m.deep_logit.in_features == 128 and m.deep.bn_0.eps == 1e-3
    m = build("PNN")
    assert tuple(m.embedder.embed.tables["manual_tag_id"].shape) == (512, 8)
    assert tuple(m.linear_w.shape) == (64, 1024)
    assert tuple(m.inner_product.inner_product_w.shape) == (1024, 8)
    assert m.fcn.dense_0.in_features == 1024 and m.fcn.logits.out_features == 1
    assert tuple(build("PNN", product_method="OPNN").outer_product.outer_product_w.shape) \
        == (1024, 8, 8)
    m = build("xDeepFM")
    assert m.linear.in_features == n_dense + 64
    assert tuple(m.cin_0.filter.shape) == (64, 50) and tuple(m.cin_1.filter.shape) == (400, 50)
    assert m.cin_logit.bias is None and m.dnn_logit.bias is None
    assert m.cin_logit.in_features == 150 and m.dnn_0.in_features == n_dense + 64
    m = build("FiBiNET")
    assert m.linear.in_features == n_dense and tuple(m.senet.w1.shape) == (8, 4)
    assert tuple(m.bilinear_original.w_all.shape) == (8, 8)
    assert m.dense_0.in_features == 21 * 16 and m.dropout_0.rate == 0.1


def test_unknown_product_method_raises():
    cfg_cls, cls = get_model("PNN")
    with pytest.raises(ValueError, match="IPNN or OPNN"):
        cls(cfg_cls(product_method="KPNN"), t_wechat_schema())


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

# each model's own flags, small widths (the golden recipe's tower)
CLI_MODELS = {"AutoInt": dict(att_layers=2), "PNN": dict(output_dimension=16),
              "xDeepFM": dict(cin_layer_feature_maps=(4, 3)),
              "FiBiNET": dict(bilinear_interaction_type="each")}


@pytest.mark.parametrize("name", sorted(CLI_MODELS))
def test_cli_trains_exports_and_predicts(name, tmp_path):
    check_cli_run(name, CLI_MODELS[name], tmp_path)


@pytest.mark.parametrize("name", sorted(CLI_MODELS))
def test_cli_raises_without_a_gpu(name, tmp_path):
    check_cli_raises_without_a_gpu(name, CLI_MODELS[name], tmp_path)
