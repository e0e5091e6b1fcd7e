"""Port parity for the FM family: DeepFM (WeChat and Douban), FFM, FwFM, AFM
and NFM against the JAX models on the same batch with the JAX weights
carried across, and FirstOrderLogit on its own; the ``convert`` round trips
(FirstOrderLogit's ``embed_w`` tables included); the full-width shapes; the
training CLI on the CPU.  Tolerances as tests/torch_zoo_common.py states
them; dropout is 0 in the parity runs, so neither side draws (NFM: see
``test_model_matches_jax``)."""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.features import schema as jschema_mod
from recalgorithm_tpu.models.common import FirstOrderLogit as JaxFirstOrderLogit
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.features import schema as tschema_mod
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models import common, get_model
from tests.torch_zoo_common import (
    SMALL,
    TOL,
    assert_grad_close,
    batches,
    build_pair,
    check_cli_raises_without_a_gpu,
    check_cli_run,
    check_matches_jax,
    check_round_trips,
    flat,
    jax_variables,
    unflat,
)

# case -> (registered name, config overrides for both packages, JAX-only
# overrides, schema)
CASES = {
    "DeepFM": ("DeepFM", dict(SMALL), {}, "wechat"),
    "DeepFM-douban": ("DeepFM", dict(SMALL), {}, "douban"),
    "FFM": ("FFM", dict(embedding_dim=4), {}, "wechat"),
    "FwFM": ("FwFM", {}, {}, "wechat"),
    "AFM": ("AFM", dict(attention_factor=6), {}, "wechat"),
    "NFM": ("NFM", dict(SMALL), {}, "wechat"),
}


@pytest.fixture(scope="module")
def data():
    return batches()


def _pair(data, case):
    name, kw, jax_kw, schema = CASES[case]
    jschema, tschema, hb = data[schema]
    return (*build_pair(name, kw, jax_kw, jschema, tschema), hb)


class _NoDropout:
    """Stands in for ``flax.linen.Dropout`` in NFM's parity run: the identity."""

    def __init__(self, rate, deterministic=None):
        del rate, deterministic

    def __call__(self, x):
        return x


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(data, case, monkeypatch):
    """Eval logits (running statistics), then train-mode logits, every
    parameter's gradient of the logits' mean, and the updated BN statistics;
    FirstOrderLogit's tables and bias, zero at init, are drawn first.

    NFM's bi-interaction dropout is 0.1 whatever ``dropout_rate`` says
    (nfm.py:54), so its train mode would draw: here, in this test only,
    flax's Dropout is the identity (``flax.linen.Dropout`` monkeypatched,
    which the JAX NFM looks up when it is applied) and the port's
    ``bi_interaction_dropout`` has rate 0."""
    jmodel, model, hb = _pair(data, case)
    if case == "NFM":
        monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
        model.bi_interaction_dropout.rate = 0.0
    check_matches_jax(jmodel, model, hb)


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_round_trips_bit_exact(data, case):
    check_round_trips(*_pair(data, case))


def test_first_order_logit_matches_jax(data):
    """Each field kind (scalar, sum, mean) on both lookup rules (device and
    manual_tag_id take the dense one, feedid the clip one), with ids past
    the vocabulary; the drawn weights carried across, then the gradients."""
    jschema, tschema, hb = data["wechat"]
    hb = dict(hb)
    hb["device"] = hb["device"].copy()
    hb["device"][:3] = (0, 3, 300)  # PAD, past the vocabulary, past the table
    hb["feedid"] = hb["feedid"].copy()
    hb["feedid"][:2] = (0, jschema.vocab_sizes["feedid"] + 5)
    fields = [("device", "device", "scalar"), ("feedid", "feedid", "scalar"),
              ("manual_tag_list", "manual_tag_id", "sum"),
              ("his_read_comment_7d_seq", "feedid", "mean")]
    jmod = JaxFirstOrderLogit(schema=jschema, fields=fields)
    variables = jax_variables(jmod, hb, seed=3)
    jb = {k: jnp.asarray(v) for k, v in hb.items()}
    with jax.default_matmul_precision("highest"):
        want, jgrads = jax.value_and_grad(
            lambda p: jnp.sum(jmod.apply({"params": p}, jb) ** 2))(variables["params"])
    mod = common.FirstOrderLogit(tschema, fields)
    mod.load_state_dict(convert.from_flax(variables))
    out = mod({k: torch.from_numpy(v) for k, v in hb.items()})
    got = (out ** 2).sum()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    got.backward()
    grads = dict(mod.named_parameters())
    for path, w in flat(jax.device_get(jgrads)).items():
        (name, g), = convert.from_flax({"params": unflat({path: w})}).items()
        assert_grad_close(grads[name].grad.numpy(), g.numpy())


def test_douban_schema_is_the_jax_packages():
    for sizes in (None, {"GENRES": 7}):
        j, t = jschema_mod.douban_schema(sizes), tschema_mod.douban_schema(sizes)
        assert repr(t) == repr(j).replace("recalgorithm_tpu.", "recalgorithm_tpu_torch.")
    assert tschema_mod.DOUBAN_MAX_HISTORY == jschema_mod.DOUBAN_MAX_HISTORY
    assert tschema_mod.DOUBAN_LABELS == jschema_mod.DOUBAN_LABELS
    assert tschema_mod.DOUBAN_DENSE_NAMES == jschema_mod.DOUBAN_DENSE_NAMES


def test_schema_derived_fields():
    """The reference's 6 fields on WeChat, the schema's own on Douban, where
    DeepFM's first order sums what its FM fields mean-pool."""
    wechat, douban = t_wechat_schema(), tschema_mod.douban_schema()
    assert common.reference_or_schema_fields(wechat) == [
        (n, n, "scalar") for n in common.SCALAR_CAT_FIELDS]
    fields = common.reference_or_schema_fields(douban)
    assert fields == common.schema_fields(douban)
    assert fields[:4] == [("USER_MD5", "USER_MD5", "scalar"), ("MOVIE_ID", "MOVIE_ID", "scalar"),
                          ("DIRECTOR_ID", "DIRECTOR_IDS", "scalar"), ("YEAR", "YEAR", "scalar")]
    assert [k for _, _, k in fields[4:]] == ["mean"] * 5
    assert len(common.schema_fields(douban, sequences=None)) == 4
    cfg_cls, cls = get_model("DeepFM")
    m = cls(cfg_cls(), douban)
    assert [k for _, _, k in m.first_order.fields[4:]] == ["sum"] * 5
    assert m.tasks == ("rating_ge_4",) and m.deep.dense_0.in_features == 9 * 8


def test_full_width_shapes():
    """The config defaults at the real WeChat table sizes."""
    schema = t_wechat_schema()
    n_dense = len(schema.dense)
    gen = torch.Generator().manual_seed(0)

    def build(name, **kw):
        cfg_cls, cls = get_model(name)
        return cls(cfg_cls(**kw), schema, gen)

    m = build("DeepFM")
    assert tuple(m.first_order.embed_w.tables["feedid"].shape) == (106496, 1)
    assert tuple(m.first_order.embed_w.tables["device"].shape) == (256, 1)
    assert tuple(m.first_order.bias.shape) == (1,) and not m.first_order.bias.any()
    assert not any(t.any() for t in m.first_order.embed_w.tables.values())
    assert tuple(m.embedder.embed.tables["userid"].shape) == (20224, 8)
    assert m.deep.dense_0.in_features == 6 * 8 and m.deep.logits.out_features == 1
    assert m.tasks == ("read_comment",)
    m = build("FFM")
    assert tuple(m.embed.tables["feedid"].shape) == (106496, 40)
    assert sorted(m.embed.tables) == sorted(common.SCALAR_CAT_FIELDS)
    m = build("FwFM")
    assert tuple(m.fields_pair_strength_weight.shape) == (15, 1)
    m = build("AFM")
    assert m.dense_logit.in_features == n_dense and tuple(m.p.shape) == (8, 1)
    assert m.attention.attention_w.out_features == 128
    assert tuple(m.embedder.embed.tables["manual_tag_id"].shape) == (512, 8)
    m = build("NFM")
    assert m.bi_interaction_bn.eps == 1e-3 and m.bi_interaction_bn.momentum == 0.01
    assert m.bi_interaction_dropout.rate == 0.1
    assert build("NFM", dropout_rate=0.0).bi_interaction_dropout.rate == 0.1
    assert m.dense_0.in_features == 8 and m.logit.in_features == 128
    assert m._order[:4] == ["dense_0", "relu_0", "bn_0", "dropout_0"]


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

# each model's own flags at small widths
CLI_MODELS = {"DeepFM": {}, "FFM": dict(embedding_dim=4), "FwFM": {},
              "AFM": dict(attention_factor=16), "NFM": {}}


@pytest.mark.parametrize("name", sorted(CLI_MODELS))
def test_cli_trains_exports_and_predicts(name, tmp_path):
    check_cli_run(name, CLI_MODELS[name], tmp_path)


@pytest.mark.parametrize("name", sorted(CLI_MODELS))
def test_cli_raises_without_a_gpu(name, tmp_path):
    check_cli_raises_without_a_gpu(name, CLI_MODELS[name], tmp_path)
