"""Port parity for the dense-and-deep models: DeepCrossing, DCN, DCNv2 (full,
low rank, stacked), GDCN (parallel, stacked), GenericDNN (WeChat, two tasks,
Douban), DLRM, FinalMLP (with and without a learned context) and MaskNet
(parallel, serial) against the JAX models on the same batch with the JAX
weights carried across; the ``convert`` round trips; the full-width shapes;
the training CLI on the CPU.  Tolerances as tests/torch_zoo_common.py
states them; dropout is 0 in the parity runs, so neither side draws."""

import pytest
import torch

from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models import get_model
from tests.torch_zoo_common import (
    SMALL,
    batches,
    build_pair,
    check_cli_raises_without_a_gpu,
    check_cli_run,
    check_matches_jax,
    check_round_trips,
)

# case -> (registered name, config overrides for both packages, JAX-only
# overrides, schema)
CASES = {
    "DeepCrossing": ("DeepCrossing", dict(residual_internal_dim=24, residual_network_num=2),
                     {}, "wechat"),
    "DCN": ("DCN", dict(num_cross_layer=2, **SMALL), {}, "wechat"),
    "DCNv2": ("DCNv2", dict(SMALL), {}, "wechat"),
    "DCNv2-low-rank": ("DCNv2", dict(cross_low_rank=4, **SMALL), {}, "wechat"),
    "DCNv2-stacked": ("DCNv2", dict(structure="stacked", **SMALL), {}, "wechat"),
    "GDCN": ("GDCN", dict(SMALL), {}, "wechat"),
    "GDCN-stacked": ("GDCN", dict(structure="stacked", **SMALL), {}, "wechat"),
    "GenericDNN": ("GenericDNN", dict(SMALL), {}, "wechat"),
    "GenericDNN-two-tasks": ("GenericDNN", dict(task_names=("read_comment", "like"), **SMALL),
                             {}, "wechat"),
    "GenericDNN-douban": ("GenericDNN", dict(SMALL), {}, "douban"),
    "DLRM": ("DLRM", dict(bottom_hidden_units=(8,), **SMALL), {}, "wechat"),
    "FinalMLP": ("FinalMLP", dict(fs_hidden_units=(8,), **SMALL), {}, "wechat"),
    "FinalMLP-ctx1": ("FinalMLP", dict(fs1_fields=(), stream2_hidden_units=(24,), **SMALL),
                      {}, "wechat"),
    "MaskNet": ("MaskNet", dict(num_blocks=2, block_output_size=12, **SMALL), {}, "wechat"),
    "MaskNet-serial": ("MaskNet", dict(block_mode="serial", num_blocks=3, block_output_size=12,
                                       **SMALL), {}, "wechat"),
}


@pytest.fixture(scope="module")
def data():
    return batches()


def _pair(data, case):
    name, kw, jax_kw, schema = CASES[case]
    jschema, tschema, hb = data[schema]
    return (*build_pair(name, kw, jax_kw, jschema, tschema), hb)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(data, case):
    """Eval logits (running statistics), then train-mode logits, every
    parameter's gradient of the summed task means, and the updated BN
    statistics; every parameter that starts at zero is drawn first."""
    check_matches_jax(*_pair(data, case))


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_round_trips_bit_exact(data, case):
    check_round_trips(*_pair(data, case))


def test_full_width_shapes():
    """The config defaults at the real WeChat table sizes."""
    schema = t_wechat_schema()
    n_dense = len(schema.dense)
    gen = torch.Generator().manual_seed(0)

    def build(name, **kw):
        cfg_cls, cls = get_model(name)
        return cls(cfg_cls(**kw), schema, gen)

    m = build("DeepCrossing")
    assert m.res_0.inner.in_features == n_dense + 66 == m.logit.in_features
    assert m.res_0.inner.out_features == 128 and not hasattr(m, "res_1")
    assert tuple(m.embedder.embed.tables["feedid"].shape) == (106496, 16)
    assert tuple(m.embedder.embed.tables["device"].shape) == (256, 2)
    m = build("DCN")
    assert tuple(m.cross.w_0.shape) == (n_dense + 66, 1) and not hasattr(m.cross, "w_1")
    assert m.deep.dense_0.in_features == n_dense + 66 and m.deep.bn_2.eps == 1e-3
    assert m.logit.in_features == n_dense + 66 + 128
    m = build("DCNv2")
    assert tuple(m.cross_v2.w_1.shape) == (n_dense + 66, n_dense + 66)
    assert m.logit.in_features == n_dense + 66 + 128
    m = build("DCNv2", cross_low_rank=32, structure="stacked")
    assert tuple(m.cross_v2.u_0.shape) == (n_dense + 66, 32) and not hasattr(m.cross_v2, "w_0")
    assert m.logit.in_features == 128
    m = build("GDCN")
    assert tuple(m.gated_cross.g_2.shape) == (n_dense + 66, n_dense + 66)
    assert not hasattr(m.gated_cross, "w_3")
    m = build("GenericDNN")
    assert len(m.embedder.fields) == 8 and sorted(m.embedder.embed.tables) == sorted(
        {f.vocab for f in schema.categorical} | {f.vocab for f in schema.sequence})
    assert m.deep.dense_0.in_features == n_dense + 8 * 16 and hasattr(m, "logit_read_comment")
    m = build("DLRM")
    assert m.bottom.dense_0.in_features == n_dense and m.bottom_out.out_features == 16
    assert not hasattr(m.bottom, "dropout_0") and m.top.dropout_0.rate == 0.1
    assert m.top.dense_0.in_features == 16 + 36 and m.logit.in_features == 128
    m = build("FinalMLP")
    assert m.fs1.fs_0.in_features == 32 and m.fs1.fs_gate.out_features == n_dense + 8 * 16
    assert not hasattr(m, "ctx1") and m.stream2.dense_0.in_features == n_dense + 8 * 16
    assert tuple(m.fusion.w3.shape) == (2, 64, 64)
    assert tuple(build("FinalMLP", fs2_fields=()).ctx2.shape) == (16,)
    m = build("MaskNet")
    assert m.ln_emb.eps == 1e-6 and m.block_2.mask_agg.out_features == 256
    assert m.block_0.mask_agg.in_features == n_dense + 128 and m.block_0.hidden.bias is None
    assert m.head.dense_0.in_features == 3 * 64 + n_dense and not hasattr(m.head, "bn_0")
    m = build("MaskNet", block_mode="serial")
    assert m.block_1.hidden.in_features == 64 and m.logit.in_features == 64 + n_dense


@pytest.mark.parametrize("name,kw,match", [
    ("DCNv2", dict(structure="tower"), "parallel/stacked"),
    ("GDCN", dict(structure="tower"), "parallel/stacked"),
    ("MaskNet", dict(block_mode="tower"), "unknown block_mode")])
def test_unknown_wiring_raises(name, kw, match):
    cfg_cls, cls = get_model(name)
    with pytest.raises(ValueError, match=match):
        cls(cfg_cls(**kw), t_wechat_schema())


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

# each model's own flags at small widths
CLI_MODELS = {"DeepCrossing": dict(residual_internal_dim=16), "DCN": {},
              "DCNv2": dict(cross_low_rank=4), "GDCN": dict(structure="stacked"),
              "GenericDNN": dict(embedding_dim=4), "DLRM": dict(bottom_hidden_units=(8,)),
              "FinalMLP": dict(fs1_fields=()), "MaskNet": dict(block_mode="serial")}


@pytest.mark.parametrize("name", sorted(CLI_MODELS))
def test_cli_trains_exports_and_predicts(name, tmp_path):
    check_cli_run(name, CLI_MODELS[name], tmp_path)


@pytest.mark.parametrize("name", sorted(CLI_MODELS))
def test_cli_raises_without_a_gpu(name, tmp_path):
    check_cli_raises_without_a_gpu(name, CLI_MODELS[name], tmp_path)
