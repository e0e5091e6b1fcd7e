"""Port parity for the models on PNN's field surface: AutoInt (and AutoInt+),
PNN (IPNN and OPNN, with the L2 regulariser), xDeepFM and FiBiNET against the
JAX models on the same batch with the JAX weights carried across; the
``convert`` round trips; the full-width shapes; the training CLI on the CPU.

Tolerances: eval logits and train-mode logits, losses and BN statistics
rtol = atol = 1e-5 (f32 on the CPU on both sides, JAX matmuls at "highest"
precision: summation order only); gradients rtol 1e-4 and atol 1e-5 *
max|g|, the bar of the port's other parity tests.  Dropout is 0 in the
parity runs, so neither side draws."""

import csv
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.cli import main as tmain
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models import get_model
from recalgorithm_tpu_torch.ops.cuda import bst_attention as bkern
from recalgorithm_tpu_torch.serving.predictor import Predictor

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(hidden_units=(32, 16), dropout_rate=0.0)

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


def assert_grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


@pytest.fixture(scope="module")
def data():
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=3, vocab_scale=0.005))
    hb = gen.batch(24, 7)
    hb["his_read_comment_7d_seq"][0], hb["his_read_comment_7d_seq_len"][0] = 0, 0
    hb["manual_tag_list"][1] = 0  # an all-PAD mean field
    return gen, hb


def _models(case, gen):
    name, kw, jax_kw = CASES[case]
    jcfg_cls, jcls = JAX_REGISTRY[name]
    jmodel = jcls(config=jcfg_cls(**kw, **jax_kw), schema=wechat_schema(gen.vocab_sizes()))
    cfg_cls, cls = get_model(name)
    return jmodel, cls(cfg_cls(**kw), t_wechat_schema(gen.vocab_sizes()))


def _variables(jmodel, hb, seed):
    """The JAX init, with BN running statistics drawn away from 0 / 1."""
    jb = {k: jnp.asarray(x) for k, x in hb.items()}
    v = jax.device_get(jax.jit(lambda b: jmodel.init(jax.random.key(seed), b))(jb))
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda x: rng.uniform(0.3, 3.0, x.shape).astype(np.float32),
                         v.get("batch_stats", {}))
    return {"params": v["params"], "batch_stats": stats}


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(data, case):
    """Eval logits (running statistics), then train-mode logits, the
    regularisation losses, every parameter's gradient of mean(logit) + the
    losses, and the updated BN statistics."""
    gen, hb = data
    jmodel, model = _models(case, gen)
    variables = _variables(jmodel, hb, seed=1)
    jb = {k: jnp.asarray(x) for k, x in hb.items()}

    @jax.jit
    def jax_run(variables, jb):
        jeval = jmodel.apply(variables, jb, train=False)["read_comment"]

        def train_loss(params):
            out, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    jb, train=True, mutable=["batch_stats", "losses"])
            reg = sum(jnp.sum(x) for x in jax.tree.leaves(upd.get("losses", {})))
            return jnp.mean(out["read_comment"]) + reg, (out["read_comment"], upd)

        (_, aux), grads = jax.value_and_grad(train_loss, has_aux=True)(variables["params"])
        return jeval, aux, grads

    with jax.default_matmul_precision("highest"):
        jeval, (jtrain, upd), jgrads = jax.device_get(jax_run(variables, jb))

    model.load_state_dict(convert.from_flax(variables))
    tb = {k: torch.from_numpy(x) for k, x in hb.items()}
    model.eval()
    with torch.no_grad():
        teval, _ = model(tb)
    np.testing.assert_allclose(teval["read_comment"].numpy(), jeval, **TOL)
    model.train()
    launches = bkern.bst_attention_forward_save.launches
    logits, losses = model(tb)
    assert bkern.bst_attention_forward_save.launches == launches  # CPU: the twin
    np.testing.assert_allclose(logits["read_comment"].detach().numpy(), jtrain, **TOL)
    # the sown losses, (x,) tuples keyed by the module path
    want_losses = {".".join(p): v for p, v in _flat(upd.get("losses", {})).items()}
    assert set(losses) == set(want_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), float(want_losses[k][0]), **TOL)
    (logits["read_comment"].mean() + sum(losses.values(), torch.zeros(()))).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    seen = set()
    for path, w in _flat(jgrads).items():  # each JAX gradient, carried to its torch name
        (name, want), = convert.from_flax({"params": _unflat({path: w})}).items()
        assert_grad_close(grads[name].numpy(), want.numpy())
        seen.add(name)
    assert seen == set(grads)
    got_stats = _flat(convert.to_flax(model).get("batch_stats", {}))
    want_stats = _flat(upd.get("batch_stats", {}))
    assert set(got_stats) == set(want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_round_trips_bit_exact(data, case):
    gen, hb = data
    jmodel, model = _models(case, gen)
    with torch.no_grad():
        for p in model.parameters():  # zero-initialised leaves too
            p.uniform_(-1.0, 1.0)
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.uniform_(0.5, 1.5)
    sd = model.state_dict()
    back = convert.from_flax(convert.to_flax(model))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k

    variables = _variables(jmodel, hb, seed=2)
    model.load_state_dict(convert.from_flax(variables))
    again, want = _flat(convert.to_flax(model)), _flat(variables)
    assert set(again) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(again[path], leaf)


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


def _cli_args(name, model_dir, steps, *extra):
    flags = [f"--{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
             for k, v in CLI_MODELS[name].items()]
    return ["--model", name, "--synthetic", "--synthetic_vocab_scale", "0.005",
            "--batch_size", "16", "--train_steps", str(steps), "--hidden_units", "16,8",
            "--log_every", "2", "--eval_every_steps", "2", "--model_dir", str(model_dir),
            "--predictions_csv", str(model_dir / "predictions.csv"), *flags, *extra]


@pytest.mark.parametrize("name", sorted(CLI_MODELS))
def test_cli_trains_exports_and_predicts(name, tmp_path):
    final = tmain.main(_cli_args(name, tmp_path, 4, "--device", "cpu"))
    assert 0.0 <= final["read_comment_auc"] <= 1.0
    with open(tmp_path / "predictions.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["read_comment_probabilities"]
    assert len(rows) == 1 + tmain.EVAL_BATCHES * 16
    cfg_cls, cls = get_model(name)
    cfg = cfg_cls(hidden_units=(16, 8), **CLI_MODELS[name])
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=42, vocab_scale=0.005))
    pred = Predictor(cls(cfg, t_wechat_schema(gen.vocab_sizes())),
                     Predictor.latest_best(str(tmp_path)), device="cpu")
    out = pred.predict_batch(gen.batch(8, 1))["read_comment"]
    assert out.shape == (8,) and np.isfinite(out).all()


@pytest.mark.parametrize("name", sorted(CLI_MODELS))
def test_cli_raises_without_a_gpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: cuda is a valid default here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(_cli_args(name, tmp_path, 2))
