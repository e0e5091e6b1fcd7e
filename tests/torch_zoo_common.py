"""Helpers of the port's model-parity tests (tests/test_torch_zoo*.py): a JAX
model and its port on one batch with the JAX weights carried across.

Tolerances: eval logits and train-mode logits, losses and BN statistics
rtol = atol = 1e-5 (f32 on the CPU on both sides, JAX matmuls at "highest"
precision: summation order only); gradients rtol 1e-4 and atol 1e-5 *
max|g|, the bar of the port's other parity tests."""

import csv
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu.features.schema import douban_schema, wechat_schema
from recalgorithm_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.cli import main as tmain
from recalgorithm_tpu_torch.features import schema as tschema
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models import get_model
from recalgorithm_tpu_torch.ops.cuda import bst_attention as bkern
from recalgorithm_tpu_torch.serving.predictor import Predictor

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(hidden_units=(32, 16), dropout_rate=0.0)


def assert_grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def unflat(leaves):
    tree = {}
    for path, v in leaves.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def wechat_batch():
    """The seeded WeChat batch: 24 rows, an empty behaviour sequence in row
    0 and an all-PAD manual_tag mean field in row 1."""
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=3, vocab_scale=0.005))
    hb = gen.batch(24, 7)
    hb["his_read_comment_7d_seq"][0], hb["his_read_comment_7d_seq_len"][0] = 0, 0
    hb["manual_tag_list"][1] = 0  # an all-PAD mean field
    return gen, hb


# Douban at small vocabularies: USER_MD5, MOVIE_ID and ACTOR_IDS take the
# large-table (clip) lookup rule, the others the dense one.
DOUBAN_SIZES = {"USER_MD5": 3000, "MOVIE_ID": 2500, "DIRECTOR_IDS": 500, "ACTOR_IDS": 2600,
                "GENRES": 40, "LANGUAGES": 100, "REGIONS": 100, "YEAR": 120}


def batches():
    """{schema name: (JAX schema, port schema, seeded batch)}: the WeChat
    batch of :func:`wechat_batch` and a Douban batch of :func:`schema_batch`."""
    gen, hb = wechat_batch()
    return {"wechat": (wechat_schema(gen.vocab_sizes()), t_wechat_schema(gen.vocab_sizes()), hb),
            "douban": (douban_schema(DOUBAN_SIZES), tschema.douban_schema(DOUBAN_SIZES),
                       schema_batch(douban_schema(DOUBAN_SIZES), 24, seed=5))}


def build_pair(name, kw, jax_kw, jschema, schema):
    """The JAX model ``name`` on ``jschema`` and its port on ``schema``, both
    with the config overrides ``kw`` (``jax_kw``: the JAX side's only)."""
    jcfg_cls, jcls = JAX_REGISTRY[name]
    cfg_cls, cls = get_model(name)
    return jcls(config=jcfg_cls(**kw, **jax_kw), schema=jschema), cls(cfg_cls(**kw), schema)


def schema_batch(schema, batch_size: int, seed: int) -> dict[str, np.ndarray]:
    """A batch of ``schema.batch_spec`` drawn from ``seed``: ids in [0, vocab]
    (0 is PAD), each sequence a random length of valid ids then PAD, row 0's
    sequences empty; dense normal, labels 0/1."""
    rng = np.random.default_rng(seed)
    hb = {}
    for name, (shape, dtype) in schema.batch_spec(batch_size).items():
        if name == "dense":
            hb[name] = rng.normal(size=shape).astype(dtype)
        elif name == "labels":
            hb[name] = (rng.random(shape) < 0.3).astype(dtype)
    for f in schema.categorical:
        hb[f.name] = rng.integers(0, schema.vocab_sizes[f.vocab] + 1, batch_size).astype(np.int32)
    for f in schema.sequence:
        lengths = rng.integers(0, f.max_length + 1, batch_size).astype(np.int32)
        lengths[0] = 0
        ids = rng.integers(1, schema.vocab_sizes[f.vocab] + 1, (batch_size, f.max_length))
        hb[f.name] = np.where(np.arange(f.max_length) < lengths[:, None], ids, 0).astype(np.int32)
        hb[f.name + "_len"] = lengths
    return hb


def jax_variables(jmodel, hb, seed, init_train=False):
    """The JAX init, with BN running statistics drawn away from 0 / 1 and
    every parameter that starts at zero (FirstOrderLogit's tables and bias,
    biases, FinalMLP's contexts, ...) drawn uniformly, so a parity run
    reads it.  ``init_train``: initialise with ``train=True`` (and a
    dropout stream), for a model that creates a parameter in train mode
    only (DIEN's ``aux_project_matrix``)."""
    jb = {k: jnp.asarray(x) for k, x in hb.items()}
    if init_train:
        rngs = {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)}
        init = lambda b: jmodel.init(rngs, b, train=True)
    else:
        init = lambda b: jmodel.init(jax.random.key(seed), b)
    v = jax.device_get(jax.jit(init)(jb))
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda x: rng.uniform(0.3, 3.0, x.shape).astype(np.float32),
                         v.get("batch_stats", {}))
    params = jax.tree.map(
        lambda x: rng.uniform(-0.5, 0.5, x.shape).astype(np.float32) if not np.any(x) else x,
        v["params"])
    return {"params": params, "batch_stats": stats}


def check_matches_jax(jmodel, model, hb, seed=1, init_train=False):
    """Eval logits (running statistics), then train-mode logits, the
    regularisation losses, every parameter's gradient of mean(logits) + the
    losses, and the updated BN statistics, for every task."""
    variables = jax_variables(jmodel, hb, seed, init_train)
    jb = {k: jnp.asarray(x) for k, x in hb.items()}

    @jax.jit
    def jax_run(variables, jb):
        jeval = jmodel.apply(variables, jb, train=False)

        def train_loss(params):
            out, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    jb, train=True, mutable=["batch_stats", "losses"])
            reg = sum(jnp.sum(x) for x in jax.tree.leaves(upd.get("losses", {})))
            return sum(jnp.mean(v) for v in out.values()) + reg, (out, upd)

        (_, aux), grads = jax.value_and_grad(train_loss, has_aux=True)(variables["params"])
        return jeval, aux, grads

    with jax.default_matmul_precision("highest"):
        jeval, (jtrain, upd), jgrads = jax.device_get(jax_run(variables, jb))

    model.load_state_dict(convert.from_flax(variables))
    tb = {k: torch.from_numpy(x) for k, x in hb.items()}
    model.eval()
    with torch.no_grad():
        teval, _ = model(tb)
    assert set(teval) == set(jeval)
    for task, want in jeval.items():
        np.testing.assert_allclose(teval[task].numpy(), want, **TOL)
    model.train()
    launches = bkern.bst_attention_forward_save.launches
    logits, losses = model(tb)
    assert bkern.bst_attention_forward_save.launches == launches  # CPU: the twin
    assert set(logits) == set(jtrain)
    for task, want in jtrain.items():
        np.testing.assert_allclose(logits[task].detach().numpy(), want, **TOL)
    # the sown losses, (x,) tuples keyed by the module path
    want_losses = {".".join(p): v for p, v in flat(upd.get("losses", {})).items()}
    assert set(losses) == set(want_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), float(want_losses[k][0]), **TOL)
    (sum(v.mean() for v in logits.values()) + sum(losses.values(), torch.zeros(()))).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    seen = set()
    for path, w in flat(jgrads).items():  # each JAX gradient, carried to its torch name
        (name, want), = convert.from_flax({"params": unflat({path: w})}).items()
        assert_grad_close(grads[name].numpy(), want.numpy())
        seen.add(name)
    assert seen == set(grads)
    got_stats = flat(convert.to_flax(model).get("batch_stats", {}))
    want_stats = flat(upd.get("batch_stats", {}))
    assert set(got_stats) == set(want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, **TOL)


def check_every_parameter_gets_a_gradient(model, hb, optimizer="adam"):
    """The trainer's loss of a train-mode forward on ``hb`` reaches every
    parameter.  The port's optimizers step after
    ``zero_grad(set_to_none=True)`` and skip a parameter without a gradient,
    where optax would still move it by its moments."""
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    tasks = tuple(model.config.task_names) or (model.schema.labels[0],)
    tr = Trainer(model, tasks, optimizers.build(optimizer, 1e-3),
                 TrainerConfig(model_dir="unused"), device="cpu")
    model.train()
    loss, _ = tr._loss_and_logits(tr._put_batch(hb))
    loss.backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert not missing, missing


def check_round_trips(jmodel, model, hb, init_train=False):
    """``convert`` both ways, bit-exact: the port's weights through a flax
    tree and back, and the JAX init through the port and back."""
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

    variables = jax_variables(jmodel, hb, seed=2, init_train=init_train)
    model.load_state_dict(convert.from_flax(variables))
    again, want = flat(convert.to_flax(model)), flat(variables)
    assert set(again) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(again[path], leaf)


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------


def cli_flags(name, flags):
    """The model's own ``flags``, with the tower at 16/8 where it has one."""
    if "hidden_units" in get_model(name)[0].__dataclass_fields__:
        return {"hidden_units": (16, 8), **flags}
    return dict(flags)


def cli_args(name, flags, model_dir, steps, *extra):
    """cli.main's arguments for ``name`` at small widths (B=16, vocab scale
    0.005) with ``cli_flags(name, flags)``."""
    own = [f"--{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
           for k, v in cli_flags(name, flags).items()]
    return ["--model", name, "--synthetic", "--synthetic_vocab_scale", "0.005",
            "--batch_size", "16", "--train_steps", str(steps),
            "--log_every", "2", "--eval_every_steps", "2", "--model_dir", str(model_dir),
            "--predictions_csv", str(model_dir / "predictions.csv"), *own, *extra]


def check_cli_run(name, flags, tmp_path):
    """4 steps on the CPU: the final eval, predictions.csv, and a best export
    that Predictor reloads."""
    final = tmain.main(cli_args(name, flags, tmp_path, 4, "--device", "cpu"))
    assert 0.0 <= final["read_comment_auc"] <= 1.0
    with open(tmp_path / "predictions.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["read_comment_probabilities"]
    assert len(rows) == 1 + tmain.EVAL_BATCHES * 16
    cfg_cls, cls = get_model(name)
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=42, vocab_scale=0.005))
    pred = Predictor(cls(cfg_cls(**cli_flags(name, flags)), t_wechat_schema(gen.vocab_sizes())),
                     Predictor.latest_best(str(tmp_path)), device="cpu")
    out = pred.predict_batch(gen.batch(8, 1))["read_comment"]
    assert out.shape == (8,) and np.isfinite(out).all()


def check_cli_raises_without_a_gpu(name, flags, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: cuda is a valid default here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(cli_args(name, flags, tmp_path, 2))
