"""precision="bf16" for every registry name: the dense towers' and the
experts' products in bf16, everything else f32 (ops/mlp.py, ops/experts.py).

Tolerances:
  * the port's bf16 eval logits against the JAX package's bf16 logits on the
    same weights (JAX run eagerly: under ``jit`` XLA on the CPU keeps the
    bias add in f32, the "excess precision" it is allowed, where flax's Dense
    rounds the product and the bias add to bf16 and so does the port):
    atol = 2e-4 * max(1, max|logit|).  Summation order in f32 can move one
    product across a bf16 rounding boundary (2^-8 relative), which the
    layers after it carry to the logit; the other rounding rule (product
    only) moves DCN's logits by 6.9e-4 of their scale, so this bar tells the
    rules apart;
  * the port's bf16 against its own f32 on the same weights: the JAX test's
    rule (tests/test_models_zoo.py::test_bf16_precision_close_to_f32),
    atol = 0.01 * max(1, max|logit|), on each model's seeded init;
  * the port's bf16 against itself with every weight moved by 1e-6
    (relative): within the same 0.01 * max(1, max|logit|).  Two devices'
    f32 sums differ by about that much and can move a product across a bf16
    rounding boundary, which is why chip_smoke.py holds the card's bf16
    logits to the CPU's at a bar of each model's own, not at 2e-4 (a
    one-ulp flip of a hidden unit moves a logit by up to 4.4e-3 of its
    scale here, MaskNet);
  * building a bf16 Dense turns off cuBLAS's bf16 partial sums;
  * one bf16 train step's gradients (DeepFM: towers; MMOE: experts) against
    the JAX bf16 step's: each within 1e-2 * max|g| of that tensor, the
    cotangents being rounded to bf16 at each cast on both sides; a bf16
    Dense's bias within 5e-2 * max|g|: its gradient is the batch sum of bf16
    cotangents, which XLA on the CPU adds with a bf16 running sum (``lax.
    reduce`` in bf16 rounds every partial sum; 2.4% of the tensor's scale
    here) where torch adds in f32 and rounds once.  The towers' BatchNorm is
    off in that step: a bias in front of a train-mode BN has a true gradient
    of 0, and each side's is rounding noise.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models import MODEL_REGISTRY, get_model
from recalgorithm_tpu_torch.models.common import TrainFlags
from tests.torch_zoo_common import flat, unflat, wechat_batch

# small widths, each where the config has the field
SMALL = {"hidden_units": (32, 16), "expert_hidden_units": 16, "output_dimension": 8,
         "cin_layer_feature_maps": (8, 8), "attention_factor": 8, "cross_hash_buckets": 1000,
         "dropout_rate": 0.0, "num_experts_per_task": (2, 2, 2), "num_experts_in_shared": 2,
         "bottom_hidden_units": (16,), "gru_output_units": 4, "output_dim": 8}
JAX_ONLY = {"use_fused_attention": "false"}  # the Pallas kernels' plain path
VS_JAX = 2e-4
VS_F32 = 0.01
GRAD = 1e-2
GRAD_BF16_BIAS = 5e-2


@pytest.fixture(scope="module")
def data():
    gen, hb = wechat_batch()
    return (wechat_schema(gen.vocab_sizes()), t_wechat_schema(gen.vocab_sizes()), hb,
            {k: jnp.asarray(v) for k, v in hb.items()},
            {k: torch.from_numpy(v) for k, v in hb.items()})


def _kw(cfg_cls, table):
    fields = set(cfg_cls.__dataclass_fields__)
    return {k: v for k, v in table.items() if k in fields}


def _port(name, schema, precision, seed=0, **kw):
    cfg_cls, cls = get_model(name)
    return cls(cfg_cls(**_kw(cfg_cls, SMALL), precision=precision, **kw), schema,
               torch.Generator().manual_seed(seed))


def _jax(name, schema, precision, **kw):
    cfg_cls, cls = JAX_REGISTRY[name]
    cfg = cfg_cls(**_kw(cfg_cls, SMALL), **_kw(cfg_cls, JAX_ONLY), precision=precision, **kw)
    return cls(config=cfg, schema=schema)


def _randomise(model, seed=1):
    """Parameters that start at zero (biases, ...) drawn uniformly and BN
    statistics away from 0 / 1, so every rounding of the towers is read."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.uniform_(-0.5, 0.5, generator=g)
        for n, b in model.named_buffers():
            if n.endswith(("running_mean", "running_var")):
                b.uniform_(0.3, 3.0, generator=g)


def _eval(model, tb):
    model.eval()
    with torch.no_grad():
        return {t: v.numpy() for t, v in model(tb)[0].items()}


def _check_logits(name, got: dict, tasks):
    assert set(got) == set(tasks)
    for t, v in got.items():
        assert v.dtype == np.float32 and v.shape == (24,), (name, t, v.dtype, v.shape)
        assert np.isfinite(v).all(), (name, t)


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_bf16_matches_jax_bf16(data, name):
    jschema, schema, _, jb, tb = data
    model = _port(name, schema, "bf16")
    _randomise(model)
    got = _eval(model, tb)
    variables = jax.tree.map(jnp.asarray, convert.to_flax(model))
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(_jax(name, jschema, "bf16").apply(variables, jb, train=False))
    _check_logits(name, got, want)
    for t, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[t], w, rtol=0, atol=VS_JAX * scale, err_msg=(name, t))


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_bf16_close_to_f32(data, name):
    """The JAX zoo test's rule on the port: bf16 within 1% of the f32
    logits' scale on the same (seeded init) weights."""
    _, schema, _, _, tb = data
    m32 = _port(name, schema, "f32")
    m16 = _port(name, schema, "bf16", seed=99)
    m16.load_state_dict(m32.state_dict())
    want, got = _eval(m32, tb), _eval(m16, tb)
    _check_logits(name, got, want)
    for t, a in want.items():
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(got[t], a, rtol=0, atol=VS_F32 * scale, err_msg=(name, t))


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_bf16_under_f32_rounding_noise(data, name):
    _, schema, _, _, tb = data
    model = _port(name, schema, "bf16")
    _randomise(model)
    moved = _port(name, schema, "bf16", seed=99)
    g = torch.Generator().manual_seed(5)
    moved.load_state_dict({k: v * (1 + 1e-6 * torch.randn(v.shape, generator=g))
                           if v.is_floating_point() else v
                           for k, v in model.state_dict().items()})
    want, got = _eval(model, tb), _eval(moved, tb)
    _check_logits(name, got, want)
    for t, a in want.items():
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(got[t], a, rtol=0, atol=VS_F32 * scale, err_msg=(name, t))


@pytest.mark.parametrize("name", ["DeepFM", "MMOE"])
def test_bf16_train_step_gradients_match_jax(data, name):
    """Train-mode forward (batch statistics) and the gradient of the mean
    logits plus the sown losses, every parameter, against the JAX bf16
    step."""
    jschema, schema, _, jb, tb = data
    model = _port(name, schema, "bf16", batch_norm=False)
    _randomise(model)
    variables = jax.tree.map(jnp.asarray, convert.to_flax(model))
    variables.setdefault("batch_stats", {})
    jmodel = _jax(name, jschema, "bf16", batch_norm=False)

    def loss(params):
        out, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jb, train=True, mutable=["batch_stats", "losses"])
        reg = sum(jnp.sum(x) for x in jax.tree.leaves(upd.get("losses", {})))
        return sum(jnp.mean(v) for v in out.values()) + reg

    with jax.default_matmul_precision("highest"):
        jgrads = jax.device_get(jax.grad(loss)(variables["params"]))
    model.train()
    logits, losses = model(tb)
    (sum(v.mean() for v in logits.values()) + sum(losses.values(), torch.zeros(()))).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    seen = set()
    for path, w in flat(jgrads).items():
        (pname, want), = convert.from_flax({"params": unflat({path: w})}).items()
        g = grads[pname].numpy()
        assert g.dtype == np.float32 and np.isfinite(g).all(), pname
        scale = max(float(np.abs(want.numpy()).max()), 1e-12)
        tol = GRAD_BF16_BIAS if re.search(r"dense_\d+\.bias$", pname) else GRAD
        np.testing.assert_allclose(g, want.numpy(), rtol=0, atol=tol * scale, err_msg=pname)
        seen.add(pname)
    assert seen == set(grads)


def test_compute_dtype():
    assert TrainFlags().compute_dtype is None
    assert TrainFlags(precision="bf16").compute_dtype is torch.bfloat16
    with pytest.raises(ValueError, match="unknown precision"):
        TrainFlags(precision="fp8").compute_dtype


def test_bf16_dense_turns_off_reduced_precision_sums():
    """Building a bf16 Dense turns off cuBLAS's bf16 partial sums (torch's
    default allows them), so a bf16 product sums in f32 on the card too; an
    f32 Dense leaves the setting alone."""
    from recalgorithm_tpu_torch.ops.mlp import Dense

    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        Dense(4, 2)
        assert matmul.allow_bf16_reduced_precision_reduction
        Dense(4, 2, compute_dtype=torch.bfloat16)
        assert not matmul.allow_bf16_reduced_precision_reduction
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
