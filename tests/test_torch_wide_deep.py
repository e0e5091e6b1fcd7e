"""Port parity for Wide&Deep and what it brings: ``hashed_cross`` bit for bit,
the model (eval and train logits, gradients, BN statistics, the sown wide
kernel summaries) against the JAX model with the JAX weights carried
across, ``convert`` both ways with ``wide_embed_w``, FTRL and the dual
FTRL/deep optimizer step for step against the JAX package's optax
transformations, the histogram summary record, and the training CLI on the
CPU with a resume.  Tolerances as tests/torch_zoo_common.py states them;
optimizer steps rtol 1e-5 and atol 1e-6 (f32 on both sides, the same
formulas: rounding only)."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recalgorithm_tpu.embed.cross import hashed_cross as jax_hashed_cross
from recalgorithm_tpu.train import optimizers as joptimizers
from recalgorithm_tpu.utils.summary import SummaryWriter as JaxSummaryWriter
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.cli import main as tmain
from recalgorithm_tpu_torch.embed.cross import hashed_cross
from recalgorithm_tpu_torch.models import MODEL_REGISTRY
from recalgorithm_tpu_torch.train import optimizers as toptimizers
from recalgorithm_tpu_torch.utils.summary import SummaryWriter
from tests.torch_zoo_common import (
    SMALL,
    TOL,
    batches,
    build_pair,
    check_cli_raises_without_a_gpu,
    check_matches_jax,
    check_round_trips,
    cli_args,
    flat,
    jax_variables,
)

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
# the golden recipe's small cross, so the parity batch hits buckets twice
KW = dict(cross_hash_buckets=5000, **SMALL)


@pytest.mark.parametrize("shape", [(64,), (64, 6)], ids=["scalar", "sequence"])
@pytest.mark.parametrize("num_buckets", [100_000, 5000, 7])
def test_hashed_cross_is_bit_exact(shape, num_buckets):
    """int32 ids over their whole range, 0 (PAD) on either side and 2^31 - 1."""
    rng = np.random.default_rng(num_buckets)
    a = rng.integers(0, 2**31 - 1, 64, dtype=np.int64).astype(np.int32)
    b = rng.integers(0, 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
    a[:3] = (0, 2**31 - 1, 1)
    b[:4] = 0
    b[4:8] = 2**31 - 1
    want = np.asarray(jax_hashed_cross(jnp.asarray(a), jnp.asarray(b), num_buckets))
    got = hashed_cross(torch.from_numpy(a), torch.from_numpy(b), num_buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    valid = got.numpy() != 0
    assert (got.numpy()[valid] >= 1).all() and (got.numpy()[valid] <= num_buckets).all()


@pytest.fixture(scope="module")
def data():
    return batches()["wechat"]


@pytest.mark.parametrize("builtin", [False, True], ids=["WideAndDeep", "WideAndDeepBuiltin"])
def test_wide_and_deep_matches_jax(data, builtin):
    """Eval and train logits, every gradient (columns 1-7 of the wide table:
    zero on both sides), the BN statistics; and the summaries the train
    forward keeps, against the JAX model's sown ones."""
    jschema, schema, hb = data
    name = "WideAndDeepBuiltin" if builtin else "WideAndDeep"
    jmodel, model = build_pair(name, KW, {}, jschema, schema)
    check_matches_jax(jmodel, model, hb)
    variables = jax_variables(jmodel, hb, seed=1)
    _, upd = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in hb.items()}, train=True,
                          mutable=["batch_stats", "summaries"])
    assert set(model.sown) == set(upd["summaries"]) == {"wide_part_kernel",
                                                        "wide_part_kernel_l2_norm"}
    for tag, want in upd["summaries"].items():
        np.testing.assert_allclose(model.sown[tag].numpy(), np.asarray(want), **TOL)


def test_convert_round_trips_with_the_wide_table(data):
    jschema, schema, hb = data
    check_round_trips(*build_pair("WideAndDeep", KW, {}, jschema, schema), hb)


def test_registry_has_21_names():
    """Every name of the JAX registry is registered (27 with the multi-task
    family, DIEN and TwoTower), the W&D alias on the same classes."""
    from recalgorithm_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY) and len(MODEL_REGISTRY) == 27
    assert MODEL_REGISTRY["WideAndDeep"] == MODEL_REGISTRY["WideAndDeepBuiltin"]


@pytest.mark.parametrize("l1,l2", [(0.0, 0.0), (0.05, 0.1)])
def test_ftrl_steps_match_jax(l1, l2):
    """8 steps from random weights; row 2's gradient is 0 throughout, so its
    weights are replaced by the proximal solution of z = 0."""
    rng = np.random.default_rng(3)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(8)]
    for g in grads:
        g[2] = 0.0
    tx = joptimizers.ftrl(0.05, l1_regularization_strength=l1, l2_regularization_strength=l2)
    params = jnp.asarray(w0)
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = toptimizers.Optimizer(toptimizers.Ftrl(
        [p], 0.05, l1_regularization_strength=l1, l2_regularization_strength=l2),
        lambda step: 0.05)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)
        opt.zero_grad()
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), **STEP_TOL)
    ftrl_state = opt.opt.state[p]
    np.testing.assert_allclose(ftrl_state["z"].numpy(), np.asarray(state.z), **STEP_TOL)
    np.testing.assert_allclose(ftrl_state["n"].numpy(), np.asarray(state.n), **STEP_TOL)
    assert toptimizers.build("ftrl", 0.05)([torch.nn.Parameter(torch.zeros(2))]).opt.defaults[
        "l1"] == 0.0
    with pytest.raises(ValueError, match="constant"):
        toptimizers.build("ftrl", lambda step: 0.05)


def test_dual_wide_deep_steps_match_jax(data):
    """FTRL on wide_embed_w and wide_bias, Adam on the rest, 4 steps of
    random gradients from the JAX init; the state dict carries FTRL's z and
    n, and a dual optimizer restored from it continues the same steps."""
    jschema, schema, hb = data
    jmodel, model = build_pair("WideAndDeep", KW, {}, jschema, schema)
    variables = jax_variables(jmodel, hb, seed=1)
    params = variables["params"]
    tx = joptimizers.dual_wide_deep(0.01, "adam", 0.005, type(jmodel).wide_param_predicate)
    state = tx.init(params)
    model.load_state_dict(convert.from_flax(variables))
    names = [n for n, _ in model.named_parameters()]
    make = toptimizers.dual_wide_deep(0.01, "adam", 0.005, type(model).wide_param_predicate,
                                      names)
    opt = make(list(model.parameters()))
    assert {id(p) for p in opt.parts["wide"].opt.param_groups[0]["params"]} == {
        id(model.wide_bias), id(model.wide_embed_w.tables["cross_userid_manualtag"])}
    rng = np.random.default_rng(0)
    by_name = dict(model.named_parameters())

    def step(opt, g_tree):
        opt.zero_grad()
        for (name, g) in convert.from_flax({"params": g_tree}).items():
            by_name[name].grad = g.clone()
        opt.step()

    trees = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
             for _ in range(4)]
    saved = None
    for i, g_tree in enumerate(trees):
        upd, state = tx.update(g_tree, state, params)
        params = optax.apply_updates(params, upd)
        step(opt, g_tree)
        got = flat(convert.to_flax(model)["params"])
        for path, want in flat(params).items():
            np.testing.assert_allclose(got[path], np.asarray(want), **STEP_TOL, err_msg=str(path))
        if i == 1:
            saved = (copy.deepcopy(opt.state_dict()),
                     {k: v.clone() for k, v in model.state_dict().items()})
    wide = saved[0]["wide"]["opt"]["state"]
    assert all({"z", "n"} <= set(s) for s in wide.values()) and len(wide) == 2
    # restore after step 2 and take steps 3 and 4 again
    final = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(saved[1])
    again = make(list(model.parameters()))
    again.load_state_dict(saved[0])
    for g_tree in trees[2:]:
        step(again, g_tree)
    for k, v in model.state_dict().items():
        assert torch.equal(v, final[k]), k


def test_histogram_record_matches_jax(tmp_path):
    values = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    records = []
    for cls, d in ((JaxSummaryWriter, tmp_path / "jax"), (SummaryWriter, tmp_path / "torch")):
        w = cls(str(d))
        w.histogram(7, "summaries/wide_part_kernel", values)
        w.close()
        with open(d / "scalars.jsonl") as f:
            (rec,) = [json.loads(line) for line in f]
        rec.pop("time")
        records.append(rec)
    assert records[0] == records[1]
    assert len(records[1]["counts"]) == 30 and len(records[1]["edges"]) == 31


def _state(model_dir, step):
    return torch.load(model_dir / "checkpoints" / f"ckpt_{step}.pt", map_location="cpu",
                      weights_only=True)


def test_cli_trains_and_resumes_like_a_straight_run(tmp_path):
    """cli.main --device cpu: 6 steps straight against 3 and a resume to 6,
    bit for bit in the weights and in both optimizers' state (FTRL's z and n
    included); the wide kernel's summaries logged (its L2 norm a scalar, the
    kernel a 30-bin histogram record)."""
    flags = dict(cross_hash_buckets=5000)
    straight, split = tmp_path / "straight", tmp_path / "split"
    tmain.main(cli_args("WideAndDeep", flags, straight, 6, "--device", "cpu"))
    tmain.main(cli_args("WideAndDeep", flags, split, 3, "--device", "cpu"))
    tmain.main(cli_args("WideAndDeep", flags, split, 6, "--device", "cpu"))
    a, b = _state(straight, 6), _state(split, 6)
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for part in ("wide", "deep"):
        assert a["optimizer"][part]["count"] == b["optimizer"][part]["count"] == 6
        for i, s in a["optimizer"][part]["opt"]["state"].items():
            for key, v in s.items():
                assert torch.equal(torch.as_tensor(v),
                                   torch.as_tensor(b["optimizer"][part]["opt"]["state"][i][key]))
    assert a["model"]["wide_embed_w.tables.cross_userid_manualtag"][:, 0].abs().sum() > 0
    with open(straight / "summaries" / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    hists = [r for r in recs if r.get("histogram") == "summaries/wide_part_kernel"]
    norms = [r for r in recs if "summaries/wide_part_kernel_l2_norm" in r]
    assert [r["step"] for r in hists] == [r["step"] for r in norms] == [2, 4, 6]
    assert sum(hists[-1]["counts"]) == 5120  # every bucket row of the cross table


def test_cli_raises_without_a_gpu(tmp_path):
    check_cli_raises_without_a_gpu("WideAndDeep", dict(cross_hash_buckets=5000), tmp_path)
