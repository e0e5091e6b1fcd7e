"""The trainer's fields the JAX TrainerConfig has (keep_best, handle_sigterm,
fuse_optimizer, compact_grad_scatter) with its defaults and meanings; every
optimizer's multi-tensor update against its formula applied one parameter at
a time, bitwise per coordinate (what tests/test_optimizers.py::
test_maybe_fuse_matches_unfused holds of optax.flatten); and the CLI flags of
this slice (--precision bf16, --no_compact_grad_scatter, --output_dir)."""

import copy
import dataclasses
import signal

import numpy as np
import pytest
import torch

from recalgorithm_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from recalgorithm_tpu_torch.cli import main as tmain
from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu_torch.features.schema import wechat_schema
from recalgorithm_tpu_torch.models.deepfm import DeepFM, DeepFMConfig
from recalgorithm_tpu_torch.train import optimizers
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

OPTIMIZERS = ("adam", "ftrl", "lazyadam", "adagrad", "rmsprop", "sgd")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().view(np.int32)


def test_fields_and_defaults_are_jax():
    ours = {f.name: f.default for f in dataclasses.fields(TrainerConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainerConfig)}
    for name in ("keep_best", "handle_sigterm", "fuse_optimizer", "compact_grad_scatter"):
        assert ours[name] == theirs[name], name
    # the JAX fields without a counterpart on the card
    assert set(theirs) - set(ours) == {"rng_impl", "scoped_vmem_limit_kib",
                                       "shard_map_embeddings"}


def _per_parameter(name: str, lr: float):
    """``name``'s update written one parameter at a time (optax's formulas,
    the JAX package's FTRL and lazy_adam), for the multi-tensor chains to be
    held to; Adam and SGD: torch's multi-tensor path, the card's default."""
    if name == "adam":
        return lambda ps: torch.optim.Adam(ps, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                           foreach=True)
    if name == "sgd":
        return lambda ps: torch.optim.SGD(ps, lr=lr, foreach=True)

    class PerParameter(torch.optim.Optimizer):
        def __init__(self, params):
            super().__init__(params, {})
            self.count = 0

        @torch.no_grad()
        def step(self):
            self.count += 1
            n = torch.tensor(float(self.count), dtype=torch.float32)
            c1 = float(1 - torch.tensor(0.9, dtype=torch.float32) ** n)
            c2 = float(1 - torch.tensor(0.999, dtype=torch.float32) ** n)
            for p in self.param_groups[0]["params"]:
                g, st = p.grad, self.state[p]
                if name == "adagrad":
                    acc = st.setdefault("acc", torch.full_like(p, 1e-8))
                    acc.add_(g.square())
                    p.add_(torch.where(acc > 0, torch.rsqrt(acc + 1e-7),
                                       torch.zeros_like(acc)) * g, alpha=-lr)
                elif name == "rmsprop":
                    nu = st.setdefault("nu", torch.zeros_like(p))
                    nu.copy_((1 - 0.9) * g.square() + 0.9 * nu)
                    p.add_(torch.rsqrt(nu + 1e-8) * g, alpha=-lr)
                elif name == "ftrl":
                    z = st.setdefault("z", torch.zeros_like(p))
                    acc = st.setdefault("n", torch.full_like(p, 0.1))
                    n_new = acc + g * g
                    z.copy_(z + g - (n_new ** 0.5 - acc ** 0.5) / lr * p)
                    acc.copy_(n_new)
                    p.copy_(torch.where(z.abs() > 0.0, -z / (n_new ** 0.5 / lr),
                                        torch.zeros_like(z)))
                else:  # lazyadam
                    mu = st.setdefault("mu", torch.zeros_like(p))
                    nu = st.setdefault("nu", torch.zeros_like(p))
                    hit = g != 0
                    mu.copy_(torch.where(hit, 0.9 * mu + (1 - 0.9) * g, mu))
                    nu.copy_(torch.where(hit, 0.999 * nu + (1 - 0.999) * g * g, nu))
                    step = -lr * (mu / c1) / (torch.sqrt(nu / c2) + 1e-8)
                    p.add_(torch.where(hit, step, torch.zeros_like(step)))

    return PerParameter


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_multi_tensor_update_matches_per_parameter(name):
    """Three steps on gradients with zeros in them (LazyAdam's rows, FTRL's
    l1 region), then a fourth after a checkpoint round trip: every
    coordinate bitwise the per-parameter update's."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (4, 2)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ours = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    ref = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    opt, ref_opt = optimizers.build(name, 0.05)(ours), _per_parameter(name, 0.05)(ref)
    for i in range(4):
        if i == 3:  # restored as a checkpoint holds it
            restored = optimizers.build(name, 0.05)(ours)
            restored.load_state_dict(copy.deepcopy(opt.state_dict()))
            opt = restored
        grads = [(rng.normal(size=s) * (rng.random(s) > 0.3)).astype(np.float32)
                 for s in shapes]
        for p, q, g in zip(ours, ref, grads):
            p.grad, q.grad = torch.from_numpy(g.copy()), torch.from_numpy(g.copy())
        opt.step()
        ref_opt.step()
        for p, q in zip(ours, ref):
            np.testing.assert_array_equal(_bits(p), _bits(q), err_msg=f"{name} step {i}")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_step_without_gradients_moves_nothing(name):
    """A step in which no parameter has a gradient (a group left out of the
    loss) leaves every parameter as it was, as the per-parameter update did."""
    params = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))]
    optimizers.build(name, 0.1)(params).step()
    for p in params:
        np.testing.assert_array_equal(p.detach().numpy(), 1.0)


def test_dual_optimizer_steps_each_part_alone():
    """The W&D dual optimizer: FTRL on the parameters its predicate picks,
    the deep optimizer on the rest, each bitwise as when built alone."""
    rng = np.random.default_rng(1)
    init = {n: rng.normal(size=(3, 2)).astype(np.float32) for n in ("w", "d", "w2")}
    params = {n: torch.nn.Parameter(torch.from_numpy(x.copy())) for n, x in init.items()}
    alone = {n: torch.nn.Parameter(torch.from_numpy(x.copy())) for n, x in init.items()}
    dual = optimizers.dual_wide_deep(0.5, "adagrad", 0.1, lambda n: n.startswith("w"),
                                     list(params))(list(params.values()))
    parts = [optimizers.build("ftrl", 0.5)([alone["w"], alone["w2"]]),
             optimizers.build("adagrad", 0.1)([alone["d"]])]
    for _ in range(2):
        for n in params:
            g = rng.normal(size=(3, 2)).astype(np.float32)
            params[n].grad, alone[n].grad = torch.from_numpy(g.copy()), torch.from_numpy(g)
        dual.step()
        for opt in parts:
            opt.step()
    for n in params:
        np.testing.assert_array_equal(_bits(params[n]), _bits(alone[n]), err_msg=n)


@pytest.fixture(scope="module")
def gen():
    return SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=2, vocab_scale=0.005))


def _deepfm_trainer(gen, tmp_path, tag, **cfg):
    model = DeepFM(DeepFMConfig(hidden_units=(16, 8), dropout_rate=0.0),
                   wechat_schema(gen.vocab_sizes()), torch.Generator().manual_seed(0))
    return Trainer(model, ("read_comment",), optimizers.build("adagrad", 0.05),
                   TrainerConfig(model_dir=str(tmp_path / tag), save_checkpoints_steps=0,
                                 **cfg), device="cpu")


def test_trainer_fuse_optimizer(gen, tmp_path):
    """fuse_optimizer is accepted (off by default, as in JAX) and trains
    bitwise as without it: the update is already multi-tensor."""
    assert not TrainerConfig().fuse_optimizer
    batches = [gen.batch(32, i) for i in range(3)]
    runs = {}
    for fuse in (False, True):
        tr = _deepfm_trainer(gen, tmp_path, str(fuse), fuse_optimizer=fuse)
        runs[fuse] = ([float(tr.train_step(hb)) for hb in batches],
                      {k: p.detach().clone() for k, p in tr.model.named_parameters()})
    assert runs[False][0] == runs[True][0]
    for k, v in runs[False][1].items():
        np.testing.assert_array_equal(_bits(runs[True][1][k]), _bits(v), err_msg=k)


@pytest.mark.parametrize("handle", [True, False])
def test_handle_sigterm(gen, tmp_path, monkeypatch, handle):
    """The handler goes in (and comes out) only with handle_sigterm."""
    calls = []
    real = signal.signal
    monkeypatch.setattr(signal, "signal",
                        lambda sig, h: calls.append(sig) or real(sig, h))
    tr = _deepfm_trainer(gen, tmp_path, "sig", handle_sigterm=handle, train_steps=2,
                         log_every=1)
    tr.train_and_evaluate(gen.batches(16, 2))
    assert calls == ([signal.SIGTERM, signal.SIGTERM] if handle else [])


def test_keep_best(gen, tmp_path):
    """keep_best exports kept, the highest eval AUCs."""
    from recalgorithm_tpu_torch import convert

    assert TrainerConfig().keep_best == 5
    tr = _deepfm_trainer(gen, tmp_path, "best", keep_best=1, train_steps=4, eval_every_steps=1,
                         log_every=2)
    tr.train_and_evaluate(gen.batches(16, 4), lambda: gen.batches(16, 2, 5000))
    best = convert.read_best(str(tmp_path / "best"))
    assert len(best) == 1


def _cli(tmp_path, model, *extra):
    return ["--model", model, "--synthetic", "--synthetic_vocab_scale", "0.005",
            "--batch_size", "16", "--train_steps", "3", "--hidden_units", "16,8",
            "--log_every", "3", "--model_dir", str(tmp_path), "--predictions_csv",
            str(tmp_path / "p.csv"), "--device", "cpu", *extra]


def test_cli_precision_bf16(tmp_path):
    final = tmain.main(_cli(tmp_path / "bf16", "DeepFM", "--precision", "bf16",
                            "--output_dir", str(tmp_path / "out")))
    assert np.isfinite(final["loss"]) and 0.0 <= final["read_comment_auc"] <= 1.0


def test_cli_no_compact_grad_scatter(tmp_path, monkeypatch):
    """DIN through the CLI with and without --no_compact_grad_scatter: the
    flag reaches the trainer, compaction engages by default (MIN_IDS 0 for
    these small batches), and the runs end with the same metrics."""
    from recalgorithm_tpu_torch.ops import compact_scatter as cs

    monkeypatch.setattr(cs, "MIN_IDS", 0)
    calls = []
    plain = cs.take_compact_bwd
    monkeypatch.setattr(cs, "take_compact_bwd", lambda t, i: calls.append(1) or plain(t, i))
    on = tmain.main(_cli(tmp_path / "on", "DIN"))
    assert calls
    n = len(calls)
    off = tmain.main(_cli(tmp_path / "off", "DIN", "--no_compact_grad_scatter"))
    assert len(calls) == n
    assert on == off
