"""DIEN as the benchmark's cell trains it (AUGRU, the auxiliary loss with 3
in-batch negatives, the Dice tower with batch norm and dropout, LazyAdam),
held to the benchmark's plain reference (``portbench/reference/dien.py``)
on the CPU at a small size: B = 16, T = 6, tables of a few hundred rows,
GRU width 4, tower 16-8.  The weights come from the seed
(``portbench/weights_dien.py``), the batches from the cell's traffic law.

The reference runs in float64 on the same (float32) weights and the same
dropout masks (drawn as float32 uniforms from a generator seeded as the
trainer's), so each gap below is the program's own float32 rounding.  Two
recurrences of 6 steps, a softmax and a tower of width at most 74 round a
logit to a few float32 ulps of the sums behind it; the gradients' leaf
norms carry that through the backward.  Every planted change (AGRU for
AUGRU, the auxiliary loss dropped, half a batch) moves a leaf's norm by
percent, far above these tolerances.

Also: ``optimizers.LazyAdam`` with its count on the device (a tensor rate)
against its host form, bitwise, and its checkpoint; the configuration
file; the weights' spec; the spans of ``DIEN.forward``; the cell's driver
at the small size, with and without a planted fault; the FLOP count; and
that the reference imports nothing of the program.
"""

import copy
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from portbench import flops_dien, harness, weights, weights_dien
from portbench.kinds import program_model
from portbench.reference import dien as ref_dien
from portbench.traffic import train as traffic
from recalgorithm_tpu_torch.models.dien import DIEN
from recalgorithm_tpu_torch.ops.activations import Dropout
from recalgorithm_tpu_torch.train import optimizers
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig
from recalgorithm_tpu_torch.utils import summary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "dien-train-short"
SEED = 2147483999
B, T = 16, 6

# Norm-wise gap of a leaf's gradient or value over the reference's norm: a
# float32 rounding of each sum, compounded by the recurrences.  The worst
# leaf reads 2.8e-6 here (the first Dice's alpha, a sum over 16 rows of
# terms that cancel), its value after three steps 6.0e-7.
NORM_RTOL = 2e-5
# Logits and losses: float32 rounding of sums of at most 74 terms, each of
# order 1, through two recurrences (the losses read 2.7e-7 here).
ABS_TOL = 2e-5
# A planted change must move some leaf by this many tolerances at least.
FAULT_MARGIN = 100


def published() -> dict:
    return harness.config(harness.cell(CELL)["config"])


def small_cfg(**config) -> dict:
    """The configuration file at the small size: the schema's vocabularies
    and sequence lengths, the batch, the GRU and tower widths; ``config``
    overrides model keys."""
    cfg = copy.deepcopy(published())
    cfg["batch_size"] = B
    cfg["config"].update(hidden_units=[16, 8], gru_output_units=4, **config)
    schema = cfg["schema"]
    schema["vocab_sizes"] = {"userid": 300, "feedid": 400, "device": 2, "authorid": 200,
                             "bgm_song_id": 200, "bgm_singer_id": 150, "manual_tag_id": 50}
    schema["history"]["max_length"] = T
    schema["tags"]["max_length"] = 4
    return cfg


def small_traffic() -> dict:
    return {**harness.cell(CELL)["traffic"], "num_batches": 3, "label_rate": 0.3,
            "history": {"law": "geometric", "p": 0.3}}


def tensors(batch, dtype=None):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if dtype is not None:
        out["dense"], out["labels"] = out["dense"].to(dtype), out["labels"].to(dtype)
    return out


def norm_gap(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def f64(params):
    return {k: v.detach().double() for k, v in params.items()}


@pytest.fixture(scope="module")
def host_batches():
    return traffic.batches(small_cfg()["schema"], small_traffic(), B, SEED)


def program(cfg, tmp_path, seed=SEED):
    """The program's DIEN holding the seed's weights, and its trainer on
    the configuration's LazyAdam (on the CPU: its host form)."""
    w = weights.make(cfg, seed, "cpu")
    model, mcfg = program_model(cfg, w, "cpu")
    trainer = Trainer(model, mcfg.task_names, optimizers.build(mcfg.optimizer,
                                                               mcfg.learning_rate),
                      TrainerConfig(seed=seed, handle_sigterm=False, model_dir=str(tmp_path)),
                      device="cpu")
    return trainer, weights.trainable(cfg, w)


def reference_run(cfg, batches, seed=SEED):
    """The reference's three steps in float64 from the seed's weights, its
    dropout from the trainer's stream (seed + 1)."""
    params = f64(weights.trainable(cfg, weights.make(cfg, seed, "cpu")))
    return ref_dien.train(params, cfg, [tensors(b, torch.float64) for b in batches],
                          seed + 1, "cpu")


def leaf_gaps(cfg, tmp_path, batches):
    """The program's first gradients and its leaves after three steps
    against the reference's: the largest norm gap of each, and the losses'
    largest absolute gap."""
    trainer, _ = program(cfg, tmp_path)
    losses, grads = [], None
    for b in batches:
        losses.append(float(trainer.train_step(b)))
        if grads is None:
            grads = {k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()}
    ref_losses, first, after = reference_run(cfg, batches)
    named = dict(trainer.model.named_parameters())
    return (max(abs(a - b) for a, b in zip(losses, ref_losses)),
            {k: norm_gap(grads[k], first[k]) for k in first},
            {k: norm_gap(named[k], after[k]) for k in after})


# ---------------------------------------------------------------------------
# the configuration, the weights
# ---------------------------------------------------------------------------


def test_configuration_file_states_the_published_dien():
    cfg = published()
    model = cfg["config"]
    assert cfg["model"] == "DIEN" and cfg["precision"] == "f32" and cfg["batch_size"] == 4096
    assert cfg["reduced"] == []
    assert "tangxyw/RecAlgorithm" in cfg["source"] and "1809.03672" in cfg["source"]
    assert model["custom_gru_type"] == "AUGRU" and model["use_auxiliary_loss"] is True
    assert model["negative_sample_number"] == 3 and model["gru_output_units"] == 8
    assert model["hidden_units"] == [512, 256, 128] and model["activation"] == "dice"
    assert model["batch_norm"] is True and model["dropout_rate"] == 0.1
    assert model["optimizer"] == "lazyadam" and model["learning_rate"] == 0.005
    assert cfg["optimizer"] == {"name": "lazyadam", "b1": 0.9, "b2": 0.999, "eps": 1e-8}
    assert cfg["schema"]["embedding_dims"]["feedid"] == 16
    assert cfg["schema"]["history"]["max_length"] == 50
    assert cfg["aux_loss_weight"] == 1.0 and len(cfg["assumed"]) == 4
    # the schema is BST's cell's, field for field
    assert cfg["schema"] == harness.config("bst-wechat")["schema"]
    bench = harness.benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "dien-wechat")
    assert entry["source"] == cfg["source"] and entry["reduced"] == []


def test_cell_traffic_is_bst_train_short():
    assert harness.cell(CELL)["traffic"] == harness.cell("bst-train-short")["traffic"]
    assert harness.cell(CELL)["chips"] == 1 and harness.cell(CELL)["kind"] == "train_dien"


@pytest.mark.parametrize("which", ["published", "small"])
def test_weights_spec_is_the_state_dict(which):
    cfg = published() if which == "published" else small_cfg()
    model, _ = program_model(cfg, None, "cpu")
    assert isinstance(model, DIEN) and model.evolution.cell_type == "AUGRU"
    spec = weights_dien.spec(cfg)
    assert len(spec) == len(model.state_dict())
    assert {n: tuple(s) for n, s, _ in spec} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# the program against the reference
# ---------------------------------------------------------------------------


def test_logits_and_auxiliary_loss_match_reference(host_batches, tmp_path):
    """One train-mode forward with dropout from a generator seeded alike on
    both sides: the logits and the auxiliary loss."""
    cfg = small_cfg()
    trainer, _ = program(cfg, tmp_path)
    model = trainer.model
    model.train()
    generator = torch.Generator().manual_seed(5)  # one stream, as the trainer's
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    logits, losses = model(tensors(host_batches[0]))
    params = f64(weights.trainable(cfg, weights.make(cfg, SEED, "cpu")))
    ref_logits, ref_aux = ref_dien.forward(params, cfg, tensors(host_batches[0], torch.float64),
                                           torch.Generator().manual_seed(5))
    torch.testing.assert_close(logits["read_comment"].double(), ref_logits, atol=ABS_TOL, rtol=0)
    assert set(losses) == {"aux"} and float(ref_aux) > 1.0
    assert abs(float(losses["aux"].detach()) - float(ref_aux)) < ABS_TOL * abs(float(ref_aux))


def test_gradients_and_three_lazyadam_steps_match_reference(host_batches, tmp_path):
    """Three ``Trainer.train_step`` s on LazyAdam against the reference's
    three steps: each loss, every leaf's first gradient, every leaf after."""
    loss_gap, grad_gaps, after_gaps = leaf_gaps(small_cfg(), tmp_path, host_batches)
    print(f"loss gap {loss_gap:.3e}, worst gradient gap {max(grad_gaps.values()):.3e}, "
          f"worst leaf gap after 3 steps {max(after_gaps.values()):.3e}")
    assert loss_gap < ABS_TOL
    assert len(grad_gaps) == len([n for n, _, law in weights_dien.spec(small_cfg())
                                  if law is not None and "running" not in n])
    for k, g in grad_gaps.items():
        assert g < NORM_RTOL, (k, g)
    for k, g in after_gaps.items():
        assert g < NORM_RTOL, (k, g)


@pytest.mark.parametrize("change", ["agru", "aux_dropped"])
def test_a_planted_change_fails_the_comparison(change, host_batches, tmp_path, monkeypatch):
    """The program with AGRU in place of AUGRU, or without the auxiliary
    loss, against the reference of the configuration: far off."""
    from portbench import control_dien

    control_dien.FAULTS[change](monkeypatch.setattr)
    cfg = small_cfg()
    trainer, _ = program(cfg, tmp_path)
    trainer.train_step(host_batches[0])
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in trainer.model.named_parameters()}
    _, first, _ = reference_run(cfg, host_batches[:1])
    worst = max(norm_gap(grads[k], first[k]) for k in first)
    assert worst > FAULT_MARGIN * NORM_RTOL, worst


def test_reference_imports_no_program():
    code = ("import sys; sys.path.insert(0, '.'); import portbench.reference.dien, "
            "portbench.weights_dien, portbench.flops_dien; "
            "bad = [m for m in sys.modules if m.split('.')[0].startswith('recalgorithm_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


# ---------------------------------------------------------------------------
# LazyAdam's device form
# ---------------------------------------------------------------------------


def _gradients(params, steps: int = 6):
    """Gradients with zeros in every step, and a leaf without one in step 2."""
    gen = torch.Generator().manual_seed(1)
    return [[None if (j == 2 and i == 1) else
             torch.randn(p.shape, generator=gen) * (torch.rand(p.shape, generator=gen) > 0.5)
             for j, p in enumerate(params)] for i in range(steps)]


def _params():
    gen = torch.Generator().manual_seed(0)
    return [torch.nn.Parameter(torch.randn(shape, generator=gen)) for shape in ((40, 4), (7,), (3,))]


SCHEDULE = optimizers.make_schedule(0.05, "cosine", warmup_steps=1, decay_steps=4)


def _lazy_steps(tensor_rate: bool):
    params = _params()
    lr = torch.tensor(SCHEDULE(0)) if tensor_rate else SCHEDULE(0)
    opt = optimizers.Optimizer(optimizers.LazyAdam(params, lr=lr), SCHEDULE)
    for grads in _gradients(params):
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
    return params, opt


def _host_form_steps(b1=0.9, b2=0.999, eps=1e-8):
    """LazyAdam as it stepped with its count on the host: the corrections
    worked out as host floats from a Python int, then the same f32 ops."""
    params = _params()
    state = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    with torch.no_grad():
        for n, grads in enumerate(_gradients(params), start=1):
            lr = SCHEDULE(n - 1)
            t = torch.tensor(float(n), dtype=torch.float32)
            c1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
            c2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
            for p, g, (mu, nu) in zip(params, grads, state):
                if g is None:
                    continue
                hit = g != 0
                mu.copy_(torch.where(hit, mu * b1 + g * (1 - b1), mu))
                nu.copy_(torch.where(hit, nu * b2 + g * (1 - b2) * g, nu))
                move = mu / c1 * -lr / (torch.sqrt(nu / c2) + eps)
                p.add_(torch.where(hit, move, torch.zeros_like(move)))
    return params, state


def test_lazyadam_device_count_matches_host_form_bitwise():
    """The count lives on the parameters' device (what a CUDA graph
    captures); the updates are those of the host-float form, bit for bit,
    with a float rate and with a tensor rate (graph-safe) alike."""
    host, host_state = _host_form_steps()
    for tensor_rate in (False, True):
        dev, opt = _lazy_steps(tensor_rate)
        assert opt.capturable is tensor_rate
        count = opt.opt.param_groups[0]["count"]
        assert torch.is_tensor(count) and count.dtype == torch.int64 and int(count) == 6
        for a, b in zip(host, dev):
            assert torch.equal(a, b)
        for (mu, nu), st in zip(host_state, opt.opt.state.values()):
            assert torch.equal(mu, st["mu"]) and torch.equal(nu, st["nu"])


def test_lazyadam_device_count_checkpoints_as_an_int():
    """A checkpoint holds the count as an int; a load writes it into the
    tensor a captured update reads, and counts as a new version."""
    _, opt = _lazy_steps(True)
    count, rate = opt.opt.param_groups[0]["count"], opt.opt.param_groups[0]["lr"]
    sd = opt.state_dict()
    assert sd["opt"]["param_groups"][0]["count"] == 6
    assert isinstance(sd["opt"]["param_groups"][0]["count"], int)
    sd["opt"]["param_groups"][0]["count"] = 9
    opt.load_state_dict(sd)
    assert opt.opt.param_groups[0]["count"] is count and int(count) == 9
    assert opt.opt.param_groups[0]["lr"] is rate and opt.version == 1


# ---------------------------------------------------------------------------
# spans, the driver, the FLOP count
# ---------------------------------------------------------------------------


def test_spans_recorded_in_forward(host_batches, tmp_path):
    trainer, _ = program(small_cfg(), tmp_path)
    summary.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.train_step(host_batches[0])
        trainer.evaluate([host_batches[1]])
    names = [r.name for r in summary.spans()]
    summary.clear()
    assert [names.count(n) for n in ("dien.extract", "dien.attend", "dien.evolve")] == [2, 2, 2]
    assert names.count("dien.aux") == 1  # train mode only


def _small_run(tmp_path, monkeypatch, fault=None):
    """The cell's driver on the CPU at the small size."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    from portbench import control_dien
    from portbench.kinds import kind

    if fault:
        control_dien.FAULTS[fault](monkeypatch.setattr)
    cell = harness.cell(CELL)
    cell["traffic"] = small_traffic()
    cell["warm_seconds"] = 0.2
    run = harness.Run(CELL, cell, small_cfg(), SEED, 0.5, False, device="cpu",
                      started=time.perf_counter())
    return kind(cell["kind"]).run(run)


def test_driver_reads_correct_at_a_small_size(tmp_path, monkeypatch):
    res = _small_run(tmp_path, monkeypatch)
    assert res.correct, res.checks
    assert res.attempted >= 1 and set(res.e2e) == {"train_ex_s", "setup_s"}


@pytest.mark.parametrize("fault", ["half_batch", "agru", "aux_dropped"])
def test_driver_refuses_a_planted_fault(fault, tmp_path, monkeypatch):
    res = _small_run(tmp_path, monkeypatch, fault)
    assert not res.correct, res.checks


@pytest.mark.parametrize("device, replays, raises", [
    ("cuda", 2, False), ("cuda", 0, True), ("cuda", 1, True), ("cpu", 0, False)])
def test_driver_needs_the_replayed_step_on_a_card(device, replays, raises):
    """A card run whose steps 2 and 3 were not both replays (a program that
    steps DIEN eagerly) fails before its window; the CPU steps eagerly."""
    from portbench.kinds import train_dien

    trainer = types.SimpleNamespace(replays=replays)
    if raises:
        with pytest.raises(RuntimeError, match="replayed step"):
            train_dien.require_replays(trainer, device)
    else:
        train_dien.require_replays(trainer, device)


def test_flops_count_the_published_step():
    """A row's forward at the published widths, by hand: the GRU's input
    products 50 * 2 * 16 * 24 and recurrent ones 50 * 2 * 8 * 24, the
    AUGRU's 50 * 2 * 8 * 24 twice, the attention 2 * 16 * 8 + 50 * 2 * 8,
    the auxiliary loss 4 * 49 * (2 * 16 * 8 + 2 * 8), the tower
    2 * (74 * 512 + 512 * 256 + 256 * 128 + 128)."""
    want = (50 * 2 * 16 * 24 + 50 * 2 * 8 * 24 + 2 * 50 * 2 * 8 * 24 + 2 * 16 * 8 + 50 * 2 * 8
            + 4 * 49 * (2 * 16 * 8 + 2 * 8) + 2 * (74 * 512 + 512 * 256 + 256 * 128 + 128))
    assert flops_dien.forward_per_row(published()) == want
    assert flops_dien.train_step(published(), 4096) == 3 * want * 4096


def test_metric_readers_read_dien_traces_only():
    from portbench.trace import Trace

    def trace(cfg):
        return Trace(kind="train", cfg=cfg, window_s=2.0, busy_s=1.0,
                     events=[("k", 0, 1)] * 300, breakdown={},
                     data={"steps": 3, "examples": 3 * 4096})

    mfu = harness.metric_module("dien_train_mfu")
    ops = harness.metric_module("dien_kernels_per_step.train")
    assert mfu.read(trace(harness.config("bst-wechat"))) is None
    assert ops.read(trace(harness.config("bst-wechat"))) is None
    assert ops.read(trace(published())) == 100.0
    got = mfu.read(trace(published()))
    assert got == pytest.approx(100 * flops_dien.train_step(published(), 3 * 4096) / 2.0 / 67e12)
