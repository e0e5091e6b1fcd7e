"""chip_smoke.py phase 8's gate on a BST train step's gradients
(``step_gradient_ratios``), on the CPU at a small size: the same step in f32
with the batch rows in another order (the same gradient, other rounding)
passes; a step whose attention passes dk scaled by 1 + 1e-3 (a kernel fault
far below the size of any real gradient) fails on w_k; a feedid table
gradient scaled by 1 + 1e-3 fails on that table.  An embedding table's
allowance is rtol x the f64 sum of its terms' magnitudes
(``lookup_abs_sums``): a row whose terms cancel passes with the f32 noise of
those terms, which the allowance from |sum| refuses.  And the rows the gate
keeps (``kink_free_rows``): none with a relu input at 0."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import recalgorithm_tpu_torch.ops.attention as attention
from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu_torch.features.schema import wechat_schema
from recalgorithm_tpu_torch.models.bst import BST, BSTConfig
from recalgorithm_tpu_torch.ops.activations import batch_norm
from recalgorithm_tpu_torch.train import optimizers
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

B = 256
CFG = BSTConfig(hidden_units=(64, 32), dropout_rate=0.0)


FEEDID = "embedder.embed.tables.feedid"


def _grads(tmp_path, batch, f64=False):
    """The step's gradients, and the f64 step's ``lookup_abs_sums`` too."""
    gen_schema = wechat_schema(SyntheticWeChat(
        wechat_schema(), SyntheticConfig(seed=7, vocab_scale=0.005)).vocab_sizes())
    model = BST(CFG, gen_schema, generator=torch.Generator().manual_seed(0))
    tr = Trainer(model, CFG.task_names, optimizers.build("adam", 0.005),
                 TrainerConfig(model_dir=str(tmp_path)), device="cpu")
    dev = tr._put_batch(batch)
    if f64:
        model.double()
        dev = {k: x.double() if x.is_floating_point() else x for k, x in dev.items()}
    model.train()
    with chip_smoke.lookup_abs_sums(model) as sums:
        loss, _ = tr._loss_and_logits(dev)
        loss.backward()
    grads = {n: p.grad.double() for n, p in model.named_parameters()}
    return (grads, sums) if f64 else grads


@pytest.mark.parametrize("case", ["reordered_rows", "dk_scaled", "table_scaled"])
def test_step_gate(tmp_path, monkeypatch, case):
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=0.005))
    batch = gen.batch(B, 1)
    cpu = _grads(tmp_path, batch)
    exact, sums = _grads(tmp_path, batch, f64=True)
    if case == "reordered_rows":
        perm = np.random.default_rng(0).permutation(B)
        other = _grads(tmp_path, {k: np.ascontiguousarray(v[perm]) for k, v in batch.items()})
    elif case == "dk_scaled":
        plain = attention.bst_mha
        monkeypatch.setattr(attention, "bst_mha", lambda q, k, v, lengths, save_bf16=False:
                            plain(q, k + 1e-3 * (k - k.detach()), v, lengths, save_bf16))
        other = _grads(tmp_path, batch)
    else:
        other = dict(cpu, **{FEEDID: cpu[FEEDID] * (1 + 1e-3)})
    ratios = chip_smoke.step_gradient_ratios(other, cpu, exact,
                                             chip_smoke.zero_gradient_params(CFG), sums)
    assert set(ratios) == set(exact)
    # every table of the model, each summed from its own lookups' terms
    assert set(sums) == {n for n in exact if ".tables." in n}
    for name, s in sums.items():
        assert (s >= exact[name].abs() * (1 - 1e-12)).all(), name  # |sum| <= sum|terms|
    if case == "reordered_rows":
        assert max(ratios.values()) <= 1.0, ratios
    elif case == "dk_scaled":
        assert ratios["transformer_0.w_k"] > 1.0, ratios
        assert ratios["transformer_0.w_v"] <= 1.0, ratios  # dv is untouched
    else:
        assert ratios[FEEDID] > 1.0, ratios
        assert max(r for n, r in ratios.items() if n != FEEDID) <= 1.0, ratios


def test_step_gate_table_row_whose_terms_cancel():
    """Row 0 of a table sums two terms of 1e3 that cancel to 1e-3: the f32
    noise of those terms (100 ulps of 1e3) passes against rtol x sum|terms|
    and fails against rtol x |sum|; an error of 1e-3 x the sum|terms| fails
    either way.  A tensor that is no table keeps the |sum| rule."""
    exact = {"embed.tables.t": torch.tensor([[1e-3], [5e-4]], dtype=torch.float64),
             "dense.weight": torch.tensor([1e-3], dtype=torch.float64)}
    sums = {"embed.tables.t": torch.tensor([[2e3], [5e-4]], dtype=torch.float64)}
    noise = 100 * 2.0**-24 * 1e3
    gpu = {"embed.tables.t": exact["embed.tables.t"] + torch.tensor([[noise], [0.0]],
                                                                    dtype=torch.float64),
           "dense.weight": exact["dense.weight"]}
    ratio = lambda g, s: chip_smoke.step_gradient_ratios(g, exact, exact, set(), s)
    assert ratio(gpu, sums)["embed.tables.t"] <= 1.0
    assert ratio(gpu, {})["embed.tables.t"] > 1.0
    far = dict(gpu, **{"embed.tables.t": exact["embed.tables.t"] + torch.tensor(
        [[2.0], [0.0]], dtype=torch.float64)})
    assert ratio(far, sums)["embed.tables.t"] > 1.0
    bad_dense = dict(gpu, **{"dense.weight": exact["dense.weight"] + noise})
    assert ratio(bad_dense, sums)["dense.weight"] > 1.0


class _TwoRelus(torch.nn.Module):
    """x -> relu(W x) by nn.ReLU, then torch.relu(h - 1)."""

    def __init__(self, bn=False):
        super().__init__()
        self.lin = torch.nn.Linear(2, 3, bias=False, dtype=torch.float64)
        with torch.no_grad():
            self.lin.weight.copy_(torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]))
        self.act = torch.nn.ReLU()
        if bn:  # a train-mode BN after the model's output, which couples its rows
            self.bn = batch_norm(3).double()

    def forward(self, batch):
        out = torch.relu(self.act(self.lin(batch["x"])) - 1.0)
        return self.bn(out) if hasattr(self, "bn") else out


def test_kink_free_rows_refuse_a_batch_norm_model():
    x = torch.tensor([[3.0, 2.0], [1e-12, 3.0], [2.0, 2.0]], dtype=torch.float64)
    with pytest.raises(AssertionError, match="BatchNorm"):
        chip_smoke.kink_free_rows(_TwoRelus(bn=True), {"x": x, "labels": torch.zeros(3, 1)})
    keep = chip_smoke.kink_free_rows(_TwoRelus(bn=True), {"x": x[::2], "labels": torch.zeros(2, 1)})
    assert keep.tolist() == [True, True]  # no row dropped: BN is no obstacle


def test_kink_free_rows_drop_rows_at_a_relu_kink():
    x = torch.tensor([[3.0, 2.0],            # kept
                      [1e-12, 3.0],          # nn.ReLU input at 1e-12
                      [2.0, 2.0],            # kept
                      [-1.0, 1.0 + 1e-12],   # nn.ReLU input (-1 + 1 + 1e-12) at 1e-12
                      [1.0 + 1e-12, 3.0]],   # torch.relu input at 1e-12
                     dtype=torch.float64)
    relu = torch.relu
    keep = chip_smoke.kink_free_rows(_TwoRelus(), {"x": x, "labels": torch.zeros(5, 1)})
    assert keep.tolist() == [True, False, True, False, False]
    assert torch.relu is relu
