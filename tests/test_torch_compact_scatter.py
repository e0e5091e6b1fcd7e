"""The PAD-compacted table gradient (ops/compact_scatter.py) against the JAX
package's, case by case of tests/test_compact_scatter.py, on the same numpy
inputs: the scatter inside the cap at several densities, interior PAD holes,
the host-side check on dense batches and without ``*_len`` columns, the
gather's gradient, a DIN train step with compaction against the plain step,
a dense batch routed to the plain step, and a 2-rank gloo ``--no_mesh`` run
in which one rank's batches are dense.

Tolerances:
  * the port's compact gradient against the port's full one
    (``F.embedding``'s backward): bitwise on every row but the PAD row 0, by
    design (the same terms summed in the same order), and row 0 too here;
  * the port against the JAX package: rtol 1e-6 and atol 1e-6 x max|g| (f32
    sums of the same terms, XLA's scatter in another order), and the JAX
    test's own rtol 1e-5 / atol 1e-6 where a tanh loss sits in front;
  * the trainer with compaction against the trainer without: losses and
    parameters bitwise;
  * the 2-rank run against one process on the same batches: rtol 1e-6
    (each rank runs the same code on one thread; the reference runs with
    the test process's threads, whose reductions may split otherwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from recalgorithm_tpu.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu.features.schema import wechat_schema as jax_wechat_schema
from recalgorithm_tpu.ops import compact_scatter as jcs
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.features.schema import wechat_schema
from recalgorithm_tpu_torch.models.din import DIN, DINConfig
from recalgorithm_tpu_torch.ops import compact_scatter as cs
from recalgorithm_tpu_torch.train import optimizers
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

from torch_dist_common import result, run_world, write_batches, write_vocab_sizes, write_weights

V, K = 1024, 16


def _prefix_ids(rng, b, t, density):
    """The JAX test's valid-prefix batch."""
    lens = np.minimum(rng.geometric(p=max(1e-6, 1 - density), size=(b,)), t)
    if density == 0.0:
        lens[:] = 0
    if density == 1.0:
        lens[:] = t
    ids = rng.integers(1, V, size=(b, t)).astype(np.int32)
    mask = np.arange(t)[None, :] < lens[:, None]
    return np.where(mask, ids, 0).astype(np.int32)


def _full(ids: np.ndarray, g: np.ndarray) -> torch.Tensor:
    """The full table gradient, as ``F.embedding``'s backward computes it."""
    return torch.ops.aten.embedding_dense_backward(
        torch.from_numpy(g).reshape(-1, g.shape[-1]),
        torch.from_numpy(ids).long().reshape(-1), V, -1, False)


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> None:
    np.testing.assert_array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))


def _vs_jax(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("density", [0.0, 0.1, 0.2])
def test_scatter_grad_matches_full_within_cap(density):
    rng = np.random.default_rng(0)
    b, t = 64, 20
    ids = _prefix_ids(rng, b, t, density)
    assert int(cs._live_lens(torch.from_numpy(ids)).sum()) <= ids.size // cs.CAP_DIVISOR
    g = (rng.normal(size=(b, t, K)).astype(np.float32) * (ids > 0)[..., None])
    got = cs.scatter_grad(torch.from_numpy(ids), torch.from_numpy(g), V)
    _bitwise(got, _full(ids, g))
    _vs_jax(got, jax.jit(lambda i, gg: jcs.scatter_grad(i, gg, V))(ids, g))
    np.testing.assert_array_equal(cs._live_lens(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jcs._live_lens(jnp.asarray(ids))))


def test_scatter_grad_interior_holes():
    """Masked slots inside the prefix stay covered: every id > 0 entry adds
    in, whatever the pattern of holes."""
    ids = np.asarray([[5, 0, 7, 0, 0], [0, 3, 0, 0, 9]], np.int32)
    g = np.where((ids > 0)[..., None],
                 np.arange(2 * 5 * K, dtype=np.float32).reshape(2, 5, K), 0.0).astype(np.float32)
    got = cs.scatter_grad(torch.from_numpy(ids), torch.from_numpy(g), V, cap_divisor=1)
    _bitwise(got, _full(ids, g))
    _vs_jax(got, jcs.scatter_grad(jnp.asarray(ids), jnp.asarray(g), V, cap_divisor=1))


def test_batch_fits_compact_flags_dense_batches():
    schema, jschema = wechat_schema(), jax_wechat_schema()
    seq = schema.sequence[0]
    assert seq.max_length >= cs.LONG_SEQ_T
    assert [f.name for f in cs.eligible_seq_features(schema)] == [
        f.name for f in jcs.eligible_seq_features(jschema)] == ["his_read_comment_7d_seq"]
    b = 4096
    assert b * seq.max_length >= cs.MIN_IDS == jcs.MIN_IDS
    cases = {"sparse": ({seq.name + "_len": np.full((b,), seq.max_length // 8, np.int32)}, True),
             "dense": ({seq.name + "_len": np.full((b,), seq.max_length, np.int32)}, False),
             # small batches never compact: always "fits"
             "small": ({seq.name + "_len": np.full((8,), seq.max_length, np.int32)}, True)}
    for name, (batch, fits) in cases.items():
        assert cs.batch_fits_compact(batch, schema) is fits, name
        assert jcs.batch_fits_compact(batch, jschema) is fits, name


def test_batch_fits_compact_without_len_column():
    """A batch without a ``*_len`` column counts live prefixes from its ids."""
    schema, jschema = wechat_schema(), jax_wechat_schema()
    seq = schema.sequence[0]
    b, t = 4096, seq.max_length
    rng = np.random.default_rng(0)
    dense_ids = rng.integers(1, 100, size=(b, t)).astype(np.int32)
    sparse_ids = np.where(np.arange(t)[None, :] < 3, dense_ids, 0)
    holes = np.where(rng.random((b, t)) < 0.2, dense_ids, 0)  # live up to the last id
    for batch in ({seq.name: dense_ids}, {seq.name: sparse_ids}, {seq.name: holes}, {}):
        assert cs.batch_fits_compact(batch, schema) is jcs.batch_fits_compact(batch, jschema)
    assert not cs.batch_fits_compact({seq.name: dense_ids}, schema)
    assert cs.batch_fits_compact({seq.name: sparse_ids}, schema)
    assert cs.batch_fits_compact({}, schema)  # feature absent: no lookup to bound


def test_take_compact_bwd_grad_equivalence():
    rng = np.random.default_rng(1)
    b, t = 128, 16
    ids = _prefix_ids(rng, b, t, 0.15)
    table = rng.normal(size=(V, K)).astype(np.float32)
    w = rng.normal(size=(K,)).astype(np.float32)
    mask = torch.from_numpy(ids > 0)[..., None].float()

    def torch_grad(take):
        tab = torch.from_numpy(table).requires_grad_()
        emb = take(tab, torch.from_numpy(ids)) * mask
        torch.tanh(emb.sum(dim=1) @ torch.from_numpy(w)).sum().backward()
        return tab.grad

    fast = torch_grad(cs.take_compact_bwd)
    _bitwise(fast, torch_grad(lambda tab, i: F.embedding(i.long(), tab)))

    def jax_loss(tab):
        emb = jcs.take_compact_bwd(tab, jnp.asarray(ids)) * (jnp.asarray(ids) > 0)[..., None]
        return jnp.sum(jnp.tanh(jnp.sum(emb, axis=1) @ jnp.asarray(w)))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(table)))
    np.testing.assert_allclose(fast.numpy(), want, rtol=1e-5, atol=1e-6)
    # the forward is the clip gather, out-of-range ids included
    odd = torch.tensor([[3, V + 5, -2, 0]])
    np.testing.assert_array_equal(cs.take_compact_bwd(torch.from_numpy(table), odd).numpy(),
                                  table[np.clip(odd.numpy(), 0, V - 1)])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

DIN_KW = dict(hidden_units=(16, 8), dropout_rate=0.0)


@pytest.fixture(scope="module")
def gen():
    return SyntheticWeChat(jax_wechat_schema(), SyntheticConfig(seed=5, vocab_scale=0.05))


def _dense(hb: dict, seed: int) -> dict:
    """``hb`` with every sequence full (live count T per row: over the cap)."""
    hb = dict(hb)
    rng = np.random.default_rng(seed)
    for f in wechat_schema().sequence:
        b = len(hb[f.name])
        hb[f.name] = rng.integers(1, 50, size=(b, f.max_length)).astype(np.int32)
        hb[f.name + "_len"] = np.full((b,), f.max_length, np.int32)
    return hb


def _din_trainer(gen, tmp_path, compact: bool, tag: str) -> Trainer:
    model = DIN(DINConfig(**DIN_KW), wechat_schema(gen.vocab_sizes()),
                torch.Generator().manual_seed(0))
    return Trainer(model, ("read_comment",), optimizers.build("sgd", 1e-2),
                   TrainerConfig(model_dir=str(tmp_path / tag), save_checkpoints_steps=0,
                                 compact_grad_scatter=compact), device="cpu")


@pytest.fixture
def compact_calls(monkeypatch):
    """MIN_IDS 0 (these batches are small), and a count of the lookups that
    took the compacted gather."""
    monkeypatch.setattr(cs, "MIN_IDS", 0)
    calls = []
    plain = cs.take_compact_bwd
    monkeypatch.setattr(cs, "take_compact_bwd", lambda tab, ids: calls.append(1) or plain(tab, ids))
    return calls


def _steps(tr: Trainer, batches) -> tuple[list[float], dict]:
    losses = [float(tr.train_step(hb)) for hb in batches]
    return losses, {k: p.detach().clone() for k, p in tr.model.named_parameters()}


def test_train_step_matches_plain_scatter(gen, tmp_path, compact_calls):
    """DIN steps with compact_grad_scatter on and off: the same losses and
    parameters, bitwise; the feedid sequence lookup compacted on."""
    batches = [gen.batch(64, i) for i in range(2)]
    assert all(cs.batch_fits_compact(hb, wechat_schema()) for hb in batches)
    on = _steps(_din_trainer(gen, tmp_path, True, "on"), batches)
    assert len(compact_calls) == 2  # one sequence lookup a step
    off = _steps(_din_trainer(gen, tmp_path, False, "off"), batches)
    assert len(compact_calls) == 2
    assert on[0] == off[0]
    for k, v in off[1].items():
        _bitwise(on[1][k], v)
    assert TrainerConfig().compact_grad_scatter  # on by default, as in the JAX trainer


def test_dense_batch_dispatches_to_plain_step(gen, tmp_path, compact_calls):
    """A batch whose sequences overflow the compact buffer takes the full
    gradient (decided on the host) and trains exactly; a sparse one after it
    compacts again."""
    dense = _dense(gen.batch(64, 0), 1)
    assert not cs.batch_fits_compact(dense, wechat_schema())
    assert not jcs.batch_fits_compact(dense, jax_wechat_schema(), min_ids=0)
    tr = _din_trainer(gen, tmp_path, True, "dense")
    got = _steps(tr, [dense])
    assert not compact_calls
    want = _steps(_din_trainer(gen, tmp_path, False, "plain"), [dense])
    assert got[0] == want[0]
    for k, v in want[1].items():
        _bitwise(got[1][k], v)
    tr.train_step(gen.batch(64, 1))
    assert len(compact_calls) == 1


def test_no_mesh_ranks_decide_alone(gen, tmp_path, monkeypatch):
    """2 gloo processes without a mesh (``--no_mesh``): rank 0's batches fit
    the cap and compact, rank 1's are dense and do not; each rank's losses
    and parameters equal one process's on its batches."""
    schema = wechat_schema(gen.vocab_sizes())
    model = DIN(DINConfig(**DIN_KW), schema, torch.Generator().manual_seed(0))
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    write_vocab_sizes(in_dir, gen.vocab_sizes())
    write_weights(in_dir, "DIN", convert.to_flax(model))
    per_rank = {0: [gen.batch(32, i) for i in range(2)],
                1: [_dense(gen.batch(32, 10 + i), i) for i in range(2)]}
    for rank, batches in per_rank.items():
        write_batches(in_dir, f"DIN_r{rank}", batches)
    out = run_world(tmp_path, "compact_no_mesh", 2, in_dir)
    for rank, batches in per_rank.items():
        got = result(out, "DIN", rank)
        np.testing.assert_array_equal(got["fits"], [rank == 0] * 2)
        ref = DIN(DINConfig(**DIN_KW), schema)
        ref.load_state_dict(model.state_dict())
        tr = Trainer(ref, ("read_comment",), optimizers.build("sgd", 0.01),
                     TrainerConfig(model_dir=str(tmp_path / f"ref{rank}"),
                                   save_checkpoints_steps=0), device="cpu")
        monkeypatch.setattr(cs, "MIN_IDS", 0)
        losses, params = _steps(tr, batches)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
        for k, v in params.items():
            np.testing.assert_allclose(got[f"param/{k}"], v.numpy(), rtol=1e-6, atol=1e-7)
