"""Port parity for ``parallel/multihost.py``, ``parallel/mesh.py``'s rules and
``data/pipeline.shard_for_host``, in one process: the lock-step iterators and
``agreed_all`` with injected reduce functions (the cases of
tests/test_data.py, tests/test_determinism.py and
tests/test_compact_scatter.py::test_agreed_all_reduces_elementwise, each
beside the JAX function on the same inputs), ``host_shard_range`` and
``shard_for_host`` for every shard of 1-4 processes (a mesh's data rows),
the single-process no-ops, the backend choice and the batch-share check.
Exact: integer bookkeeping only."""

import dataclasses

import numpy as np
import pytest
import torch

from recalgorithm_tpu.parallel import multihost as jax_multihost
from recalgorithm_tpu.parallel.mesh import _spec_for as jax_spec_for
from recalgorithm_tpu_torch.data import pipeline
from recalgorithm_tpu_torch.parallel import mesh as mesh_lib
from recalgorithm_tpu_torch.parallel import multihost
from recalgorithm_tpu_torch.runtime.loader import DatasetArrays


def _two_host_reduce(per_window, fn, calls):
    """A reduce for one of two simulated hosts in lock-step: the other
    host's count at the same window index (0 past its end)."""
    def make(host):
        def reduce(count):
            i = calls[host]
            calls[host] += 1
            other = per_window[1 - host]
            return fn(count, other[i] if i < len(other) else 0)
        return reduce
    return make


@pytest.mark.parametrize("impl", (multihost, jax_multihost), ids=("torch", "jax"))
def test_synchronized_iterator_stops_all_hosts_together(impl):
    """host0 has 5 batches, host1 3, window 2: every host stops at the
    global minimum, one reduce a window."""
    per_window = {0: [2, 2, 1], 1: [2, 1]}
    calls = {0: 0, 1: 0}
    make = _two_host_reduce(per_window, min, calls)
    out0 = list(impl.synchronized_iterator(iter(range(5)), make(0), window=2))
    out1 = list(impl.synchronized_iterator(iter(range(3)), make(1), window=2))
    assert out0 == out1 == [0, 1, 2]
    assert calls == {0: 2, 1: 2}


@pytest.mark.parametrize("impl", (multihost, jax_multihost), ids=("torch", "jax"))
def test_aligned_iterator_pads_short_hosts(impl):
    per_window = {0: [2, 2, 1], 1: [2, 0, 0]}
    calls = {0: 0, 1: 0}
    make = _two_host_reduce(per_window, max, calls)
    pad = object()
    out0 = list(impl.aligned_iterator(iter(range(5)), lambda: pad, make(0), window=2))
    out1 = list(impl.aligned_iterator(iter(range(2)), lambda: pad, make(1), window=2))
    assert out0 == [0, 1, 2, 3, 4]
    assert out1 == [0, 1, pad, pad, pad]


def test_aligned_iterator_stops_when_every_host_is_empty():
    out = list(multihost.aligned_iterator(iter(range(4)), lambda: None, lambda c: c, window=2))
    assert out == [0, 1, 2, 3]


@pytest.mark.parametrize("name", ("synchronized_iterator", "aligned_iterator"))
def test_single_process_passthrough(name):
    fn = getattr(multihost, name)
    args = (iter([1, 2, 3]),) if name == "synchronized_iterator" else (iter([1, 2, 3]), None)
    assert list(fn(*args)) == [1, 2, 3]


@pytest.mark.parametrize("impl", (multihost, jax_multihost), ids=("torch", "jax"))
def test_agreed_all_reduces_elementwise(impl):
    """Global AND per window position, short windows padded with True so the
    collective's shape stays fixed."""
    other = np.array([1, 0, 1, 1, 1, 1, 1, 1], np.int32)
    seen = {}

    def reduce_fn(a):
        seen["shape"] = a.shape
        return np.minimum(a, other)

    got = impl.agreed_all([True, True, False], window=8, reduce_fn=reduce_fn)
    assert seen["shape"] == (8,)
    np.testing.assert_array_equal(got, [True, False, False])


def test_single_process_no_ops():
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert multihost.initialize() is None  # no WORLD_SIZE: nothing to start
    assert multihost.initialize("file:///unused", 1, 0) is None
    assert multihost.agreed_flag(True) and not multihost.agreed_flag(False)
    np.testing.assert_array_equal(multihost.agreed_all([True, False]), [True, False])
    assert multihost.host_shard_range(103) == jax_multihost.host_shard_range(103) == (0, 103)
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize("file:///unused")


@dataclasses.dataclass
class _Row:
    """The data-row part of a ProcessMesh."""

    data_index: int
    data_size: int


@pytest.mark.parametrize("count", (1, 2, 3, 4))
def test_host_shard_range_covers_total_once(count):
    """Contiguous, disjoint, in order; the last shard takes the remainder
    (the JAX formula with the process index and count)."""
    for total in (0, 7, 103):
        ranges = [multihost.host_shard_range(total, _Row(i, count)) for i in range(count)]
        per = total // count
        assert ranges == [(i * per, total if i == count - 1 else (i + 1) * per)
                          for i in range(count)]


def _arrays(n):
    rng = np.random.default_rng(0)
    return DatasetArrays(
        dense=rng.normal(size=(n, 3)).astype(np.float32),
        categorical={"userid": np.arange(n, dtype=np.int32)},
        sequences={"seq": (rng.integers(0, 9, (n, 5)).astype(np.int32),
                           rng.integers(0, 6, n).astype(np.int32))},
        labels=rng.integers(0, 2, (n, 2)).astype(np.float32))


@pytest.mark.parametrize("count", (2, 3))
def test_shard_for_host_slices(count):
    """Each data shard's contiguous rows, every column alike; the shards
    concatenate to the split; one process keeps the whole split."""
    data = _arrays(11)
    assert pipeline.shard_for_host(data) is data
    shards = [pipeline.shard_for_host(data, _Row(i, count)) for i in range(count)]
    for i, shard in enumerate(shards):
        lo, hi = multihost.host_shard_range(11, _Row(i, count))
        np.testing.assert_array_equal(shard.categorical["userid"], np.arange(lo, hi))
        for k, v in shard.as_flat().items():
            np.testing.assert_array_equal(v, data.as_flat()[k][lo:hi], err_msg=k)
    for k, v in data.as_flat().items():
        np.testing.assert_array_equal(np.concatenate([s.as_flat()[k] for s in shards]), v)


def test_backend_follows_the_devices(monkeypatch):
    """gloo on the CPU and for ranks sharing a card, NCCL with a card each."""
    assert multihost.choose_backend("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.choose_backend("cuda", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert multihost.choose_backend("cuda", 4) == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert multihost.choose_backend("cuda", 16) == "gloo"


def test_global_batch_checks_the_share():
    row = _Row(0, 2)
    local = {"dense": np.zeros((4, 3), np.float32), "labels": np.zeros((4, 2), np.float32)}
    got = multihost.global_batch(local, row, 8, "cpu")
    assert set(got) == set(local) and got["dense"].shape == (4, 3)
    with pytest.raises(ValueError, match="global batch"):
        multihost.global_batch(local, row, 6, "cpu")
    with pytest.raises(ValueError, match="unequal"):
        multihost.global_batch({**local, "labels": np.zeros((3, 2))}, row, 8, "cpu")


@pytest.mark.parametrize("num_model", (1, 2, 3))
def test_param_specs_match_the_jax_rules(num_model):
    """The port's rules on state_dict names give the JAX spec kinds on the
    flax paths convert maps them to (tables row-sharded, divisible expert
    groups sharded, the rest replicated)."""
    from jax.sharding import PartitionSpec as P

    from recalgorithm_tpu.parallel.mesh import EXPERT_BIAS_SPEC, EXPERT_KERNEL_SPEC, TABLE_SPEC

    kinds = {TABLE_SPEC: mesh_lib.TABLE, EXPERT_KERNEL_SPEC: mesh_lib.EXPERT,
             EXPERT_BIAS_SPEC: mesh_lib.EXPERT, P(): mesh_lib.REPLICATED}
    cases = {  # port name: (flax path, shape)
        "embedder.embed.tables.feedid": (("FieldEmbedder_0", "embed", "feedid"), (512, 16)),
        "first_order.embed_w.tables.userid": (("first_order", "embed_w", "userid"), (256, 1)),
        "wide_embed_w.tables.cross": (("wide_embed_w", "cross"), (4096, 1)),
        "transformer_0.position_embedding": (("transformer_0", "position_embedding"), (51, 16)),
        "experts.kernel": (("experts", "kernel"), (6, 8, 4)),
        "experts.bias": (("experts", "bias"), (6, 4)),
        "cgc_0.experts_shared.kernel": (("cgc_0", "experts_shared", "kernel"), (4, 8, 4)),
        "gate_like.weight": (("gate_like", "kernel"), (8, 6)),
    }
    specs = mesh_lib.param_specs({n: s for n, (_, s) in cases.items()}, num_model)
    for name, (path, shape) in cases.items():
        leaf = np.zeros(shape)
        assert specs[name] == kinds[jax_spec_for(path, leaf, num_model)], name


def _zoo_models():
    from recalgorithm_tpu_torch.models import MODEL_REGISTRY

    return [(name, {}) for name in sorted(MODEL_REGISTRY)] + [("MMOE", {"num_experts": 4})]


@pytest.mark.parametrize("name,overrides", _zoo_models(),
                         ids=[f"{n}{o.get('num_experts', '')}" for n, o in _zoo_models()])
def test_shard_model_specs_are_the_name_rules(name, overrides):
    """What the modules' ``shard_`` split on a (data 2, model 2) mesh, which
    the Trainer's gradient reduction and gathers read, is what the name
    rules of ``param_specs`` (the JAX package's) pick, for every model of
    the zoo: tables row-sharded, expert groups whose E divides 2 (PLE's 10
    shared experts, MMOE's 4) split, 5 or 3 experts whole."""
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import get_model

    sizes = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=0.005)).vocab_sizes()
    cfg_cls, cls = get_model(name)
    model = cls(cfg_cls(**overrides), wechat_schema(sizes), torch.Generator().manual_seed(0))
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mesh = mesh_lib.ProcessMesh(rank=3, world=4, num_model=2, data_group=None, model_group=None)
    specs = mesh_lib.shard_model(model, mesh)  # no collective: only the split
    assert set(specs) == set(model.state_dict())
    assert {n: specs[n] for n in whole} == mesh_lib.param_specs(whole, mesh.num_model)
    for n, p in model.named_parameters():
        parts = {mesh_lib.TABLE: 4, mesh_lib.EXPERT: 2}.get(specs[n], 1)
        assert tuple(p.shape) == (whole[n][0] // parts, *whole[n][1:]), n
