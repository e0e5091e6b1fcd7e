"""Port parity for several processes: the port's Trainer on a 2-rank gloo
world on the CPU (``tests/torch_dist_worker.py``), each run held against the
same steps of the JAX package on its 8-device CPU mesh and at 1 device, from
the same JAX init, on the same global batches (each rank feeds its rows):

  * DeepCrossing, data parallel (as tests/test_multihost_e2e.py: 4 Adam
    steps, dropout 0; the port's one-process run beside it);
  * global-batch BatchNorm and Dice: one step of BST (tower BN) and DIN
    (Dice's BN and the tower's), the loss and the updated statistics;
  * MMOE on a (data 1, model 2) mesh with 4 experts (each rank holds 2) and
    with 3 (not divisible: replicated);
  * TwoTower's in-batch softmax with the log-Q counts over the global batch;
  * DIEN's auxiliary loss, its negatives rolled over the global batch (held
    to the port's one process: JAX's cannot initialise it, ROADMAP C.3);
  * the best-export gather with a full best list (keep 1) and a checkpoint
    round trip (gathered to rank 0's file, restored as shards);
  * ``sharded_top_k`` on the cases of tests/test_retrieval.py on 2 and 4
    ranks.

Tolerances: losses rtol 1e-4 against JAX (the trainer parity bar of
tests/test_torch_train.py: f32 on both sides, JAX at "highest" precision,
differences compound through the updates) and 1e-5 against the port's
one-process run (the same code, the batch mean summed in two halves);
statistics and parameters rtol 1e-4, atol 1e-5; top-k indices exact, scores
rtol 1e-6 (tests/test_retrieval.py's bar)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recalgorithm_tpu.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from recalgorithm_tpu.parallel import mesh as jax_mesh
from recalgorithm_tpu.serving.retrieval import brute_force_top_k as jax_top_k
from recalgorithm_tpu.train.loop import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models import get_model
from recalgorithm_tpu_torch.parallel import mesh as mesh_lib
from recalgorithm_tpu_torch.train import optimizers as toptimizers
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

from torch_dist_common import (flat, result, start_world, write_batches, write_vocab_sizes,
                               write_weights)

LOSS_JAX = dict(rtol=1e-4)
LOSS_PORT = dict(rtol=1e-5)
STATS = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(dropout_rate=0.0)
# tag: (model, config overrides, optimizer, rate, steps, global batch, JAX mesh model axis)
RUNS = {
    "DeepCrossing": ("DeepCrossing", {}, "adam", 0.01, 4, 64, 1),  # no dropout
    "BST": ("BST", dict(hidden_units=(32, 16), mlp_activation="relu", **SMALL), "sgd", 0.01,
            1, 32, 1),
    "DIN": ("DIN", dict(hidden_units=(32, 16), **SMALL), "sgd", 0.01, 1, 32, 1),
    "MMOE": ("MMOE", dict(num_experts=4, expert_hidden_units=32, hidden_units=(16,), **SMALL),
             "sgd", 0.01, 3, 32, 2),
    "MMOE3": ("MMOE", dict(num_experts=3, expert_hidden_units=16, hidden_units=(16,), **SMALL),
              "sgd", 0.01, 1, 32, 2),
    "TwoTower": ("TwoTower", dict(hidden_units=(32,), output_dim=16, logq_correction=True),
                 "sgd", 0.05, 2, 32, 1),
    "DIENAux": ("DIEN", dict(hidden_units=(16,), use_auxiliary_loss=True, **SMALL), "sgd",
                0.01, 2, 32, 1),
}
# held to the port's one-process run only: JAX's DIEN with the auxiliary loss
# cannot initialise (ROADMAP C.3); its negatives roll over the global batch
PORT_ONLY = {"DIENAux"}
# the JAX side's plain attention (its Pallas kernels run interpreted on the CPU)
JAX_ONLY = {"BST": dict(use_fused_attention="false"), "DIN": dict(use_fused_attention="false")}
TOP_K_CASES = ((101, 7), (64, 5), (40, 12))  # 101 divides no rank count; 12 > 40 / 4


def _jax_optimizer(name, lr):
    return optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8) if name == "adam" else optax.sgd(lr)


def _jax_trainer(tag, schema, tmp, mesh):
    """The JAX Trainer of ``tag`` at 1 device (``mesh`` None) or on the CPU
    mesh."""
    name, kw, opt, lr, _, b, _ = RUNS[tag]
    cfg_cls, cls = JAX_REGISTRY[name]
    cfg = cfg_cls(batch_size=b, **kw, **JAX_ONLY.get(tag, {}))
    return JaxTrainer(cls(config=cfg, schema=schema),
                      tuple(cfg.task_names) or (schema.labels[0],), _jax_optimizer(opt, lr),
                      JaxTrainerConfig(model_dir=str(tmp / f"jax_{tag}_{mesh is not None}"),
                                       save_checkpoints_steps=0, compact_grad_scatter=False),
                      mesh=mesh)


def _jax_init(jt, batch):
    """``Trainer.init_state`` compiled (its eager init dispatches op by op)."""
    mesh, jt.mesh = jt.mesh, None
    state = jax.jit(jt.init_state)(batch)
    jt.mesh = mesh
    return state


def _on_mesh(jt, state):
    """A copy of ``state`` placed as ``Trainer.init_state`` places it on
    ``jt``'s mesh: params sharded, the optimizer state anew (a copy: the
    train step donates its state)."""
    state = jax.tree.map(lambda x: jnp.array(x, copy=True), state)
    params = jax.device_put(state.params, jax_mesh.param_shardings(state.params, jt.mesh))
    return state.replace(params=params, opt_state=jt.tx.init(params))


def _jax_steps(tag, jt, state, batches):
    """The JAX steps of ``tag``: (losses, variables after)."""
    losses = []
    with jax.default_matmul_precision("highest"):
        jt._compile()
        for hb in batches[:RUNS[tag][4]]:
            state, loss = jt._train_jit(state, jt._put_batch(hb), jax.random.key(1))
            losses.append(float(loss))
    return losses, jax.device_get({"params": state.params, "batch_stats": state.batch_stats})


def _port_run(tag, sizes, init, batches):
    """The port's one-process steps of ``tag`` from the JAX init."""
    name, kw, opt, lr, steps, b, _ = RUNS[tag]
    cfg_cls, cls = get_model(name)
    cfg = cfg_cls(**kw)
    model = cls(cfg, t_wechat_schema(sizes))
    model.load_state_dict(convert.from_flax(init))
    tr = Trainer(model, tuple(cfg.task_names) or ("read_comment",),
                 toptimizers.build(opt, lr), TrainerConfig(save_checkpoints_steps=0),
                 device="cpu")
    return [float(tr.train_step(hb)) for hb in batches[:steps]]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX references, then the 2-rank run of every scenario and the 4-rank
    sharded_top_k."""
    tmp = tmp_path_factory.mktemp("distributed")
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=5, vocab_scale=0.003))
    sizes = gen.vocab_sizes()
    schema = wechat_schema(sizes)
    write_vocab_sizes(tmp, sizes)
    with open(tmp / "runs.json", "w") as f:
        json.dump({tag: dict(model=m, kw=kw, optimizer=o, lr=lr, steps=s, model_axis=a)
                   for tag, (m, kw, o, lr, s, _, a) in RUNS.items()}, f)
    runs = {}
    for j, (tag, (name, kw, _, _, steps, b, _)) in enumerate(RUNS.items()):
        batches = [gen.batch(b, 10 * j + i) for i in range(steps)]
        if tag in PORT_ONLY:
            cfg_cls, cls = get_model(name)
            jt = state = None
            init = convert.to_flax(cls(cfg_cls(**kw), t_wechat_schema(sizes),
                                       torch.Generator().manual_seed(j)))
        else:
            jt = _jax_trainer(tag, schema, tmp, None)
            state = _jax_init(jt, batches[0])
            init = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
        write_weights(tmp, tag, init)
        write_batches(tmp, tag, batches)
        runs[tag] = (batches, jt, state, init)
    rng = np.random.default_rng(1)
    cases = {}
    for j, (n, k) in enumerate(TOP_K_CASES):
        cases[f"c{j}/u"] = rng.normal(size=(6, 16)).astype(np.float32)
        cases[f"c{j}/c"] = rng.normal(size=(n, 16)).astype(np.float32)
        cases[f"c{j}/k"] = np.asarray(k)
    np.savez(tmp / "top_k.npz", **cases)
    # the ranks run while the JAX references do
    worlds = {2: start_world(tmp, "distributed", 2, tmp), 4: start_world(tmp, "top_k", 4, tmp)}
    refs = {}
    for tag, (batches, jt, state, init) in runs.items():
        if tag in PORT_ONLY:
            refs[tag] = dict(port=_port_run(tag, sizes, init, batches))
            continue
        mesh_jt = _jax_trainer(tag, schema, tmp, jax_mesh.make_mesh(num_model=RUNS[tag][6]))
        mesh_losses = _jax_steps(tag, mesh_jt, _on_mesh(mesh_jt, state), batches)[0]
        losses, after = _jax_steps(tag, jt, state, batches)
        refs[tag] = dict(losses=losses, after=after, mesh_losses=mesh_losses,
                         port=_port_run(tag, sizes, init, batches))
    return {"refs": refs, "cases": cases, **{w: finish() for w, finish in worlds.items()}}


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_losses_match_jax(world, tag):
    """Every rank's global losses against JAX at 1 device and on its mesh,
    and against the port's one-process run."""
    ref = world["refs"][tag]
    for rank in (0, 1):
        got = result(world[2], tag, rank)["losses"]
        np.testing.assert_allclose(got, ref["port"], **LOSS_PORT)
        if tag not in PORT_ONLY:
            np.testing.assert_allclose(got, ref["losses"], **LOSS_JAX)
            np.testing.assert_allclose(got, ref["mesh_losses"], **LOSS_JAX)


@pytest.mark.parametrize("tag", ("BST", "DIN", "TwoTower"))
def test_batch_statistics_are_the_global_batch(world, tag):
    """The running BatchNorm / Dice statistics and TwoTower's feedid_freq
    after the steps: the global batch's, as the JAX step's, on both ranks."""
    want = flat(world["refs"][tag]["after"]["batch_stats"])
    assert want
    for rank in (0, 1):
        got = convert.to_flax(_StateHolder(result(world[2], tag, rank)))["batch_stats"]
        got = flat(got)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **STATS, err_msg=str(k))


@pytest.mark.parametrize("tag", ("DeepCrossing", "MMOE", "TwoTower"))
def test_parameters_match_jax(world, tag):
    """The whole parameters gathered after the steps (tables from both
    ranks' rows, MMOE's experts from both model ranks) against JAX's."""
    want = flat(world["refs"][tag]["after"]["params"])
    got = flat(convert.to_flax(_StateHolder(result(world[2], tag, 0)))["params"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **STATS, err_msg=str(k))


def test_tables_and_experts_are_sharded(world):
    """Each rank holds half of every table's rows; MMOE's 4 experts split
    2 + 2 over the model axis; 3 experts stay whole on both ranks."""
    dc = result(world[2], "DeepCrossing", 1)
    assert dc["local/embedder.embed.tables.feedid"].shape[0] * 2 == \
        dc["state/embedder.embed.tables.feedid"].shape[0]
    whole = result(world[2], "MMOE", 0)["state/experts.kernel"]
    for rank in (0, 1):
        local = result(world[2], "MMOE", rank)["local/experts.kernel"]
        assert local.shape[0] == 2
        np.testing.assert_array_equal(local, whole[2 * rank:2 * rank + 2])
        assert result(world[2], "MMOE3", rank)["local/experts.kernel"].shape[0] == 3


def test_specs_pick_the_jax_parameters(world):
    """param_specs on the port's names picks the tables and expert groups
    the JAX rules pick on the flax paths (convert maps one to the other)."""
    for tag in ("DeepCrossing", "MMOE", "TwoTower"):
        params = flat(world["refs"][tag]["after"]["params"])
        for path in params:
            leaf = convert.from_flax(_tree({("params",) + path: params[path]}))
            (name,) = [k for k in leaf if not k.endswith("num_batches_tracked")]
            assert mesh_lib.is_embedding_table_path(name) == \
                jax_mesh.is_embedding_table_path(path), (path, name)
            assert mesh_lib.is_expert_param_path(name) == \
                jax_mesh.is_expert_param_path(path), (path, name)


def test_best_export_gather_with_a_full_list(world):
    """keep 1: an export, a worse AUC that every rank skips, a better one
    that every rank gathers for (the old one evicted); rank 0's artifact is
    the whole model; the checkpoint restores every rank's shards and Adam
    moments bitwise."""
    for rank in (0, 1):
        r = result(world[2], "export", rank)
        steps = [int(s) for s in r["steps"]]
        assert json.loads(str(r["listed"])) == [[0.95, steps[2]]]
        assert json.loads(str(r["dirs"])) == [f"best_{steps[2]}"]
        assert bool(r["same_params"]) and bool(r["same_opt"])
        assert int(r["restored_step"]) == steps[2]
    r = result(world[2], "export", 0)
    exported = {k[len("exported/"):]: v for k, v in r.items() if k.startswith("exported/")}
    whole = {k[len("whole/"):]: v for k, v in r.items() if k.startswith("whole/")}
    assert set(exported) == set(whole)
    for k in whole:
        np.testing.assert_array_equal(exported[k], whole[k], err_msg=k)


@pytest.mark.parametrize("ranks", (2, 4))
def test_sharded_top_k_matches_single_device(world, ranks):
    cases = world["cases"]
    for j, (n, k) in enumerate(TOP_K_CASES):
        want_s, want_i = jax_top_k(cases[f"c{j}/u"], cases[f"c{j}/c"], k)
        for rank in range(ranks):
            got = result(world[ranks], "top_k", rank)
            np.testing.assert_array_equal(got[f"c{j}/indices"], np.asarray(want_i))
            np.testing.assert_allclose(got[f"c{j}/scores"], np.asarray(want_s), rtol=1e-6)


class _StateHolder(torch.nn.Module):
    """A module whose state_dict is a worker's gathered ``state/`` arrays, for
    ``convert.to_flax`` (buffers: the BN statistics and feedid_freq)."""

    def __init__(self, saved):
        super().__init__()
        self._sd = {k[len("state/"):]: torch.from_numpy(v) for k, v in saved.items()
                    if k.startswith("state/")}

    def state_dict(self, *args, **kwargs):
        return self._sd

    def named_buffers(self, *args, **kwargs):
        stats = ("running_mean", "running_var", "num_batches_tracked", "feedid_freq")
        return [(k, v) for k, v in self._sd.items() if k.split(".")[-1] in stats]


def _tree(flat_paths):
    tree = {}
    for path, v in flat_paths.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree
