"""Training loop: the counterpart of ``recalgorithm_tpu/train/loop.py``.

Responsibilities (the reference's Estimator usage, wide_and_deep.py:331-376):

  * the train step — loss = sum of per-task mean sigmoid CE (mmoe.py:261-263),
    each task scaled by the model config's ``task_loss_weights``, plus the
    regularisation terms the model returns beside its logits; BatchNorm
    running statistics update in train mode (UPDATE_OPS parity); Adam;
  * streaming train metrics (loss / accuracy / logloss / calibration /
    200-bin AUC) on the device, logged every ``log_every`` steps with the
    summaries the model keeps in ``sown`` (scalars, or histogram records
    in ``summaries/scalars.jsonl``);
  * eval every ``eval_every_steps`` steps or ``eval_throttle_secs`` seconds,
    and a final eval;
  * checkpoints (``torch.save``: model, optimizer, step, dropout generator)
    every ``save_checkpoints_steps``, the last 3 kept, resume from the
    latest; a best-exporter keyed on the first task's eval AUC that keeps
    the ``keep_best`` best exports (BestExporter(exports_to_keep=5) parity);
  * SIGTERM (``handle_sigterm``): finish the step in flight, checkpoint,
    return without the final eval;
  * the PAD-compacted table gradient (``compact_grad_scatter``, on by
    default as in the JAX trainer; ``ops/compact_scatter.py``): before each
    step, ``batch_fits_compact`` checks the host batch's ``*_len`` columns
    (no device sync), and the step's long sequence lookups take the
    compacted backward when it fits and the full one when it does not, so
    the gradient is exact at every density;
  * ``fuse_optimizer`` is accepted and changes nothing: every optimizer's
    update is already one multi-tensor chain (``train/optimizers.py``);
  * how a step runs, chosen once from the mesh, the accumulation, the
    device and the optimizer (``step_graph.engaged``):
    row gradients of the tables (``tables.row_sparse_grads``): where there
    is no process mesh, no gradient accumulation and the optimizer is one
    whose class applies row gradients (``optimizers.Adagrad``), a step's
    lookups of whole f32 tables make row gradients and the update touches
    those rows alone.  Everywhere else (a mesh's all-reduce and the
    accumulator's running mean want dense gradients, as does the dual
    optimizer's FTRL) the gradients are dense;
  * on CUDA the whole step is one CUDA graph, replayed
    (``train/step_graph.py``): where there is no process mesh, no gradient
    accumulation and the optimizer's updates can be captured (Adam, SGD and
    LazyAdam), a key's (compaction choice, columns' shapes) first step runs
    eagerly, its second captures and replays, and every later one replays.
    The eager step and the capture run one body (``_step_body``).
    Everywhere else every step runs eagerly;
  * gradient accumulation (``grad_accum_steps`` = k, ``optax.MultiSteps``
    semantics): the optimizer is applied every k micro-batches with the
    running mean of their gradients, so its count (Adam's bias correction,
    the schedule) advances once per application; BatchNorm statistics and
    the metrics update on every micro-batch, and ``step`` counts
    micro-batches.  The accumulator is checkpointed with the rest.

Several processes (``mesh``, a ``parallel/mesh.ProcessMesh``): the model's
tables are row-sharded and its divisible expert groups split over the model
axis (``mesh.shard_model``); each rank trains on its data shard's rows and
backpropagates its local-mean loss.  Then replicated parameters' gradients
are averaged over all ranks, expert shards' over their data column, and a
table shard's gradient, which the exchange's backward already summed over
every data shard, is divided by the data shard count: every gradient is the
global batch mean's.  The metrics are summed over the data column before
they are reported, the ``eval_throttle_secs`` decision is rank 0's,
``predict`` returns the global rows on every rank, and checkpoints and best
exports gather the whole state to rank 0, which writes the one-process
layout (every rank restores from it and takes its shard).  Each data shard
draws its own dropout stream; the ranks of a data row draw the same.

Several processes without a mesh (``--no_mesh``) decide on compaction per
batch, each rank alone.  The JAX trainer agrees on the choice over all hosts
(``agreed_all``) because its two choices are two executables whose
collectives must match; here the step runs eagerly, no collective depends on
the choice, and there is nothing to agree on.  Under a mesh the lookups are
``embed/sharded.py``'s exchange, which keeps its own backward.

The JAX trainer's ``rng_impl`` (a TPU PRNG) and ``scoped_vmem_limit_kib``
(an XLA-on-TPU compiler budget) have no counterpart on the card.

Data contract: iterables of host batches (dict[str, np.ndarray]) with fixed
shapes; an optional ``"_weights"`` (B,) 0/1 mask marks real rows in padded
eval tails.  Only the model's inputs (the schema's batch columns) and
``_weights`` go to the device: metadata such as ``_index`` stays on the
host.  The put is ``utils/device.to_device`` (on a card, one non-blocking
copy through pinned staging memory).  The model is built (and
initialised) by the caller; the trainer moves it to its device.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, Iterable, Mapping

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.embed import tables
from recalgorithm_tpu_torch.ops import compact_scatter as cs
from recalgorithm_tpu_torch.ops.activations import Dropout
from recalgorithm_tpu_torch.parallel import mesh as mesh_lib
from recalgorithm_tpu_torch.parallel import multihost
from recalgorithm_tpu_torch.train import metrics as M
from recalgorithm_tpu_torch.train import step_graph
from recalgorithm_tpu_torch.utils.device import resolve_device, to_device
from recalgorithm_tpu_torch.utils.summary import SummaryWriter, span

CHECKPOINTS_KEPT = 3


@dataclasses.dataclass
class TaskMetrics:
    auc: M.AUCState
    acc: M.ScalarMeanState
    logloss: M.ScalarMeanState
    pmean: M.ScalarMeanState
    ymean: M.ScalarMeanState

    @classmethod
    def init(cls, device) -> "TaskMetrics":
        return cls(auc=M.AUCState.init(device), acc=M.ScalarMeanState.init(device),
                   logloss=M.ScalarMeanState.init(device),
                   pmean=M.ScalarMeanState.init(device),
                   ymean=M.ScalarMeanState.init(device))


@dataclasses.dataclass
class MetricsState:
    loss_mean: M.ScalarMeanState
    task_metrics: dict[str, TaskMetrics]


@dataclasses.dataclass
class TrainerConfig:
    model_dir: str = "./model_dir"
    train_steps: int = 10000
    log_every: int = 100
    eval_every_steps: int = 0  # 0 = no step-triggered eval
    # time-based eval throttle, the reference's EvalSpec(throttle_secs=600)
    # (wide_and_deep.py:350-355); 0 disables (the final eval always runs)
    eval_throttle_secs: float = 0.0
    save_checkpoints_steps: int = 1000
    keep_best: int = 5  # BestExporter(exports_to_keep=5)
    seed: int = 42  # seeds the dropout generator (seed + 1, as the JAX loop)
    # accepted and unused: every update is already multi-tensor
    # (train/optimizers.py), what the JAX maybe_fuse makes of optax's
    fuse_optimizer: bool = False
    # PAD-compacted gradient of long sequence lookups (ops/compact_scatter.py);
    # a batch that overflows the compact buffer runs with it off
    compact_grad_scatter: bool = True
    # catch SIGTERM: finish the step in flight, checkpoint, skip the final
    # eval (installs in the main thread only)
    handle_sigterm: bool = True
    # apply the optimizer every k micro-batches with the mean of their
    # gradients (optax.MultiSteps); train_steps counts micro-batches
    grad_accum_steps: int = 1


class Trainer:
    def __init__(self, model: torch.nn.Module, task_names: tuple[str, ...],
                 optimizer: Callable, config: TrainerConfig,
                 device: str | torch.device | None = None, mesh=None,
                 global_batch_size: int | None = None):
        """``optimizer`` is a factory of the parameters (``optimizers.build``,
        ``optimizers.dual_wide_deep``);
        ``device`` defaults to ``cuda`` and raises without a card.  With a
        ``mesh`` the whole ``model`` is sharded onto it here (every rank
        builds the same model from the same seed, or loads whole weights
        first); ``device`` is this rank's, and ``global_batch_size`` (required
        then) the rows of a train step over all data shards: every train step
        checks that this rank holds its share of them."""
        if mesh is not None and global_batch_size is None:
            raise ValueError("a Trainer on a mesh needs the global batch size")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.global_batch_size = global_batch_size
        # what each state_dict entry is on this rank (mesh.shard_model); one
        # process holds everything whole
        self.specs = (mesh_lib.shard_model(model, mesh) if mesh is not None
                      else dict.fromkeys(model.state_dict(), mesh_lib.REPLICATED))
        self.model = model.to(self.device)
        self.task_names = tuple(task_names)
        self.config = config
        self.optimizer = optimizer(list(self.model.parameters()))
        stream = config.seed + 1 + (mesh.data_index if mesh is not None else 0)
        self.generator = torch.Generator(device=self.device).manual_seed(stream)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator
        self.step = 0
        self.metrics = self._fresh_metrics()
        if config.grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {config.grad_accum_steps}")
        # MultiSteps state: micro-batches accumulated so far in this window
        # and the running mean of their gradients
        self.mini_step = 0
        self.accum = ([torch.zeros_like(p) for p in self.model.parameters()]
                      if config.grad_accum_steps > 1 else [])
        self._inputs = frozenset(self.model.schema.batch_spec(1)) | {"_weights"}
        # a batch's row count as a device constant, by row count
        self._rows: dict[int, torch.Tensor] = {}
        paths = step_graph.engaged(self.device, mesh, config.grad_accum_steps, self.optimizer)
        # the step's CUDA graphs by key (step_graph.py); None: every step eager
        self._step_graphs: dict[step_graph.Key, step_graph.StepGraph] | None = (
            {} if paths.replay else None)
        self._side = torch.cuda.Stream(self.device) if paths.replay else None
        self._grads_of = None  # the graph whose gradients the parameters hold
        self.replays = 0  # steps that ran as a graph replay
        self.row_grads = paths.row_grads

    def _fresh_metrics(self) -> MetricsState:
        return MetricsState(M.ScalarMeanState.init(self.device),
                            {t: TaskMetrics.init(self.device) for t in self.task_names})

    # -- steps ---------------------------------------------------------------

    def _put_batch(self, batch: Mapping[str, np.ndarray],
                   global_rows: int | None = None) -> dict[str, torch.Tensor]:
        """The model's columns of a host batch on the device; under a mesh
        with ``global_rows``, checked to be this rank's share of a global
        batch of that many rows."""
        if self.mesh is not None and global_rows is not None:
            return multihost.global_batch(batch, self.mesh, global_rows, self.device,
                                          self._inputs)
        return to_device(batch, self.device, self._inputs)

    def _task_label(self, batch, task: str) -> torch.Tensor:
        """A task's label column; a model may derive a joint label (ESMM's
        ``ctcvr``) in its ``derived_label``."""
        label_idx = {name: i for i, name in enumerate(self.model.schema.labels)}
        if task in label_idx:
            return batch["labels"][:, label_idx[task]]
        if hasattr(self.model, "derived_label"):
            return self.model.derived_label(task, batch)
        raise KeyError(f"task {task!r} has no label column or derivation")

    def _loss_and_logits(self, batch) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        logits, reg = self.model(batch)
        weights = batch.get("_weights")
        # optional per-task loss weights (config.task_loss_weights, (task, w) pairs)
        tlw = dict(getattr(getattr(self.model, "config", None),
                           "task_loss_weights", ()) or ())
        total = torch.zeros((), device=self.device)
        for task in self.task_names:
            ce = F.binary_cross_entropy_with_logits(
                logits[task], self._task_label(batch, task), reduction="none")
            if weights is not None:
                mean = (ce * weights).sum() / weights.sum().clamp(min=1.0)
            else:
                mean = ce.mean()
            total = total + tlw.get(task, 1.0) * mean
        for leaf in reg.values():
            total = total + leaf.sum()
        return total, logits

    def _update_metrics(self, state: MetricsState, batch, logits, loss) -> None:
        """Adds the batch to ``state`` in place."""
        weights = batch.get("_weights")
        for task in self.task_names:
            y = self._task_label(batch, task)
            p = torch.sigmoid(logits[task])
            tm = state.task_metrics[task]
            pc = p.clamp(1e-7, 1.0 - 1e-7)
            ce = -(y * torch.log(pc) + (1.0 - y) * torch.log1p(-pc))
            M.auc_update(tm.auc, y, p, weights)
            M.mean_update(tm.acc, ((p >= 0.5).to(torch.float32) == y).to(torch.float32),
                          weights)
            M.mean_update(tm.logloss, ce, weights)
            M.mean_update(tm.pmean, p, weights)
            M.mean_update(tm.ymean, y.to(torch.float32), weights)
        M.mean_update(state.loss_mean, loss[None],
                      weights.sum()[None] if weights is not None else self._row_count(batch))

    def _row_count(self, batch) -> torch.Tensor:
        """(1,) f32 of the batch's rows, a device constant made once."""
        b = int(batch["labels"].shape[0])
        if b not in self._rows:
            self._rows[b] = torch.full((1,), float(b), device=self.device)
        return self._rows[b]

    def _reduce_grads(self, loss: torch.Tensor) -> torch.Tensor:
        """Under a mesh: every gradient to the global batch mean's (module
        docstring), in one all_reduce over all ranks and, with expert
        shards, one over the data column.  Returns the global mean loss,
        which rides the first all_reduce."""
        mesh = self.mesh
        replicated, experts = [loss.detach().reshape(1)], []
        for name, p in self.model.named_parameters():
            if p.grad is None:
                continue
            spec = self.specs[name]
            if spec == mesh_lib.TABLE:
                p.grad.div_(mesh.data_size)
            elif spec == mesh_lib.EXPERT and mesh.num_model > 1:
                experts.append(p.grad)
            else:
                replicated.append(p.grad)
        for grads, group, n in ((replicated, None, mesh.world),
                                (experts, mesh.data_group, mesh.data_size)):
            if not grads:
                continue
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            flat.div_(n)
            for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        return replicated[0][0]

    def train_step(self, host_batch: Mapping[str, np.ndarray]) -> torch.Tensor:
        """One optimizer step on a host batch; returns the loss (on the
        device; under a mesh the global batch's).  The compaction choice is
        made on the host batch, before it goes to the device.  Its phases
        are spans under ``train.step`` (``utils/summary.py``; recorded while
        a profiler runs): ``train.put`` (the compaction choice and the put,
        which on a card returns once its copy is queued, after waiting only
        where the host is two puts ahead of the card), then for an eager step
        ``train.forward``, ``train.backward``, ``train.optimizer`` and
        ``train.metrics``, for a replayed one ``train.replay`` (after a
        ``train.capture`` where the step captured its graph, or captured it
        again because a load of optimizer state replaced what it reads)."""
        with span("train.step"):
            with span("train.put"):
                cols = {k: v for k, v in host_batch.items() if k in self._inputs}
                compact = (self.config.compact_grad_scatter and self.mesh is None
                           and cs.batch_fits_compact(cols, self.model.schema))
                graph = self._graph_of(cols, compact)
                # a graph's inputs are overwritten on the stream its replays run
                # on, so the previous replay has read them before this copy lands
                batch = (to_device(cols, self.device, out=graph.inputs) if graph is not None
                         else self._put_batch(cols, self.global_batch_size))
            if graph is None:
                return self._eager_step(batch, compact)
            if not graph.warm:
                return self._warm_up(graph, batch, compact)
            if graph.graph is None or graph.version != self.optimizer.version:
                with span("train.capture"):
                    self._capture(graph, batch, compact)
            with span("train.replay"):
                return self._replay(graph)

    def _graph_of(self, cols, compact: bool) -> step_graph.StepGraph | None:
        """The step graph of the key of ``cols``, the model's columns of a
        host batch (its others, such as ``_index``, stay on the host), made
        at its first sight; None where steps run eagerly."""
        if self._step_graphs is None:
            return None
        k = step_graph.key(cols, compact)
        graph = self._step_graphs.get(k)
        if graph is None:
            graph = self._step_graphs[k] = step_graph.StepGraph.of(cols, self.device)
        return graph

    def _step_body(self, batch, compact: bool, update: Callable[[], None],
                   reduce: Callable[[torch.Tensor], torch.Tensor] | None = None
                   ) -> torch.Tensor:
        """The step, as the eager step runs it and a capture records it: the
        forward under both lookup modes (the compaction choice, the row
        gradients), the backward (the gradients set to None first, then
        ``reduce``'s, if any), ``update`` and the metric update.  Returns the
        loss, or ``reduce``'s result."""
        with span("train.forward"):
            self.model.train()
            with tables.compact_grad_scatter(compact), tables.row_sparse_grads(self.row_grads):
                loss, logits = self._loss_and_logits(batch)
        with span("train.backward"):
            self.optimizer.zero_grad()
            loss.backward()
            reduced = reduce(loss) if reduce is not None else None
        with span("train.optimizer"):
            update()
        with span("train.metrics"):
            loss = loss.detach()
            self._update_metrics(self.metrics, batch,
                                 {t: v.detach() for t, v in logits.items()}, loss)
        return loss if reduced is None else reduced

    def _eager_step(self, batch, compact: bool) -> torch.Tensor:
        """The step run now: under a mesh with the gradients reduced and
        the global loss returned."""
        self._grads_of = None
        return self._step_body(batch, compact, self._apply_grads,
                               self._reduce_grads if self.mesh is not None else None)

    def _warm_up(self, graph: step_graph.StepGraph, batch, compact: bool) -> torch.Tensor:
        """A key's first step: eager, on the side stream the capture uses."""
        stream = torch.cuda.current_stream(self.device)
        self._side.wait_stream(stream)
        with torch.cuda.stream(self._side):
            loss = self._eager_step(batch, compact)
        stream.wait_stream(self._side)
        graph.warm = True
        return loss

    def _capture(self, graph: step_graph.StepGraph, batch, compact: bool) -> None:
        """Captures the step's body into ``graph`` with the optimizer's
        update alone (its rate is written before each replay), no kernel
        running: the replay that follows runs them.  The gradients are set
        to None before the capture, so the backward makes them in the
        graph's pool.  A failure raises."""
        graph.graph = None  # a graph captured again frees its old pool first
        self.optimizer.zero_grad()
        cuda_graph = torch.cuda.CUDAGraph()
        cuda_graph.register_generator_state(self.generator)
        with torch.cuda.graph(cuda_graph, stream=self._side):
            loss = self._step_body(batch, compact, self.optimizer.apply)
        graph.graph, graph.loss, graph.version = cuda_graph, loss, self.optimizer.version
        graph.grads = [p.grad for p in self.model.parameters()]
        self._grads_of = None

    def _replay(self, graph: step_graph.StepGraph) -> torch.Tensor:
        """The step as ``graph``'s replay: the rate written, the graph
        launched; the parameters hold its gradients after it."""
        if not self.model.training:
            self.model.train()
        self.optimizer.prepare()
        loss = graph.replay()
        if self._grads_of is not graph:
            for p, g in zip(self.model.parameters(), graph.grads):
                p.grad = g
            self._grads_of = graph
        self.step += 1
        self.replays += 1
        return loss

    def _apply_grads(self) -> None:
        """The optimizer step, or with ``grad_accum_steps`` k > 1 the running
        mean of the gradients and a step every k-th call."""
        k = self.config.grad_accum_steps
        if k == 1:
            self.optimizer.step()
        else:
            n = self.mini_step
            with torch.no_grad():
                for p, acc in zip(self.model.parameters(), self.accum):
                    g = p.grad if p.grad is not None else torch.zeros_like(acc)
                    acc.add_((g - acc) / (n + 1))  # optax's running mean
            if n == k - 1:
                for p, acc in zip(self.model.parameters(), self.accum):
                    p.grad = acc.clone()
                    acc.zero_()
                self.optimizer.step()
                self.optimizer.zero_grad()
            self.mini_step = (n + 1) % k
        self.step += 1

    # -- metric reporting ----------------------------------------------------

    def _metrics_snapshot(self, state: MetricsState) -> dict[str, float]:
        """The reported metrics; under a mesh the data column's states are
        summed first (collective), so they are the global batch's."""
        if self.mesh is not None and self.mesh.data_size > 1:
            parts: list[torch.Tensor] = []
            _map_tensors(state, lambda t: parts.append(t) or t)
            flat = multihost.all_reduce_sum(torch.cat([t.reshape(-1) for t in parts]),
                                            self.mesh.data_group)
            pieces = iter(torch.split(flat, [t.numel() for t in parts]))
            state = _map_tensors(state, lambda t: next(pieces).view_as(t))
        out = {"loss": float(M.mean_compute(state.loss_mean))}
        for task, tm in state.task_metrics.items():
            out[f"{task}_auc"] = float(M.auc_compute(tm.auc))
            out[f"{task}_accuracy"] = float(M.mean_compute(tm.acc))
            out[f"{task}_logloss"] = float(M.mean_compute(tm.logloss))
            out[f"{task}_calibration"] = float(M.mean_compute(tm.pmean)) / max(
                float(M.mean_compute(tm.ymean)), 1e-7)
        return out

    def _log_summaries(self, writer: SummaryWriter, step: int, log_fn) -> None:
        """Log the summaries the model kept in its last train-mode forward
        (``model.sown``, e.g. the W&D wide kernel and its norm), as the JAX
        trainer logs its sown collection: a value of size 1 to the scalar
        stream and the console, up to 32 values as indexed scalars, larger
        ones as a histogram record."""
        sown = getattr(self.model, "sown", None)
        if not sown:
            return
        scalars: dict[str, float] = {}
        console: list[str] = []
        for tag, leaf in sown.items():
            v = leaf.detach().cpu().numpy()
            if v.size == 1:
                scalars[f"summaries/{tag}"] = float(v)
                console.append(f"{tag}={float(v):.5f}")
            elif v.size <= 32:
                for i, x in enumerate(v.ravel()):
                    scalars[f"summaries/{tag}/{i}"] = float(x)
                console.append(f"{tag}=[" + " ".join(f"{x:.4f}" for x in v.ravel()) + "]")
            else:
                writer.histogram(step, f"summaries/{tag}", v)
        if scalars:
            writer.scalars(step, scalars)
        if console:
            log_fn(f"step {step} summaries: " + " ".join(console))

    def _time_eval_due(self, step: int, last_eval_time: float) -> bool:
        """Whether the wall-clock eval throttle fires at this step.  Under a
        mesh the check runs only every ``log_every`` steps, where every rank
        is, and rank 0's clock decides for all (clocks drift: ranks that
        disagree would enter different collectives)."""
        cfg = self.config
        if not cfg.eval_throttle_secs:
            return False
        due = time.time() - last_eval_time >= cfg.eval_throttle_secs
        if self.mesh is None:
            return due
        if step % cfg.log_every:
            return False
        return multihost.agreed_flag(due)

    def full_state_dict(self) -> dict[str, torch.Tensor]:
        """The whole model state dict (under a mesh gathered from every
        rank's shards: collective)."""
        sd = self.model.state_dict()
        if self.mesh is None:
            return sd
        return mesh_lib.gather_state_dict(sd, self.specs, self.mesh)

    # -- public API ----------------------------------------------------------

    def evaluate(self, eval_batches: Iterable[Mapping[str, np.ndarray]]) -> dict[str, float]:
        state = self._fresh_metrics()
        self.model.eval()
        with torch.no_grad():
            for hb in eval_batches:
                batch = self._put_batch(hb)
                loss, logits = self._loss_and_logits(batch)
                self._update_metrics(state, batch, logits, loss)
        return self._metrics_snapshot(state)

    def predict(self, batches: Iterable[Mapping[str, np.ndarray]], collect: tuple[str, ...] = ()
                ) -> dict[str, np.ndarray] | tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
        """Probabilities per task, concatenated over batches; rows with
        ``_weights == 0`` (padded tails) dropped.

        ``collect`` names extra batch columns (labels, ``_index``, id
        columns) returned row-aligned with the probabilities, read from the
        host batch; with a non-empty ``collect`` the return is
        ``(probs, collected)``.  Under a mesh every rank returns the global
        rows: each batch's data shards in rank order (one collective at the
        end; every rank predicts the same number of batches)."""
        local = []
        self.model.eval()
        with torch.no_grad():
            for hb in batches:
                logits, _ = self.model(self._put_batch(hb))
                keep = (np.asarray(hb["_weights"]) > 0 if "_weights" in hb
                        else np.ones(len(next(iter(hb.values()))), bool))
                local.append(({t: torch.sigmoid(logits[t]).cpu().numpy() for t in self.task_names},
                              {k: np.asarray(hb[k]) for k in collect}, keep))
        shards = [local]
        if self.mesh is not None and self.mesh.data_size > 1:
            shards = [None] * self.mesh.data_size
            dist.all_gather_object(shards, local, group=self.mesh.data_group)
            if len({len(s) for s in shards}) != 1:
                raise RuntimeError(f"data shards predicted {[len(s) for s in shards]} batches")
        outs: dict[str, list[np.ndarray]] = {t: [] for t in self.task_names}
        extras: dict[str, list[np.ndarray]] = {k: [] for k in collect}
        for parts in zip(*shards):
            for probs, cols, keep in parts:
                for t in self.task_names:
                    outs[t].append(probs[t][keep])
                for k in collect:
                    extras[k].append(cols[k][keep])
        probs = {t: np.concatenate(v) if v else np.empty((0,), np.float32)
                 for t, v in outs.items()}
        if not collect:
            return probs
        return probs, {k: np.concatenate(v) if v else np.empty((0,)) for k, v in extras.items()}

    def train_and_evaluate(
        self,
        train_batches: Iterable[Mapping[str, np.ndarray]],
        eval_batches_fn: Callable[[], Iterable[Mapping[str, np.ndarray]]] | None = None,
        log_fn: Callable[[str], None] = print,
    ) -> dict[str, float]:
        """Resume from the latest checkpoint of ``model_dir`` if there is one,
        then train until ``train_steps`` (the batches continue the stream: a
        resumed run is fed the batches after the restored step).  Returns the
        final eval metrics (empty when preempted or without eval batches)."""
        cfg = self.config
        checkpointer = _Checkpointer(cfg.model_dir, cfg.keep_best)
        checkpointer.restore_latest(self)
        summary = SummaryWriter(os.path.join(cfg.model_dir, "summaries"),
                                enabled=multihost.process_index() == 0)

        # preemption notice (SIGTERM): finish the step in flight, save, skip
        # the final eval.  Installs only in the main thread; restored on return.
        preempted = {"flag": False}
        prev_handler = None
        if cfg.handle_sigterm:
            try:
                prev_handler = signal.signal(
                    signal.SIGTERM, lambda signum, frame: preempted.update(flag=True))
            except ValueError:  # not the main thread
                pass

        try:
            t0 = last_eval_time = time.time()
            last_log_step = self.step
            train_iter = iter(train_batches)
            while self.step < cfg.train_steps and not preempted["flag"]:
                try:
                    hb = next(train_iter)
                except StopIteration:
                    break
                self.train_step(hb)
                step = self.step
                if step % cfg.log_every == 0 and step != last_log_step:
                    snap = self._metrics_snapshot(self.metrics)
                    rows = len(hb["labels"]) * (self.mesh.data_size if self.mesh else 1)
                    rate = (step - last_log_step) * rows / max(time.time() - t0, 1e-9)
                    log_fn(f"step {step} loss={snap['loss']:.5f} "
                           + " ".join(f"{t}_auc={snap[f'{t}_auc']:.5f}"
                                      for t in self.task_names)
                           + f" ({rate:,.0f} ex/s)")
                    summary.scalars(step, {f"train/{k}": v for k, v in snap.items()}
                                    | {"train/examples_per_s": rate})
                    self._log_summaries(summary, step, log_fn)
                    t0, last_log_step = time.time(), step
                if cfg.save_checkpoints_steps and step % cfg.save_checkpoints_steps == 0:
                    checkpointer.save(self)
                due_steps = cfg.eval_every_steps and step % cfg.eval_every_steps == 0
                due_time = self._time_eval_due(step, last_eval_time)
                if eval_batches_fn is not None and (due_steps or due_time):
                    ev = self.evaluate(eval_batches_fn())
                    last_eval_time = time.time()
                    log_fn(f"eval @ {step}: {ev}")
                    summary.scalars(step, {f"eval/{k}": v for k, v in ev.items()})
                    checkpointer.maybe_export_best(self, ev[f"{self.task_names[0]}_auc"])
            checkpointer.save(self)
            if preempted["flag"]:
                log_fn(f"SIGTERM: checkpoint saved at step {self.step}, skipping "
                       "final eval (restart resumes from it)")
                return {}
            final_eval: dict[str, float] = {}
            if eval_batches_fn is not None:
                final_eval = self.evaluate(eval_batches_fn())
                log_fn(f"final eval: {final_eval}")
                summary.scalars(self.step, {f"eval/{k}": v for k, v in final_eval.items()})
                checkpointer.maybe_export_best(self, final_eval[f"{self.task_names[0]}_auc"])
            return final_eval
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            summary.close()


def latest_checkpoint_step(model_dir: str) -> int:
    """Step of the newest checkpoint under ``model_dir`` (0 if none)."""
    steps = _Checkpointer.steps(os.path.join(os.path.abspath(model_dir), "checkpoints"))
    return steps[-1] if steps else 0


def _map_tensors(obj, fn):
    """``obj`` (dataclasses and dicts of tensors) with ``fn`` applied to each
    tensor, in field order."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return dataclasses.replace(obj, **{f.name: _map_tensors(getattr(obj, f.name), fn)
                                       for f in dataclasses.fields(obj)})


def _optimizer_state(trainer: Trainer, sd: dict, fn) -> dict:
    """``sd``, a state dict of ``trainer.optimizer``, with ``fn(tensor,
    spec)`` applied to each parameter's state tensors (not the 0-d counts),
    ``spec`` being the parameter's (``trainer.specs``).  ``sd``'s
    per-parameter dicts are replaced, not changed (``state_dict()`` shares
    them with the live state)."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    parts = getattr(trainer.optimizer, "parts", None)
    pairs = ([(sd[k], o) for k, o in parts.items()] if parts is not None
             else [(sd, trainer.optimizer)])
    for packed, opt in pairs:
        params = [p for g in opt.opt.param_groups for p in g["params"]]
        state = packed["opt"]["state"]
        for idx, st in list(state.items()):
            spec = trainer.specs[names[id(params[idx])]]
            state[idx] = {k: fn(v, spec) if torch.is_tensor(v) and v.dim() > 0 else v
                          for k, v in st.items()}
    return sd


class _Checkpointer:
    """``torch.save`` checkpoints (the last CHECKPOINTS_KEPT kept) and the
    best-AUC exporter.  Under a mesh every rank calls each method at the
    same point: the whole state is gathered to rank 0, which alone writes,
    and every rank restores from the one file and takes its shard."""

    def __init__(self, model_dir: str, keep_best: int = 5):
        self.model_dir = os.path.abspath(model_dir)
        self.keep_best = keep_best
        self.dir = os.path.join(self.model_dir, "checkpoints")
        self.writer = multihost.process_index() == 0
        os.makedirs(self.dir, exist_ok=True)
        # the keep-or-evict bookkeeping runs alike on every rank, from one read
        self.best = convert.read_best(self.model_dir)

    @staticmethod
    def steps(ckpt_dir: str) -> list[int]:
        if not os.path.isdir(ckpt_dir):
            return []
        return sorted(int(f[5:-3]) for f in os.listdir(ckpt_dir)
                      if f.startswith("ckpt_") and f.endswith(".pt"))

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step}.pt")

    def save(self, trainer: Trainer) -> None:
        mesh = trainer.mesh
        generator = trainer.generator.get_state()
        if mesh is None:
            model, opt, accum, generators = (trainer.model.state_dict(),
                                              trainer.optimizer.state_dict(), trainer.accum, None)
        else:
            model = trainer.full_state_dict()
            opt = _optimizer_state(trainer, trainer.optimizer.state_dict(),
                                   lambda t, spec: mesh_lib.gather_tensor(t, spec, mesh))
            names = [n for n, _ in trainer.model.named_parameters()]
            accum = [mesh_lib.gather_tensor(a, trainer.specs[n], mesh)
                     for n, a in zip(names, trainer.accum)]
            generators = [None] * mesh.world
            dist.all_gather_object(generators, generator)
        if not self.writer:
            return
        path = self._path(trainer.step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"model": model, "optimizer": opt, "step": trainer.step,
                    "generator": generator, "generators": generators,
                    "mini_step": trainer.mini_step, "accum": accum}, tmp)
        os.replace(tmp, path)  # atomic: a reader never sees half a checkpoint
        for old in self.steps(self.dir)[:-CHECKPOINTS_KEPT]:
            os.remove(self._path(old))

    def restore_latest(self, trainer: Trainer) -> None:
        steps = self.steps(self.dir)
        if not steps:
            return
        ck = torch.load(self._path(steps[-1]), map_location="cpu", weights_only=True)
        model, opt, accum = ck["model"], ck["optimizer"], ck.get("accum", [])
        generator = ck["generator"]
        mesh = trainer.mesh
        if mesh is not None:
            model = mesh_lib.shard_state_dict(model, trainer.specs, mesh)
            opt = _optimizer_state(trainer, opt,
                                   lambda t, spec: mesh_lib.shard_tensor(t, spec, mesh))
            names = [n for n, _ in trainer.model.named_parameters()]
            accum = [mesh_lib.shard_tensor(a, trainer.specs[n], mesh)
                     for n, a in zip(names, accum)]
            generators = ck.get("generators")
            if generators is not None and len(generators) == mesh.world:
                generator = generators[mesh.rank]
        trainer.model.load_state_dict(model)  # in place: the graphs keep reading it
        trainer.optimizer.load_state_dict(opt)  # new state tensors: graphs captured again
        trainer.step = int(ck["step"])
        trainer.generator.set_state(generator)  # a replay reads it anew
        if len(accum) != len(trainer.accum):
            raise ValueError(f"checkpoint {steps[-1]} was written with another "
                             "grad_accum_steps than this run's")
        trainer.mini_step = int(ck.get("mini_step", 0))
        for acc, saved in zip(trainer.accum, accum):
            acc.copy_(saved)

    def maybe_export_best(self, trainer: Trainer, auc: float) -> None:
        """Keep the ``keep_best`` highest-AUC exports (BestExporter parity).
        The decision is the same on every rank (the same AUC and list), so
        every rank enters the gather or none does."""
        keep = self.keep_best
        if len(self.best) >= keep and auc <= min(a for a, _ in self.best):
            return
        full = trainer.full_state_dict()
        self.best = sorted(set(self.best) | {(auc, trainer.step)}, reverse=True)[:keep]
        if self.writer:
            convert.save_export(self.model_dir, trainer.step, auc, trainer.model,
                                keep=keep, state_dict=full)
