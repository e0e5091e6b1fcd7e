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
    the BEST_EXPORTS_KEPT best exports (BestExporter(exports_to_keep=5) parity);
  * SIGTERM: finish the step in flight, checkpoint, return without the final
    eval;
  * gradient accumulation (``grad_accum_steps`` = k, ``optax.MultiSteps``
    semantics): the optimizer is applied every k micro-batches with the
    running mean of their gradients, so its count (Adam's bias correction,
    the schedule) advances once per application; BatchNorm statistics and
    the metrics update on every micro-batch, and ``step`` counts
    micro-batches.  The accumulator is checkpointed with the rest.

Not ported yet: the mesh (multi-device), the compact gradient scatter (its
torch counterpart, the gather's backward, is exact at every density), the
TPU compiler options and ``rng_impl``.

Data contract: iterables of host batches (dict[str, np.ndarray]) with fixed
shapes; an optional ``"_weights"`` (B,) 0/1 mask marks real rows in padded
eval tails.  Only the model's inputs (the schema's batch columns) and
``_weights`` go to the device: metadata such as ``_index`` stays on the
host.  The model is built (and initialised) by the caller; the trainer moves
it to its device.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.ops.activations import Dropout
from recalgorithm_tpu_torch.serving.predictor import resolve_device
from recalgorithm_tpu_torch.train import metrics as M
from recalgorithm_tpu_torch.utils.summary import SummaryWriter

CHECKPOINTS_KEPT = 3
BEST_EXPORTS_KEPT = 5  # BestExporter(exports_to_keep=5)


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
    seed: int = 42  # seeds the dropout generator (seed + 1, as the JAX loop)
    # apply the optimizer every k micro-batches with the mean of their
    # gradients (optax.MultiSteps); train_steps counts micro-batches
    grad_accum_steps: int = 1


class Trainer:
    def __init__(self, model: torch.nn.Module, task_names: tuple[str, ...],
                 optimizer: Callable, config: TrainerConfig,
                 device: str | torch.device | None = None):
        """``optimizer`` is a factory of the parameters (``optimizers.build``,
        ``optimizers.dual_wide_deep``);
        ``device`` defaults to ``cuda`` and raises without a card."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.task_names = tuple(task_names)
        self.config = config
        self.optimizer = optimizer(list(self.model.parameters()))
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)
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

    def _fresh_metrics(self) -> MetricsState:
        return MetricsState(M.ScalarMeanState.init(self.device),
                            {t: TaskMetrics.init(self.device) for t in self.task_names})

    # -- steps ---------------------------------------------------------------

    def _put_batch(self, batch: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items() if k in self._inputs}

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

    def _update_metrics(self, state: MetricsState, batch, logits, loss) -> MetricsState:
        weights = batch.get("_weights")
        tms = {}
        for task in self.task_names:
            y = self._task_label(batch, task)
            p = torch.sigmoid(logits[task])
            tm = state.task_metrics[task]
            pc = p.clamp(1e-7, 1.0 - 1e-7)
            ce = -(y * torch.log(pc) + (1.0 - y) * torch.log1p(-pc))
            tms[task] = TaskMetrics(
                auc=M.auc_update(tm.auc, y, p, weights),
                acc=M.mean_update(tm.acc, ((p >= 0.5).to(torch.float32) == y)
                                  .to(torch.float32), weights),
                logloss=M.mean_update(tm.logloss, ce, weights),
                pmean=M.mean_update(tm.pmean, p, weights),
                ymean=M.mean_update(tm.ymean, y.to(torch.float32), weights),
            )
        n = weights.sum() if weights is not None else torch.tensor(
            float(batch["labels"].shape[0]), device=self.device)
        return MetricsState(M.mean_update(state.loss_mean, loss[None], n[None]), tms)

    def train_step(self, host_batch: Mapping[str, np.ndarray]) -> torch.Tensor:
        """One optimizer step on a host batch; returns the loss (on the device)."""
        batch = self._put_batch(host_batch)
        self.model.train()
        loss, logits = self._loss_and_logits(batch)
        self.optimizer.zero_grad()
        loss.backward()
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
        loss = loss.detach()
        self.metrics = self._update_metrics(
            self.metrics, batch, {t: v.detach() for t, v in logits.items()}, loss)
        return loss

    # -- metric reporting ----------------------------------------------------

    @staticmethod
    def _metrics_snapshot(state: MetricsState) -> dict[str, float]:
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

    # -- public API ----------------------------------------------------------

    def evaluate(self, eval_batches: Iterable[Mapping[str, np.ndarray]]) -> dict[str, float]:
        state = self._fresh_metrics()
        self.model.eval()
        with torch.no_grad():
            for hb in eval_batches:
                batch = self._put_batch(hb)
                loss, logits = self._loss_and_logits(batch)
                state = self._update_metrics(state, batch, logits, loss)
        return self._metrics_snapshot(state)

    def predict(self, batches: Iterable[Mapping[str, np.ndarray]], collect: tuple[str, ...] = ()
                ) -> dict[str, np.ndarray] | tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
        """Probabilities per task, concatenated over batches; rows with
        ``_weights == 0`` (padded tails) dropped.

        ``collect`` names extra batch columns (labels, ``_index``, id
        columns) returned row-aligned with the probabilities, read from the
        host batch; with a non-empty ``collect`` the return is
        ``(probs, collected)``."""
        outs: dict[str, list[np.ndarray]] = {t: [] for t in self.task_names}
        extras: dict[str, list[np.ndarray]] = {k: [] for k in collect}
        self.model.eval()
        with torch.no_grad():
            for hb in batches:
                logits, _ = self.model(self._put_batch(hb))
                keep = np.asarray(hb["_weights"]) > 0 if "_weights" in hb else slice(None)
                for t in self.task_names:
                    outs[t].append(torch.sigmoid(logits[t]).cpu().numpy()[keep])
                for k in collect:
                    extras[k].append(np.asarray(hb[k])[keep])
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
        checkpointer = _Checkpointer(cfg.model_dir)
        checkpointer.restore_latest(self)
        summary = SummaryWriter(os.path.join(cfg.model_dir, "summaries"))

        # preemption notice (SIGTERM): finish the step in flight, save, skip
        # the final eval.  Installs only in the main thread; restored on return.
        preempted = {"flag": False}
        try:
            prev_handler = signal.signal(
                signal.SIGTERM, lambda signum, frame: preempted.update(flag=True))
        except ValueError:  # not the main thread
            prev_handler = None

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
                    rate = ((step - last_log_step) * len(hb["labels"])
                            / max(time.time() - t0, 1e-9))
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
                due_time = (cfg.eval_throttle_secs
                            and time.time() - last_eval_time >= cfg.eval_throttle_secs)
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


class _Checkpointer:
    """``torch.save`` checkpoints (the last CHECKPOINTS_KEPT kept) and the
    best-AUC exporter."""

    def __init__(self, model_dir: str):
        self.model_dir = os.path.abspath(model_dir)
        self.dir = os.path.join(self.model_dir, "checkpoints")
        os.makedirs(self.dir, exist_ok=True)

    @staticmethod
    def steps(ckpt_dir: str) -> list[int]:
        if not os.path.isdir(ckpt_dir):
            return []
        return sorted(int(f[5:-3]) for f in os.listdir(ckpt_dir)
                      if f.startswith("ckpt_") and f.endswith(".pt"))

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step}.pt")

    def save(self, trainer: Trainer) -> None:
        path = self._path(trainer.step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"model": trainer.model.state_dict(),
                    "optimizer": trainer.optimizer.state_dict(),
                    "step": trainer.step,
                    "generator": trainer.generator.get_state(),
                    "mini_step": trainer.mini_step,
                    "accum": trainer.accum}, tmp)
        os.replace(tmp, path)  # atomic: a reader never sees half a checkpoint
        for old in self.steps(self.dir)[:-CHECKPOINTS_KEPT]:
            os.remove(self._path(old))

    def restore_latest(self, trainer: Trainer) -> None:
        steps = self.steps(self.dir)
        if not steps:
            return
        ck = torch.load(self._path(steps[-1]), map_location="cpu", weights_only=True)
        trainer.model.load_state_dict(ck["model"])
        trainer.optimizer.load_state_dict(ck["optimizer"])
        trainer.step = int(ck["step"])
        trainer.generator.set_state(ck["generator"])
        accum = ck.get("accum", [])
        if len(accum) != len(trainer.accum):
            raise ValueError(f"checkpoint {steps[-1]} was written with another "
                             "grad_accum_steps than this run's")
        trainer.mini_step = int(ck.get("mini_step", 0))
        for acc, saved in zip(trainer.accum, accum):
            acc.copy_(saved)

    def maybe_export_best(self, trainer: Trainer, auc: float) -> None:
        """Keep the BEST_EXPORTS_KEPT highest-AUC exports (BestExporter parity)."""
        best = convert.read_best(self.model_dir)
        if len(best) >= BEST_EXPORTS_KEPT and auc <= min(a for a, _ in best):
            return
        convert.save_export(self.model_dir, trainer.step, auc, trainer.model,
                            keep=BEST_EXPORTS_KEPT)
