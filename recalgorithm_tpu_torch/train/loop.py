"""Training loop: the counterpart of ``recalgorithm_tpu/train/loop.py``.

Responsibilities (the reference's Estimator usage, wide_and_deep.py:331-376):

  * the train step — loss = sum of per-task mean sigmoid CE (mmoe.py:261-263),
    each task scaled by the model config's ``task_loss_weights``, plus the
    regularisation terms the model returns beside its logits; BatchNorm
    running statistics update in train mode (UPDATE_OPS parity); Adam;
  * streaming train metrics (loss / accuracy / logloss / calibration /
    200-bin AUC) on the device, logged every ``log_every`` steps;
  * eval every ``eval_every_steps`` steps or ``eval_throttle_secs`` seconds,
    and a final eval;
  * checkpoints (``torch.save``: model, optimizer, step, dropout generator)
    every ``save_checkpoints_steps``, the last 3 kept, resume from the
    latest; a best-exporter keyed on the first task's eval AUC that keeps
    the BEST_EXPORTS_KEPT best exports (BestExporter(exports_to_keep=5) parity);
  * SIGTERM: finish the step in flight, checkpoint, return without the final
    eval.

Not ported yet: the mesh (multi-device), the compact gradient scatter (its
torch counterpart, the gather's backward, is exact at every density), the
TPU compiler options, ``rng_impl`` and ``grad_accum_steps``.

Data contract: iterables of host batches (dict[str, np.ndarray]) with fixed
shapes; an optional ``"_weights"`` (B,) 0/1 mask marks real rows in padded
eval tails.  The model is built (and initialised) by the caller; the trainer
moves it to its device.
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


class Trainer:
    def __init__(self, model: torch.nn.Module, task_names: tuple[str, ...],
                 optimizer: Callable, config: TrainerConfig,
                 device: str | torch.device | None = None):
        """``optimizer`` is a factory of the parameters (``optimizers.build``);
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

    def _fresh_metrics(self) -> MetricsState:
        return MetricsState(M.ScalarMeanState.init(self.device),
                            {t: TaskMetrics.init(self.device) for t in self.task_names})

    # -- steps ---------------------------------------------------------------

    def _put_batch(self, batch: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def _task_label(self, batch, task: str) -> torch.Tensor:
        label_idx = {name: i for i, name in enumerate(self.model.schema.labels)}
        if task not in label_idx:
            raise KeyError(f"task {task!r} has no label column")
        return batch["labels"][:, label_idx[task]]

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
        self.optimizer.step()
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

    def predict(self, batches: Iterable[Mapping[str, np.ndarray]]) -> dict[str, np.ndarray]:
        """Probabilities per task, concatenated over batches; rows with
        ``_weights == 0`` (padded tails) dropped."""
        outs: dict[str, list[np.ndarray]] = {t: [] for t in self.task_names}
        self.model.eval()
        with torch.no_grad():
            for hb in batches:
                logits, _ = self.model(self._put_batch(hb))
                keep = np.asarray(hb["_weights"]) > 0 if "_weights" in hb else slice(None)
                for t in self.task_names:
                    outs[t].append(torch.sigmoid(logits[t]).cpu().numpy()[keep])
        return {t: np.concatenate(v) if v else np.empty((0,), np.float32)
                for t, v in outs.items()}

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
                    "generator": trainer.generator.get_state()}, tmp)
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

    def maybe_export_best(self, trainer: Trainer, auc: float) -> None:
        """Keep the BEST_EXPORTS_KEPT highest-AUC exports (BestExporter parity)."""
        best = convert.read_best(self.model_dir)
        if len(best) >= BEST_EXPORTS_KEPT and auc <= min(a for a, _ in best):
            return
        convert.save_export(self.model_dir, trainer.step, auc, trainer.model,
                            keep=BEST_EXPORTS_KEPT)
