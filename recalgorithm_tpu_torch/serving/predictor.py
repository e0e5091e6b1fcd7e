"""Serving: load an exported model and run batch prediction.

Counterpart of ``recalgorithm_tpu/serving/predictor.py``: ``Predictor``
(with int8 tables under ``quantize``) serves an export
``export/best_<step>/`` as written by ``convert.save_export`` through the
model's code; ``HLOPredictor`` serves an artifact of ``serving/export.py``
with no model code.  The serving input is the framework's standard
translated batch (dict of numpy arrays), so the same artifact serves
offline scoring and the HTTP server.

Both run on ``cuda`` unless the caller asks for ``device="cpu"``; with no
card and no explicit CPU request they raise rather than carry on on the
CPU.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Mapping

import numpy as np
import torch
from torch import nn

from recalgorithm_tpu_torch.convert import load_export
from recalgorithm_tpu_torch.serving.export import load_exported
from recalgorithm_tpu_torch.utils.device import resolve_device, to_device
from recalgorithm_tpu_torch.utils.summary import span


class Predictor:
    """Loads an export into ``model`` and predicts per-task probabilities."""

    def __init__(self, model: nn.Module, export_dir: str,
                 device: str | torch.device | None = None, quantize: bool = False):
        """quantize: serve the gather-path embedding tables as per-row int8
        (``serving/quantize.py``); their f32 copies never reach the device."""
        self.device = resolve_device(device)
        model.load_state_dict(load_export(export_dir))
        self.qtables = None
        if quantize:
            from recalgorithm_tpu_torch.serving.quantize import quantize_model

            self.qtables = quantize_model(model)
        self.model = model.to(self.device).eval()
        metrics_path = os.path.join(export_dir, "metrics.json")
        self.export_metrics = {}
        if os.path.exists(metrics_path):
            with open(metrics_path) as f:
                self.export_metrics = json.load(f)

    @staticmethod
    def latest_best(model_dir: str) -> str:
        """Path of the highest-AUC export under ``model_dir`` (best_exports.json)."""
        best_path = os.path.join(model_dir, "best_exports.json")
        with open(best_path) as f:
            best = json.load(f)
        if not best:
            raise FileNotFoundError(f"no exports recorded in {best_path}")
        _, step = max(best)
        return os.path.join(model_dir, "export", f"best_{int(step)}")

    def predict_batch(self, batch: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Sigmoid of the eval logits, one (B,) array per task; the spans
        ``predict.put`` (the columns to the device) and ``predict.forward``
        (the forward and the copy back, which waits for the device)."""
        with torch.inference_mode():
            with span("predict.put"):
                tb = to_device(batch, self.device)
            with span("predict.forward"):
                logits, _ = self.model(tb)
                return {k: torch.sigmoid(v).cpu().numpy() for k, v in logits.items()}

    def predict(
        self, batches: Iterable[Mapping[str, np.ndarray]]
    ) -> dict[str, np.ndarray]:
        """Offline scoring over an iterator; padded tails (``_weights`` == 0)
        are dropped."""
        return _predict(self.predict_batch, batches)


def _predict(predict_batch, batches) -> dict[str, np.ndarray]:
    outs: dict[str, list[np.ndarray]] = {}
    for hb in batches:
        probs = predict_batch(hb)
        w = hb.get("_weights")
        for task, p in probs.items():
            if w is not None:
                p = p[np.asarray(w) > 0]
            outs.setdefault(task, []).append(p)
    return {t: np.concatenate(v) for t, v in outs.items()}


class HLOPredictor:
    """Serves an artifact of ``serving/export.py`` with NO model code.

    The artifact holds the weights (f32 or int8 tables) and the traced
    graph; this class coerces host batches to the manifest's input spec
    (pads the batch dimension to the baked size, slices the padding off the
    outputs) and runs the program, moved whole to ``device`` (default
    ``cuda``: the kernel nodes launch the hand kernels; no card raises).
    Same ``predict_batch(dict) -> dict`` surface as :class:`Predictor`, so a
    ``BatchingPredictor`` takes either.
    """

    def __init__(self, artifact_path: str, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self._call = load_exported(artifact_path, self.device)
        with open(artifact_path + ".manifest.json") as f:
            self.manifest = json.load(f)
        self.batch_size = int(self.manifest["batch_size"])
        self.inputs = self.manifest["inputs"]
        self.tasks = list(self.manifest["outputs"])

    @property
    def program(self) -> torch.export.ExportedProgram:
        """The loaded program, on ``device``."""
        return self._call.program

    def predict_batch(self, batch: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
        b = self.batch_size
        coerced = {}
        n = None
        for name, spec in self.inputs.items():
            if name not in batch:
                raise KeyError(f"missing input {name!r} (manifest spec)")
            arr = np.asarray(batch[name], dtype=spec["dtype"])
            n = arr.shape[0] if n is None else n
            if arr.shape[0] > b:
                raise ValueError(f"batch of {arr.shape[0]} rows exceeds the artifact's "
                                 f"baked batch size {b}")
            if arr.shape[0] < b:  # zero-pad the tail rows
                pad = np.zeros((b - arr.shape[0],) + arr.shape[1:], arr.dtype)
                arr = np.concatenate([arr, pad])
            coerced[name] = arr
        probs = self._call(coerced)
        return {t: p.cpu().numpy()[:n] for t, p in probs.items()}

    def predict(
        self, batches: Iterable[Mapping[str, np.ndarray]]
    ) -> dict[str, np.ndarray]:
        """Offline scoring over an iterator (:meth:`Predictor.predict`);
        padded tails (``_weights`` == 0) are dropped."""
        return _predict(self.predict_batch, batches)
