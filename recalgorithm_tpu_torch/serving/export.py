"""Ahead-of-time serving export: a ``torch.export`` program (``.pt2``).

Counterpart of ``recalgorithm_tpu/serving/export.py``, which writes a
serialized StableHLO function.  The names ``export_stablehlo`` and
``load_exported`` are kept so that a reader finds the counterpart, but the
artifact here is a ``torch.export`` program saved by ``torch.export.save``,
not StableHLO: the no-grad ``sigmoid(logits)`` of an eval-mode copy of the
model at a fixed batch size, weights (f32, or int8 tables with
``quantize_embeddings``) included.  The hand kernels are inside it as the
ops ``recalgorithm_torch::din_attention`` and
``recalgorithm_torch::bst_mha_forward``, each one graph node that runs the
kernel on CUDA tensors and its plain twin on CPU tensors; serving an
artifact needs those op registrations and no model code.

Beside the artifact, ``<path>.manifest.json`` holds the JAX package's keys
(``model``, ``batch_size``, ``quantized_embeddings``, ``inputs``,
``outputs``, ``artifact_bytes``).  ``outputs`` is the model's resolved task
list, where the JAX package writes the raw ``config.task_names`` (``()``
for DeepFM and GenericDNN).
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

# the op registrations torch.export.load needs to resolve the kernel nodes
from recalgorithm_tpu_torch.ops.cuda import bst_attention as _bst_ops  # noqa: F401
from recalgorithm_tpu_torch.ops.cuda import din_attention as _din_ops  # noqa: F401
from recalgorithm_tpu_torch.utils.device import to_device


class _Serve(nn.Module):
    """ids -> per-task probabilities (the sigmoid of the eval logits)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        logits, _ = self.model(batch)
        return {task: torch.sigmoid(v) for task, v in logits.items()}


def _input_spec(schema, batch_size: int) -> dict[str, tuple[tuple[int, ...], np.dtype]]:
    """The served inputs: the schema's batch without labels, keys sorted (the
    order of the manifest and of every call)."""
    spec = schema.batch_spec(batch_size)
    spec.pop("labels", None)
    return dict(sorted(spec.items()))


def _served_copy(model: nn.Module, quantize_embeddings: bool = False) -> nn.Module:
    """An eval-mode copy of ``model`` on its device, built on the CPU from
    its config and weights; with ``quantize_embeddings`` its gather-path
    tables are int8 (``serving/quantize.py``) and their f32 parameters are
    gone before the copy reaches the device."""
    device = next(model.parameters()).device
    copy = type(model)(model.config, model.schema)
    copy.load_state_dict(model.state_dict())
    if quantize_embeddings:
        from recalgorithm_tpu_torch.serving.quantize import quantize_model

        quantize_model(copy)
    return copy.to(device).eval()


def export_stablehlo(
    model: nn.Module,
    schema,
    batch_size: int,
    out_path: str,
    quantize_embeddings: bool = False,
) -> torch.export.ExportedProgram:
    """Trace ``model`` (its weights, on its device) for ``batch_size`` rows
    and save the program to ``out_path`` with its manifest.  Returns the
    program."""
    served = _Serve(_served_copy(model, quantize_embeddings))
    device = next(served.parameters()).device
    spec = _input_spec(schema, batch_size)
    # a tensor of its own a column: the artifact saves its example inputs,
    # and torch.save refuses a card put's typed views of one buffer
    example = {k: v.clone() for k, v in to_device(
        {name: np.zeros(shape, dtype) for name, (shape, dtype) in spec.items()}, device).items()}
    with torch.no_grad():
        program = torch.export.export(served, (example,), strict=False)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)
    manifest = {
        "model": type(model).__name__,
        "batch_size": batch_size,
        "quantized_embeddings": quantize_embeddings,
        "inputs": {name: {"shape": list(shape), "dtype": str(dtype)}
                   for name, (shape, dtype) in spec.items()},
        "outputs": list(model.config.task_names or (schema.labels[0],)),
        "artifact_bytes": os.path.getsize(out_path),
    }
    with open(out_path + ".manifest.json", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return program


def load_exported(path: str, device: torch.device):
    """Load an artifact onto ``device`` (the whole program moved there, so its
    kernel nodes dispatch to the kernels on a card); returns a
    callable(batch of numpy arrays in the manifest's layout: its inputs
    alone) -> {task: probabilities on ``device``}, with the program as its
    ``.program``."""
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(torch.export.load(path), device)
    module = program.module()

    def call(batch: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
        with torch.no_grad():
            return module(to_device(batch, device))

    call.program = program
    return call
