"""How a train step runs (:func:`engaged`), and the train step as one CUDA
graph, replayed: what ``Trainer.train_step`` keeps for it (``train/loop.py``).

A graph is keyed by the step's compaction choice and by the name, shape and
dtype of each of the model's columns (:func:`key`).  It owns one device
tensor a column (:attr:`StepGraph.inputs`), typed views of one flat buffer
(``utils/device.empty_batch``), which the put (``utils/device.to_device``
with ``out``) fills in place with one non-blocking copy from pinned staging
memory, on the trainer's current stream: the stream the replay runs on, so
stream order keeps the previous replay's reads of the inputs ahead of the
copy that overwrites them.  The first step of a key runs eagerly on the
trainer's side stream (the warm-up: it builds the optimizer's state and
every lazily made handle); the second captures forward, loss, backward,
optimizer update and metric update, then replays them; every later step
replays.

What a replay reads in place: the static inputs, the parameters, the
optimizer's state and its tensor rate (``train/optimizers.py``), the
streaming metric state (``train/metrics.py``), the dropout generator
(registered with the graph, so a replay draws the masks the eager step
would) and the tensors made inside the capture, which live in the graph's
own memory pool.  A load of optimizer state replaces the tensors the graph
reads (``Optimizer.version``): the trainer then drops its graphs and
captures again.

A replay calls no Python kernel wrapper: the hand kernels' ``.launches``
counters (``ops/cuda``) count eager calls and captures, not replays; what a
replay ran shows in a profiler's trace of the card.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import numpy as np
import torch

from recalgorithm_tpu_torch.utils.device import empty_batch

Key = tuple


class Paths(NamedTuple):
    """How a trainer's steps run (:func:`engaged`)."""

    replay: bool     # from a key's second step on, a captured CUDA graph replays
    row_grads: bool  # the tables take row gradients, and only touched rows update


def engaged(device: torch.device, mesh, grad_accum_steps: int, optimizer) -> Paths:
    """Both choices from one condition, no process mesh (its all-reduce
    wants dense gradients, and its gloo collectives cannot be captured) and
    no gradient accumulation (its running mean is dense, and its branch on
    the micro-step would need two graphs), and from what the device and the
    optimizer declare: steps replay on CUDA with an optimizer whose every
    update can be captured (``capturable``), and make row gradients with
    one whose every update applies them (``row_grads``; a dual optimizer's
    FTRL does not)."""
    alone = mesh is None and grad_accum_steps == 1
    return Paths(replay=alone and torch.device(device).type == "cuda"
                 and bool(optimizer.capturable),
                 row_grads=alone and bool(optimizer.row_grads))


def key(batch: Mapping[str, np.ndarray], compact: bool) -> Key:
    """The graph of a host batch (the model's columns only)."""
    return (compact, *sorted((k, np.shape(v), np.asarray(v).dtype.str)
                             for k, v in batch.items()))


@dataclasses.dataclass
class StepGraph:
    """One key's static inputs and, once captured, its graph."""

    inputs: dict[str, torch.Tensor]
    warm: bool = False                     # the eager warm-up step ran
    graph: torch.cuda.CUDAGraph | None = None
    loss: torch.Tensor | None = None       # the captured step's loss
    grads: list | None = None              # the parameters' captured gradients
    version: int = -1                      # the optimizer's, at the capture

    @classmethod
    def of(cls, batch: Mapping[str, np.ndarray], device) -> "StepGraph":
        """Static inputs shaped as ``batch``'s columns put on ``device``."""
        return cls(empty_batch(batch, device))

    def replay(self) -> torch.Tensor:
        """Runs the captured step; returns a copy of its loss, which the
        next replay does not overwrite."""
        self.graph.replay()
        return self.loss.clone()
