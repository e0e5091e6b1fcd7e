"""Where the port runs, and how a host batch reaches it.

:func:`resolve_device` names the device; :func:`to_device` is the one put
of a host batch's columns (dicts of numpy arrays, or of the lists a JSON
request gives) onto it, for the trainer (its eager and its graph steps),
``parallel/multihost.global_batch``, the ``Predictor``, the artifact call
and the ``Retriever``.  Copies are pageable and synchronous.
"""

from __future__ import annotations

from typing import Collection, Mapping

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' (--device cpu) to run "
            "on the CPU")
    return dev


def host_tensor(column) -> torch.Tensor:
    """A column as a CPU tensor, with ``np.asarray``'s dtype: over the
    array's own memory, or over a host copy where torch cannot take that
    memory (a negative stride, or a read-only buffer, whose tensor torch
    does not support)."""
    a = np.asarray(column)
    if not a.flags.writeable or min(a.strides, default=0) < 0:
        a = np.array(a)
    return torch.from_numpy(a)


def to_device(batch: Mapping, device: str | torch.device,
              columns: Collection[str] | None = None,
              out: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
    """``batch``'s columns on ``device``: those ``columns`` names (all where
    None) as new tensors, or with ``out`` copied in place into its tensors
    (a step graph's static inputs), one a column of ``out``'s names."""
    if out is not None:
        for k, x in out.items():
            x.copy_(host_tensor(batch[k]))
        return out
    return {k: host_tensor(v).to(device) for k, v in batch.items()
            if columns is None or k in columns}
