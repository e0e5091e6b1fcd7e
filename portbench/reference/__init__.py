"""Plain PyTorch references of the benchmark's models.

Each reference is written from the configuration file alone (widths,
vocabularies, field lists), in float32 with TF32 off, with no kernel, cache or
batching, and imports nothing of the measured program.  It takes the
benchmark's weights (``portbench/weights.py``) by their state-dict names and
the benchmark's inputs, and works out the rest itself.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """Run the enclosed reference with float32 products (``tf32=False``, the
    reference) or TF32 products (``tf32=True``, the control: the nearest
    precision below the configuration's float32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
