"""Drivers of the cells, one module a kind (``train``, ``serve``), and what
they share: building the program's model from a configuration file.

The program is imported here and in the drivers only; the reference and the
traffic generators import nothing of it.
"""

from __future__ import annotations

import importlib


def kind(name: str):
    """The driver module of a cell kind."""
    return importlib.import_module(f"portbench.kinds.{name}")


def program_model(cfg: dict, weights: dict | None, device):
    """The program's model of ``cfg`` on ``device``, holding ``weights``
    (every leaf: a missing or extra name raises; None keeps the model's own
    initial values, for a caller that loads weights itself)."""
    import torch

    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import get_model

    config_cls, model_cls = get_model(cfg["model"])
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["config"].items()}
    mcfg = config_cls(**fields, precision=cfg["precision"], batch_size=cfg["batch_size"])
    schema = wechat_schema(cfg["schema"]["vocab_sizes"])
    with torch.device(device):
        model = model_cls(mcfg, schema)
    if weights is not None:
        model.load_state_dict(weights)
    return model, mcfg
