"""Model zoo: importing this package populates the registry (DIN and BST so far).

Use ``recalgorithm_tpu_torch.models.get_model(name)`` for
(config_cls, model_cls).
"""

from recalgorithm_tpu_torch.models.common import MODEL_REGISTRY, get_model, register_model

from recalgorithm_tpu_torch.models import bst, din  # noqa: F401  (register BST, DIN)

__all__ = ["MODEL_REGISTRY", "get_model", "register_model"]
