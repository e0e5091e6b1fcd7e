"""Model zoo: importing this package populates the registry with the models
ported so far: DIN, BST, AutoInt (AutoInt+ with ``use_deep_tower``), PNN,
xDeepFM, FiBiNET, DeepCrossing, DCN, DCNv2, GDCN, GenericDNN, DeepFM, FFM,
FwFM, AFM, NFM, DLRM, FinalMLP, MaskNet and WideAndDeep (also registered as
WideAndDeepBuiltin).

Use ``recalgorithm_tpu_torch.models.get_model(name)`` for
(config_cls, model_cls).
"""

from recalgorithm_tpu_torch.models.common import MODEL_REGISTRY, get_model, register_model

from recalgorithm_tpu_torch.models import (  # noqa: F401  (register the models)
    afm,
    autoint,
    bst,
    dcn,
    dcn_v2,
    deep_crossing,
    deepfm,
    din,
    dlrm,
    ffm,
    fibinet,
    final_mlp,
    fwfm,
    gdcn,
    generic_dnn,
    masknet,
    nfm,
    pnn,
    wide_and_deep,
    xdeepfm,
)

__all__ = ["MODEL_REGISTRY", "get_model", "register_model"]
