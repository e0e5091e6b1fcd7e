"""Model zoo: importing this package populates the registry with the 27 names
of the JAX package's: DIN, DIEN, BST, AutoInt (AutoInt+ with
``use_deep_tower``), PNN, xDeepFM, FiBiNET, DeepCrossing, DCN, DCNv2, GDCN,
GenericDNN, DeepFM, FFM, FwFM, AFM, NFM, DLRM, FinalMLP, MaskNet,
WideAndDeep (also registered as WideAndDeepBuiltin), the multi-task MMOE,
PLE, ESMM and SharedBottom, and the retrieval model TwoTower.

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
    dien,
    din,
    dlrm,
    esmm,
    ffm,
    fibinet,
    final_mlp,
    fwfm,
    gdcn,
    generic_dnn,
    masknet,
    mmoe,
    nfm,
    ple,
    pnn,
    shared_bottom,
    two_tower,
    wide_and_deep,
    xdeepfm,
)

__all__ = ["MODEL_REGISTRY", "get_model", "register_model"]
