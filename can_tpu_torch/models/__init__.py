"""CANNet for PyTorch (counterpart of ``can_tpu/models``)."""

from can_tpu_torch.models.cannet import (
    BACKEND_CFG,
    CONTEXT_SCALES,
    FEAT_CH,
    FRONTEND_CFG,
    CANNet,
    context_block,
    load_vgg16_frontend,
    random_state_dict,
    reference_param_shapes,
)

__all__ = ["BACKEND_CFG", "CONTEXT_SCALES", "FEAT_CH", "FRONTEND_CFG",
           "CANNet", "context_block", "load_vgg16_frontend", "random_state_dict",
           "reference_param_shapes"]
