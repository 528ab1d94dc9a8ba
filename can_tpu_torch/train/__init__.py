"""Loss/count reductions and the on-device u8 normaliser (the parts of
``can_tpu/train`` the serving path uses)."""

from can_tpu_torch.train.loss import density_counts, masked_mse_sum
from can_tpu_torch.train.steps import normalize_on_device

__all__ = ["density_counts", "masked_mse_sum", "normalize_on_device"]
