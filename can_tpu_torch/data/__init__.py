"""Host-side data helpers the serving path needs: ImageNet normalisation,
shape buckets and padded batch assembly (counterparts of
``can_tpu/data/dataset.py`` and ``can_tpu/data/batching.py``)."""

from can_tpu_torch.data.batching import Batch, pad_batch, snap_to_bucket
from can_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD, normalize_host

__all__ = ["Batch", "pad_batch", "snap_to_bucket", "IMAGENET_MEAN",
           "IMAGENET_STD", "normalize_host"]
