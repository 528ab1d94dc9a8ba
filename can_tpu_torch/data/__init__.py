"""Host-side data: images (``imageio``: PNG without PIL, the bilinear
resize), the crowd dataset and its normalisation, shape buckets, padded
batches and the training batcher, density maps and synthetic data
(counterparts of ``can_tpu/data``)."""

from can_tpu_torch.data.batching import Batch, ShardedBatcher, pad_batch, snap_to_bucket
from can_tpu_torch.data.dataset import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    CrowdDataset,
    normalize_host,
)
from can_tpu_torch.data.density import gaussian_density_map
from can_tpu_torch.data.synthetic import make_synthetic_dataset

__all__ = ["Batch", "ShardedBatcher", "pad_batch", "snap_to_bucket",
           "IMAGENET_MEAN", "IMAGENET_STD", "CrowdDataset", "normalize_host",
           "gaussian_density_map", "make_synthetic_dataset"]
