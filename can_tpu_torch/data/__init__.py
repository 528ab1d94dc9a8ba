"""Host-side data: images (``imageio``: PNG without PIL, the bilinear
resize), the crowd dataset and its normalisation, the prepared density
store and item cache, shape buckets, the batch planner, padded batches,
the training batcher, device prefetch, density maps and synthetic data
(counterparts of ``can_tpu/data``)."""

from can_tpu_torch.data.batching import Batch, ShardedBatcher, pad_batch, snap_to_bucket
from can_tpu_torch.data.dataset import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    CrowdDataset,
    normalize_host,
)
from can_tpu_torch.data.density import gaussian_density_map, generate_density_maps
from can_tpu_torch.data.prefetch import PrefetchPutError, prefetch_to_device
from can_tpu_torch.data.prepared import ItemCache, PreparedStore, StaleStoreError, write_store
from can_tpu_torch.data.synthetic import make_synthetic_dataset

__all__ = ["Batch", "ShardedBatcher", "pad_batch", "snap_to_bucket",
           "IMAGENET_MEAN", "IMAGENET_STD", "CrowdDataset", "normalize_host",
           "gaussian_density_map", "generate_density_maps", "PrefetchPutError", "prefetch_to_device",
           "ItemCache", "PreparedStore", "StaleStoreError", "write_store",
           "make_synthetic_dataset"]
