"""raydp_tpu_torch.data — datasets and the feed to the device.

- :mod:`dataset` — :class:`DistributedDataset`, Arrow blocks in the object
  store (the reference's store-backed dataset, copied), and
  :class:`TableDataset`, the same read interface over in-process blocks;
- :mod:`feed` — host batches (byte-identical to the reference's), the
  streaming :class:`DeviceFeed` and the resident :class:`DeviceEpochCache`.
"""

from raydp_tpu_torch.data.dataset import (
    BlockMeta, DistributedDataset, TableDataset, release,
)
from raydp_tpu_torch.data.feed import (
    MASK_KEY, DeviceEpochCache, DeviceFeed, DevicePrefetcher,
    HostBatchIterator, PipelineTimings, ShardSpec, epoch_seed, pad_batch,
)

__all__ = ["MASK_KEY", "BlockMeta", "DeviceEpochCache", "DeviceFeed",
           "DevicePrefetcher", "DistributedDataset", "HostBatchIterator",
           "PipelineTimings", "ShardSpec", "TableDataset", "epoch_seed",
           "pad_batch", "release"]
