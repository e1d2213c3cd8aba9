"""raydp_tpu_torch.data — datasets and the feed to the device.

- :mod:`dataset` — :class:`TableDataset`, the read interface of the
  reference's ``DistributedDataset`` over in-process Arrow blocks;
- :mod:`feed` — host batches (byte-identical to the reference's), the
  streaming :class:`DeviceFeed` and the resident :class:`DeviceEpochCache`.
"""

from raydp_tpu_torch.data.dataset import TableDataset
from raydp_tpu_torch.data.feed import (
    MASK_KEY, DeviceEpochCache, DeviceFeed, DevicePrefetcher,
    HostBatchIterator, PipelineTimings, ShardSpec, epoch_seed, pad_batch,
)

__all__ = ["MASK_KEY", "DeviceEpochCache", "DeviceFeed", "DevicePrefetcher",
           "HostBatchIterator", "PipelineTimings", "ShardSpec",
           "TableDataset", "epoch_seed", "pad_batch"]
