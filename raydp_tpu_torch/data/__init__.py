"""raydp_tpu_torch.data — datasets and the feed to the device.

- :mod:`dataset` — :class:`DistributedDataset`, Arrow blocks in the object
  store (the reference's dataset, copied), with the ETL frame conversions
  :func:`from_frame`, :func:`from_frame_recoverable` and :func:`to_frame`,
  and :class:`TableDataset`, the same read interface over in-process
  blocks;
- :mod:`feed` — host batches (byte-identical to the reference's), the
  streaming :class:`DeviceFeed` and the resident :class:`DeviceEpochCache`;
- :mod:`bridges` — :func:`to_torch_dataset` and :func:`to_tf_dataset`,
  host-side feeds for a training loop the user writes.
"""

from raydp_tpu_torch.data.bridges import to_tf_dataset, to_torch_dataset
from raydp_tpu_torch.data.dataset import (
    BlockMeta, DistributedDataset, TableDataset, from_frame,
    from_frame_recoverable, release, to_frame,
)
from raydp_tpu_torch.data.feed import (
    MASK_KEY, DeviceEpochCache, DeviceFeed, DevicePrefetcher,
    HostBatchIterator, PipelineTimings, ShardSpec, epoch_seed, pad_batch,
)

__all__ = ["MASK_KEY", "BlockMeta", "DeviceEpochCache", "DeviceFeed",
           "DevicePrefetcher", "DistributedDataset", "HostBatchIterator",
           "PipelineTimings", "ShardSpec", "TableDataset", "epoch_seed",
           "from_frame", "from_frame_recoverable", "pad_batch", "release",
           "to_frame", "to_tf_dataset", "to_torch_dataset"]
