"""Framework bridges: a :class:`DistributedDataset` as a torch / tf.data feed
— the port's copy of :mod:`raydp_tpu.data.bridges`.

Parity surface for reference users who train OUTSIDE the built-in estimators:
the reference hands its dataset to torch as an ``IterableDataset`` + prefetching
DataLoader (torch/torch_ml_dataset.py:30-110) and to TF via ``dataset.to_tf``
feeding ``model.fit`` (tf/estimator.py:179-199). Here both bridges sit on the
same host feed the estimators use (:class:`~raydp_tpu_torch.data.feed.HostBatchIterator`
— decoded-block caching, within-block shuffling, balanced shard plans), so a
user migrating an external torch/TF training loop keeps the data-plane
semantics of the native path.

These bridges are HOST-side by design: they exist for foreign training loops,
and compute nothing on a device (the user's loop moves each batch to the
card itself). Training on the card through the port should use the
estimators (or :class:`DeviceFeed` / :class:`DeviceEpochCache`), which place
batches themselves.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from raydp_tpu_torch.data.feed import HostBatchIterator, ShardSpec, epoch_seed

__all__ = ["to_torch_dataset", "to_tf_dataset"]


def _columns_spec(feature_columns: Sequence[str], label_column: Optional[str],
                  feature_dtype, label_dtype):
    spec = {"features": (list(feature_columns), feature_dtype)}
    if label_column is not None:
        spec["label"] = (label_column, label_dtype)
    return spec


def _shard(ds, world_size: int, rank: int, shuffle: bool, seed: int):
    if world_size <= 1:
        return None
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    plans = ds.split_shards(world_size, shuffle=shuffle, seed=seed)
    return ShardSpec(parts=plans[rank])


def to_torch_dataset(ds, feature_columns: Sequence[str],
                     label_column: Optional[str] = None,
                     batch_size: int = 64,
                     shuffle: bool = False,
                     seed: int = 0,
                     feature_dtype=np.float32,
                     label_dtype=np.float32,
                     drop_last: bool = False,
                     world_size: int = 1,
                     rank: int = 0):
    """The dataset as a ``torch.utils.data.IterableDataset`` of already-batched
    ``(features, label)`` CPU tensor pairs (``features`` alone without a
    ``label_column``).

    Mirrors the reference's ``TorchMLDataset`` contract
    (torch/torch_ml_dataset.py:30-67): iterable, optional shuffling, sized via
    ``len()``. Batches are cut here (pass the result to a ``DataLoader`` with
    ``batch_size=None``), so the balanced shard plan and decoded-block cache
    of the native feed apply unchanged; ``world_size``/``rank`` select one
    balanced shard for DDP-style consumers (``divide_blocks`` parity,
    reference utils.py:149-222).

    Determinism note: with multi-worker loaders the per-epoch shuffle signal
    is derived from torch's worker seeding convention (``info.seed -
    info.id`` = the loader's per-epoch base seed), so the shuffle order is
    reproducible across runs only when the ``DataLoader``'s ``generator`` is
    explicitly seeded; workers always AGREE within a run either way (the
    stripe split needs all workers on one order). A custom ``worker_init_fn``
    that reseeds torch does not break agreement, only cross-run
    reproducibility. The native ``DeviceFeed.set_epoch`` path has no such
    dependence.
    """
    import torch
    from torch.utils.data import IterableDataset

    shard = _shard(ds, world_size, rank, shuffle, seed)
    columns = _columns_spec(feature_columns, label_column,
                            feature_dtype, label_dtype)
    rows = shard.num_rows() if shard is not None \
        else sum(ds.block_sizes())
    n_batches = rows // batch_size if drop_last \
        else -(-rows // batch_size)

    class _TorchBridge(IterableDataset):
        def __init__(self):
            super().__init__()
            self._epoch = 0

        def __iter__(self):
            from torch.utils.data import get_worker_info
            info = get_worker_info()
            # per-epoch reseed — the external-loop analogue of
            # DeviceFeed.set_epoch; without it every epoch replays
            # byte-identical batch order. The epoch signal must vary per
            # epoch and be IDENTICAL across loader workers (the stripe split
            # below needs all workers walking one order). Two worker modes:
            # fresh forks per epoch (counter resets, but the DataLoader's
            # per-epoch base seed info.seed - info.id varies) and
            # persistent_workers (base seed fixed, but this dataset copy
            # lives on and its counter advances) — the SUM covers both.
            epoch_sig, self._epoch = self._epoch, self._epoch + 1
            if info is not None:
                epoch_sig += int(info.seed) - int(info.id)
            it_seed = epoch_seed(seed, epoch_sig) if shuffle else seed
            it = HostBatchIterator(
                ds, batch_size, columns, shard=shard, shuffle=shuffle,
                seed=it_seed, drop_remainder=drop_last)

            def _tensor(a):
                # the host feed serves read-only views of its frozen decode
                # cache; from_numpy would share that memory and let an
                # in-place consumer mutation (feats.sub_(...)) silently
                # poison later epochs — copy unless already writeable-owned
                a = np.ascontiguousarray(a)
                if not a.flags.writeable:
                    a = a.copy()
                return torch.from_numpy(a)

            # every worker walks the SAME order and takes every N-th batch
            # (a stripe split): without it each of N workers would yield the
            # whole dataset, N× data per epoch
            for i, batch in enumerate(it):
                if info is not None and i % info.num_workers != info.id:
                    continue
                feats = _tensor(batch["features"])
                if label_column is None:
                    yield feats
                else:
                    yield feats, _tensor(batch["label"])

        def __len__(self):
            return n_batches

    return _TorchBridge()


def to_tf_dataset(ds, feature_columns: Sequence[str],
                  label_column: Optional[str] = None,
                  batch_size: int = 64,
                  shuffle: bool = False,
                  seed: int = 0,
                  feature_dtype=np.float32,
                  label_dtype=np.float32,
                  drop_last: bool = False,
                  world_size: int = 1,
                  rank: int = 0):
    """The dataset as a batched ``tf.data.Dataset`` of ``(features, label)``
    (``features`` alone without a ``label_column``) — what the reference's
    TF path feeds ``model.fit`` (tf/estimator.py:179-199).

    Built with ``from_generator`` over the native host feed; the last batch is
    ragged unless ``drop_last`` (declared via a ``None`` leading dim in the
    output signature).
    """
    import tensorflow as tf

    shard = _shard(ds, world_size, rank, shuffle, seed)
    columns = _columns_spec(feature_columns, label_column,
                            feature_dtype, label_dtype)
    n_features = len(feature_columns)
    f_spec = tf.TensorSpec(shape=(None, n_features) if n_features > 1
                           else (None,), dtype=tf.as_dtype(np.dtype(
                               feature_dtype)))
    if label_column is None:
        signature = f_spec
    else:
        signature = (f_spec, tf.TensorSpec(
            shape=(None,), dtype=tf.as_dtype(np.dtype(label_dtype))))

    epoch_box = [0]

    def _gen():
        # from_generator re-invokes this per epoch (model.fit / .repeat()):
        # vary the shuffle seed each time, like DeviceFeed.set_epoch
        epoch, epoch_box[0] = epoch_box[0], epoch_box[0] + 1
        it_seed = epoch_seed(seed, epoch) if shuffle else seed
        it = HostBatchIterator(ds, batch_size, columns, shard=shard,
                               shuffle=shuffle, seed=it_seed,
                               drop_remainder=drop_last)
        for batch in it:
            if label_column is None:
                yield batch["features"]
            else:
                yield batch["features"], batch["label"]

    return tf.data.Dataset.from_generator(_gen, output_signature=signature)
