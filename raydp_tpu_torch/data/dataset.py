"""Datasets the feed and the estimator read: Arrow blocks in the object
store, or Arrow tables held in this process.

- :class:`DistributedDataset` — the port's copy of the store half of
  :mod:`raydp_tpu.data.dataset`: an immutable list of Arrow blocks in the
  object store (written by ``put_arrow`` / ``put_arrow_many`` from any
  session process), read with ``get_block(zero_copy=True)``, shuffled
  (``random_shuffle``), planned into shards (``split_shards``), passed to
  another process (``portable`` / ``from_portable``) and released. The
  frame conversions (``from_frame``, ``from_frame_recoverable``,
  ``to_frame``) and ``random_shuffle``'s distributed path come with the ETL
  engine; without a session the dataset shuffles locally.
- :class:`TableDataset` — the same read interface (``schema``,
  ``num_blocks``, ``count``, ``block_sizes``, ``get_block``, ``blocks``,
  ``to_arrow``) over ``pa.Table`` blocks in memory, with no runtime. The
  unit tests of the feed and the estimator use it.

Reference parity map (python/raydp/spark/dataset.py): :func:`release` is
``release_spark_recoverable`` (dataset.py:224-237); ownership transfer is
``get_raydp_master_owner`` (dataset.py:137-158).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.runtime.object_store import ObjectRef, get_client
from raydp_tpu_torch.utils import divide_blocks

logger = get_logger("data.dataset")


@dataclass
class BlockMeta:
    num_rows: int
    # exactly one of `ref` / fetch recipe is the access path
    ref: Optional[ObjectRef] = None
    cache_key: Optional[str] = None
    executor: Optional[str] = None
    recover: Optional[bytes] = None  # cloudpickled lineage Task


class DistributedDataset:
    """An immutable list of Arrow blocks resolvable from any session process."""

    def __init__(self, blocks: List[BlockMeta], schema: pa.Schema,
                 owner: Optional[str] = None,
                 frame_id: Optional[str] = None, session=None):
        self._blocks = blocks
        self._schema = schema
        self._owner = owner
        self._frame_id = frame_id   # set for recoverable datasets
        self._session = session

    # ---- basic accessors ----------------------------------------------------
    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def num_blocks(self) -> int:
        return len(self._blocks)

    def count(self) -> int:
        return sum(b.num_rows for b in self._blocks)

    def block_sizes(self) -> List[int]:
        return [b.num_rows for b in self._blocks]

    # ---- block access (the hot fetch path, dataset.py:54-84) ----------------
    def get_block_ref(self, i: int, max_retries: int = 8) -> ObjectRef:
        """Resolve block ``i`` to an object-store ref, fetching/recovering as
        needed. Retries route around restarting executors (``max_retries=-1``
        spirit, dataset.py:54 — bounded here to fail eventually)."""
        meta = self._blocks[i]
        if meta.ref is not None:
            return meta.ref
        assert meta.cache_key is not None and self._session is not None
        last_err: Optional[Exception] = None
        for attempt in range(max_retries):
            try:
                executor = self._resolve_executor(meta, attempt)
                out = executor.get_block(meta.cache_key, meta.recover,
                                         self._owner)
                meta.ref = out["ref"]
                if meta.num_rows < 0:
                    meta.num_rows = out["num_rows"]
                return meta.ref
            except Exception as e:  # noqa: BLE001 - retry any transport failure
                last_err = e
                import time
                time.sleep(0.5)
        raise RuntimeError(
            f"could not fetch block {i} ({meta.cache_key})") from last_err

    def _resolve_executor(self, meta: BlockMeta, attempt: int = 0):
        from raydp_tpu_torch.runtime import get_runtime
        rt = get_runtime()
        handle = rt.get_actor(meta.executor) if meta.executor else None
        if handle is None:
            # executor gone for good: fan recovery out across live executors
            # (hash spread + attempt rotation) instead of serializing all
            # recovery through one actor (the reference schedules fetch tasks
            # anywhere, dataset.py:203-220)
            if self._session is not None and self._session.executors:
                import zlib
                pool = self._session.executors
                # crc32, not hash(): str hashes are per-process randomized,
                # and every reader process should converge on the same
                # executor per block so a lost block is recovered once
                idx = (zlib.crc32(meta.cache_key.encode()) + attempt) % len(pool)
                handle = pool[idx]
            else:
                raise RuntimeError(f"no executor to serve block {meta.cache_key}")
        return handle

    def get_block(self, i: int, zero_copy: bool = False) -> pa.Table:
        """Fetch block ``i``. ``zero_copy=True`` decodes in place over shared
        memory — valid only while the dataset is not released; the device feed
        uses it because each batch is consumed (device_put) before the next
        fetch."""
        return get_client().get(self.get_block_ref(i), zero_copy=zero_copy)

    def blocks(self) -> List[pa.Table]:
        return [self.get_block(i) for i in range(self.num_blocks())]

    def to_arrow(self) -> pa.Table:
        if not self._blocks:
            return self._schema.empty_table()
        return pa.concat_tables(self.blocks(), promote_options="permissive")

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def take(self, n: int) -> List[dict]:
        out: List[dict] = []
        for i in range(self.num_blocks()):
            out.extend(self.get_block(i).slice(0, n - len(out)).to_pylist())
            if len(out) >= n:
                break
        return out

    # ---- transforms ---------------------------------------------------------
    def random_shuffle(self, seed: Optional[int] = None) -> "DistributedDataset":
        """Uniform random shuffle across ALL rows (the reference's estimators
        call ``ds.random_shuffle()`` before training, torch/estimator.py:335-338,
        where ray.data shuffles executor-side).

        With a live session this runs as distributed shuffle tasks on the
        executors (map: random bucketing; reduce: in-partition permutation) —
        the driver moves only refs, never rows. Without a session (e.g. a
        dataset rebuilt from :meth:`portable` inside an SPMD rank) it falls
        back to a local two-level shuffle.
        """
        if self._session is not None and self.num_blocks() > 0:
            refs = [self.get_block_ref(i) for i in range(self.num_blocks())]
            schema_bytes = self._schema.serialize().to_pybytes()
            new_refs, rows = self._session.engine.random_shuffle_refs(
                refs, schema_bytes, seed, owner=self._owner)
            blocks = [BlockMeta(num_rows=n, ref=r)
                      for r, n in zip(new_refs, rows)]
            return DistributedDataset(blocks, self._schema, self._owner,
                                      session=self._session)
        rng = np.random.RandomState(seed if seed is not None else 0)
        order = rng.permutation(self.num_blocks())
        client = get_client()
        new_blocks: List[BlockMeta] = []
        for i in order:
            table = self.get_block(int(i))
            perm = rng.permutation(table.num_rows)
            shuffled = table.take(pa.array(perm))
            ref = client.put_arrow(shuffled, owner=self._owner)
            new_blocks.append(BlockMeta(num_rows=shuffled.num_rows, ref=ref))
        return DistributedDataset(new_blocks, self._schema, self._owner,
                                  session=self._session)

    def split_shards(self, world_size: int, shuffle: bool = False,
                     seed: Optional[int] = None
                     ) -> List[List[Tuple[int, int, int]]]:
        """Balanced shard plan: per rank, ``(block_index, offset, length)`` with
        equal per-rank sample counts (the ``divide_blocks`` kernel,
        utils.py:149-222 — offsets here since a rank may take part of a block).

        With MORE ranks than blocks — where ``divide_blocks`` has no whole
        block per rank and the reference repartitions first
        (test_torch_sequential.py:23-54) — the plan falls back to contiguous
        row ranges: rank ``r`` reads rows ``[r·per, (r+1)·per)`` of the
        concatenated dataset, wrapping past the end so every rank still gets
        exactly ``ceil(total/world)`` samples (the SPMD no-short-rank rule).
        """
        sizes = self.block_sizes()
        if world_size > len(sizes):
            total = sum(sizes)
            if total == 0:
                return [[] for _ in range(world_size)]
            per = -(-total // world_size)
            starts = np.cumsum([0] + list(sizes))
            # shuffle here is coarse, like divide_blocks' block shuffle: a
            # seeded rotation of the global row space plus a permutation of
            # the rank→slice mapping, so ranks draw different data each epoch
            # (per-row shuffling belongs to the feed's in-batch shuffle)
            rotation = 0
            order = np.arange(world_size)
            if shuffle:
                rng = np.random.RandomState(seed if seed is not None else 0)
                rotation = int(rng.randint(total))
                order = rng.permutation(world_size)

            def runs(start: int, stop: int) -> List[Tuple[int, int, int]]:
                out: List[Tuple[int, int, int]] = []
                row = start
                while row < stop:
                    r = row % total
                    b = int(np.searchsorted(starts, r, side="right")) - 1
                    take = int(min(stop - row, starts[b + 1] - r))
                    out.append((b, r - int(starts[b]), take))
                    row += take
                return out

            return [runs(int(order[r]) * per + rotation,
                         (int(order[r]) + 1) * per + rotation)
                    for r in range(world_size)]
        assignment = divide_blocks(sizes, world_size,
                                   shuffle=shuffle, shuffle_seed=seed)
        plans: List[List[Tuple[int, int, int]]] = []
        for rank in range(world_size):
            taken: Dict[int, int] = {}
            plan: List[Tuple[int, int, int]] = []
            for block_idx, n in assignment[rank]:
                off = taken.get(block_idx, 0)
                size = self._blocks[block_idx].num_rows
                if off >= size:
                    off = 0  # duplicated block (wraparound): restart from the top
                take = min(n, size - off)
                plan.append((block_idx, off, take))
                taken[block_idx] = off + take
                if take < n:
                    plan.append((block_idx, 0, n - take))
                    taken[block_idx] = n - take
            plans.append(plan)
        return plans

    # ---- portability --------------------------------------------------------
    def portable(self) -> Dict:
        """A picklable descriptor another session process (e.g. an SPMD rank)
        can rebuild this dataset from. Forces every block into the object
        store first, so readers need only a store client — no session, no
        executors (parity: the holder-actor handoff, dataset.py:239-313)."""
        refs = [self.get_block_ref(i) for i in range(self.num_blocks())]
        return {
            "refs": refs,
            "rows": self.block_sizes(),
            "schema": self._schema.serialize().to_pybytes(),
        }

    @staticmethod
    def from_portable(payload: Dict) -> "DistributedDataset":
        """Rebuild from :meth:`portable` in a process with a live store client."""
        schema = pa.ipc.read_schema(pa.py_buffer(payload["schema"]))
        blocks = [BlockMeta(num_rows=n, ref=r)
                  for r, n in zip(payload["refs"], payload["rows"])]
        return DistributedDataset(blocks, schema)

    # ---- lifecycle ----------------------------------------------------------
    def release(self) -> None:
        """Drop recoverable blocks + fetched refs
        (parity: ``release_spark_recoverable``, dataset.py:224-237)."""
        if self._frame_id is not None and self._session is not None:
            self._session.release_cached(self._frame_id)
        refs = [b.ref for b in self._blocks if b.ref is not None]
        if refs:
            try:
                get_client().free(refs)
            except Exception:
                pass
        self._blocks = []

    def transfer_to_master(self) -> None:
        """Re-home fetched blocks to the master actor so they outlive executors
        and ``stop(cleanup_data=False)`` (parity: dataset.py:137-158)."""
        if self._session is None:
            return
        refs = [b.ref for b in self._blocks if b.ref is not None]
        if refs:
            get_client().transfer_ownership(refs, self._session.master_name)


def release(ds: DistributedDataset) -> None:
    ds.release()


class TableDataset:
    """An immutable list of Arrow blocks held in this process."""

    def __init__(self, blocks: Sequence[pa.Table],
                 schema: Optional[pa.Schema] = None):
        if schema is None:
            if not blocks:
                raise ValueError("an empty TableDataset needs a schema")
            schema = blocks[0].schema
        for i, block in enumerate(blocks):
            if not block.schema.equals(schema):
                raise ValueError(f"block {i} schema {block.schema} differs "
                                 f"from the dataset's {schema}")
        self._blocks = list(blocks)
        self._schema = schema

    @property
    def schema(self) -> pa.Schema:
        return self._schema

    def num_blocks(self) -> int:
        return len(self._blocks)

    def count(self) -> int:
        return sum(b.num_rows for b in self._blocks)

    def block_sizes(self) -> List[int]:
        return [b.num_rows for b in self._blocks]

    def get_block(self, i: int, zero_copy: bool = False) -> pa.Table:
        """Block ``i``. The tables are already in this process, so
        ``zero_copy`` (which the store-backed dataset honours) changes
        nothing: every call returns the same immutable table."""
        return self._blocks[i]

    def blocks(self) -> List[pa.Table]:
        return [self.get_block(i) for i in range(self.num_blocks())]

    def to_arrow(self) -> pa.Table:
        if not self._blocks:
            return self._schema.empty_table()
        return pa.concat_tables(self.blocks(), promote_options="permissive")
