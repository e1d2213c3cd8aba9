"""Continuous pipelines — the port's copy of :mod:`raydp_tpu.stream`:
streaming ingest → incremental shuffle epochs on the port's ETL engine →
windowed aggregation → online training (``TorchEstimator.partial_fit``).

    from raydp_tpu_torch import stream
    pipe = stream.read_stream(stream.FileTailSource("/landing")) \
               .transform(lambda df: df.filter(...)) \
               .window(size=4, keys=["k"], aggs={"v": ["sum", "mean"]})
    for epoch in pipe.epochs():
        ...
"""

from raydp_tpu_torch.stream.pipeline import (
    ContinuousPipeline,
    EpochResult,
    EpochStream,
    WindowResult,
    read_stream,
)
from raydp_tpu_torch.stream.sources import (
    FileTailSource,
    MicroBatch,
    ReplayLogSource,
    StreamError,
    StreamSource,
    SyntheticSource,
)

__all__ = [
    "ContinuousPipeline",
    "EpochResult",
    "EpochStream",
    "FileTailSource",
    "MicroBatch",
    "ReplayLogSource",
    "StreamError",
    "StreamSource",
    "SyntheticSource",
    "WindowResult",
    "read_stream",
]
