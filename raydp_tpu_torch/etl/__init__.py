"""raydp_tpu_torch.etl — the Arrow-native distributed DataFrame engine.

This is the build's answer to the reference's embedded Spark: the reference runs
stock Spark with its executors hosted in Ray actors (SURVEY.md §1 L2;
RayAppMaster.scala, RayDPExecutor.scala); we provide a from-scratch, Arrow-native
engine with the DataFrame surface the reference's examples actually use
(select/filter/withColumn/groupBy-agg/join/randomSplit/read.csv/parquet — see
examples/data_process.py, examples/pytorch_nyctaxi.py). Partitions are Arrow
tables; compute is ``pyarrow.compute`` on executor actors; wide operators hash-
shuffle through the shared-memory object store; cached frames are recoverable via
lineage (the ``prepareRecoverableRDD`` dance, ObjectStoreWriter.scala:164-204).
"""

from raydp_tpu_torch.etl.expressions import col, lit, when
from raydp_tpu_torch.etl.frame import DataFrame
from raydp_tpu_torch.etl.session import Session
from raydp_tpu_torch.etl import functions

__all__ = ["col", "lit", "when", "DataFrame", "Session", "functions"]
