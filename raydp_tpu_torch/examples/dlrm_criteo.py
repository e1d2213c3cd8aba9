"""Criteo DLRM preprocessing — the port's copy of the data half of
``examples/dlrm_criteo.py``: the Criteo schema's constants, a synthetic
Criteo-format TSV (``generate_criteo``: 1 int label, 13 int dense features
with missing values, 26 categorical string columns with a skewed (zipf)
distribution) and the notebook's ``pre_process`` (frequency-limited
categorical dictionaries via distributed groupBy counts, log(x+1) on the
numerics), whose ``udf`` lambdas are cloudpickled to the ETL executors.
"""

from __future__ import annotations

import numpy as np

NUM_DENSE = 13
NUM_CAT = 26
LABEL = "_c0"
DENSE_COLS = [f"_c{i}" for i in range(1, NUM_DENSE + 1)]
CAT_COLS = [f"_c{i}" for i in range(NUM_DENSE + 1, NUM_DENSE + 1 + NUM_CAT)]


def generate_criteo(rows: int, path: str, seed: int = 0,
                    cat_cardinality: int = 1000) -> None:
    """Criteo-format TSV: label \\t 13 ints (w/ blanks) \\t 26 cat tokens."""
    rng = np.random.RandomState(seed)
    label = (rng.random_sample(rows) < 0.25).astype(np.int64)
    dense = rng.poisson(8, size=(rows, NUM_DENSE)).astype(object)
    dense[rng.random_sample(dense.shape) < 0.1] = ""  # missing values
    cats = np.empty((rows, NUM_CAT), dtype=object)
    for j in range(NUM_CAT):
        ids = rng.zipf(1.3, size=rows) % cat_cardinality
        cats[:, j] = np.char.add(f"t{j}_", ids.astype(str))
    with open(path, "w") as f:
        for i in range(rows):
            f.write("\t".join([str(label[i])]
                              + [str(v) for v in dense[i]]
                              + list(cats[i])) + "\n")


def pre_process(session, df, frequency_limit: int = 3):
    """The notebook's ``pre_process``: per-column frequency-limited dictionary
    (rank by count, ids dense from 1; rare/null → 0) built with distributed
    groupBy counts, then log(x+1) on the numeric columns."""
    from raydp_tpu_torch.etl import functions as F
    from raydp_tpu_torch.etl.expressions import col, udf

    sizes = []
    for c in CAT_COLS:
        counts = (df.groupBy(c).agg(F.count(c).alias("n"))
                  .to_pandas())
        counts = counts[counts["n"] >= frequency_limit]
        counts = counts.sort_values("n", ascending=False)
        mapping = {v: i + 1 for i, v in enumerate(counts[c])}
        sizes.append(len(mapping) + 1)  # 0 = rare/unseen
        to_id = udf("int64")(lambda v, m=mapping: m.get(v, 0))
        df = df.withColumn(c, to_id(col(c)))
    for c in DENSE_COLS:
        v = col(c).cast("double").fill_null(0.0)
        df = df.withColumn(c, F.log1p(v))
    return df, sizes

