"""NYCTaxi fare regression with gradient-boosted trees on the card — the
port's copy of ``examples/gbdt_nyctaxi.py``.

The reference's XGBoost example (examples/xgboost_ray_nyctaxi.py: Spark ETL
→ XGBoostTrainer over Rabit) as the port runs it: the port's ETL feeds
:class:`raydp_tpu_torch.train.GBDTEstimator`, whose histogram trees grow on
the CUDA device (``--device cpu`` for the CPU). Demonstrates per-round eval
reporting and early stopping. The session's executors are left to
``raydp_tpu_torch.init``'s defaults unless given here, so a launch through
``python -m raydp_tpu_torch.cli.submit --num-executors N --executor-cores C``
sets them.

Run: python raydp_tpu_torch/examples/gbdt_nyctaxi.py [--rows 100000]
     [--rounds 100]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--early-stopping-rounds", type=int, default=10)
    ap.add_argument("--num-executors", type=int, default=None)
    ap.add_argument("--executor-cores", type=int, default=None)
    ap.add_argument("--csv", default=None)
    ap.add_argument("--device", default=None,
                    help="the training device (default: the CUDA card)")
    args = ap.parse_args()

    import raydp_tpu_torch
    from raydp_tpu_torch.examples.nyctaxi_features import (
        LABEL, feature_columns, nyc_taxi_preprocess,
    )
    from raydp_tpu_torch.train import GBDTEstimator
    from raydp_tpu_torch.utils import random_split

    csv_path = args.csv
    if csv_path is None:
        from raydp_tpu_torch.examples.generate_nyctaxi import generate
        csv_path = os.path.join(tempfile.mkdtemp(), "nyctaxi.csv")
        generate(args.rows).to_csv(csv_path, index=False)

    session = raydp_tpu_torch.init(
        "gbdt-nyctaxi", num_executors=args.num_executors,
        executor_cores=args.executor_cores, executor_memory="1GB")
    print(f"session: {session.num_executors} executors x "
          f"{session.executor_cores} cores")
    try:
        data = session.read.csv(csv_path,
                                num_partitions=session.num_executors * 2)
        data = nyc_taxi_preprocess(data)
        train_df, test_df = random_split(data, [0.9, 0.1], 0)
        features = feature_columns(data)

        est = GBDTEstimator(
            # xgboost-style params (reference xgboost_ray_nyctaxi.py:60-75)
            params={"objective": "reg:squarederror",
                    "max_depth": args.max_depth, "eta": 0.3},
            feature_columns=features,
            label_column=LABEL,
            num_boost_round=args.rounds,
            early_stopping_rounds=args.early_stopping_rounds,
            device=args.device,
        )
        train_ds, eval_ds = est._convert_frames(train_df, test_df)
        t0 = time.perf_counter()
        result = est.fit(train_ds, eval_ds)
        wall = time.perf_counter() - t0
        print(result.history[-1])
        rounds = est.evals_result.get("eval_rmse", [])
        if rounds:
            print(f"eval rmse by round: first={rounds[0]:.4f} "
                  f"best={min(rounds):.4f} rounds_run={len(rounds)}")
        model = est.get_model()
        print(f"forest: {model.num_trees} trees, "
              f"best_iteration={model.best_iteration}")
        n_train = train_ds.count()
        print("gbdt_nyctaxi " + json.dumps({
            "train_rows": n_train, "rounds_run": len(rounds),
            "fit_wall_s": wall,
            "rows_rounds_per_s": n_train * len(rounds) / wall,
            "split": result.dispatch[0]}))
    finally:
        raydp_tpu_torch.stop()


if __name__ == "__main__":
    main()
