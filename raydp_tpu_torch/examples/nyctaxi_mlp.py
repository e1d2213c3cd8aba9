"""End-to-end NYCTaxi fare regression — the port's copy of
``examples/nyctaxi_mlp.py``: CSV → distributed feature ETL on host executors
→ recoverable Arrow handoff → ``TorchEstimator`` training of
``NYCTaxiModel`` on the CUDA card (``--device cpu`` trains on the CPU).

Run: python raydp_tpu_torch/examples/nyctaxi_mlp.py [--rows 100000]
     [--epochs 5] [--num-workers N]

``--num-workers N`` (N > 1) trains as a gang of N rank processes under one
``torch.distributed`` process group (``TorchEstimator.fit_gang``): one card
a rank under NCCL when the node has a card for each, else the ranks share
the card (or the CPU) under gloo.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def build_estimator(features, batch_size: int, epochs: int, device,
                    model=None):
    """The example's estimator: ``NYCTaxiModel`` (a fresh one unless
    ``model`` is given), Adam(1e-3), smooth L1, MAE and MSE. A fresh
    model is drawn on the host from seed 0 and placed on ``device`` by the
    estimator, so every device trains from the same weights."""
    import torch

    from raydp_tpu_torch.examples.nyctaxi_features import LABEL
    from raydp_tpu_torch.models import NYCTaxiModel
    from raydp_tpu_torch.train import TorchEstimator

    if model is None:
        model = NYCTaxiModel(len(features), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    return TorchEstimator(
        model=model,
        optimizer=lambda params: torch.optim.Adam(params, lr=1e-3),
        loss="smooth_l1",
        feature_columns=features,
        label_column=LABEL,
        batch_size=batch_size,
        num_epochs=epochs,
        metrics=["mae", "mse"],
        device=device,
    )


def main(argv=None) -> dict:
    """Runs the example; returns ``{"features", "history", "trace",
    "metrics_dump"}`` (the last two None without ``--trace``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--num-executors", type=int, default=2)
    ap.add_argument("--num-workers", type=int, default=1,
                    help=">1 trains as a gang of rank processes")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--trace", action="store_true",
                    help="collect a merged causal chrome trace + metrics "
                         "dump before teardown")
    ap.add_argument("--device", default=None,
                    help="the training device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import raydp_tpu_torch
    from raydp_tpu_torch.examples.nyctaxi_features import (
        feature_columns, nyc_taxi_preprocess,
    )

    device = raydp_tpu_torch.resolve_device(args.device)
    csv_path = args.csv
    if csv_path is None:
        from raydp_tpu_torch.examples.generate_nyctaxi import generate
        csv_path = os.path.join(tempfile.mkdtemp(prefix="rdt-nyc-"),
                                "nyctaxi.csv")
        generate(args.rows).to_csv(csv_path, index=False)

    session = raydp_tpu_torch.init(
        "nyctaxi", num_executors=args.num_executors, executor_cores=1,
        executor_memory="1GB")
    out = {"trace": None, "metrics_dump": None}
    try:
        data = session.read.csv(csv_path,
                                num_partitions=args.num_executors * 2)
        data = nyc_taxi_preprocess(data)
        train_df, test_df = data.randomSplit([0.9, 0.1], seed=0)
        features = feature_columns(data)
        print(f"{len(features)} features: {features}")

        estimator = build_estimator(features, args.batch_size, args.epochs,
                                    device)
        result = estimator.fit_on_frame(train_df, test_df,
                                        num_workers=args.num_workers)
        for row in result.history:
            print(row)
        out.update(features=features, history=result.history)
        if args.trace:
            # collect BEFORE teardown: dead actors' span lanes are lost
            from raydp_tpu_torch import metrics, profiler
            path = profiler.collect_chrome_trace()
            print(f"chrome trace: {path} ({path.flow_events} flow events, "
                  f"{path.actors} actor lanes, "
                  f"{path.skipped_actors} skipped)")
            out["trace"] = path
            out["metrics_dump"] = metrics.dump()
            print(f"metrics dump: {out['metrics_dump']}")
    finally:
        raydp_tpu_torch.stop()
    return out


if __name__ == "__main__":
    main()
