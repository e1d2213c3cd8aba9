"""NYCTaxi with a user-owned torch training loop over the data-plane bridge
— the port's copy of ``examples/torch_loop_nyctaxi.py``.

The reference ships bring-your-own-loop examples where the framework only
provides the data plane and the user writes the torch loop (horovod_nyctaxi.py,
raytrain_nyctaxi.py). This is that story on the port: distributed feature ETL
on host executors → ``to_torch_dataset`` → a stock ``DataLoader`` + a
hand-written torch loop that moves each batch to the card itself
(``--device cpu`` trains on the CPU).

Run: python raydp_tpu_torch/examples/torch_loop_nyctaxi.py [--rows 50000]
     [--epochs 3] [--loader-workers 2]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def train_loop(train, evaluate, num_features: int, epochs: int, lr: float,
               device, loader_workers: int = 0, seed: int = 0) -> list:
    """The user's loop: a stock ``DataLoader`` over the bridge, each batch
    moved to ``device``; returns one report a epoch."""
    import torch
    from torch import nn

    torch.manual_seed(seed)
    loader = torch.utils.data.DataLoader(
        train, batch_size=None, num_workers=loader_workers)
    model = nn.Sequential(
        nn.Linear(num_features, 256), nn.ReLU(), nn.BatchNorm1d(256),
        nn.Linear(256, 64), nn.ReLU(), nn.BatchNorm1d(64),
        nn.Linear(64, 1)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    loss_fn = nn.SmoothL1Loss()

    reports = []
    for epoch in range(epochs):
        model.train()
        t0, total, steps = time.perf_counter(), 0.0, 0
        for feats, labels in loader:
            feats = feats.to(device, non_blocking=True)
            labels = labels.to(device, non_blocking=True)
            opt.zero_grad()
            loss = loss_fn(model(feats).squeeze(-1), labels)
            loss.backward()
            opt.step()
            total += float(loss)
            steps += 1
        model.eval()
        with torch.no_grad():
            esum, ecnt = 0.0, 0
            for feats, labels in evaluate:
                feats, labels = feats.to(device), labels.to(device)
                esum += float(loss_fn(model(feats).squeeze(-1), labels)) \
                    * len(labels)
                ecnt += len(labels)
        reports.append({"epoch": epoch, "train_loss": round(total / steps, 5),
                        "eval_loss": round(esum / max(ecnt, 1), 5),
                        "epoch_time_s": round(time.perf_counter() - t0, 2)})
        print(reports[-1])
    return reports


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=50_000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--loader-workers", type=int, default=0,
                    help="DataLoader num_workers (the bridge stripes batches "
                         "across workers)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="the training device (default: the CUDA card)")
    args = ap.parse_args()

    import raydp_tpu_torch
    from raydp_tpu_torch.data import from_frame, to_torch_dataset
    from raydp_tpu_torch.examples.generate_nyctaxi import generate
    from raydp_tpu_torch.examples.nyctaxi_features import (
        LABEL, feature_columns, nyc_taxi_preprocess,
    )

    device = raydp_tpu_torch.resolve_device(args.device)
    csv_path = os.path.join(tempfile.mkdtemp(prefix="rdt-ex-"), "nyctaxi.csv")
    generate(args.rows).to_csv(csv_path, index=False)

    session = raydp_tpu_torch.init("torch-loop", num_executors=2,
                                   executor_cores=2, executor_memory="1GB")
    try:
        df = nyc_taxi_preprocess(session.read.csv(csv_path, num_partitions=4))
        features = feature_columns(df)
        train_df, eval_df = df.randomSplit([0.9, 0.1], seed=0)
        train_ds, eval_ds = from_frame(train_df), from_frame(eval_df)

        train = to_torch_dataset(
            train_ds, feature_columns=features, label_column=LABEL,
            batch_size=args.batch_size, shuffle=True)
        evaluate = to_torch_dataset(
            eval_ds, feature_columns=features, label_column=LABEL,
            batch_size=args.batch_size)
        train_loop(train, evaluate, len(features), args.epochs, args.lr,
                   device, args.loader_workers)
    finally:
        raydp_tpu_torch.stop()


if __name__ == "__main__":
    main()
