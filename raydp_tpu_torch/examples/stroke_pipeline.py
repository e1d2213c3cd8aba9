"""End-to-end data-processing tutorial pipeline (healthcare stroke shape) —
the port's copy of ``examples/stroke_pipeline.py``.

The reference's tutorials walk a healthcare stroke CSV through Spark
preprocessing into estimator training on one cluster;
``raydp_tpu_torch/doc/tutorial_data_processing.md`` narrates this pipeline
step by step.
Here the same pipeline runs on the port: the ETL on host executors, then a
``TorchEstimator`` fit of a small MLP on the CUDA card (``--device cpu``
trains on the CPU). The data is generated, with the reference's seed, so
nothing is downloaded.

Run: ``python raydp_tpu_torch/examples/stroke_pipeline.py [--rows 6000]
[--epochs 6]``
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import pandas as pd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def generate_stroke(rows: int, seed: int = 11) -> pd.DataFrame:
    """A stroke-dataset-shaped table (same columns as the reference CSV),
    generated because this environment has no egress. `bmi` has missing
    values and `smoking_status` an Unknown level, like the original."""
    rng = np.random.RandomState(seed)
    age = np.clip(rng.normal(45, 22, rows), 1, 95).round(0)
    hypertension = (rng.random_sample(rows) < 0.10 + 0.2 * (age > 60)) \
        .astype(np.int64)
    heart_disease = (rng.random_sample(rows) < 0.04 + 0.12 * (age > 65)) \
        .astype(np.int64)
    glucose = np.clip(rng.gamma(6.0, 18.0, rows), 55, 280).round(2)
    bmi = np.clip(rng.normal(28.5, 7.5, rows), 12, 60).round(1)
    logit = (-5.2 + 0.055 * (age - 45) + 0.9 * hypertension
             + 0.8 * heart_disease + 0.008 * (glucose - 110)
             + rng.normal(0, 0.6, rows))
    stroke = (rng.random_sample(rows) < 1 / (1 + np.exp(-logit))) \
        .astype(np.int64)
    bmi_missing = rng.random_sample(rows) < 0.04
    return pd.DataFrame({
        "id": np.arange(1, rows + 1),
        "gender": rng.choice(["Male", "Female"], rows, p=[0.41, 0.59]),
        "age": age,
        "hypertension": hypertension,
        "heart_disease": heart_disease,
        "ever_married": rng.choice(["Yes", "No"], rows, p=[0.66, 0.34]),
        "work_type": rng.choice(
            ["Private", "Self-employed", "Govt_job", "children"],
            rows, p=[0.62, 0.16, 0.13, 0.09]),
        "Residence_type": rng.choice(["Urban", "Rural"], rows),
        "avg_glucose_level": glucose,
        "bmi": np.where(bmi_missing, np.nan, bmi),
        "smoking_status": rng.choice(
            ["never smoked", "formerly smoked", "smokes", "Unknown"],
            rows, p=[0.37, 0.17, 0.16, 0.30]),
        "stroke": stroke,
    })


FEATURES = ["age", "hypertension", "heart_disease", "avg_glucose_level",
            "bmi", "is_male", "is_married", "is_urban",
            "work_private", "work_self", "smokes", "smoked_formerly"]
LABEL = "stroke"


def preprocess(df):
    """The tutorial's transformation chapter: impute, filter, encode."""
    from raydp_tpu_torch.etl.expressions import col

    df = df.fillna(28.5, subset=["bmi"])          # median-BMI imputation
    df = df.filter(col("age") >= 2)               # drop infant rows
    df = (df
          .withColumn("is_male", col("gender") == "Male")
          .withColumn("is_married", col("ever_married") == "Yes")
          .withColumn("is_urban", col("Residence_type") == "Urban")
          .withColumn("work_private", col("work_type") == "Private")
          .withColumn("work_self", col("work_type") == "Self-employed")
          .withColumn("smokes", col("smoking_status") == "smokes")
          .withColumn("smoked_formerly",
                      col("smoking_status") == "formerly smoked"))
    return df.select(LABEL, *FEATURES)


def build_estimator(batch_size: int, epochs: int, device, model=None):
    """The example's estimator: ``MLP`` with hidden widths 64, 32 and 1,
    each followed by a ReLU, then a 1-wide head (a fresh one unless
    ``model`` is given), Adam(1e-3), BCE with logits, seed 0.

    A fresh model is drawn on the host from seed 0 and placed on
    ``device`` by the estimator, so every device trains from the same
    weights (a card's generator draws other numbers from the same seed),
    as the reference's ``PRNGKey(0)`` init does."""
    import torch

    from raydp_tpu_torch.models import MLP
    from raydp_tpu_torch.train import TorchEstimator

    if model is None:
        model = MLP(len(FEATURES), (64, 32, 1), out_features=1,
                    use_batch_norm=False, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    return TorchEstimator(
        model=model,
        optimizer=lambda params: torch.optim.Adam(params, lr=1e-3),
        loss="bce_with_logits",
        feature_columns=FEATURES,
        label_column=LABEL,
        batch_size=batch_size,
        num_epochs=epochs,
        seed=0,
        device=device,
    )


def main(argv=None) -> dict:
    """Runs the pipeline; returns ``{"history", "ok"}``, ``ok`` when the
    train loss fell."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=6000)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="the training device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import raydp_tpu_torch
    from raydp_tpu_torch.data import from_frame
    from raydp_tpu_torch.utils import random_split

    device = raydp_tpu_torch.resolve_device(args.device)
    csv_path = os.path.join(tempfile.mkdtemp(prefix="rdt-stroke-"),
                            "stroke.csv")
    generate_stroke(args.rows).to_csv(csv_path, index=False)

    session = raydp_tpu_torch.init("stroke", num_executors=2,
                                   executor_cores=1, executor_memory="512MB")
    try:
        data = session.read.csv(csv_path, num_partitions=4)

        # -- inspect (tutorial chapter 2) ---------------------------------
        from raydp_tpu_torch.etl import functions as F

        n = data.count()
        by_smoking = (data.groupBy("smoking_status")
                      .agg(F.mean("stroke").alias("stroke_rate"))
                      .to_pandas())
        print(f"{n} rows; stroke rate by smoking status:")
        print(by_smoking.to_string(index=False))

        # -- transform (chapter 3) ----------------------------------------
        data = preprocess(data)
        train_df, test_df = random_split(data, [0.8, 0.2], seed=0)

        # -- hand off to training (chapter 4) ------------------------------
        train_ds, test_ds = from_frame(train_df), from_frame(test_df)
        est = build_estimator(args.batch_size, args.epochs, device)
        result = est.fit(train_ds, test_ds)
        last = result.history[-1]
        print(f"final: train_loss={last['train_loss']:.4f} "
              f"eval_loss={last['eval_loss']:.4f} (first epoch: "
              f"train_loss={result.history[0]['train_loss']:.4f})")
        # the loss must actually improve over training
        ok = last["train_loss"] < result.history[0]["train_loss"]
        if not ok:
            print("FAILED: loss did not decrease", file=sys.stderr)
        return {"history": result.history, "ok": ok}
    finally:
        raydp_tpu_torch.stop()


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
