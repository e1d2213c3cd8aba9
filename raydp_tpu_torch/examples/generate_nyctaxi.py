"""Synthetic NYC-taxi-like rows — the port's copy of
``examples/generate_nyctaxi.py``'s ``generate`` (schema parity with the
original project's fake_nyctaxi.csv / random_nyctaxi.py generator; values
are synthetic, the same for a seed as the reference's)."""

from __future__ import annotations

import numpy as np
import pandas as pd


def generate(num_rows: int, seed: int = 0) -> pd.DataFrame:
    rng = np.random.RandomState(seed)
    pickup_lon = rng.uniform(-74.2, -73.7, num_rows)
    pickup_lat = rng.uniform(40.5, 41.0, num_rows)
    drop_lon = pickup_lon + rng.normal(0, 0.03, num_rows)
    drop_lat = pickup_lat + rng.normal(0, 0.03, num_rows)
    dist = np.abs(drop_lon - pickup_lon) + np.abs(drop_lat - pickup_lat)
    base = pd.Timestamp("2019-01-01").value
    span = pd.Timestamp("2019-12-31").value - base
    ts = pd.to_datetime(base + (rng.random_sample(num_rows) * span).astype("int64"))
    passengers = rng.randint(1, 7, num_rows)
    fare = 2.5 + dist * 110 + passengers * 0.4 + rng.normal(0, 1.5, num_rows)
    return pd.DataFrame({
        "fare_amount": np.clip(fare, 2.5, 249.0),
        "pickup_datetime": ts.strftime("%Y-%m-%d %H:%M:%S"),
        "pickup_longitude": pickup_lon,
        "pickup_latitude": pickup_lat,
        "dropoff_longitude": drop_lon,
        "dropoff_latitude": drop_lat,
        "passenger_count": passengers,
    })

