"""NYC taxi feature pipeline — the port's copy of
``examples/nyctaxi_features.py`` (itself functional parity with the original
project's examples/data_process.py: clean_up + time features + distance
features), built on the port's expression API. Where the reference reaches for Python UDFs
(``night``, ``late_night``, ``manhattan``), we use vectorized expressions — the
columnar path — and keep one UDF only where shown as an escape-hatch example.
"""

from __future__ import annotations

from raydp_tpu_torch.etl import functions as F
from raydp_tpu_torch.etl.expressions import col, lit, when

LABEL = "fare_amount"


def clean_up(data):
    return (data
            .filter(col("pickup_longitude") <= -72)
            .filter(col("pickup_longitude") >= -76)
            .filter(col("dropoff_longitude") <= -72)
            .filter(col("dropoff_longitude") >= -76)
            .filter(col("pickup_latitude") <= 42)
            .filter(col("pickup_latitude") >= 38)
            .filter(col("dropoff_latitude") <= 42)
            .filter(col("dropoff_latitude") >= 38)
            .filter(col("passenger_count") <= 6)
            .filter(col("passenger_count") >= 1)
            .filter(col("fare_amount") > 0)
            .filter(col("fare_amount") < 250)
            .filter(col("dropoff_longitude") != col("pickup_longitude"))
            .filter(col("dropoff_latitude") != col("pickup_latitude")))


def add_time_features(data):
    ts = col("pickup_datetime").cast("timestamp")
    data = (data
            .withColumn("day", F.dayofmonth(ts))
            .withColumn("hour_of_day", F.hour(ts))
            .withColumn("day_of_week", F.dayofweek(ts) - 2)
            .withColumn("week_of_year", F.weekofyear(ts))
            .withColumn("month_of_year", F.month(ts))
            .withColumn("quarter_of_year", F.quarter(ts))
            .withColumn("year", F.year(ts)))
    night = when((col("hour_of_day") >= 16) & (col("hour_of_day") <= 20)
                 & (col("day_of_week") < 5), 1).otherwise(0)
    late_night = when((col("hour_of_day") <= 6)
                      | (col("hour_of_day") >= 20), 1).otherwise(0)
    return (data.withColumn("night", night)
                .withColumn("late_night", late_night))


def _manhattan(lon1, lat1, lon2, lat2):
    return F.abs(lat2 - lat1) + F.abs(lon2 - lon1)


def add_distance_features(data):
    ny = (-74.0063889, 40.7141667)
    jfk = (-73.7822222222, 40.6441666667)
    ewr = (-74.175, 40.69)
    lgr = (-73.87, 40.77)
    data = (data
            .withColumn("abs_diff_longitude",
                        F.abs(col("dropoff_longitude") - col("pickup_longitude")))
            .withColumn("abs_diff_latitude",
                        F.abs(col("dropoff_latitude") - col("pickup_latitude"))))
    data = data.withColumn("manhattan",
                           col("abs_diff_latitude") + col("abs_diff_longitude"))
    for name, (lon, lat) in (("jfk", jfk), ("ewr", ewr), ("lgr", lgr),
                             ("downtown", ny)):
        data = data.withColumn(
            f"pickup_distance_{name}",
            _manhattan(col("pickup_longitude"), col("pickup_latitude"),
                       lit(lon), lit(lat)))
        data = data.withColumn(
            f"dropoff_distance_{name}",
            _manhattan(col("dropoff_longitude"), col("dropoff_latitude"),
                       lit(lon), lit(lat)))
    return data


def drop_columns(data):
    return data.drop("pickup_datetime")


def nyc_taxi_preprocess(data):
    data = clean_up(data)
    data = add_time_features(data)
    data = add_distance_features(data)
    return drop_columns(data)


def feature_columns(df):
    return [c for c in df.columns if c != LABEL]
