"""Estimator interface — the port's copy of the parts of
:mod:`raydp_tpu.train.estimator` on the training path: ``fit`` over datasets
plus ``get_model``, ``fit_on_frame`` over ETL DataFrames with the frame
conversion every estimator shares, and the checkpoint cadence every
estimator loop shares.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Optional


class EstimatorInterface(ABC):
    """``fit`` over datasets + ``get_model``."""

    @abstractmethod
    def fit(self, train_ds, evaluate_ds=None, max_retries: int = 0):
        ...

    @abstractmethod
    def get_model(self):
        ...


class FrameEstimatorInterface(ABC):
    """``fit_on_frame`` — the ``fit_on_spark`` analogue
    (spark/interfaces.py:27-39): accepts ETL DataFrames, converts through the
    data plane (object store or a parquet spill directory), optionally stops the
    ETL engine after conversion with ownership transferred to the master."""

    @abstractmethod
    def fit_on_frame(self, train_df, evaluate_df=None, *,
                     fs_directory: Optional[str] = None,
                     stop_etl_after_conversion: bool = False,
                     max_retries: int = 0):
        ...

    @staticmethod
    def _convert_frames(train_df, evaluate_df=None, *,
                        fs_directory: Optional[str] = None,
                        stop_etl_after_conversion: bool = False):
        """Frames → datasets through the chosen conversion path; optionally
        stop the ETL engine with ownership transferred to the master so the
        data survives (parity: torch/estimator.py:358-390, dataset.py:137-158).
        Shared by every concrete estimator's ``fit_on_frame``."""
        import raydp_tpu_torch
        from raydp_tpu_torch.data import from_frame, from_frame_recoverable

        def convert(df, tag):
            if df is None:
                return None
            if fs_directory is not None:
                # parquet spill path (parity: torch/estimator.py:365-376)
                path = os.path.join(fs_directory, tag)
                df.write.parquet(path)
                session = df._session
                return from_frame(session.read.parquet(path))
            return from_frame_recoverable(df)

        train_ds = convert(train_df, "train")
        eval_ds = convert(evaluate_df, "eval")
        if stop_etl_after_conversion:
            train_ds.transfer_to_master()
            if eval_ds is not None:
                eval_ds.transfer_to_master()
            raydp_tpu_torch.stop(cleanup_data=False)
        return train_ds, eval_ds


def save_epoch_now(epoch: int, interval: int, num_epochs: int) -> bool:
    """The checkpoint cadence every estimator loop shares: every
    ``interval``-th epoch, and always the final one (so resume/get_model
    semantics hold at any interval)."""
    return (epoch + 1) % interval == 0 or epoch == num_epochs - 1
