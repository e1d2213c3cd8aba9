"""Estimator interface — the port's copy of the parts of
:mod:`raydp_tpu.train.estimator` on the training path: ``fit`` over datasets
plus ``get_model``, and the checkpoint cadence every estimator loop shares.
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class EstimatorInterface(ABC):
    """``fit`` over datasets + ``get_model``."""

    @abstractmethod
    def fit(self, train_ds, evaluate_ds=None, max_retries: int = 0):
        ...

    @abstractmethod
    def get_model(self):
        ...


def save_epoch_now(epoch: int, interval: int, num_epochs: int) -> bool:
    """The checkpoint cadence every estimator loop shares: every
    ``interval``-th epoch, and always the final one (so resume/get_model
    semantics hold at any interval)."""
    return (epoch + 1) % interval == 0 or epoch == num_epochs - 1
