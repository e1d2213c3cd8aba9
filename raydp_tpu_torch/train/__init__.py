"""raydp_tpu_torch.train — the estimator, its metrics and checkpoints.

- :mod:`torch_estimator` — :class:`TorchEstimator` (fit / fit_on_frame
  / predict / get_model, the port of ``FlaxEstimator``);
- :mod:`metrics` — MSE / RMSE / MAE / Accuracy / BCE with the pad mask;
- :mod:`checkpoint` — ``step_<n>`` dirs in the reference's one-process
  layout;
- :mod:`estimator` — the estimator interfaces (``fit``, ``fit_on_frame``
  with its frame conversion) and checkpoint cadence.
"""

from raydp_tpu_torch.train.estimator import (
    EstimatorInterface, FrameEstimatorInterface,
)
from raydp_tpu_torch.train.metrics import Metric, build_metrics
from raydp_tpu_torch.train.torch_estimator import (
    TorchEstimator, TrainingResult, TrainState,
)

__all__ = ["EstimatorInterface", "FrameEstimatorInterface", "Metric",
           "TorchEstimator", "TrainState", "TrainingResult", "build_metrics"]
