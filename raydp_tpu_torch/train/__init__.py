"""raydp_tpu_torch.train — the estimator, its metrics and checkpoints.

- :mod:`torch_estimator` — :class:`TorchEstimator` (fit / fit_on_frame
  / predict / get_model / partial_fit, the port of ``FlaxEstimator``) and
  :class:`PipelineModel`, the layer-list model the GPipe schedule trains;
- :mod:`gbdt_estimator` — :class:`GBDTEstimator` (histogram trees on the
  card; fit / fit_on_frame / predict / get_model / load_model);
- :mod:`step_graph` — the step runner that replays a captured train or
  eval step as a CUDA graph (the reference's jitted scan and chain);
- :mod:`metrics` — MSE / RMSE / MAE / Accuracy / BCE with the pad mask;
- :mod:`checkpoint` — ``step_<n>`` dirs in the reference's one-process
  layout;
- :mod:`estimator` — the estimator interfaces (``fit``, ``partial_fit``
  over a continuous pipeline, ``fit_on_frame`` with its frame conversion)
  and checkpoint cadence.
"""

from raydp_tpu_torch.train.estimator import (
    EstimatorInterface, FrameEstimatorInterface,
)
from raydp_tpu_torch.train.gbdt_estimator import GBDTEstimator
from raydp_tpu_torch.train.metrics import Metric, build_metrics
from raydp_tpu_torch.train.torch_estimator import (
    PipelineModel, TorchEstimator, TrainingResult, TrainState,
)

__all__ = ["EstimatorInterface", "FrameEstimatorInterface", "GBDTEstimator",
           "Metric", "PipelineModel", "TorchEstimator", "TrainState",
           "TrainingResult", "build_metrics"]
