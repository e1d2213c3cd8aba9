"""GBDTEstimator: the XGBoostEstimator-parity trainer on the card — the port
of :mod:`raydp_tpu.train.gbdt_estimator`.

Parity map (reference xgboost/estimator.py):

- ``XGBoostEstimator(params, label_column, num_boost_round)`` thin wrapper
  over ``ray.train.xgboost.XGBoostTrainer`` (54-81) — here the same sklearn
  shape over :func:`raydp_tpu_torch.models.gbdt.fit_gbdt`, whose histograms
  are where XGBoost's Rabit allreduce sits;
- per-iteration ``CheckpointConfig(num_to_keep=1)`` (60-68) — the forest's
  split/leaf tables are pickled per fit into ``checkpoint_dir``
  (``model.pkl`` holds the port's ``GBDTModel``; a reference model crosses
  through :func:`~raydp_tpu_torch.models.convert.gbdt_from_reference`);
- ``fit_on_spark`` conversion paths + ``get_model`` (83-119) —
  ``fit_on_frame`` / ``get_model`` below.

Accepted ``params`` keys follow xgboost naming: ``objective``
(``reg:squarederror`` | ``binary:logistic`` | ``multi:softmax`` |
``multi:softprob``), ``num_class``, ``max_depth``, ``eta`` /
``learning_rate``, ``lambda`` / ``reg_lambda``, ``min_child_weight``,
``max_bin``. Eval sets are scored every boosting round
(``result.evals_result``) and ``early_stopping_rounds`` stops and truncates
to the best iteration; ``weight_column`` supplies per-row instance weights.

The rounds run on ``device`` (CUDA unless ``device="cpu"``; raises without
it). Materializing the datasets (``to_arrow`` on the host) and binning stay
on the host, as in the reference; ``result.dispatch`` holds the fit's wall
split (``materialize_s`` and :func:`fit_gbdt`'s ``timings``).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np

from raydp_tpu_torch.device import DeviceLike, resolve_device
from raydp_tpu_torch.log import get_logger
from raydp_tpu_torch.train.estimator import (
    EstimatorInterface, FrameEstimatorInterface,
)
from raydp_tpu_torch.train.torch_estimator import TrainingResult

logger = get_logger("train.gbdt_estimator")


class GBDTEstimator(EstimatorInterface, FrameEstimatorInterface):
    def __init__(
        self,
        params: Optional[Dict] = None,
        feature_columns: Optional[Sequence[str]] = None,
        label_column: Optional[str] = None,
        num_boost_round: int = 100,
        checkpoint_dir: Optional[str] = None,
        early_stopping_rounds: Optional[int] = None,
        weight_column: Optional[str] = None,
        mesh=None,
        device: DeviceLike = None,
    ):
        params = dict(params or {})
        self.objective = params.pop("objective", "reg:squarederror")
        self.num_class = params.pop("num_class", None)
        self.max_depth = int(params.pop("max_depth", 6))
        self.learning_rate = float(params.pop(
            "eta", params.pop("learning_rate", 0.3)))
        self.reg_lambda = float(params.pop(
            "lambda", params.pop("reg_lambda", 1.0)))
        self.min_child_weight = float(params.pop("min_child_weight", 1.0))
        self.num_bins = int(params.pop("max_bin", 256))
        if "early_stopping_rounds" in params:
            early_stopping_rounds = params.pop("early_stopping_rounds")
        if params:
            logger.warning("ignoring unsupported params: %s", sorted(params))
        self.feature_columns = list(feature_columns or [])
        self.label_column = label_column
        self.num_boost_round = num_boost_round
        self.checkpoint_dir = checkpoint_dir
        self.early_stopping_rounds = early_stopping_rounds
        self.weight_column = weight_column
        self.mesh = mesh  # refused by fit_gbdt until the multi-device slice
        #: the device every fit and predict runs on: CUDA unless
        #: ``device="cpu"`` is passed; raises without CUDA
        self.device = resolve_device(device)
        self._model = None
        self._result: Optional[TrainingResult] = None
        self.evals_result: Dict = {}

    # ------------------------------------------------------------------ data
    def _feature_matrix(self, table) -> np.ndarray:
        return np.stack([table.column(c).to_numpy(zero_copy_only=False)
                         .astype(np.float32, copy=False)
                         for c in self.feature_columns], axis=1)

    def _materialize(self, ds, with_weight: bool = False):
        if ds is None:
            return None
        if not self.feature_columns or self.label_column is None:
            raise ValueError("pass feature_columns and label_column")
        table = ds.to_arrow()
        X = self._feature_matrix(table)
        y = (table.column(self.label_column).to_numpy(zero_copy_only=False)
             .astype(np.float32, copy=False))
        if with_weight and self.weight_column is not None:
            w = (table.column(self.weight_column)
                 .to_numpy(zero_copy_only=False).astype(np.float32, copy=False))
            return X, y, w
        return (X, y, None) if with_weight else (X, y)

    def _metrics_from_margin(self, margin, y, prefix: str) -> Dict[str, float]:
        from raydp_tpu_torch.models.gbdt import eval_metric

        name, value = eval_metric(margin, y, self.objective)
        out = {f"{prefix}_{name}": value}
        if self.objective == "binary:logistic":
            p = 1.0 / (1.0 + np.exp(-margin))
            out[f"{prefix}_error"] = float(((p > 0.5) != (y > 0.5)).mean())
        elif self.objective.startswith("multi:"):
            out[f"{prefix}_merror"] = float(
                (margin.argmax(axis=1) != y.astype(np.int64)).mean())
        return out

    # ------------------------------------------------------------------- fit
    def fit(self, train_ds, evaluate_ds=None, max_retries: int = 0
            ) -> TrainingResult:
        from raydp_tpu_torch.models.gbdt import fit_gbdt

        t0 = time.perf_counter()
        X, y, w = self._materialize(train_ds, with_weight=True)
        evals = self._materialize(evaluate_ds)
        timings = {"materialize_s": time.perf_counter() - t0}

        model, train_margin, evals_result = fit_gbdt(
            X, y, num_trees=self.num_boost_round, max_depth=self.max_depth,
            num_bins=self.num_bins, learning_rate=self.learning_rate,
            reg_lambda=self.reg_lambda, min_child_weight=self.min_child_weight,
            objective=self.objective, num_class=self.num_class,
            sample_weight=w, evals=evals,
            early_stopping_rounds=self.early_stopping_rounds,
            mesh=self.mesh, device=self.device, timings=timings)
        self.evals_result = evals_result

        report = {"num_trees": model.num_trees}
        if model.best_iteration is not None:
            report["best_iteration"] = model.best_iteration
        report.update(self._metrics_from_margin(train_margin, y, "train"))
        if evals is not None:
            eX, ey = evals
            report.update(self._metrics_from_margin(
                model.predict(eX, output_margin=True, device=self.device),
                ey, "eval"))
        logger.info("gbdt fit: %s", report)

        ckpt_dir = self.checkpoint_dir or tempfile.mkdtemp(prefix="rdt-gbdt-")
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(ckpt_dir, "model.pkl"), "wb") as fh:
            pickle.dump(model, fh)

        self._model = model
        self._result = TrainingResult(state=model, history=[report],
                                      checkpoint_dir=ckpt_dir,
                                      dispatch=[timings])
        return self._result

    # ---------------------------------------------------------- fit_on_frame
    def fit_on_frame(self, train_df, evaluate_df=None, *,
                     fs_directory: Optional[str] = None,
                     stop_etl_after_conversion: bool = False,
                     max_retries: int = 0) -> TrainingResult:
        train_ds, eval_ds = self._convert_frames(
            train_df, evaluate_df, fs_directory=fs_directory,
            stop_etl_after_conversion=stop_etl_after_conversion)
        return self.fit(train_ds, eval_ds, max_retries=max_retries)

    # ------------------------------------------------------------- get_model
    def get_model(self):
        """The fitted :class:`~raydp_tpu_torch.models.gbdt.GBDTModel`
        (parity: xgboost/estimator.py:110-119)."""
        if self._model is None:
            raise RuntimeError("call fit()/fit_on_frame() first")
        return self._model

    def predict(self, ds, output_margin: bool = False) -> np.ndarray:
        """Run the fitted trees over a dataset's feature columns on the
        estimator's device."""
        model = self.get_model()
        X = self._feature_matrix(ds.to_arrow())
        return model.predict(X, output_margin=output_margin,
                             device=self.device)

    @staticmethod
    def load_model(checkpoint_dir: str):
        with open(os.path.join(checkpoint_dir, "model.pkl"), "rb") as fh:
            return pickle.load(fh)
