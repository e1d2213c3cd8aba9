"""The serving plane: trained estimators behind a micro-batched, hedged
inference service over the executor pool — the port of
:mod:`raydp_tpu.serve`, serving on the card.

    est.fit_on_frame(train_df)
    est.export_serving("/shared/model-v1")
    with ServingSession("/shared/model-v1", session=session) as srv:
        preds = srv.predict(rows)
        srv.autoscale()                    # replicas follow queue depth
        srv.rollout("/shared/model-v2")    # guarded canary deploy

Each replica runs in an ETL executor, which takes its CUDA context at the
replica's load: an executor that hosts no replica imports no torch and
holds no context. ``device="cpu"`` (on :class:`ServingSession` and
:func:`load_servable`) serves on the CPU instead.
"""

from raydp_tpu_torch.serve.autoscale import ServingAutoscaler  # noqa: F401
from raydp_tpu_torch.serve.rollout import RolloutController  # noqa: F401
from raydp_tpu_torch.serve.servable import (  # noqa: F401
    Servable, export_bundle, load_servable,
)
from raydp_tpu_torch.serve.session import (  # noqa: F401
    ServingError, ServingOverloaded, ServingSession,
)

__all__ = ["RolloutController", "Servable", "ServingAutoscaler",
           "ServingError", "ServingOverloaded", "ServingSession",
           "export_bundle", "load_servable"]
