"""raydp_tpu_torch.models — ported model families.

- :mod:`transformer` — the long-context TransformerLM (forward, losses,
  backward);
- :mod:`mlp` — ``MLP`` / ``NYCTaxiModel`` (Flax BatchNorm semantics);
- :mod:`dlrm` — ``DLRM`` and ``criteo_batch_preprocessor``;
- :mod:`gbdt` — histogram gradient-boosted trees (``fit_gbdt``,
  ``GBDTModel``), trained on the card;
- :mod:`layers` — the Flax layers they share;
- :mod:`convert` — Flax variable trees (a ``PipelineModel``'s stacked
  ones too) → the port's state_dicts, and a
  reference forest → the port's ``GBDTModel``.
"""

from raydp_tpu_torch.models.convert import (
    dlrm_params_from_flax, gbdt_from_reference, mlp_variables_from_flax,
    pipeline_params_from_flax, transformer_params_from_flax,
)
from raydp_tpu_torch.models.dlrm import (
    DLRM, criteo_batch_preprocessor, dlrm_param_rules,
)
from raydp_tpu_torch.models.gbdt import GBDTModel, fit_gbdt
from raydp_tpu_torch.models.mlp import MLP, NYCTaxiModel
from raydp_tpu_torch.models.transformer import (
    TransformerLM, lm_loss, lm_loss_fused, transformer_param_rules,
)

__all__ = ["DLRM", "GBDTModel", "MLP", "NYCTaxiModel", "TransformerLM",
           "criteo_batch_preprocessor", "dlrm_param_rules",
           "dlrm_params_from_flax", "fit_gbdt", "gbdt_from_reference",
           "lm_loss", "lm_loss_fused", "mlp_variables_from_flax",
           "pipeline_params_from_flax", "transformer_param_rules",
           "transformer_params_from_flax"]
