"""raydp_tpu_torch.models — ported model families.

- :mod:`transformer` — the long-context TransformerLM (forward, losses,
  backward);
- :mod:`convert` — Flax param trees → the port's state_dicts.
"""

from raydp_tpu_torch.models.convert import transformer_params_from_flax
from raydp_tpu_torch.models.transformer import (
    TransformerLM, lm_loss, lm_loss_fused,
)

__all__ = ["TransformerLM", "lm_loss", "lm_loss_fused",
           "transformer_params_from_flax"]
