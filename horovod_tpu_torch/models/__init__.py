"""Model zoo of the port (counterpart of ``horovod_tpu/models``): so far
the decoder-only Transformer LM."""

from horovod_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig, TransformerLM, apply_rope, best_attention,
    causal_attention, lm_loss, lm_loss_from_hidden, params_from_flax,
)
