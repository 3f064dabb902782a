"""Training substrate: optimizer, gradient compression, checkpointing, loop
(`repro.train`)."""

from repro_torch.train.optimizer import (
    AdamWConfig,
    abstract_opt_state,
    adamw_init,
    adamw_update,
    global_norm,
)

__all__ = ["AdamWConfig", "abstract_opt_state", "adamw_init", "adamw_update", "global_norm"]
