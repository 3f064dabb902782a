"""Training substrate: optimizer, gradient compression, checkpointing, loop
(`repro.train`)."""

from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]
