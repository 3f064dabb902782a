"""Helpers shared by the LM tests of the port: `repro`'s configs turned
into the port's, and tensors and arrays carried between the two packages.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as tj
from repro_torch.models import moe as mt, transformer as tt

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_moe(moe_j) -> mt.MoEConfig:
    return mt.MoEConfig(**dataclasses.asdict(moe_j))


def port_config(cfg_j) -> tt.LMConfig:
    fields = {f.name: getattr(cfg_j, f.name)
              for f in dataclasses.fields(tj.LMConfig)}
    fields["dtype"] = TORCH_DTYPE[fields["dtype"]]
    fields["param_dtype"] = TORCH_DTYPE[fields["param_dtype"]]
    if fields["moe"] is not None:
        fields["moe"] = port_moe(fields["moe"])
    return tt.LMConfig(**fields)


def as_np(x):
    """A torch tensor or a JAX array as a float32 NumPy array."""
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def tensors(tree):
    """A nested dict of arrays as the same dict of CPU tensors."""
    return {k: tensors(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}
