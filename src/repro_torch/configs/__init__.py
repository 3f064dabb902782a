"""Configurations: the paper's parRSB workload and pipeline presets
(`parrsb`), and the architecture registry (`--arch <id>` resolves here).

The registry holds every architecture of `repro`'s: the LMs
``tinyllama-1.1b``, ``command-r-35b`` and ``mistral-large-123b`` (dense;
mistral's 245 GB of bf16 weights are built only sharded across ranks) and
``deepseek-moe-16b`` and ``qwen3-moe-30b-a3b`` (MoE), served and trained;
``sasrec`` (serving, retrieval and training); and the GNNs
``meshgraphnet``, ``graphcast``, ``nequip`` and ``mace`` (trained).
``NOT_PORTED`` names `repro`'s arch ids that wait for a slice (none).
"""

from repro_torch.configs import (
    command_r_35b,
    deepseek_moe_16b,
    graphcast,
    mace,
    meshgraphnet,
    mistral_large_123b,
    nequip,
    qwen3_moe_30b_a3b,
    sasrec,
    tinyllama_1_1b,
)
from repro_torch.configs.base import ArchDef, ShapeCell

# In `repro`'s order, which `all_cells` keeps.
REGISTRY = {m.ARCH.arch_id: m.ARCH
            for m in (deepseek_moe_16b, qwen3_moe_30b_a3b, mistral_large_123b,
                      tinyllama_1_1b, command_r_35b, mace, nequip,
                      graphcast, meshgraphnet, sasrec)}

# `repro`'s other arch ids, each with the slice it waits for.
NOT_PORTED: dict = {}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet "
                       f"({NOT_PORTED[arch_id]}); ported: {sorted(REGISTRY)}")
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_cells():
    """Every (arch × shape) cell with its skip reason (None = runnable):
    (arch_id, shape_name, ShapeCell, skip), in `repro`'s order."""
    for arch_id, arch in REGISTRY.items():
        for shape_name, cell, skip in arch.cells():
            yield arch_id, shape_name, cell, skip


__all__ = ["ArchDef", "ShapeCell", "REGISTRY", "NOT_PORTED", "all_cells",
           "get_arch"]
