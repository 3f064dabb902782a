"""Configurations: the paper's parRSB workload and pipeline presets
(`parrsb`), and the architecture registry (`--arch <id>` resolves here).

The registry holds the architectures the port runs: the LMs
``tinyllama-1.1b`` and ``command-r-35b`` (dense) and ``deepseek-moe-16b``
and ``qwen3-moe-30b-a3b`` (MoE), served and trained; ``sasrec`` (serving,
retrieval and training); and the GNNs ``meshgraphnet``, ``graphcast``,
``nequip`` and ``mace`` (trained).  ``mistral-large-123b``, the one other
arch id of `repro`'s registry, raises `KeyError` naming it as not ported
yet, with the slice it waits for.
"""

from repro_torch.configs import (
    command_r_35b,
    deepseek_moe_16b,
    graphcast,
    mace,
    meshgraphnet,
    nequip,
    qwen3_moe_30b_a3b,
    sasrec,
    tinyllama_1_1b,
)
from repro_torch.configs.base import ArchDef, ShapeCell

REGISTRY = {m.ARCH.arch_id: m.ARCH
            for m in (deepseek_moe_16b, qwen3_moe_30b_a3b, tinyllama_1_1b,
                      command_r_35b, mace, nequip, graphcast, meshgraphnet,
                      sasrec)}

# `repro`'s other arch ids, each with the slice it waits for.
NOT_PORTED = {
    "mistral-large-123b": "246 GB of bf16 weights: needs the sharding "
                          "slice across cards (ROADMAP C3)",
}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet "
                       f"({NOT_PORTED[arch_id]}); ported: {sorted(REGISTRY)}")
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["ArchDef", "ShapeCell", "REGISTRY", "NOT_PORTED", "get_arch"]
