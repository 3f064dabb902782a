"""Configurations: the paper's parRSB workload and pipeline presets
(`parrsb`), and the architecture registry (`--arch <id>` resolves here).

The registry holds the architectures the port runs: ``tinyllama-1.1b``
(serving) and ``sasrec`` (serving and retrieval).  Every other arch id of
`repro`'s registry raises `KeyError` naming it as not ported yet (ROADMAP
slice D).
"""

from repro_torch.configs import sasrec, tinyllama_1_1b
from repro_torch.configs.base import ArchDef, ShapeCell

REGISTRY = {m.ARCH.arch_id: m.ARCH for m in (tinyllama_1_1b, sasrec)}

# `repro`'s other arch ids, each waiting for its slice.
NOT_PORTED = ("deepseek-moe-16b", "qwen3-moe-30b-a3b", "mistral-large-123b",
              "command-r-35b", "mace", "nequip", "graphcast", "meshgraphnet")


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet; ported: "
                       f"{sorted(REGISTRY)}")
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["ArchDef", "ShapeCell", "REGISTRY", "NOT_PORTED", "get_arch"]
