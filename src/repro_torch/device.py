"""Where the port's device work runs.

Every entry point takes ``device=None``, which means the card
(``"cuda"``).  Without a card the call raises unless the caller asked for
the CPU explicitly (``device="cpu"``, as the tests do): the port never
carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise when a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
