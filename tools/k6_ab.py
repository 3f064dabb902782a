#!/usr/bin/env python3
"""K6's bf16 device time at the serve shapes, for one or more checkouts.

    python3 tools/k6_ab.py ROOT [ROOT ...]     # needs one CUDA card

Each ROOT is a checkout of this repository (a ``git archive`` of another
commit unpacked into a git-ignored directory, say).  Every ROOT runs in a
process of its own, in the order given, so a comparison of two commits on
one card reads ``parent change change parent``.  Each prints one JSON line:
the root, and for the bf16 cases ``prefill``, ``long_prefill``,
``continuation``, ``decode`` and ``long_decode`` of chip_smoke.py's
FLASH_CASES the profiler's device ms per launch of the K6 kernel, the
kernel's name and a digest of the output's bits (two checkouts whose
digests agree gave the same output).  Each checkout builds its own K6 library under its own
``build/``.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CASES = ("prefill", "long_prefill", "continuation", "decode", "long_decode")


def one(root: str) -> dict:
    """The measurement for the checkout ``root``, in this process."""
    sys.path.insert(0, str(Path(root) / "src"))
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import cuda as fa

    assert Path(fa.__file__).resolve().is_relative_to(Path(root).resolve())
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    out = {"root": root, "device": cs.nvidia_smi()}
    for case in CASES:
        B, Sq, Skv, H, Hkv, D, qo, kl, causal = cs.FLASH_CASES[case]
        kl = Skv if kl is None else kl
        qo = kl - Sq if qo is None else qo
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .cuda().bfloat16()
                   for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))

        def call():
            return fa.flash_attention_cuda(q, k, v, causal=causal,
                                           q_offset=qo, kv_len=kl)

        o = call()
        torch.cuda.synchronize()
        digest = hashlib.sha256(o.view(torch.int16).cpu().numpy().tobytes())
        ms, _, name = cs.profiled_ms(call, "flash_attention_kernel")
        out[case] = {"dev_ms": ms, "kernel": name,
                     "digest": digest.hexdigest()[:16]}
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, __file__, "--one", root],
                             check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
