#!/usr/bin/env python3
"""chip_smoke.py's ``serve`` and ``serve_moe`` phases, or the phases
named, for one or more checkouts.

    python3 tools/serve_ab.py ROOT [ROOT ...]      # needs one CUDA card
    python3 tools/serve_ab.py --phases serve,recsys ROOT [ROOT ...]

Each ROOT is a checkout of this repository (a ``git archive`` of another
commit unpacked into a git-ignored directory, say).  Every ROOT runs in a
process of its own, in the order given, so a comparison of two commits on
one card reads ``parent change change parent``.  Each imports its own
``chip_smoke.py`` and package, builds its own K6 and K5 under its own
``build/``, sets the torch options of chip_smoke's ``main`` (no TF32) and
runs ``phase_serve`` and then ``phase_serve_moe`` (or ``phase_<name>``
of each name given, in order) as that checkout's script does, their
checks included.  Their JSON lines are printed as they
come, after a line ``{"root": ROOT}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path


def one(root: str, phases: list[str]) -> None:
    """The ``phases`` of the checkout ``root``, in this process."""
    root_path = Path(root).resolve()
    os.chdir(root_path)
    sys.path[:0] = [str(root_path / "src"), str(root_path)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.flash_attention import cuda as fa_cuda

    assert Path(cs.__file__).resolve().is_relative_to(root_path)
    assert Path(fa_cuda.__file__).resolve().is_relative_to(root_path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"root": root, "device": cs.nvidia_smi()}), flush=True)
    fa_cuda.build()
    eb_cuda.build()
    for name in phases:
        getattr(cs, f"phase_{name}")()


def main(argv: list[str]) -> int:
    phases = "serve,serve_moe"
    if argv[:1] == ["--phases"]:
        phases, argv = argv[1], argv[2:]
    if len(argv) == 2 and argv[0] == "--one":
        one(argv[1], phases.split(","))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--phases", phases, "--one", root],
                             check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
