"""Build and load a hand-written CUDA kernel library (shared by every kernel
package).

A ``csrc/*.cu`` source with a plain C interface is compiled at first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
under ``build/repro_torch_kernels/`` at the repository root, and loaded
with `ctypes` (pointers and the stream go in as ``c_void_p``).  The
library's file name carries a hash of the source, so an edited kernel is
rebuilt and a stale build is never loaded.  Nothing here runs at import:
the module imports on a machine with no `nvcc` and no card.

:func:`launch_context` is every wrapper's one way to pick the device and
the stream a launch goes on.  Every fault of the toolchain or of a launch
raises one type, :class:`KernelError`: a missing ``nvcc``, a failed build,
a library that does not load and a launch that returns an error
(:func:`check_launch`).  The guard's catches (`guard/policy.py`,
`dist/refine_sharded.py`) let it through, so no fallback hides a broken
kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelError(RuntimeError):
    """A hand-written kernel could not be built, loaded or launched."""


def check_launch(name: str, rc: int) -> None:
    """Raise :class:`KernelError` when a launch returned a CUDA error."""
    if rc != 0:
        raise KernelError(f"{name}: launch failed with CUDA error {rc}")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                          "cannot be built")
    return found


def build(source: Path) -> tuple[Path, str]:
    """Compile ``source`` if its library is not built yet.

    Returns the library path and the compiler's report (``-Xptxas -v``:
    registers, shared memory and spills per kernel; empty when the library
    was already built)."""
    tag = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed ({proc.returncode}) on {source.name}:"
                          f"\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


def load(source: Path, signatures: dict) -> ctypes.CDLL:
    """Build ``source`` if needed and load it; ``signatures`` maps each
    exported C function to its ``argtypes`` (every one returns the launch's
    ``cudaGetLastError()`` as an int)."""
    path, _ = build(source)
    try:
        lib = ctypes.CDLL(str(path))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    except (OSError, AttributeError) as exc:
        raise KernelError(f"cannot load {path.name}: {exc}") from exc
    return lib


def launch_context(t: torch.Tensor):
    """The device context to launch in and the raw handle of the current
    stream of ``t``'s device.  The context switches devices only where
    ``t``'s device is not the current one, so the common call costs the
    host no switch: ``ctx, stream = launch_context(t)``, then launch under
    ``with ctx:``."""
    index = t.get_device()
    ctx = contextlib.nullcontext() if index == torch.cuda.current_device() \
        else torch.cuda.device(index)
    return ctx, torch._C._cuda_getCurrentRawStream(index)
