"""Loader and launch wrappers for K1 and K2, the hand-written CUDA ELL SpMVs.

`csrc/ell_spmv.cu` is compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into a shared library with a plain C
interface under ``build/repro_torch_kernels/`` at the repository root, and
loaded with `ctypes` (pointers and the stream go in as ``c_void_p``).  The
library's file name carries a hash of the source, so an edited kernel is
rebuilt and a stale build is never loaded.  Nothing here runs at import:
the module imports on a machine with no `nvcc` and no card.

:func:`ell_spmv_cuda` (K1) and :func:`ell_spmv_batched_cuda` (K2) check
devices, types, shapes and contiguity, raise on anything the kernel does
not take, launch on the current stream and raise if the launch returned a
CUDA error.  ``LAUNCHES`` counts K1's launches and ``BATCHED_LAUNCHES``
K2's (and nothing else), so a run can show that it went through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "ell_spmv.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = 0          # K1 launches since the last reset (callers reset)
BATCHED_LAUNCHES = 0  # K2 launches since the last reset
_FUNCS = {torch.float32: "ell_spmv_f32", torch.bfloat16: "ell_spmv_bf16"}
_BATCHED_FUNCS = {torch.float32: "ell_spmv_batched_f32",
                  torch.bfloat16: "ell_spmv_batched_bf16"}
_MAX_GRID_Y = 65535   # CUDA's limit on gridDim.y, K2's problem axis
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA ELL "
                           "SpMV kernel cannot be built")
    return found


def build() -> tuple[Path, str]:
    """Compile the kernel if its library is not built yet.

    Returns the library path and the compiler's report (``-Xptxas -v``:
    registers, shared memory and spills per kernel; empty when the library
    was already built)."""
    tag = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libell_spmv_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


def _load():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name in _FUNCS.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in _BATCHED_FUNCS.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(who: str, cols_t, vals_t, x, nd: int) -> None:
    """Devices, types, ranks and shapes the kernels take: ``nd`` is 2 for
    K1 ((w, n) slabs, x (n,)) and 3 for K2 ((B, w, n) slabs, x (B, n))."""
    for name, t in (("cols_t", cols_t), ("vals_t", vals_t), ("x", x)):
        if not t.is_cuda:
            raise ValueError(f"{who}: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.device != x.device:
            raise ValueError(f"{who}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
    if cols_t.dtype != torch.int32:
        raise TypeError(f"{who}: cols_t must be int32, not {cols_t.dtype}")
    if vals_t.dtype not in _FUNCS or x.dtype != vals_t.dtype:
        raise TypeError(f"{who}: vals_t and x must both be float32 or "
                        f"both bfloat16 (got {vals_t.dtype}, {x.dtype})")
    if cols_t.ndim != nd or vals_t.shape != cols_t.shape \
            or x.shape != cols_t.shape[:-2] + cols_t.shape[-1:]:
        lead = "(B, w, n) and x (B, n)" if nd == 3 else "(w, n) and x (n,)"
        raise ValueError(f"{who}: need cols_t/vals_t {lead} "
                         f"(got {tuple(cols_t.shape)}, {tuple(vals_t.shape)}, "
                         f"{tuple(x.shape)})")


def ell_spmv_cuda(cols_t: torch.Tensor, vals_t: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """K1: ``y[i] = Σ_k vals_t[k, i] · x[cols_t[k, i]]`` on the card.

    cols_t: (w, n) int32; vals_t: (w, n) float32 or bfloat16; x: (n,) of
    vals_t's type; all contiguous on one CUDA device.  Column ids must lie
    in [0, n): the kernel does not check them."""
    global LAUNCHES
    _check("ell_spmv_cuda", cols_t, vals_t, x, 2)
    w, n = cols_t.shape
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    fn = getattr(_load(), _FUNCS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(cols_t.data_ptr(), vals_t.data_ptr(), x.data_ptr(),
                y.data_ptr(), n, w, stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmv_cuda: launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return y


def ell_spmv_batched_cuda(cols_t: torch.Tensor, vals_t: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """K2: ``y[b, i] = Σ_k vals_t[b, k, i] · x[b, cols_t[b, k, i]]`` on the
    card.

    cols_t: (B, w, n) int32; vals_t: (B, w, n) float32 or bfloat16; x:
    (B, n) of vals_t's type; all contiguous on one CUDA device; B at most
    65535.  Column ids are per problem and must lie in [0, n): the kernel
    does not check them."""
    global BATCHED_LAUNCHES
    _check("ell_spmv_batched_cuda", cols_t, vals_t, x, 3)
    B, w, n = cols_t.shape
    if B > _MAX_GRID_Y:
        raise ValueError(f"ell_spmv_batched_cuda: B = {B} problems exceed "
                         f"the grid's {_MAX_GRID_Y}")
    y = torch.empty((B, n), dtype=x.dtype, device=x.device)
    if B == 0 or n == 0:
        return y
    fn = getattr(_load(), _BATCHED_FUNCS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(cols_t.data_ptr(), vals_t.data_ptr(), x.data_ptr(),
                y.data_ptr(), B, n, w, stream)
    if rc != 0:
        raise RuntimeError(
            f"ell_spmv_batched_cuda: launch failed with CUDA error {rc}")
    BATCHED_LAUNCHES += 1
    return y
