"""Loader and launch wrappers for K1 and K2, the hand-written CUDA ELL SpMVs.

`csrc/ell_spmv.cu` is built at first use and loaded with `ctypes` by
`repro_torch.kernels._build` (``nvcc``, ``sm_90a``, a plain C interface,
the library under ``build/repro_torch_kernels/`` named by a hash of the
source).  Nothing here runs at import: the module imports on a machine
with no `nvcc` and no card.

:func:`ell_spmv_cuda` (K1) and :func:`ell_spmv_batched_cuda` (K2) check
devices, types, shapes and contiguity, raise on anything the kernel does
not take, launch on the current stream and raise if the launch returned a
CUDA error.  ``LAUNCHES`` counts K1's launches and ``BATCHED_LAUNCHES``
K2's (and nothing else), so a run can show that it went through them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ell_spmv.cu"

LAUNCHES = 0          # K1 launches since the last reset (callers reset)
BATCHED_LAUNCHES = 0  # K2 launches since the last reset
_FUNCS = {torch.float32: "ell_spmv_f32", torch.bfloat16: "ell_spmv_bf16"}
_BATCHED_FUNCS = {torch.float32: "ell_spmv_batched_f32",
                  torch.bfloat16: "ell_spmv_batched_bf16"}
_MAX_GRID_Y = 65535   # CUDA's limit on gridDim.y, K2's problem axis
_lib = None


def build():
    """Compile the kernels' library if needed: its path and the compiler's
    register report (see `_build.build`)."""
    return _build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        ptr = ctypes.c_void_p
        sigs = {name: [ptr] * 4 + [ctypes.c_longlong, ctypes.c_int, ptr]
                for name in _FUNCS.values()}
        sigs.update({name: [ptr] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                        ctypes.c_int, ptr]
                     for name in _BATCHED_FUNCS.values()})
        _lib = _build.load(SOURCE, sigs)
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
    ctx, stream = _build.launch_context(x)
    with ctx:
        rc = fn(cols_t.data_ptr(), vals_t.data_ptr(), x.data_ptr(),
                y.data_ptr(), n, w, stream)
    _build.check_launch("ell_spmv_cuda", rc)
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
    ctx, stream = _build.launch_context(x)
    with ctx:
        rc = fn(cols_t.data_ptr(), vals_t.data_ptr(), x.data_ptr(),
                y.data_ptr(), B, n, w, stream)
    _build.check_launch("ell_spmv_batched_cuda", rc)
    BATCHED_LAUNCHES += 1
    return y
