"""Loader and launch wrappers for K3 and K4, the hand-written CUDA connection
tables.

`csrc/segment_sum.cu` is built at first use and loaded with `ctypes` by
`repro_torch.kernels._build` (``nvcc``, ``sm_90a``, a plain C interface,
the library under ``build/repro_torch_kernels/`` named by a hash of the
source).  Nothing here runs at import: the module imports on a machine
with no `nvcc` and no card.

:func:`connection_table_cuda` (K3) and :func:`connection_table_batched_cuda`
(K4) check devices, types, shapes and contiguity, raise on anything the
kernel does not take, launch on the current stream and raise if the launch
returned a CUDA error.  ``LAUNCHES`` counts K3's launches and
``BATCHED_LAUNCHES`` K4's (and nothing else), so a run can show that it
went through them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_sum.cu"

LAUNCHES = 0          # K3 launches since the last reset (callers reset)
BATCHED_LAUNCHES = 0  # K4 launches since the last reset
_INT_MAX = 2**31 - 1  # w, nparts and G ride C ints
_lib = None


def build():
    """Compile the kernels' library if needed: its path and the compiler's
    register report (see `_build.build`)."""
    return _build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _lib = _build.load(SOURCE, {
            "segment_sum_f32": [ptr] * 4 + [i64, i32, i64, i32, ptr],
            "segment_sum_batched_f32": [ptr] * 4 + [i32, i64, i32, i64, i32,
                                                    ptr],
        })
    return _lib


def _check(who: str, labels, cols, wts, nparts: int, nd: int) -> None:
    """Devices, types, ranks and shapes the kernels take: ``nd`` is 2 for K3
    (labels (m,), cols/wts (B, w)) and 3 for K4 (labels (G, m), cols/wts
    (G, B, w))."""
    for name, t in (("labels", labels), ("cols", cols), ("wts", wts)):
        if not t.is_cuda:
            raise ValueError(f"{who}: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.device != cols.device:
            raise ValueError(f"{who}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
    if labels.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError(f"{who}: labels and cols must be int32 "
                        f"(got {labels.dtype}, {cols.dtype})")
    if wts.dtype != torch.float32:
        raise TypeError(f"{who}: wts must be float32, not {wts.dtype}")
    if cols.ndim != nd or wts.shape != cols.shape or labels.ndim != nd - 1 \
            or labels.shape[:-1] != cols.shape[:-2]:
        lead = "labels (G, m), cols/wts (G, B, w)" if nd == 3 \
            else "labels (m,), cols/wts (B, w)"
        raise ValueError(f"{who}: need {lead} (got {tuple(labels.shape)}, "
                         f"{tuple(cols.shape)}, {tuple(wts.shape)})")
    if not 0 <= nparts <= _INT_MAX or cols.shape[-1] > _INT_MAX \
            or (nd == 3 and cols.shape[0] > _INT_MAX):
        raise ValueError(f"{who}: nparts, w or G past the kernel's int range")


def _launch(fn, labels, cols, wts, out, lead, nparts: int) -> None:
    B, w = cols.shape[-2:]
    ctx, stream = _build.launch_context(cols)
    with ctx:
        rc = fn(labels.data_ptr(), cols.data_ptr(), wts.data_ptr(),
                out.data_ptr(), *lead, B, w, labels.shape[-1], nparts, stream)
    _build.check_launch(fn.__name__, rc)


def connection_table_cuda(labels: torch.Tensor, cols: torch.Tensor,
                          wts: torch.Tensor, nparts: int) -> torch.Tensor:
    """K3: ``out[i, q] = Σ_k wts[i, k] · [labels[cols[i, k]] == q]`` on the
    card.

    labels: (m,) int32; cols: (B, w) int32 in [0, m); wts: (B, w) float32;
    all contiguous on one CUDA device (views with a storage offset are
    taken: the kernel handles any 4-byte alignment).  Returns (B, nparts)
    float32."""
    global LAUNCHES
    _check("connection_table_cuda", labels, cols, wts, nparts, 2)
    B, w = cols.shape
    if B == 0 or w == 0 or nparts == 0:
        return torch.zeros((B, nparts), dtype=torch.float32, device=cols.device)
    out = torch.empty((B, nparts), dtype=torch.float32, device=cols.device)
    _launch(_load().segment_sum_f32, labels, cols, wts, out, (), nparts)
    LAUNCHES += 1
    return out


def connection_table_batched_cuda(labels: torch.Tensor, cols: torch.Tensor,
                                  wts: torch.Tensor,
                                  nparts: int) -> torch.Tensor:
    """K4: ``out[g, i, q] = Σ_k wts[g, i, k] · [labels[g, cols[g, i, k]] ==
    q]`` on the card, every problem g in one launch.

    labels: (G, m) int32; cols: (G, B, w) int32 in [0, m); wts: (G, B, w)
    float32; all contiguous on one CUDA device (views with a storage offset
    are taken, as in K3).  Returns (G, B, nparts) float32."""
    global BATCHED_LAUNCHES
    _check("connection_table_batched_cuda", labels, cols, wts, nparts, 3)
    G, B, w = cols.shape
    if G == 0 or B == 0 or w == 0 or nparts == 0:
        return torch.zeros((G, B, nparts), dtype=torch.float32,
                           device=cols.device)
    out = torch.empty((G, B, nparts), dtype=torch.float32, device=cols.device)
    _launch(_load().segment_sum_batched_f32, labels, cols, wts, out, (G,),
            nparts)
    BATCHED_LAUNCHES += 1
    return out
