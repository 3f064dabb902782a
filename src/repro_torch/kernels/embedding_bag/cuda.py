"""Loader and launch wrapper for K5, the hand-written CUDA embedding bag.

`csrc/embedding_bag.cu` is built at first use and loaded with `ctypes` by
`repro_torch.kernels._build` (``nvcc``, ``sm_90a``, a plain C interface,
the library under ``build/repro_torch_kernels/`` named by a hash of the
source).  Nothing here runs at import: the module imports on a machine
with no `nvcc` and no card.

:func:`embedding_bag_cuda` checks devices, types, ranks and contiguity,
raises on anything the kernel does not take, launches on the current
stream and raises if the launch returned a CUDA error.  With ``split``
it allocates the workspace of the split launch (a long bag's runs summed
by many warps at once, two kernels on the stream).  ``LAUNCHES`` counts
its calls that launch (and nothing else), so a run can show that it went
through K5.  :func:`run_shape` reads the kernel's run and group sizes (R,
G) from its source: a bag of more than R entries is summed in runs of R
(`ref.embedding_bag_runs_ref`).
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"

LAUNCHES = 0          # K5 launches since the last reset (callers reset)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1  # bag ids ride int32, d a C int
_lib = None


def build():
    """Compile the kernel's library if needed: its path and the compiler's
    register report (see `_build.build`)."""
    return _build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _lib = _build.load(SOURCE, {
            "embedding_bag_fwd": [ptr] * 7 + [i64, i32, i64, i64, i32,
                                                 ptr],
        })
    return _lib


@functools.cache
def _constants(source: Path) -> dict:
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", source.read_text())}


def run_shape() -> tuple[int, int]:
    """(R, G): the kernel's entries a run of a long bag and runs a group
    of its combine (``kRun``, ``kGroup`` in the source)."""
    c = _constants(SOURCE)
    return c["kRun"], c["kGroup"]


def _check(table, indices, segments, weights, n_bags: int) -> None:
    who = "embedding_bag_cuda"
    for name, t in (("table", table), ("indices", indices),
                    ("segments", segments), ("weights", weights)):
        if not t.is_cuda:
            raise ValueError(f"{who}: {name} is on {t.device}, not a CUDA device")
        if t.device != table.device:
            raise ValueError(f"{who}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
    if table.dtype not in _DTYPES or weights.dtype != table.dtype:
        raise TypeError(f"{who}: table and weights must share float32 or "
                        f"bfloat16 (got {table.dtype}, {weights.dtype})")
    if indices.dtype != torch.int32 or segments.dtype != torch.int32:
        raise TypeError(f"{who}: indices and segments must be int32 (got "
                        f"{indices.dtype}, {segments.dtype})")
    if table.ndim != 2 or indices.ndim != 1 \
            or segments.shape != indices.shape \
            or weights.shape != indices.shape:
        raise ValueError(f"{who}: need table (V, d) and indices, segments, "
                         f"weights (nnz,); got {tuple(table.shape)}, "
                         f"{tuple(indices.shape)}, {tuple(segments.shape)}, "
                         f"{tuple(weights.shape)}")
    if not 0 <= n_bags <= _INT_MAX or table.shape[1] > _INT_MAX:
        raise ValueError(f"{who}: n_bags={n_bags} or d={table.shape[1]} "
                         "past the kernel's int range")


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       segments: torch.Tensor, weights: torch.Tensor,
                       n_bags: int, *, split: bool = False) -> torch.Tensor:
    """K5: ``out[b] = Σ_{segments[i] = b} weights[i] · table[indices[i]]``
    on the card, summed in fp32 and rounded once: a bag of at most R
    entries in nnz order, a longer one in runs of R (`run_shape`; the order
    of `ref.embedding_bag_runs_ref`).

    table (V, d) float32 or bfloat16; indices (nnz,) int32 in [0, V) (not
    checked: a scan would cost a pass over them); segments (nnz,) int32,
    sorted ascending, in [0, n_bags); weights (nnz,) of the table's type;
    all contiguous on one CUDA device.  Returns (n_bags, d) of the table's
    type; an empty bag is a zero row.  ``split``: a long bag's runs are
    summed by many warps at once and then combined (two kernels, a
    workspace of 2·ceil(nnz / R) fp32 rows); else the warp that owns a bag
    sums all of it (one kernel).  The bits are the same either way."""
    global LAUNCHES
    _check(table, indices, segments, weights, n_bags)
    d, nnz = table.shape[1], indices.shape[0]
    out = torch.empty((n_bags, d), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    run, _ = run_shape()
    slots, part, rec = 0, None, None     # the split's workspace
    if split and nnz > run:              # else no bag can be long
        slots = -(-nnz // run)
        part = torch.empty((2 * slots, d), dtype=torch.float32,
                           device=table.device)
        rec = torch.empty((2 * slots,), dtype=torch.int64,
                          device=table.device)
    ctx, stream = _build.launch_context(table)
    with ctx:
        rc = _load().embedding_bag_fwd(
            table.data_ptr(), indices.data_ptr(), segments.data_ptr(),
            weights.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if rec is None else rec.data_ptr(), slots,
            _DTYPES[table.dtype], nnz, n_bags, d, stream)
    _build.check_launch("embedding_bag_fwd", rc)
    LAUNCHES += 1
    return out
