"""Loader and launch wrapper for K6, the hand-written CUDA flash attention.

`csrc/flash_attention.cu` is built at first use and loaded with `ctypes` by
`repro_torch.kernels._build` (``nvcc``, ``sm_90a``, a plain C interface,
the library under ``build/repro_torch_kernels/`` named by a hash of the
source).  Nothing here runs at import: the module imports on a machine
with no `nvcc` and no card.

:func:`flash_attention_cuda` checks devices, types, shapes and strides,
raises on anything the kernel does not take, launches on the current
stream and raises if the launch returned a CUDA error.  ``LAUNCHES`` counts
its launches (and nothing else), so a run can show that it went through
K6.

A decode call (``Sq * H / Hkv <= 16`` flattened rows) is one launch of
the split-KV route: :func:`decode_splits` cuts its key tiles into
``n_split`` runs, each split writes a partial into a workspace from the
caching allocator (``torch.empty``: no launch), and the last block of each
(batch, KV head) merges them, found by a ticket on a counter.  The
counters are one zeroed int32 buffer per (device, stream), made once and
kept; the kernel leaves them zero.  Keyed by stream, they are never shared
by two calls in flight at once: calls on one stream run in order.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

LAUNCHES = 0          # K6 launches since the last reset (callers reset)
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1  # sizes, q_offset and kv_len ride C ints
_GRID_MAX = 65535     # Hkv and B are the grid's y and z
DECODE_ROWS = 16      # Sq * G at most: the split-KV decode route
KEY_TILE = 64         # keys per KV tile
MAX_SPLITS = 256      # the kernel's bound on n_split
BLOCKS_PER_SM = 1     # the decode grid's aim (fewer, longer runs merge faster)
_lib = None
_sm_count: dict[int, int] = {}
_counters: dict[tuple[int, int], torch.Tensor] = {}


def build():
    """Compile the kernel's library if needed: its path and the compiler's
    register report (see `_build.build`)."""
    return _build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _lib = _build.load(SOURCE, {
            "flash_attention_fwd": [ptr] * 4 + [i32] * 7 + [i64] * 9
            + [i32] * 3 + [ctypes.c_float, ptr, ptr, i32, ptr],
        })
    return _lib


def _check(q, k, v, q_offset: int, kv_len: int) -> None:
    who = "flash_attention_cuda"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{who}: {name} is on {t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError(f"{who}: tensors on different devices")
        if t.ndim != 4:
            raise ValueError(f"{who}: {name} must be 4-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{who}: {name}'s head dim is not contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{who}: q, k, v must share float32 or bfloat16 "
                        f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{who}: need q (B, Sq, H, D), k and v (B, Skv, Hkv, "
                         f"D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{who}: H={H} is not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{who}: head dim {D} not in {HEAD_DIMS}")
    if not 0 <= kv_len <= Skv:
        raise ValueError(f"{who}: kv_len={kv_len} outside [0, Skv={Skv}]")
    if max(Sq * H, Skv, abs(q_offset) + Sq) > _INT_MAX \
            or max(B, Hkv) > _GRID_MAX:
        raise ValueError(f"{who}: sizes past the kernel's int or grid range")


def decode_splits(B: int, Hkv: int, Sq: int, *, causal: bool, q_offset: int,
                  kv_len: int, n_sm: int) -> int:
    """How many runs the decode route cuts its key tiles into: about
    ``BLOCKS_PER_SM`` blocks per SM over the ``B * Hkv`` (batch, KV head)
    pairs, at least one tile a run, at most ``MAX_SPLITS``; then as few runs
    as give the same tiles per run, so no run is empty.  The tiles are those
    below kv_end: ``kv_len`` and, causally, the last query's position + 1."""
    kv_end = min(kv_len, q_offset + Sq) if causal else kv_len
    n_tiles = -(-max(kv_end, 0) // KEY_TILE)
    want = -(-BLOCKS_PER_SM * n_sm // (B * Hkv))
    n = max(1, min(n_tiles, want, MAX_SPLITS))
    per = -(-n_tiles // n)
    return -(-n_tiles // per) if n_tiles else 1


def _sms(device: torch.device) -> int:
    """The SM count of ``device`` (a tensor's: its index is set), cached."""
    if device.index not in _sm_count:
        _sm_count[device.index] = torch.cuda.get_device_properties(
            device.index).multi_processor_count
    return _sm_count[device.index]


def _ticket_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The zeroed int32 ticket counters of ``stream`` on ``device``, at least
    ``n`` of them (a larger buffer replaces a smaller one, zeroed on the
    same stream, so it is ready before the next launch there)."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, q_offset: int,
                         kv_len: int) -> torch.Tensor:
    """K6: ``flash_attention_pallas(q, k, v, causal=, q_offset=, kv_len=)``
    on the card.

    q (B, Sq, H, D), k and v (B, Skv, Hkv, D), float32 or bfloat16, on one
    CUDA device, each with its last dim contiguous (other strides are
    free: a slice of the KV cache goes in as it is).  Returns a contiguous
    (B, Sq, H, D) tensor of q's type."""
    global LAUNCHES
    _check(q, k, v, q_offset, kv_len)
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    ctx, stream = _build.launch_context(q)
    with ctx:
        rows = Sq * (H // Hkv)
        n_split, ws, counters = 1, None, None
        if rows <= DECODE_ROWS:
            n_split = decode_splits(B, Hkv, Sq, causal=causal,
                                    q_offset=q_offset, kv_len=kv_len,
                                    n_sm=_sms(q.device))
            if n_split > 1:
                ws = torch.empty(B * Hkv * n_split * rows * (D + 2),
                                 dtype=torch.float32, device=q.device)
                counters = _ticket_counters(q.device, stream, B * Hkv)
        rc = _load().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Skv, H, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            q_offset, kv_len, int(causal), 1.0 / math.sqrt(D),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), n_split,
            stream)
    _build.check_launch("flash_attention_fwd", rc)
    LAUNCHES += 1
    return out
