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

``window`` (the sliding-window variant) masks key ``j`` for the query at
``p`` unless ``p − j < window``, and every route skips the key tiles
wholly below a block's window: a decode step far into a long cache reads
about ``window`` keys, not the whole cache.

A decode call (``Sq * H / Hkv <= 16`` flattened rows) is one launch of
the split-KV route: :func:`decode_splits` cuts its key tiles into
``n_split`` runs, each split writes a partial into a workspace from the
caching allocator (``torch.empty``: no launch), and the last block of each
(batch, KV head) merges them, found by a ticket on a counter.  The
counters are one zeroed int32 buffer per (device, stream), made once and
kept; the kernel leaves them zero.  Keyed by stream, they are never shared
by two calls in flight at once: calls on one stream run in order.

:func:`flash_attention_bwd_cuda` is K6's backward, `csrc/flash_attention_bwd.cu`
(a library of its own, built in parallel with the forward's): dq, dk and
dv of the same function, in two launches (dQ, then dK and dV), with the
rows' statistics in a workspace from the caching allocator.  bf16 at D =
64 and 128 (`takes_stats`) takes the forward's output and its rows'
logsumexp, which ``flash_attention_cuda(..., return_lse=True)`` gives
(the bf16 prefill route whatever the rows), and recomputes nothing; every
other call recomputes the softmax statistics.  ``BACKWARD_LAUNCHES``
counts its calls (each launches its two grids), apart from ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")

LAUNCHES = 0          # K6 launches since the last reset (callers reset)
BACKWARD_LAUNCHES = 0  # K6 backward calls since the last reset
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1  # sizes, q_offset and kv_len ride C ints
_GRID_MAX = 65535     # Hkv and B are the grid's y and z
DECODE_ROWS = 16      # Sq * G at most: the split-KV decode route
KEY_TILE = 64         # keys per KV tile
MAX_SPLITS = 256      # the kernel's bound on n_split
BLOCKS_PER_SM = 1     # the decode grid's aim (fewer, longer runs merge faster)
_lib = None
_lib_bwd = None
_sm_count: dict[int, int] = {}
_counters: dict[tuple[int, int], torch.Tensor] = {}


def build():
    """Compile the kernel's library if needed: its path and the compiler's
    register report (see `_build.build`)."""
    return _build.build(SOURCE)


def build_backward():
    """Compile the backward's library if needed (see `build`)."""
    return _build.build(BWD_SOURCE)


def _load():
    global _lib
    if _lib is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _lib = _build.load(SOURCE, {
            "flash_attention_fwd": [ptr] * 4 + [i32] * 7 + [i64] * 9
            + [i32] * 4 + [ctypes.c_float, ptr, ptr, i32, ptr, ptr],
        })
    return _lib


# the backward's C entry: q, k, v, dout, out, lse, dq, dk, dv, the workspace;
# the type flag, B, Sq, Skv, H, Hkv, D; q's, k's, v's and dout's strides;
# q_offset, kv_len, causal, window; the scale; the stream
BWD_PROTOTYPES = {
    "flash_attention_bwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
    + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
}


def _load_bwd():
    global _lib_bwd
    if _lib_bwd is None:
        _lib_bwd = _build.load(BWD_SOURCE, BWD_PROTOTYPES)
    return _lib_bwd


def takes_stats(dtype: torch.dtype, D: int) -> bool:
    """Whether the backward at this type and head dim is the route that
    reads the forward's output and logsumexp (bf16, D >= 64)."""
    return dtype == torch.bfloat16 and D >= 64


def _check(q, k, v, q_offset: int, kv_len: int, window,
           who: str = "flash_attention_cuda") -> None:
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
    if window is not None and not 1 <= window <= _INT_MAX:
        raise ValueError(f"{who}: window={window} outside [1, {_INT_MAX}]")
    if max(Sq * H, Skv, abs(q_offset) + Sq) > _INT_MAX \
            or max(B, Hkv) > _GRID_MAX:
        raise ValueError(f"{who}: sizes past the kernel's int or grid range")


def decode_tiles(Sq: int, *, causal: bool, q_offset: int, kv_len: int,
                 window: int | None = None) -> tuple[int, int]:
    """The key tiles [t_lo, t_hi) a decode call reads: those below kv_end
    (``kv_len`` and, causally, the last query's position + 1) and, with a
    window, from the tile holding the first query's first visible key
    (``q_offset − window + 1``); the kernel's host entry computes the
    same."""
    kv_end = min(kv_len, q_offset + Sq) if causal else kv_len
    t_hi = -(-max(kv_end, 0) // KEY_TILE)
    first = q_offset - window + 1 if window is not None else 0
    t_lo = first // KEY_TILE if first > 0 else 0
    return t_lo, max(t_lo, t_hi)


def decode_splits(B: int, Hkv: int, Sq: int, *, causal: bool, q_offset: int,
                  kv_len: int, n_sm: int, window: int | None = None) -> int:
    """How many runs the decode route cuts its key tiles (`decode_tiles`)
    into: about ``BLOCKS_PER_SM`` blocks per SM over the ``B * Hkv``
    (batch, KV head) pairs, at least one tile a run, at most
    ``MAX_SPLITS``; then as few runs as give the same tiles per run, so no
    run is empty."""
    t_lo, t_hi = decode_tiles(Sq, causal=causal, q_offset=q_offset,
                              kv_len=kv_len, window=window)
    n_tiles = t_hi - t_lo
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
                         *, causal: bool, q_offset: int, kv_len: int,
                         window: int | None = None, return_lse: bool = False):
    """K6: ``flash_attention_pallas(q, k, v, causal=, q_offset=, kv_len=)``
    on the card, with `repro`'s sliding-window mask where ``window`` is
    given.

    q (B, Sq, H, D), k and v (B, Skv, Hkv, D), float32 or bfloat16, on one
    CUDA device, each with its last dim contiguous (other strides are
    free: a slice of the KV cache goes in as it is).  Returns a contiguous
    (B, Sq, H, D) tensor of q's type; with ``return_lse`` (bf16 at D >= 64
    only: the backward's `takes_stats` route) also each row's logsumexp
    of the scaled, masked scores in log2 units, float32 (B, H, Sq), from
    the bf16 prefill route whatever the rows."""
    global LAUNCHES
    _check(q, k, v, q_offset, kv_len, window)
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if return_lse and not takes_stats(q.dtype, D):
        raise ValueError(f"flash_attention_cuda: return_lse takes bf16 at D "
                         f">= 64 (got {q.dtype}, D={D})")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    ctx, stream = _build.launch_context(q)
    with ctx:
        rows = Sq * (H // Hkv)
        n_split, ws, counters = 1, None, None
        if rows <= DECODE_ROWS and not return_lse:
            n_split = decode_splits(B, Hkv, Sq, causal=causal,
                                    q_offset=q_offset, kv_len=kv_len,
                                    n_sm=_sms(q.device), window=window)
            if n_split > 1:
                ws = torch.empty(B * Hkv * n_split * rows * (D + 2),
                                 dtype=torch.float32, device=q.device)
                counters = _ticket_counters(q.device, stream, B * Hkv)
        rc = _load().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Skv, H, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            q_offset, kv_len, int(causal), window or 0, 1.0 / math.sqrt(D),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), n_split,
            None if lse is None else lse.data_ptr(), stream)
    _build.check_launch("flash_attention_fwd", rc)
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def _check_stats(q, out, lse, who: str) -> None:
    """``out`` and ``lse`` as `flash_attention_cuda(..., return_lse=True)`
    gives them for q: raises on a missing or misshapen one."""
    B, Sq, H, D = q.shape
    if out is None or lse is None:
        raise ValueError(f"{who}: bf16 at D={D} needs the forward's out and "
                         f"lse (flash_attention_cuda(..., return_lse=True))")
    if out.shape != q.shape or out.dtype != q.dtype \
            or out.device != q.device or not out.is_contiguous():
        raise ValueError(f"{who}: out must be contiguous {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}; got {tuple(out.shape)}, "
                         f"{out.dtype}, {out.device}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{who}: lse must be contiguous float32 "
                         f"{(B, H, Sq)} on {q.device}; got "
                         f"{tuple(lse.shape)}, {lse.dtype}, {lse.device}")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool, q_offset: int, kv_len: int,
                             window: int | None = None,
                             out: torch.Tensor | None = None,
                             lse: torch.Tensor | None = None):
    """K6's backward on the card: dq, dk, dv of `flash_attention_cuda`'s
    function at (q, k, v) for the output gradient ``dout``, as
    `ref.flash_attention_grads` computes them.

    Takes what `flash_attention_cuda` takes; ``dout`` is (B, Sq, H, D) of
    q's type on q's device (a head dim that is not contiguous is copied
    first).  bf16 at D >= 64 (`takes_stats`) also takes the forward's
    ``out`` and ``lse`` (`flash_attention_cuda(..., return_lse=True)`) and
    raises without them; every other call raises with them.  Returns
    contiguous dq, dk and dv of the inputs' type and shapes.  Two calls
    on the same inputs give the same bits."""
    global BACKWARD_LAUNCHES
    who = "flash_attention_bwd_cuda"
    _check(q, k, v, q_offset, kv_len, window, who)
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device:
        raise ValueError(f"{who}: dout must match q ({tuple(q.shape)}, "
                         f"{q.dtype}, {q.device}); got {tuple(dout.shape)}, "
                         f"{dout.dtype}, {dout.device}")
    if q.shape[2] > _GRID_MAX:
        raise ValueError(f"{who}: H={q.shape[2]} past the grid's range")
    B, Sq, H, D = q.shape
    saved = takes_stats(q.dtype, D)
    if saved:
        _check_stats(q, out, lse, who)
    elif out is not None or lse is not None:
        raise ValueError(f"{who}: out and lse are taken by bf16 at D >= 64 "
                         f"only (got {q.dtype}, D={D})")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    _, Skv, Hkv, _ = k.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dq.numel() == 0 or dk.numel() == 0:   # no pair: no gradient
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty((1 if saved else 3) * B * H * Sq, dtype=torch.float32,
                        device=q.device)
    ctx, stream = _build.launch_context(q)
    with ctx:
        rc = _load_bwd().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            out.data_ptr() if saved else None,
            lse.data_ptr() if saved else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Skv, H, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3], q_offset, kv_len, int(causal), window or 0,
            1.0 / math.sqrt(D), stream)
    _build.check_launch("flash_attention_bwd", rc)
    BACKWARD_LAUNCHES += 1
    return dq, dk, dv
