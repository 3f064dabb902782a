"""Public dispatch for K6, causal GQA flash attention.

``prefer``:

* ``"auto"`` (default) — the CUDA kernel for CUDA tensors, the plain
  PyTorch version (`ref.flash_attention_plain`) for CPU tensors;
* ``"cuda"`` — the CUDA kernel; raises for a CPU tensor;
* ``"ref"`` — the plain version on any device.

There is no fallback: on a CUDA tensor a build or launch failure raises.
K6 masks the ragged edge of its tiles itself, so nothing is padded here.

Gradients.  Where q, k or v requires a gradient (and grad mode is on), a
call that takes the kernel (or, on the CPU, its plain version) goes
through :class:`FlashAttention`, a `torch.autograd.Function`.  On the card
at bf16 and D >= 64 (`saves_stats`) its forward is the bf16 prefill with
its rows' logsumexp (``torch.ops.repro_torch.flash_attention_lse``; a
decode-shaped call too) and it saves q, k, v, the output and the
logsumexp; elsewhere its forward is the call above and it saves q, k and
v.  Its backward is K6's backward kernel on a CUDA tensor
(`cuda.flash_attention_bwd_cuda`: dQ, then dK and dV, in a fixed order;
with the saved output and logsumexp nothing is recomputed) and
`ref.flash_attention_grads`, the attention recomputed in plain torch block
of queries by block, on a CPU one.  A build or launch fault raises;
nothing falls back to the plain gradient on the card, and a saved
logsumexp that is missing or misshapen raises.  `repro` trains through
its pure-JAX attention under ``jax.checkpoint`` (its Pallas kernel has no
backward), so the backward kernel replaces the port's plain recompute,
not a TPU kernel.
``prefer="ref"`` differentiates the plain version directly.

The dry run.  The kernel route and the CPU route are also one operator,
``torch.ops.repro_torch.flash_attention`` (a `torch.library.custom_op`:
the kernel on a CUDA tensor, the plain version on a CPU one, the same
calls as before; taken only on ``meta`` tensors or under a dispatch
mode), with a shape rule for ``meta`` tensors and a FLOP formula (:func:`kernel_flops`) registered with
`torch.utils.flop_counter`: the work the kernel's tile loops do, so a
``meta`` step (`repro_torch.launch.dryrun`) and `FlopCounterMode` on the
card count what K6 runs, the causal and window-masked tiles it skips
left out.  :func:`kernel_bytes` is its traffic for the dry run's byte
count; ``flash_attention_lse``, the forward under autograd at bf16 and D
>= 64, has both too (the prefill route's tiles).  The backward is one
operator too, ``torch.ops.repro_torch.flash_attention_backward``, taken in
the same places, with a shape rule, :func:`backward_flops` (the pairs of
the tiles its two launches multiply, on the route the call takes) and
:func:`backward_bytes`.  A ``meta`` tensor stands for a CUDA one: it takes
the route the card would.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import is_in_torch_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import cuda
from repro_torch.kernels.flash_attention.ref import (
    TILE,
    flash_attention_grads,
    flash_attention_lse2,
    flash_attention_plain,
    key_tiles,
)

_PREFER = ("auto", "cuda", "ref")


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         q_offset: int, kv_len: int, window: int | None) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_len=kv_len,
                                     window=window)
    return cuda.flash_attention_cuda(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_len=kv_len,
                                     window=window)


_k6 = torch.library.custom_op("repro_torch::flash_attention",
                              mutates_args=())(_run)


@_k6.register_fake
def _k6_shape(q, k, v, causal, q_offset, kv_len, window):
    """The kernel's output: a contiguous (B, Sq, H, D) tensor of q's
    type."""
    return q.new_empty(q.shape)


def _forward(q, k, v, causal, q_offset, kv_len, window):
    """`_run` through the operator only where a ``meta`` tensor or a
    dispatch mode (the dry run's meter, `FlopCounterMode`) has to see K6;
    else called directly, so a launch-bound decode step pays no
    operator dispatch."""
    if q.is_meta or is_in_torch_dispatch_mode():
        return torch.ops.repro_torch.flash_attention(q, k, v, causal,
                                                     q_offset, kv_len, window)
    return _run(q, k, v, causal, q_offset, kv_len, window)


PREFILL_ROWS = {torch.float32: 64, torch.bfloat16: 128}   # rows a block
_WARP_ROWS = 16        # the bf16 prefill: 8 warps of 16 rows a block


def _block_tiles(r0, R, rows, G, q_offset, kv_len, causal, window):
    """A prefill block's key tiles [j0, nkv): from the tile holding its
    first row's first visible key to its last row's causal end."""
    T = cuda.KEY_TILE
    kv_end = kv_len
    if causal:
        kv_end = min(kv_end, q_offset + min(rows - 1, r0 + R - 1) // G + 1)
    j0 = 0
    if window is not None:
        first = q_offset + r0 // G - window + 1
        j0 = first // T if first > 0 else 0
    return j0, max(j0, -(-max(kv_end, 0) // T))


def tile_pairs(q_shape, k_shape, dtype, causal: bool, q_offset: int,
               kv_len: int, window: int | None,
               prefill: bool = False) -> tuple[int, int, int]:
    """What K6's tile loops multiply for one (batch, KV head): (pairs, t_lo,
    t_hi) — the (real query row, key) pairs of every tile a block or warp
    multiplies (query ``r // G`` of flattened row ``r``; ``cuda.KEY_TILE``
    keys a tile, the ragged edge's masked keys included) and the span of
    tiles [t_lo, t_hi) any of them reads.  Routes as the kernel's host
    entry picks them: the split-KV decode (every row in one block, the
    tiles of `cuda.decode_tiles`); the fp32 prefill (blocks of 64 rows,
    each over its block's tiles); the bf16 prefill (blocks of 128 rows,
    each warp of 16 skipping the tiles past its own causal end and, with
    a window, those wholly before its unit's first visible key; at D >= 64
    a unit is a warpgroup of 64 rows).  ``prefill`` takes the bf16 prefill
    whatever the rows, as the forward with its logsumexp does."""
    _, Sq, H, D = q_shape
    G = H // k_shape[2]
    rows, T = Sq * G, cuda.KEY_TILE
    if rows <= cuda.DECODE_ROWS and not prefill:
        lo, hi = cuda.decode_tiles(Sq, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len, window=window)
        return rows * T * (hi - lo), lo, hi
    R = PREFILL_ROWS[dtype]
    pairs, t_lo, t_hi = 0, None, 0
    for r0 in range(0, rows, R):
        j0, nkv = _block_tiles(r0, R, rows, G, q_offset, kv_len, causal,
                               window)
        t_lo = j0 if t_lo is None else min(t_lo, j0)
        t_hi = max(t_hi, nkv)
        if dtype != torch.bfloat16:
            pairs += min(R, rows - r0) * T * (nkv - j0)
            continue
        for w0 in range(0, min(R, rows - r0), _WARP_ROWS):
            unit0 = w0 // 64 * 64 if D >= 64 else w0
            last = unit0 + 63 if D >= 64 else w0 + _WARP_ROWS - 1
            hi = nkv
            if causal:     # tiles starting past the unit's last position
                hi = min(hi, (q_offset + (r0 + last) // G) // T + 1)
            lo = j0
            if window is not None:   # tiles ending before its first key
                edge = q_offset + (r0 + unit0) // G - window + 1
                lo = max(lo, -(-(edge - T + 1) // T))
            pairs += min(_WARP_ROWS, rows - r0 - w0) * T * max(hi - lo, 0)
    return pairs, t_lo or 0, t_hi


def kernel_flops(q_shape, k_shape, dtype, causal, q_offset, kv_len,
                 window, prefill: bool = False) -> int:
    """K6's FLOPs: 4·D per (row, key) pair its tiles multiply (Q Kᵀ and
    P V; `tile_pairs`), over the B·Hkv (batch, KV head) pairs; tiles
    wholly masked, causally or by the window, are skipped, as the kernel
    skips them."""
    B, _, _, D = q_shape
    pairs = tile_pairs(q_shape, k_shape, dtype, causal, q_offset, kv_len,
                       window, prefill)[0]
    return 4 * D * pairs * B * k_shape[2]


def kernel_bytes(q, k, v, causal, q_offset, kv_len, window,
                 prefill: bool = False) -> int:
    """K6's traffic: q read and the output written once, and the K and V
    rows of the tiles its blocks read (their span, once)."""
    _, lo, hi = tile_pairs(q.shape, k.shape, q.dtype, causal, q_offset,
                           kv_len, window, prefill)
    T = cuda.KEY_TILE
    B, Skv, Hkv, D = k.shape
    keys = max(min(hi * T, Skv) - lo * T, 0)
    return 2 * q.numel() * q.element_size() \
        + 2 * B * keys * Hkv * D * k.element_size()


def kernel_bytes_lse(q, k, v, causal, q_offset, kv_len, window) -> int:
    """The forward with its logsumexp: `kernel_bytes` on the prefill
    route, and the rows' fp32 logsumexp written."""
    B, Sq, H, _ = q.shape
    return kernel_bytes(q, k, v, causal, q_offset, kv_len, window, True) \
        + 4 * B * H * Sq


@register_flop_formula(torch.ops.repro_torch.flash_attention, get_raw=True)
def _k6_flops(q, k, v, causal, q_offset, kv_len, window, *args, **kwargs):
    return kernel_flops(q.shape, k.shape, q.dtype, causal, q_offset, kv_len,
                        window)


def saves_stats(q: torch.Tensor) -> bool:
    """Under autograd: whether the forward saves its output and its rows'
    logsumexp for the backward — bf16 at D >= 64 on the card, or on a
    ``meta`` tensor, which stands for one (`cuda.takes_stats`)."""
    return (q.is_cuda or q.is_meta) and cuda.takes_stats(q.dtype, q.shape[-1])


def _run_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             q_offset: int, kv_len: int, window: int | None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The output and its rows' logsumexp (log2 units): the kernel's bf16
    prefill on a CUDA tensor, the plain versions on a CPU one."""
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    if not q.is_cuda:
        return (flash_attention_plain(q, k, v, **kw),
                flash_attention_lse2(q, k, v, **kw))
    return cuda.flash_attention_cuda(q, k, v, return_lse=True, **kw)


_k6_lse = torch.library.custom_op("repro_torch::flash_attention_lse",
                                  mutates_args=())(_run_lse)


@_k6_lse.register_fake
def _k6_lse_shape(q, k, v, causal, q_offset, kv_len, window):
    """A contiguous (B, Sq, H, D) output of q's type and a float32 (B, H,
    Sq) logsumexp."""
    B, Sq, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Sq), dtype=torch.float32)


def _forward_lse(q, k, v, causal, q_offset, kv_len, window):
    """`_run_lse` through the operator only where a ``meta`` tensor or a
    dispatch mode has to see it, as `_forward`."""
    if q.is_meta or is_in_torch_dispatch_mode():
        return torch.ops.repro_torch.flash_attention_lse(
            q, k, v, causal, q_offset, kv_len, window)
    return _run_lse(q, k, v, causal, q_offset, kv_len, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_lse,
                       get_raw=True)
def _k6_lse_flops(q, k, v, causal, q_offset, kv_len, window, *args,
                  **kwargs):
    return kernel_flops(q.shape, k.shape, q.dtype, causal, q_offset, kv_len,
                        window, prefill=True)


def _run_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor, causal: bool, q_offset: int,
                  kv_len: int, window: int | None,
                  out: torch.Tensor | None = None,
                  lse: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv: the backward kernel on a CUDA tensor (given the
    forward's ``out`` and ``lse`` where `cuda.takes_stats`), the plain
    recompute on a CPU one."""
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    if not q.is_cuda:
        return flash_attention_grads(q, k, v, dout, **kw)
    return cuda.flash_attention_bwd_cuda(q, k, v, dout, out=out, lse=lse,
                                         **kw)


_k6_bwd = torch.library.custom_op("repro_torch::flash_attention_backward",
                                  mutates_args=())(_run_backward)


@_k6_bwd.register_fake
def _k6_bwd_shape(q, k, v, dout, causal, q_offset, kv_len, window, out=None,
                  lse=None):
    """The kernel's dq, dk, dv: contiguous, of the inputs' shapes and
    type."""
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _backward(q, k, v, dout, causal, q_offset, kv_len, window, out=None,
              lse=None):
    """`_run_backward` through the operator only where a ``meta`` tensor
    or a dispatch mode has to see it, as `_forward`."""
    if q.is_meta or is_in_torch_dispatch_mode():
        return torch.ops.repro_torch.flash_attention_backward(
            q, k, v, dout, causal, q_offset, kv_len, window, out, lse)
    return _run_backward(q, k, v, dout, causal, q_offset, kv_len, window,
                         out, lse)


def backward_pairs(q_shape, causal: bool, q_offset: int, kv_len: int,
                   window: int | None) -> tuple[int, int, int]:
    """What K6's backward multiplies for one (batch, query head): (pairs,
    t_lo, t_hi) — the (real query row, key) pairs of every (query tile,
    key tile) it visits (each query tile's real rows × ``TILE`` keys of
    each key tile `ref.key_tiles` gives it; the dK/dV launch visits the
    same pairs from the keys' side) and the span of key tiles [t_lo, t_hi)
    read."""
    Sq = q_shape[1]
    pairs, t_lo, t_hi = 0, None, 0
    for i0 in range(0, Sq, TILE):
        lo, hi = key_tiles(i0, Sq, causal=causal, q_offset=q_offset,
                           kv_len=kv_len, window=window)
        if hi > lo:
            t_lo = lo if t_lo is None else min(t_lo, lo)
            t_hi = max(t_hi, hi)
        pairs += min(TILE, Sq - i0) * TILE * (hi - lo)
    return pairs, t_lo or 0, t_hi


def backward_flops(q_shape, k_shape, causal, q_offset, kv_len,
                   window, saved: bool = False) -> int:
    """K6's backward FLOPs.  Recomputing (``saved`` False): 9 products of
    2·D FLOPs per pair of `backward_pairs` (the dQ launch forms S and dP
    in each of its two passes, then dS K; the dK/dV launch S, dP, Pᵀ dO
    and dSᵀ Q), over the B·H (batch, query head) pairs.  From the saved
    output and logsumexp (``saved``): the dQ launch's 3 products (S, dP,
    dS K) per pair of the forward's prefill tiles (`tile_pairs`, over the
    B·Hkv (batch, KV head) pairs), and the dK/dV launch's 4 per pair of
    `backward_pairs` — 14·D a pair where the two walks meet the same
    pairs."""
    B, _, H, D = q_shape
    pairs = backward_pairs(q_shape, causal, q_offset, kv_len, window)[0]
    if not saved:
        return 18 * D * pairs * B * H
    rows = tile_pairs(q_shape, k_shape, torch.bfloat16, causal, q_offset,
                      kv_len, window, prefill=True)[0]
    return 6 * D * rows * B * k_shape[2] + 8 * D * pairs * B * H


def backward_bytes(q, k, v, dout, causal, q_offset, kv_len, window,
                   out=None, lse=None) -> int:
    """K6's backward traffic: q and dout read and dq written once, the K and
    V rows of the key tiles it reads (their span, once), dk and dv written
    whole; recomputing, the rows' m, 1 / l, δ written and read once
    (fp32); from the saved statistics, the output and the logsumexp read
    and δ written and read once."""
    _, lo, hi = backward_pairs(q.shape, causal, q_offset, kv_len, window)
    B, Skv, Hkv, D = k.shape
    keys = max(min(hi * TILE, Skv) - lo * TILE, 0)
    rows = q.shape[0] * q.shape[2] * q.shape[1]
    stats = 2 * 3 * 4 * rows if lse is None \
        else q.numel() * q.element_size() + 3 * 4 * rows
    return 3 * q.numel() * q.element_size() \
        + 2 * B * keys * Hkv * D * k.element_size() \
        + 2 * k.numel() * k.element_size() + stats


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward,
                       get_raw=True)
def _k6_bwd_flops(q, k, v, dout, causal, q_offset, kv_len, window, out=None,
                  lse=None, *args, **kwargs):
    return backward_flops(q.shape, k.shape, causal, q_offset, kv_len, window,
                          saved=lse is not None)


class FlashAttention(torch.autograd.Function):
    """K6 under autograd: the forward is K6 (the kernel on the card, the
    plain version on the CPU), saving q, k and v and, where `saves_stats`,
    its output and its rows' logsumexp; the backward is K6's backward
    kernel on the card and the plain recompute
    (`ref.flash_attention_grads`) on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_len, window):
        ctx.args = (causal, q_offset, kv_len, window)
        if saves_stats(q):
            out, lse = _forward_lse(q, k, v, causal, q_offset, kv_len, window)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal, q_offset, kv_len, window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, *stats = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, dout, *ctx.args, *stats)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int | None = None,
                    kv_len: int | None = None, window: int | None = None,
                    block_q: int = 128, block_k: int = 128,
                    prefer: str = "auto") -> torch.Tensor:
    """GQA attention: q (B, Sq, H, D), k and v (B, Skv, Hkv, D) → (B, Sq, H,
    D).

    With ``q_offset`` and ``kv_len`` left out, queries are end-aligned with
    the keys, `repro`'s ``ops.flash_attention`` contract (``ref.py``
    semantics).  Given, they are the Pallas kernel's explicit form: query
    ``i`` sits at ``q_offset + i`` and only the first ``kv_len`` keys are
    real — a decode step over a cache of ``max_seq`` rows passes
    ``q_offset=pos, kv_len=pos + 1``.  ``window`` (>= 1, or None for
    none) hides key ``j`` from the query at ``p`` unless ``p − j <
    window``: the sliding-window variant, whose kernel reads only the key
    tiles a block's window reaches.  ``block_q``/``block_k`` are the
    Pallas tile sizes, accepted for `repro`'s signature; K6's tiles are
    fixed when it is compiled (64 keys; 128 query rows for a bf16 prefill,
    64 for an fp32 prefill).  A decode call (``Sq * H / Hkv <= 16``) holds
    all its rows of a (batch, KV head) in one block and splits the keys
    across the card in runs of 64-key tiles, merged in the same launch."""
    if prefer not in _PREFER:
        raise ValueError(f"unknown prefer: {prefer!r} (have {_PREFER})")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be >= 1 (got {block_q}, {block_k})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None (got {window})")
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    q_offset = kv_len - q.shape[1] if q_offset is None else int(q_offset)
    if prefer == "ref":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                     kv_len=kv_len, window=window)
    if prefer == "cuda" and not q.is_cuda:
        raise ValueError("prefer='cuda' needs CUDA tensors: the CUDA flash "
                         "attention has no CPU mode")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, q_offset, kv_len, window)
    return _forward(q, k, v, causal, q_offset, kv_len, window)
