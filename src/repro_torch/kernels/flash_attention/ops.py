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
through :class:`FlashAttention`, a `torch.autograd.Function`: its forward
is that call and saves only q, k and v; its backward is
`ref.flash_attention_grads`, the attention recomputed in plain torch block
of queries by block, its gradient written out.  The backward is plain by
design, not a
fallback: `repro` trains through its pure-JAX attention under
``jax.checkpoint`` and its Pallas kernel has no backward.  ``prefer="ref"``
differentiates the plain version directly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import cuda
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_grads,
    flash_attention_plain,
)

_PREFER = ("auto", "cuda", "ref")


def _forward(q, k, v, causal, q_offset, kv_len, window):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_len=kv_len,
                                     window=window)
    return cuda.flash_attention_cuda(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_len=kv_len,
                                     window=window)


class FlashAttention(torch.autograd.Function):
    """K6 under autograd: the forward is K6 (the kernel on the card, the
    plain version on the CPU), saving q, k and v; the backward recomputes
    the attention in plain torch (`ref.flash_attention_grads`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_len, window):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, q_offset, kv_len, window)
        return _forward(q, k, v, causal, q_offset, kv_len, window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        causal, q_offset, kv_len, window = ctx.args
        dq, dk, dv = flash_attention_grads(q, k, v, dout, causal=causal,
                                           q_offset=q_offset, kv_len=kv_len,
                                           window=window)
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
