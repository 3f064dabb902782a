"""Plain PyTorch versions of K6, causal GQA attention.

:func:`attention_ref` is `repro/kernels/flash_attention/ref.py`'s oracle:
queries end-aligned with keys, fp32 softmax, ``p`` cast to ``q.dtype``
before the PV product.  :func:`flash_attention_plain` computes what the
Pallas kernel `flash_attention_pallas` (and K6) computes with its explicit
arguments: query ``i`` sits at position ``q_offset + i``, keys at or past
``kv_len`` are masked, masked scores are ``-1e30``, scores, softmax and the
PV sums are fp32 with ``p`` rounded to the input type first, and the
denominator is clamped to ``1e-30``.  Both take q ``(B, Sq, H, D)`` and k, v
``(B, Skv, Hkv, D)`` with ``H`` a multiple of ``Hkv``; query head ``h``
reads KV head ``h // (H // Hkv)``.

A row with no valid key (only padded tail queries have one) is not held to
anything: here it averages every key, in K6 it is zero.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """End-aligned causal (or full) GQA attention; the scores are formed in
    ``q.dtype`` and softmaxed in fp32, as `repro`'s ``ref.py:12``."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() / math.sqrt(D)
    if causal:
        qpos = torch.arange(Sq, device=q.device) + (Skv - Sq)
        mask = qpos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype), v)
    return o.reshape(B, Sq, H, D)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int | None = None,
                          kv_len: int | None = None) -> torch.Tensor:
    """What ``flash_attention_pallas(q, k, v, causal=, q_offset=, kv_len=)``
    computes (`repro` ``kernel.py:86``), in one pass over all keys.

    ``kv_len`` defaults to ``Skv`` and ``q_offset`` to ``kv_len - Sq``
    (queries end-aligned with the real keys)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kv_len = Skv if kv_len is None else kv_len
    q_offset = kv_len - Sq if q_offset is None else q_offset
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(D))
    kpos = torch.arange(Skv, device=q.device)
    valid = (kpos < kv_len)[None, :]
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        valid = valid & (qpos[:, None] >= kpos[None, :])
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
