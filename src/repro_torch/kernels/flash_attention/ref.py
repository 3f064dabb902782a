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
reads KV head ``h // (H // Hkv)``.  With ``window`` (the sliding-window
variant) key ``j`` is visible to the query at ``p`` only if ``p − j <
window``, `repro`'s mask (``repro/models/transformer.py:180-183``).

:func:`flash_attention_grads` is K6's backward, plain by design: `repro`
trains through its pure-JAX attention under ``jax.checkpoint`` and the
Pallas kernel has no backward, so the gradient recomputes the attention
here, block of queries by block, with its gradient written out in plain
torch.  :func:`flash_attention_grads_tiles` is K6's backward kernel
(`csrc/flash_attention_bwd.cu`) written out in plain torch: its two
launches' tile loops and sums in order, for the tests; nothing on the main
path calls it.  With ``stats=(out, lse)`` it is the route that reads the
forward's output and logsumexp (bf16 at D >= 64 on the card): δ = dO · O,
P from the logsumexp (:func:`flash_attention_lse2`, log2 units, as the
kernel's forward writes it), launch 1 over blocks of flattened (position,
head) rows (:func:`dq_tiles`), launch 2 over the key tiles as before.

A row with no valid key (only padded tail queries have one) is not held to
anything: here it averages every key, in K6 it is zero.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


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


def _visible(Sq: int, Skv: int, q_offset: int, kv_len: int, causal: bool,
             window: int | None, device) -> torch.Tensor:
    """(Sq, Skv) bool: key j is real and visible to query i."""
    kpos = torch.arange(Skv, device=device)
    valid = (kpos < kv_len)[None, :]
    if causal or window is not None:
        qpos = q_offset + torch.arange(Sq, device=device)
        if causal:
            valid = valid & (qpos[:, None] >= kpos[None, :])
        if window is not None:
            valid = valid & (qpos[:, None] - kpos[None, :] < window)
    return valid


def _plain(qf, kf, vf, p_dtype, *, causal, q_offset, kv_len, window):
    """The plain attention on fp32 q, k, v with p rounded to ``p_dtype``
    before the PV product; fp32 (B, Sq, H, D)."""
    B, Sq, H, D = qf.shape
    Skv, Hkv = kf.shape[1], kf.shape[2]
    qg = qf.reshape(B, Sq, Hkv, H // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * (1.0 / math.sqrt(D))
    valid = _visible(Sq, Skv, q_offset, kv_len, causal, window, qf.device)
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(p_dtype).float(), vf) / l
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int | None = None,
                          kv_len: int | None = None,
                          window: int | None = None) -> torch.Tensor:
    """What ``flash_attention_pallas(q, k, v, causal=, q_offset=, kv_len=)``
    computes (`repro` ``kernel.py:86``), in one pass over all keys, with
    `repro`'s sliding-window mask where ``window`` is given.

    ``kv_len`` defaults to ``Skv`` and ``q_offset`` to ``kv_len - Sq``
    (queries end-aligned with the real keys)."""
    Sq, Skv = q.shape[1], k.shape[1]
    kv_len = Skv if kv_len is None else kv_len
    q_offset = kv_len - Sq if q_offset is None else q_offset
    o = _plain(q.float(), k.float(), v.float(), v.dtype, causal=causal,
               q_offset=q_offset, kv_len=kv_len, window=window)
    return o.to(q.dtype)


def flash_attention_lse2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int | None = None,
                         kv_len: int | None = None,
                         window: int | None = None) -> torch.Tensor:
    """Each row's logsumexp of the scaled, masked scores in log2 units,
    fp32 (B, H, Sq): what K6's forward writes for its backward (−inf for
    a row with no visible key, which the kernel writes as about −1e30)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kv_len = Skv if kv_len is None else kv_len
    q_offset = kv_len - Sq if q_offset is None else q_offset
    qg = q.float().reshape(B, Sq, Hkv, H // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(D))
    valid = _visible(Sq, Skv, q_offset, kv_len, causal, window, q.device)
    s = torch.where(valid, s, -math.inf)
    return (torch.logsumexp(s, -1) * LOG2E).reshape(B, H, Sq)


def key_range(q0: int, q1: int, *, causal: bool, q_offset: int, kv_len: int,
              window: int | None) -> tuple[int, int]:
    """The keys [lo, hi) that queries q0..q1−1 can see."""
    hi = min(kv_len, q_offset + q1) if causal else kv_len
    lo = max(0, q_offset + q0 - window + 1) if window is not None else 0
    return lo, max(lo, hi)


BACKWARD_SCORES = 2**27   # score elements a block of the backward holds


def _plain_grads(qf, kf, vf, dof, p_dtype, *, causal, q_offset, kv_len,
                 window):
    """dq, dk, dv (fp32) of `_plain` at fp32 q, k, v for the fp32 output
    gradient ``dof``, written out: with s the masked scaled scores, p =
    exp(s − max s), l = Σp, p̃ = p rounded to ``p_dtype`` and o = p̃ v / l,

        dv = (p̃ / l)ᵀ dO,   dp = (dO vᵀ − Σ p̃ ∘ dO vᵀ / l) / l,
        ds = p ∘ dp (0 where masked),   dq = ds k · scale,   dk = dsᵀ q · scale,

    the rounding of p passed straight through, as autograd passes it.
    Autograd through `_plain` also sends a gradient through the row max,
    which is zero where p̃ = p (fp32) and of p's rounding in bf16."""
    B, Sq, H, D = qf.shape
    Skv, Hkv = kf.shape[1], kf.shape[2]
    scale = 1.0 / math.sqrt(D)
    qg = qf.reshape(B, Sq, Hkv, H // Hkv, D)
    dog = dof.reshape(B, Sq, Hkv, H // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    valid = _visible(Sq, Skv, q_offset, kv_len, causal, window, qf.device)
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s.sub_(s.amax(-1, keepdim=True)))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    pr = p.to(p_dtype).float() if p_dtype != torch.float32 else p
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)          # dO vᵀ
    c = (pr * dp).sum(-1, keepdim=True) / l
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pr / l, dog)
    ds = dp.sub_(c).mul_(p).div_(l).masked_fill_(~valid, 0.0)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, Sq, H, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dq * scale, dk * scale, dv


def _block_rows(B, H, Sq, kv_keys, window) -> int:
    """Query rows a backward block takes: its scores (B · H · rows · the
    keys it sees) within ``BACKWARD_SCORES``; with a window a block of r
    rows sees at most r + window keys."""
    budget = BACKWARD_SCORES // (B * H)
    rows = max(1, budget // max(1, kv_keys))
    if window is not None:
        while rows < Sq and 2 * rows * min(kv_keys, 2 * rows + window) <= budget:
            rows *= 2
    return min(rows, Sq)


def flash_attention_grads(q, k, v, dout, *, causal: bool, q_offset: int,
                          kv_len: int, window: int | None = None):
    """dq, dk, dv of `flash_attention_plain` at (q, k, v) for the output
    gradient ``dout``: the attention recomputed in fp32 over blocks of
    queries, each over the keys it can see (`key_range`), and its
    gradient written out (`_plain_grads`); dk and dv are summed over the
    blocks in fp32 and each gradient is cast once to its input's type.  A
    block holds at most ``BACKWARD_SCORES`` scores."""
    B, Sq, H, D = q.shape
    rows = _block_rows(B, H, Sq, min(kv_len, k.shape[1]), window)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for q0 in range(0, Sq, rows):
        q1 = min(Sq, q0 + rows)
        lo, hi = key_range(q0, q1, causal=causal, q_offset=q_offset,
                           kv_len=kv_len, window=window)
        if hi == lo:                           # no key: no gradient
            continue
        gq, gk, gv = _plain_grads(
            q[:, q0:q1].float(), k[:, lo:hi].float(), v[:, lo:hi].float(),
            dout[:, q0:q1].float(), v.dtype, causal=causal,
            q_offset=q_offset + q0 - lo, kv_len=hi - lo, window=window)
        dq[:, q0:q1] = gq
        dk[:, lo:hi] += gk
        dv[:, lo:hi] += gv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


TILE = 64   # the backward kernel's query rows and keys a tile


def key_tiles(i0: int, Sq: int, *, causal: bool, q_offset: int, kv_len: int,
              window: int | None) -> tuple[int, int]:
    """The key tiles [t_lo, t_hi) the backward's query tile at row ``i0``
    walks (its dQ launch): those holding the keys its rows can see
    (`key_range`)."""
    lo, hi = key_range(i0, min(Sq, i0 + TILE), causal=causal,
                       q_offset=q_offset, kv_len=kv_len, window=window)
    return lo // TILE, -(-hi // TILE) if hi > lo else lo // TILE


def query_tiles(j0: int, Sq: int, *, causal: bool, q_offset: int,
                kv_len: int, window: int | None) -> tuple[int, int]:
    """The query tiles [qt_lo, qt_hi) whose rows see a key of the key tile
    at ``j0`` (the backward's dK/dV launch): the (query tile, key tile)
    pairs of `key_tiles`, walked from the keys' side."""
    if j0 >= kv_len:
        return 0, 0
    i_min = max(0, j0 - q_offset) if causal else 0
    i_max = Sq if window is None else min(Sq, j0 + TILE - 1 + window - q_offset)
    if i_max <= i_min:
        return 0, 0
    return i_min // TILE, -(-i_max // TILE)


def kv_heads(H: int, Hkv: int) -> torch.Tensor:
    """The KV head each query head reads: ``h // (H // Hkv)``."""
    return torch.arange(H) // (H // Hkv)


ROW_BLOCK = 128   # the saved-statistics route's launch 1: flattened rows a block
UNIT = 64         # ... and a warpgroup's


def dq_tiles(rho0: int, rows: int, G: int, *, causal: bool, q_offset: int,
             kv_len: int, window: int | None) -> list:
    """Launch 1 of the saved-statistics route: for each warpgroup of the
    block of flattened rows at ``rho0`` (row ``rho`` is position ``rho //
    G``; ``rows`` = Sq G), its first row and the key tiles [lo, hi) it
    multiplies — the block's span (from the tile of its first row's first
    visible key to its last row's causal end, as the forward's prefill),
    less the tiles wholly above the warpgroup's last row or wholly below
    its first row's window."""
    kv_end = kv_len
    if causal:
        kv_end = min(kv_end, q_offset + min(rows - 1, rho0 + ROW_BLOCK - 1) // G
                     + 1)
    nkv = -(-kv_end // TILE) if kv_end > 0 else 0
    j0 = 0
    if window is not None:
        first = q_offset + rho0 // G - window + 1
        j0 = first // TILE if first > 0 else 0
    out = []
    for u0 in range(rho0, min(rho0 + ROW_BLOCK, rows), UNIT):
        hi = nkv
        if causal:        # tiles starting past the warpgroup's last position
            hi = min(hi, (q_offset + (u0 + UNIT - 1) // G) // TILE + 1)
        lo = j0
        if window is not None:   # tiles ending before its first row's window
            edge = q_offset + u0 // G - window + 1
            lo = max(lo, -(-(edge - TILE + 1) // TILE))
        out.append((u0, lo, max(lo, hi)))
    return out


def _ds_saved(p: torch.Tensor, dp: torch.Tensor,
              delta: torch.Tensor) -> torch.Tensor:
    """dS of the saved-statistics route: P (dP − δ), δ the rows' dO · O."""
    return p * (dp - delta)


def _grads_tiles_saved(q, k, v, dout, out, lse, *, causal, q_offset, kv_len,
                       window):
    """`flash_attention_grads_tiles` with ``stats=(out, lse)``."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G, rows = H // Hkv, Sq * (H // Hkv)
    c2 = LOG2E / math.sqrt(D)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    f = dict(dtype=torch.promote_types(q.dtype, torch.float32),
             device=q.device)

    def rnd(x):
        return x if q.dtype in (torch.float32, torch.float64) \
            else x.to(q.dtype).to(f["dtype"])

    heads = kv_heads(H, Hkv).to(q.device)
    # group[c, g]: the g-th query head reading KV head c
    group = torch.stack([torch.nonzero(heads == c).flatten()
                         for c in range(Hkv)])
    qf, dof, kf, vf, of = (t.to(f["dtype"]) for t in (q, dout, k, v, out))
    lse = lse.to(f["dtype"])
    delta = (dof * of).sum(-1).permute(0, 2, 1)            # (B, H, Sq)

    def flat(x):   # (B, Sq, H, ...) → (B, Hkv, Sq G, ...): row rho = i G + g
        x = x[:, :, group]
        return x.permute(0, 2, 1, 3, *range(4, x.ndim)).reshape(
            B, Hkv, rows, *x.shape[4:])

    qr, dor = flat(qf), flat(dof)
    lr, dr = flat(lse.permute(0, 2, 1)), flat(delta.permute(0, 2, 1))
    pos = q_offset + torch.arange(rows, device=q.device) // G

    # launch 1: dq over blocks of flattened rows, each warpgroup its tiles
    dqr = torch.zeros((B, Hkv, rows, D), **f)
    for rho0 in range(0, rows, ROW_BLOCK):
        for u0, lo, hi in dq_tiles(rho0, rows, G, **kw):
            u1 = min(rows, u0 + UNIT)
            acc = torch.zeros((B, Hkv, u1 - u0, D), **f)
            for t in range(lo, hi):
                k0, k1 = t * TILE, min(Skv, t * TILE + TILE)
                keys = torch.arange(k0, k1, device=q.device)
                ok = (keys < kv_len)[None, :]
                if causal:
                    ok = ok & (pos[u0:u1, None] >= keys[None, :])
                if window is not None:
                    ok = ok & (pos[u0:u1, None] - keys[None, :] < window)
                s = torch.einsum("bhrd,bkhd->bhrk", qr[:, :, u0:u1],
                                 kf[:, k0:k1])
                p = torch.where(ok, torch.exp2(s * c2 - lr[:, :, u0:u1, None]),
                                0.0)
                dp = torch.einsum("bhrd,bkhd->bhrk", dor[:, :, u0:u1],
                                  vf[:, k0:k1])
                ds = _ds_saved(p, dp, dr[:, :, u0:u1, None])
                acc += torch.einsum("bhrk,bkhd->bhrd", rnd(ds), kf[:, k0:k1])
            dqr[:, :, u0:u1] = acc / math.sqrt(D)
    dq = torch.zeros((B, Sq, H, D), **f)
    dq[:, :, group.flatten()] = dqr.reshape(B, Hkv, Sq, G, D).permute(
        0, 2, 1, 3, 4).reshape(B, Sq, H, D)

    def mask(i0, i1, k0, k1):
        return _visible(i1 - i0, k1 - k0, q_offset + i0 - k0, kv_len - k0,
                        causal, window, q.device)

    # launch 2: dk, dv per key tile, over the group's heads, then the
    # query tiles that see it
    dk = torch.zeros((B, Skv, Hkv, D), **f)
    dv = torch.zeros((B, Skv, Hkv, D), **f)
    for j0 in range(0, Skv, TILE):
        j1 = min(Skv, j0 + TILE)
        qt_lo, qt_hi = query_tiles(j0, Sq, **kw)
        gk = torch.zeros((B, Hkv, j1 - j0, D), **f)
        gv = torch.zeros_like(gk)
        for g in range(G):
            hs = group[:, g]
            for qt in range(qt_lo, qt_hi):
                i0, i1 = qt * TILE, min(Sq, qt * TILE + TILE)
                qg, dog = qf[:, i0:i1, hs], dof[:, i0:i1, hs]
                s = torch.einsum("bkhd,bqhd->bhkq", kf[:, j0:j1], qg)
                ok = mask(i0, i1, j0, j1).T
                p = torch.where(ok, torch.exp2(s * c2 - lse[:, hs, None, i0:i1]),
                                0.0)
                dp = torch.einsum("bkhd,bqhd->bhkq", vf[:, j0:j1], dog)
                ds = p * (dp - delta[:, hs, None, i0:i1])
                gv += torch.einsum("bhkq,bqhd->bhkd", rnd(p), dog)
                gk += torch.einsum("bhkq,bqhd->bhkd", rnd(ds), qg)
        dk[:, j0:j1] = (gk / math.sqrt(D)).permute(0, 2, 1, 3)
        dv[:, j0:j1] = gv.permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_grads_tiles(q, k, v, dout, *, causal: bool,
                                q_offset: int, kv_len: int,
                                window: int | None = None, stats=None):
    """dq, dk, dv as K6's backward kernel computes them: its two launches'
    loops and sums in order, in tiles of ``TILE`` rows and keys, in fp32.

    Launch 1, per query tile: pass 1 walks its key tiles (`key_tiles`)
    with an online softmax, the row max m, the row sum l and δ = Σ p̃ dP /
    l rescaled as m grows (p̃ rounded to the input type); pass 2 walks them
    again, dq += ds K with ds = p (dP − δ) / l.  Launch 2, per key tile:
    the query heads of its group, then its query tiles (`query_tiles`), in
    that order: dv += (p / l)ᵀ dO and dk += dsᵀ Q.  In bf16, p / l and ds
    are rounded to bf16 before their products, as the tensor cores take
    them.  A row with no visible key adds nothing (the kernel's forward
    gives it a zero output).  float64 inputs are computed in float64: the
    algorithm without the rounding of its sums.

    ``stats=(out, lse)``: the route that reads the forward's output (B,
    Sq, H, D) and its rows' logsumexp (B, H, Sq, log2 units,
    `flash_attention_lse2`).  No pass recomputes m and l: P = 2^(s scale
    log2 e − lse) and δ = dO · O (fp32).  Launch 1, per block of
    ``ROW_BLOCK`` flattened rows (ρ = i G + g) of one KV head, per
    warpgroup of ``UNIT`` rows, its key tiles (`dq_tiles`): dq += dS K
    with dS = P (dP − δ).  Launch 2, per key tile: the group's heads, then
    the query tiles that see it (`query_tiles`): dv += Pᵀ dO, dk += dSᵀ Q.
    In bf16, P and dS are rounded before their products."""
    if stats is not None:
        out, lse = stats
        return _grads_tiles_saved(q, k, v, dout, out, lse, causal=causal,
                                  q_offset=q_offset, kv_len=kv_len,
                                  window=window)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    f = dict(dtype=torch.promote_types(q.dtype, torch.float32),
             device=q.device)

    def rnd(x):
        return x if q.dtype in (torch.float32, torch.float64) \
            else x.to(q.dtype).to(f["dtype"])

    heads = kv_heads(H, Hkv).to(q.device)
    qf, dof, kf, vf = (t.to(f["dtype"]) for t in (q, dout, k, v))
    kh, vh = kf[:, :, heads], vf[:, :, heads]      # each query head's K, V
    m = torch.full((B, H, Sq), -math.inf, **f)
    l = torch.ones((B, H, Sq), **f)
    delta = torch.zeros((B, H, Sq), **f)
    dq = torch.zeros((B, Sq, H, D), **f)

    def mask(i0, i1, k0, k1):
        """(rows, keys) visibility of queries i0..i1−1 and keys k0..k1−1."""
        return _visible(i1 - i0, k1 - k0, q_offset + i0 - k0, kv_len - k0,
                        causal, window, q.device)

    # launch 1: dq, and each row's m, l, δ
    for i0 in range(0, Sq, TILE):
        i1 = min(Sq, i0 + TILE)
        t_lo, t_hi = key_tiles(i0, Sq, **kw)

        def scores(t, i0=i0, i1=i1):
            k0, k1 = t * TILE, min(Skv, t * TILE + TILE)
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, i0:i1], kh[:, k0:k1])
            s = torch.where(mask(i0, i1, k0, k1), s * scale, -math.inf)
            dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, i0:i1], vh[:, k0:k1])
            return s, dp, k0, k1

        mi = torch.full((B, H, i1 - i0), -math.inf, **f)
        li = torch.zeros_like(mi)
        du = torch.zeros_like(mi)
        for t in range(t_lo, t_hi):
            s, dp, _, _ = scores(t)
            m_new = torch.maximum(mi, s.amax(-1))
            live = m_new > -math.inf
            corr = torch.where(live, torch.exp(mi - m_new), 1.0)
            p = torch.where(live[..., None], torch.exp(s - m_new[..., None]),
                            0.0)
            li = li * corr + p.sum(-1)
            du = du * corr + (rnd(p) * dp).sum(-1)
            mi = m_new
        li = li.clamp_min(1e-30)
        di = du / li
        acc = torch.zeros((B, H, i1 - i0, D), **f)
        for t in range(t_lo, t_hi):
            s, dp, k0, k1 = scores(t)
            p = torch.where(s > -math.inf, torch.exp(s - mi[..., None]), 0.0)
            ds = p * (dp - di[..., None]) * (1.0 / li)[..., None]
            acc += torch.einsum("bhqk,bkhd->bhqd", rnd(ds), kh[:, k0:k1])
        dq[:, i0:i1] = (acc * scale).permute(0, 2, 1, 3)
        m[..., i0:i1], l[..., i0:i1], delta[..., i0:i1] = mi, li, di

    # launch 2: dk, dv; group[c, g] is the g-th query head reading KV head c
    group = torch.stack([torch.nonzero(heads == c).flatten()
                         for c in range(Hkv)])
    inv_l = 1.0 / l
    dk = torch.zeros((B, Skv, Hkv, D), **f)
    dv = torch.zeros((B, Skv, Hkv, D), **f)
    for j0 in range(0, Skv, TILE):
        j1 = min(Skv, j0 + TILE)
        qt_lo, qt_hi = query_tiles(j0, Sq, **kw)
        gk = torch.zeros((B, Hkv, j1 - j0, D), **f)
        gv = torch.zeros_like(gk)
        for g in range(group.shape[1]):
            hs = group[:, g]
            for qt in range(qt_lo, qt_hi):
                i0, i1 = qt * TILE, min(Sq, qt * TILE + TILE)
                qg, dog = qf[:, i0:i1, hs], dof[:, i0:i1, hs]
                s = torch.einsum("bkhd,bqhd->bhkq", kf[:, j0:j1], qg) * scale
                ok = mask(i0, i1, j0, j1).T
                mq = m[:, hs, None, i0:i1]
                p = torch.where(ok, torch.exp(s - torch.where(ok, mq, 0.0)),
                                0.0)
                dp = torch.einsum("bkhd,bqhd->bhkq", vf[:, j0:j1], dog)
                il = inv_l[:, hs, None, i0:i1]
                ds = p * (dp - delta[:, hs, None, i0:i1]) * il
                gv += torch.einsum("bhkq,bqhd->bhkd", rnd(p * il), dog)
                gk += torch.einsum("bhkq,bqhd->bhkd", rnd(ds), qg)
        dk[:, j0:j1] = (gk * scale).permute(0, 2, 1, 3)
        dv[:, j0:j1] = gv.permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
