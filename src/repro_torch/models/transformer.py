"""Decoder-only transformer LM: GQA + RoPE + RMSNorm + SwiGLU (+ MoE).

Port of `repro.models.transformer`, with `repro`'s layouts at the public
functions — activations (B, S, H, D), the KV cache (L, B, max_seq, Hkv, D)
and JAX's parameter shapes (stacked per layer) in `init_params`:

* serving: `prefill`, `decode_step` and `init_cache` on a `Transformer`
  module (weights cast to ``cfg.dtype`` once);
* training: `loss_fn(cfg, params, batch)` over `init_params`' fp32 master
  tree, whose leaves may require gradients.

`forward` dispatches on its first argument: ``forward(model, tokens)``
runs a `Transformer`, ``forward(cfg, params, tokens)`` is `repro`'s
training forward over the master tree — the embedding lookup on K5
(`kernels/embedding_bag`, differentiable), each layer cast to
``cfg.dtype`` inside autograd (`repro`'s ``_cast_layers``), so gradients
land on the fp32 masters, and with ``cfg.remat`` each layer under
``torch.utils.checkpoint(..., use_reentrant=False)``, `repro`'s
``jax.checkpoint(nothing_saveable)``: its forward runs again in the
backward.  Both paths run the same layer math (`attention_block`,
`ffn_block`, `rope`) on a layer given as a dict of `repro`'s keys: a
module's `Layer.tree` or a cast slice of the master tree.  The FFN of a
layer is the dense SwiGLU or, with ``cfg.moe``, the MoE layer of
`models/moe.py` (`repro`'s ``ffn_block`` dispatch); `loss_fn` adds no
load-balancing term, as `repro`'s adds none.

Every attention call, prefill, decode and training, goes through K6
(`kernels/flash_attention`): on a CUDA tensor the hand-written kernel, on
a CPU tensor its plain version; under autograd its `FlashAttention`
function, whose backward recomputes the attention in plain torch (by
design: `repro`'s Pallas kernel has no backward).  With ``cfg.attn ==
"sliding_window"`` every call passes ``window=cfg.window``.  Query head
``h`` reads KV head ``h // G``, the mapping of `repro`'s
``jnp.repeat(k, G, axis=2)``; the kernel does it natively, with no
repeated copy.  Projections, the FFN and the head are plain large
products (`torch.matmul`), as `repro` leaves them to XLA.

Differences from `repro` by design:

* `Transformer` holds the layers unstacked (a ``ModuleList``), cast to
  ``cfg.dtype`` once when it is built (`repro` casts the stack per call in
  `_cast_layers`; the values are identical).
* `prefill` writes K and V into the cache as the attention block computes
  them (`repro` recomputes them outside its remat'd layer; the values are
  the same), into a preallocated cache when one is passed.
* `decode_step` writes the new K and V into the cache **in place** at
  ``pos`` and returns the same cache; it takes one token per sequence.
* `build_model` draws the weights one layer at a time and casts each
  layer to ``cfg.dtype`` before the next is drawn, so the fp32 masters
  are never held whole: a 30B-parameter model fits one 80 GB card.
* The training forward walks the layers in a Python loop (`repro` scans
  over the stack); ``unroll`` stays a config field.
* Not ported: ``moe.impl="shardmap"`` (expert parallelism, slice C3).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import (
    dense_init,
    embed_init,
    rms_norm,
    stack_trees,
    tree_cast,
    tree_slice,
)
from repro_torch.models.moe import MoE, MoEConfig, init_moe, moe_apply


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    moe: MoEConfig | None = None
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16        # compute dtype
    param_dtype: Any = torch.float32   # master params
    attn_block_kv: int = 1024
    remat: bool = True
    attn: str = "full"                 # "full" | "sliding_window"
    window: int = 4096
    attn_impl: str = "auto"
    unroll: bool = False

    @property
    def q_per_kv(self) -> int:
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads={self.n_heads} is not a multiple of "
                             f"n_kv_heads={self.n_kv_heads}")
        return self.n_heads // self.n_kv_heads

    def n_params(self) -> int:
        d, h = self.d_model, self.n_heads * self.d_head
        kv = self.n_kv_heads * self.d_head
        attn = d * h + 2 * d * kv + h * d
        if self.moe is None:
            ffn = 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.moe.d_ff_expert * (self.moe.n_experts + self.moe.n_shared)
            ffn += d * self.moe.n_experts  # router
        return self.n_layers * (attn + ffn + 2 * d) + 2 * self.vocab * d + d

    def n_active_params(self) -> int:
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        h, kv = self.n_heads * self.d_head, self.n_kv_heads * self.d_head
        attn = d * h + 2 * d * kv + h * d
        ffn = 3 * d * self.moe.d_ff_expert * (self.moe.top_k + self.moe.n_shared)
        return self.n_layers * (attn + ffn + 2 * d) + 2 * self.vocab * d + d


def check_supported(cfg: LMConfig) -> None:
    """Raise for what the port does not run yet."""
    if cfg.moe is not None and cfg.moe.impl == "shardmap":
        raise NotImplementedError(
            f"{cfg.name}: moe.impl='shardmap' (expert parallelism) waits "
            "for the sharding slice (ROADMAP C3)")
    if cfg.attn not in ("full", "sliding_window"):
        raise ValueError(f"{cfg.name}: unknown attn={cfg.attn!r}")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_layer(cfg: LMConfig, generator: torch.Generator) -> dict:
    """One layer's parameter tree in ``cfg.param_dtype`` on the generator's
    device (`repro`'s ``init_layer``): norms, wq (d, H, dh), wk/wv (d, Hkv,
    dh), wo (H, dh, d), and ``ffn`` {wi, wg, wo} or ``moe`` (`init_moe`)."""
    check_supported(cfg)
    d, dh, pd = cfg.d_model, cfg.d_head, cfg.param_dtype
    ones = torch.ones((d,), dtype=pd, device=generator.device)
    p = {
        "attn_norm": ones,
        "wq": dense_init(generator, (d, cfg.n_heads, dh), dtype=pd),
        "wk": dense_init(generator, (d, cfg.n_kv_heads, dh), dtype=pd),
        "wv": dense_init(generator, (d, cfg.n_kv_heads, dh), dtype=pd),
        "wo": dense_init(generator, (cfg.n_heads, dh, d), dtype=pd),
        "ffn_norm": ones.clone(),
    }
    if cfg.moe is None:
        p["ffn"] = {"wi": dense_init(generator, (d, cfg.d_ff), dtype=pd),
                    "wg": dense_init(generator, (d, cfg.d_ff), dtype=pd),
                    "wo": dense_init(generator, (cfg.d_ff, d), dtype=pd)}
    else:
        p["moe"] = init_moe(cfg.moe, d, generator, pd)
    return p


def _outer(cfg: LMConfig, generator: torch.Generator, dtype) -> dict:
    """``embed`` (V, d), ``head`` (d, V) and ``final_norm`` (d,), drawn in
    fp32 and cast to ``dtype``."""
    d = cfg.d_model
    return {"embed": embed_init(generator, (cfg.vocab, d), dtype),
            "head": dense_init(generator, (d, cfg.vocab), dtype=dtype),
            "final_norm": torch.ones((d,), dtype=dtype,
                                     device=generator.device)}


def init_params(cfg: LMConfig, generator: torch.Generator) -> dict:
    """`repro`'s parameter tree in ``cfg.param_dtype`` on the generator's
    device: ``embed`` (V, d), ``head`` (d, V), ``final_norm`` (d,) and
    ``layers``, `init_layer`'s leaves stacked over a leading (n_layers,)
    dim.  Draws embed, head, then layer 0, 1, … (`build_model`'s order)."""
    check_supported(cfg)
    params = _outer(cfg, generator, cfg.param_dtype)
    params["layers"] = stack_trees([init_layer(cfg, generator)
                               for _ in range(cfg.n_layers)])
    return params


class Layer(nn.Module):
    """One decoder layer's weights in ``cfg.dtype``, in JAX's shapes: wq (d,
    H, dh), wk/wv (d, Hkv, dh), wo (H, dh, d); the dense FFN's wi/wg (d,
    d_ff) and w_down (d_ff, d), or ``moe`` (`models.moe.MoE`)."""

    def __init__(self, cfg: LMConfig, p: dict):
        super().__init__()
        dtype = cfg.dtype

        def param(t):
            return nn.Parameter(t.to(dtype), requires_grad=False)

        for name in ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm"):
            setattr(self, name, param(p[name]))
        if cfg.moe is None:
            self.wi = param(p["ffn"]["wi"])
            self.wg = param(p["ffn"]["wg"])
            self.w_down = param(p["ffn"]["wo"])
        else:
            self.moe = MoE(p["moe"], dtype)

    def tree(self) -> dict:
        """The layer under `repro`'s keys, as `attention_block` and
        `ffn_block` take it (``moe`` is the `MoE` module)."""
        p = {name: getattr(self, name) for name in
             ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm")}
        if hasattr(self, "moe"):
            p["moe"] = self.moe
        else:
            p["ffn"] = {"wi": self.wi, "wg": self.wg, "wo": self.w_down}
        return p


class Transformer(nn.Module):
    """The LM's weights in ``cfg.dtype``, the stacked layers unstacked.
    ``params["layers"]`` is `init_params`' stacked tree or an iterable of
    `init_layer` trees, each cast as it comes (`build_model`).

    ``attn_prefer`` is K6's dispatch for every attention call (`ops`
    ``prefer``): ``"auto"`` runs the kernel on the card and the plain
    version on the CPU.  Set to ``"ref"``, it forces the plain version on
    the card, to hold the kernel's model against the plain one."""

    def __init__(self, cfg: LMConfig, params: dict):
        check_supported(cfg)
        super().__init__()
        self.cfg = cfg
        self.attn_prefer = "auto"

        def param(t):
            return nn.Parameter(t.to(cfg.dtype), requires_grad=False)

        self.embed = param(params["embed"])
        self.head = param(params["head"])
        self.final_norm = param(params["final_norm"])
        layers = params["layers"]
        if isinstance(layers, dict):             # stacked over n_layers
            stacked = layers
            layers = (tree_slice(stacked, i) for i in range(cfg.n_layers))
        self.layers = nn.ModuleList(Layer(cfg, p) for p in layers)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def build_model(cfg: LMConfig, generator: torch.Generator) -> Transformer:
    """The model drawn one layer at a time on the generator's device: each
    layer's leaves in ``cfg.param_dtype`` by `init_layer`, cast to
    ``cfg.dtype``, the fp32 draw dropped before the next layer is drawn.
    Peak memory is the model in ``cfg.dtype`` plus one layer in fp32 (and,
    before any layer, the fp32 draw of the embedding or the head).

    The draws come in `init_params`' order from the same generator, so the
    weights equal ``Transformer(cfg, init_params(cfg, generator))``'s;
    `repro`'s come from `jax.random` and differ (parity with `repro` goes
    through converted weights, `convert.lm_params_from_numpy`)."""
    check_supported(cfg)
    params = _outer(cfg, generator, cfg.dtype)
    params["layers"] = (init_layer(cfg, generator)
                        for _ in range(cfg.n_layers))
    return Transformer(cfg, params)


# ---------------------------------------------------------------------------
# RoPE + attention
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotated by position pos (..., S); cos and sin are
    fp32, cast to x's type before they meet x."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[..., :, None, None].float() * freqs        # (..., S, 1, half)
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention_block(cfg: LMConfig, p: dict, x: torch.Tensor,
                    pos: torch.Tensor, k_cache: torch.Tensor | None = None,
                    v_cache: torch.Tensor | None = None, start: int = 0, *,
                    prefer: str = "auto"):
    """Self-attention of x (B, S, d) at positions pos (B, S); ``p`` holds
    the layer's ``attn_norm``, ``wq``, ``wk``, ``wv`` and ``wo`` in x's
    type.

    Without a cache, the S queries attend causally over their own keys
    (K6 with ``q_offset=0, kv_len=S``).  With one layer's cache (B,
    max_seq, Hkv, D), K and V are first written into it in place at
    ``start``, and the queries attend over the cache's first ``start + S``
    rows (``q_offset=start, kv_len=start + S``).  The sliding-window
    variant passes ``window=cfg.window`` to every call.  ``prefer`` is
    K6's dispatch.  Returns the block's output and this call's K (after
    rope) and V."""
    B, S, d = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    window = cfg.window if cfg.attn == "sliding_window" else None
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q = (h @ p["wq"].reshape(d, H * dh)).view(B, S, H, dh)
    k = (h @ p["wk"].reshape(d, Hkv * dh)).view(B, S, Hkv, dh)
    v = (h @ p["wv"].reshape(d, Hkv * dh)).view(B, S, Hkv, dh)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    if k_cache is None:
        out = flash_attention(q, k, v, causal=True, q_offset=0, kv_len=S,
                              window=window, prefer=prefer)
    else:
        k_cache[:, start:start + S] = k
        v_cache[:, start:start + S] = v
        out = flash_attention(q, k_cache, v_cache, causal=True,
                              q_offset=start, kv_len=start + S,
                              window=window, prefer=prefer)
    y = out.reshape(B, S, H * dh) @ p["wo"].reshape(H * dh, d)
    return y, (k, v)


def ffn_block(cfg: LMConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU over ``p["ffn"]`` {wi, wg, wo}: ``silu(h @ wg) * (h @ wi) @
    wo``, silu as ``g * sigmoid(g)`` (each op rounded to x's type, as
    `jax.nn.silu`); with ``cfg.moe``, the MoE layer ``p["moe"]`` (a `MoE`
    module or `init_moe`'s tree) on the same normed h."""
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if cfg.moe is not None:
        moe = p["moe"]
        if isinstance(moe, MoE):
            return moe(h, cfg.moe)
        return moe_apply(cfg.moe, moe, h, cfg.dtype)
    f = p["ffn"]
    g = h @ f["wg"]
    return (g * torch.sigmoid(g) * (h @ f["wi"])) @ f["wo"]


def _layer(cfg, p, x, pos, k_cache=None, v_cache=None, start=0, *,
           prefer="auto"):
    a, kv = attention_block(cfg, p, x, pos, k_cache, v_cache, start,
                            prefer=prefer)
    x = x + a
    return x + ffn_block(cfg, p, x), kv


def _logits(cfg: LMConfig, final_norm, head, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, final_norm, cfg.norm_eps)
    return x @ head


# ---------------------------------------------------------------------------
# Forward passes: the module (serving) and the master tree (training)
# ---------------------------------------------------------------------------

def forward(model_or_cfg, *args, **kwargs) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V): ``forward(model, tokens)`` runs a
    `Transformer`; ``forward(cfg, params, tokens, *, attn_prefer="auto")``
    is `repro`'s training forward over the master tree (see the module
    docstring)."""
    if isinstance(model_or_cfg, LMConfig):
        return _forward_params(model_or_cfg, *args, **kwargs)
    return _forward_model(model_or_cfg, *args, **kwargs)


def _forward_model(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    B, S = tokens.shape
    x = model.embed[tokens]
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    for layer in model.layers:
        x, _ = _layer(cfg, layer.tree(), x, pos, prefer=model.attn_prefer)
    return _logits(cfg, model.final_norm, model.head, x)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` (B, S, d) on K5 as bags of one row (weight 1),
    differentiable: `repro`'s ``jnp.take(embed, tokens, axis=0)``."""
    B, S = tokens.shape
    n = B * S
    seg = torch.arange(n, dtype=torch.int32, device=tokens.device)
    return embedding_bag(table, tokens.reshape(n).to(torch.int32), seg,
                         n).view(B, S, table.shape[1])


def _train_layer(cfg: LMConfig, p_master: dict, x: torch.Tensor,
                 pos: torch.Tensor, prefer: str) -> torch.Tensor:
    """One layer of the training forward: its master slice cast to
    ``cfg.dtype`` (inside autograd), then the layer."""
    x, _ = _layer(cfg, tree_cast(p_master, cfg.dtype), x, pos, prefer=prefer)
    return x


def _forward_params(cfg: LMConfig, params: dict, tokens: torch.Tensor, *,
                    attn_prefer: str = "auto") -> torch.Tensor:
    check_supported(cfg)
    B, S = tokens.shape
    x = embed_tokens(params["embed"].to(cfg.dtype), tokens)
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    for i in range(cfg.n_layers):
        p = tree_slice(params["layers"], i)
        if cfg.remat:
            x = checkpoint(_train_layer, cfg, p, x, pos, attn_prefer,
                           use_reentrant=False)
        else:
            x = _train_layer(cfg, p, x, pos, attn_prefer)
    return _logits(cfg, params["final_norm"], params["head"].to(cfg.dtype), x)


def loss_fn(cfg: LMConfig, params: dict, batch: dict, *,
            attn_prefer: str = "auto") -> torch.Tensor:
    """`repro`'s ``loss_fn``: next-token cross-entropy of ``batch``'s
    ``tokens`` against its ``labels`` (both (B, S) int), fp32 logsumexp −
    gold logit, masked mean by ``batch["mask"]`` (ones if absent) over
    max(Σmask, 1).  ``attn_prefer`` is K6's dispatch (``"ref"``: the plain
    attention)."""
    logits = forward(cfg, params, batch["tokens"],
                     attn_prefer=attn_prefer).float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# Serving (KV cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               device=None) -> dict:
    """Zeroed K and V caches, each (n_layers, batch, max_seq, Hkv, D) in
    ``cfg.dtype``."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def prefill(model: Transformer, tokens: torch.Tensor,
            cache: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Full forward over the prompt: the last position's logits (B, 1, V)
    and the populated cache.

    Without ``cache`` a new one of length S is returned, as `repro`'s
    prefill returns it; with one (max_seq ≥ S rows, e.g. from
    `init_cache`) its first S rows are written in place."""
    B, S = tokens.shape
    if cache is None:
        cache = init_cache(model.cfg, B, S, device=tokens.device)
    elif cache["k"].shape[2] < S:
        raise ValueError(f"cache holds {cache['k'].shape[2]} positions, the "
                         f"prompt {S}")
    x = model.embed[tokens]
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    for i, layer in enumerate(model.layers):
        x, (k, v) = _layer(model.cfg, layer.tree(), x, pos,
                           prefer=model.attn_prefer)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return _logits(model.cfg, model.final_norm, model.head, x[:, -1:]), cache


def decode_step(model: Transformer, cache: dict, tokens: torch.Tensor,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens (B, 1) at position ``pos`` → logits (B, 1, V).

    Writes the step's K and V into ``cache`` in place at ``pos`` (every
    sequence of the batch is at the same position) and attends over its
    first ``pos + 1`` rows; returns the same cache."""
    B, S = tokens.shape
    max_seq = cache["k"].shape[2]
    if S != 1:
        raise ValueError(f"decode_step takes one token per sequence, got {S}")
    if not 0 <= pos < max_seq:
        raise ValueError(f"pos={pos} outside the cache's {max_seq} positions")
    x = model.embed[tokens]
    posb = torch.full((B, 1), pos, device=tokens.device)
    for i, layer in enumerate(model.layers):
        x, _ = _layer(model.cfg, layer.tree(), x, posb, cache["k"][i],
                      cache["v"][i], pos, prefer=model.attn_prefer)
    return _logits(model.cfg, model.final_norm, model.head, x), cache
