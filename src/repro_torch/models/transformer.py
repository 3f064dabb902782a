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
* ``moe.impl="shardmap"`` under `NO_SHARD` runs `moe_apply` (expert
  parallelism over one rank is the same math; `repro` needs a mesh).

Sharding.  Every block, `forward`, `loss_fn`, `prefill`, `decode_step`,
`init_cache`, `Transformer` and `build_model` take ``rules`` (`repro`'s
`ShardRules` hook; default `NO_SHARD`, the one-process run, unchanged).  Under a
`repro_torch.dist.sharding.MeshRules` on a `DeviceMesh` each rank holds
the slices of the weights that the rules' spec of each full shape gives
it (`Transformer` and `build_model` slice; the master-tree functions take
a tree placed by `train.checkpoint.reshard`) and runs its part, where
`repro` leaves the partitioning to GSPMD:

* attention: the rank's query heads (slices of ``wq`` and ``wo``) and the
  KV heads they read (``h // G``: ``wk``/``wv`` sliced when their heads
  divide the model axis, else every rank holds all of them and its K6
  call reads its own), then the output's partial sums summed over
  ``model``;
* dense FFN: column slices of ``wi``/``wg``, row slices of ``wo``, the
  partial sums summed;
* embedding: a vocab-parallel lookup — K5 on the rank's rows, foreign ids
  at weight 0, the rows summed; the head: the rank's vocab columns, all
  gathered for serving, a distributed logsumexp and the gold logit from
  its owner in `loss_fn`;
* MoE: ``impl="shardmap"`` is `moe_apply_shardmap` (expert parallelism,
  capacity per rank) on the residual stream's own tokens;
  ``impl="pjit"``, `repro`'s default, is `moe_apply_pjit`: `repro`'s
  GSPMD-partitioned layer, whose meaning is the one-process layer's on
  the global batch (the capacity from the global token count), each rank
  running its experts' rows and the shared experts' column / row slices.

Sequence parallelism (`repro`'s ``("batch", "act_seq", "embed")`` under
``lm_rules(seq_shard=True)``, the default): where S divides the model
axis the residual stream between blocks is each rank's slice of the
sequence (`_stream_seq`), so remat's saved layer inputs are S / model
rows.  Each block norms its slice, all-gathers the norm along the sequence
before its projections (the shardmap MoE takes the slice as it is), and
reduce-scatters its partial sums back to the slice where an all-reduce
stood; the embedding's sum is a reduce-scatter too, and the head gathers
the sequence first.  Where S does
not divide (a decode step's S = 1), or with ``seq_shard=False``, the
stream is whole on every model rank and the sums are all-reduces.  Results
are unchanged up to the order of the sums.

A spec of one shard (world size 1) runs the one-process math, its
collectives over one rank.  The batch is each rank's own (the caller
splits it over the data axes, `launch.cells.lm_train_step`), and
`loss_fn` is the global masked mean: the local sums and counts
all-reduced over the data axes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import cache_specs_lm, spec_bytes, tree_specs
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import (
    NO_SHARD,
    ShardRules,
    dense_init,
    embed_init,
    grad_scale,
    rms_norm,
    stack_trees,
    tree_cast,
    tree_slice,
    tree_unbind,
    vocab_parallel_lookup,
)
from repro_torch.models.moe import (
    MoE,
    MoEConfig,
    init_moe,
    moe_apply,
    moe_apply_pjit,
    moe_apply_shardmap,
    shared_ffn,
)


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
    """Raise for a config the model does not run."""
    if cfg.attn not in ("full", "sliding_window"):
        raise ValueError(f"{cfg.name}: unknown attn={cfg.attn!r}")
    if cfg.moe is not None and cfg.moe.impl not in ("pjit", "shardmap"):
        raise ValueError(f"{cfg.name}: unknown moe.impl={cfg.moe.impl!r}")


# ---------------------------------------------------------------------------
# Specs and memory
# ---------------------------------------------------------------------------

def _on_mesh(rules: ShardRules) -> bool:
    """Whether ``rules`` bind a mesh (a `MeshRules`), not `NO_SHARD`."""
    return getattr(rules, "mesh", None) is not None


def _entry(rules: ShardRules, logical, shape, dim: int):
    """The spec entry of dim ``dim`` (None: replicated, or `NO_SHARD`)."""
    spec = rules.spec(logical, shape)
    return None if spec is None else spec[dim]


def _count(rules: ShardRules, entry) -> int:
    return 1 if entry is None else rules.count(entry)


def _data_entry(rules: ShardRules):
    """The mesh axes the batch is split over (None: not split)."""
    spec = rules.spec(("batch",))
    return None if spec is None else spec[0]


def _stream_seq(rules: ShardRules, B: int, S: int, d: int):
    """The spec entry the residual stream's sequence dim is split over:
    `repro`'s ``("batch", "act_seq", "embed")`` for this rank's (B, S, d)
    batch — ``model`` under ``lm_rules(seq_shard=True)`` when S divides it
    (sequence parallelism), None when the stream stays whole (`NO_SHARD`,
    ``seq_shard=False``, a decode step's S = 1)."""
    if not _on_mesh(rules):
        return None
    n_data = _count(rules, _data_entry(rules))
    return rules.spec(("batch", "act_seq", "embed"), (B * n_data, S, d))[1]


def _seq_gather(rules: ShardRules, x: torch.Tensor, seq) -> torch.Tensor:
    """The whole sequence (dim 1) from every rank's slice (``seq`` None:
    x, already whole)."""
    return x if seq is None else rules.gather(x, seq, 1)


def _to_stream(rules: ShardRules, y: torch.Tensor, entry, seq
               ) -> torch.Tensor:
    """A block's output (B, S, d), partial sums over the spec entry
    ``entry`` (None: whole on the rank), as the residual stream holds it:
    reduce-scattered along the sequence when ``seq`` is the same entry,
    else all-reduced and, under ``seq``, cut to this rank's slice."""
    if seq is not None and entry == seq:
        return rules.scatter(y, seq, 1)
    if entry is not None:
        y = rules.psum(y, entry)
    if seq is None:
        return y
    n = y.shape[1] // rules.count(seq)
    return y.narrow(1, rules.index(seq) * n, n)


def abstract_params(cfg: LMConfig) -> dict:
    """`init_params`' tree as meta tensors (shapes and types, no memory):
    `repro`'s ``abstract_params``."""
    d, dh, L = cfg.d_model, cfg.d_head, cfg.n_layers
    dt = cfg.param_dtype

    def t(*shape):
        return torch.empty(shape, dtype=dt, device="meta")

    layer = {"attn_norm": t(L, d), "wq": t(L, d, cfg.n_heads, dh),
             "wk": t(L, d, cfg.n_kv_heads, dh),
             "wv": t(L, d, cfg.n_kv_heads, dh),
             "wo": t(L, cfg.n_heads, dh, d), "ffn_norm": t(L, d)}
    if cfg.moe is None:
        layer["ffn"] = {"wi": t(L, d, cfg.d_ff), "wg": t(L, d, cfg.d_ff),
                        "wo": t(L, cfg.d_ff, d)}
    else:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        moe = {"router": torch.empty((L, d, e), dtype=torch.float32,
                                     device="meta"),
               "wi": t(L, e, d, f), "wg": t(L, e, d, f), "wo": t(L, e, f, d)}
        if cfg.moe.n_shared:
            fs = f * cfg.moe.n_shared
            moe.update(shared_wi=t(L, d, fs), shared_wg=t(L, d, fs),
                       shared_wo=t(L, fs, d))
        layer["moe"] = moe
    return {"embed": t(cfg.vocab, d), "head": t(d, cfg.vocab),
            "final_norm": t(d), "layers": layer}


def _memory_bytes(device: torch.device) -> int:
    """The card's memory, or the host's memory available now."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")


def check_fits(cfg: LMConfig, device, dtype, rules: ShardRules = NO_SHARD
               ) -> int:
    """The bytes of the weights in ``dtype`` that one rank holds under
    ``rules``; raises `MemoryError` when they exceed the device's memory
    (the card's, or the host's available memory), before anything is
    drawn."""
    device = torch.device(device)
    size = torch.empty((), dtype=dtype).element_size()
    tree = abstract_params(cfg)
    if not _on_mesh(rules):
        need = cfg.n_params() * size
    else:
        need = spec_bytes(tree, tree_specs(rules, tree), rules.mesh, size)
    have = _memory_bytes(device)
    if need > have:
        where = "one rank" if _on_mesh(rules) else "one process"
        raise MemoryError(
            f"{cfg.name}: {need / 1e9:.1f} GB of {dtype} weights on {where} "
            f"do not fit the {have / 1e9:.1f} GB of {device}; shard them "
            "across ranks (rules=lm_rules(mesh))")
    return need


def _place(rules: ShardRules, t: torch.Tensor, spec, dtype) -> torch.Tensor:
    """``t`` in ``dtype``, sliced to this rank's block of ``spec`` (a copy
    of the block alone, so the full tensor can be dropped)."""
    if spec is None:
        return t.to(dtype)
    return rules.local(t, spec).to(dtype=dtype, copy=True)


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
    dim.  Draws embed, head, then layer 0, 1, … (`build_model`'s order).
    Raises `MemoryError` when the masters exceed the generator's device
    (`check_fits`)."""
    check_supported(cfg)
    check_fits(cfg, generator.device, cfg.param_dtype)
    params = _outer(cfg, generator, cfg.param_dtype)
    params["layers"] = stack_trees([init_layer(cfg, generator)
                               for _ in range(cfg.n_layers)])
    return params


class Layer(nn.Module):
    """One decoder layer's weights in ``cfg.dtype``, in JAX's shapes: wq (d,
    H, dh), wk/wv (d, Hkv, dh), wo (H, dh, d); the dense FFN's wi/wg (d,
    d_ff) and w_down (d_ff, d), or ``moe`` (`models.moe.MoE`).  Under
    ``rules`` each is this rank's slice of the full one in ``p``."""

    def __init__(self, cfg: LMConfig, p: dict, rules: ShardRules = NO_SHARD):
        super().__init__()
        dtype = cfg.dtype
        specs = tree_specs(rules, p, layer=True)

        def param(t, spec):
            return nn.Parameter(_place(rules, t, spec, dtype),
                                requires_grad=False)

        for name in ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm"):
            setattr(self, name, param(p[name], specs[name]))
        if cfg.moe is None:
            f, fs = p["ffn"], specs["ffn"]
            self.wi = param(f["wi"], fs["wi"])
            self.wg = param(f["wg"], fs["wg"])
            self.w_down = param(f["wo"], fs["wo"])
        else:
            self.moe = MoE({k: _place(rules, t, specs["moe"][k], dtype)
                            for k, t in p["moe"].items()}, dtype)

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
    the card, to hold the kernel's model against the plain one.

    ``rules``: under a `MeshRules` the module holds this rank's slice of
    each weight (``params`` are the full ones; each is sliced as it is
    cast) and every call runs the rank's part (the module docstring)."""

    def __init__(self, cfg: LMConfig, params: dict,
                 rules: ShardRules = NO_SHARD):
        check_supported(cfg)
        super().__init__()
        self.cfg = cfg
        self.rules = rules
        self.attn_prefer = "auto"
        outer = {k: params[k] for k in ("embed", "head", "final_norm")}
        specs = tree_specs(rules, outer)

        def param(name):
            return nn.Parameter(_place(rules, params[name], specs[name],
                                       cfg.dtype), requires_grad=False)

        self.embed = param("embed")
        self.head = param("head")
        self.final_norm = param("final_norm")
        layers = params["layers"]
        if isinstance(layers, dict):             # stacked over n_layers
            stacked = layers
            layers = (tree_slice(stacked, i) for i in range(cfg.n_layers))
        self.layers = nn.ModuleList(Layer(cfg, p, rules) for p in layers)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def build_model(cfg: LMConfig, generator: torch.Generator,
                rules: ShardRules = NO_SHARD) -> Transformer:
    """The model drawn one layer at a time on the generator's device: each
    layer's leaves in ``cfg.param_dtype`` by `init_layer`, cast to
    ``cfg.dtype``, the fp32 draw dropped before the next layer is drawn.
    Peak memory is the model in ``cfg.dtype`` plus one layer in fp32 (and,
    before any layer, the fp32 draw of the embedding or the head).  Under
    ``rules`` each rank draws every layer whole and keeps its slices, so
    its weights are the one-process model's slices; it holds its share of
    the model plus one layer in fp32.  Raises `MemoryError` before drawing
    when the rank's share does not fit its device (`check_fits`):
    mistral-large-123b's 245 GB of bf16 on one process.

    The draws come in `init_params`' order from the same generator, so the
    weights equal ``Transformer(cfg, init_params(cfg, generator))``'s;
    `repro`'s come from `jax.random` and differ (parity with `repro` goes
    through converted weights, `convert.lm_params_from_numpy`)."""
    check_supported(cfg)
    check_fits(cfg, generator.device, cfg.dtype, rules)
    params = _outer(cfg, generator, cfg.dtype)
    params["layers"] = (init_layer(cfg, generator)
                        for _ in range(cfg.n_layers))
    return Transformer(cfg, params, rules)


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


def _kv_heads(cfg: LMConfig, p: dict, rules: ShardRules):
    """The KV heads this rank's query heads read (``h // G``), as a
    function of a (B, S, Hkv_local, D) tensor: the identity when the KV
    heads are sliced alike (or nothing is sharded); else, with every KV
    head held, the run of them its query heads read, or a gather of one
    KV head per query head where the two do not tile."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    H_l, Hkv_l = p["wq"].shape[1], p["wk"].shape[1]
    if H_l == H or Hkv_l != Hkv:
        return lambda t: t
    G = H // Hkv
    q_entry = _entry(rules, (None, "heads", None),
                     (cfg.d_model, H, cfg.d_head), 1)
    h0 = rules.index(q_entry) * H_l
    if H_l % G == 0:
        lo, hi = h0 // G, (h0 + H_l) // G
    elif G % H_l == 0:
        lo, hi = h0 // G, h0 // G + 1
    else:
        idx = torch.arange(h0, h0 + H_l) // G
        return lambda t: t.index_select(2, idx.to(t.device))
    return lambda t: t[:, :, lo:hi]


def attention_block(cfg: LMConfig, p: dict, x: torch.Tensor,
                    pos: torch.Tensor, k_cache: torch.Tensor | None = None,
                    v_cache: torch.Tensor | None = None, start: int = 0, *,
                    prefer: str = "auto", rules: ShardRules = NO_SHARD,
                    seq=None):
    """Self-attention of x (B, S, d) at positions pos (B, S); ``p`` holds
    the layer's ``attn_norm``, ``wq``, ``wk``, ``wv`` and ``wo`` in x's
    type (under ``rules``, this rank's slices).

    Without a cache, the S queries attend causally over their own keys
    (K6 with ``q_offset=0, kv_len=S``).  With one layer's cache (B,
    max_seq, Hkv, D), K and V are first written into it in place at
    ``start``, and the queries attend over the cache's first ``start + S``
    rows (``q_offset=start, kv_len=start + S``).  The sliding-window
    variant passes ``window=cfg.window`` to every call.  ``prefer`` is
    K6's dispatch.  Under ``rules`` the rank's query heads attend over the
    KV heads they read and the output projection's partial sums are
    summed over the heads' axes; under sequence parallelism (``seq``, the
    spec entry of x's sequence dim) x is this rank's slice of the
    sequence: its norm is all-gathered along the sequence before the
    projections, and the output reduce-scattered back to the slice
    (`_to_stream`).  Returns the block's output and this call's K (after
    rope) and V, for the whole sequence."""
    dh = cfg.d_head
    H, Hkv = p["wq"].shape[1], p["wk"].shape[1]       # this rank's heads
    window = cfg.window if cfg.attn == "sliding_window" else None
    h = _seq_gather(rules, rms_norm(x, p["attn_norm"], cfg.norm_eps), seq)
    B, S, d = h.shape
    q = (h @ p["wq"].reshape(d, H * dh)).view(B, S, H, dh)
    k = (h @ p["wk"].reshape(d, Hkv * dh)).view(B, S, Hkv, dh)
    v = (h @ p["wv"].reshape(d, Hkv * dh)).view(B, S, Hkv, dh)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    read = _kv_heads(cfg, p, rules)
    if k_cache is None:
        out = flash_attention(q, read(k), read(v), causal=True, q_offset=0,
                              kv_len=S, window=window, prefer=prefer)
    else:
        k_cache[:, start:start + S] = k
        v_cache[:, start:start + S] = v
        out = flash_attention(q, read(k_cache), read(v_cache), causal=True,
                              q_offset=start, kv_len=start + S,
                              window=window, prefer=prefer)
    y = out.reshape(B, S, H * dh) @ p["wo"].reshape(H * dh, d)
    heads = _entry(rules, ("heads", None, None), (cfg.n_heads, dh, d), 0)
    return _to_stream(rules, y, heads, seq), (k, v)


def _moe_shardmap_block(cfg: LMConfig, moe_p: dict, h: torch.Tensor,
                        rules: ShardRules) -> torch.Tensor:
    """Expert-parallel MoE (`moe_apply_shardmap`) on `repro`'s token layout
    ``("batch", "act_seq", "embed")``, which is the residual stream's: h
    (B_loc, S_loc, d) is this rank's batch and, under sequence
    parallelism, its slice of the sequence (all of it otherwise, as in a
    decode step); the output keeps that layout.  Expert weights arrive
    per ``("experts", "fsdp", None)``: their ``d`` dim is gathered over the
    data axes when the spec shards it."""
    moe = cfg.moe
    E, d, f = moe.n_experts, cfg.d_model, moe.d_ff_expert
    wi_spec = rules.spec(("experts", "fsdp", None), (E, d, f))
    if wi_spec[0] != "model":
        raise ValueError(f"{cfg.name}: moe.impl='shardmap' needs the {E} "
                         "experts split over the mesh's 'model' axis (spec "
                         f"{wi_spec})")
    shared = bool(moe.n_shared) and _entry(
        rules, (None, "ffn"), (d, f * moe.n_shared), 1) is not None
    return moe_apply_shardmap(moe, moe_p, h, data_axes=wi_spec[1],
                              model_axis="model", dtype=cfg.dtype,
                              rules=rules, fsdp_gather=wi_spec[1] is not None,
                              shared_gather=shared)


def _moe_pjit_block(cfg: LMConfig, moe_p: dict, h: torch.Tensor,
                    rules: ShardRules, seq=None) -> torch.Tensor:
    """`repro`'s GSPMD-partitioned MoE (`moe_apply_pjit`: the one-process
    layer on the global batch, capacity from the global token count) on
    the residual stream's layout: h (B_loc, S_loc, d), gathered along the
    sequence under ``seq``.  Each rank runs its experts of the
    ``("experts", "fsdp", None)`` spec (FSDP ``d`` dims gathered over the
    data axes) and the shared experts' column / row slices of the dense
    FFN's spec; the partial sums go back to the stream by `_to_stream`
    (one collective when both split alike)."""
    moe = cfg.moe
    E, d, f = moe.n_experts, cfg.d_model, moe.d_ff_expert
    h = _seq_gather(rules, h, seq)
    experts, fsdp, _ = rules.spec(("experts", "fsdp", None), (E, d, f))
    y = moe_apply_pjit(moe, moe_p, h, dtype=cfg.dtype, rules=rules,
                       data_axes=_data_entry(rules), expert_axes=experts,
                       fsdp_axes=fsdp)
    if not moe.n_shared:
        return _to_stream(rules, y, experts, seq)
    s = shared_ffn(h.reshape(-1, d), moe_p["shared_wi"], moe_p["shared_wg"],
                   moe_p["shared_wo"], cfg.dtype).view_as(y)
    shared = _entry(rules, (None, "ffn"), (d, f * moe.n_shared), 1)
    if shared == experts:
        return _to_stream(rules, y + s, experts, seq)
    return _to_stream(rules, y, experts, seq) + _to_stream(rules, s, shared,
                                                           seq)


def ffn_block(cfg: LMConfig, p: dict, x: torch.Tensor, *,
              rules: ShardRules = NO_SHARD, seq=None) -> torch.Tensor:
    """SwiGLU over ``p["ffn"]`` {wi, wg, wo}: ``silu(h @ wg) * (h @ wi) @
    wo``, silu as ``g * sigmoid(g)`` (each op rounded to x's type, as
    `jax.nn.silu`); with ``cfg.moe``, the MoE layer ``p["moe"]`` (a `MoE`
    module or `init_moe`'s tree) on the same normed h.  Under ``rules``:
    the FFN's column / row slices, the norm all-gathered along the
    sequence first under ``seq`` and the output summed back to the stream
    (`_to_stream`); the MoE by its ``impl``: ``"shardmap"`` runs
    `moe_apply_shardmap` on the stream's own tokens, ``"pjit"``
    `_moe_pjit_block` (the module docstring)."""
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if cfg.moe is not None:
        moe = p["moe"]
        tree = moe.tree() if isinstance(moe, MoE) else moe
        if not _on_mesh(rules):
            if isinstance(moe, MoE):
                return moe(h, cfg.moe)
            return moe_apply(cfg.moe, moe, h, cfg.dtype)
        if cfg.moe.impl == "shardmap":
            return _moe_shardmap_block(cfg, tree, h, rules)
        return _moe_pjit_block(cfg, tree, h, rules, seq)
    h = _seq_gather(rules, h, seq)
    f = p["ffn"]
    g = h @ f["wg"]
    y = (g * torch.sigmoid(g) * (h @ f["wi"])) @ f["wo"]
    ffn = _entry(rules, ("ffn", None), (cfg.d_ff, cfg.d_model), 0)
    return _to_stream(rules, y, ffn, seq)


def _layer(cfg, p, x, pos, k_cache=None, v_cache=None, start=0, *,
           prefer="auto", rules=NO_SHARD, seq=None):
    a, kv = attention_block(cfg, p, x, pos, k_cache, v_cache, start,
                            prefer=prefer, rules=rules, seq=seq)
    x = x + a
    return x + ffn_block(cfg, p, x, rules=rules, seq=seq), kv


def _vocab(cfg: LMConfig, rules: ShardRules):
    """The spec entry the vocab dim is split over (None: whole)."""
    return _entry(rules, ("vocab", None), (cfg.vocab, cfg.d_model), 0)


def _logits(cfg: LMConfig, final_norm, head, x: torch.Tensor,
            rules: ShardRules = NO_SHARD, gather: bool = True
            ) -> torch.Tensor:
    """The final norm and the head of x (the whole sequence); under
    ``rules`` the rank's vocab columns, all-gathered along the vocab dim
    when ``gather``."""
    x = rms_norm(x, final_norm, cfg.norm_eps)
    logits = x @ head
    vocab = _vocab(cfg, rules)
    if gather and vocab is not None:
        logits = rules.gather(logits, vocab, logits.ndim - 1)
    return logits


def _embed(cfg: LMConfig, table: torch.Tensor, tokens: torch.Tensor,
           rules: ShardRules, plain, seq=None) -> torch.Tensor:
    """The residual stream's first value for tokens (B, S):
    ``plain(table, tokens)`` when the vocab is whole on the rank, else
    `vocab_parallel_lookup` over the vocab's axes, its rows summed back to
    the stream (`_to_stream`: reduce-scattered to this rank's slice of the
    sequence under ``seq``)."""
    vocab = _vocab(cfg, rules)
    if _count(rules, vocab) == 1:
        return _to_stream(rules, plain(table, tokens), vocab, seq)
    B, S = tokens.shape
    x = vocab_parallel_lookup(table, tokens.reshape(-1), 1.0, rules, vocab,
                              reduce=False)
    return _to_stream(rules, x.view(B, S, table.shape[1]), vocab, seq)


def _index_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


# ---------------------------------------------------------------------------
# Forward passes: the module (serving) and the master tree (training)
# ---------------------------------------------------------------------------

def forward(model_or_cfg, *args, **kwargs) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V): ``forward(model, tokens)`` runs a
    `Transformer`; ``forward(cfg, params, tokens, *, attn_prefer="auto",
    rules=NO_SHARD)`` is `repro`'s training forward over the master tree
    (see the module docstring)."""
    if isinstance(model_or_cfg, LMConfig):
        return _forward_params(model_or_cfg, *args, **kwargs)
    return _forward_model(model_or_cfg, *args, **kwargs)


def _forward_model(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    cfg, rules = model.cfg, model.rules
    B, S = tokens.shape
    seq = _stream_seq(rules, B, S, cfg.d_model)
    x = _embed(cfg, model.embed, tokens, rules, _index_rows, seq)
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    for layer in model.layers:
        x, _ = _layer(cfg, layer.tree(), x, pos, prefer=model.attn_prefer,
                      rules=rules, seq=seq)
    return _logits(cfg, model.final_norm, model.head,
                   _seq_gather(rules, x, seq), rules)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` (B, S, d) on K5 as bags of one row (weight 1),
    differentiable: `repro`'s ``jnp.take(embed, tokens, axis=0)``."""
    B, S = tokens.shape
    n = B * S
    seg = torch.arange(n, dtype=torch.int32, device=tokens.device)
    return embedding_bag(table, tokens.reshape(n).to(torch.int32), seg,
                         n, bags_of_one=True).view(B, S, table.shape[1])


def _train_layer(cfg: LMConfig, p_master: dict, x: torch.Tensor,
                 pos: torch.Tensor, prefer: str,
                 rules: ShardRules = NO_SHARD, seq=None) -> torch.Tensor:
    """One layer of the training forward: its master slice cast to
    ``cfg.dtype`` (inside autograd), then the layer."""
    x, _ = _layer(cfg, tree_cast(p_master, cfg.dtype), x, pos, prefer=prefer,
                  rules=rules, seq=seq)
    return x


def _forward_params(cfg: LMConfig, params: dict, tokens: torch.Tensor, *,
                    attn_prefer: str = "auto", rules: ShardRules = NO_SHARD,
                    gather: bool = True) -> torch.Tensor:
    check_supported(cfg)
    B, S = tokens.shape
    seq = _stream_seq(rules, B, S, cfg.d_model)
    x = _embed(cfg, params["embed"].to(cfg.dtype), tokens, rules,
               embed_tokens, seq)
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    for p in tree_unbind(params["layers"]):
        if cfg.remat:
            x = checkpoint(_train_layer, cfg, p, x, pos, attn_prefer, rules,
                           seq, use_reentrant=False)
        else:
            x = _train_layer(cfg, p, x, pos, attn_prefer, rules, seq)
    return _logits(cfg, params["final_norm"], params["head"].to(cfg.dtype),
                   _seq_gather(rules, x, seq), rules, gather)


def loss_fn(cfg: LMConfig, params: dict, batch: dict, *,
            attn_prefer: str = "auto",
            rules: ShardRules = NO_SHARD) -> torch.Tensor:
    """`repro`'s ``loss_fn``: next-token cross-entropy of ``batch``'s
    ``tokens`` against its ``labels`` (both (B, S) int), fp32 logsumexp −
    gold logit, masked mean by ``batch["mask"]`` (ones if absent) over
    max(Σmask, 1).  ``attn_prefer`` is K6's dispatch (``"ref"``: the plain
    attention).

    Under ``rules``: ``params`` and ``batch`` are this rank's; with the
    vocab split, the logsumexp is distributed (the max and the sum of
    exponentials all-reduced) and the gold logit comes from the rank that
    owns its column; the sums and counts are all-reduced over the data
    axes, so every rank returns the global loss.  Its gradient on a rank
    is the rank's share (1 / ranks of the sum of the ranks' losses;
    `repro_torch.dist.sharding.reduce_grads` sums the shares)."""
    logits = _forward_params(cfg, params, batch["tokens"],
                             attn_prefer=attn_prefer, rules=rules,
                             gather=False).float()
    labels = batch["labels"].long()
    vocab = _vocab(cfg, rules)
    if _count(rules, vocab) == 1:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        cols = logits.shape[-1]
        top = rules.pmax(logits.detach().amax(-1), vocab)
        total = rules.psum(torch.exp(logits - top[..., None]).sum(-1), vocab)
        logz = top + torch.log(total)
        local = labels - rules.index(vocab) * cols
        own = (local >= 0) & (local < cols)
        g = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])
        gold = rules.psum(torch.where(own, g[..., 0], 0.0), vocab)
    nll = logz - gold
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    num, den = (nll * mask).sum(), mask.sum()
    data = _data_entry(rules)
    if data is not None:
        num, den = rules.psum(num, data), rules.psum(den, data)
    loss = num / den.clamp_min(1.0)
    if _on_mesh(rules) and rules.n_ranks > 1:
        loss = grad_scale(loss, 1.0 / rules.n_ranks)
    return loss


# ---------------------------------------------------------------------------
# Serving (KV cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_seq: int, device=None, *,
               rules: ShardRules = NO_SHARD) -> dict:
    """Zeroed K and V caches, each (n_layers, batch, max_seq, Hkv, D) in
    ``cfg.dtype``; under ``rules``, this rank's block of them
    (`repro_torch.dist.sharding.cache_specs_lm`: the batch over the data
    axes, the KV heads over ``model`` when they divide it)."""
    shape = [cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head]
    if _on_mesh(rules):
        for dim, entry in enumerate(cache_specs_lm(cfg, rules.mesh)["k"]):
            n = _count(rules, entry)
            if shape[dim] % n:
                raise ValueError(f"cache dim {dim} ({shape[dim]}) does not "
                                 f"split over {entry} ({n} shards)")
            shape[dim] //= n
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def prefill(model: Transformer, tokens: torch.Tensor,
            cache: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Full forward over the prompt: the last position's logits (B, 1, V)
    and the populated cache.

    Without ``cache`` a new one of length S is returned, as `repro`'s
    prefill returns it; with one (max_seq ≥ S rows, e.g. from
    `init_cache`) its first S rows are written in place.  Under the
    model's rules, ``tokens`` are this rank's sequences and the cache its
    block."""
    B, S = tokens.shape
    cfg, rules = model.cfg, model.rules
    if cache is None:
        cache = init_cache(cfg, B * _count(rules, _data_entry(rules)), S,
                           device=tokens.device, rules=rules)
    elif cache["k"].shape[2] < S:
        raise ValueError(f"cache holds {cache['k'].shape[2]} positions, the "
                         f"prompt {S}")
    seq = _stream_seq(rules, B, S, cfg.d_model)
    x = _embed(cfg, model.embed, tokens, rules, _index_rows, seq)
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    for i, layer in enumerate(model.layers):
        x, (k, v) = _layer(cfg, layer.tree(), x, pos,
                           prefer=model.attn_prefer, rules=rules, seq=seq)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    x = _seq_gather(rules, x, seq)[:, -1:]
    return _logits(cfg, model.final_norm, model.head, x, rules), cache


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
    cfg, rules = model.cfg, model.rules
    seq = _stream_seq(rules, B, S, cfg.d_model)
    x = _embed(cfg, model.embed, tokens, rules, _index_rows, seq)
    posb = torch.full((B, 1), pos, device=tokens.device)
    for i, layer in enumerate(model.layers):
        x, _ = _layer(cfg, layer.tree(), x, posb, cache["k"][i],
                      cache["v"][i], pos, prefer=model.attn_prefer,
                      rules=rules, seq=seq)
    return _logits(cfg, model.final_norm, model.head,
                   _seq_gather(rules, x, seq), rules), cache
