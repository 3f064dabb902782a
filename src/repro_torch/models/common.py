"""Shared model building blocks: init helpers, RMSNorm, LayerNorm, MLPs,
parameter trees (`tree_map`, `tree_leaves` in JAX's order, `tree_cast`),
and the vocab-parallel lookup the LM and SASRec share
(`vocab_parallel_lookup`).

Ports of `repro.models.common`.  The init functions take an explicit
`torch.Generator` (their tensors are made on its device); `jax.random` and
torch give different numbers from one seed, so parity goes through
converted parameters (`repro_torch.convert.lm_params_from_numpy`), not
through the seed.  `ShardRules` is `repro`'s hook that every model call
takes; its default `NO_SHARD` is the one-process run, and
`repro_torch.dist.sharding.MeshRules` binds it to a mesh.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.kernels.embedding_bag.ops import embedding_bag


class ShardRules:
    """Logical-axis → placement hook threaded through every model call.

    Models name the axes of their weights and activations (``"batch"``,
    ``"heads"``, ``"experts"`` …); `repro_torch.dist.sharding.MeshRules`
    maps them onto mesh axes.  This default instance is the one-process
    run: no spec, and ``shard`` returns its input."""

    def spec(self, axes: Sequence[str | None], shape=None):
        return None

    def shard(self, x: torch.Tensor, axes: Sequence[str | None]) -> torch.Tensor:
        return x


NO_SHARD = ShardRules()


class _GradScale(torch.autograd.Function):
    """The identity, its gradient scaled by ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def grad_scale(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x``, its gradient scaled by ``s``: a sharded loss's share on one
    rank (``s`` = 1 / ranks; `repro_torch.dist.sharding.reduce_grads` sums
    the shares)."""
    return _GradScale.apply(x, s)


def vocab_parallel_lookup(table: torch.Tensor, ids: torch.Tensor,
                          weight: float, rules: ShardRules, entry, *,
                          prefer: str = "auto",
                          reduce: bool = True) -> torch.Tensor:
    """``weight · full[ids]`` for ids (N,) into the whole vocab → (N, d),
    where ``table`` is this rank's rows of ``full``: its shard
    ``rules.index(entry)`` of the vocab split over the spec entry's axes.
    K5 runs over the rank's rows with the ids another rank owns at weight 0
    (differentiable in ``table``: its backward is K5 on the transposed bag
    of the rank's rows), then the rows are summed over the entry's axes
    (``rules.psum``): one rank adds a row, the others exact zeros.  With
    ``reduce=False`` the caller sums what it makes of the partial rows
    (SASRec's candidate scores)."""
    rows = table.shape[0]
    local = ids - rules.index(entry) * rows
    own = (local >= 0) & (local < rows)
    n = ids.shape[0]
    seg = torch.arange(n, dtype=torch.int32, device=ids.device)
    w = own.to(table.dtype)
    x = embedding_bag(table, torch.where(own, local, 0).to(torch.int32), seg,
                      n, weights=w if weight == 1.0 else w * weight,
                      bags_of_one=True, prefer=prefer)
    return rules.psum(x, entry) if reduce else x


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    """Truncated normal in ±2σ with σ = scale / √fan_in (fan_in =
    ``shape[in_axis]``)."""
    std = scale / math.sqrt(shape[in_axis])
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (std * t).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32,
               scale: float = 1.0) -> torch.Tensor:
    """Normal / √d (d = ``shape[-1]``)."""
    t = torch.randn(shape, dtype=torch.float32, generator=generator,
                    device=generator.device)
    return (scale * t / math.sqrt(shape[-1])).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 accumulation; the normalised x is cast back to
    x's type before the scale, in `repro`'s order."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * gamma.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 mean and variance; the normalised x is cast back
    to x's type before γ and β, in `repro`'s order."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * gamma.to(x.dtype) + beta.to(x.dtype)


def mlp_init(generator: torch.Generator, sizes, dtype=torch.float32) -> dict:
    """`repro`'s ``mlp_init``: ``w{i}`` (sizes[i], sizes[i+1]) by
    `dense_init` and ``b{i}`` zeros, one pair a layer."""
    n = len(sizes) - 1
    tree = {f"w{i}": dense_init(generator, (sizes[i], sizes[i + 1]),
                                dtype=dtype) for i in range(n)}
    tree.update({f"b{i}": torch.zeros((sizes[i + 1],), dtype=dtype,
                                      device=generator.device)
                 for i in range(n)})
    return tree


def mlp_apply(params: dict, x: torch.Tensor, *, act=torch.nn.functional.silu,
              final_act: bool = False) -> torch.Tensor:
    """`repro`'s ``mlp_apply``: ``x @ w{i} + b{i}`` a layer, ``act`` (SiLU)
    between layers and none after the last unless ``final_act``."""
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list/tuple tree in JAX's flattening
    order (dict keys sorted); ``None`` is an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in JAX's order (as
    `tree_leaves` lists them), by the items of ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``jax.tree_util.tree_map`` over nested dicts, lists and tuples: ``fn``
    of each leaf of ``tree`` and the leaves at the same place in ``rest``
    (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def stack_trees(trees: list):
    """Trees of one structure stacked leaf by leaf along a new leading dim
    (`repro`'s ``jax.vmap`` of a per-layer init)."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def tree_slice(tree, i: int):
    """Entry ``i`` of a stacked tree's leading dim (a view of each
    leaf)."""
    return tree_map(lambda t: t[i], tree)


def tree_unbind(tree) -> list:
    """Every entry of a stacked tree's leading dim, each leaf unbound once:
    its backward is one stack of the entries' gradients, where a slice per
    entry (`tree_slice`) makes a full-size gradient per entry, traffic
    that grows with the square of the depth."""
    leaves = tree_leaves(tree)
    parts = [t.unbind(0) for t in leaves]
    return [tree_unflatten(tree, [p[i] for p in parts])
            for i in range(len(parts[0]))]


def tree_cast(tree, dtype):
    """Every floating tensor of a nested dict/list cast to ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_cast(v, dtype) for v in tree)
    return tree


def count_params(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))


def param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
