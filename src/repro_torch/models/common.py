"""Shared model building blocks: init helpers, RMSNorm, LayerNorm, MLPs,
parameter trees (`tree_map`, `tree_leaves` in JAX's order, `tree_cast`).

Ports of `repro.models.common`.  The init functions take an explicit
`torch.Generator` (their tensors are made on its device); `jax.random` and
torch give different numbers from one seed, so parity goes through
converted parameters (`repro_torch.convert.lm_params_from_numpy`), not
through the seed.  `repro`'s `ShardRules` is an identity on one device and
is not ported (sharding is slice C3).
"""

from __future__ import annotations

import math

import torch


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
