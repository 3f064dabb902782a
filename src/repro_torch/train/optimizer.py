"""AdamW with decoupled weight decay + global-norm clipping.

Port of `repro.train.optimizer`: moment trees m and v in fp32, the step
count a 0-d int32 tensor, master params updated in fp32 and cast back to
each param's type.  Functional, as `repro`'s: `adamw_update` returns new
trees and leaves its inputs alone.  Trees are nested dicts of tensors
(`models.common.tree_map`); `global_norm` sums the leaves in JAX's
flattening order.  `abstract_opt_state` is `adamw_init`'s tree as
``meta`` tensors, for the dry run (`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    """Zero fp32 moments shaped like ``params`` (on its leaves' devices) and
    a zero int32 count on the first leaf's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_opt_state(params) -> dict:
    """`adamw_init`'s tree as ``meta`` tensors: the same keys, shapes and
    types (fp32 moments, a 0-d int32 count), no memory (`repro`'s
    ``abstract_opt_state``).  ``params`` may be ``meta`` tensors too."""
    def like(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return {"m": tree_map(like, params), "v": tree_map(like, params),
            "count": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(tree) -> torch.Tensor:
    """√(Σ over the leaves, in JAX's order, of Σ x²), in fp32."""
    total = None
    for leaf in tree_leaves(tree):
        s = torch.sum(leaf.float() ** 2)
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, grads, opt_state: dict, params, *,
                 gnorm: torch.Tensor | None = None):
    """Returns (new_params, new_opt_state, grad_norm): the gradients scaled
    by min(1, clip / max(‖g‖, 1e-12)), bias-corrected moments, and the
    decoupled decay ``lr · wd · p``.  ``gnorm`` is ‖g‖ when the caller has
    it: the norm of the whole tree when ``grads`` are one rank's slices
    (`repro_torch.dist.sharding.global_norm`), so every rank clips
    alike.  Default: `global_norm` of ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    count = opt_state["count"] + 1
    cf = count.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=cf.device), cf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=cf.device), cf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.float()
        new_p = pf - cfg.lr * (step + cfg.weight_decay * pf)
        return new_p.to(p.dtype), m, v

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return (_pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                            "count": count}, gnorm)


def _pick(tree, i):
    """The i-th member of each (p, m, v) leaf tuple of `adamw_update`."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
