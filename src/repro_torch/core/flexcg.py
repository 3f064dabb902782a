"""Flexible preconditioned conjugate gradients (paper §7), in PyTorch.

The math is `repro.core.flexcg`'s: ``L x = b`` for the singular graph
Laplacian restricted to the complement of the constants, with

* the **first search direction NOT preconditioned** (``p₀ = r₀``), so that
  once inverse iteration feeds an eigenvector as the right-hand side the
  solve converges in a single iteration — the outer loop's stopping signal;
* the **flexible β** (Polak–Ribière form) that admits a variable
  preconditioner (an AMG V-cycle);
* masked dots and a constant deflation of every residual and
  preconditioned vector, so padded entries never contribute.

It is batched the same way: ``b`` may carry leading batch dims (the vector
axis is the last one), every reduction is per problem, and a converged
problem's state is frozen by `torch.where` on its ``act`` flag (never by an
in-place update, which would let a frozen problem move) while the loop runs
on until every problem is done.

Where JAX runs a ``lax.while_loop`` whose condition is ``any(active)`` on
the device, the port runs a Python loop, and reading that flag drains the
launch queue.  Because a frozen iteration is an exact no-op — with ``act``
false everywhere every state and ``k`` keep their bits — the loop reads the
flag only every ``_CHECK_EVERY`` iterations and returns the same ``x``,
``iters`` and ``resnorm`` as reading it after every iteration.  The price
is up to ``_CHECK_EVERY − 1`` frozen passes after the last problem
converges.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

_CHECK_EVERY = 4   # iterations between host reads of the "any active" flag


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-problem dot product: reduce the vector (last) axis, keepdim."""
    return (a * b).sum(-1, keepdim=True)


def _project_out_ones(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Remove the (masked) constant component: x ← (x − mean_mask(x))·mask.

    Batched over any leading dims (the reduction is per problem)."""
    m = _vdot(x, mask) / torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    return (x - m) * mask


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iters: torch.Tensor    # per-problem iteration counts (0-d for 1-D input)
    resnorm: torch.Tensor  # per-problem final residual norms


def flexcg(
    op: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    *,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    x0: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    tol: float = 1e-5,
    maxiter: int = 200,
) -> CGResult:
    """Flexible PCG on ``b``'s device.

    ``b``: (..., n).  ``op``/``precond`` map (..., n) → (..., n).  ``mask``
    is broadcast against ``b``; each leading index is an independent
    problem whose iteration stops (state freezes) at its own convergence.
    """
    mask = torch.ones_like(b) if mask is None else \
        mask.to(b.dtype).expand(b.shape)
    M = (lambda r: r) if precond is None else precond

    b = _project_out_ones(b, mask)
    bnorm = torch.sqrt(_vdot(b, b))
    x = torch.zeros_like(b) if x0 is None else _project_out_ones(x0, mask)
    r = _project_out_ones(b - op(x), mask)
    # Key point: the first direction is the *unpreconditioned* residual.
    z = r
    p = z
    rz = _vdot(r, z)
    resnorm = torch.sqrt(_vdot(r, r))
    tol_abs = tol * torch.clamp(bnorm, min=1e-30)
    k = torch.zeros(b.shape[:-1] + (1,), dtype=torch.int32, device=b.device)

    def active_flags(k, resnorm):
        return (k < maxiter) & (resnorm > tol_abs)

    step = 0
    while step % _CHECK_EVERY or bool(active_flags(k, resnorm).any()):
        act = active_flags(k, resnorm)           # (..., 1) bool per problem
        w = op(p)
        pw = _vdot(p, w)
        alpha = torch.where(pw.abs() > 1e-30, rz / pw, 0.0)
        x_new = x + alpha * p
        r_new = _project_out_ones(r - alpha * w, mask)
        z_new = _project_out_ones(M(r_new), mask)
        beta = torch.where(rz.abs() > 1e-30, _vdot(z_new, r_new - r) / rz, 0.0)
        rz_new = _vdot(r_new, z_new)
        p_new = z_new + beta * p
        res_new = torch.sqrt(_vdot(r_new, r_new))
        # Converged problems keep their state frozen.
        x = torch.where(act, x_new, x)
        r = torch.where(act, r_new, r)
        z = torch.where(act, z_new, z)
        p = torch.where(act, p_new, p)
        rz = torch.where(act, rz_new, rz)
        k = k + act.to(torch.int32)
        resnorm = torch.where(act, res_new, resnorm)
        step += 1
    return CGResult(
        x=_project_out_ones(x, mask),
        iters=k.squeeze(-1),
        resnorm=resnorm.squeeze(-1),
    )
