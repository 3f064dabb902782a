"""Inverse power iteration for the Fiedler vector (paper Algorithm 2 + §7).

The math and the host bookkeeping are `repro.core.inverse_iteration`'s:
the outer loop orthogonalizes b against 1, normalizes it, solves
``L y = b`` with preconditioned flexcg and sets b ← y, with parRSB's two
augmentations:

* **augmented projection** — the initial guess of each inner solve is the
  L-orthogonal projection of b onto the span of the previous iterates (a
  small Gram solve);
* **single-iteration stop** — once flexcg (whose first direction is
  unpreconditioned) returns in one iteration, b is an eigenvector.

The outer loop is a host loop in both packages; each inner solve, which
JAX jits as one ``while_loop``, is the port's eager `flexcg` on the
device.  An outer iteration reads λ, the residual and the inner iteration
counts back once, besides the flag flexcg's loop reads every few
iterations.

**Batched variant** (`inverse_iteration_batched`): the B subproblems of a
shape bucket share one per-problem-masked flexcg, preconditioned by Jacobi
from the operator's own diagonal (the default) or by a packed
`BatchedAMG` V-cycle.  Its matvecs are K2 on the card.

`repro`'s ``cg_divergence`` chaos hook (`repro_torch.guard.chaos`) sits
where `repro` has it in both outer loops: when it fires, the outer step's
Rayleigh quotient becomes NaN and the breakdown path runs.

The Gram solve differs from JAX's in one way that matters: where
`jnp.linalg.solve` answers a singular matrix with non-finite values (which
`repro` turns into x0 = 0 per problem), `torch.linalg.solve` raises.  The
port calls `torch.linalg.solve_ex` and applies the same finite mask, plus
the solver's own singularity flag.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.flexcg import CGResult, _project_out_ones, flexcg
from repro_torch.core.lanczos import _full_fp32_matmul
from repro_torch.device import resolve_device
from repro_torch.guard import chaos


@dataclasses.dataclass
class InverseIterInfo:
    outer_iters: int
    inner_iters: list
    eigenvalue: float
    residual: float
    breakdown: bool = False    # hit a non-finite iterate; λ/res are stale


@dataclasses.dataclass
class BatchedInverseIterInfo:
    outer_iters: np.ndarray    # (B,) outer iteration count at convergence
    inner_iters: list          # per outer step: (B,) inner-iteration counts
    eigenvalue: np.ndarray     # (B,)
    residual: np.ndarray       # (B,)
    converged: np.ndarray      # (B,) bool
    breakdown: np.ndarray | None = None  # (B,) bool: λ/res are stale


def _rayleigh(op, y, mask):
    Ly = op(y)
    num = (y * Ly).sum()
    den = torch.clamp((y * y).sum(), min=1e-30)
    lam = num / den
    res = torch.sqrt(((Ly - lam * y) ** 2).sum() / den)
    return lam, res


def _gram_solve(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(G + ridge·I)⁻¹ rhs per problem (G (..., m, m), rhs (..., m)), with
    the ridge scaled to each Gram (fp32 near-duplicate iterates make G
    singular).  A singular system comes back non-finite, as from
    `jnp.linalg.solve`, instead of raising."""
    m = G.shape[-1]
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    ridge = (1e-5 * tr / m + 1e-20)[..., None, None]
    eye = torch.eye(m, dtype=G.dtype, device=G.device)
    coef, info = torch.linalg.solve_ex(G + ridge * eye, rhs[..., None])
    return torch.where((info == 0)[..., None], coef[..., 0], float("nan"))


def inverse_iteration(
    op: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    *,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    mask: torch.Tensor | None = None,
    seed: int = 0,
    b0: torch.Tensor | None = None,
    max_outer: int = 30,
    inner_tol: float = 1e-4,
    inner_maxiter: int = 200,
    tol: float = 1e-3,
    proj_window: int = 5,
    device=None,
) -> tuple[torch.Tensor, InverseIterInfo]:
    """Return (y₂ approximation, info).

    ``b0`` is the start vector; without one, seeded NumPy noise is used
    (the JAX version draws `jax.random` noise from a key instead).  The
    solve runs on ``b0``'s device, else ``mask``'s, else ``device``."""
    if b0 is not None:
        dev = b0.device
    elif mask is not None:
        dev = mask.device
    else:
        dev = resolve_device(device)
    mask = (torch.ones(n, dtype=torch.float32, device=dev) if mask is None
            else mask.to(device=dev, dtype=torch.float32))
    if b0 is None:
        b0 = torch.from_numpy(
            np.random.default_rng(seed).standard_normal(n).astype(np.float32))
    b = _project_out_ones(b0.to(device=dev, dtype=torch.float32), mask)
    b = b / torch.clamp(torch.linalg.vector_norm(b), min=1e-30)

    ys: list[torch.Tensor] = []     # previous iterates (projection basis)
    lys: list[torch.Tensor] = []    # L @ previous iterates
    inner_counts = []
    lam = torch.tensor(0.0)
    res = torch.tensor(float("inf"))
    outer = 0
    breakdown = False
    with _full_fp32_matmul():
        for outer in range(1, max_outer + 1):
            # Augmented projection: x0 = Y (Yᵀ L Y)⁻¹ Yᵀ b.
            if ys:
                Y = torch.stack(ys, dim=1)       # (n, m)
                W = torch.stack(lys, dim=1)      # (n, m)
                x0 = Y @ _gram_solve(Y.T @ W, Y.T @ b)
                x0 = torch.where(torch.isfinite(x0).all(), x0, 0.0)
            else:
                x0 = torch.zeros_like(b)
            result: CGResult = flexcg(op, b, precond=precond, x0=x0, mask=mask,
                                      tol=inner_tol, maxiter=inner_maxiter)
            y = result.x
            inner_counts.append(int(result.iters))

            b_prev = b
            ynorm = torch.clamp(torch.linalg.vector_norm(y), min=1e-30)
            b = _project_out_ones(y / ynorm, mask)
            b = b / torch.clamp(torch.linalg.vector_norm(b), min=1e-30)
            lam, res = _rayleigh(op, b, mask)
            if chaos.should_fire("cg_divergence", outer):
                lam = torch.tensor(float("nan"))
            if not (np.isfinite(float(lam)) and np.isfinite(float(res))):
                # Numerical breakdown: keep the last good iterate and stop,
                # flagging the stale Rayleigh pair for the caller.
                breakdown = True
                b = b_prev
                lam, res = _rayleigh(op, b, mask)
                break

            ys.append(b)
            lys.append(op(b))
            if len(ys) > proj_window:
                ys.pop(0)
                lys.pop(0)

            if float(res) <= tol * max(float(lam), 1e-12):
                break
            # Paper's stopping signal: flexcg converged in a single iteration.
            if outer > 1 and int(result.iters) <= 1:
                break

    info = InverseIterInfo(
        outer_iters=outer,
        inner_iters=inner_counts,
        eigenvalue=float(lam),
        residual=float(res),
        breakdown=breakdown,
    )
    return b, info


# ---------------------------------------------------------------------------
# Batched (level-synchronous) inverse iteration
# ---------------------------------------------------------------------------

def _rayleigh_batched(Ly, y):
    den = torch.clamp((y * y).sum(-1), min=1e-30)
    lam = (y * Ly).sum(-1) / den
    res = torch.sqrt(((Ly - lam[:, None] * y) ** 2).sum(-1) / den)
    return lam, res


def _batched_inner_solve(op, precond, b, x0, mask, inner_tol, inner_maxiter):
    """One inner solve + renormalization + Rayleigh quotient, all batched.

    ``precond=None`` selects Jacobi from the operator's own diagonal
    (padding rows have diag 0 → identity there); a `BatchedAMG` (or any
    callable) is applied as the flexible preconditioner per subproblem."""
    pre = precond
    if pre is None:
        inv_d = torch.where(op.diag > 0,
                            1.0 / torch.clamp(op.diag, min=1e-30), 0.0)
        pre = lambda r: r * inv_d  # noqa: E731
    result = flexcg(op, b, precond=pre, x0=x0, mask=mask,
                    tol=inner_tol, maxiter=inner_maxiter)
    y = result.x
    ynorm = torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                        min=1e-30)
    b_new = _project_out_ones(y / ynorm, mask)
    b_new = b_new / torch.clamp(
        torch.linalg.vector_norm(b_new, dim=-1, keepdim=True), min=1e-30)
    Ly = op(b_new)
    lam, res = _rayleigh_batched(Ly, b_new)
    return b_new, lam, res, result.iters, Ly


def _augmented_projection(Y, W, b):
    """x0 = Y (Yᵀ L Y)⁻¹ Yᵀ b per subproblem (Y (B, n, m), W = L Y).

    The ridge is scaled to each Gram, and a non-finite or singular solve
    falls back to x0 = 0 per problem."""
    G = torch.einsum("bnm,bnk->bmk", Y, W)
    rhs = torch.einsum("bnm,bn->bm", Y, b)
    x0 = torch.einsum("bnm,bm->bn", Y, _gram_solve(G, rhs))
    ok = torch.isfinite(x0).all(dim=-1, keepdim=True)
    return torch.where(ok, x0, 0.0)


def inverse_iteration_batched(
    op,
    n: int,
    *,
    mask: torch.Tensor,
    b0: torch.Tensor,
    precond=None,
    max_outer: int = 30,
    inner_tol: float = 1e-4,
    inner_maxiter: int = 200,
    tol: float = 1e-3,
    proj_window: int = 5,
) -> tuple[torch.Tensor, BatchedInverseIterInfo]:
    """B inverse-iteration Fiedler solves in lockstep on ``b0``'s device.

    Returns (B (B, n) iterates, per-problem info).  An all-zero mask row is
    a batch-padding dummy that converges immediately.  ``precond`` is a
    callable applied per subproblem inside the inner flexcg (e.g. a
    `BatchedAMG` V-cycle); None selects Jacobi from the operator's own
    diagonal.  The host bookkeeping — freezing, breakdown, the
    single-iteration stop — is `repro`'s, line for line.
    """
    B = mask.shape[0]
    b = _project_out_ones(b0.to(torch.float32), mask)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True),
                        min=1e-30)

    ys: list[torch.Tensor] = []
    lys: list[torch.Tensor] = []
    inner_counts: list[np.ndarray] = []
    lam = np.zeros(B)
    res = np.full(B, np.inf)
    done = np.zeros(B, dtype=bool)
    breakdown = np.zeros(B, dtype=bool)
    outer_iters = np.zeros(B, dtype=np.int64)
    with _full_fp32_matmul():
        lb = op(b)  # L@b, kept in lockstep with b's freeze updates
        for outer in range(1, max_outer + 1):
            if ys:
                x0 = _augmented_projection(torch.stack(ys, dim=-1),
                                           torch.stack(lys, dim=-1), b)
            else:
                x0 = torch.zeros_like(b)
            b_new, lam_new, res_new, iters, Ly_new = _batched_inner_solve(
                op, precond, b, x0, mask, inner_tol, inner_maxiter
            )
            # The outer step's one host sync: λ, residuals, inner counts.
            lam_h, res_h, iters_f = torch.stack(
                [lam_new, res_new, iters.to(lam_new.dtype)]).cpu().numpy()
            iters_h = iters_f.astype(np.int32)
            inner_counts.append(iters_h)
            lam_h = lam_h.astype(np.float64)
            res_h = res_h.astype(np.float64)
            if chaos.should_fire("cg_divergence", outer):
                lam_h = np.full_like(lam_h, np.nan)
            finite = np.isfinite(lam_h) & np.isfinite(res_h)
            upd = ~done & finite  # a non-finite update keeps the last good state
            outer_iters[upd] = outer
            lam = np.where(upd, lam_h, lam)
            res = np.where(upd, res_h, res)
            upd_d = torch.from_numpy(upd).to(b.device)[:, None]
            b = torch.where(upd_d, b_new, b)
            lb = torch.where(upd_d, Ly_new, lb)

            ys.append(b)
            lys.append(lb)
            if len(ys) > proj_window:
                ys.pop(0)
                lys.pop(0)

            done |= res <= tol * np.maximum(lam, 1e-12)
            # Numerical breakdown: stop on the last good iterate, but flag
            # the problem — the frozen λ/res never met tolerance and are stale.
            breakdown |= ~finite & ~done
            done |= ~finite
            # Paper's stopping signal, per subproblem: a single-iteration
            # inner solve means the Krylov space is invariant → eigenvector.
            if outer > 1:
                done |= finite & (iters_h <= 1)
            if done.all():
                break

    info = BatchedInverseIterInfo(
        outer_iters=outer_iters,
        inner_iters=inner_counts,
        eigenvalue=lam,
        residual=res,
        converged=done,
        breakdown=breakdown,
    )
    return b, info
