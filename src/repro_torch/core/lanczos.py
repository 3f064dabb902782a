"""Lanczos with restarts for the Fiedler pair (paper §6), in PyTorch.

The math is `repro.core.lanczos`'s: a fixed-width Lanczos window with full
reorthogonalization (twice — necessary in fp32), the small tridiagonal
Ritz problem solved with `torch.linalg.eigh`, the smallest Ritz vector
restarting the window, the constant vector deflated at every step (paper
Eq. 4.11), and one true matvec per restart for the residual.

Where JAX runs the window as one jitted `lax.scan`, the port runs a Python
loop of ``window`` eager steps.  The loop keeps everything on the device:
the window matrix ``Q`` is written in place row by row, the breakdown test
``β > 1e-12`` is a `torch.where`, and nothing inside the window reads a
value back to the host.  The only host sync of a restart is the one JAX
has too: reading θ and the residuals back for the convergence test.

**Packed variant** (`lanczos_fiedler_batched`): the B independent Fiedler
solves of one RSB tree level are packed into one flat (N,) vector (each
problem owns a contiguous, zero-padded block; ``seg[j]`` names slot j's
problem), and every per-problem reduction (α, β, reorthogonalization dots,
constant deflation, Ritz-vector norms) is a matmul with the one-hot
segment matrix ``S`` (n_seg × N), built once per call — once per tree
level — not once per restart.  The (n_seg, m, m) tridiagonal Ritz
problems go to one batched `torch.linalg.eigh` on the device in fp32.
Convergence is tracked per problem on the host; a converged problem's Ritz
output is frozen while the rest keep iterating.

Float32 matmuls must stay full fp32: the reorthogonalization dots lose the
Krylov basis's orthogonality at TF32's ~3 digits.  PyTorch's default
(``torch.backends.cuda.matmul.allow_tf32 = False``) is set explicitly for
the duration of each solve and restored afterwards.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.flexcg import _project_out_ones
from repro_torch.device import resolve_device


@dataclasses.dataclass
class LanczosInfo:
    restarts: int
    eigenvalue: float
    residual: float
    converged: bool
    breakdown: bool = False  # non-finite Ritz pair: (θ, res) are unusable


@dataclasses.dataclass
class BatchedLanczosInfo:
    """Per-subproblem convergence bookkeeping for a batched solve."""

    restarts: np.ndarray     # (B,) restart count at convergence (or the cap)
    eigenvalue: np.ndarray   # (B,)
    residual: np.ndarray     # (B,)
    converged: np.ndarray    # (B,) bool
    breakdown: np.ndarray | None = None  # (B,) bool: frozen on a stale pair


@contextlib.contextmanager
def _full_fp32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _safe_eigh(T: torch.Tensor):
    """Batched symmetric eigensolve that, like `jnp.linalg.eigh`, answers a
    non-finite matrix with non-finite eigenvalues instead of raising (the
    host bookkeeping reads them as a breakdown).  No host sync."""
    bad = ~torch.isfinite(T).all(-1).all(-1)
    evals, evecs = torch.linalg.eigh(torch.where(bad[..., None, None], 0.0, T))
    return torch.where(bad[..., None], float("nan"), evals), evecs


def _tridiag(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Tridiagonal matrices from (..., m) diagonals and (..., m) couplings
    (the last coupling is the residual term and is not part of T)."""
    return (torch.diag_embed(alpha) + torch.diag_embed(beta[..., :-1], 1)
            + torch.diag_embed(beta[..., :-1], -1))


def _window_body(op, q0: torch.Tensor, mask: torch.Tensor, m: int):
    """One restart window: returns (Q (m,n), alpha (m,), beta (m,)).

    beta[j] is the subdiagonal linking step j to j+1 (beta[m-1] is the
    residual coupling used in the Ritz residual bound)."""
    n = q0.shape[0]
    Q = torch.zeros((m, n), dtype=q0.dtype, device=q0.device)
    alpha = torch.empty(m, dtype=q0.dtype, device=q0.device)
    beta = torch.empty(m, dtype=q0.dtype, device=q0.device)
    q, q_prev = q0, torch.zeros_like(q0)
    beta_prev = torch.zeros((), dtype=q0.dtype, device=q0.device)
    for j in range(m):
        w = op(q) - beta_prev * q_prev
        a = (w * q).sum()
        w = w - a * q
        # Full reorthogonalization against the window + constants (twice is
        # enough — Parlett): rows ≥ j of Q are zero so the mask is implicit.
        for _ in range(2):
            w = w - Q.T @ (Q @ w)
            w = _project_out_ones(w, mask)
        b = torch.linalg.vector_norm(w)
        q_next = torch.where(b > 1e-12, w / torch.clamp(b, min=1e-30), 0.0)
        Q[j] = q
        alpha[j] = a
        beta[j] = b
        q_prev, q, beta_prev = q, q_next, b
    return Q, alpha, beta


def lanczos_fiedler(
    op: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    *,
    mask: torch.Tensor | None = None,
    seed: int = 0,
    b0: torch.Tensor | None = None,
    window: int = 30,
    max_restarts: int = 50,
    tol: float = 1e-3,
    device=None,
) -> tuple[torch.Tensor, LanczosInfo]:
    """Return (y₂ approximation, info).

    ``b0`` is the start vector; without one, seeded NumPy noise is used (the
    JAX version draws `jax.random` noise from a key instead).  The solve
    runs on ``b0``'s device, else ``mask``'s, else ``device``."""
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
    q = b0.to(device=dev, dtype=torch.float32)
    q = _project_out_ones(q, mask)
    q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-30)

    theta = torch.tensor(0.0)
    res = torch.tensor(float("inf"))
    y = q
    converged = False
    r = 0
    with _full_fp32_matmul():
        for r in range(1, max_restarts + 1):
            Q, alpha, beta = _window_body(op, q, mask, window)
            evals, evecs = _safe_eigh(_tridiag(alpha, beta))
            s = evecs[:, 0]
            theta = evals[0]
            y = Q.T @ s
            y = y / torch.clamp(torch.linalg.vector_norm(y), min=1e-30)
            # Cheap bound, then the true residual (one matvec).
            res = torch.linalg.vector_norm(op(y) - theta * y)
            th_h, res_h = torch.stack([theta, res]).cpu().tolist()
            if res_h <= tol * max(th_h, 1e-12):
                converged = True
                break
            q = _project_out_ones(y, mask)
            q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-30)

    th_h, res_h = float(theta), float(res)
    info = LanczosInfo(
        restarts=r,
        eigenvalue=th_h,
        residual=res_h,
        converged=converged,
        breakdown=not (np.isfinite(th_h) and np.isfinite(res_h)),
    )
    return y, info


# ---------------------------------------------------------------------------
# Batched (level-synchronous, packed) Lanczos
# ---------------------------------------------------------------------------

def _seg_onehot(seg: torch.Tensor, n_seg: int, dtype) -> torch.Tensor:
    """(n_seg, N) one-hot segment matrix: per-problem reductions as matmuls."""
    ids = torch.arange(n_seg, dtype=seg.dtype, device=seg.device)
    return (seg[None, :] == ids[:, None]).to(dtype)


def _project_out_ones_seg(x, mask, seg, S, count):
    """Per-problem constant deflation: x ← (x − mean_mask,p(x)) · mask.
    ``count`` is ``max(S @ mask, 1)``, computed once per solve."""
    s = S @ (x * mask)
    return (x - (s / count)[seg]) * mask


def _packed_restart(op, q, mask, seg, S, count, window):
    """One restart over all packed subproblems, entirely on ``q``'s device.

    ``op`` is the block-diagonal operator over the packed (N,) slots.
    Empty segments (padding) produce θ = 0, res = 0 and read as converged
    immediately.  Returns (y, θ, res, q_next), all device tensors.
    """
    m = window
    N = q.shape[0]
    n_seg = S.shape[0]
    Q = torch.zeros((m, N), dtype=q.dtype, device=q.device)
    alphas = torch.empty((m, n_seg), dtype=q.dtype, device=q.device)
    betas = torch.empty((m, n_seg), dtype=q.dtype, device=q.device)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(n_seg, dtype=q.dtype, device=q.device)
    for j in range(m):
        w = op(q) - beta_prev[seg] * q_prev
        alpha = S @ (w * q)                      # (n_seg,)
        w = w - alpha[seg] * q
        # Full reorthogonalization against the window + constants (twice is
        # enough — Parlett), per problem: rows ≥ j of Q are zero so the
        # window mask is implicit.
        for _ in range(2):
            dots = (Q * w[None, :]) @ S.T        # (m, n_seg) per-problem Qᵀw
            w = w - (Q * dots[:, seg]).sum(0)
            w = _project_out_ones_seg(w, mask, seg, S, count)
        beta = torch.sqrt(S @ (w * w))           # (n_seg,)
        bj = beta[seg]
        q_next = torch.where(bj > 1e-12, w / torch.clamp(bj, min=1e-30), 0.0)
        Q[j] = q
        alphas[j] = alpha
        betas[j] = beta
        q_prev, q, beta_prev = q, q_next, beta

    evals, evecs = _safe_eigh(_tridiag(alphas.T, betas.T))  # (n_seg, m, m)
    s = evecs[:, :, 0]                           # (n_seg, m)
    theta = evals[:, 0]                          # (n_seg,)
    y = (s.T[:, seg] * Q).sum(0)                 # per-problem Ritz vector
    ynorm = torch.sqrt(S @ (y * y))
    y = y / torch.clamp(ynorm, min=1e-30)[seg]
    Ly = op(y)
    res = torch.sqrt(S @ ((Ly - theta[seg] * y) ** 2))
    q_next = _project_out_ones_seg(y, mask, seg, S, count)
    qn = torch.sqrt(S @ (q_next * q_next))
    q_next = q_next / torch.clamp(qn, min=1e-30)[seg]
    return y, theta, res, q_next


def lanczos_fiedler_batched(
    op,
    n: int,
    *,
    seg: np.ndarray,
    n_seg: int,
    mask: np.ndarray,
    b0: np.ndarray,
    window: int = 30,
    max_restarts: int = 50,
    tol: float = 1e-3,
) -> tuple[torch.Tensor, BatchedLanczosInfo]:
    """All packed Fiedler solves in lockstep: (Y (N,) on the operator's
    device, per-problem info).

    ``op``: block-diagonal operator over the packed (N,) slots (no
    cross-problem coupling) with a ``device``.  ``seg[j]`` names slot j's
    subproblem id in [0, n_seg); ``mask[j]`` flags real (non-padding)
    slots; ``b0`` holds the packed start vectors.  These three are host
    arrays; they are copied to the device once per call.

    The host bookkeeping — start-vector projection, per-problem freezing,
    convergence and breakdown — is `repro`'s, line for line.
    """
    dev = op.device
    seg_h = np.asarray(seg)
    mask_h = np.asarray(mask, dtype=np.float64)
    q_h = np.asarray(b0, dtype=np.float64)
    # Host analogue of _project_out_ones_seg + per-segment normalization.
    s = np.bincount(seg_h, weights=q_h * mask_h, minlength=n_seg)
    c = np.maximum(np.bincount(seg_h, weights=mask_h, minlength=n_seg), 1.0)
    q_h = (q_h - (s / c)[seg_h]) * mask_h
    nrm = np.sqrt(np.bincount(seg_h, weights=q_h * q_h, minlength=n_seg))
    q_h = q_h / np.maximum(nrm, 1e-30)[seg_h]

    seg_d = torch.from_numpy(seg_h.astype(np.int64)).to(dev)
    mask_d = torch.from_numpy(mask_h.astype(np.float32)).to(dev)
    S = _seg_onehot(seg_d, n_seg, torch.float32)
    q = torch.from_numpy(q_h.astype(np.float32)).to(dev)

    y = q.clone()
    theta = np.zeros(n_seg)
    res = np.full(n_seg, np.inf)
    done = np.zeros(n_seg, dtype=bool)
    breakdown = np.zeros(n_seg, dtype=bool)
    restarts = np.zeros(n_seg, dtype=np.int64)
    with _full_fp32_matmul():
        count = torch.clamp(S @ mask_d, min=1.0)
        for r in range(1, max_restarts + 1):
            y_new, theta_new, res_new, q_next = _packed_restart(
                op, q, mask_d, seg_d, S, count, window
            )
            # The restart's one host sync: θ and the residuals.
            theta_h, res_h = torch.stack([theta_new, res_new]).cpu().numpy()
            finite = np.isfinite(theta_h) & np.isfinite(res_h)
            upd = ~done & finite  # a non-finite restart keeps the last state
            restarts[upd] = r
            theta = np.where(upd, theta_h, theta)
            res = np.where(upd, res_h, res)
            upd_d = torch.from_numpy(upd).to(dev)
            y = torch.where(upd_d[seg_d], y_new, y)
            done |= res <= tol * np.maximum(theta, 1e-12)
            # Numerical breakdown: freeze the problem and flag it — its
            # frozen (θ, res) never met tolerance.
            breakdown |= ~finite & ~done
            done |= ~finite
            if done.all():
                break
            q = q_next

    info = BatchedLanczosInfo(
        restarts=restarts, eigenvalue=theta, residual=res, converged=done,
        breakdown=breakdown,
    )
    return y, info
