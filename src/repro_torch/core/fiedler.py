"""Fiedler-vector solver facade — `repro.core.fiedler` on assembled graphs.

* a dense NumPy path for subproblems at or below ``_DENSE_CUTOFF`` (the
  recursion tail), identical to `repro`'s;
* **multilevel (coarse-to-fine) warm starts** (`multilevel_warm_start`,
  on by default): host NumPy, line for line `repro`'s, so the warm start
  of a given graph is the same vector in both packages; the inverse paths
  blend a noise floor into it (`_blend_noise`), as there;
* ``method="lanczos"``: the **packed** level solve
  (`fiedler_from_graph_batched`) packs every subproblem of an RSB tree
  level into one flat block-diagonal ELL Laplacian (`_pack_layout`,
  `_packed_ell_laplacian`, `_packed_b0`), copied to the device once, and
  solves it with :func:`repro_torch.core.lanczos.lanczos_fiedler_batched`,
  whose matvec is the CUDA ELL SpMV (K1) on the card;
* ``method="inverse"``: inverse iteration with flexcg inner solves.  The
  batched entry groups subproblems into (n_pad, width_pad) shape buckets,
  each one batched operator (K2 on the card) solved by
  `inverse_iteration_batched` with ``precond="jacobi"`` (the operator's
  own diagonal) or ``"amg"`` (one packed `BatchedAMG` per bucket, K2 on
  every level); the unbatched entry uses the graph's own `AMG` (K1);
* the unbatched `fiedler_from_graph` (either method);
* the matrix-free mesh entry points (paper §5): `fiedler_from_mesh` and
  `fiedler_from_mesh_batched` solve on the gather-scatter Laplacian
  (`core/gather_scatter.py`) of an element sub-mesh's vertex-id table —
  Lanczos fully matrix-free, inverse iteration with the AMG hierarchy of
  the assembled dual graph (``graph_for_amg``; its levels run K1 on the
  card, the batched ones K2).

Start vectors come from NumPy ``default_rng`` (`_noise_b0`), exactly as in
`repro`, so both packages start from the same bits.  ``use_kernel`` is kept
where `repro` has it but defaults to **True**: on a CUDA device every
assembled matvec goes through K1 or K2.  Every solve emits `repro`'s
solver metrics into the active trace (`_emit_fiedler_metrics`,
``amg_levels``, ``cg_inner_iters``) from the host values the solvers
already read back, and runs inside a profiler range (``fiedler:lanczos``,
``fiedler:inverse``, ...; `repro_torch.obs.profiler`).

The degenerate-pair tools (paper §9) are `repro`'s:
`fiedler_pair_from_graph` solves again on the deflated operator
``L + σ·y₂y₂ᵀ`` (its Laplacian part K1 on the card), and
`best_cut_in_pair` sweeps the pair's span on the host.  `repro` draws the
second solve's start vector from ``jax.random.PRNGKey(seed + 1)``, the
port from NumPy ``default_rng(seed + 1)``; where λ₂ is double the second
vector is then another member of the eigenspace, and the pair's span and
cut, not the vectors, are what agree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.amg import amg_setup, amg_setup_batched, coarsen_graph
from repro_torch.core.gather_scatter import GSLaplacian, _build, _handle
from repro_torch.core.inverse_iteration import (
    inverse_iteration,
    inverse_iteration_batched,
)
from repro_torch.core.lanczos import lanczos_fiedler, lanczos_fiedler_batched
from repro_torch.core.laplacian import (
    EllLaplacian,
    batched_ell_arrays,
    batched_ell_operator,
    dense_laplacian_np,
    ell_operator,
    fill_ell_block,
)
from repro_torch.device import resolve_device
from repro_torch.mesh.graphs import Graph, dual_graph_from_incidence

_DENSE_CUTOFF = 192


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


@dataclasses.dataclass
class FiedlerResult:
    vector: np.ndarray     # (n,) float — Fiedler components (real entries only)
    eigenvalue: float
    residual: float
    iterations: int        # restarts (lanczos) or outer iters (inverse)
    method: str
    levels: int = 0        # multilevel warm-start hierarchy depth (0 = none)
    breakdown: bool = False  # solver hit a non-finite iterate; stale (λ, res)
    # Wall seconds of the call's device solves (shared by every problem of
    # a batched call; 0 for the dense host path).
    device_seconds: float = 0.0
    inner_iterations: int = 0  # flexcg iterations over all outer steps (inverse)


_METHODS = ("lanczos", "inverse")


def check_fiedler_method(method: str) -> None:
    if method not in _METHODS:
        raise ValueError(f"unknown fiedler method: {method}")


def _emit_fiedler_metrics(results) -> None:
    """Emit solver counters/gauges for completed solves into the active
    obs span (no-op outside a trace).  Host values only."""
    for r in results:
        if r is None:
            continue
        obs.counter_add("fiedler_solves")
        if r.method == "lanczos":
            obs.counter_add("lanczos_restarts", r.iterations)
        elif r.method == "inverse":
            obs.counter_add("inverse_outer_iters", r.iterations)
        obs.gauge_max("residual_max", float(r.residual))
        if r.levels:
            obs.gauge_max("multilevel_levels", r.levels)


# ---------------------------------------------------------------------------
# Multilevel (coarse-to-fine) warm starts — host NumPy
# ---------------------------------------------------------------------------

def _lap_matvec_np(graph: Graph, deg: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Host Laplacian matvec L x = deg ⊙ x − A x over the COO view."""
    ax = np.bincount(
        graph.rows, weights=graph.weights * x[graph.indices], minlength=graph.n
    )
    return deg * x - ax


def _cg_refine_np(graph: Graph, deg: np.ndarray, inv_d: np.ndarray,
                  b: np.ndarray, iters: int) -> np.ndarray:
    """One cascadic inverse-iteration step: ≈solve L x = b with `iters`
    Jacobi-PCG steps, x₀ = b (host NumPy; every vector stays ⊥ 1)."""
    x = b.copy()
    r = b - _lap_matvec_np(graph, deg, x)
    r -= r.mean()
    z = inv_d * r
    z -= z.mean()
    p = z.copy()
    rz = r @ z
    for _ in range(iters):
        w = _lap_matvec_np(graph, deg, p)
        pw = p @ w
        if abs(pw) < 1e-30:
            break
        a = rz / pw
        x += a * p
        r -= a * w
        r -= r.mean()
        z = inv_d * r
        z -= z.mean()
        rz_new = r @ z
        if rz_new < 1e-30:
            break
        p = z + (rz_new / rz) * p
        rz = rz_new
    x -= x.mean()
    return x


def _rayleigh_ritz_pair_np(graph: Graph, deg: np.ndarray,
                           V: np.ndarray) -> np.ndarray | None:
    """Rayleigh–Ritz over span(V) (V: (n, k) candidates, k small): project
    out constants, orthonormalize, rotate to the L-eigenbasis of the
    subspace, columns sorted by ascending Ritz value.  None on breakdown."""
    V = V - V.mean(axis=0, keepdims=True)
    Q, _ = np.linalg.qr(V)
    W = np.stack([_lap_matvec_np(graph, deg, Q[:, j]) for j in range(Q.shape[1])], 1)
    G = Q.T @ W
    G = 0.5 * (G + G.T)
    if not np.isfinite(G).all():
        return None
    w, S = np.linalg.eigh(G)
    return Q @ S[:, np.argsort(w)]


def multilevel_warm_start(
    graph: Graph,
    *,
    coarse_cutoff: int = _DENSE_CUTOFF,
    refine_iters: int = 6,
) -> tuple[np.ndarray | None, int]:
    """Cascadic coarse-to-fine Fiedler warm start (returns (warm, n_levels)).

    Pairwise Galerkin hierarchy over the node order (callers feed
    RCB-ordered graphs), a dense solve at the coarsest level, then per
    level a piecewise-constant prolongation, one Jacobi-PCG
    inverse-iteration step per candidate, and a 2×2 Rayleigh–Ritz rotation
    over the candidate pair (y₂, y₃), which keeps the warm start on y₂ when
    aggregation swaps the eigenvalue order between levels.  Returns
    (None, 0) for graphs at or below ``coarse_cutoff`` and on numerical
    breakdown (the caller falls back to noise).
    """
    if graph.n <= coarse_cutoff:
        return None, 0
    levels: list[Graph] = [graph]
    aggs: list[np.ndarray] = []
    while levels[-1].n > coarse_cutoff:
        g = levels[-1]
        agg = np.arange(g.n, dtype=np.int64) // 2
        levels.append(coarsen_graph(g, agg, (g.n + 1) // 2))
        aggs.append(agg)
    w, v = np.linalg.eigh(dense_laplacian_np(levels[-1]))
    V = v[:, 1:3] if v.shape[1] >= 3 else v[:, 1:2]   # (n_c, ≤2) candidates
    for agg, g in zip(reversed(aggs), reversed(levels[:-1])):
        V = V[agg]                           # piecewise-constant prolongation
        deg = np.zeros(g.n)
        np.add.at(deg, g.rows, g.weights)
        inv_d = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-30), 0.0)
        cols = []
        for j in range(V.shape[1]):
            c = V[:, j] - V[:, j].mean()
            nrm = np.linalg.norm(c)
            if not np.isfinite(nrm) or nrm < 1e-30:
                return None, 0               # degenerate level: fall back
            cols.append(_cg_refine_np(g, deg, inv_d, c / nrm, refine_iters))
        V = _rayleigh_ritz_pair_np(g, deg, np.stack(cols, 1))
        if V is None:
            return None, 0
    vec = V[:, 0]
    if not np.isfinite(vec).all():
        return None, 0
    return vec.astype(np.float32), len(aggs)


_INVERSE_NOISE_BLEND = 0.3


def _blend_noise(warm: np.ndarray, seed: int) -> np.ndarray:
    """Mix a deterministic noise floor into a multilevel warm start.

    Single-vector inverse iteration amplifies only the eigencomponents its
    start vector contains: a prolonged coarse Fiedler vector that lands
    (near-)orthogonal to y₂ — near-degenerate pairs, paper §9 — would trap
    the iteration on the wrong eigenvector.  Lanczos is immune (it builds a
    Krylov *subspace*), so only the inverse paths blend."""
    z = _noise_b0(seed, warm.shape[0])
    nw, nz = np.linalg.norm(warm), np.linalg.norm(z)
    if nw < 1e-30 or nz < 1e-30:
        return warm
    return (warm / nw + _INVERSE_NOISE_BLEND * z / nz).astype(np.float32)


def _noise_b0(seed: int, n: int) -> np.ndarray:
    """Deterministic start-vector noise from NumPy — the same bits as
    `repro.core.fiedler._noise_b0` for the same seed."""
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _dense_fiedler(L: np.ndarray) -> tuple[np.ndarray, float]:
    w, v = np.linalg.eigh(L)
    return v[:, 1], float(w[1])


def _padded_ell_laplacian(graph: Graph, n_pad: int, width_pad: int, *,
                          device=None, use_kernel: bool = True) -> EllLaplacian:
    """One graph's operator padded to n_pad rows (a pack of one)."""
    return _packed_ell_laplacian([graph], np.array([0, n_pad]), n_pad,
                                 width_pad, device=device,
                                 use_kernel=use_kernel)


def fiedler_from_graph(
    graph: Graph,
    *,
    method: str = "lanczos",
    order: np.ndarray | None = None,
    seed: int = 0,
    warm: np.ndarray | None = None,
    tol: float = 1e-3,
    window: int = 30,
    max_restarts: int = 50,
    pad: bool = True,
    use_kernel: bool = True,
    multilevel: bool = True,
    device=None,
) -> FiedlerResult:
    """Fiedler vector of an assembled graph Laplacian (Lanczos, or inverse
    iteration preconditioned by the graph's `AMG`, whose fine nodes
    ``order`` permutes).

    ``multilevel=True`` (default) seeds the solve with the cascadic
    coarse-to-fine warm start when no explicit ``warm`` is given."""
    check_fiedler_method(method)
    n = graph.n
    if n <= _DENSE_CUTOFF:
        vec, lam = _dense_fiedler(dense_laplacian_np(graph))
        res = FiedlerResult(vec, lam, 0.0, 0, "dense")
        _emit_fiedler_metrics([res])
        return res
    dev = resolve_device(device)

    ml_levels = 0
    if warm is None and multilevel:
        warm, ml_levels = multilevel_warm_start(graph)
        if warm is not None and method == "inverse":
            warm = _blend_noise(warm, seed)

    n_pad = next_pow2(n) if pad else n
    width = int(graph.degrees.max()) if graph.nnz else 1
    width_pad = next_pow2(max(width, 2)) if pad else width
    if warm is not None:
        b0 = np.pad(warm.astype(np.float32), (0, n_pad - n))
    else:
        b0 = _noise_b0(seed, n_pad)
    pre = None
    if method == "inverse":
        pre = amg_setup(graph, order=order, device=dev, use_kernel=use_kernel)
        ml_levels = max(ml_levels, len(pre.ops))
        obs.gauge_max("amg_levels", len(pre.ops))
    with obs.stopwatch() as t_dev:
        op = _padded_ell_laplacian(graph, n_pad, width_pad, device=dev,
                                   use_kernel=use_kernel)
        y, info, iters, inner = _solve_one(op, n, n_pad, b0, pre, method,
                                           window, max_restarts, tol, dev)
        vec = y[:n].cpu().numpy()
    out = FiedlerResult(vec, info.eigenvalue, info.residual, iters,
                        method, levels=ml_levels, breakdown=info.breakdown,
                        device_seconds=t_dev.seconds, inner_iterations=inner)
    _emit_fiedler_metrics([out])
    return out


def _solve_one(op, n: int, n_pad: int, b0: np.ndarray, pre, method: str,
               window: int, max_restarts: int, tol: float, dev):
    """The device solve of one padded operator (ELL or gather-scatter):
    Lanczos, or inverse iteration preconditioned by ``pre`` (an `AMG` of
    the real n nodes).  Returns (y, info, iterations, inner iterations)."""
    mask = torch.from_numpy((np.arange(n_pad) < n).astype(np.float32)).to(dev)
    b0 = torch.from_numpy(b0).to(dev)
    if method == "lanczos":
        with obs.annotate("fiedler:lanczos"):
            y, info = lanczos_fiedler(
                op, n_pad, mask=mask, b0=b0,
                window=window, max_restarts=max_restarts, tol=tol,
            )
        return y, info, info.restarts, 0

    # The AMG hierarchy is sized to the real graph; wrap it to ignore the
    # padding.
    def precond(r):
        return torch.nn.functional.pad(pre(r[:n]), (0, n_pad - n))

    with obs.annotate("fiedler:inverse"):
        y, info = inverse_iteration(op.apply, n_pad, precond=precond,
                                    mask=mask, b0=b0, tol=tol)
    inner = sum(info.inner_iters)
    obs.counter_add("cg_inner_iters", float(inner))
    return y, info, info.outer_iters, inner


# ---------------------------------------------------------------------------
# Batched (level-synchronous) entry point — the packed layout
# ---------------------------------------------------------------------------

def _normalize_batch_args(B, seeds, warms):
    seeds = list(range(B)) if seeds is None else list(seeds)
    warms = [None] * B if warms is None else list(warms)
    if len(seeds) != B or len(warms) != B:
        raise ValueError("seeds/warms must match the batch length")
    return seeds, warms


def _pack_layout(sizes, pack_slots=None, pack_segs=None):
    """Pack B subproblems into one flat vector of power-of-two blocks.

    Returns (offs, N, n_seg, seg, mask): problem b owns slots
    [offs[b], offs[b+1]) with its first sizes[b] slots real (mask 1).
    `pack_slots`/`pack_segs` pin N / n_seg to run-wide values (a level's
    subproblems partition the root set, so their padded blocks always fit
    the root's padded size); they are only overridden upward if a layout
    overflows.
    """
    pads = [next_pow2(max(s, 2)) for s in sizes]
    offs = np.concatenate([[0], np.cumsum(pads)]).astype(np.int64)
    total = int(offs[-1])
    N = next_pow2(total)
    if pack_slots is not None:
        N = max(N, int(pack_slots))
    n_seg = next_pow2(len(sizes))
    if pack_segs is not None:
        n_seg = max(n_seg, int(pack_segs))
    seg = np.zeros(N, dtype=np.int32)
    mask = np.zeros(N, dtype=np.float32)
    for b, s in enumerate(sizes):
        seg[offs[b]:offs[b + 1]] = b
        mask[offs[b]:offs[b] + s] = 1.0
    # trailing slots: seg 0, mask 0, zero operator rows — fully inert
    return offs, N, n_seg, seg, mask


def _packed_ell_arrays(graphs: list, offs, N: int, width_pad: int):
    """Host arrays (C, V, D) of the block-diagonal ELL Laplacian over the
    packed slots: each problem's cols are offset into its own block, so
    there is no cross-problem coupling.

    C and V are (N, width_pad) views of C-contiguous (width_pad, N) int32 /
    float32 arrays — the transposed layout the device operator keeps — so
    `ell_operator` copies them to the device without a host transpose.
    The values equal `repro`'s (its float64 vals are cast to float32 on
    assignment instead of afterwards; D accumulates in float64 as there).
    """
    Ct = np.empty((width_pad, N), dtype=np.int32)
    Ct[:] = np.arange(N, dtype=np.int32)
    Vt = np.zeros((width_pad, N), dtype=np.float32)
    C, V = Ct.T, Vt.T
    D = np.zeros(N, dtype=np.float64)
    for b, g in enumerate(graphs):
        o, o_next = int(offs[b]), int(offs[b + 1])
        fill_ell_block(g, C[o:o_next], V[o:o_next], D[o:o_next], col_offset=o)
    return C, V, D


def _packed_ell_laplacian(graphs: list, offs, N: int, width_pad: int, *,
                          device=None, use_kernel: bool = True) -> EllLaplacian:
    """The packed block-diagonal operator on ``device`` — one host-to-device
    copy of (N, width_pad) cols and vals per call (once per tree level)."""
    C, V, D = _packed_ell_arrays(graphs, offs, N, width_pad)
    return ell_operator(C, V, D, N, device=device, use_kernel=use_kernel)


def _packed_b0(sizes, offs, N: int, seeds, warms) -> np.ndarray:
    out = np.zeros(N, dtype=np.float32)
    for b, s in enumerate(sizes):
        o, o_next = int(offs[b]), int(offs[b + 1])
        if warms[b] is not None:
            out[o:o + s] = np.asarray(warms[b], dtype=np.float32)
        else:
            out[o:o_next] = _noise_b0(seeds[b], o_next - o)
    return out


def _solve_packed_lanczos(op, offs, N, n_seg, seg, mask, b0, sizes,
                          tol, window, max_restarts):
    with obs.annotate(f"fiedler:lanczos_packed:N{N}"):
        Y, info = lanczos_fiedler_batched(
            op, N, seg=seg, n_seg=n_seg, mask=mask, b0=b0,
            window=window, max_restarts=max_restarts, tol=tol,
        )
    Yh = Y.cpu().numpy()
    return [
        FiedlerResult(
            Yh[int(offs[b]):int(offs[b]) + s], float(info.eigenvalue[b]),
            float(info.residual[b]), int(info.restarts[b]), "lanczos",
            breakdown=bool(info.breakdown[b])
            if info.breakdown is not None else False,
        )
        for b, s in enumerate(sizes)
    ]


# -- shape buckets (the inverse path's leading-batch-dim layout) ------------

def _batched_b0(sizes, seeds, warms, n_pad: int, b_pad: int) -> np.ndarray:
    """Per-problem start vectors (b_pad, n_pad): padded warm starts where
    given, otherwise seeded noise; zero rows for batch-padding dummies."""
    out = np.zeros((b_pad, n_pad), dtype=np.float32)
    for r, (sz, sd, warm) in enumerate(zip(sizes, seeds, warms)):
        if warm is not None:
            out[r, :sz] = np.asarray(warm, dtype=np.float32)
        else:
            out[r] = _noise_b0(sd, n_pad)
    return out


def _solve_inverse_buckets(results, solve_ix, size_of, bucket_key,
                           host_op, device_op, seeds, warms, tol, *,
                           graph_of, precond: str, use_kernel: bool,
                           device) -> float:
    """The ``method="inverse"`` tail of both batched entry points: group
    problems into shape buckets (``bucket_key(i)``, whose first entry is
    n_pad), run one batched preconditioned solve per bucket, unpack
    FiedlerResults into ``results`` in place.  ``host_op(ix, key, b_pad)``
    builds a bucket's operator arrays on the host and ``device_op`` puts
    them on the device.  Returns the wall seconds of the device solves
    (operator copies included).

    ``precond="jacobi"`` preconditions with each operator's own diagonal;
    ``"amg"`` builds one packed `BatchedAMG` V-cycle per bucket from the
    (RCB-ordered) assembled graphs ``graph_of(i)``."""
    if precond not in ("jacobi", "amg"):
        raise ValueError(f"unknown preconditioner: {precond}")
    buckets: dict = {}
    for i in solve_ix:
        buckets.setdefault(bucket_key(i), []).append(i)
    device_seconds = 0.0
    for key, ix in sorted(buckets.items()):
        n_pad = key[0]
        b_pad = next_pow2(len(ix))
        pre = None
        if precond == "amg":
            pre = amg_setup_batched([graph_of(i) for i in ix], n_pad, b_pad,
                                    device=device, use_kernel=use_kernel)
            obs.gauge_max("amg_levels", len(pre.ops))
        arrays = host_op(ix, key, b_pad)
        mask = np.zeros((b_pad, n_pad), dtype=np.float32)
        for r, i in enumerate(ix):
            mask[r, :size_of(i)] = 1.0
        b0 = _batched_b0([size_of(i) for i in ix], [seeds[i] for i in ix],
                         [warms[i] for i in ix], n_pad, b_pad)
        with obs.stopwatch() as t_dev:
            op = device_op(arrays)
            with obs.annotate(f"fiedler:inverse_batched:n{n_pad}xb{b_pad}"):
                Y, info = inverse_iteration_batched(
                    op, n_pad, mask=torch.from_numpy(mask).to(device),
                    b0=torch.from_numpy(b0).to(device), tol=tol,
                    precond=pre)
            Yh = Y.cpu().numpy()
        device_seconds += t_dev.seconds
        inner = np.sum(info.inner_iters, axis=0)
        obs.counter_add("cg_inner_iters", float(inner.sum()))
        for r, i in enumerate(ix):
            results[i] = FiedlerResult(
                Yh[r, :size_of(i)], float(info.eigenvalue[r]),
                float(info.residual[r]), int(info.outer_iters[r]), "inverse",
                levels=0 if pre is None else len(pre.ops),
                breakdown=bool(info.breakdown[r]),
                inner_iterations=int(inner[r]),
            )
    return device_seconds


def _dense_results(sizes, laplacian_of):
    """Dense host solves for the problems at or below the cutoff; returns
    (results with None for the rest, indices of the rest)."""
    results: list = [None] * len(sizes)
    solve_ix = []
    for i, n in enumerate(sizes):
        if n <= _DENSE_CUTOFF:
            vec, lam = _dense_fiedler(laplacian_of(i))
            results[i] = FiedlerResult(vec, lam, 0.0, 0, "dense")
        else:
            solve_ix.append(i)
    return results, solve_ix


def _fill_warms(solve_ix, warms, seeds, graph_of, method) -> dict:
    """Cascadic warm starts for every problem without one; returns each
    problem's warm-start hierarchy depth."""
    ml_levels = {i: 0 for i in solve_ix}
    for i in solve_ix:
        if warms[i] is None:
            warms[i], ml_levels[i] = multilevel_warm_start(graph_of(i))
            if warms[i] is not None and method == "inverse":
                warms[i] = _blend_noise(warms[i], seeds[i])
    return ml_levels


def _solve_packed(results, solve_ix, sizes, host_op, device_op, seeds, warms,
                  ml_levels, tol, window, max_restarts, pack_slots,
                  pack_segs):
    """The ``method="lanczos"`` tail of both batched entry points: pack the
    problems (`_pack_layout`), build the block-diagonal operator's arrays
    on the host (``host_op(offs, N)``), put them on the device
    (``device_op``) and solve in one packed Lanczos call."""
    offs, N, n_seg, seg, mask = _pack_layout(sizes, pack_slots, pack_segs)
    arrays = host_op(offs, N)
    b0 = _packed_b0(sizes, offs, N, [seeds[i] for i in solve_ix],
                    [warms[i] for i in solve_ix])
    with obs.stopwatch() as t_dev:
        op = device_op(arrays)
        packed = _solve_packed_lanczos(
            op, offs, N, n_seg, seg, mask, b0, sizes, tol, window, max_restarts
        )
    for r, i in enumerate(solve_ix):
        results[i] = packed[r]
        results[i].levels = ml_levels[i]
        results[i].device_seconds = t_dev.seconds


def fiedler_from_graph_batched(
    graphs: list,
    *,
    method: str = "lanczos",
    seeds: list | None = None,
    warms: list | None = None,
    tol: float = 1e-3,
    window: int = 30,
    max_restarts: int = 50,
    pack_slots: int | None = None,
    pack_segs: int | None = None,
    width_pad: int | None = None,
    use_kernel: bool = True,
    multilevel: bool = True,
    precond: str = "jacobi",
    device=None,
) -> list:
    """Fiedler vectors of B independent graphs in one batched solve on
    ``device`` (default: the card).

    Returns FiedlerResults aligned with the input order; problems at or
    below the dense cutoff take the dense host path (exact parity with the
    unbatched entry point).  ``method="lanczos"`` packs every other problem
    into one flat block-diagonal Lanczos solve whose matvec is K1 on the
    card; ``method="inverse"`` solves (n_pad, width_pad) shape buckets of
    batched operators (K2 on the card) by inverse iteration, with
    ``precond="jacobi"`` (the operator's own diagonal) or ``"amg"`` (one
    packed `BatchedAMG` V-cycle per bucket).
    """
    check_fiedler_method(method)
    B = len(graphs)
    seeds, warms = _normalize_batch_args(B, seeds, warms)
    results, solve_ix = _dense_results(
        [g.n for g in graphs], lambda i: dense_laplacian_np(graphs[i]))
    if not solve_ix:
        _emit_fiedler_metrics(results)
        return results
    dev = resolve_device(device)
    ml_levels = ({i: 0 for i in solve_ix} if not multilevel else
                 _fill_warms(solve_ix, warms, seeds, lambda i: graphs[i],
                             method))

    if method == "inverse":
        def bucket_key(i):
            g = graphs[i]
            width = int(g.degrees.max()) if g.nnz else 1
            return (next_pow2(g.n), next_pow2(max(width, 2)))

        dev_s = _solve_inverse_buckets(
            results, solve_ix, lambda i: graphs[i].n, bucket_key,
            lambda ix, key, b_pad: batched_ell_arrays(
                [graphs[i] for i in ix], key[0], key[1], b_pad),
            lambda arrays: batched_ell_operator(*arrays, device=dev,
                                                use_kernel=use_kernel),
            seeds, warms, tol, graph_of=lambda i: graphs[i], precond=precond,
            use_kernel=use_kernel, device=dev)
        for i in solve_ix:  # deepest hierarchy used: warm start or AMG ladder
            results[i].levels = max(results[i].levels, ml_levels[i])
            results[i].device_seconds = dev_s
        _emit_fiedler_metrics(results)
        return results

    width = max(
        int(graphs[i].degrees.max()) if graphs[i].nnz else 1
        for i in solve_ix
    )
    width = next_pow2(max(width, 2))
    if width_pad is not None:
        width = max(width, int(width_pad))

    _solve_packed(
        results, solve_ix, [graphs[i].n for i in solve_ix],
        lambda offs, N: (*_packed_ell_arrays([graphs[i] for i in solve_ix],
                                             offs, N, width), N),
        lambda arrays: ell_operator(*arrays, device=dev,
                                    use_kernel=use_kernel),
        seeds, warms, ml_levels, tol, window, max_restarts, pack_slots,
        pack_segs)
    _emit_fiedler_metrics(results)
    return results


# ---------------------------------------------------------------------------
# Matrix-free mesh entry points (gather-scatter Laplacian, paper §5)
# ---------------------------------------------------------------------------

def _graph_from_vert_gid(vert_gid: np.ndarray) -> Graph:
    """Assembled dual graph of one sub-mesh (compacted vertex id space)."""
    uniq, inv = np.unique(vert_gid, return_inverse=True)
    return dual_graph_from_incidence(
        inv.reshape(vert_gid.shape), uniq.size, vert_gid.shape[0]
    )


def _gs_laplacian_from_np(gid: np.ndarray, n_global: int, n: int, *,
                          device) -> GSLaplacian:
    """GSLaplacian with host-computed degrees (aw_apply(1) ≡ per-slot sum
    of id multiplicities).  gid: (n, K) or (B, n, K); per-problem id spaces
    for 3-D."""
    K = gid.shape[-1]
    if gid.ndim == 3:
        deg_full = np.stack([
            np.bincount(g.ravel(), minlength=n_global)[g].sum(-1) for g in gid
        ])
    else:
        deg_full = np.bincount(gid.ravel(), minlength=n_global)[gid].sum(-1)
    h = _handle(gid, n_global, device)
    return GSLaplacian(
        terms=((1.0, h),), n=n,
        degree_full=torch.from_numpy(deg_full.astype(np.float32)).to(h.device),
        diag=torch.from_numpy((deg_full - K).astype(np.float32)).to(h.device),
    )


def _fill_gs_block(vert_gid: np.ndarray, gid_block: np.ndarray,
                   base: int) -> int:
    """Compact one sub-mesh's ids into gid_block starting at id ``base``;
    rows past E get one fresh singleton id per slot (no coupling,
    self-cancelling).  Returns the next unused id."""
    E, K = vert_gid.shape
    uniq, inv = np.unique(vert_gid, return_inverse=True)
    gid_block[:E] = inv.reshape(E, K) + base
    base += uniq.size
    n_rows = gid_block.shape[0]
    if n_rows > E:
        pad = (n_rows - E) * K
        gid_block[E:] = (base + np.arange(pad)).reshape(-1, K)
        base += pad
    return base


def _padded_gs_laplacian(vert_gid: np.ndarray, n_pad: int, *,
                         device) -> GSLaplacian:
    """Gather-scatter Laplacian padded to n_pad elements (decoupled tail)."""
    gid = np.empty((n_pad, vert_gid.shape[1]), dtype=np.int64)
    ng = _fill_gs_block(vert_gid, gid, 0)
    return _build([(1.0, _handle(gid, ng, device))], n_pad)


def _padded_gs_arrays_batched(vert_gids: list, n_pad: int, b_pad: int):
    """Host (b_pad, n_pad, K) id table of B stacked sub-meshes, each
    compacted in its own id space, and the shared power-of-two id bound."""
    K = vert_gids[0].shape[1]
    gid = np.empty((b_pad, n_pad, K), dtype=np.int64)
    need = 2
    for b, vg in enumerate(vert_gids):
        need = max(need, _fill_gs_block(vg, gid[b], 0))
    ng = next_pow2(need)
    for b in range(len(vert_gids), b_pad):  # batch-padding dummy problems
        gid[b] = (np.arange(n_pad * K, dtype=np.int64) % ng).reshape(n_pad, K)
    return gid, ng, n_pad


def _padded_gs_laplacian_batched(vert_gids: list, n_pad: int, b_pad: int, *,
                                 device) -> GSLaplacian:
    """Stack B gather-scatter Laplacians into one (b_pad, n_pad, K) operator
    (padded element slots get fresh singleton ids)."""
    gid, ng, n = _padded_gs_arrays_batched(vert_gids, n_pad, b_pad)
    return _gs_laplacian_from_np(gid, ng, n, device=device)


def _packed_gs_arrays(vert_gids: list, offs, N: int):
    """Host (N, K) ids of the block-diagonal packed layout, the id bound
    and N: each problem's compacted ids live in a disjoint range of one
    shared id space; padding slots get fresh singleton ids
    (self-cancelling)."""
    K = vert_gids[0].shape[1]
    gid = np.empty((N, K), dtype=np.int64)
    base = 0
    for b, vg in enumerate(vert_gids):
        o, o_next = int(offs[b]), int(offs[b + 1])
        base = _fill_gs_block(vg, gid[o:o_next], base)
    tail = int(offs[-1])
    if N > tail:
        gid[tail:] = (base + np.arange((N - tail) * K)).reshape(-1, K)
    return gid, next_pow2(N * K), N


def _packed_gs_laplacian(vert_gids: list, offs, N: int, *,
                         device) -> GSLaplacian:
    """Block-diagonal gather-scatter Laplacian over the packed slots, with
    the shape-stable id bound next_pow2(N·K)."""
    return _gs_laplacian_from_np(*_packed_gs_arrays(vert_gids, offs, N),
                                 device=device)


def fiedler_from_mesh(
    vert_gid: np.ndarray,
    *,
    method: str = "lanczos",
    graph_for_amg: Graph | None = None,
    order: np.ndarray | None = None,
    seed: int = 0,
    warm: np.ndarray | None = None,
    tol: float = 1e-3,
    window: int = 30,
    max_restarts: int = 50,
    pad: bool = True,
    multilevel: bool = True,
    use_kernel: bool = True,
    device=None,
) -> FiedlerResult:
    """Fiedler vector via the matrix-free gather-scatter Laplacian (paper
    §5) of one sub-mesh's (E, K) vertex-id table, on ``device``.

    ``graph_for_amg`` (the assembled dual graph) is needed for
    ``method="inverse"`` only: the AMG hierarchy needs assembled coarse
    levels (paper §7; K1 on the card where ``use_kernel``), while Lanczos
    runs fully matrix-free.  ``multilevel=True`` (default) assembles the
    dual graph on the host for the cascadic warm start when no ``warm``
    is given; the device solve itself stays matrix-free."""
    check_fiedler_method(method)
    E = vert_gid.shape[0]
    if E <= _DENSE_CUTOFF:
        g = dual_graph_from_incidence(vert_gid, int(vert_gid.max()) + 1, E)
        vec, lam = _dense_fiedler(dense_laplacian_np(g))
        res = FiedlerResult(vec, lam, 0.0, 0, "dense")
        _emit_fiedler_metrics([res])
        return res
    if method == "inverse" and graph_for_amg is None:
        raise ValueError("inverse iteration needs the assembled dual graph "
                         "for AMG")
    dev = resolve_device(device)

    ml_levels = 0
    if warm is None and multilevel:
        g_ml = graph_for_amg
        if g_ml is None:
            g_ml = _graph_from_vert_gid(np.asarray(vert_gid))
        warm, ml_levels = multilevel_warm_start(g_ml)
        if warm is not None and method == "inverse":
            warm = _blend_noise(warm, seed)

    n_pad = next_pow2(E) if pad else E
    if warm is not None:
        b0 = np.pad(warm.astype(np.float32), (0, n_pad - E))
    else:
        b0 = _noise_b0(seed, n_pad)
    pre = None
    if method == "inverse":
        pre = amg_setup(graph_for_amg, order=order, device=dev,
                        use_kernel=use_kernel)
        ml_levels = max(ml_levels, len(pre.ops))
        obs.gauge_max("amg_levels", len(pre.ops))
    with obs.stopwatch() as t_dev:
        op = _padded_gs_laplacian(vert_gid, n_pad, device=dev)
        y, info, iters, inner = _solve_one(op, E, n_pad, b0, pre, method,
                                           window, max_restarts, tol, dev)
        vec = y[:E].cpu().numpy()
    out = FiedlerResult(vec, info.eigenvalue, info.residual, iters, method,
                        levels=ml_levels, breakdown=info.breakdown,
                        device_seconds=t_dev.seconds, inner_iterations=inner)
    _emit_fiedler_metrics([out])
    return out


def fiedler_from_mesh_batched(
    vert_gids: list,
    *,
    method: str = "lanczos",
    seeds: list | None = None,
    warms: list | None = None,
    tol: float = 1e-3,
    window: int = 30,
    max_restarts: int = 50,
    pack_slots: int | None = None,
    pack_segs: int | None = None,
    multilevel: bool = True,
    precond: str = "jacobi",
    graphs: list | None = None,
    use_kernel: bool = True,
    device=None,
) -> list:
    """Matrix-free batched analogue of :func:`fiedler_from_mesh`: B
    element sub-meshes (their (E, K) id tables) per call, on ``device``.
    ``method="lanczos"`` packs every sub-mesh into one flat gather-scatter
    solve; ``method="inverse"`` uses the leading-batch-dim gather-scatter
    operators with ``precond="jacobi"`` or ``"amg"`` (a packed
    `BatchedAMG` V-cycle over the assembled dual graphs, K2 on the card;
    the fine operator stays matrix-free).  ``multilevel=True`` (default)
    fills missing ``warms`` entries with the cascadic warm start.

    ``graphs`` optionally supplies each sub-mesh's assembled dual graph;
    entries may be None, and anything missing is assembled on demand."""
    check_fiedler_method(method)
    B = len(vert_gids)
    seeds, warms = _normalize_batch_args(B, seeds, warms)
    graphs = [None] * B if graphs is None else list(graphs)
    if len(graphs) != B:
        raise ValueError("graphs must match the batch length")

    def graph_of(i):
        if graphs[i] is None:
            graphs[i] = _graph_from_vert_gid(np.asarray(vert_gids[i]))
        return graphs[i]

    results, solve_ix = _dense_results(
        [vg.shape[0] for vg in vert_gids],
        lambda i: dense_laplacian_np(graph_of(i)))
    if not solve_ix:
        _emit_fiedler_metrics(results)
        return results
    dev = resolve_device(device)
    ml_levels = ({i: 0 for i in solve_ix} if not multilevel else
                 _fill_warms(solve_ix, warms, seeds, graph_of, method))

    if method == "lanczos":
        _solve_packed(
            results, solve_ix, [vert_gids[i].shape[0] for i in solve_ix],
            lambda offs, N: _packed_gs_arrays(
                [vert_gids[i] for i in solve_ix], offs, N),
            lambda arrays: _gs_laplacian_from_np(*arrays, device=dev),
            seeds, warms, ml_levels, tol, window, max_restarts, pack_slots,
            pack_segs)
        _emit_fiedler_metrics(results)
        return results

    dev_s = _solve_inverse_buckets(
        results, solve_ix, lambda i: vert_gids[i].shape[0],
        lambda i: (next_pow2(vert_gids[i].shape[0]),),
        lambda ix, key, b_pad: _padded_gs_arrays_batched(
            [vert_gids[i] for i in ix], key[0], b_pad),
        lambda arrays: _gs_laplacian_from_np(*arrays, device=dev),
        seeds, warms, tol, graph_of=graph_of, precond=precond,
        use_kernel=use_kernel, device=dev)
    for i in solve_ix:  # deepest hierarchy used: warm start or AMG ladder
        results[i].levels = max(results[i].levels, ml_levels[i])
        results[i].device_seconds = dev_s
    _emit_fiedler_metrics(results)
    return results


# ---------------------------------------------------------------------------
# Degenerate Fiedler pairs (paper §9 future work)
# ---------------------------------------------------------------------------

def fiedler_pair_from_graph(
    graph: Graph,
    *,
    seed: int = 0,
    tol: float = 1e-4,
    window: int = 40,
    max_restarts: int = 60,
    use_kernel: bool = True,
    device=None,
) -> tuple[np.ndarray, np.ndarray, float, float]:
    """(y₂, y₃, λ₂, λ₃): the two smallest nontrivial eigenpairs.

    Paper §9: on topologically-checkerboard graphs λ₂ has multiplicity 2
    and single-vector Lanczos returns an arbitrary member of the eigenspace
    whose cut quality varies (45° cuts expose ≈2N faces vs N).  The second
    vector comes from SPECTRAL DEFLATION: Lanczos again on
    ``L' = L + σ·y₂y₂ᵀ`` (σ above a Gershgorin bound on λ_max pushes y₂'s
    eigenvalue out of the way), the padded ELL Laplacian's ``apply`` (K1
    on the card) plus a rank-one term.  ``device``: where both solves run
    (None: the card)."""
    res1 = fiedler_from_graph(graph, method="lanczos", seed=seed, tol=tol,
                              window=window, max_restarts=max_restarts,
                              use_kernel=use_kernel, device=device)
    y1 = res1.vector / max(np.linalg.norm(res1.vector), 1e-30)

    dev = resolve_device(device)
    n = graph.n
    n_pad = next_pow2(n)
    width = int(graph.degrees.max()) if graph.nnz else 1
    op = _padded_ell_laplacian(graph, n_pad, next_pow2(max(width, 2)),
                               device=dev, use_kernel=use_kernel)
    mask = torch.from_numpy((np.arange(n_pad) < n).astype(np.float32)).to(dev)
    y1p = torch.from_numpy(
        np.pad(y1.astype(np.float32), (0, n_pad - n))).to(dev)
    # Gershgorin bound on λ_max; σ above it exiles y₂'s eigenvalue
    sigma = 4.0 * float(op.diag.max()) + 1.0

    def deflated(x):
        return op.apply(x) + sigma * y1p * torch.dot(y1p, x)

    with obs.annotate("fiedler:lanczos"):
        y, info = lanczos_fiedler(
            deflated, n_pad, mask=mask, seed=seed + 1, window=window,
            max_restarts=max_restarts, tol=tol,
        )
    y2 = y[:n].cpu().numpy()
    y2 = y2 - y1 * float(y1 @ y2)          # exact orthogonality polish
    y2 /= max(np.linalg.norm(y2), 1e-30)
    return y1, y2, res1.eigenvalue, info.eigenvalue


def best_cut_in_pair(
    graph: Graph,
    y1: np.ndarray,
    y2: np.ndarray,
    *,
    n_theta: int = 16,
    weights: np.ndarray | None = None,
) -> tuple[np.ndarray, float, float]:
    """Paper §9: sweep θ over span{y₂, y₃} and keep the balanced bisection
    with the minimum ω-cut.  Returns (fiedler-like vector, θ, cut).  Host
    NumPy, `repro`'s line for line."""
    w = np.ones(graph.n) if weights is None else np.asarray(weights, np.float64)
    rows, cols, ew = graph.rows, graph.indices, graph.weights
    best = (None, 0.0, np.inf)
    for theta in np.linspace(0.0, np.pi, n_theta, endpoint=False):
        v = np.cos(theta) * y1 + np.sin(theta) * y2
        order = np.argsort(v, kind="stable")
        half = np.zeros(graph.n, dtype=bool)
        cw = np.cumsum(w[order])
        k = int(np.searchsorted(cw - w[order] / 2, cw[-1] / 2)) + 1
        half[order[:k]] = True
        cut = float(ew[half[rows] != half[cols]].sum() / 2.0)
        if cut < best[2]:
            best = (v, float(theta), cut)
    return best
