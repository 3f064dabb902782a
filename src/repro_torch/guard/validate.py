"""Validation front door: typed diagnostics + optional sanitizing repair.

The port of `repro.guard.validate`, host NumPy and bit-identical to it.
``validate_graph`` / ``validate_mesh`` run as the implicit first stage of
a guarded ``PartitionPipeline`` (and are callable directly by CLI entry
points).  Strict mode (``sanitize=False``) raises a :class:`GuardError` on
the first class of defect found; ``sanitize=True`` repairs what is
repairable — dropping self-loops and non-positive/non-finite edge weights,
coalescing duplicate edges, patching non-finite coordinates and node
weights — and records every fix in the :class:`GuardReport`.

Disconnected inputs (including zero-degree nodes, which are singleton
components) are *handled*, not rejected: the Fiedler vector is undefined
there, so the pipeline partitions each component independently with
proportional part budgets (:func:`proportional_budgets`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.guard.errors import GuardError, GuardIssue, GuardReport
from repro_torch.mesh.graphs import Graph, build_csr, connected_labels


# ---------------------------------------------------------------------------
# Scalar / CLI checks
# ---------------------------------------------------------------------------

def check_positive_int(name: str, value, *, minimum: int = 1,
                       maximum: int | None = None) -> int:
    """CLI front-door check: ``value`` must be an int >= ``minimum``."""
    try:
        v = int(value)
    except (TypeError, ValueError):
        raise GuardError("bad-argument",
                         f"{name} must be an integer, got {value!r}",
                         details={"name": name, "value": value}) from None
    if v != float(value) or v < minimum or (maximum is not None
                                            and v > maximum):
        lo_hi = f">= {minimum}" if maximum is None else \
            f"in [{minimum}, {maximum}]"
        raise GuardError("bad-argument",
                         f"{name} must be {lo_hi}, got {value!r}",
                         details={"name": name, "value": value,
                                  "minimum": minimum, "maximum": maximum})
    return v


def validate_nparts(nparts, n: int) -> int:
    """``nparts`` must be an integer in ``[1, n]``."""
    try:
        k = int(nparts)
    except (TypeError, ValueError):
        raise GuardError("bad-nparts",
                         f"nparts must be an integer, got {nparts!r}",
                         details={"nparts": nparts, "n": n}) from None
    if k < 1 or k > max(int(n), 1):
        raise GuardError("bad-nparts",
                         f"nparts={k} out of range [1, {n}] "
                         f"for an input with {n} nodes",
                         details={"nparts": k, "n": int(n)})
    return k


# ---------------------------------------------------------------------------
# Graph validation
# ---------------------------------------------------------------------------

def _patch_nonfinite_rows(arr: np.ndarray) -> tuple[np.ndarray, int]:
    """Replace rows containing non-finite entries with the column means of
    the finite rows (0 when no row is finite).  Returns (fixed, n_bad)."""
    a = np.asarray(arr, np.float64)
    flat = a.reshape(a.shape[0], -1)
    bad = ~np.isfinite(flat).all(axis=1)
    n_bad = int(bad.sum())
    if n_bad == 0:
        return arr, 0
    good = flat[~bad]
    fill = good.mean(axis=0) if good.size else np.zeros(flat.shape[1])
    flat = flat.copy()
    flat[bad] = fill
    return flat.reshape(a.shape).astype(np.asarray(arr).dtype, copy=False), \
        n_bad


def _raise_or_record(report: GuardReport | None, sanitize: bool,
                     code: str, message: str, count: int,
                     details: dict) -> None:
    """Strict mode raises; sanitize mode records a fixed issue."""
    if not sanitize:
        raise GuardError(code, message, details=details)
    if report is not None:
        report.record(GuardIssue(code, message, count=count, fixed=True))


def validate_graph(graph: Graph, *, coords=None, weights=None,
                   nparts=None, sanitize: bool = False,
                   report: GuardReport | None = None):
    """Validate (and optionally repair) a CSR graph + optional per-node
    coords/weights.  Returns ``(graph, coords, weights)`` — identical
    objects when nothing needed fixing.

    Strict mode raises :class:`GuardError`; ``sanitize=True`` repairs and
    records into ``report``.  Structural CSR corruption and out-of-range
    ``nparts`` are never repairable.
    """
    n = int(graph.n)
    indptr = np.asarray(graph.indptr)
    indices = np.asarray(graph.indices)
    w_edge = np.asarray(graph.weights)

    if indptr.shape != (n + 1,) or int(indptr[0]) != 0 or \
            int(indptr[-1]) != indices.size or np.any(np.diff(indptr) < 0):
        raise GuardError("malformed-csr",
                         "indptr is not a monotone [0..nnz] prefix array",
                         details={"n": n, "nnz": int(indices.size)})
    if indices.size and (indices.min() < 0 or indices.max() >= n):
        raise GuardError("malformed-csr",
                         "column indices out of range [0, n)",
                         details={"n": n, "min": int(indices.min()),
                                  "max": int(indices.max())})
    if nparts is not None:
        validate_nparts(nparts, n)

    rows = graph.rows
    nonfinite = int((~np.isfinite(w_edge)).sum())
    nonpos = int((np.isfinite(w_edge) & (w_edge <= 0)).sum())
    loops = int((rows == indices).sum())
    key = rows.astype(np.int64) * n + indices.astype(np.int64)
    dups = int(key.size - np.unique(key).size)

    if nonfinite:
        _raise_or_record(report, sanitize, "nonfinite-edge-weight",
                         f"{nonfinite} edge weights are NaN/Inf",
                         nonfinite, {"count": nonfinite})
    if nonpos:
        _raise_or_record(report, sanitize, "nonpositive-edge-weight",
                         f"{nonpos} edge weights are <= 0",
                         nonpos, {"count": nonpos})
    if loops:
        _raise_or_record(report, sanitize, "self-loop",
                         f"{loops} self-loop entries", loops,
                         {"count": loops})
    if dups:
        _raise_or_record(report, sanitize, "duplicate-edge",
                         f"{dups} duplicate (row, col) entries coalesced",
                         dups, {"count": dups})
    if sanitize and (nonfinite or nonpos or loops or dups):
        keep = np.isfinite(w_edge) & (w_edge > 0) & (rows != indices)
        graph = build_csr(rows[keep], indices[keep], n,
                          weights=w_edge[keep], symmetrize=False,
                          sum_duplicates=True)

    if weights is not None:
        w = np.asarray(weights, np.float64)
        if w.shape[0] != n:
            raise GuardError("bad-node-weight",
                             f"weights has {w.shape[0]} entries for "
                             f"{n} nodes", details={"n": n,
                                                    "len": int(w.shape[0])})
        bad = ~np.isfinite(w) | (w < 0)
        n_bad = int(bad.sum())
        if n_bad:
            _raise_or_record(report, sanitize, "bad-node-weight",
                             f"{n_bad} node weights are NaN/Inf/negative",
                             n_bad, {"count": n_bad})
            w = w.copy()
            w[bad] = 1.0
            weights = w

    if coords is not None:
        c = np.asarray(coords)
        n_bad = int((~np.isfinite(
            c.reshape(c.shape[0], -1)).all(axis=1)).sum())
        if n_bad:
            _raise_or_record(report, sanitize, "nonfinite-coords",
                             f"{n_bad} coordinate rows are NaN/Inf",
                             n_bad, {"count": n_bad})
            coords, _ = _patch_nonfinite_rows(c)

    # Zero-degree nodes and multiple components are *handled* downstream
    # (per-component partitioning) — record them, never raise.
    if report is not None:
        zdeg = int((np.diff(np.asarray(graph.indptr)) == 0).sum())
        if zdeg:
            report.record(GuardIssue(
                "zero-degree-node",
                f"{zdeg} nodes have no incident edges "
                "(partitioned as singleton components)", count=zdeg))
        report.validated = True
        report.sanitized = report.sanitized or sanitize
    return graph, coords, weights


def validate_mesh(mesh, *, nparts=None, sanitize: bool = False,
                  report: GuardReport | None = None):
    """Validate (and optionally repair) a ``HexMesh``: finite coordinates
    and non-negative finite element weights; ``nparts`` in range."""
    nelems = int(mesh.nelems)
    if nelems < 1:
        raise GuardError("empty-mesh", "mesh has no elements",
                         details={"nelems": nelems})
    if nparts is not None:
        validate_nparts(nparts, nelems)

    coords = np.asarray(mesh.coords)
    weights = np.asarray(mesh.weights, np.float64)
    patch: dict = {}

    bad_c = int((~np.isfinite(
        coords.reshape(nelems, -1)).all(axis=1)).sum())
    if bad_c:
        _raise_or_record(report, sanitize, "nonfinite-coords",
                         f"{bad_c} element centroids are NaN/Inf",
                         bad_c, {"count": bad_c})
        patch["coords"], _ = _patch_nonfinite_rows(coords)

    bad_w = int((~np.isfinite(weights) | (weights < 0)).sum())
    if bad_w:
        _raise_or_record(report, sanitize, "bad-node-weight",
                         f"{bad_w} element weights are NaN/Inf/negative",
                         bad_w, {"count": bad_w})
        w = weights.copy()
        w[~np.isfinite(w) | (w < 0)] = 1.0
        patch["weights"] = w.astype(np.asarray(mesh.weights).dtype,
                                    copy=False)

    if report is not None:
        report.validated = True
        report.sanitized = report.sanitized or sanitize
    return dataclasses.replace(mesh, **patch) if patch else mesh


# ---------------------------------------------------------------------------
# Connected components + proportional part budgets
# ---------------------------------------------------------------------------

def component_labels(graph: Graph) -> tuple[np.ndarray, int]:
    """Compacted component label per node and the component count."""
    labels = connected_labels(graph.n, graph.rows, graph.indices)
    ncomp = int(labels.max()) + 1 if labels.size else 0
    return labels, ncomp


def proportional_budgets(comp_weights, nparts: int) -> np.ndarray:
    """Largest-remainder apportionment of ``nparts`` over components,
    with a floor of one part per component (requires
    ``nparts >= len(comp_weights)``)."""
    w = np.asarray(comp_weights, np.float64)
    k = w.size
    if k == 0 or nparts < k:
        raise GuardError("bad-nparts",
                         f"cannot give {k} components >=1 part each "
                         f"with nparts={nparts}",
                         details={"components": k, "nparts": int(nparts)})
    total = float(w.sum())
    raw = (nparts * w / total) if total > 0 else np.full(k, nparts / k)
    b = np.maximum(1, np.floor(raw).astype(np.int64))
    rem = raw - np.floor(raw)
    diff = int(nparts - b.sum())
    order = np.argsort(-rem, kind="stable")
    i = 0
    while diff > 0:                      # hand out leftovers by remainder
        b[order[i % k]] += 1
        diff -= 1
        i += 1
    order_take = np.argsort(rem, kind="stable")
    i = 0
    while diff < 0:                      # claw back over-floored budgets
        c = order_take[i % k]
        if b[c] > 1:
            b[c] -= 1
            diff += 1
        i += 1
    return b


def pack_components(comp_weights, nparts: int) -> np.ndarray:
    """When there are more components than parts, group whole components
    into ``nparts`` bins (greedy heaviest-first onto the lightest bin).
    Returns the bin id per component."""
    w = np.asarray(comp_weights, np.float64)
    k = w.size
    bins = np.zeros(nparts, np.float64)
    group = np.empty(k, np.int64)
    for c in np.argsort(-w, kind="stable"):
        g = int(np.argmin(bins))
        group[c] = g
        bins[g] += w[c]
    return group
