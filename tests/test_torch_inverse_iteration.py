"""repro_torch inverse iteration (Jacobi and AMG flexcg) vs repro (CPU).

The graphs are those of tests/test_multilevel.py:123-147 and
tests/test_kernels.py:79; the JAX side runs repro's own path (inline
matvecs, ``guard=False`` semantics: no chaos hooks fire).

Tolerances and why:
* eigenvalues within ``rel=2e-2, abs=1e-4`` of the dense oracle and of
  repro's — the solves stop at ``tol=1e-4`` or on the single-iteration
  signal, so λ carries the solve's error, not fp32 rounding;
* |cos| ≥ 0.999 against repro's vector on the non-square grids (a simple
  λ₂ with a clear gap); square grids have a degenerate λ₂ (paper §9), so
  only their eigenvalues are compared;
* outer iteration counts within 1 (fp32 sums in another order can move a
  stopping test by one step);
* the singular-Gram regression (tests/test_rsb_engine.py:145): the same
  ``breakdown`` and ``converged`` flags in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.fiedler as fj
import repro.core.laplacian as lap_j
import repro.mesh as mesh_j
import repro_torch.core.fiedler as ft
import repro_torch.core.laplacian as lap_t
import repro_torch.mesh as mesh_t
from repro.core.inverse_iteration import inverse_iteration_batched as iib_j
from repro_torch.core.inverse_iteration import inverse_iteration_batched as iib_t

TOL = 1e-4
MULTI = [(20, 20), (16, 25), (24, 14)]       # tests/test_multilevel.py:141


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solves here are many small eager ops: one intra-op thread per
    test worker keeps the parallel workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))


def _check_pair(dims, a, b):
    lam, _ = lap_t.fiedler_oracle_np(mesh_t.grid_graph_2d(*dims))
    assert b.method == "inverse" and np.isfinite(b.vector).all()
    assert b.eigenvalue == pytest.approx(lam, rel=2e-2, abs=1e-4)
    assert b.eigenvalue == pytest.approx(a.eigenvalue, rel=2e-2, abs=1e-4)
    if dims[0] != dims[1]:
        assert _cos(a.vector, b.vector) >= 0.999
    assert abs(a.iterations - b.iterations) <= 1
    assert a.levels == b.levels and a.breakdown == b.breakdown


@pytest.mark.parametrize("precond", ["jacobi", "amg"])
def test_batched_inverse_multi_problem(precond):
    kw = dict(method="inverse", precond=precond, tol=TOL)
    rj = fj.fiedler_from_graph_batched(
        [mesh_j.grid_graph_2d(*d) for d in MULTI], **kw)
    rt = ft.fiedler_from_graph_batched(
        [mesh_t.grid_graph_2d(*d) for d in MULTI], device="cpu", **kw)
    for d, a, b in zip(MULTI, rj, rt):
        _check_pair(d, a, b)
        assert b.inner_iterations > 0 and b.device_seconds > 0.0
        if precond == "amg":
            assert b.levels >= 1


@pytest.mark.parametrize("dims,precond",
                         [((20, 26), "amg"), ((18, 24), "jacobi")])
def test_batched_inverse_batch_of_one(dims, precond):
    """tests/test_multilevel.py:123 (AMG) and tests/test_kernels.py:79
    (Jacobi, which repro runs through its Pallas kernel there)."""
    kw = dict(method="inverse", precond=precond, tol=TOL)
    a = fj.fiedler_from_graph_batched([mesh_j.grid_graph_2d(*dims)], **kw)[0]
    b = ft.fiedler_from_graph_batched([mesh_t.grid_graph_2d(*dims)],
                                      device="cpu", **kw)[0]
    _check_pair(dims, a, b)


@pytest.mark.parametrize("dims", [(20, 26), (18, 24)])
def test_unbatched_inverse_matches_jax(dims):
    """`fiedler_from_graph(method="inverse")`: the graph's own AMG (2-D
    level operators, K1's route)."""
    a = fj.fiedler_from_graph(mesh_j.grid_graph_2d(*dims), method="inverse",
                              tol=TOL, seed=3)
    b = ft.fiedler_from_graph(mesh_t.grid_graph_2d(*dims), method="inverse",
                              tol=TOL, seed=3, device="cpu")
    _check_pair(dims, a, b)
    assert b.inner_iterations > 0


def test_batched_start_vectors_match():
    graphs = [mesh_t.grid_graph_2d(*d) for d in MULTI]
    warms = [None, ft._blend_noise(ft.multilevel_warm_start(graphs[1])[0], 4),
             None]
    args = ([g.n for g in graphs], [3, 4, 5], warms, 512, 4)
    assert np.array_equal(ft._batched_b0(*args), np.asarray(fj._batched_b0(*args)))


@pytest.mark.parametrize("dims", [(16, 25), (14, 15)])
def test_inverse_gram_breakdown_regression(dims):
    """tests/test_rsb_engine.py:145 through both packages: cold noise
    starts, where near-duplicate projection iterates once made the fp32
    Gram singular.  The solver-level flags agree, and both entry points
    return finite vectors with a sane eigenvalue."""
    gj, gt = mesh_j.grid_graph_2d(*dims), mesh_t.grid_graph_2d(*dims)
    lam, _ = lap_t.fiedler_oracle_np(gt)
    n_pad = ft.next_pow2(gt.n)
    mask = (np.arange(n_pad) < gt.n).astype(np.float32)[None]
    b0 = ft._noise_b0(0, n_pad)[None]
    _, ij = iib_j(lap_j.ell_laplacian_batched([gj], n_pad, 8, 1), n_pad,
                  mask=jnp.asarray(mask), b0=jnp.asarray(b0), tol=TOL)
    _, it = iib_t(lap_t.ell_laplacian_batched([gt], n_pad, 8, 1, device="cpu"),
                  n_pad, mask=torch.from_numpy(mask), b0=torch.from_numpy(b0),
                  tol=TOL)
    assert np.array_equal(it.breakdown, ij.breakdown)
    assert np.array_equal(it.converged, ij.converged)
    assert np.abs(it.outer_iters - ij.outer_iters).max() <= 1
    kw = dict(method="inverse", tol=TOL, multilevel=False)
    rb = ft.fiedler_from_graph_batched([gt], device="cpu", **kw)[0]
    ru = ft.fiedler_from_graph(gt, device="cpu", **kw)
    ru_j = fj.fiedler_from_graph(gj, **kw)
    assert ru.breakdown == ru_j.breakdown
    for r in (rb, ru):
        assert np.isfinite(r.vector).all()
        assert r.eigenvalue == pytest.approx(lam, rel=5e-2, abs=1e-4)


def test_bad_preconditioner_raises():
    g = mesh_t.grid_graph_2d(20, 20)
    with pytest.raises(ValueError, match="unknown preconditioner"):
        ft.fiedler_from_graph_batched([g], method="inverse", precond="nope",
                                      device="cpu")
