"""repro_torch Laplacian, Lanczos and Fiedler front end vs repro (CPU).

Tolerances and why:
* the packed operator apply: 1e-5 — both sum the same ≤ 8 fp32 products
  per row, in another order;
* `multilevel_warm_start`: 1e-10 — the same float64 NumPy code, so in
  practice exact;
* packed Lanczos solves: eigenvalues within the solve's ``tol`` relative
  and |cos| ≥ 0.999 — the fp32 device arithmetic differs between the
  packages, and eigenvector signs are arbitrary in both; graphs are
  rectangular grids, whose λ₂ is simple (a clear spectral gap), so the
  vectors are comparable;
* restart counts within one;
* the dense path below the cutoff: exact (the same NumPy `eigh`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.fiedler as fj
import repro.core.lanczos as lj
import repro.mesh as mesh_j
import repro_torch.core.fiedler as ft
import repro_torch.core.lanczos as lt
import repro_torch.mesh as mesh_t
from repro_torch.convert import ell_from_arrays
from repro_torch.core.laplacian import fiedler_oracle_np

GRID_BATCH = [(16, 20), (24, 28), (20, 30)]   # all above _DENSE_CUTOFF=192
TOL = 1e-4


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


def _pack(graphs):
    sizes = [g.n for g in graphs]
    offs, N, n_seg, seg, mask = fj._pack_layout(sizes)
    return sizes, offs, N, n_seg, seg, mask


def test_packed_operator_apply_matches_jax():
    graphs_j = [mesh_j.grid_graph_2d(*d) for d in GRID_BATCH]
    graphs_t = [mesh_t.grid_graph_2d(*d) for d in GRID_BATCH]
    _, offs, N, _, _, _ = _pack(graphs_j)
    assert ft._pack_layout([g.n for g in graphs_t])[1] == N
    op_j = fj._packed_ell_laplacian(graphs_j, offs, N, 8)
    x = np.random.default_rng(0).normal(size=N).astype(np.float32)
    want = np.asarray(op_j.apply(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    for use_kernel in (True, False):
        op_t = ft._packed_ell_laplacian(graphs_t, offs, N, 8, device="cpu",
                                        use_kernel=use_kernel)
        assert op_t.cols_t.shape == (8, N) and op_t.cols_t.is_contiguous()
        np.testing.assert_allclose(op_t.apply(xt).numpy(), want, atol=1e-5)
    # The same operator rebuilt from repro's arrays (`convert`).
    op_c = ell_from_arrays(np.asarray(op_j.cols), np.asarray(op_j.vals),
                           np.asarray(op_j.diag), N, "cpu")
    np.testing.assert_allclose(op_c.apply(xt).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dims", [(24, 28), (30, 17)])
def test_multilevel_warm_start_matches(dims):
    gj, gt = mesh_j.grid_graph_2d(*dims), mesh_t.grid_graph_2d(*dims)
    wj, lvj = fj.multilevel_warm_start(gj)
    wt, lvt = ft.multilevel_warm_start(gt)
    assert lvj == lvt > 0
    np.testing.assert_allclose(wt, wj, atol=1e-10, rtol=0)


def test_packed_start_vectors_match():
    graphs = [mesh_t.grid_graph_2d(*d) for d in GRID_BATCH]
    sizes, offs, N, _, _, _ = _pack(graphs)
    warms = [None, ft.multilevel_warm_start(graphs[1])[0], None]
    seeds = [3, 4, 5]
    want = np.asarray(fj._packed_b0(sizes, offs, N, seeds, warms))
    assert np.array_equal(ft._packed_b0(sizes, offs, N, seeds, warms), want)


@pytest.mark.parametrize("multilevel", [True, False])
def test_fiedler_batched_matches_jax(multilevel):
    graphs_j = [mesh_j.grid_graph_2d(*d) for d in GRID_BATCH]
    graphs_t = [mesh_t.grid_graph_2d(*d) for d in GRID_BATCH]
    kw = dict(seeds=[11, 12, 13], tol=TOL, window=30, max_restarts=40,
              multilevel=multilevel)
    rj = fj.fiedler_from_graph_batched(graphs_j, **kw)
    rt = ft.fiedler_from_graph_batched(graphs_t, device="cpu", **kw)
    for g, a, b in zip(graphs_t, rj, rt):
        assert b.method == "lanczos" and b.vector.shape == (g.n,)
        assert abs(b.eigenvalue - a.eigenvalue) <= TOL * a.eigenvalue
        assert _cos(a.vector, b.vector) >= 0.999
        assert abs(a.iterations - b.iterations) <= 1
        assert a.levels == b.levels
        assert b.device_seconds > 0.0
        lam, _ = fiedler_oracle_np(g)
        assert b.eigenvalue == pytest.approx(lam, rel=10 * TOL)


def test_dense_path_exact():
    gj, gt = mesh_j.grid_graph_2d(10, 12), mesh_t.grid_graph_2d(10, 12)
    rj = fj.fiedler_from_graph_batched([gj])[0]
    rt = ft.fiedler_from_graph_batched([gt], device="cpu")[0]
    assert rt.method == "dense"
    assert np.array_equal(rj.vector, rt.vector)
    assert rj.eigenvalue == rt.eigenvalue
    single = ft.fiedler_from_graph(gt, device="cpu")
    assert np.array_equal(single.vector, rt.vector)


def test_fiedler_unbatched_matches_jax():
    gj, gt = mesh_j.grid_graph_2d(18, 25), mesh_t.grid_graph_2d(18, 25)
    a = fj.fiedler_from_graph(gj, tol=TOL, seed=2)
    b = ft.fiedler_from_graph(gt, tol=TOL, seed=2, device="cpu")
    assert abs(b.eigenvalue - a.eigenvalue) <= TOL * a.eigenvalue
    assert _cos(a.vector, b.vector) >= 0.999
    assert abs(a.iterations - b.iterations) <= 1


def test_lanczos_unbatched_on_operator():
    """`lanczos_fiedler` on a plain callable from the same start vector."""
    g = mesh_t.grid_graph_2d(14, 23)
    op = ft._packed_ell_laplacian([g], [0, 512], 512, 8, device="cpu")
    mask = (np.arange(512) < g.n).astype(np.float32)
    b0 = ft._noise_b0(9, 512)
    yj, ij = lj.lanczos_fiedler(
        fj._padded_ell_laplacian(mesh_j.grid_graph_2d(14, 23), 512, 8), 512,
        mask=jnp.asarray(mask), b0=jnp.asarray(b0), tol=TOL)
    yt, it = lt.lanczos_fiedler(op, 512, mask=torch.from_numpy(mask),
                                b0=torch.from_numpy(b0), tol=TOL)
    assert it.converged and ij.converged
    assert abs(it.eigenvalue - ij.eigenvalue) <= TOL * ij.eigenvalue
    assert _cos(np.asarray(yj)[:g.n], yt.numpy()[:g.n]) >= 0.999


def test_breakdown_is_flagged_not_raised():
    """A non-finite operator freezes the problems it reaches as breakdowns,
    as in repro, instead of raising from the eigensolver."""
    import dataclasses

    graphs = [mesh_t.grid_graph_2d(*d) for d in GRID_BATCH[:2]]
    sizes, offs, N, n_seg, seg, mask = _pack(graphs)
    b0 = ft._packed_b0(sizes, offs, N, [1, 2], [None, None])
    op_t = ft._packed_ell_laplacian(graphs, offs, N, 8, device="cpu")
    op_t.diag[0] = float("nan")
    op_j = fj._packed_ell_laplacian(graphs, offs, N, 8)
    op_j = dataclasses.replace(op_j, diag=op_j.diag.at[0].set(jnp.nan))
    kw = dict(seg=seg, n_seg=n_seg, mask=mask, b0=b0, window=10,
              max_restarts=3)
    _, it = lt.lanczos_fiedler_batched(op_t, N, **kw)
    _, ij = lj.lanczos_fiedler_batched(
        op_j, N, **{**kw, "seg": jnp.asarray(seg), "mask": jnp.asarray(mask),
                    "b0": jnp.asarray(b0)})
    assert it.breakdown[0] and it.converged.all()
    assert np.array_equal(it.breakdown, ij.breakdown)
    assert np.array_equal(it.restarts, ij.restarts)


def test_unported_and_device_contract(monkeypatch):
    g = mesh_t.grid_graph_2d(16, 20)
    with pytest.raises(ValueError, match="unknown fiedler method"):
        ft.fiedler_from_graph_batched([g], method="nope", device="cpu")
    with pytest.raises(ValueError, match="unknown fiedler method"):
        ft.fiedler_from_graph(g, method="nope", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.fiedler_from_graph_batched([g])
