"""repro_torch flexcg, the augmented projection and AMG vs repro (CPU).

Tolerances and why:
* flexcg solutions: 1e-4 relative (‖x_t − x_j‖ ≤ 1e-4·‖x_j‖) — both run
  the same fp32 recurrence, summed in another order, to a 1e-5 residual;
  iteration counts within 1 (a last-ulp difference can move the stopping
  test by one step);
* the flexcg loop's flag check every few iterations: bit
  identical to checking every iteration (a frozen iteration is an exact
  no-op);
* `_augmented_projection`: 1e-5 on well-conditioned random Grams (an
  m × m fp32 solve); on an exactly singular Gram both packages return 0
  for that problem and keep the others;
* AMG hierarchies: bit identical (the same host NumPy); one V-cycle within
  1e-5 of the largest output entry (fp32 sums in another order through
  each level), and the per-problem contraction ‖r − L u‖ < 0.9 ‖r‖ of
  tests/test_multilevel.py.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.amg as amg_j
import repro.core.laplacian as lap_j
import repro.mesh as mesh_j
import repro_torch.core.amg as amg_t
import repro_torch.core.laplacian as lap_t
import repro_torch.mesh as mesh_t
from repro.core.flexcg import flexcg as flexcg_j
from repro.core.inverse_iteration import _augmented_projection as aug_j
from repro_torch.core.fiedler import next_pow2
from repro_torch.core.flexcg import flexcg as flexcg_t
from repro_torch.core.inverse_iteration import _augmented_projection as aug_t


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solves here are many small eager ops: one intra-op thread per
    test worker keeps the parallel workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _rhs(n, seed):
    b = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    return b - b.mean()


# ---------------------------------------------------------------------------
# flexcg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precond", ["none", "amg"])
def test_flexcg_1d_matches_jax(precond):
    """grid_graph_2d(16, 16) as in tests/test_fiedler.py, 1-D right-hand
    side, unpreconditioned and AMG-preconditioned."""
    gj, gt = mesh_j.grid_graph_2d(16, 16), mesh_t.grid_graph_2d(16, 16)
    op_j, op_t = lap_j.ell_laplacian(gj), lap_t.ell_laplacian(gt, device="cpu")
    pre_j = amg_j.amg_setup(gj) if precond == "amg" else None
    pre_t = amg_t.amg_setup(gt, device="cpu") if precond == "amg" else None
    b = _rhs(gt.n, seed=0)
    rj = flexcg_j(op_j.apply, jnp.asarray(b), precond=pre_j, tol=1e-5,
                  maxiter=2000)
    rt = flexcg_t(op_t.apply, torch.from_numpy(b), precond=pre_t, tol=1e-5,
                  maxiter=2000)
    assert rt.iters.shape == () and rt.resnorm.shape == ()
    assert _rel(rt.x.numpy(), rj.x) <= 1e-4
    assert abs(int(rt.iters) - int(rj.iters)) <= 1
    if precond == "amg":
        assert int(rt.iters) < 40      # the V-cycle does its work


def _batched_problem(m):
    """Three grids padded into one batched operator plus a batch-padding
    dummy: problems converge at different iterations."""
    graphs = [m.grid_graph_2d(16, 16), m.grid_graph_2d(10, 20),
              m.grid_graph_2d(12, 9)]
    n_pad = next_pow2(max(g.n for g in graphs))
    mask = np.zeros((4, n_pad), dtype=np.float32)
    b = np.zeros((4, n_pad), dtype=np.float32)
    for r, g in enumerate(graphs):
        mask[r, :g.n] = 1.0
        b[r, :g.n] = _rhs(g.n, seed=r)
    return graphs, n_pad, mask, b


def test_flexcg_batched_matches_jax():
    """Jacobi-preconditioned, as the batched inverse path runs it."""
    graphs_j, n_pad, mask, b = _batched_problem(mesh_j)
    graphs_t, _, _, _ = _batched_problem(mesh_t)
    op_j = lap_j.ell_laplacian_batched(graphs_j, n_pad, 8, 4)
    op_t = lap_t.ell_laplacian_batched(graphs_t, n_pad, 8, 4, device="cpu")
    inv_j = jnp.where(op_j.diag > 0, 1.0 / jnp.maximum(op_j.diag, 1e-30), 0.0)
    inv_t = torch.where(op_t.diag > 0, 1.0 / op_t.diag.clamp(min=1e-30), 0.0)
    rj = flexcg_j(op_j, jnp.asarray(b), precond=lambda r: r * inv_j,
                  mask=jnp.asarray(mask), tol=1e-5, maxiter=500)
    rt = flexcg_t(op_t, torch.from_numpy(b), precond=lambda r: r * inv_t,
                  mask=torch.from_numpy(mask), tol=1e-5, maxiter=500)
    it_j, it_t = np.asarray(rj.iters), rt.iters.numpy()
    assert it_t.shape == (4,) and it_t[3] == 0 == it_j[3]   # the dummy
    assert len(set(it_t[:3].tolist())) > 1        # they stop one by one
    assert np.abs(it_t - it_j).max() <= 1
    xj = np.asarray(rj.x)
    for r in range(3):
        assert _rel(rt.x[r].numpy(), xj[r]) <= 1e-4
    assert not rt.x[3].any()


def test_flexcg_flag_check_cadence_is_bit_identical(monkeypatch):
    """Reading the "any problem active" flag every few iterations runs a
    few frozen iterations past the last convergence; they change no bit of
    x, iters or resnorm against reading it every iteration."""
    graphs, n_pad, mask, b = _batched_problem(mesh_t)
    op = lap_t.ell_laplacian_batched(graphs, n_pad, 8, 4, device="cpu")
    pre = amg_t.amg_setup_batched(graphs, n_pad, 4, device="cpu")
    runs = []
    for c in (1, 3, 4, 7):      # 4 is the port's cadence
        monkeypatch.setattr(sys.modules["repro_torch.core.flexcg"],
                            "_CHECK_EVERY", c)
        runs.append(flexcg_t(op, torch.from_numpy(b), precond=pre,
                             mask=torch.from_numpy(mask), tol=1e-5,
                             maxiter=500))
    assert runs[0].iters.max() % 7 and runs[0].iters.max() % 4
    for r in runs[1:]:
        assert torch.equal(r.x, runs[0].x)
        assert torch.equal(r.iters, runs[0].iters)
        assert torch.equal(r.resnorm, runs[0].resnorm)


def test_flexcg_single_iteration_on_eigenvector():
    """Paper §7: with b an eigenvector and the first direction
    unpreconditioned, flexcg stops after one iteration (plus at most one
    roundoff step), AMG preconditioner or not — in both packages."""
    gj, gt = mesh_j.grid_graph_2d(16, 16), mesh_t.grid_graph_2d(16, 16)
    _, y2 = lap_t.fiedler_oracle_np(gt)
    b = y2.astype(np.float32)
    rj = flexcg_j(lap_j.ell_laplacian(gj).apply, jnp.asarray(b),
                  precond=amg_j.amg_setup(gj), tol=1e-4, maxiter=100)
    rt = flexcg_t(lap_t.ell_laplacian(gt, device="cpu").apply,
                  torch.from_numpy(b), precond=amg_t.amg_setup(gt, device="cpu"),
                     tol=1e-4, maxiter=100)
    assert int(rt.iters) <= 2 and int(rj.iters) <= 2
    assert int(rt.iters) == int(rj.iters)


# ---------------------------------------------------------------------------
# The augmented projection's Gram solve
# ---------------------------------------------------------------------------

def test_augmented_projection_matches_jax():
    rng = np.random.default_rng(0)
    B, n, m = 3, 50, 4
    Y = rng.normal(size=(B, n, m)).astype(np.float32)
    W = (Y * rng.uniform(1.0, 2.0, size=(B, n, 1))).astype(np.float32)
    b = rng.normal(size=(B, n)).astype(np.float32)
    want = np.asarray(aug_j(*map(jnp.asarray, (Y, W, b))))
    got = aug_t(*map(torch.from_numpy, (Y, W, b))).numpy()
    assert np.isfinite(want).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_augmented_projection_singular_gram():
    """Problem 0's ridged Gram is exactly singular: G = diag(−1, 200001)
    gets the ridge 1e-5·tr/m = 1, so G + ridge·I = diag(0, 200002).
    `jnp.linalg.solve` answers NaN, which repro turns into x0 = 0;
    `torch.linalg.solve` would raise — the port must return the same 0 and
    keep problem 1."""
    rng = np.random.default_rng(1)
    n = 6
    Y = np.zeros((2, n, 2), dtype=np.float32)
    W = np.zeros((2, n, 2), dtype=np.float32)
    Y[0, 0, 0] = Y[0, 1, 1] = 1.0
    W[0, 0, 0], W[0, 1, 1] = -1.0, 200001.0
    Y[1] = rng.normal(size=(n, 2))
    W[1] = Y[1] * 1.5
    b = rng.normal(size=(2, n)).astype(np.float32)
    want = np.asarray(aug_j(*map(jnp.asarray, (Y, W, b))))
    got = aug_t(*map(torch.from_numpy, (Y, W, b))).numpy()
    assert not want[0].any() and not got[0].any()
    assert np.abs(want[1]).max() > 0.1
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# AMG
# ---------------------------------------------------------------------------

def _same_level_ops(ops_j, ops_t, batched):
    assert len(ops_j) == len(ops_t) > 0
    for a, b in zip(ops_j, ops_t):
        cols, vals = np.asarray(a.cols), np.asarray(a.vals)
        assert np.array_equal(b.cols_t.numpy(), cols.swapaxes(-1, -2))
        assert np.array_equal(b.vals_t.numpy(), vals.swapaxes(-1, -2))
        assert np.array_equal(b.diag.numpy(), np.asarray(a.diag))
        assert b.cols_t.ndim == (3 if batched else 2)


def test_amg_hierarchy_bit_identical():
    gj, gt = mesh_j.grid_graph_2d(20, 26), mesh_t.grid_graph_2d(20, 26)
    order = np.random.default_rng(0).permutation(gt.n)
    pj = amg_j.amg_setup(gj, order=order)
    pt = amg_t.amg_setup(gt, order=order, device="cpu")
    _same_level_ops(pj.ops, pt.ops, batched=False)
    assert pt.sizes == pj.sizes
    for a, b in zip(pj.aggs, pt.aggs):
        assert np.array_equal(b.numpy(), np.asarray(a))
    assert np.array_equal(pt.coarse_pinv.numpy(), np.asarray(pj.coarse_pinv))


@pytest.mark.parametrize("b_pad", [2, 4])
def test_batched_amg_hierarchy_bit_identical(b_pad):
    dims = [(20, 20), (16, 25)]
    pj = amg_j.amg_setup_batched([mesh_j.grid_graph_2d(*d) for d in dims],
                                 512, b_pad)
    pt = amg_t.amg_setup_batched([mesh_t.grid_graph_2d(*d) for d in dims],
                                 512, b_pad, device="cpu")
    _same_level_ops(pj.ops, pt.ops, batched=True)
    assert pt.sizes == pj.sizes and pt.sizes[-1] == 16
    assert np.array_equal(pt.coarse_pinv.numpy(), np.asarray(pj.coarse_pinv))


def test_vcycle_matches_jax_and_contracts():
    """One V-cycle on the inputs of tests/test_multilevel.py:102 (batched)
    and on grid_graph_2d(16, 16) (unbatched)."""
    dims = [(20, 20), (16, 25)]
    graphs = [mesh_t.grid_graph_2d(*d) for d in dims]
    n_pad = next_pow2(max(g.n for g in graphs))
    rng = np.random.default_rng(0)
    R = np.zeros((2, n_pad), dtype=np.float32)
    for b, g in enumerate(graphs):
        R[b, :g.n] = _rhs(g.n, seed=10 + b)
    pj = amg_j.amg_setup_batched([mesh_j.grid_graph_2d(*d) for d in dims],
                                 n_pad, 2)
    pt = amg_t.amg_setup_batched(graphs, n_pad, 2, device="cpu")
    Uj = np.asarray(pj(jnp.asarray(R)))
    Ut = pt(torch.from_numpy(R)).numpy()
    assert Ut.shape == (2, n_pad) and np.isfinite(Ut).all()
    assert np.abs(Ut - Uj).max() <= 1e-5 * np.abs(Uj).max()
    for b, g in enumerate(graphs):
        op = lap_t.ell_laplacian(g, device="cpu")
        res = R[b, :g.n] - op.apply(torch.from_numpy(Ut[b, :g.n])).numpy()
        assert np.linalg.norm(res) < 0.9 * np.linalg.norm(R[b, :g.n])

    gj, gt = mesh_j.grid_graph_2d(16, 16), mesh_t.grid_graph_2d(16, 16)
    r = rng.normal(size=gt.n).astype(np.float32)
    r -= r.mean()
    uj = np.asarray(amg_j.amg_setup(gj)(jnp.asarray(r)))
    ut = amg_t.amg_setup(gt, device="cpu")(torch.from_numpy(r)).numpy()
    assert np.abs(ut - uj).max() <= 1e-5 * np.abs(uj).max()
    res = r - lap_t.ell_laplacian(gt, device="cpu").apply(
        torch.from_numpy(ut)).numpy()
    assert np.linalg.norm(res) < 0.9 * np.linalg.norm(r)
