"""The degenerate-pair tools (paper §9) against `repro`'s.

`grid_graph_2d(16, 16)` has a double λ₂ (the x and y modes).  The port
draws the deflated solve's start vector from NumPy, `repro` from
``jax.random``, so y₃ may be another member of the eigenspace: the test
holds the eigenvalues (within the solve's ``tol``) and the span of the
pair (every principal angle's cosine ≥ 0.999), and `best_cut_in_pair`
bit for bit on the same vectors.
"""

import numpy as np
import pytest
import torch

import repro.core.fiedler as fj
import repro.mesh as mesh_j
import repro_torch.core.fiedler as ft
import repro_torch.mesh as mesh_t

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pairs():
    gj, gt = mesh_j.grid_graph_2d(16, 16), mesh_t.grid_graph_2d(16, 16)
    return (gj, fj.fiedler_pair_from_graph(gj, seed=0, tol=TOL),
            ft.fiedler_pair_from_graph(gt, seed=0, tol=TOL, device="cpu"))


def _basis(y1, y2):
    return np.linalg.qr(np.stack([y1, y2], 1).astype(np.float64))[0]


def test_pair_eigenvalues_and_span_match_repro(pairs):
    _, (y1j, y2j, l2j, l3j), (y1t, y2t, l2t, l3t) = pairs
    assert abs(l2t - l2j) <= TOL * l2j and abs(l3t - l3j) <= TOL * l3j
    assert abs(l3t - l2t) <= TOL * l2t          # the double eigenvalue
    assert abs(float(y1t @ y2t)) <= 1e-6        # an orthonormal pair
    assert np.linalg.norm(y2t) == pytest.approx(1.0, abs=1e-6)
    cos = np.linalg.svd(_basis(y1j, y2j).T @ _basis(y1t, y2t),
                        compute_uv=False)
    assert cos.min() >= 0.999


@pytest.mark.parametrize("which", ["repro", "port"])
def test_best_cut_in_pair_matches_repro(which, pairs):
    gj, pj, pt = pairs
    gt = mesh_t.grid_graph_2d(16, 16)
    y1, y2 = (pj if which == "repro" else pt)[:2]
    vj, thj, cj = fj.best_cut_in_pair(gj, y1, y2)
    vt, tht, ct = ft.best_cut_in_pair(gt, y1, y2)
    assert np.array_equal(vt, vj) and tht == thj and ct == cj
    w = np.random.default_rng(3).integers(1, 3, gj.n).astype(float)
    vj, thj, cj = fj.best_cut_in_pair(gj, y1, y2, n_theta=9, weights=w)
    vt, tht, ct = ft.best_cut_in_pair(gt, y1, y2, n_theta=9, weights=w)
    assert np.array_equal(vt, vj) and tht == thj and ct == cj
