"""repro_torch.core.gather_scatter (the matrix-free dual-graph Laplacian,
paper §5) vs repro.core.gather_scatter on the same id tables.

The setup is host NumPy in both packages, so the compacted ids must be
identical.  The port's apply is an ordered segment sum (each id's values
added in flat-position order, as a sequential scatter-add does: bit for
bit equal to ``index_add_`` on the CPU), held to
`repro`'s within 1e-5 relative to the size of the terms (Σ|terms|, the
scale of what the two float32 sums add); the weighted Laplacian is also
held to the port's own ELL Laplacian of the same dual graph, and the
unweighted one to the dual graph's adjacency with each neighbour counted
once, both at the same 1e-5.
"""

import numpy as np
import pytest
import torch

import repro.core.fiedler as fd_j
import repro.core.gather_scatter as gs_j
import repro.mesh as mesh_j
import repro_torch.core.fiedler as fd_t
import repro_torch.core.gather_scatter as gs_t
import repro_torch.mesh as mesh_t
from repro_torch.core.laplacian import ell_laplacian
from repro_torch.mesh.graphs import build_csr

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


MESHES = {
    "box": lambda m: m.box_mesh(5, 4, 3),
    "pebble": lambda m: m.pebble_mesh(6, 6, 6, n_pebbles=2, seed=3),
}


def _close(got, want, scale):
    """|got − want| ≤ TOL·scale elementwise (scale: Σ|terms| per entry)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= TOL * np.maximum(scale, 1.0)), \
        float(np.max(np.abs(got - want) / np.maximum(scale, 1.0)))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_gs_setup_ids_identical(name):
    vg = MESHES[name](mesh_j).vert_gid
    hj = gs_j.gs_setup(np.asarray(vg))
    ht = gs_t.gs_setup(MESHES[name](mesh_t).vert_gid, device="cpu")
    assert np.array_equal(np.asarray(hj.gid), ht.gid.numpy())
    assert hj.n_global == ht.n_global
    # the occurrence table: each id's flat positions in increasing order,
    # padded with the zero position, and each position's row
    flat, occ = ht.take.numpy(), ht.occ.numpy()
    assert np.array_equal(flat, ht.gid.numpy().ravel())
    assert occ.shape == (np.bincount(flat).max(), ht.n_global)
    for g in (0, ht.n_global // 2, ht.n_global - 1):
        pos = np.flatnonzero(flat == g)
        assert np.array_equal(occ[:pos.size, g], pos)
        assert np.all(occ[pos.size:, g] == flat.size)


def _tables(name):
    """(flat vert_gid, batched (B, E, K) ids + bound) from both packages:
    the flat table of the mesh, and the padded per-problem stack of its
    two RCB halves (`_padded_gs_laplacian_batched`'s layout)."""
    mj, mt = MESHES[name](mesh_j), MESHES[name](mesh_t)
    vg = np.asarray(mt.vert_gid)
    half = mt.nelems // 2
    parts = [vg[:half], vg[half:]]
    n_pad = fd_t.next_pow2(max(p.shape[0] for p in parts))
    return np.asarray(mj.vert_gid), vg, parts, n_pad


@pytest.mark.parametrize("name", sorted(MESHES))
def test_flat_apply_against_repro(name):
    vj, vt, _, _ = _tables(name)
    rng = np.random.default_rng(0)
    E, K = vt.shape
    hj, ht = gs_j.gs_setup(vj), gs_t.gs_setup(vt, device="cpu")
    u = rng.normal(size=(E, K)).astype(np.float32)
    x = rng.normal(size=E).astype(np.float32)
    X = rng.normal(size=(3, E)).astype(np.float32)
    _close(gs_t.gs_apply(ht, torch.from_numpy(u)),
           gs_j.gs_apply(hj, u), np.asarray(gs_j.gs_apply(hj, np.abs(u))))
    _close(gs_t.aw_apply(ht, torch.from_numpy(x)),
           gs_j.aw_apply(hj, x), np.asarray(gs_j.aw_apply(hj, np.abs(x))))
    _close(gs_t.aw_apply(ht, torch.from_numpy(X)),   # leading batch dims
           gs_j.aw_apply(hj, X), np.asarray(gs_j.aw_apply(hj, np.abs(X))))
    Lj = gs_j.weighted_laplacian(vj)
    Lt = gs_t.weighted_laplacian(vt, device="cpu")
    assert np.array_equal(np.asarray(Lj.degree_full), Lt.degree_full.numpy())
    assert np.array_equal(np.asarray(Lj.diag), Lt.diag.numpy())
    scale = (np.asarray(Lj.degree_full) * np.abs(x)
             + np.asarray(gs_j.aw_apply(hj, np.abs(x))))
    _close(Lt.apply(torch.from_numpy(x)), Lj.apply(x), scale)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_batched_apply_against_repro(name):
    _, _, parts, n_pad = _tables(name)
    Lj = fd_j._padded_gs_laplacian_batched(parts, n_pad, 2)
    Lt = fd_t._padded_gs_laplacian_batched(parts, n_pad, 2, device="cpu")
    hj, ht = Lj.terms[0][1], Lt.terms[0][1]
    assert np.array_equal(np.asarray(hj.gid), ht.gid.numpy())
    assert np.array_equal(np.asarray(Lj.degree_full), Lt.degree_full.numpy())
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, n_pad)).astype(np.float32)
    u = rng.normal(size=ht.gid.shape).astype(np.float32)
    _close(gs_t.gs_apply(ht, torch.from_numpy(u)), gs_j.gs_apply(hj, u),
           np.asarray(gs_j.gs_apply(hj, np.abs(u))))
    scale = (np.asarray(Lj.degree_full) * np.abs(x)
             + np.asarray(gs_j.aw_apply(hj, np.abs(x))))
    _close(Lt.apply(torch.from_numpy(x)), Lj.apply(x), scale)
    # each problem of the stack equals its own padded operator
    for b, p in enumerate(parts):
        L1 = fd_t._padded_gs_laplacian(p, n_pad, device="cpu")
        _close(Lt.apply(torch.from_numpy(x))[b],
               L1.apply(torch.from_numpy(x[b])), scale[b])


@pytest.mark.parametrize("name", sorted(MESHES))
def test_weighted_gs_against_ell(name):
    """The matrix-free operator and the port's assembled ELL Laplacian of
    the same dual graph apply the same matrix (both on the CPU)."""
    m = MESHES[name](mesh_t)
    g = mesh_t.dual_graph(m)
    L_gs = gs_t.weighted_laplacian(m.vert_gid, device="cpu")
    L_ell = ell_laplacian(g, device="cpu")
    x = np.random.default_rng(2).normal(size=m.nelems).astype(np.float32)
    xt = torch.from_numpy(x)
    deg = np.bincount(g.rows, weights=g.weights, minlength=g.n)
    ax = np.bincount(g.rows, weights=g.weights * np.abs(x)[g.indices],
                     minlength=g.n)
    _close(L_gs.apply(xt), L_ell.apply(xt), deg * np.abs(x) + ax)
    assert np.array_equal(L_gs.diag.numpy(), L_ell.diag.numpy())


def test_unweighted_gs_counts_neighbours_once():
    m = mesh_t.box_mesh(4, 3, 3)
    g = mesh_t.dual_graph(m)
    gu = build_csr(g.rows, g.indices, g.n, weights=np.ones(g.nnz),
                   symmetrize=False, sum_duplicates=False)
    L = gs_t.unweighted_laplacian(m.vert_gid, m.edge_gid, m.face_gid,
                                  device="cpu")
    x = np.random.default_rng(3).normal(size=m.nelems).astype(np.float32)
    deg = np.bincount(gu.rows, weights=gu.weights, minlength=g.n)
    ax = np.bincount(gu.rows, weights=x[gu.indices], minlength=g.n)
    ax_abs = np.bincount(gu.rows, weights=np.abs(x)[gu.indices],
                         minlength=g.n)
    _close(L.apply(torch.from_numpy(x)), deg * x - ax,
           deg * np.abs(x) + ax_abs)
    assert np.array_equal(L.diag.numpy(), deg.astype(np.float32))


def test_apply_is_deterministic_and_ordered():
    """The ordered segment sum equals a sequential scatter-add bit for bit
    (the order `index_add_` adds in on the CPU) and repeats exactly."""
    vg = mesh_t.pebble_mesh(6, 6, 6, n_pebbles=2, seed=3).vert_gid
    h = gs_t.gs_setup(vg, device="cpu")
    u = torch.from_numpy(
        np.random.default_rng(4).normal(size=vg.shape).astype(np.float32))
    seq = torch.zeros(h.n_global).index_add_(0, h.take, u.reshape(-1))
    got = gs_t.gs_apply(h, u)
    assert torch.equal(got, seq[h.take].reshape(u.shape))
    assert torch.equal(got, gs_t.gs_apply(h, u))
