"""repro_torch host substrate vs repro: meshes, dual graphs, CSR/ELL
utilities and the geometric orders.

All of it is host NumPy in both packages, copied line for line, so the
gate is bit-identical arrays (``np.array_equal``), no tolerance.
"""

import numpy as np
import pytest

import repro.core.rcb as rcb_j
import repro.core.sfc as sfc_j
import repro.mesh as mesh_j
import repro_torch.convert as convert
import repro_torch.core.rcb as rcb_t
import repro_torch.core.sfc as sfc_t
import repro_torch.mesh as mesh_t

MESHES = {
    "box444": lambda m: m.box_mesh(4, 4, 4),
    "box534": lambda m: m.box_mesh(5, 3, 4, lengths=(2.0, 1.0, 0.5)),
    "quality": lambda m: m.pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15,
                                       seed=1),
}


@pytest.fixture(scope="module", params=sorted(MESHES))
def meshes(request):
    make = MESHES[request.param]
    return make(mesh_j), make(mesh_t)


def _same_graph(gj, gt):
    assert gj.n == gt.n
    for name in ("indptr", "indices", "weights", "rows"):
        a, b = getattr(gj, name), getattr(gt, name)
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


def test_mesh_arrays_identical(meshes):
    mj, mt = meshes
    for name in ("vert_gid", "edge_gid", "face_gid", "coords", "weights"):
        a, b = getattr(mj, name), getattr(mt, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (mj.n_vert, mj.n_edge, mj.n_face) == (mt.n_vert, mt.n_edge, mt.n_face)


def test_dual_graph_identical(meshes):
    mj, mt = meshes
    _same_graph(mesh_j.dual_graph(mj), mesh_t.dual_graph(mt))


def test_extract_subgraphs_on_rcb_split_identical(meshes):
    mj, mt = meshes
    gj, gt = mesh_j.dual_graph(mj), mesh_t.dual_graph(mt)
    halves = rcb_j.rcb_parts(mj.coords, 2, mj.weights)
    groups = [np.flatnonzero(halves == 0), np.flatnonzero(halves == 1)]
    for sj, st in zip(mesh_j.extract_subgraphs(gj, groups),
                      mesh_t.extract_subgraphs(gt, groups)):
        _same_graph(sj, st)
    perm = rcb_j.rcb_order(mj.coords, mj.weights)
    _same_graph(gj.sub(perm), gt.sub(perm))


def test_csr_to_ell_and_connected_labels_identical(meshes):
    mj, mt = meshes
    gj, gt = mesh_j.dual_graph(mj), mesh_t.dual_graph(mt)
    for max_row in (None, 32):
        cj, vj = mesh_j.csr_to_ell(gj, max_row=max_row)
        ct, vt = mesh_t.csr_to_ell(gt, max_row=max_row)
        assert np.array_equal(cj, ct) and np.array_equal(vj, vt)
    parts = rcb_j.rcb_parts(mj.coords, 8, mj.weights)
    intra = parts[gj.rows] == parts[gj.indices]
    src, dst = gj.rows[intra], gj.indices[intra]
    assert np.array_equal(mesh_j.connected_labels(gj.n, src, dst),
                          mesh_t.connected_labels(gt.n, src, dst))
    assert np.array_equal(mesh_j.connected_components(gj),
                          mesh_t.connected_components(gt))


def test_geometric_orders_identical(meshes):
    mj, _ = meshes
    c, w = mj.coords, mj.weights
    assert np.array_equal(rcb_j.rcb_order(c, w), rcb_t.rcb_order(c, w))
    assert np.array_equal(rcb_j.rib_order(c, w), rcb_t.rib_order(c, w))
    for k in (2, 5, 16):
        assert np.array_equal(rcb_j.rcb_parts(c, k, w), rcb_t.rcb_parts(c, k, w))
        assert np.array_equal(rcb_j.rib_parts(c, k, w), rcb_t.rib_parts(c, k, w))
    for curve in ("hilbert", "morton"):
        assert np.array_equal(sfc_j.sfc_order(c, curve=curve),
                              sfc_t.sfc_order(c, curve=curve))
        assert np.array_equal(sfc_j.sfc_parts(c, 7, w, curve=curve),
                              sfc_t.sfc_parts(c, 7, w, curve=curve))


@pytest.mark.parametrize("dims", [(7, 9), (3, 4, 5)])
def test_grid_generators_identical(dims):
    name = f"grid_graph_{len(dims)}d"
    _same_graph(getattr(mesh_j, name)(*dims), getattr(mesh_t, name)(*dims))


def test_convert_round_trips(meshes):
    """`convert` rebuilds the port's objects from `repro`'s arrays."""
    mj, mt = meshes
    m2 = convert.mesh_from_arrays(mj.vert_gid, mj.coords, mj.weights, mj.n_vert)
    for name in ("vert_gid", "edge_gid", "face_gid", "coords", "weights"):
        assert np.array_equal(getattr(m2, name), getattr(mt, name)), name
    gj = mesh_j.dual_graph(mj)
    _same_graph(convert.graph_from_arrays(gj.indptr, gj.indices, gj.weights,
                                          gj.n), mesh_t.dual_graph(mt))
