"""The recursive RSB engines and the matrix-free mesh solves vs repro.

`fiedler_from_mesh` and `fiedler_from_mesh_batched` solve on the
gather-scatter Laplacian in both packages; the fp32 arithmetic differs
(the solvers' reductions), so each solve is held to `repro`'s by its
eigenvalue (within ``rel=TOL``, the solve tolerance) and its vector
(|cos| ≥ 0.999).  The engines split by sorting those vectors, and on
these meshes the splits agree exactly: `rsb_partition_mesh` and
`rsb_partition_graph` with ``engine="recursive"``, guarded and not, give
`repro`'s labels bit for bit, and so do the ``reference`` preset on the
quality mesh (cut 8918, BENCH_partition.json's ``rsb_weighted_recursive``
row) and a ``solver_nan`` chaos run through the recursive engine, whose
`GuardReport` equals `repro`'s.
"""

import numpy as np
import pytest
import torch

import repro.configs.parrsb as cfg_j
import repro.core.fiedler as fd_j
import repro.core.pipeline as pipe_j
import repro.core.rsb as rsb_j
import repro.guard as guard_j
import repro.mesh as mesh_j
import repro_torch.configs.parrsb as cfg_t
import repro_torch.core.fiedler as fd_t
import repro_torch.core.pipeline as pipe_t
import repro_torch.core.rsb as rsb_t
import repro_torch.guard as guard_t
import repro_torch.mesh as mesh_t
from repro_torch.core.rcb import rcb_order
from repro_torch.core.refine import edge_cut

TOL = 1e-3            # solve tolerance, and the eigenvalue's rel. bound
QUALITY_CUT = 8918.0  # BENCH_partition.json: quality mesh, 16 parts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))


MESHES = {   # ~500-element pebble mesh and a small box
    "pebble": lambda m: m.pebble_mesh(8, 8, 8, n_pebbles=3, seed=0),
    "box": lambda m: m.box_mesh(8, 6, 5),
}


@pytest.fixture(scope="module")
def meshes():
    return {k: (b(mesh_j), b(mesh_t)) for k, b in MESHES.items()}


def _ordered(mt):
    """The mesh's vertex-id table in RCB order (what the engine solves at
    the root) and its assembled dual graph."""
    vg = mt.vert_gid[rcb_order(mt.coords, mt.weights)]
    return vg, fd_t._graph_from_vert_gid(vg)


def _same_solve(a, b):
    assert a.method == b.method
    assert b.eigenvalue == pytest.approx(a.eigenvalue, rel=TOL)
    assert _cos(a.vector, b.vector) >= 0.999
    assert a.levels == b.levels


@pytest.mark.parametrize("method", ["lanczos", "inverse"])
def test_fiedler_from_mesh_matches(meshes, method):
    vg, g = _ordered(meshes["pebble"][1])
    kw = {}
    if method == "inverse":
        kw = dict(graph_for_amg=g, order=np.arange(g.n))
    a = fd_j.fiedler_from_mesh(vg, method=method, seed=3, tol=TOL, **kw)
    b = fd_t.fiedler_from_mesh(vg, method=method, seed=3, tol=TOL,
                               device="cpu", **kw)
    _same_solve(a, b)
    # the matrix-free solve and the assembled one find the same pair
    c = fd_t.fiedler_from_graph(g, method=method, seed=3, tol=TOL,
                                device="cpu")
    assert c.eigenvalue == pytest.approx(b.eigenvalue, rel=TOL)
    assert _cos(b.vector, c.vector) >= 0.999


@pytest.mark.parametrize("method,precond", [("lanczos", "jacobi"),
                                            ("inverse", "jacobi"),
                                            ("inverse", "amg")])
def test_fiedler_from_mesh_batched_matches(meshes, method, precond):
    vg, _ = _ordered(meshes["pebble"][1])
    n = vg.shape[0]
    # three sub-meshes: the two RCB halves and a dense-tail piece
    vgs = [vg[: n // 2], vg[n // 2:], vg[:150]]
    kw = dict(method=method, precond=precond, seeds=[1, 2, 3], tol=TOL)
    got_j = fd_j.fiedler_from_mesh_batched(vgs, **kw)
    got_t = fd_t.fiedler_from_mesh_batched(vgs, device="cpu", **kw)
    for a, b in zip(got_j, got_t):
        _same_solve(a, b)
    assert got_t[2].method == "dense"
    # a batch of one is the unbatched solve
    one = fd_t.fiedler_from_mesh_batched(vgs[:1], method="lanczos",
                                         seeds=[5], tol=TOL, device="cpu")[0]
    ref = fd_t.fiedler_from_mesh(vgs[0], seed=5, tol=TOL, device="cpu")
    assert one.eigenvalue == pytest.approx(ref.eigenvalue, rel=TOL)
    assert _cos(one.vector, ref.vector) >= 0.999


ENGINE_RUNS = [("pebble", "lanczos"), ("box", "lanczos"), ("box", "inverse")]


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("name,method", ENGINE_RUNS)
def test_recursive_engines_match_repro(meshes, name, method, guard):
    mj, mt = meshes[name]
    gkw_j = dict(guard=guard_j.GuardPolicy()) if guard else {}
    gkw_t = dict(guard=guard_t.GuardPolicy()) if guard else {}
    a, ra = rsb_j.rsb_partition_mesh(mj, 8, method=method,
                                     engine="recursive", **gkw_j)
    b, rb = rsb_t.rsb_partition_mesh(mt, 8, method=method,
                                     engine="recursive", device="cpu", **gkw_t)
    assert np.array_equal(a, b)
    assert rb.engine == "recursive" and rb.precond == ra.precond
    assert [(r.level, r.size, r.nparts, r.method) for r in rb.records] == \
        [(r.level, r.size, r.nparts, r.method) for r in ra.records]
    assert [lv.n_nodes for lv in rb.levels] == [lv.n_nodes for lv in ra.levels]
    assert (rb.guard is not None) == guard
    if guard:
        assert rb.guard.to_dict() == ra.guard.to_dict() and rb.guard.clean
    gj, gt = mesh_j.dual_graph(mj), mesh_t.dual_graph(mt)
    a, _ = rsb_j.rsb_partition_graph(
        gj, 8, coords=np.asarray(mj.coords), weights=np.asarray(mj.weights),
        method=method, engine="recursive", **gkw_j)
    b, _ = rsb_t.rsb_partition_graph(
        gt, 8, coords=mt.coords, weights=mt.weights, method=method,
        engine="recursive", device="cpu", **gkw_t)
    assert np.array_equal(a, b)


def test_reference_preset_matches_repro():
    mj = mesh_j.pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1)
    mt = mesh_t.pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1)
    cj = cfg_j.make_pipeline("reference").run(mj, 16)
    ct = cfg_t.make_pipeline("reference", device="cpu").run(mt, 16)
    assert np.array_equal(ct.parts, cj.parts)
    assert np.array_equal(ct.parts_raw, cj.parts_raw)
    assert edge_cut(ct.require_graph(), ct.parts) == QUALITY_CUT
    assert ct.report.engine == "recursive" and ct.report.guard.clean
    assert ct.config["bisect"] == "rsb-recursive"
    # engine="recursive" through the front door is the same pipeline
    assert np.array_equal(
        pipe_t.partition(mt, 16, engine="recursive", device="cpu"), ct.parts)


def test_solver_nan_through_recursive_engine(meshes):
    mj, mt = meshes["pebble"]
    kw = dict(pre="rcb", bisect="rsb-recursive", post=("repair", "refine"),
              guard=True, guard_kw={"chaos": ("solver_nan",)})
    cj = pipe_j.PartitionPipeline(**kw).run(mj, 8)
    ct = pipe_t.PartitionPipeline(device="cpu", **kw).run(mt, 8)
    assert ct.report.guard.to_dict() == cj.report.guard.to_dict()
    assert ct.report.guard.fallbacks > 0
    assert np.array_equal(ct.parts, cj.parts)
    assert guard_t.count_disconnected(ct.require_graph(), ct.parts, 8) == 0
    assert not guard_t.chaos.active()


def test_laplacian_validated_and_engine_checked(meshes):
    mt = meshes["box"][1]
    with pytest.raises(ValueError):
        rsb_t.rsb_partition_mesh(mt, 4, laplacian="nope", engine="recursive",
                                 device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        rsb_t.rsb_partition_mesh(mt, 4, engine="nope", device="cpu")
    a, _ = rsb_t.rsb_partition_mesh(mt, 4, laplacian="unweighted",
                                    engine="recursive", device="cpu")
    b, _ = rsb_t.rsb_partition_mesh(mt, 4, engine="recursive", device="cpu")
    assert np.array_equal(a, b)    # validated only, as in repro
