"""repro_torch.core.multilevel (the V-cycle bisect stage) vs repro.

The V-cycle is host NumPy in both packages — heavy-edge matching,
Galerkin coarsening, the coarsest solve (dense ``eigh`` or BFS growth),
balance restoration and boundary FM — so labels and `MultilevelStats`
must be identical (seconds aside), and so must the ``multilevel`` and
``multilevel-quality`` presets through `make_pipeline`, guarded and not.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.configs.parrsb as cfg_j
import repro.core.amg as amg_j
import repro.core.multilevel as ml_j
import repro.core.pipeline as pipe_j
import repro.mesh as mesh_j
import repro_torch.configs.parrsb as cfg_t
import repro_torch.core.amg as amg_t
import repro_torch.core.multilevel as ml_t
import repro_torch.core.pipeline as pipe_t
import repro_torch.mesh as mesh_t
from repro_torch.core.refine import edge_cut

QUALITY_CUT = 8916.0   # BENCH_partition.json: quality mesh, multilevel, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


GRAPHS = {   # name: (make(mesh module) -> (graph, node weights), nparts)
    "box": (lambda m: (m.dual_graph(m.box_mesh(10, 8, 6)), None), 8),
    "pebble": (lambda m: (lambda pm: (m.dual_graph(pm), pm.weights))(
        m.pebble_mesh(8, 8, 8, n_pebbles=3, seed=0)), 6),
    "grid": (lambda m: (m.grid_graph_2d(30, 24), None), 5),
    "grid-large": (lambda m: (m.grid_graph_2d(60, 40), None), 4),
}


@pytest.fixture(scope="module")
def graphs():
    return {k: (b(mesh_j), b(mesh_t), k_) for k, (b, k_) in GRAPHS.items()}


def _stats(st) -> dict:
    """MultilevelStats without its wall seconds."""
    d = dataclasses.asdict(st)
    for key in ("coarsen_seconds", "coarsest_seconds", "refine_seconds"):
        d.pop(key)
    for r in d["records"]:
        r.pop("coarsen_seconds")
        r.pop("refine_seconds")
    return d


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("seed,capped,rounds", [(0, False, 4), (3, True, 8)])
def test_heavy_edge_matching_bit_identical(graphs, name, seed, capped,
                                           rounds):
    (gj, wj), (gt, wt), _ = graphs[name]
    w = np.ones(gt.n) if wt is None else np.asarray(wt, np.float64)
    kw = dict(node_weights=w, max_weight=2.0 * w.mean()) if capped else {}
    aj, nj = amg_j.heavy_edge_matching(gj, seed=seed, rounds=rounds, **kw)
    at, nt = amg_t.heavy_edge_matching(gt, seed=seed, rounds=rounds, **kw)
    assert nj == nt and np.array_equal(aj, at) and at.dtype == aj.dtype
    assert np.bincount(at).max() <= 2 and nt < gt.n


ML_CASES = {   # name: (graph, keywords)
    "box": ("box", {}),
    "pebble": ("pebble", {}),
    "grid": ("grid", {}),
    "pebble-greedy": ("pebble", dict(coarse_solver="greedy")),
    "grid-quality": ("grid", dict(coarse_factor=16, refine_passes=4,
                                  stall=128, balance_tol=0.03)),
    # one ladder level leaves ~1,200 of 2,400 nodes > _DENSE_SPECTRAL_MAX:
    # "spectral" falls back to greedy growth on the coarsest graph
    "grid-over-dense-max": ("grid-large", dict(coarse_factor=256,
                                               max_levels=1)),
    "box-seed": ("box", dict(seed=5, max_levels=2)),
}


@pytest.mark.parametrize("case", sorted(ML_CASES))
def test_multilevel_partition_bit_identical(graphs, case):
    name, kw = ML_CASES[case]
    (gj, wj), (gt, wt), k = graphs[name]
    pj, rj = ml_j.multilevel_partition(gj, k, weights=wj, **kw)
    pt, rt = ml_t.multilevel_partition(gt, k, weights=wt, **kw)
    assert np.array_equal(pj, pt)
    assert _stats(rj.ml) == _stats(rt.ml)
    assert rt.engine == "multilevel" and rt.multilevel
    assert [r.iterations for r in rt.records] == \
        [r.iterations for r in rj.records]
    solver = rt.ml.coarse_solver
    if case == "grid-over-dense-max":
        assert rt.ml.n_coarsest > ml_t._DENSE_SPECTRAL_MAX
        assert solver == "greedy"
    elif case != "pebble-greedy":
        assert rt.ml.n_coarsest <= ml_t._DENSE_SPECTRAL_MAX
        assert solver == "spectral"
    assert sorted(np.unique(pt)) == list(range(k))


def test_multilevel_degenerate_ladder_and_validation():
    gj, gt = mesh_j.grid_graph_2d(6, 6), mesh_t.grid_graph_2d(6, 6)
    pj, rj = ml_j.multilevel_partition(gj, 4)
    pt, rt = ml_t.multilevel_partition(gt, 4)
    assert np.array_equal(pj, pt) and rt.ml.levels == 0
    assert _stats(rj.ml) == _stats(rt.ml)
    for args, kw in (((0,), {}), ((37,), {}),
                     ((2,), dict(coarse_solver="nope"))):
        with pytest.raises(ValueError):
            ml_t.multilevel_partition(gt, *args, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_helpers_bit_identical(graphs, seed):
    """`_rebalance`, `_bfs_order`, `_greedy_grow_parts` and
    `_dense_spectral_parts` on the same inputs."""
    (gj, wj), (gt, wt), k = graphs["pebble"]
    w = np.asarray(wt, np.float64)
    rng = np.random.default_rng(seed)
    parts = rng.integers(0, k, gt.n)
    mean = w.sum() / k
    corridor = (0.95 * mean, 1.05 * mean)
    bj, bt = parts.copy(), parts.copy()
    mj = ml_j._rebalance(gj, bj, k, w, corridor)
    mt = ml_t._rebalance(gt, bt, k, w, corridor)
    assert mj == mt and np.array_equal(bj, bt)
    assert np.array_equal(ml_j._bfs_order(gj), ml_t._bfs_order(gt))
    assert np.array_equal(ml_j._greedy_grow_parts(gj, w, k),
                          ml_t._greedy_grow_parts(gt, w, k))
    sub = rng.permutation(gt.n)[:150]
    assert np.array_equal(ml_j._dense_spectral_parts(gj.sub(sub), w[sub], 4),
                          ml_t._dense_spectral_parts(gt.sub(sub), w[sub], 4))


@pytest.fixture(scope="module")
def quality():
    return (mesh_j.pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1),
            mesh_t.pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1))


@pytest.mark.parametrize("preset", ["multilevel", "multilevel-quality"])
@pytest.mark.parametrize("guard", [None, False])
def test_presets_bit_identical(quality, preset, guard):
    mj, mt = quality
    pj = cfg_j.make_pipeline(preset, guard=guard)
    pt = cfg_t.make_pipeline(preset, guard=guard, device="cpu")
    assert pt.bisect_kw == pj.bisect_kw and pt.post_kw == pj.post_kw
    assert (pt.pre, pt.bisect, pt.post) == (pj.pre, pj.bisect, pj.post)
    cj, ct = pj.run(mj, 16), pt.run(mt, 16)
    assert np.array_equal(cj.parts, ct.parts)
    assert np.array_equal(cj.parts_raw, ct.parts_raw)
    assert _stats(cj.report.ml) == _stats(ct.report.ml)
    assert ct.config["guard"] == (guard is None)
    if guard is None:
        assert ct.report.guard.to_dict() == cj.report.guard.to_dict()
        assert ct.report.guard.clean
    if preset == "multilevel":
        assert edge_cut(ct.require_graph(), ct.parts) == QUALITY_CUT


def test_preset_bisect_kw_from_config():
    cfg = dataclasses.replace(cfg_t.make_config(), coarse_factor=4,
                              ml_refine_passes=3, ml_stall=7,
                              balance_tol=0.08)
    cfg_jx = dataclasses.replace(cfg_j.make_config(), coarse_factor=4,
                                 ml_refine_passes=3, ml_stall=7,
                                 balance_tol=0.08)
    for preset in ("multilevel", "multilevel-quality", "default"):
        pt = cfg_t.make_pipeline(preset, config=cfg,
                                 bisect_kw=dict(seed=2))
        pj = cfg_j.make_pipeline(preset, config=cfg_jx,
                                 bisect_kw=dict(seed=2))
        assert pt.bisect_kw == pj.bisect_kw
    assert cfg_t.make_pipeline("multilevel", config=cfg).bisect_kw == dict(
        coarse_factor=4, refine_passes=3, stall=7, balance_tol=0.08)


def test_front_door_partition(graphs):
    (gj, _), (gt, _), _ = graphs["box"]
    for kw in ({}, dict(coarse_factor=4, refine="repair", seed=1)):
        want = pipe_j.partition(gj, 8, partitioner="multilevel", **kw)
        got = pipe_t.partition(gt, 8, partitioner="multilevel", device="cpu",
                               **kw)
        assert np.array_equal(got, want)
    with pytest.raises(TypeError, match="unknown keyword"):
        pipe_t.partition(gt, 8, partitioner="multilevel", tol=1e-3,
                         device="cpu")
    ctx = pipe_t.PartitionPipeline(pre="none", bisect="multilevel",
                                   post=(), device="cpu").run(gt, 8)
    assert ctx.report.engine == "multilevel"
    assert ctx.report.ml.levels == len(ctx.report.levels) > 0
    assert "multilevel" in pipe_t.bisect_stage_names()
