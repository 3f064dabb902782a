"""repro_torch.core.kway (hill-climbing k-way FM) vs repro.core.kway.

The k-way refiner is host Python/NumPy in both packages: given the same
graph and labels, labels and `KwayStats` must agree exactly.  End to end,
the `kway`, `quality` and `quality-kway` presets are held to `repro`'s
``guard=False`` runs on a small pebble mesh: the Lanczos labels agree there
(as `tests/test_torch_pipeline.py` finds for the quality mesh), so the
refined labels must be identical; and `repro`'s post chain on the port's
raw labels must give the port's refined labels.
"""

import numpy as np
import pytest
import torch

import repro.configs.parrsb as cfg_j
import repro.core.kway as kway_j
import repro.core.rcb as rcb_j
import repro.mesh as mesh_j
import repro_torch.configs.parrsb as cfg_t
import repro_torch.core.kway as kway_t
import repro_torch.mesh as mesh_t
from repro_torch.core.refine import balance_corridor

NPARTS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _quality(m):
    return m.pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1)


@pytest.fixture(scope="module")
def quality():
    mj, mt = _quality(mesh_j), _quality(mesh_t)
    return mj, mesh_j.dual_graph(mj), mesh_t.dual_graph(mt)


@pytest.fixture(scope="module")
def noisy_labels(quality):
    """RCB labels with 3% of the elements moved to random parts."""
    mj = quality[0]
    rng = np.random.default_rng(4)
    parts = rcb_j.rcb_parts(mj.coords, NPARTS, mj.weights)
    pick = rng.choice(parts.size, parts.size // 33, replace=False)
    parts[pick] = rng.integers(0, NPARTS, pick.size)
    return parts


def _same(a, b):
    (pa, sa), (pb, sb) = a, b
    assert np.array_equal(pa, pb)
    ra, rb = sa.row(), sb.row()
    ra.pop("seconds"), rb.pop("seconds")
    assert ra == rb
    assert ra["kway"]["moves_kept"] == sa.moves_applied


@pytest.mark.parametrize("kw", [dict(passes=8), dict(passes=3, stall=16),
                                dict(passes=12, balance_tol=0.03)])
def test_kway_fm_identical(quality, noisy_labels, kw):
    mj, gj, gt = quality
    w = mj.weights
    a = kway_j.kway_fm(gj, noisy_labels, NPARTS, weights=w, **kw)
    b = kway_t.kway_fm(gt, noisy_labels, NPARTS, weights=w, **kw)
    _same(a, b)
    assert b[1].cut_after < b[1].cut_before
    assert b[1].kway.records[0].attempted >= b[1].kway.records[0].best_prefix


def test_kway_fm_restricted_and_boundary_identical(quality, noisy_labels):
    mj, gj, gt = quality
    w = mj.weights
    corr = balance_corridor(noisy_labels, NPARTS, w, 0.05)
    nodes = np.flatnonzero(noisy_labels % 3 == 0)
    _same(kway_j.kway_fm(gj, noisy_labels, NPARTS, weights=w, passes=2,
                         corridor=corr, nodes=nodes),
          kway_t.kway_fm(gt, noisy_labels, NPARTS, weights=w, passes=2,
                         corridor=corr, nodes=nodes))
    for passes in (1, 2, 4):
        _same(kway_j.kway_fm_boundary(gj, noisy_labels, NPARTS, weights=w,
                                      passes=passes, corridor=corr),
              kway_t.kway_fm_boundary(gt, noisy_labels, NPARTS, weights=w,
                                      passes=passes, corridor=corr))


def test_kway_stage_identical(quality, noisy_labels):
    mj, gj, gt = quality
    w = mj.weights
    a = kway_j.kway_stage(gj, noisy_labels, NPARTS, weights=w)
    b = kway_t.kway_stage(gt, noisy_labels, NPARTS, weights=w)
    _same(a, b)
    assert b[1].stages == ["kway"] and b[1].cut_after < b[1].cut_before
    assert kway_t.KwayStats.from_dict(b[1].kway.to_dict()).row() == \
        b[1].kway.row()


def test_presets_match_repro_config():
    for preset in ("kway", "quality", "quality-kway"):
        pj = cfg_j.make_pipeline(preset, guard=False)
        pt = cfg_t.make_pipeline(preset, device="cpu")
        assert (pt.pre, pt.bisect, pt.post, pt.post_kw, pt.bisect_kw) == \
            (pj.pre, pj.bisect, pj.post, pj.post_kw, pj.bisect_kw), preset


@pytest.mark.parametrize("preset", ["kway", "quality", "quality-kway"])
def test_kway_presets_identical(preset):
    """End to end on ``pebble_mesh(8, 8, 8, n_pebbles=3, seed=1)`` into 8
    parts the raw labels agree, so the refined ones must too.  (With
    ``seed=2`` the fp32 Fiedler solves of the two packages split one
    element differently at an equal raw cut; there the second half of this
    test still holds.)  And `repro`'s post chain run on the port's own raw
    labels returns the port's refined labels."""
    import repro.core.pipeline as pipe_j

    mj = mesh_j.pebble_mesh(8, 8, 8, n_pebbles=3, seed=1)
    mt = mesh_t.pebble_mesh(8, 8, 8, n_pebbles=3, seed=1)
    pj = cfg_j.make_pipeline(preset, guard=False)
    cj = pj.run(mj, 8)
    ct = cfg_t.make_pipeline(preset, device="cpu").run(mt, 8)
    assert np.array_equal(cj.parts_raw, ct.parts_raw)
    assert np.array_equal(cj.parts, ct.parts)
    assert ct.report.post.kway.row() == cj.report.post.kway.row()
    assert [s.name for s in ct.stages if s.kind == "post"] == ["repair", "kway"]
    again, _, _ = pipe_j.run_post_stages(cj.require_graph(), ct.parts_raw, 8,
                                         pj.post, weights=mj.weights,
                                         post_kw=pj.post_kw)
    assert np.array_equal(again, ct.parts)
