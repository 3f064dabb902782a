"""repro_torch post stages, metrics and the pipeline front door vs repro.

* Post stages and metrics are host NumPy in both packages: given the same
  labels they must agree bit for bit (``==`` / ``np.array_equal``).
* End to end on the quality mesh (`benchmarks/quality.py`'s
  ``pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1)``, 16 parts),
  the spectral presets are held to the cut of repro's ``guard=False`` run
  on the same machine within 2% — the fp32 solves may differ in the last
  bits, and a flipped eigenvector sign relabels parts without changing the
  cut, so raw labels are not compared — plus 0 disconnected parts and the
  post chain's balance corridor.  The ``geometric`` preset is pure NumPy:
  labels identical.
"""

import numpy as np
import pytest
import torch

import repro.configs.parrsb as cfg_j
import repro.core.metrics as met_j
import repro.core.pipeline as pipe_j
import repro.core.rcb as rcb_j
import repro.core.refine as ref_j
import repro.mesh as mesh_j
import repro_torch.configs.parrsb as cfg_t
import repro_torch.core.metrics as met_t
import repro_torch.core.refine as ref_t
import repro_torch.mesh as mesh_t
from repro_torch.core.pipeline import PartitionPipeline, partition
from repro_torch.core.rsb import rsb_partition_mesh

NPARTS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solves here are many small eager ops: one intra-op thread per
    test worker keeps the parallel workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _quality(m):
    return m.pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1)


@pytest.fixture(scope="module")
def quality():
    mj, mt = _quality(mesh_j), _quality(mesh_t)
    return mj, mt, mesh_j.dual_graph(mj), mesh_t.dual_graph(mt)


@pytest.fixture(scope="module")
def noisy_labels(quality):
    """RCB labels with 3% of the elements moved to random parts: fragments
    for repair and boundary moves for refine."""
    mj = quality[0]
    rng = np.random.default_rng(4)
    parts = rcb_j.rcb_parts(mj.coords, NPARTS, mj.weights)
    pick = rng.choice(parts.size, parts.size // 33, replace=False)
    parts[pick] = rng.integers(0, NPARTS, pick.size)
    return parts


def _same_stats(a, b):
    assert a.row() == b.row()


def test_post_stages_bit_identical(quality, noisy_labels):
    mj, _, gj, gt = quality
    w = mj.weights
    cj = ref_j.balance_corridor(noisy_labels, NPARTS, w, 0.05)
    assert ref_t.balance_corridor(noisy_labels, NPARTS, w, 0.05) == cj
    assert ref_t.edge_cut(gt, noisy_labels) == ref_j.edge_cut(gj, noisy_labels)
    pj, sj = ref_j.repair_components(gj, noisy_labels, NPARTS, weights=w,
                                     corridor=cj)
    pt, st = ref_t.repair_components(gt, noisy_labels, NPARTS, weights=w,
                                     corridor=cj)
    assert np.array_equal(pj, pt) and st.fragments_repaired > 0
    for s in (sj, st):
        s.seconds = 0.0
    _same_stats(sj, st)
    qj, sj = ref_j.refine_stage(gj, pj, NPARTS, weights=w, corridor=cj)
    qt, st = ref_t.refine_stage(gt, pt, NPARTS, weights=w, corridor=cj)
    assert np.array_equal(qj, qt) and st.moves_applied > 0
    for s in (sj, st):
        s.seconds = 0.0
    _same_stats(sj, st)


def test_metrics_bit_identical(quality, noisy_labels):
    _, _, gj, gt = quality
    a = met_j.partition_metrics(gj, noisy_labels, NPARTS)
    b = met_t.partition_metrics(gt, noisy_labels, NPARTS)
    assert a.row() == b.row() and b.disconnected_parts > 0
    assert met_t.comm_time_model(b) == met_j.comm_time_model(a)


@pytest.fixture(scope="module")
def runs(quality):
    """One JAX (guard=False) and one port run per preset, shared by tests."""
    mj, mt, _, _ = quality
    out = {}
    for preset in ("default", "raw", "geometric"):
        cj = cfg_j.make_pipeline(preset, guard=False).run(mj, NPARTS)
        ct = cfg_t.make_pipeline(preset, device="cpu").run(mt, NPARTS)
        out[preset] = cj, ct
    return out


@pytest.mark.parametrize("preset", ["default", "raw"])
def test_spectral_presets_match_cut(quality, runs, preset):
    mj, _, _, gt = quality
    cj, ct = runs[preset]
    mj_ = met_t.partition_metrics(gt, cj.parts, NPARTS, weights=mj.weights)
    mt_ = met_t.partition_metrics(gt, ct.parts, NPARTS, weights=mj.weights)
    assert mt_.edge_cut <= 1.02 * mj_.edge_cut
    assert mt_.edge_cut >= 0.98 * mj_.edge_cut
    assert mt_.disconnected_parts == 0
    assert set(np.unique(ct.parts)) == set(range(NPARTS))
    floor, cap = ref_t.balance_corridor(ct.parts_raw, NPARTS, mj.weights, 0.05)
    pw = np.bincount(ct.parts, weights=mj.weights, minlength=NPARTS)
    assert pw.min() >= floor and pw.max() <= cap
    assert ct.report.total_iterations == pytest.approx(
        cj.report.total_iterations, abs=len(ct.report.levels))
    # guarded by default: the dual graph is assembled by guard:validate
    assert [s.kind for s in ct.stages][:4] == ["setup", "guard", "pre",
                                               "bisect"]
    assert ct.stages[3].info["device_seconds"] > 0.0


def test_geometric_preset_identical(runs):
    cj, ct = runs["geometric"]
    assert np.array_equal(cj.parts, ct.parts)
    assert np.array_equal(cj.parts_raw, ct.parts_raw)


def test_mesh_engine_delegates_to_dual_graph(quality, runs):
    """`rsb_partition_mesh` runs the graph engine on the assembled dual
    graph: the `raw` preset's labels, with K1 routing on by default."""
    parts, report = rsb_partition_mesh(quality[1], NPARTS, device="cpu")
    assert np.array_equal(parts, runs["raw"][1].parts_raw)
    assert report.engine == "batched" and len(report.levels) == 4
    assert report.device_seconds > 0.0


def test_front_door_and_sfc_pre(quality, runs):
    mj, mt, _, gt = quality
    labels = partition(mt, NPARTS, device="cpu")
    assert np.array_equal(labels, runs["default"][1].parts)
    pj = cfg_j.make_pipeline("default", pre="sfc", guard=False).run(mj, NPARTS)
    pt = PartitionPipeline(pre="sfc", device="cpu").run(mt, NPARTS)
    cut_j = met_t.partition_metrics(gt, pj.parts, NPARTS).edge_cut
    cut_t = met_t.partition_metrics(gt, pt.parts, NPARTS).edge_cut
    assert abs(cut_t - cut_j) <= 0.02 * cut_j
    assert np.array_equal(
        partition(mt, NPARTS, partitioner="sfc", device="cpu"),
        pipe_j.partition(mj, NPARTS, partitioner="sfc", guard=False))


def test_unported_and_device_contract(quality, monkeypatch):
    mt = quality[1]
    # the recursive engine and its preset are ported (labels held to
    # repro's in tests/test_torch_recursive.py)
    assert cfg_t.make_pipeline("reference", device="cpu").bisect == \
        "rsb-recursive"
    labels = partition(mt, NPARTS, engine="recursive", device="cpu")
    assert sorted(np.unique(labels)) == list(range(NPARTS))
    with pytest.raises(ValueError, match="unknown pipeline preset"):
        cfg_t.make_pipeline("nope")
    with pytest.raises(ValueError, match="unknown bisect stage"):
        PartitionPipeline(bisect="nope")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        partition(mt, NPARTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg_t.make_pipeline("geometric").run(mt, NPARTS)


@pytest.mark.parametrize("partitioner", ["rsb", "rcb"])
def test_rsb_front_door_gives_repros_labels(quality, partitioner):
    """`repro_torch.core.rsb.partition`, the compatibility front door,
    gives `repro.core.rsb.partition`'s labels on the quality mesh."""
    import repro.core.rsb as rsb_j
    import repro_torch.core.rsb as rsb_t

    mj, mt, _, _ = quality
    want = rsb_j.partition(mj, NPARTS, partitioner=partitioner, guard=False)
    got = rsb_t.partition(mt, NPARTS, partitioner=partitioner, guard=False,
                          device="cpu")
    np.testing.assert_array_equal(got, want)
