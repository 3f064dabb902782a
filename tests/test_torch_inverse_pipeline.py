"""``partition(..., partitioner="rsb_inverse")`` in repro_torch vs repro (CPU).

``pebble_mesh(10, 10, 10, n_pebbles=6, seed=0)`` (959 elements) into 8
parts, RCB pre-ordering, inverse iteration with the Jacobi (default) and
the AMG preconditioner, the default repair + refine post chain.  repro runs
``guard=False`` through its pipeline once per preconditioner (shared by a
module fixture).  Held to: raw and refined cuts within 2% of repro's (the
fp32 solves may differ in the last bits; a flipped eigenvector sign
relabels parts without changing the cut), 0 disconnected parts, the post
chain's balance corridor, and the same ``report.precond``.
"""

import numpy as np
import pytest
import torch

import repro.core.pipeline as pipe_j
import repro.mesh as mesh_j
import repro_torch.mesh as mesh_t
from repro_torch.core.metrics import partition_metrics
from repro_torch.core.pipeline import PartitionPipeline, partition
from repro_torch.core.refine import balance_corridor
from repro_torch.core.rsb import rsb_partition_graph

NPARTS = 8
PRECONDS = ("jacobi", "amg")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solves here are many small eager ops: one intra-op thread per
    test worker keeps the parallel workers from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pebble(m):
    return m.pebble_mesh(10, 10, 10, n_pebbles=6, seed=0)


@pytest.fixture(scope="module")
def runs():
    """{precond: (repro context, port context)} — one pipeline run each,
    bisect_kw as in benchmarks/partition_time.py."""
    mj, mt = _pebble(mesh_j), _pebble(mesh_t)
    out = {}
    for pc in PRECONDS:
        kw = dict(method="inverse", precond=pc)
        cj = pipe_j.PartitionPipeline(pre="rcb", bisect_kw=kw,
                                      guard=False).run(mj, NPARTS)
        ct = PartitionPipeline(pre="rcb", bisect_kw=kw, device="cpu").run(
            mt, NPARTS)
        out[pc] = cj, ct
    return mt, out


@pytest.mark.parametrize("precond", PRECONDS)
def test_inverse_pipeline_matches_repro(runs, precond):
    mt, out = runs
    cj, ct = out[precond]
    g = ct.require_graph()
    for attr in ("parts_raw", "parts"):
        cut_j = partition_metrics(g, getattr(cj, attr), NPARTS).edge_cut
        cut_t = partition_metrics(g, getattr(ct, attr), NPARTS).edge_cut
        assert abs(cut_t - cut_j) <= 0.02 * cut_j, (attr, cut_t, cut_j)
    pm = partition_metrics(g, ct.parts, NPARTS, weights=mt.weights)
    assert pm.disconnected_parts == 0
    assert set(np.unique(ct.parts)) == set(range(NPARTS))
    floor, cap = balance_corridor(ct.parts_raw, NPARTS, mt.weights, 0.05)
    pw = np.bincount(ct.parts, weights=mt.weights, minlength=NPARTS)
    assert pw.min() >= floor and pw.max() <= cap
    assert ct.report.precond == cj.report.precond == precond
    solved = [r for r in ct.report.records if r.method != "dense"]
    assert solved and all(r.method == "inverse" for r in solved)
    assert ct.report.total_iterations == pytest.approx(
        cj.report.total_iterations, abs=len(ct.report.levels))
    assert all(lv.inner_iterations > 0 for lv in ct.report.levels)
    # guarded by default: setup, guard:validate, pre, then the bisect stage
    assert [s.kind for s in ct.stages][:4] == ["setup", "guard", "pre",
                                               "bisect"]
    assert ct.stages[3].info["device_seconds"] > 0.0


@pytest.mark.parametrize("precond", PRECONDS)
def test_front_door_rsb_inverse(runs, precond):
    """``partitioner="rsb_inverse"`` is the pipeline with
    ``method="inverse"``: the same labels as the pipeline run above."""
    mt, out = runs
    kw = {} if precond == "jacobi" else dict(precond="amg")
    labels = partition(mt, NPARTS, partitioner="rsb_inverse", device="cpu", **kw)
    assert np.array_equal(labels, out[precond][1].parts)


def test_engine_reports_precond_only_for_inverse(runs):
    mt, out = runs
    g = out["amg"][1].require_graph()
    _, rep = rsb_partition_graph(g, 2, coords=mt.coords, weights=mt.weights,
                                 precond="amg", device="cpu")
    assert rep.precond == "none"       # Lanczos: no preconditioner used


def test_still_not_ported():
    """The recursive engine is ported: both methods run through the front
    door (Lanczos on the gather-scatter operator, inverse iteration with
    the per-node AMG) and keep the invariants."""
    mt = _pebble(mesh_t)
    for kw in (dict(engine="recursive"),
               dict(partitioner="rsb_inverse", precond="amg",
                    engine="recursive")):
        labels = partition(mt, NPARTS, device="cpu", **kw)
        g = mesh_t.dual_graph(mt)
        pm = partition_metrics(g, labels, NPARTS)
        assert pm.disconnected_parts == 0
        assert sorted(np.unique(labels)) == list(range(NPARTS))
    pipe = PartitionPipeline(bisect="rsb-recursive", bisect_kw=dict(
        method="inverse"), device="cpu")
    ctx = pipe.run(mt, NPARTS)
    assert ctx.report.engine == "recursive" and ctx.report.precond == "amg"
