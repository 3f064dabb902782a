"""repro_torch.dist (halo plan, frontier plan, sharded sweeps) vs repro.dist.

* The halo and frontier plans are host NumPy in both packages: every array
  must be identical, dtype included.
* The sweep loop: the port's `run_sharded_sweeps` on the CPU (its
  connection tables from K4's plain slot loop, its admission pass on the
  host) must return `repro`'s labels, moves per sweep and tracked cut, as
  both `repro`'s device path and its NumPy mirror give them.  The meshes
  have integer weights, so every fp32 sum is exact and the paths agree
  bit for bit (`refine_sharded.py`'s module docstring).
* The stages: `refine-sharded` and `kway-sharded` post chains give
  `repro`'s labels and stats (`guard=False` on the JAX side).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.pipeline as pipe_j
import repro.dist.refine_sharded as rs_j
import repro.mesh as mesh_j
import repro_torch.core.pipeline as pipe_t
import repro_torch.dist.refine_sharded as rs_t
import repro_torch.mesh as mesh_t
from repro.core import balance_corridor
from repro.dist.partition_aware import plan_halo_sharding as plan_j
from repro_torch.convert import graph_from_arrays, halo_plan_from_arrays
from repro_torch.core.refine import edge_cut
from repro_torch.dist.partition_aware import plan_halo_sharding as plan_t

CASES = [((8, 8, 6), 8, 3), ((6, 6, 4), 4, 5), ((9, 8, 6), 12, 7)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _seeded_case(dims, nparts, seed, frac=0.12):
    """tests/test_refine_sharded.py's case: RCB labels with a seeded
    perturbation, the corridor widened to the perturbed state; the JAX
    dual graph and the port's (identical arrays)."""
    mesh = mesh_j.box_mesh(*dims)
    ctx = pipe_j.PartitionPipeline(bisect="rcb", post=(),
                                   guard=False).run(mesh, nparts)
    gj = ctx.require_graph()
    rng = np.random.default_rng(seed)
    parts = ctx.parts.copy()
    sel = rng.random(gj.n) < frac
    parts[sel] = rng.integers(0, nparts, sel.sum())
    corr = balance_corridor(parts, nparts, ctx.weights, 0.05)
    gt = mesh_t.dual_graph(mesh_t.box_mesh(*dims))
    return gj, gt, parts, ctx.weights, corr


def _assert_same_arrays(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        elif not dataclasses.is_dataclass(x):
            assert x == y, f.name


@pytest.mark.parametrize("dims,nparts,seed", CASES)
def test_plans_identical(dims, nparts, seed):
    gj, gt, parts, w, _ = _seeded_case(dims, nparts, seed)
    pj, pt = plan_j(gj, parts, nparts), plan_t(gt, parts, nparts)
    _assert_same_arrays(pj, pt)
    assert pt.stats() == pj.stats()
    fj = rs_j.build_frontier_plan(gj, parts, nparts, weights=w)
    ft = rs_t.build_frontier_plan(gt, parts, nparts, weights=w)
    _assert_same_arrays(fj, ft)
    _assert_same_arrays(fj.plan, ft.plan)
    assert ft.gather_row_words == fj.gather_row_words


@pytest.mark.parametrize("dims,nparts,seed", CASES)
def test_sweeps_match_repro(dims, nparts, seed):
    """Port device path (CPU) ≡ repro device path ≡ repro host mirror ≡
    port host mirror, on the identical plan handed over as arrays."""
    gj, _, parts, w, corr = _seeded_case(dims, nparts, seed)
    fj = rs_j.build_frontier_plan(gj, parts, nparts, weights=w)
    plan = halo_plan_from_arrays(**{f.name: getattr(fj.plan, f.name)
                                    for f in dataclasses.fields(fj.plan)})
    gt = graph_from_arrays(gj.indptr, gj.indices, gj.weights, gj.n)
    ft = rs_t.build_frontier_plan(gt, parts, nparts, weights=w, plan=plan)
    _assert_same_arrays(fj, ft)
    want = [rs_j.run_sharded_sweeps(fj, parts, nparts, sweeps=10,
                                    corridor=corr),
            rs_j.refine_sharded_host(fj, parts, nparts, sweeps=10,
                                     corridor=corr)]
    got = [rs_t.run_sharded_sweeps(ft, parts, nparts, sweeps=10,
                                   corridor=corr, device="cpu"),
           rs_t.run_sharded_sweeps(ft, parts, nparts, sweeps=10,
                                   corridor=corr, backend="host")]
    out0, rec0, info0 = want[0]
    assert info0["moves"] > 0         # the perturbation left real work
    for out, rec, info in want[1:] + got:
        assert np.array_equal(out, out0)
        assert [r.moves for r in rec] == [r.moves for r in rec0]
        assert [(r.cut_before, r.cut_after) for r in rec] == \
            [(r.cut_before, r.cut_after) for r in rec0]
        assert info["cut"] == info0["cut"]
        assert info["gathers"] == info0["gathers"] == len(rec0)
    assert got[0][2]["cut"] == pytest.approx(edge_cut(gt, got[0][0]))


@pytest.mark.parametrize("dims,nparts,seed", CASES)
def test_sweeps_monotone_and_corridor(dims, nparts, seed):
    _, gt, parts, w, corr = _seeded_case(dims, nparts, seed)
    fp = rs_t.build_frontier_plan(gt, parts, nparts, weights=w)
    out, records, info = rs_t.run_sharded_sweeps(fp, parts, nparts, sweeps=10,
                                                 corridor=corr, device="cpu")
    assert info["moves"] > 0 and info["admit_seconds"] >= 0.0
    for r in records:
        assert r.cut_after <= r.cut_before + 1e-6
    pw = np.bincount(out, weights=np.asarray(w, float), minlength=nparts)
    assert pw.min() >= corr[0] - 1e-9
    assert pw.max() <= corr[1] + 1e-9
    assert set(np.unique(out)) == set(range(nparts))


@pytest.mark.parametrize("refine", ["repair+refine-sharded", "refine-sharded",
                                    "kway-sharded", "repair+kway-sharded"])
def test_post_chains_match_repro(refine):
    gj, gt, parts, w, _ = _seeded_case((8, 8, 6), 8, 11, frac=0.25)
    post = pipe_j.parse_refine(refine)
    assert pipe_t.parse_refine(refine) == post
    pj, sj, _ = pipe_j.run_post_stages(gj, parts, 8, post, weights=w,
                                       post_kw=dict(sweeps=8))
    pt, st, records = pipe_t.run_post_stages(gt, parts, 8, post, weights=w,
                                             post_kw=dict(sweeps=8),
                                             device="cpu")
    assert np.array_equal(pj, pt)
    row_j, row_t = sj.row(), st.row()
    row_j.pop("seconds"), row_t.pop("seconds")
    if row_j["kway"] is not None:
        for r in (row_j, row_t):
            r["kway"] = {k: v for k, v in r["kway"].items() if k != "seconds"}
    assert row_t == row_j
    info = records[-1].info["sharded"]
    assert info["gathers"] == len(st.sweeps) > 0
    assert info["plan_seconds"] >= 0.0 and info["m"] > info["halo"] > 0


@pytest.mark.parametrize("dims,nparts", [((8, 8, 6), 8), ((9, 8, 6), 12)])
def test_pipeline_runs_match_repro(dims, nparts):
    """Through the front door, RSB then the sharded post chains: identical
    labels.  On the 8×8×6 box RSB's labels are already optimal (the chains
    move nothing); on the 9×8×6 box into 12 parts they move elements."""
    mj, mt = mesh_j.box_mesh(*dims), mesh_t.box_mesh(*dims)
    raw = pipe_t.partition(mt, nparts, refine="none", device="cpu")
    g = mesh_t.dual_graph(mt)
    for refine in ("repair+refine-sharded", "kway-sharded"):
        pj = pipe_j.partition(mj, nparts, refine=refine, guard=False)
        pt = pipe_t.partition(mt, nparts, refine=refine, device="cpu")
        assert np.array_equal(pj, pt), refine
        assert edge_cut(g, pt) <= edge_cut(g, raw)


def test_set_drop_matches_jax_mode_drop():
    """The pad slot (``n_local``) is dropped, as JAX's ``mode="drop"``
    drops it, even where several pad rows aim at it."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, (3, 6)).astype(np.int32)
    slots = np.array([[0, 2, 6, 6], [5, 6, 1, 6], [6, 6, 6, 6]])
    values = rng.integers(5, 9, (3, 4)).astype(np.int32)
    got = rs_t._set_drop(torch.from_numpy(labels), torch.from_numpy(slots),
                         torch.from_numpy(values))
    want = [jnp.asarray(labels[g]).at[slots[g]].set(values[g], mode="drop")
            for g in range(3)]
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_argmax_tie_picks_first_part():
    """Node 0 (part 0) is tied between parts 1 and 2 (two edges to each,
    one to its own part): both packages move it to part 1, the first
    maximal target."""
    src = np.array([0, 0, 0, 0, 0, 1, 3])
    dst = np.array([1, 2, 3, 4, 5, 2, 4])
    parts = np.array([0, 1, 1, 2, 2, 0])
    from repro.mesh import build_csr as build_j
    from repro_torch.mesh.graphs import build_csr as build_t
    gj, gt = build_j(src, dst, 6), build_t(src, dst, 6)
    corr = (0.0, 100.0)
    fj = rs_j.build_frontier_plan(gj, parts, 3)
    ft = rs_t.build_frontier_plan(gt, parts, 3)
    out_j, _, _ = rs_j.run_sharded_sweeps(fj, parts, 3, sweeps=4,
                                          corridor=corr)
    out_t, rec, _ = rs_t.run_sharded_sweeps(ft, parts, 3, sweeps=4,
                                            corridor=corr, device="cpu")
    assert out_t[0] == 1 and np.array_equal(out_t, out_j)
    assert rec[0].moves == 0 and rec[1].moves == 1


def test_empty_frontier_is_noop():
    from repro_torch.mesh.graphs import build_csr

    src = np.array([0, 0, 0, 1, 1, 2, 4, 4, 4, 5, 5, 6])
    dst = np.array([1, 2, 3, 2, 3, 3, 5, 6, 7, 6, 7, 7])
    g = build_csr(src, dst, 8)
    parts = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    fp = rs_t.build_frontier_plan(g, parts, 2)
    assert fp.plan.halo == 0
    out, records, info = rs_t.run_sharded_sweeps(fp, parts, 2,
                                                 corridor=(0.0, 8.0))
    assert np.array_equal(out, parts) and records == []
    assert info["gathers"] == 0 and info["cut"] == 0.0


def test_no_fallback_and_contract(monkeypatch):
    """A failing table build raises (no host-refiner fallback), a guard
    object raises, and without a card the device path raises."""
    _, gt, parts, w, corr = _seeded_case((6, 6, 4), 4, 5)

    def broken(*a, **k):
        raise RuntimeError("launch failed")

    with pytest.raises(NotImplementedError, match="guard"):
        rs_t.refine_sharded_stage(gt, parts, 4, weights=w, guard=object(),
                                  device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        rs_t.run_sharded_sweeps(rs_t.build_frontier_plan(gt, parts, 4), parts,
                                4, corridor=corr, backend="tpu")
    monkeypatch.setattr(rs_t, "connection_table_batched", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        rs_t.kway_sharded_stage(gt, parts, 4, weights=w, device="cpu")
    monkeypatch.setattr(rs_t, "run_sharded_sweeps",
                        lambda fp, p, n, **k: (p * 0 - 1, [], {"moves": 0}))
    with pytest.raises(ValueError, match="invalid labels"):
        rs_t.refine_sharded_stage(gt, parts, 4, weights=w, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe_t.run_post_stages(gt, parts, 4, ("refine-sharded",), weights=w)
    # a host-only chain never asks for the device
    pipe_t.run_post_stages(gt, parts, 4, ("repair", "kway"), weights=w)
