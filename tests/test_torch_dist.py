"""repro_torch.dist across 8 gloo ranks on the CPU, held to repro.dist.

One 8-rank group is spawned once for the module (`_dist_ranks`); every
rank runs the cases below and the tests read what each rank returned.

* The halo matvec: `adjacency_matvec_distributed` on `grid_graph_2d(32,
  32)` under the random, RCB and RSB plans of
  `examples/partition_aware_gnn.py`, against `repro`'s on 8 forced host
  devices and the dense ``A·x``: within 1e-6 of max|y| (float32 sums in
  another order), the same ``y`` on every rank.
* The sweep across ranks (`tests/test_refine_sharded.py`'s 8-device
  parity cases): P = 8 on 8 ranks (G = 1) and P = 12 on 8 ranks (d = 6,
  ranks 6 and 7 sit out).  Labels, moves and tracked cuts equal `repro`'s
  in-process `run_sharded_sweeps` and the NumPy mirror bit for bit on
  every rank, one boundary gather and one scalar gather a sweep.
"""

import numpy as np
import pytest
import torch

import _dist_ranks
import repro.dist.refine_sharded as rs_j
import repro.mesh as mesh_j
import repro_torch.dist.refine_sharded as rs_t
import repro_torch.mesh as mesh_t
from repro.core import balance_corridor
from repro.core.pipeline import PartitionPipeline as PipelineJ
from repro_torch.core.pipeline import PartitionPipeline as PipelineT
from repro_torch.core.rcb import rcb_parts

WORLD = 8
PLANS = ("random", "rcb", "rsb")
SWEEP_CASES = {"P8_on_8": ((8, 8, 6), 8, 3, 8),     # dims, nparts, seed, d
               "P12_on_8": ((9, 8, 6), 12, 7, 6)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grid_case():
    """`examples/partition_aware_gnn.py`'s graph, plans and ``x``."""
    g = mesh_t.grid_graph_2d(32, 32)
    coords = np.stack(np.meshgrid(np.arange(32), np.arange(32),
                                  indexing="ij"), -1).reshape(-1, 2)
    coords = np.concatenate([coords, np.zeros((g.n, 1))], 1).astype(float)
    ctx = PipelineT(bisect_kw=dict(tol=1e-4), device="cpu").run(
        g, WORLD, coords=coords)
    parts = {"random": np.random.default_rng(0).permutation(
                 np.arange(g.n) % WORLD),
             "rcb": rcb_parts(coords, WORLD),
             "rsb": ctx.parts}
    x = np.random.default_rng(1).normal(size=g.n)
    return g, parts, x


def _seeded_case(dims, nparts, seed, frac=0.12):
    """tests/test_refine_sharded.py's case (RCB labels, a seeded
    perturbation, the corridor of the perturbed state) as both packages'
    graphs and the shared labels."""
    mesh = mesh_j.box_mesh(*dims)
    ctx = PipelineJ(bisect="rcb", post=(), guard=False).run(mesh, nparts)
    gj = ctx.require_graph()
    rng = np.random.default_rng(seed)
    parts = ctx.parts.copy()
    sel = rng.random(gj.n) < frac
    parts[sel] = rng.integers(0, nparts, sel.sum())
    corr = balance_corridor(parts, nparts, ctx.weights, 0.05)
    gt = mesh_t.dual_graph(mesh_t.box_mesh(*dims))
    return gj, gt, parts, np.asarray(ctx.weights), corr


@pytest.fixture(scope="module")
def grid():
    return _grid_case()


@pytest.fixture(scope="module")
def sweep_cases():
    return {name: _seeded_case(dims, nparts, seed)
            for name, (dims, nparts, seed, _) in SWEEP_CASES.items()}


@pytest.fixture(scope="module")
def ranks(grid, sweep_cases, tmp_path_factory):
    """Every rank's results (one spawn of 8 ranks for the module)."""
    g, parts, x = grid
    cases = {f"matvec/{p}": ("case_matvec", dict(graph=g, parts=parts[p],
                                                 nparts=WORLD, x=x))
             for p in PLANS}
    for name, (_, gt, lab, w, corr) in sweep_cases.items():
        cases[f"sweep/{name}"] = ("case_sweep", dict(
            graph=gt, parts=lab, nparts=SWEEP_CASES[name][1], weights=w,
            corridor=corr))
    return _dist_ranks.run_ranks(_dist_ranks.run_cases, cases, WORLD,
                                 tmp_path_factory.mktemp("ranks8"))


@pytest.fixture(scope="module")
def repro_matvec(grid, multi_device_run, tmp_path_factory):
    """`repro`'s distributed matvec under the same plans, 8 host devices."""
    g, parts, x = grid
    d = tmp_path_factory.mktemp("repro_matvec")
    np.savez(d / "in.npz", x=x, **parts)
    multi_device_run(f"""
import jax, numpy as np
from jax.sharding import AxisType
from repro.dist.partition_aware import (adjacency_matvec_distributed,
                                        plan_halo_sharding)
from repro.mesh.graphs import grid_graph_2d
d = np.load({str(d / "in.npz")!r})
g = grid_graph_2d(32, 32)
mesh = jax.make_mesh((8,), ("shards",), axis_types=(AxisType.Auto,))
out = {{}}
with jax.set_mesh(mesh):
    for name in {PLANS!r}:
        plan = plan_halo_sharding(g, d[name], 8)
        out[name] = adjacency_matvec_distributed(plan, mesh, d["x"])
np.savez({str(d / "out.npz")!r}, **out)
""")
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("plan", PLANS)
def test_matvec_matches_repro_and_dense(plan, grid, ranks, repro_matvec):
    g, _, x = grid
    A = np.zeros((g.n, g.n))
    A[g.rows, g.indices] = g.weights
    dense = A @ x
    y0 = ranks[0][f"matvec/{plan}"]
    assert y0.shape == (g.n,)
    for r in range(1, WORLD):
        assert np.array_equal(ranks[r][f"matvec/{plan}"], y0)
    scale = np.abs(dense).max()
    assert np.abs(y0 - dense).max() <= 1e-6 * scale
    assert np.abs(y0 - repro_matvec[plan]).max() <= 1e-6 * scale


@pytest.mark.parametrize("name", SWEEP_CASES)
def test_sweep_across_ranks_matches_repro(name, sweep_cases, ranks):
    gj, _, parts, w, corr = sweep_cases[name]
    nparts, d = SWEEP_CASES[name][1], SWEEP_CASES[name][3]
    fj = rs_j.build_frontier_plan(gj, parts, nparts, weights=w)
    out_j, rec_j, info_j = rs_j.run_sharded_sweeps(fj, parts, nparts,
                                                   sweeps=10, corridor=corr)
    out_h, _, _ = rs_t.refine_sharded_host(fj, parts, nparts, sweeps=10,
                                           corridor=corr)
    assert np.array_equal(out_j, out_h) and info_j["moves"] > 0
    for r in range(WORLD):
        got = ranks[r][f"sweep/{name}"]
        assert np.array_equal(got["labels"], out_j), r
        assert got["moves"] == [x.moves for x in rec_j]
        assert got["cuts"] == [(x.cut_before, x.cut_after) for x in rec_j]
        info = got["info"]
        assert info["gathers"] == len(rec_j) == info_j["gathers"]
        assert info["cut"] == info_j["cut"]
        assert (info["ranks"], info["shards_per_rank"]) == (d, nparts // d)
        c = got["counters"]
        if r < d:        # one boundary gather and one scalar gather a sweep
            assert c["sharded_gathers"] == c["sharded_sweeps"] \
                == c["sharded_scalar_gathers"] == len(rec_j)
            assert c["sharded_label_gathers"] == 1
        else:            # sat out: rank 0's result, no sweep of its own
            assert "sharded_sweeps" not in c
