"""repro_torch.dist across 4 gloo ranks on the CPU, held to repro.dist.

One 4-rank group is spawned once for the module (`_dist_ranks`).

* The distributed GS Laplacian: `dist_lap_apply_allreduce` on
  `box_mesh(4, 4, 3)` split over 4 ranks against `repro`'s on 4 forced
  host devices and against the port's one-process GS apply, both within
  1e-6 of max|y|.
* The ring: `ring_allreduce` against `all_reduce` — bit-equal on
  integer-valued floats, within 1e-6 on random ones — and bit-equal to
  the ring's own order (rank r adds r, r−1, …), as `repro`'s shard r.
* The sweep across ranks: P = 12 on 4 ranks (G = 3), labels equal to
  `repro`'s in-process `run_sharded_sweeps` and the NumPy mirror.
* `run_sharded`'s protocol (`benchmarks/partition_time.py`): the
  959-element `pebble_mesh(10,10,10, n_pebbles=6, seed=0)` into 8 parts,
  the post chains across the 4 ranks: the recorded cuts 4679
  (`repair+refine-sharded`) and 4319 (`kway-sharded`), labels equal to the
  one-process chains', one boundary gather a sweep.
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
from repro_torch.core.gather_scatter import gs_setup, weighted_laplacian
from repro_torch.core.pipeline import PartitionPipeline as PipelineT
from repro_torch.core.pipeline import run_post_stages
from repro_torch.core.refine import edge_cut

WORLD = 4
SWEEP = ((9, 8, 6), 12, 7)                 # dims, nparts, seed: G = 3
CHAINS = {"repair+refine-sharded": (("repair", "refine-sharded"), 4679.0),
          "kway-sharded": (("kway-sharded",), 4319.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def gs_case():
    m = mesh_t.box_mesh(4, 4, 3)
    h = gs_setup(m.vert_gid, device="cpu")
    L = weighted_laplacian(m.vert_gid, device="cpu")
    x = np.random.default_rng(1).normal(size=m.nelems).astype(np.float32)
    return dict(vert_gid=m.vert_gid, gid=h.gid.numpy(), n_global=h.n_global,
                deg=L.degree_full.numpy(), x=x,
                y=L.apply(torch.from_numpy(x)).numpy())


@pytest.fixture(scope="module")
def ring_case():
    rng = np.random.default_rng(2)
    return dict(ints=rng.integers(-1000, 1000, (WORLD, 37)).astype(np.float32),
                rand=rng.normal(size=(WORLD, 37)).astype(np.float32))


@pytest.fixture(scope="module")
def sweep_case():
    dims, nparts, seed = SWEEP
    mesh = mesh_j.box_mesh(*dims)
    ctx = PipelineJ(bisect="rcb", post=(), guard=False).run(mesh, nparts)
    gj = ctx.require_graph()
    rng = np.random.default_rng(seed)
    parts = ctx.parts.copy()
    sel = rng.random(gj.n) < 0.12
    parts[sel] = rng.integers(0, nparts, sel.sum())
    corr = balance_corridor(parts, nparts, ctx.weights, 0.05)
    gt = mesh_t.dual_graph(mesh_t.box_mesh(*dims))
    return gj, gt, parts, np.asarray(ctx.weights), corr


@pytest.fixture(scope="module")
def smoke_case():
    """`run_sharded`'s raw labels: Lanczos RSB without post stages."""
    ctx = PipelineT(pre="rcb", bisect_kw=dict(tol=1e-3), post=(),
                    device="cpu").run(
        mesh_t.pebble_mesh(10, 10, 10, n_pebbles=6, seed=0), 8)
    return ctx.require_graph(), ctx.parts_raw, np.asarray(ctx.weights)


@pytest.fixture(scope="module")
def ranks(gs_case, ring_case, sweep_case, smoke_case, tmp_path_factory):
    """Every rank's results (one spawn of 4 ranks for the module)."""
    _, gt, parts, w, corr = sweep_case
    g, raw, sw = smoke_case
    cases = {
        "gs": ("case_gs", {k: gs_case[k]
                           for k in ("gid", "x", "deg", "n_global")}),
        "ring/ints": ("case_ring", dict(xs=ring_case["ints"])),
        "ring/rand": ("case_ring", dict(xs=ring_case["rand"])),
        "sweep": ("case_sweep", dict(graph=gt, parts=parts, nparts=SWEEP[1],
                                     weights=w, corridor=corr)),
    }
    for name, (post, _) in CHAINS.items():
        cases[f"chain/{name}"] = ("case_post_chain", dict(
            graph=g, raw=raw, nparts=8, weights=sw, post=post,
            post_kw={"sweeps": 8}))
    return _dist_ranks.run_ranks(_dist_ranks.run_cases, cases, WORLD,
                                 tmp_path_factory.mktemp("ranks4"))


@pytest.fixture(scope="module")
def repro_gs(gs_case, multi_device_run, tmp_path_factory):
    """`repro`'s `dist_lap_apply_allreduce` on 4 host devices
    (tests/test_distributed.py::test_distributed_gs_laplacian's setup)."""
    d = tmp_path_factory.mktemp("repro_gs")
    np.savez(d / "in.npz", vert_gid=gs_case["vert_gid"], x=gs_case["x"])
    multi_device_run(f"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.core import weighted_laplacian
from repro.core.gather_scatter import gs_setup
from repro.dist.collectives import dist_lap_apply_allreduce
d = np.load({str(d / "in.npz")!r})
L = weighted_laplacian(d["vert_gid"])
h = gs_setup(d["vert_gid"])
n = d["x"].size
gid = np.asarray(h.gid).reshape(4, n // 4, -1)
deg = np.asarray(L.degree_full).reshape(4, n // 4)
mesh = jax.make_mesh((4,), ("shards",), axis_types=(AxisType.Auto,))
def fn(g, xl, dg):
    return dist_lap_apply_allreduce(g[0], xl[0], dg[0], h.n_global,
                                    "shards")[None]
with jax.set_mesh(mesh):
    out = jax.shard_map(fn, mesh=mesh, in_specs=(P("shards"),) * 3,
                        out_specs=P("shards"))(
        jnp.asarray(gid), jnp.asarray(d["x"].reshape(4, -1)), jnp.asarray(deg))
np.save({str(d / "out.npy")!r}, np.asarray(out).reshape(-1))
""", devices=WORLD)
    return np.load(d / "out.npy")


def test_gs_laplacian_matches_repro_and_one_process(gs_case, ranks, repro_gs):
    y = np.concatenate([ranks[r]["gs"] for r in range(WORLD)])
    scale = np.abs(gs_case["y"]).max()
    assert np.abs(y - gs_case["y"]).max() <= 1e-6 * scale
    assert np.abs(y - repro_gs).max() <= 1e-6 * scale


@pytest.mark.parametrize("kind", ["ints", "rand"])
def test_ring_allreduce(kind, ring_case, ranks):
    xs = ring_case[kind]
    for r in range(WORLD):
        ring, ref = ranks[r][f"ring/{kind}"]
        # the ring's own order: rank r adds x_r, x_{r-1}, ..., in float32
        want = xs[r].copy()
        for k in range(1, WORLD):
            want = want + xs[(r - k) % WORLD]
        assert np.array_equal(ring, want)
        if kind == "ints":
            assert np.array_equal(ring, ref)
        else:
            assert np.abs(ring - ref).max() <= 1e-6 * np.abs(ref).max()


def test_sweep_across_four_ranks_matches_repro(sweep_case, ranks):
    gj, _, parts, w, corr = sweep_case
    nparts = SWEEP[1]
    fj = rs_j.build_frontier_plan(gj, parts, nparts, weights=w)
    out_j, rec_j, _ = rs_j.run_sharded_sweeps(fj, parts, nparts, sweeps=10,
                                              corridor=corr)
    out_h, _, _ = rs_t.refine_sharded_host(fj, parts, nparts, sweeps=10,
                                           corridor=corr)
    assert np.array_equal(out_j, out_h)
    for r in range(WORLD):
        got = ranks[r]["sweep"]
        assert np.array_equal(got["labels"], out_j), r
        assert got["moves"] == [x.moves for x in rec_j]
        assert got["cuts"] == [(x.cut_before, x.cut_after) for x in rec_j]
        assert (got["info"]["ranks"], got["info"]["shards_per_rank"]) == (4, 3)
        c = got["counters"]
        assert c["sharded_gathers"] == c["sharded_sweeps"] \
            == c["sharded_scalar_gathers"] == len(rec_j)


@pytest.mark.parametrize("name", CHAINS)
def test_run_sharded_protocol_across_ranks(name, smoke_case, ranks):
    g, raw, w = smoke_case
    post, recorded_cut = CHAINS[name]
    want, agg, _ = run_post_stages(g, raw, 8, post, weights=w,
                                   post_kw={"sweeps": 8}, device="cpu")
    assert edge_cut(g, want) == recorded_cut
    for r in range(WORLD):
        got = ranks[r][f"chain/{name}"]
        assert np.array_equal(got["labels"], want), r
        assert got["moves"] == [s.moves for s in agg.sweeps]
        assert "host-fallback" not in got["stages"][-1]
        c = got["counters"]
        assert c["sharded_gathers"] == c["sharded_sweeps"] > 0
