"""The halo GraphCast across 4 gloo ranks on the CPU, held to `repro`'s
GraphCast on the full graph.

`stencil_graph_3d(6, 6, 6)` (216 nodes, 26-neighbour stencil) is split
into 4 shards by RCB of its grid coordinates and planned
(`plan_halo_sharding`, bit-identical to `repro`'s); every rank runs its
shard through `graphcast_halo_local` and `graphcast_halo_loss`, one halo
exchange a layer, and differentiates the loss across the ranks.  Held
to `repro`'s one-device `graphcast_forward` and `graphcast_loss` on the
whole graph with the same converted weights: every rank's forward block
within 1e-4 of max|out|, the loss (the same on every rank) within 1e-5
(relative), and the gradients summed over the ranks within 1e-4 of each
leaf's max; with recompute (``remat``) the same loss and gradients bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _dist_ranks
from repro.models.gnn.common import GraphBatch as GraphBatchJ
from repro.models.gnn.graphcast import GraphCastConfig as GraphCastConfigJ
from repro.models.gnn.graphcast import graphcast_forward, graphcast_loss, init_graphcast
from repro_torch.core.rcb import rcb_parts
from repro_torch.dist import gather_features, plan_halo_sharding
from repro_torch.mesh import grid_coords_3d, stencil_graph_3d
from repro_torch.models.gnn.graphcast import GraphCastConfig

WORLD = 4
SIDE = 6


@pytest.fixture(scope="module")
def halo_run(tmp_path_factory):
    g = stencil_graph_3d(SIDE, SIDE, SIDE)
    parts = rcb_parts(grid_coords_3d(SIDE, SIDE, SIDE), WORLD)
    plan = plan_halo_sharding(g, parts, WORLD)
    cfg_j = GraphCastConfigJ(n_layers=2, d_hidden=16, n_vars=4, d_in=5)
    cfg = GraphCastConfig(n_layers=2, d_hidden=16, n_vars=4, d_in=5)
    params_j = init_graphcast(cfg_j, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params_j)
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(g.n, 5)).astype(np.float32)
    tgt = rng.normal(size=(g.n, 4)).astype(np.float32)
    ranks = _dist_ranks.run_ranks(
        _dist_ranks.run_cases,
        {"halo": ("case_halo_graphcast",
                  dict(cfg=cfg, params=params, plan=plan, feat=feat,
                       tgt=tgt))},
        WORLD, tmp_path_factory.mktemp("halo"))
    full = GraphBatchJ(
        node_feat=jnp.asarray(feat),
        edge_src=jnp.asarray(g.indices.astype(np.int32)),
        edge_dst=jnp.asarray(g.rows.astype(np.int32)),
        node_mask=jnp.ones(g.n), edge_mask=jnp.ones(g.nnz),
        targets=jnp.asarray(tgt))
    want_out = np.asarray(graphcast_forward(cfg_j, params_j, full))
    want_loss, want_grads = jax.value_and_grad(
        lambda p: graphcast_loss(cfg_j, p, full))(params_j)
    return plan, [r["halo"] for r in ranks], want_out, float(want_loss), \
        want_grads


def test_halo_forward_matches_repro_full_graph(halo_run):
    plan, ranks, want, _, _ = halo_run
    blocks = np.stack([r["pred"] for r in ranks])
    got = gather_features(plan, blocks)
    scale = np.abs(want).max()
    for s in range(WORLD):
        rows = plan.shard_of == s
        err = np.abs(got[rows] - want[rows]).max()
        assert err <= 1e-4 * scale, (s, err)


def test_halo_loss_matches_repro_full_graph(halo_run):
    _, ranks, _, want, _ = halo_run
    losses = [r["plain"]["loss"] for r in ranks]
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], want, rtol=1e-5)


def test_halo_grads_match_repro_full_graph(halo_run):
    _, ranks, _, _, want = halo_run
    for r in ranks:
        got = jax.tree_util.tree_leaves(r["plain"]["grads"])
        for (path, w), a in zip(jax.tree_util.tree_leaves_with_path(want),
                                got):
            w = np.asarray(w)
            assert a.shape == w.shape, path
            assert np.abs(a - w).max() <= 1e-4 * np.abs(w).max(), \
                jax.tree_util.keystr(path)


def test_halo_remat_is_bit_identical(halo_run):
    _, ranks, _, _, _ = halo_run
    for r in ranks:
        assert r["remat"]["loss"] == r["plain"]["loss"]
        for a, b in zip(jax.tree_util.tree_leaves(r["remat"]["grads"]),
                        jax.tree_util.tree_leaves(r["plain"]["grads"])):
            np.testing.assert_array_equal(a, b)
