"""The GNNs in repro_torch vs repro: generators, sampler, shapes and data;
the fixed-order gather/scatter pair; MeshGraphNet, GraphCast, NequIP and
MACE forwards, losses, gradients and train steps; invariances; remat.

`repro`'s ``init_*`` make the parameter tree; it goes to NumPy and into
the port (`convert.gnn_params_from_numpy`), so both packages run the same
weights on the same NumPy-drawn batch.  Tolerances (fp32, those of
`test_torch_lm_train.py`): forward outputs and energies 1e-5 of their
max |·|, the loss 1e-5 (relative), every gradient leaf 1e-4 of its max
|·|, the parameters after one AdamW step 1e-6.  The generators, the
sampler and the data are bit-identical; the ordered sum gives the same
bits twice and, on rows of at most ``RUN`` entries, the bits of a
sequential sum in edge order.  Batches carry padded slots (masked, all
pointing at node 0) so that a row longer than ``RUN`` is split.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as get_arch_j
from repro.configs.shapes import GNN_SHAPES as GNN_SHAPES_J
from repro.data.synthetic import gnn_full_batch as gnn_full_batch_j
from repro.data.synthetic import molecule_batches as molecule_batches_j
from repro.launch.cells import OPT_CFG as OPT_CFG_J
from repro.mesh import graphs as graphs_j
from repro.models.gnn import common as common_j
from repro.models.gnn import equivariant as eq_j
from repro.models.gnn import graphcast as gc_j
from repro.models.gnn import mace as mace_j
from repro.models.gnn import meshgraphnet as mgn_j
from repro.models.gnn import nequip as nq_j
from repro.models.gnn import sampler as sampler_j
from repro.train.optimizer import adamw_init as adamw_init_j
from repro.train.optimizer import adamw_update as adamw_update_j
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.convert import gnn_params_from_numpy, gnn_params_to_numpy
from repro_torch.data.synthetic import gnn_full_batch, molecule_batches
from repro_torch.launch import cells
from repro_torch.mesh import graphs
from repro_torch.models.common import tree_leaves
from repro_torch.models.gnn import common, equivariant, graphcast, mace
from repro_torch.models.gnn import meshgraphnet as mgn
from repro_torch.models.gnn import nequip, sampler
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import value_and_grad

ARCHS = ("meshgraphnet", "graphcast", "nequip", "mace")
INIT_J = {"meshgraphnet": mgn_j.init_mgn, "graphcast": gc_j.init_graphcast,
          "nequip": nq_j.init_nequip, "mace": mace_j.init_mace}
LOSS_J = {"meshgraphnet": mgn_j.mgn_loss, "graphcast": gc_j.graphcast_loss,
          "nequip": nq_j.nequip_loss, "mace": mace_j.mace_loss}
OUT_J = {"meshgraphnet": mgn_j.mgn_forward,
         "graphcast": gc_j.graphcast_forward,
         "nequip": nq_j.nequip_energy, "mace": mace_j.mace_energy}
OUT_T = {"meshgraphnet": mgn.mgn_forward,
         "graphcast": graphcast.graphcast_forward,
         "nequip": nequip.nequip_energy, "mace": mace.mace_energy}
CFG_T = {mgn_j.MGNConfig: mgn.MGNConfig,
         gc_j.GraphCastConfig: graphcast.GraphCastConfig,
         nq_j.NequIPConfig: nequip.NequIPConfig,
         mace_j.MACEConfig: mace.MACEConfig}
PAD = 100      # masked slots at node 0: a row of more than RUN entries


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_cfg(cfg_j):
    """`repro`'s GNN config as the port's (the fields both have; the port
    has no ``unroll`` and its dtype is torch's)."""
    cls = CFG_T[type(cfg_j)]
    names = {f.name for f in dataclasses.fields(cls)} - {"dtype"}
    return cls(**{n: getattr(cfg_j, n) for n in names})


def to_port(b_j) -> common.GraphBatch:
    """A `repro` GraphBatch as the port's, on the CPU."""
    kw = {f: None if getattr(b_j, f) is None
          else torch.from_numpy(np.array(getattr(b_j, f)))
          for f in common._TENSOR_FIELDS}
    return common.GraphBatch(**kw, n_graphs=b_j.n_graphs)


def padded(b_j, pad=PAD):
    """``b_j`` with ``pad`` masked edge slots at node 0 (the sampler's
    padding)."""
    z = jnp.zeros((pad,), jnp.int32)
    return dataclasses.replace(
        b_j, edge_src=jnp.concatenate([b_j.edge_src, z]),
        edge_dst=jnp.concatenate([b_j.edge_dst, z]),
        edge_mask=jnp.concatenate([b_j.edge_mask, jnp.zeros((pad,))]))


def setup(arch_id, seed=0):
    """(cfg_j, params_j, batch_j, cfg, params, batch) at the smoke width."""
    cfg_j = get_arch_j(arch_id).make_smoke_config()
    if arch_id in ("nequip", "mace"):
        b_j = next(molecule_batches_j(16, 10, 20, seed=seed + 3))
    else:
        g = graphs_j.rmat_graph(48, 200, seed=seed + 5)
        d_out = cfg_j.n_vars if arch_id == "graphcast" else cfg_j.d_out
        b_j = gnn_full_batch_j(g, d_feat=cfg_j.d_in, d_out=d_out,
                               seed=seed + 1)
    b_j = padded(b_j)
    p_j = INIT_J[arch_id](cfg_j, jax.random.PRNGKey(seed))
    p_np = jax.tree_util.tree_map(np.asarray, p_j)
    cfg = port_cfg(cfg_j)
    return cfg_j, p_j, b_j, cfg, gnn_params_from_numpy(
        arch_id, cfg, p_np, device="cpu"), to_port(b_j)


def max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# Host code: bit-identical copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, m, seed", [(256, 1024, 0), (2708, 5278, 3),
                                        (1000, 20000, 7)])
def test_rmat_graph_is_repros(n, m, seed):
    a, b = graphs.rmat_graph(n, m, seed=seed), graphs_j.rmat_graph(n, m,
                                                                  seed=seed)
    assert a.n == b.n
    for f in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_molecule_stencil_coords_are_repros():
    for x, y in zip(graphs.radius_molecule_batch(5, 30, 64, seed=2),
                    graphs_j.radius_molecule_batch(5, 30, 64, seed=2)):
        np.testing.assert_array_equal(x, y)
    for stencil in (26, 6):
        a = graphs.stencil_graph_3d(5, 4, 3, stencil=stencil)
        b = graphs_j.stencil_graph_3d(5, 4, 3, stencil=stencil)
        for f in ("indptr", "indices", "weights"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(graphs.grid_coords_3d(3, 4, 5),
                                  graphs_j.grid_coords_3d(3, 4, 5))


@pytest.mark.parametrize("fanout", [(15, 10), (4, 3)])
def test_sampler_is_repros(fanout):
    g = graphs.rmat_graph(3000, 30000, seed=1)
    seeds = np.arange(0, 3000, 97)
    a = sampler.sample_neighbors(g, seeds, fanout,
                                 rng=np.random.default_rng(4))
    b = sampler_j.sample_neighbors(graphs_j.rmat_graph(3000, 30000, seed=1),
                                   seeds, fanout,
                                   rng=np.random.default_rng(4))
    for f in dataclasses.fields(sampler_j.SampledSubgraph):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y)
    assert sampler.subgraph_capacity(1024, (15, 10)) == \
        sampler_j.subgraph_capacity(1024, (15, 10)) == (169984, 168960)


def cells_of(shapes):
    return {k: (c.name, c.kind, c.meta) for k, c in shapes.items()}


def test_gnn_shapes_are_repros():
    assert cells_of(GNN_SHAPES) == cells_of(GNN_SHAPES_J)
    assert (GNN_SHAPES["minibatch_lg"]["sub_nodes"],
            GNN_SHAPES["minibatch_lg"]["sub_edges"]) == (169984, 168960)


def test_gnn_batches_are_repros():
    g = graphs.rmat_graph(100, 400, seed=2)
    a, b = gnn_full_batch(g, 7, 3, seed=5), gnn_full_batch_j(g, 7, 3, seed=5)
    for f in common._TENSOR_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.numpy().dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    it, it_j = molecule_batches(3, 10, 20, seed=4), \
        molecule_batches_j(3, 10, 20, seed=4)
    for _ in range(2):
        x, y = next(it), next(it_j)
        assert x.n_graphs == y.n_graphs
        for f in common._TENSOR_FIELDS:
            np.testing.assert_array_equal(getattr(x, f).numpy(),
                                          np.asarray(getattr(y, f)))


def test_equivariant_tables_are_repros():
    np.testing.assert_array_equal(equivariant.gaunt_tensor(),
                                  eq_j.gaunt_tensor())
    assert equivariant.enumerate_paths() == eq_j.enumerate_paths()
    assert equivariant.n_paths() == 11
    np.testing.assert_array_equal(equivariant.path_tensors(),
                                  eq_j.path_tensors())
    r = np.random.default_rng(0).normal(size=(50, 3))
    np.testing.assert_array_equal(equivariant.sh_l2_np(r), eq_j.sh_l2_np(r))


def test_configs_are_repros():
    for arch_id in ARCHS:
        arch, arch_j = get_arch(arch_id), get_arch_j(arch_id)
        for make in ("make_config", "make_smoke_config"):
            assert getattr(arch, make)() == port_cfg(getattr(arch_j, make)())
        assert (arch.family, arch.source, arch.skips) == \
            (arch_j.family, arch_j.source, arch_j.skips)
        assert cells_of(arch.shapes) == cells_of(arch_j.shapes)


# ---------------------------------------------------------------------------
# The fixed-order gather / scatter pair
# ---------------------------------------------------------------------------

def _index(E=300, n=20, long=200, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n - 3, E)          # the last rows stay empty
    idx[rng.permutation(E)[:long]] = 0       # a row of `long` entries
    return idx


# row 0's length: not split, split once (7 runs), split twice (63 runs)
LONG = {"short": (200, 10), "split": (300, 200), "twice": (2100, 2000)}


@pytest.mark.parametrize("tail", [(), (4,), (3, 9)])
@pytest.mark.parametrize("case", list(LONG))
def test_scatter_gather_match_jax(tail, case):
    rng = np.random.default_rng(1)
    E, long = LONG[case]
    idx = _index(E=E, long=long)
    n = 20
    v = rng.normal(size=(E,) + tail).astype(np.float32)
    x = rng.normal(size=(n,) + tail).astype(np.float32)
    wo = rng.normal(size=(n,) + tail).astype(np.float32)
    wg = rng.normal(size=(E,) + tail).astype(np.float32)
    plan = common.segment_plan(torch.from_numpy(idx), n)
    assert len(plan.tree) == {"short": 0, "split": 1, "twice": 2}[case]

    def f_j(v, x):
        s = jax.ops.segment_sum(v, jnp.asarray(idx), num_segments=n)
        g = jnp.take(x, jnp.asarray(idx), axis=0)
        return (s * wo).sum() + (g * g * wg).sum(), (s, g)

    (_, (s_j, g_j)), (dv_j, dx_j) = jax.value_and_grad(
        f_j, argnums=(0, 1), has_aux=True)(jnp.asarray(v), jnp.asarray(x))
    vt = torch.from_numpy(v).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    s = common.scatter_sum(vt, plan, n)
    g = common.gather(xt, plan)
    ((s * torch.from_numpy(wo)).sum()
     + (g * g * torch.from_numpy(wg)).sum()).backward()
    terms = jax.ops.segment_sum(np.abs(v), jnp.asarray(idx), num_segments=n)
    assert float(np.abs(s.detach().numpy() - s_j).max()) <= \
        1e-6 * float(np.max(terms))
    np.testing.assert_array_equal(g.detach().numpy(), np.asarray(g_j))
    assert max_rel(vt.grad, dv_j) <= 1e-6
    assert max_rel(xt.grad, dx_j) <= 1e-5
    assert np.all(s.detach().numpy()[17:] == 0)      # empty rows
    # the same bits twice, and through a tensor index (planned on the fly)
    assert torch.equal(common.scatter_sum(torch.from_numpy(v), plan, n),
                       s.detach())
    assert torch.equal(
        common.scatter_sum(torch.from_numpy(v), torch.from_numpy(idx), n),
        common.scatter_sum(torch.from_numpy(v),
                           common.segment_plan(idx, n), n))


@pytest.mark.parametrize("case", list(LONG))
def test_ordered_sum_order_is_the_plans(case):
    """Bits of a NumPy emulation: each row's entries in edge order, runs of
    ``RUN`` summed sequentially from 0, a long row's partials ``RUN`` at a
    time, level by level."""
    rng = np.random.default_rng(2)
    E, long = LONG[case]
    idx = _index(E=E, long=long, seed=3)
    v = (rng.normal(size=(idx.size, 3)) * 10.0 ** rng.integers(
        -3, 4, (idx.size, 1))).astype(np.float32)
    got = common.ordered_sum(torch.from_numpy(v),
                             common.segment_plan(idx, 20)).numpy()
    run = common.RUN

    def seq(rows):
        acc = np.zeros(3, np.float32)
        for r in rows:
            acc = (acc + r).astype(np.float32)
        return acc

    for row in range(20):
        parts = [v[i] for i in np.flatnonzero(idx == row)]
        while len(parts) > run:
            parts = [seq(parts[k:k + run]) for k in range(0, len(parts), run)]
        np.testing.assert_array_equal(got[row], seq(parts))


def test_plan_on_batch_is_cached_and_moves():
    b = to_port(padded(gnn_full_batch_j(graphs_j.rmat_graph(30, 90, seed=1),
                                        4, 3)))
    p = b.plan("edge_dst")
    assert b.plan("edge_dst") is p and p.n == 30 and p.long_rows is not None
    moved = b.to("cpu")
    assert torch.equal(moved.plan("edge_dst").perm, p.perm)
    with pytest.raises(ValueError, match="plan of 30 rows"):
        common.scatter_sum(torch.zeros(b.edge_dst.shape[0]), p, 31)


def test_segment_softmax_matches_repro():
    rng = np.random.default_rng(5)
    idx = _index(E=120, long=60)
    logits = rng.normal(size=(120, 2)).astype(np.float32)
    want = common_j.segment_softmax(jnp.asarray(logits), jnp.asarray(idx), 20)
    got = common.segment_softmax(torch.from_numpy(logits),
                                 torch.from_numpy(idx), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# The models against repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_matches_repro(arch_id):
    cfg_j, p_j, b_j, cfg, p, b = setup(arch_id)
    want = np.asarray(OUT_J[arch_id](cfg_j, p_j, b_j))
    with torch.no_grad():
        got = OUT_T[arch_id](cfg, p, b).numpy()
    assert got.shape == want.shape
    assert max_rel(got, want) <= 1e-5, arch_id


def test_mgn_with_positions_matches_repro():
    cfg_j, p_j, b_j, cfg, p, b = setup("meshgraphnet", seed=2)
    pos = np.random.default_rng(0).normal(size=(b.n_nodes, 3)) \
        .astype(np.float32)
    b_j = dataclasses.replace(b_j, positions=jnp.asarray(pos))
    b.positions = torch.from_numpy(pos)
    want = np.asarray(mgn_j.mgn_forward(cfg_j, p_j, b_j))
    with torch.no_grad():
        assert max_rel(mgn.mgn_forward(cfg, p, b), want) <= 1e-5


@pytest.mark.parametrize("arch_id", ARCHS)
def test_loss_and_grads_match_repro(arch_id):
    cfg_j, p_j, b_j, cfg, p, b = setup(arch_id, seed=1)
    loss_j, g_j = jax.value_and_grad(
        lambda q: LOSS_J[arch_id](cfg_j, q, b_j))(p_j)
    loss_t, g_t = value_and_grad(
        lambda q, bb: cells.GNN_LOSSES[arch_id](cfg, q, bb))(p, b)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    leaves_j = jax.tree_util.tree_leaves_with_path(g_j)
    leaves_t = tree_leaves(g_t)
    assert len(leaves_j) == len(leaves_t)
    for (path, want), got in zip(leaves_j, leaves_t):
        want = np.asarray(want)
        assert got.shape == want.shape, path
        assert np.abs(got.numpy() - want).max() <= \
            1e-4 * np.abs(want).max(), (arch_id, jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_gnn_train_step_matches_repro(arch_id):
    """`gnn_train_step` against `repro`'s ``_gnn_cell`` step body, part by
    part: its loss (1e-5) and gradients (1e-4 of each leaf's max) against
    ``jax.value_and_grad``, and the parameters it returns against `repro`'s
    ``adamw_update`` with ``OPT_CFG`` of the same gradients (1e-6).  (The
    first AdamW step moves an entry by lr·g/(|g| + eps): where |g| is near
    eps = 1e-8, a gradient gap far inside its tolerance moves the entry by
    more than 1e-6, so the two packages' whole steps are not compared
    entry by entry.)"""
    cfg_j, p_j, b_j, cfg, p, b = setup(arch_id, seed=2)
    assert dataclasses.asdict(OPT_CFG_J) == dataclasses.asdict(cells.OPT_CFG)
    loss_j, g_j = jax.value_and_grad(
        lambda q: LOSS_J[arch_id](cfg_j, q, b_j))(p_j)
    new_t, opt_t, loss_t = cells.gnn_train_step(arch_id, cfg, p,
                                                adamw_init(p), b)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    _, g_t = value_and_grad(
        lambda q, bb: cells.GNN_LOSSES[arch_id](cfg, q, bb))(p, b)
    for a, w in zip(tree_leaves(g_t), jax.tree_util.tree_leaves(g_j)):
        assert np.abs(a.numpy() - np.asarray(w)).max() <= \
            1e-4 * np.abs(np.asarray(w)).max()
    g_np = jax.tree_util.tree_map(jnp.asarray, gnn_params_to_numpy(g_t))
    new_j, opt_j, _ = adamw_update_j(OPT_CFG_J, g_np, adamw_init_j(p_j), p_j)
    for a, w in zip(tree_leaves(new_t), jax.tree_util.tree_leaves(new_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-6)
    assert int(opt_t["count"]) == 1
    back = gnn_params_to_numpy(new_t)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, new_j))


def test_converter_rejects_other_trees():
    cfg_j, p_j, _, cfg, _, _ = setup("graphcast")
    p_np = jax.tree_util.tree_map(np.asarray, p_j)
    with pytest.raises(ValueError, match="not a 'meshgraphnet'"):
        gnn_params_from_numpy("meshgraphnet", cfg, p_np, device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        gnn_params_from_numpy("graphcast", dataclasses.replace(cfg,
                                                               n_layers=3),
                              p_np, device="cpu")


def test_tensor_products_match_repro():
    rng = np.random.default_rng(6)
    E, C, P = 40, 5, equivariant.n_paths()
    feat = rng.normal(size=(E, C, 9)).astype(np.float32)
    r = rng.normal(size=(E, 3))
    sh = eq_j.sh_l2_np(r / np.linalg.norm(r, axis=1, keepdims=True)) \
        .astype(np.float32)
    w = rng.normal(size=(E, C, P)).astype(np.float32)
    want = eq_j.tensor_product(jnp.asarray(feat), jnp.asarray(sh),
                               jnp.asarray(w))
    got = equivariant.tensor_product(torch.from_numpy(feat),
                                     torch.from_numpy(sh), torch.from_numpy(w))
    assert max_rel(got, want) <= 1e-5
    f2 = rng.normal(size=(E, C, 9)).astype(np.float32)
    pw = rng.normal(size=(C, P)).astype(np.float32)
    want = mace_j.tensor_product_pair(jnp.asarray(feat), jnp.asarray(f2),
                                      jnp.asarray(pw))
    got = mace.tensor_product_pair(torch.from_numpy(feat),
                                   torch.from_numpy(f2), torch.from_numpy(pw))
    assert max_rel(got, want) <= 1e-5
    rr = np.abs(rng.normal(size=(30,))).astype(np.float32) * 3
    np.testing.assert_allclose(
        equivariant.bessel_rbf(torch.from_numpy(rr), 8, 5.0).numpy(),
        np.asarray(eq_j.bessel_rbf(jnp.asarray(rr), 8, 5.0)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        equivariant.sh_l2(torch.from_numpy(r.astype(np.float32))).numpy(),
        eq_j.sh_l2_np(r), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Behaviour: invariances, masks, remat, determinism
# ---------------------------------------------------------------------------

def _random_rotation(rng):
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


@pytest.mark.parametrize("arch_id", ["nequip", "mace"])
def test_rotation_invariance(arch_id):
    _, _, _, cfg, p, b = setup(arch_id)
    rng = np.random.default_rng(3)
    Q = _random_rotation(rng)
    pos = b.positions.numpy().astype(np.float64)

    def energy(x):
        bb = dataclasses.replace(b, positions=torch.from_numpy(
            x.astype(np.float32)), plans={})
        with torch.no_grad():
            return OUT_T[arch_id](cfg, p, bb).numpy()

    e1 = energy(pos)
    np.testing.assert_allclose(e1, energy(pos @ Q.T), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(e1, energy(pos + rng.normal(size=3)),
                               atol=1e-3, rtol=1e-4)


def test_permutation_invariance_mgn():
    g = graphs.rmat_graph(40, 160, seed=5)
    batch = gnn_full_batch(g, d_feat=6, d_out=3, seed=1)
    cfg = mgn.MGNConfig(n_layers=2, d_hidden=16, d_in=6)
    params = mgn.init_mgn(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = mgn.mgn_forward(cfg, params, batch).numpy()
        perm = np.random.default_rng(0).permutation(g.n)
        inv = torch.from_numpy(np.argsort(perm).astype(np.int32))
        pb = common.GraphBatch(
            node_feat=batch.node_feat[perm],
            edge_src=inv[batch.edge_src.long()],
            edge_dst=inv[batch.edge_dst.long()],
            node_mask=batch.node_mask, edge_mask=batch.edge_mask,
            targets=batch.targets[perm])
        out_p = mgn.mgn_forward(cfg, params, pb).numpy()
    np.testing.assert_allclose(out_p, out[perm], atol=2e-4)


def test_edge_mask_drops_messages():
    g = graphs.rmat_graph(30, 90, seed=8)
    batch = gnn_full_batch(g, d_feat=4, d_out=3, seed=3)
    cfg = mgn.MGNConfig(n_layers=1, d_hidden=8, d_in=4)
    params = mgn.init_mgn(cfg, torch.Generator().manual_seed(1))
    same = dataclasses.replace(
        batch, node_feat=batch.node_feat[:1].expand_as(batch.node_feat),
        edge_mask=torch.zeros_like(batch.edge_mask), plans={})
    with torch.no_grad():
        out = mgn.mgn_forward(cfg, params, same)
    np.testing.assert_allclose((out - out[0]).numpy(), 0.0, atol=1e-5)


def test_graphcast_remat_is_bit_identical():
    _, _, _, cfg, p, b = setup("graphcast", seed=3)
    runs = [value_and_grad(lambda q, bb, r=r: graphcast.graphcast_loss(
        cfg, q, bb, remat=r))(p, b) for r in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])))
    with pytest.raises(ValueError, match="GraphCast"):
        cells.gnn_train_step("meshgraphnet", cfg, p, adamw_init(p), b,
                             remat=True)


@pytest.mark.parametrize("arch_id", ["meshgraphnet", "mace"])
def test_train_step_same_bits_twice(arch_id):
    _, _, _, cfg, p, b = setup(arch_id, seed=4)
    a = cells.gnn_train_step(arch_id, cfg, p, adamw_init(p), b)
    c = cells.gnn_train_step(arch_id, cfg, p, adamw_init(p), b.to("cpu"))
    assert torch.equal(a[2], c[2])
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a[0]), tree_leaves(c[0])))


def test_gnn_model_flops_is_repros():
    """`_gnn_cell`'s count at the published widths and the cells' sizes."""
    want = {}
    for arch_id in ARCHS:
        cfg = get_arch(arch_id).make_config()
        want[arch_id] = cells.gnn_model_flops(arch_id, cfg, 169984, 168960)
    d = 128
    assert want["meshgraphnet"] == 3.0 * 15 * (
        2 * (3 * d * d + d * d) * 168960 + 2 * (2 * d * d + d * d) * 169984)
    C, P = 128, 11
    assert want["mace"] == 3.0 * 2 * (
        (2 * (8 * 64 + 64 * C * P) + 2 * P * 81 * C) * 168960
        + (2 * 2 * P * 729 * C + 10 * C * C * 9) * 169984)
