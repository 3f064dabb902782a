"""The GNNs across ranks on the CPU: the port's sharded GNN train step
(`gnn_rules`: nodes and edges striped over every mesh axis, the
parameters replicated) held to the port's one process and to `repro`
under ``gnn_rules`` on 4 forced JAX host devices.

Each arch's smoke config on one batch: MeshGraphNet and GraphCast on
``rmat_graph(50, 200)`` with 100 masked edge slots at node 0 (a row of
more than ``RUN`` entries), NequIP and MACE on 4 molecules of 9 atoms and
19 edges.  Every batch is padded by `pad_graph_batch` to a multiple of 8
(the nodes 50 → 56 and 36 → 40, the edges 76 → 80 and 500 → 504), so the
8-rank case pads nodes and edges.  The weights are `repro`'s ``init_*``,
converted.  One spawn for each mesh (`_dist_ranks`): 4 gloo ranks on
(2, 2), then 8 on (2, 4), one torch thread each; `repro` runs once in a
subprocess on 4 forced host devices (a (2, 2) mesh), started before the
ranks and running beside them.

Gates (fp32): the loss within 1e-5 relative and each reduced gradient leaf
within 1e-4 of its max, of the one-process port and of `repro`; two runs
of the loss, the gradient and a train step give the same bits on every
rank; every rank's params after one step within 1e-4 of each leaf's max
of the one-process step's.  A control — each rank's node stripe taken
from the next rank, with its own edges — misses the gradient gate.
GraphCast with ``remat=True`` (each processor layer recomputed in the
backward) in the 4-rank spawn equals ``remat=False`` bit for bit on every
rank: the loss, the reduced gradient and the params after one step.

Host code: a padded batch's loss equals the unpadded one's; the plan of a
``meta`` index bounds a real plan on an index shaped like an
``ogb_products`` edge stripe at 256 devices; under `NO_SHARD` the sum and
the take are today's ordered pair, bit for bit.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _dist_ranks
from repro.configs import get_arch as get_arch_j
from repro.models.gnn import graphcast as gc_j
from repro.models.gnn import mace as mace_j
from repro.models.gnn import meshgraphnet as mgn_j
from repro.models.gnn import nequip as nq_j
from repro_torch.configs import get_arch
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.data.synthetic import (gnn_full_batch, molecule_batches,
                                        pad_graph_batch, with_geometry)
from repro_torch.dist.sharding import gnn_rules
from repro_torch.launch.cells import GNN_LOSSES, gnn_train_step
from repro_torch.launch.dryrun import StepMeter
from repro_torch.launch.mesh import MeshShape, RankView
from repro_torch.mesh.graphs import rmat_graph
from repro_torch.models.common import NO_SHARD, tree_leaves
from repro_torch.models.gnn import common
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import value_and_grad

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("meshgraphnet", "graphcast", "nequip", "mace")
INIT_J = {"meshgraphnet": mgn_j.init_mgn, "graphcast": gc_j.init_graphcast,
          "nequip": nq_j.init_nequip, "mace": mace_j.init_mace}
MESHES = {"2x2": (2, 2), "2x4": (2, 4)}
PAD_TO = 8
REPRO_DEVICES = 4
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-4
FIELDS = ("node_feat", "edge_src", "edge_dst", "node_mask", "edge_mask",
          "positions", "species", "graph_ids", "targets")

_REPRO = r"""
import numpy as np, jax
from jax.sharding import AxisType
from repro.configs import get_arch
from repro.dist.sharding import gnn_rules
from repro.models.gnn.common import GraphBatch
from repro.models.gnn.graphcast import graphcast_loss
from repro.models.gnn.mace import mace_loss
from repro.models.gnn.meshgraphnet import mgn_loss
from repro.models.gnn.nequip import nequip_loss

LOSS = {"meshgraphnet": mgn_loss, "graphcast": graphcast_loss,
        "nequip": nequip_loss, "mace": mace_loss}
FIELDS = ("node_feat", "edge_src", "edge_dst", "node_mask", "edge_mask",
          "positions", "species", "graph_ids", "targets")
z = np.load(IN)

def unflat(prefix):
    tree = {}
    for key in z.files:
        if key.startswith(prefix + "/"):
            node, parts = tree, key[len(prefix) + 1:].split("/")
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = jax.numpy.asarray(z[key])
    return tree

def flat(tree, prefix):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}

mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for arch in ARCHS:
    cfg = get_arch(arch).make_smoke_config()
    b = GraphBatch(**{f: (jax.numpy.asarray(z[f"{arch}/batch/{f}"])
                          if f"{arch}/batch/{f}" in z.files else None)
                      for f in FIELDS},
                   n_graphs=int(z[f"{arch}/n_graphs"]))
    rules = gnn_rules(mesh)
    with jax.set_mesh(mesh):
        loss, g = jax.jit(jax.value_and_grad(
            lambda q, bb: LOSS[arch](cfg, q, bb, rules)))(unflat(arch + "/p"), b)
    out[f"{arch}/loss"] = np.asarray(loss)
    out.update(flat(g, arch + "/grads"))
np.savez(OUT, **out)
print("OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def flat(tree, prefix=""):
    """A tree as {"a/b": leaf}."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{prefix}/{key}" if prefix
                                 else key).items()}
    return {prefix: tree}


def raw_batch(arch_id, cfg) -> common.GraphBatch:
    """The arch's batch before padding (see the module docstring)."""
    if arch_id in ("nequip", "mace"):
        return next(molecule_batches(4, 9, 19, seed=3))
    d_out = cfg.n_vars if arch_id == "graphcast" else cfg.d_out
    b = gnn_full_batch(rmat_graph(50, 200, seed=5), d_feat=cfg.d_in,
                       d_out=d_out, seed=1)
    z = torch.zeros(100, dtype=torch.int32)
    return dataclasses.replace(
        b, edge_src=torch.cat([b.edge_src, z]),
        edge_dst=torch.cat([b.edge_dst, z]),
        edge_mask=torch.cat([b.edge_mask, torch.zeros(100)]), plans={})


@pytest.fixture(scope="module")
def inputs():
    """Per arch: the smoke config, `repro`'s weights (NumPy), the port's,
    and the raw and padded batches."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = get_arch(arch).make_smoke_config()
        cfg_j = get_arch_j(arch).make_smoke_config()
        p_np = jax.tree_util.tree_map(np.asarray, INIT_J[arch](
            cfg_j, jax.random.PRNGKey(i)))
        raw = raw_batch(arch, cfg)
        out[arch] = dict(cfg=cfg, p_np=p_np,
                         p=gnn_params_from_numpy(arch, cfg, p_np,
                                                 device="cpu"),
                         raw=raw, batch=pad_graph_batch(raw, PAD_TO))
    return out


@pytest.fixture(scope="module")
def repro_run(inputs, tmp_path_factory):
    """`repro`'s loss and gradient under ``gnn_rules`` on 4 forced host
    devices, started in its own process while the ranks run."""
    d = tmp_path_factory.mktemp("repro_gnn")
    arrays = {}
    for arch, inp in inputs.items():
        arrays.update({f"{arch}/p/{k}": v
                       for k, v in flat(inp["p_np"]).items()})
        b = inp["batch"]
        arrays.update({f"{arch}/batch/{f}": getattr(b, f).numpy()
                       for f in FIELDS if getattr(b, f) is not None})
        arrays[f"{arch}/n_graphs"] = np.asarray(b.n_graphs)
    np.savez(d / "in.npz", **arrays)
    code = (f"IN = {str(d / 'in.npz')!r}\nOUT = {str(d / 'out.npz')!r}\n"
            f"ARCHS = {ARCHS!r}\n" + _REPRO)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{REPRO_DEVICES}")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, d / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(repro_run, inputs, tmp_path_factory):
    """Every rank's results, by mesh name then arch, one spawn a mesh."""
    out = {}
    for name, shape in MESHES.items():
        cases = {arch: ("case_gnn_step", dict(
            arch_id=arch, cfg=inp["cfg"], params=np_tree(inp["p"]),
            batch=inp["batch"], mesh_shape=shape, control=True))
            for arch, inp in inputs.items()}
        if name == "2x2":
            inp = inputs["graphcast"]
            cases["graphcast_remat"] = ("case_gnn_step", dict(
                arch_id="graphcast", cfg=inp["cfg"], params=np_tree(inp["p"]),
                batch=inp["batch"], mesh_shape=shape, remat=True))
        out[name] = _dist_ranks.run_ranks(
            _dist_ranks.run_cases, cases, shape[0] * shape[1],
            tmp_path_factory.mktemp(f"ranks_gnn_{name}"), timeout=600)
    return out


@pytest.fixture(scope="module")
def repro_out(repro_run, ranks):
    proc, path = repro_run
    out, err = proc.communicate(timeout=420)
    assert proc.returncode == 0 and "OK" in out, f"{out}\n{err}"
    return np.load(path)


@pytest.fixture(scope="module")
def one_process(inputs):
    """The port's one-process loss, gradient and train step (`NO_SHARD`)
    on each padded batch."""
    out = {}
    for arch, inp in inputs.items():
        cfg, p, b = inp["cfg"], inp["p"], inp["batch"]
        loss, g = value_and_grad(lambda q, bb: GNN_LOSSES[arch](
            cfg, q, bb))(p, b)
        new = gnn_train_step(arch, cfg, p, adamw_init(p), b)[0]
        out[arch] = dict(loss=float(loss), grads=flat(np_tree(g)),
                         params=flat(np_tree(new)))
    return out


def gap(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def grad_gaps(got: dict, want: dict) -> dict:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    return {k: gap(got[k], want[k]) for k in want}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_step_matches_one_process(mesh, arch, ranks, one_process):
    want = one_process[arch]
    for rk in ranks[mesh]:
        got = rk[arch]
        assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
        gaps = grad_gaps(flat(got["grads"]), want["grads"])
        assert max(gaps.values()) <= GRAD_TOL, gaps
        gaps = grad_gaps(flat(got["params"]), want["params"])
        assert max(gaps.values()) <= PARAM_TOL, gaps


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_loss_and_grads_match_repro(mesh, arch, ranks, repro_out):
    want_loss = float(repro_out[f"{arch}/loss"])
    prefix = f"{arch}/grads/"
    want = {k[len(prefix):]: repro_out[k] for k in repro_out.files
            if k.startswith(prefix)}
    for rk in ranks[mesh]:
        got = rk[arch]
        assert abs(got["loss"] - want_loss) <= LOSS_TOL * abs(want_loss)
        gaps = grad_gaps(flat(got["grads"]), want)
        assert max(gaps.values()) <= GRAD_TOL, gaps


@pytest.mark.parametrize("mesh", MESHES)
def test_two_runs_are_bit_identical(mesh, ranks, inputs):
    n = MESHES[mesh][0] * MESHES[mesh][1]
    for arch in ARCHS:
        rks = [rk[arch] for rk in ranks[mesh]]
        assert all(rk["repeat_equal"] for rk in rks), arch
        # every rank returns the global loss and the same reduced gradient
        assert len({rk["loss"] for rk in rks}) == 1, arch
        for rk in rks[1:]:
            for k, v in flat(rk["grads"]).items():
                np.testing.assert_array_equal(v, flat(rks[0]["grads"])[k])
        # each rank held its stripe, and the step moved data both ways
        b = inputs[arch]["batch"]
        assert {rk["n_local"] for rk in rks} == {b.n_nodes // n}
        assert {rk["e_local"] for rk in rks} == {b.edge_src.shape[0] // n}
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= \
            set(rks[0]["collectives"])


def test_graphcast_remat_is_bit_identical_across_ranks(ranks):
    """Recompute changes no bit of the sharded step on any rank."""
    for rk in ranks["2x2"]:
        plain, remat = rk["graphcast"], rk["graphcast_remat"]
        assert remat["loss"] == plain["loss"]
        for which in ("grads", "params"):
            want = flat(plain[which])
            for k, v in flat(remat[which]).items():
                np.testing.assert_array_equal(v, want[k], err_msg=k)
            assert sorted(flat(remat[which])) == sorted(want)
        assert remat["repeat_equal"]


@pytest.mark.parametrize("mesh", MESHES)
def test_shifted_node_stripes_miss_the_gate(mesh, ranks, one_process):
    """The control: a rank that reads the next rank's nodes with its own
    edges computes another gradient."""
    for arch in ARCHS:
        for rk in ranks[mesh]:
            gaps = grad_gaps(flat(rk[arch]["control_grads"]),
                             one_process[arch]["grads"])
            assert max(gaps.values()) > 100 * GRAD_TOL, (arch, gaps)


@pytest.mark.parametrize("arch", ARCHS)
def test_padding_keeps_the_loss(arch, inputs):
    inp = inputs[arch]
    raw, padded = inp["raw"], inp["batch"]
    assert padded.n_nodes % PAD_TO == 0 and padded.n_nodes > raw.n_nodes
    assert padded.edge_src.shape[0] % PAD_TO == 0 \
        and padded.edge_src.shape[0] > raw.edge_src.shape[0]
    assert float(padded.node_mask[raw.n_nodes:].abs().sum()) == 0.0
    assert int(padded.edge_dst[raw.edge_src.shape[0]:].abs().sum()) == 0
    with torch.no_grad():
        want = float(GNN_LOSSES[arch](inp["cfg"], inp["p"], raw))
        got = float(GNN_LOSSES[arch](inp["cfg"], inp["p"], padded))
    assert abs(got - want) <= LOSS_TOL * abs(want)


def test_with_geometry_draws_from_the_seed(inputs):
    b = inputs["meshgraphnet"]["raw"]
    g1, g2 = with_geometry(b, seed=7), with_geometry(b, seed=7)
    assert torch.equal(g1.positions, g2.positions)
    assert g1.positions.shape == (b.n_nodes, 3)
    assert not torch.equal(g1.positions, with_geometry(b, seed=8).positions)
    assert int(g1.species.abs().sum()) == int(g1.graph_ids.abs().sum()) == 0
    assert g1.n_graphs == 1 and g1.targets.shape == (1,)
    cfg = get_arch("nequip").make_smoke_config()
    p = inputs["nequip"]["p"]
    padded = pad_graph_batch(g1, PAD_TO)
    with torch.no_grad():
        want = float(GNN_LOSSES["nequip"](cfg, p, g1))
        got = float(GNN_LOSSES["nequip"](cfg, p, padded))
    assert np.isfinite(want) and abs(got - want) <= LOSS_TOL * abs(want)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

OGB_STRIPE = 241_637          # an ogb_products edge stripe at 256 devices
OGB_NODES = 2_449_029
OGB_PAD = 61_859_328 - 61_859_140    # the padded edge slots, at node 0


def _ordered_sum_bytes(plan, E, d=128):
    """The bytes the dry run counts through `ordered_sum` on (E, d) fp32
    values (`StepMeter`'s traffic: each op's inputs and outputs)."""
    values = torch.empty((E, d), device="meta")
    with StepMeter(memory=False, traffic=True) as meter:
        common.ordered_sum(values, plan)
    return meter.bytes


def test_meta_plan_bounds_a_real_plan():
    rng = np.random.default_rng(0)
    idx = np.concatenate([rng.integers(0, OGB_NODES, OGB_STRIPE - OGB_PAD),
                          np.zeros(OGB_PAD, np.int64)]).astype(np.int32)
    real = common.segment_plan(torch.from_numpy(idx), OGB_NODES)
    meta = common.segment_plan(torch.empty(OGB_STRIPE, dtype=torch.int32,
                                           device="meta"), OGB_NODES)
    assert real.long_rows is not None          # the padding's row 0
    assert {t.device.type for t in (meta.perm, meta.offsets, meta.take)} \
        == {"meta"}
    seg_real, seg_meta = real.offsets.numel() - 1, meta.offsets.numel() - 1
    assert seg_real <= seg_meta <= 1.05 * seg_real
    b_real = _ordered_sum_bytes(real.to("meta"), OGB_STRIPE)
    b_meta = _ordered_sum_bytes(meta, OGB_STRIPE)
    assert b_real <= b_meta <= 1.05 * b_real


@pytest.mark.parametrize("E, n, hub", [(5000, 300, 4000), (4000, 5000, 0),
                                       (33 * 40, 40, 0)])
def test_meta_plan_sizes_are_bounds(E, n, hub):
    """Every array of a meta plan is at least as long as a real plan's,
    for a hub, for rows of one, and for every row just over RUN."""
    rng = np.random.default_rng(1)
    if E == 33 * 40:
        idx = np.repeat(np.arange(40), 33)
    else:
        idx = np.concatenate([rng.integers(0, n, E - hub),
                              np.zeros(hub, np.int64)])
    real = common.segment_plan(idx.astype(np.int64), n)
    meta = common.segment_plan(torch.empty(E, device="meta"), n)
    assert meta.offsets.numel() >= real.offsets.numel()
    if real.first is not None:
        assert meta.take.numel() >= real.take.numel()
        assert meta.long_rows.numel() >= real.long_rows.numel()


def test_meta_batch_plans_are_meta_and_cached_apart():
    b = pad_graph_batch(raw_batch("meshgraphnet",
                                  get_arch("meshgraphnet")
                                  .make_smoke_config()), PAD_TO)
    rules = gnn_rules(RankView(MeshShape((2, 2), ("data", "model")), 1))
    one = b.plan("edge_dst")
    striped = b.plan("edge_dst", rules=rules)      # n: 4 × the rows
    assert one.n == b.n_nodes and striped.n == 4 * b.n_nodes
    same_n = b.plan("edge_dst", b.n_nodes, rules)
    assert same_n is not one and b.plan("edge_dst") is one
    meta = common.GraphBatch(**{
        f: None if getattr(b, f) is None else getattr(b, f).to("meta")
        for f in FIELDS}, n_graphs=b.n_graphs)
    plan = meta.plan("edge_src", rules=rules)
    assert plan.perm.device.type == "meta" and plan.n == 4 * b.n_nodes


def test_no_shard_sum_and_take_are_the_ordered_pair():
    rng = np.random.default_rng(2)
    idx = np.concatenate([rng.integers(0, 20, 200), np.zeros(80, np.int64)])
    v = torch.from_numpy(rng.normal(size=(280, 3)).astype(np.float32))
    plan = common.segment_plan(idx, 20)
    want = common.ordered_sum(v, plan)
    for got in (common.scatter_sum(v, plan, 20),
                common.scatter_sum(v, plan, 20, NO_SHARD)):
        assert torch.equal(got, want)
    x = torch.from_numpy(rng.normal(size=(20, 3)).astype(np.float32))
    x.requires_grad_()
    (g,) = torch.autograd.grad((common.gather(
        common.node_table(x, NO_SHARD), plan) * v).sum(), x)
    assert torch.equal(g, want)
    assert common.global_rows(7, NO_SHARD) == 7
    assert common.node_entry(NO_SHARD) is None
    loss = torch.tensor(2.0, requires_grad=True)
    assert common.loss_share(loss, NO_SHARD) is loss


def test_gnn_cell_on_one_device_runs_the_one_process_step():
    """A one-device mesh is the one-process step, as a card runs it."""
    from repro_torch.launch.cells import build_cell

    cell = build_cell("nequip", "molecule", MeshShape((1, 1),
                                                      ("data", "model")))
    assert callable(cell.fn)
    params, opt, batch = cell.abstract_args
    assert batch.n_nodes == 128 * 30 and batch.node_mask.device.type == "meta"
    new, _, loss = cell.fn(*cell.abstract_args)
    assert loss.shape == () and loss.device.type == "meta"
    assert [t.shape for t in tree_leaves(new)] == \
        [t.shape for t in tree_leaves(params)]
