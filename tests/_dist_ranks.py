"""Run a function on every rank of a fresh `torch.distributed` group.

The port's distributed tests spawn their ranks here: one process a rank
(the ``spawn`` start method, never fork), one torch thread each, a
``file://`` rendezvous under the test's temporary directory (no fixed
port: several test workers share the machine).  Each rank pickles what its
task returns into that directory, and :func:`run_ranks` returns the list
in rank order; a rank that raises, dies or outlives the timeout fails the
call and the other ranks are stopped.

Imports no JAX: the card tests use it too.
"""

from __future__ import annotations

import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, backend, workdir, task, payload):
    torch.set_num_threads(1)
    if backend == "nccl":       # NCCL takes the current device
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{workdir}/rdv",
                            rank=rank, world_size=world)
    try:
        out = task(rank, payload)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        from repro_torch.dist import group as dist_group

        dist_group.destroy()


def run_ranks(task, payload, world: int, workdir, *, backend: str = "gloo",
              timeout: float = 300.0) -> list:
    """``[task(rank, payload) for every rank]``, each in its own process of
    one ``world``-rank group.  ``task`` must be importable by name."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, backend, str(workdir),
                                           task, payload),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# The ranks' side of the tests: `run_cases` runs a dict of named cases, each
# ``(case function name, kwargs)``, and returns their results by name.
# ---------------------------------------------------------------------------

def run_cases(rank, cases: dict) -> dict:
    return {name: globals()[fn](**kw) for name, (fn, kw) in cases.items()}


def case_matvec(graph, parts, nparts, x, device="cpu"):
    from repro_torch.dist import adjacency_matvec_distributed, plan_halo_sharding

    plan = plan_halo_sharding(graph, parts, nparts)
    return adjacency_matvec_distributed(plan, None, x, device=device)


def case_sweep(graph, parts, nparts, weights, corridor, sweeps=10,
               device="cpu", max_devices=None):
    """The sweep across the default group, traced: labels, moves and cuts
    per sweep, info, and this rank's counters and K4 launches."""
    from repro_torch import obs
    from repro_torch.dist import build_frontier_plan, run_sharded_sweeps
    from repro_torch.kernels.segment_sum import cuda as ss_cuda

    fp = build_frontier_plan(graph, parts, nparts, weights=weights)
    before = ss_cuda.BATCHED_LAUNCHES
    with obs.trace("sweeps") as root:
        out, rec, info = run_sharded_sweeps(
            fp, parts, nparts, sweeps=sweeps, corridor=corridor,
            device=device, max_devices=max_devices)
    return dict(labels=out, moves=[r.moves for r in rec],
                cuts=[(r.cut_before, r.cut_after) for r in rec],
                info={k: v for k, v in info.items() if not k.endswith("_seconds")},
                counters=root.total_counters(),
                k4=ss_cuda.BATCHED_LAUNCHES - before)


def case_gs(gid, x, deg, n_global, device="cpu"):
    """This rank's block of the distributed GS Laplacian apply."""
    from repro_torch.dist import dist_lap_apply_allreduce

    r, n = dist.get_rank(), dist.get_world_size()
    rows = slice(r * len(x) // n, (r + 1) * len(x) // n)
    y = dist_lap_apply_allreduce(
        torch.from_numpy(gid[rows]).to(device),
        torch.from_numpy(x[rows]).to(device),
        torch.from_numpy(deg[rows]).to(device), n_global, None)
    return y.cpu().numpy()


def case_ring(xs, device="cpu"):
    """``ring_allreduce`` and ``all_reduce`` of this rank's row of ``xs``."""
    from repro_torch.dist import ring_allreduce
    from repro_torch.dist import group as dist_group

    x = torch.from_numpy(xs[dist.get_rank()]).to(device)
    return (ring_allreduce(x, None).cpu().numpy(),
            dist_group.all_reduce_sum(x, dist.group.WORLD).cpu().numpy())


def case_post_chain(graph, raw, nparts, weights, post, post_kw,
                    device="cpu"):
    """`run_post_stages` across the default group: labels, the sweeps'
    moves, and this rank's counters and K4 launches."""
    from repro_torch import obs
    from repro_torch.core.pipeline import run_post_stages
    from repro_torch.kernels.segment_sum import cuda as ss_cuda

    before = ss_cuda.BATCHED_LAUNCHES
    with obs.trace("chain") as root:
        parts, agg, records = run_post_stages(graph, raw, nparts, post,
                                              weights=weights,
                                              post_kw=post_kw, device=device)
    return dict(labels=parts, moves=[s.moves for s in agg.sweeps],
                counters=root.total_counters(),
                k4=ss_cuda.BATCHED_LAUNCHES - before,
                stages=[r.info["stages"] for r in records])


def case_compressed_psum(xs):
    """`compressed_psum` of this rank's row of ``xs`` across the default
    group."""
    from repro_torch.train.grad_compression import compressed_psum

    x = torch.from_numpy(xs[dist.get_rank()])
    return compressed_psum(x, dist.group.WORLD).numpy()


def case_halo_graphcast(cfg, params, plan, feat, tgt, device="cpu"):
    """The halo GraphCast across the default group, rank r on shard r:
    this rank's forward block, and without and with recompute the loss
    and the parameter gradients summed over the ranks (NumPy trees)."""
    from repro_torch.convert import gnn_params_from_numpy, gnn_params_to_numpy
    from repro_torch.dist import group as dist_group
    from repro_torch.models.common import tree_map
    from repro_torch.models.gnn.halo import (graphcast_halo_local,
                                             graphcast_halo_loss,
                                             halo_batch_from_plan)
    from repro_torch.train.train_loop import value_and_grad

    b = halo_batch_from_plan(plan, feat, tgt, device=device).shard(
        dist.get_rank())
    p = gnn_params_from_numpy("graphcast", cfg, params, device=device)
    with torch.no_grad():
        pred = graphcast_halo_local(cfg, p, b)
    out = dict(pred=pred.cpu().numpy())
    for remat in (False, True):
        loss, grads = value_and_grad(lambda q, bb: graphcast_halo_loss(
            cfg, q, bb, remat=remat))(p, b)
        grads = tree_map(
            lambda g: dist_group.all_reduce_sum(g, dist.group.WORLD), grads)
        out["remat" if remat else "plain"] = dict(
            loss=float(loss), grads=gnn_params_to_numpy(grads))
    return out


# ---------------------------------------------------------------------------
# Sharding (tests/test_torch_moe_ep.py, tests/test_torch_tp.py): each case
# lays a DeviceMesh over the group and returns NumPy trees.
# ---------------------------------------------------------------------------

def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def case_moe_ep(moe_kw, params, x, pspec, x_specs, mesh_shape):
    """`moe_apply_shardmap` on this rank's block of ``x`` under each of
    ``x_specs`` (name → spec), the weights placed by ``pspec``."""
    from repro_torch.dist.sharding import Spec, lm_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import MoEConfig, moe_apply_shardmap

    rules = lm_rules(make_mesh(mesh_shape, ("data", "model")))
    moe = MoEConfig(**moe_kw)
    p = {k: rules.local(torch.from_numpy(v), Spec(*pspec[k]))
         for k, v in params.items()}
    out = {}
    for name, spec in x_specs.items():
        xl = rules.local(torch.from_numpy(x), Spec(*spec))
        y = moe_apply_shardmap(moe, p, xl, data_axes="data",
                               model_axis="model", dtype=torch.float32,
                               rules=rules)
        out[name] = y.numpy()
    return dict(coords=rules.coords, y=out)


def case_lm_step(cfg, params, batch, mesh_shape, steps=1, grads=False,
                 serve=None):
    """On a (data, model) mesh of ``mesh_shape`` under `lm_rules` (sequence
    parallel): the params placed by `param_specs_lm`; ``steps`` sharded
    `lm_train_step`s (their losses and this rank's params after each;
    whether the first step run twice gave the same bits); with ``grads``,
    `loss_fn`'s value and this rank's reduced gradient slices first, and
    again under ``lm_rules(seq_shard=False)`` (``nosp_loss``,
    ``nosp_grads``); with ``serve`` = (prompt tokens, steps), a sharded
    `Transformer`'s prefill and greedy decode logits (every rank's batch:
    the data axis is 1)."""
    from repro_torch.dist.sharding import lm_rules, param_specs_lm, reduce_grads
    from repro_torch.launch.cells import lm_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train.checkpoint import reshard
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import value_and_grad

    rules = lm_rules(make_mesh(mesh_shape, ("data", "model")))
    full = _torch_tree(params)
    specs = param_specs_lm(cfg, full, rules.mesh)
    p = reshard(full, rules.mesh, specs, device="cpu")
    b = _torch_tree(batch)
    out = dict(coords=rules.coords)
    if grads:
        from repro_torch.launch.cells import _rows

        nosp = lm_rules(rules.mesh, seq_shard=False)
        for key, r in (("", rules), ("nosp_", nosp)):
            loss, g = value_and_grad(lambda q, bb: T.loss_fn(cfg, q, bb,
                                                             rules=r))(
                p, _rows(r, b))
            out[key + "loss"] = float(loss)
            out[key + "grads"] = _numpy_tree(reduce_grads(g, specs, r))
    opt = adamw_init(p)
    again = lm_train_step(cfg, p, opt, b, rules=rules)[0]
    losses, trees = [], []
    for _ in range(steps):
        p, opt, loss = lm_train_step(cfg, p, opt, b, rules=rules)
        losses.append(float(loss))
        trees.append(_numpy_tree(p))
    out["losses"], out["params"] = losses, trees
    out["repeat_equal"] = all(
        np.array_equal(x, y) for x, y in zip(
            _leaves(_numpy_tree(again)), _leaves(trees[0])))
    if serve is not None:
        prompt, n = serve
        model = T.Transformer(cfg, full, rules)
        tok = torch.from_numpy(prompt)
        with torch.no_grad():
            logits, cache = T.prefill(model, tok, T.init_cache(
                cfg, tok.shape[0], tok.shape[1] + n, rules=rules))
            seq = [logits]
            for i in range(n):
                nxt = seq[-1][:, -1].argmax(-1, keepdim=True)
                logits, cache = T.decode_step(model, cache, nxt,
                                              tok.shape[1] + i)
                seq.append(logits)
        out["serve"] = torch.cat(seq, 1).numpy()
    return out


def case_moe_pjit(cfg, params, x, x_specs, mesh_shape, control=True):
    """`repro`'s pjit MoE layer across the ranks: `_moe_pjit_block` under
    `lm_rules` on this rank's block of ``x`` under each of ``x_specs``
    (name → spec; a spec that splits the sequence over ``model`` is the
    residual stream's SP layout, the block's ``seq``), the layer's MoE
    weights placed by the rules' specs (experts over ``model``, their
    ``d`` over ``data``).  With ``control``, the per-rank capacity of
    expert parallelism (`_moe_shardmap_block`) on the same blocks."""
    from repro_torch.dist.sharding import Spec, lm_rules, tree_specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T

    rules = lm_rules(make_mesh(mesh_shape, ("data", "model")))
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    specs = tree_specs(rules, {"moe": full}, layer=True)["moe"]
    p = {k: rules.local(v, specs[k]) for k, v in full.items()}
    out = dict(coords=rules.coords, y={}, control={})
    with torch.no_grad():
        for name, spec in x_specs.items():
            spec = Spec(*spec)
            xl = rules.local(torch.from_numpy(x), spec)
            out["y"][name] = T._moe_pjit_block(cfg, p, xl, rules,
                                               seq=spec[1]).numpy()
            if control:
                out["control"][name] = T._moe_shardmap_block(
                    cfg, p, xl, rules).numpy()
    return out


def case_stream_rows(cfg, params, tokens, mesh_shape):
    """The rows (the sequence dim) of the residual stream entering and
    leaving each layer on this rank of a (data, model) mesh: the training
    forward under `lm_rules` with ``seq_shard`` on and off, and a sharded
    `Transformer`'s prefill and first decode step (``seq_shard`` on)."""
    from repro_torch.dist.sharding import lm_rules, param_specs_lm
    from repro_torch.launch.cells import _rows
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train.checkpoint import reshard

    mesh = make_mesh(mesh_shape, ("data", "model"))
    full = _torch_tree(params)
    p = reshard(full, mesh, param_specs_lm(cfg, full, mesh), device="cpu")
    tok = torch.from_numpy(tokens)
    seen, layer = [], T._layer

    def spy(*args, **kw):
        seen.append(args[2].shape[1])
        out = layer(*args, **kw)
        seen.append(out[0].shape[1])
        return out

    out = {}
    T._layer = spy
    try:
        with torch.no_grad():
            for key, sp in (("train", True), ("train_nosp", False)):
                rules = lm_rules(mesh, seq_shard=sp)
                T.forward(cfg, p, _rows(rules, {"tokens": tok})["tokens"],
                          rules=rules)
                out[key], seen[:] = list(seen), []
            rules = lm_rules(mesh)
            model = T.Transformer(cfg, full, rules)
            mine = _rows(rules, {"tokens": tok})["tokens"]
            B, S = mine.shape
            cache = T.init_cache(cfg, B * mesh_shape[0], S + 1, rules=rules)
            logits, cache = T.prefill(model, mine, cache)
            out["prefill"], seen[:] = list(seen), []
            T.decode_step(model, cache, logits[:, -1].argmax(-1)[:, None], S)
            out["decode"] = list(seen)
    finally:
        T._layer = layer
    return out


def case_gnn_step(arch_id, cfg, params, batch, mesh_shape, control=False,
                  remat=False):
    """One GNN arch under `gnn_rules` on a (data, model) mesh of
    ``mesh_shape``: this rank's stripe of the whole (padded) ``batch``
    (`launch.cells.stripe`), the loss and the reduced gradient (NumPy
    trees), the params after one `gnn_train_step`, whether a second run
    of both gave the same bits, and the collectives it ran.  With
    ``control``, each rank also takes the next rank's node stripe with its
    own edges (a wrong layout, whose gradient must miss); ``remat``
    (GraphCast) recomputes each processor layer in the backward."""
    import dataclasses

    from repro_torch.dist import group as dist_group
    from repro_torch.dist.sharding import gnn_rules, reduce_grads
    from repro_torch.launch.cells import (GNN_LOSSES, _replicated,
                                          gnn_train_step, stripe)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import value_and_grad

    rules = gnn_rules(make_mesh(mesh_shape, ("data", "model")))
    p = _torch_tree(params)
    mine = stripe(batch, rules)

    kw = {"remat": True} if remat else {}

    def grads_of(b):
        loss, g = value_and_grad(lambda q, bb: GNN_LOSSES[arch_id](
            cfg, q, bb, rules, **kw))(p, b)
        return float(loss), _numpy_tree(reduce_grads(g, _replicated(g), rules))

    def run():
        with dist_group.census() as cen:
            loss, g = grads_of(mine)
        new = gnn_train_step(arch_id, cfg, p, adamw_init(p), mine,
                             rules=rules, **kw)[0]
        return loss, g, _numpy_tree(new), cen.records

    loss, g, new, records = run()
    loss2, g2, new2, _ = run()
    out = dict(coords=rules.coords, loss=loss, grads=g, params=new,
               n_local=mine.n_nodes, e_local=int(mine.edge_src.shape[0]),
               collectives=sorted({r[0] for r in records}))
    out["repeat_equal"] = loss2 == loss and all(
        np.array_equal(x, y) for x, y in zip(_leaves(g) + _leaves(new),
                                             _leaves(g2) + _leaves(new2)))
    if control:
        r, n = dist.get_rank(), dist.get_world_size()
        shifted = stripe(batch, rules, (r + 1) % n)
        nodes = [f for f in _NODE_FIELDS if getattr(shifted, f) is not None]
        if batch.targets.dim() > 1:            # node targets move with them
            nodes.append("targets")
        out["control_grads"] = grads_of(dataclasses.replace(
            mine, **{f: getattr(shifted, f) for f in nodes}, plans={}))[1]
    return out


def case_stripe_sum(index, values, n, device="cpu"):
    """`scatter_sum` and the take's backward under `gnn_rules` on a mesh
    of every rank along ``model`` (the ranks' edge stripes of ``values``
    and ``index``; this rank's node stripe back), beside the one-process
    sum of this rank's edges: (sharded, one-process, the sharded take's
    gradient), NumPy."""
    from repro_torch.dist.sharding import Spec, gnn_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.gnn.common import (gather, node_table,
                                               scatter_sum, segment_plan)

    rules = gnn_rules(make_mesh((1, dist.get_world_size()),
                                ("data", "model")))
    rows = Spec(("data", "model"))
    idx = rules.local(torch.from_numpy(index), rows).to(device)
    v = rules.local(torch.from_numpy(values), rows).to(device)
    plan = segment_plan(idx, n)
    got = scatter_sum(v, plan, n, rules)
    one = scatter_sum(v, plan, n)
    x = torch.zeros((n // dist.get_world_size(),) + tuple(v.shape[1:]),
                    device=device, requires_grad=True)
    (g,) = torch.autograd.grad((gather(node_table(x, rules), plan)
                                * v).sum(), x)
    return got.cpu().numpy(), one.cpu().numpy(), g.cpu().numpy()


_NODE_FIELDS = ("node_feat", "node_mask", "positions", "species",
                "graph_ids")


def case_reshard(tree, save_shape, load_shape, spec, workdir):
    """A tree placed on a (data, model) mesh of ``save_shape`` under
    ``spec`` (per leaf), gathered and saved by rank 0; every rank waits,
    then restores it onto ``load_shape``.  Returns this rank's block and
    the file's step."""
    from repro_torch.dist.sharding import Spec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.checkpoint import (load_checkpoint, reshard,
                                              save_checkpoint, unshard)

    specs = {k: Spec(*v) for k, v in spec.items()}
    full = _torch_tree(tree)
    mesh = make_mesh(save_shape, ("data", "model"))
    placed = reshard(full, mesh, specs, device="cpu")
    gathered = unshard(placed, mesh, specs)
    if dist.get_rank() == 0:
        save_checkpoint(workdir, 7, gathered)
    dist.barrier()
    step, restored, _ = load_checkpoint(f"{workdir}/ckpt_00000007.npz", full)
    mesh2 = make_mesh(load_shape, ("data", "model"))
    back = reshard(restored, mesh2, specs, device="cpu")
    coords = dict(zip(mesh2.mesh_dim_names, mesh2.get_coordinate()))
    return dict(step=step, coords=coords,
                placed={k: v.numpy() for k, v in placed.items()},
                back={k: v.numpy() for k, v in back.items()})


def case_meshes():
    """`make_debug_mesh` over every rank, and `make_mesh`'s refusal of a
    shape the group does not fill."""
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh

    mesh = make_debug_mesh(axis="model")
    try:
        make_mesh((3, 2), ("data", "model"))
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(names=mesh.mesh_dim_names, shape=tuple(mesh.mesh.shape),
                coord=mesh.get_coordinate(), refused=refused)


def case_lm_census(cfg, params, batch, mesh_shape):
    """One sharded `lm_train_step` on a (data, model) mesh of
    ``mesh_shape`` under `FlopCounterMode` and the collective census:
    this rank's coordinates, FLOPs and census records."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import group as dist_group
    from repro_torch.dist.sharding import lm_rules, param_specs_lm
    from repro_torch.launch.cells import lm_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.checkpoint import reshard
    from repro_torch.train.optimizer import adamw_init

    rules = lm_rules(make_mesh(mesh_shape, ("data", "model")))
    full = _torch_tree(params)
    p = reshard(full, rules.mesh, param_specs_lm(cfg, full, rules.mesh),
                device="cpu")
    opt = adamw_init(p)
    with dist_group.census() as cen, FlopCounterMode(display=False) as fc:
        lm_train_step(cfg, p, opt, _torch_tree(batch), rules=rules)
    return dict(coords=rules.coords, flops=fc.get_total_flops(),
                records=cen.records)


def case_recsys(cfg, params, batch, seq, cand, mesh_shape, k, n_cat_chunks,
                user_chunk, steps=2):
    """SASRec on a (data, model) mesh of ``mesh_shape`` under
    `recsys_rules`, ``params`` placed by `param_specs_recsys`: this rank's
    user states, streamed top-k and block of retrieval scores; the loss and
    this rank's reduced gradient slices; ``steps`` `recsys_train_step`s
    (losses and this rank's params after each) and whether the first step
    run twice gave the same bits."""
    from repro_torch.dist.sharding import (Spec, param_specs_recsys,
                                           recsys_rules, reduce_grads)
    from repro_torch.launch.cells import (recsys_retrieval,
                                          recsys_serve_topk,
                                          recsys_train_step)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.recsys.sasrec import SASRec, sasrec_train_loss
    from repro_torch.train.checkpoint import reshard
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import value_and_grad

    rules = recsys_rules(make_mesh(mesh_shape, ("data", "model")))
    full = _torch_tree(params)
    specs = param_specs_recsys(cfg, full, rules.mesh)
    p = reshard(full, rules.mesh, specs, device="cpu")
    users = Spec("data", None)
    seq_t = torch.from_numpy(seq)
    mine = rules.local(seq_t, users)
    model = SASRec(cfg, p)
    out = dict(coords=rules.coords)
    with torch.no_grad():
        out["states"] = model.user_state(mine, rules).numpy()
        v, i = recsys_serve_topk(cfg, model, mine, k, n_cat_chunks,
                                 user_chunk, rules=rules)
        out["topk"] = (v.numpy(), i.numpy())
        out["scores"] = recsys_retrieval(
            cfg, model, seq_t, rules.local(torch.from_numpy(cand),
                                           Spec("model")),
            rules=rules).numpy()
    b = _torch_tree(batch)
    rows = {key: rules.local(x, users) for key, x in b.items()}
    loss, g = value_and_grad(lambda q, bb: sasrec_train_loss(
        cfg, q, bb, rules=rules))(p, rows)
    out["loss"] = float(loss)
    out["grads"] = _numpy_tree(reduce_grads(g, specs, rules))
    opt = adamw_init(p)
    again = recsys_train_step(cfg, p, opt, b, rules=rules)
    losses, trees = [], []
    q = p
    for _ in range(steps):
        q, opt, loss = recsys_train_step(cfg, q, opt, b, rules=rules)
        losses.append(float(loss))
        trees.append(_numpy_tree(q))
    out["losses"], out["params"] = losses, trees
    out["repeat_equal"] = float(again[2]) == losses[0] and all(
        np.array_equal(x, y) for x, y in zip(
            _leaves(_numpy_tree(again[0])), _leaves(trees[0])))
    return out


def case_recsys_census(cfg, params, batch, seq, mesh_shape, local_chunk):
    """One sharded `recsys_train_step` and one `recsys_serve_topk` (top-100,
    this rank's users in chunks of ``local_chunk``) on a (data, model) mesh
    of ``mesh_shape``, each under `FlopCounterMode` and the collective
    census: this rank's coordinates, FLOPs and census records by step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import group as dist_group
    from repro_torch.dist.sharding import (Spec, param_specs_recsys,
                                           recsys_rules)
    from repro_torch.launch.cells import recsys_serve_topk, recsys_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.recsys.sasrec import SASRec
    from repro_torch.train.checkpoint import reshard
    from repro_torch.train.optimizer import adamw_init

    rules = recsys_rules(make_mesh(mesh_shape, ("data", "model")))
    full = _torch_tree(params)
    p = reshard(full, rules.mesh, param_specs_recsys(cfg, full, rules.mesh),
                device="cpu")
    out = dict(coords=rules.coords)
    with dist_group.census() as cen, FlopCounterMode(display=False) as fc:
        recsys_train_step(cfg, p, adamw_init(p), _torch_tree(batch),
                          rules=rules)
    out["train"] = dict(flops=fc.get_total_flops(), records=cen.records)
    mine = rules.local(torch.from_numpy(seq), Spec("data", None))
    with torch.no_grad(), dist_group.census() as cen, \
            FlopCounterMode(display=False) as fc:
        recsys_serve_topk(cfg, SASRec(cfg, p), mine, k=100,
                          user_chunk=local_chunk, rules=rules)
    out["serve"] = dict(flops=fc.get_total_flops(), records=cen.records)
    return out
