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
        dist.destroy_process_group()


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
