"""Production dry run: every (arch × shape) cell on the production meshes,
on ``meta`` tensors, with no ranks and no card.

Port of `repro.launch.dryrun`, whose two compiles per cell become two
runs of the port's own step (`launch.cells.build_cell`) as rank 0 of the
mesh (`launch.mesh.RankView`; its collectives are `AbstractGroup`s,
which answer with ``meta`` tensors and report to the census):

* EXEC pass — the step at full depth under a `StepMeter` that follows
  every storage's life: `repro`'s ``memory_analysis`` fields, the peak of
  live bytes the measured fact (arguments included; recompute, the
  functional AdamW's old and new trees, the caches, as the eager step
  holds them).  Donated arguments (`Cell.donate`) are reported as
  ``alias_bytes``; an eager step holds its arguments until it returns,
  so they do not lower the peak.
* PROFILE pass — FLOPs by `torch.utils.flop_counter.FlopCounterMode`,
  bytes accessed as each op's input and output bytes (views move none;
  K5, K6 and K6's backward count the rows their tile loops read,
  `kernel_bytes`), and the census of collectives
  (`repro_torch.dist.group.census`).  K5, K6 and K6's backward are custom
  operators with a ``meta`` shape rule and a FLOP formula of the kernel's
  work, so the run counts what the card runs, the tiles K6 skips left
  out.  Deep models (> ``PROFILE_CAP`` layers) use `repro`'s
  layer differencing: Q(n) = Q(2) + (n−2)·(Q(4)−Q(2))/2, exact because
  the layers are identical.

The roofline (`launch.roofline`) is on the H100 SXM5's constants, each
collective at the slowest link its group crosses; the step's bound is
`roofline.step_bound` of the ops' own rooflines summed (``op_s``) and the
collective term, written with each cell (``op_s``, ``bound_s``).  A cell
that raises is written with ``status: "fail"``.

Usage:
    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out runs/dryrun_torch
Each cell writes <out>/<arch>__<shape>__<mesh>.json (skips:
<arch>__<shape>__skip.json).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import all_cells, get_arch
from repro_torch.dist import group as dist_group
from repro_torch.kernels.embedding_bag import ops as k5_ops
from repro_torch.kernels.flash_attention import ops as k6_ops
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import axis_sizes, make_production_mesh
from repro_torch.launch.roofline import (COLLECTIVES, HBM_BW, PEAK_FLOPS,
                                         CollectiveStats, collective_seconds,
                                         collective_stats, from_counts,
                                         step_bound)

PROFILE_CAP = 6   # run the full depth up to this many layers; layer-diff beyond
DEVICE_BYTES = 80e9          # an H100 SXM5's HBM3

MESHES = {"pod": [False], "multi": [True], "both": [False, True]}


def mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


# ops that move no bytes: metadata, allocation without a write
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like,
               torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided, torch.ops.aten.detach,
               torch.ops.aten.alias, torch.ops.aten.lift_fresh,
               torch.ops.aten._local_scalar_dense}
# the kernels' own traffic, in place of their inputs' whole size
_KERNEL_BYTES = {torch.ops.repro_torch.flash_attention: k6_ops.kernel_bytes,
                 torch.ops.repro_torch.flash_attention_lse:
                     k6_ops.kernel_bytes_lse,
                 torch.ops.repro_torch.flash_attention_backward:
                     k6_ops.backward_bytes,
                 torch.ops.repro_torch.embedding_bag: k5_ops.kernel_bytes}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepMeter(TorchDispatchMode):
    """Counts of the ops run under it: with ``memory``, the bytes of every
    live storage an op made (one storage counted once, its views free;
    freed when its last tensor dies) and their peak; with ``traffic``, the bytes each op
    reads and writes (its tensor inputs and outputs; views and
    allocations none; K5 and K6 their `kernel_bytes`), and ``op_s``: each
    op's own roofline, the larger of its FLOPs (`FlopCounterMode`'s
    formulas) over the peak and its bytes over HBM's rate, summed over the
    ops — the least time the step could take with its ops run one after
    another, as an eager step runs them on one stream."""

    def __init__(self, *, memory: bool = True, traffic: bool = False):
        super().__init__()
        self.memory, self.traffic = memory, traffic
        self.live = self.peak = 0
        self.bytes = 0
        self.op_s = 0.0
        self._flops = FlopCounterMode().flop_registry if traffic else {}
        self._held: dict = {}

    def _free(self, key: int, n: int) -> None:
        self._held.pop(key, None)
        self.live -= n

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live (the
        arguments); returns the bytes of those not yet counted."""
        new = 0
        for t in _tensors(tree):
            s = t.untyped_storage()
            key = id(s)
            if key in self._held:
                continue
            n = s.nbytes()
            self._held[key] = weakref.finalize(s, self._free, key, n)
            self.live += n
            new += n
        self.peak = max(self.peak, self.live)
        return new

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.traffic:
            packet = func._overloadpacket
            n = 0
            if packet in _KERNEL_BYTES:
                n = _KERNEL_BYTES[packet](*args)
            elif not func.is_view and packet not in _NO_TRAFFIC:
                n = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
                    + sum(_nbytes(t) for t in _tensors(out))
            flops = self._flops[packet](*args, **kwargs, out_val=out) \
                if packet in self._flops else 0
            self.bytes += n
            self.op_s += max(flops / PEAK_FLOPS, n / HBM_BW)
        if self.memory and not func.is_view:
            self.hold(out)    # a view's storage is its base's
        return out


def _unique_bytes(tree) -> int:
    seen, total = set(), 0
    for t in _tensors(tree):
        s = t.untyped_storage()
        if id(s) not in seen:
            seen.add(id(s))
            total += s.nbytes()
    return total


def exec_pass(cell) -> dict:
    """The step at full depth under a `StepMeter`: `repro`'s
    ``memory_analysis`` fields.  ``peak_bytes`` is the high-water mark of
    live storages, arguments included; ``temp_bytes`` what the step held
    above its arguments at that mark."""
    args = cell.abstract_args
    donated = [args[i] for i in cell.donate()]
    with StepMeter(memory=True) as meter:
        arg_bytes = meter.hold(args)
        out = cell.fn(*args)
        out_bytes = _unique_bytes(out)
        peak = meter.peak
    return {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": peak - arg_bytes, "peak_bytes": peak,
            "alias_bytes": _unique_bytes(donated)}


def profile_census(cell, mesh) -> dict:
    """FLOPs, bytes accessed and the census of one run of the step."""
    with dist_group.census() as cen, \
            FlopCounterMode(display=False) as flops, \
            StepMeter(memory=False, traffic=True) as meter:
        cell.fn(*cell.abstract_args)
    stats = collective_stats(cen.records)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(meter.bytes), "op_s": meter.op_s,
            "wire": stats.total_wire_bytes,
            "per_op": dict(stats.per_op), "counts": dict(stats.counts),
            "collective_s": collective_seconds(cen.records, mesh),
            "records": cen.records}


def _n_layers_of(arch_id: str) -> int | None:
    return getattr(get_arch(arch_id).make_config(), "n_layers", None)


def _lerp(q2: float, q4: float, L: int) -> float:
    return q2 + (q4 - q2) / 2.0 * (L - 2)


def layer_diff(qs: dict, L: int) -> dict:
    """Q(L) from the depth-2 and depth-4 censuses (`repro`'s formula)."""
    out = {k: _lerp(qs[2][k], qs[4][k], L)
           for k in ("flops", "bytes", "wire", "collective_s", "op_s")}
    out["per_op"] = {k: _lerp(qs[2]["per_op"][k], qs[4]["per_op"][k], L)
                     for k in COLLECTIVES}
    out["counts"] = {k: int(round(_lerp(qs[2]["counts"][k],
                                        qs[4]["counts"][k], L)))
                     for k in COLLECTIVES}
    return out


def profile_depth(make, L: int | None, mesh) -> tuple[dict, dict]:
    """The census of a step ``L`` layers deep: run at that depth up to
    ``PROFILE_CAP``, else by layer differencing of depths 2 and 4.
    ``make(n)`` builds the cell at depth ``n`` (None: its own)."""
    if L is None or L <= PROFILE_CAP:
        return profile_census(make(None), mesh), {
            "profile_method": "unrolled-full"}
    qs = {n: profile_census(make(n), mesh) for n in (2, 4)}
    return layer_diff(qs, L), {"profile_method": f"layer-diff(2,4)->L={L}"}


def _profile(arch_id, shape_name, mesh, **kw):
    return profile_depth(lambda n: build_cell(arch_id, shape_name, mesh,
                                              n_layers=n, **kw),
                         _n_layers_of(arch_id), mesh)


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True, profile: bool = True,
             moe_impl: str | None = None) -> dict:
    """One cell's record (`repro`'s keys; ``fits_80gb`` for the H100,
    ``op_s`` and ``bound_s`` for the eager step's bound).
    The MoE runs as its config says (``"pjit"``, the published default),
    or as ``moe_impl`` (``"shardmap"``: expert parallelism)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = math.prod(axis_sizes(mesh).values())
    tag = mesh_tag(multi_pod)
    kw = {"moe_impl": moe_impl} if moe_impl else {}
    t0 = time.perf_counter()
    cell = build_cell(arch_id, shape_name, mesh, **kw)
    mem = exec_pass(cell)
    t_exec = time.perf_counter() - t0
    live = mem["peak_bytes"]
    t1 = time.perf_counter()
    if profile:
        census, pmeta = _profile(arch_id, shape_name, mesh, **kw)
    else:
        census = profile_census(cell, mesh)
        pmeta = {"profile_method": "exec-full"}
    t_prof = time.perf_counter() - t1
    rl = from_counts(census["flops"], census["bytes"], census["wire"],
                     census["collective_s"], n_dev, cell.model_flops,
                     op_s=census["op_s"])
    coll = CollectiveStats(census["per_op"], census["counts"],
                           census["wire"]).row()
    record = {
        "arch": arch_id, "shape": shape_name, "mesh": tag,
        "n_devices": n_dev, "kind": cell.kind, "notes": cell.notes,
        "exec_compile_s": round(t_exec, 2),
        "profile_compile_s": round(t_prof, 2),
        "memory_analysis": mem,
        "live_bytes_per_device": int(live),
        "fits_80gb": bool(live < DEVICE_BYTES),
        "cost_analysis": {"flops": census["flops"],
                          "bytes accessed": census["bytes"]},
        "collectives": coll,
        "roofline": rl.row(),
        "op_s": census["op_s"],
        "bound_s": step_bound(census["op_s"], census["collective_s"]),
        "status": "ok",
        **pmeta,
    }
    if verbose:
        print(f"== {arch_id} × {shape_name} × {tag} ==")
        print(f"  memory (exec): {mem}")
        print(f"  live/device: {live / 1e9:.2f} GB  "
              f"fits80GB={record['fits_80gb']}")
        print(f"  cost (profile): flops={census['flops']:.3e} "
              f"bytes={census['bytes']:.3e}")
        print(f"  collectives: {coll}")
        print(f"  roofline: compute={rl.compute_s:.4e}s "
              f"memory={rl.memory_s:.4e}s collective={rl.collective_s:.4e}s "
              f"dominant={rl.dominant} useful={rl.useful_fraction:.3f}")
        print(f"  bound: {record['bound_s']:.4e}s (the ops one after "
              f"another: {census['op_s']:.4e}s)")
    return record


def targets(args) -> tuple[list, list]:
    """(runnable (arch, shape) pairs, skipped (arch, shape, reason))."""
    if args.all:
        cells = [(a, s, skip) for a, s, _, skip in all_cells()]
    elif args.arch and args.shape is None:
        cells = [(args.arch, s, skip)
                 for s, _, skip in get_arch(args.arch).cells()]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(args.arch, args.shape, None)]
    return ([(a, s) for a, s, skip in cells if skip is None],
            [(a, s, skip) for a, s, skip in cells if skip])


def sweep_one(job) -> dict:
    """One (arch, shape, multi_pod, profile, moe_impl) job: its record, or
    a ``fail`` record with the error."""
    a, s, mp, profile, moe_impl = job
    try:
        return run_cell(a, s, multi_pod=mp, profile=profile, verbose=False,
                        moe_impl=moe_impl)
    except Exception as e:  # record, keep sweeping
        return {"arch": a, "shape": s, "mesh": mesh_tag(mp), "status": "fail",
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def sweep(jobs):
    """Records of ``jobs`` (`sweep_one`'s tuples) in order."""
    return [sweep_one(j) for j in jobs]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=sorted(MESHES), default="both")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-profile", action="store_true",
                    help="count FLOPs on the full-depth step, no layer "
                         "differencing")
    ap.add_argument("--moe-impl", choices=("pjit", "shardmap"), default=None,
                    help="run the MoE cells so (default: the config's, "
                         "pjit)")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    runnable, skipped = targets(args)
    for a, s, reason in skipped:
        rec = {"arch": a, "shape": s, "status": "skip", "reason": reason}
        with open(os.path.join(args.out, f"{a}__{s}__skip.json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(f"SKIP {a} × {s}: {reason}")
    jobs = []
    for a, s in runnable:
        for mp in MESHES[args.mesh]:
            path = os.path.join(args.out, f"{a}__{s}__{mesh_tag(mp)}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"cached {a} × {s} × {mesh_tag(mp)}")
                continue
            jobs.append((a, s, mp, not args.no_profile, args.moe_impl))
    failures = 0
    for rec in sweep(jobs):
        path = os.path.join(args.out,
                            f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        head = f"{rec['arch']} × {rec['shape']} × {rec['mesh']}"
        if rec["status"] == "ok":
            r = rec["roofline"]
            print(f"ok   {head}: live {rec['live_bytes_per_device'] / 1e9:.2f} "
                  f"GB fits80GB={rec['fits_80gb']} dominant={r['dominant']} "
                  f"roofline={r['roofline_fraction']:.3f} "
                  f"bound={rec['bound_s']:.4g}s")
        else:
            failures += 1
            print(f"FAIL {head}: {rec['error']}")
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")
    print("dry-run complete")


if __name__ == "__main__":
    main()
