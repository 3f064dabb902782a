"""Roofline terms of one step on the H100 cluster, from the dry run's counts.

Port of `repro.launch.roofline`.  Three terms per (arch × shape × mesh),
all **per device** (the dry run runs one rank's step, so its FLOPs, bytes
and collectives are already per device):

    compute    = FLOPs / PEAK_FLOPS         (989 TFLOP/s dense bf16)
    memory     = bytes / HBM_BW             (3.35 TB/s HBM3)
    collective = Σ_op wire_bytes(op) / link_bw(op's axis)

the constants the H100 SXM5's (NVIDIA H100 Tensor Core GPU datasheet,
SXM5 column), the links those of `repro_torch.launch.mesh` (NVLink 450
GB/s a card one way inside a node of 8, InfiniBand NDR 50 GB/s a card
between nodes): each collective is timed at the bandwidth of the slowest
link its group crosses (`Topology.link_bw`), where `repro` times every
link alike.

There is no HLO to parse: the census is the port's own collectives
(`repro_torch.dist.group.census`: op, local output bytes, group size,
axis), summed with `repro`'s ring model:

    all-reduce         2·b·(g−1)/g    (reduce-scatter + all-gather ring)
    all-gather         b·(g−1)/g
    reduce-scatter     b·(g−1)
    all-to-all         b·(g−1)/g
    collective-permute b

with b the op's local output bytes and g its group size.

The step's bound.  `repro`'s is the largest term: XLA fuses a step and
overlaps its terms.  The port runs eagerly, its ops one after another on
one stream, so the dry run also counts ``op_s``, each op's own
max(FLOPs / PEAK_FLOPS, bytes / HBM_BW) summed over the step, and bounds
the step by `step_bound` (the larger of ``op_s`` and the collective term,
which may overlap the ops).  ``roofline_fraction`` and ``dominant`` are
taken against that bound when ``op_s`` is given, and against the largest
term, as `repro`'s, when it is not.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s, H100 SXM5
HBM_BW = 3.35e12           # HBM3 bytes/s, H100 SXM5

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def wire_bytes(op: str, b: float, g: int) -> float:
    """Ring-model bytes one device sends for a collective of local output
    ``b`` bytes over ``g`` devices (0 for a group of one)."""
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * b * (g - 1) / g
    if op in ("all-gather", "all-to-all"):
        return b * (g - 1) / g
    if op == "reduce-scatter":
        return float(b * (g - 1))
    if op == "collective-permute":
        return float(b)
    raise ValueError(f"unknown collective {op!r} (have {COLLECTIVES})")


@dataclasses.dataclass
class CollectiveStats:
    per_op: dict              # op kind → wire bytes (per device)
    counts: dict              # op kind → #ops
    total_wire_bytes: float

    def row(self):
        return {
            "wire_bytes": self.total_wire_bytes,
            "counts": dict(self.counts),
            "bytes_by_kind": {k: v for k, v in self.per_op.items() if v},
        }


def collective_stats(records) -> CollectiveStats:
    """`repro`'s ``collective_wire_bytes`` over census records ``(op,
    bytes, group size, axis)``."""
    per_op = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for op, b, g, _ in records:
        if g <= 1:
            continue
        per_op[op] += wire_bytes(op, b, g)
        counts[op] += 1
    return CollectiveStats(per_op=per_op, counts=counts,
                           total_wire_bytes=sum(per_op.values()))


def collective_seconds(records, mesh=None, link_bw: float | None = None
                       ) -> float:
    """The collective term: each record's wire bytes over ``link_bw`` when
    given (`repro`'s one-link model), else over the bandwidth of the
    slowest link its axis crosses on ``mesh``'s topology (InfiniBand for a
    record with no axis)."""
    from repro_torch.launch.mesh import IB_BW

    if link_bw is not None:
        return collective_stats(records).total_wire_bytes / link_bw
    topo = getattr(mesh, "topology", None)
    total = 0.0
    for op, b, g, axis in records:
        bw = topo.link_bw(mesh, axis) if topo is not None and axis else IB_BW
        total += wire_bytes(op, b, g) / bw
    return total


@dataclasses.dataclass
class Roofline:
    flops_per_dev: float
    bytes_per_dev: float
    wire_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_fraction: float     # MODEL_FLOPS / (FLOPs · n_dev)
    roofline_fraction: float   # compute_s / the step's bound — how close
                               # the step is to being compute-bound at peak

    def row(self) -> dict:
        return dataclasses.asdict(self)


def step_bound(op_s: float, collective_s: float) -> float:
    """The least time of an eager step: its ops' own rooflines summed
    (``op_s``), or its collectives' term where that is longer."""
    return max(op_s, collective_s)


def from_counts(flops: float, byts: float, wire: float, collective_s: float,
                n_devices: int, model_flops: float, *,
                op_s: float | None = None,
                peak_flops: float = PEAK_FLOPS,
                hbm_bw: float = HBM_BW) -> Roofline:
    """The `Roofline` of a step's per-device FLOPs, bytes, wire bytes and
    collective seconds; with ``op_s``, against `step_bound`."""
    ct = flops / peak_flops
    mt = byts / hbm_bw
    terms = {"compute": ct, "memory": mt, "collective": collective_s}
    total_flops = flops * n_devices
    if op_s is None:
        bound, dominant = max(terms.values()), max(terms, key=terms.get)
    else:
        bound = step_bound(op_s, collective_s)
        dominant = "collective" if collective_s > op_s \
            else ("compute" if ct > mt else "memory")
    return Roofline(
        flops_per_dev=flops, bytes_per_dev=byts, wire_bytes_per_dev=wire,
        compute_s=ct, memory_s=mt, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        useful_fraction=model_flops / total_flops if total_flops else 0.0,
        roofline_fraction=(ct / bound) if bound > 0 else 0.0,
    )


def roofline(cost: dict, records, n_devices: int, model_flops: float, *,
             mesh=None, peak_flops: float = PEAK_FLOPS,
             hbm_bw: float = HBM_BW, link_bw: float | None = None
             ) -> Roofline:
    """`repro`'s ``roofline`` on the census ``records`` (in place of the
    HLO text): ``cost`` has ``"flops"`` and ``"bytes accessed"``; the
    collective term is `collective_seconds` on ``mesh`` (or at ``link_bw``
    for every link)."""
    return from_counts(
        float(cost.get("flops", 0.0)), float(cost.get("bytes accessed", 0.0)),
        collective_stats(records).total_wire_bytes,
        collective_seconds(records, mesh, link_bw), n_devices, model_flops,
        peak_flops=peak_flops, hbm_bw=hbm_bw)
