"""Partition-aware halo sharding: the partitioner's output becomes the
framework's communication plan.

A partition of the (dual) graph assigns every node to one of ``nparts``
shards.  :func:`plan_halo_sharding` turns that assignment into a
:class:`HaloPlan` — per-shard contiguous node blocks plus the incoming-edge
lists and export buffers a message-passing sweep needs.  The only
collective per sweep is one gather of each shard's exported boundary
values, so the wire volume per feature column is ``n_shards · halo`` words
— proportional to the partition's edge cut.

Layout
------
* Shard ``s`` owns the nodes with ``parts == s`` in ascending global id,
  at local slots ``0 .. block_sizes[s]-1`` of a block padded to the uniform
  ``n_local = max_s block_sizes[s]`` (so the per-shard arrays stack).
* ``export_idx[s]`` lists the local slots of shard ``s``'s *boundary*
  nodes (nodes with at least one edge into another shard), padded to the
  uniform ``halo = max_s |boundary_s|``; ``export_mask`` marks real rows.
* A sweep gathers every shard's exports into a ``(n_shards · halo, F)``
  buffer; edge sources index the *combined* space: ``[0, n_local)`` are the
  shard's own slots, ``n_local + r·halo + j`` is export row ``j`` of shard
  ``r``.
* ``edge_{src,dst,weight,mask}[s]`` hold the incoming edges of shard
  ``s``'s nodes (dst local slot, src combined index), padded to the uniform
  ``max_edges``.  Every directed CSR entry of the graph appears exactly
  once, in its destination's shard.

All planning is host-side NumPy, copied from `repro.dist.partition_aware`
and bit-identical to it, with `repro`'s ``halo_truncate`` chaos hook: a
plan that fails its self-check is rebuilt once with the chaos sites muted,
and raises if the rebuild fails too, and with its obs counters: the
plan's wire volume (``halo_words``, ``halo_bytes``, ``halo_max_degree``)
and ``guard_fallbacks`` for a rebuild.

The distributed matvec (:func:`adjacency_matvec_distributed`) runs across
the ranks of a `torch.distributed` group, one shard a rank: each rank
exchanges its exports in ONE gather (:func:`halo_exchange`), then takes
and segment-sums its incoming edges in plain torch, as `repro`'s
``_matvec_kernel`` does in plain ``jnp`` (no Pallas kernel lies on this
path).  Where `repro` reads the sharded result back to the host, the port
gathers the ranks' blocks once more, so every rank ends with the whole
``y``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import obs
from repro_torch.dist import group as dist_group
from repro_torch.guard import chaos


@dataclasses.dataclass(frozen=True, eq=False)  # identity eq/hash: ndarray
class HaloPlan:                                # fields break field-wise ==
    """Host-side sharding plan produced by :func:`plan_halo_sharding`."""

    n: int                     # global node count
    n_shards: int
    n_local: int               # padded nodes per shard
    halo: int                  # padded export rows per shard (max boundary)
    max_edges: int             # padded incoming edges per shard
    block_sizes: np.ndarray    # (P,) real nodes per shard
    shard_of: np.ndarray       # (n,) owning shard of each global node
    slot_of: np.ndarray        # (n,) local slot of each global node
    export_idx: np.ndarray     # (P, halo) int64 local slots exported
    export_mask: np.ndarray    # (P, halo) float32
    edge_src: np.ndarray       # (P, max_edges) int64 combined index
    edge_dst: np.ndarray       # (P, max_edges) int64 local slot
    edge_weight: np.ndarray    # (P, max_edges) float32
    edge_mask: np.ndarray      # (P, max_edges) float32

    @property
    def collective_words_per_feature(self) -> int:
        """Rows of the per-sweep all_gather buffer — the wire volume one
        message-passing sweep moves per feature column (∝ edge cut)."""
        return self.n_shards * self.halo

    def stats(self) -> dict:
        """JSON-able plan summary (benchmark / experiment records)."""
        return {
            "n": self.n,
            "n_shards": self.n_shards,
            "n_local": self.n_local,
            "halo": self.halo,
            "max_edges": self.max_edges,
            "gather_words_per_col": self.collective_words_per_feature,
            "node_fill": round(float(self.block_sizes.sum())
                               / (self.n_shards * self.n_local), 4),
            "edge_fill": round(float(self.edge_mask.sum())
                               / (self.n_shards * self.max_edges), 4),
        }


def plan_halo_sharding(graph, parts, nparts: int | None = None,
                       *, pad_to: int = 1) -> HaloPlan:
    """Build a :class:`HaloPlan` from a node→shard assignment.

    ``parts`` is either a label array or a partition-pipeline
    :class:`~repro_torch.core.pipeline.PartitionContext` (anything with
    ``.parts``/``.nparts``) — the pipeline's output plugs in directly, and
    its report (post-stage metrics, per-stage timings) stays attached for
    the caller.  ``nparts`` may be omitted for contexts (taken from the
    context) and label arrays (inferred as ``max+1``).

    ``parts`` need not be balanced — blocks are padded to the largest
    shard.  ``pad_to`` rounds ``n_local``/``halo``/``max_edges`` up to a
    multiple (alignment; padding rows stay fully masked).
    Host-side NumPy; O(nnz log nnz).
    """
    if hasattr(parts, "parts"):          # PartitionContext (duck-typed)
        ctx = parts
        if ctx.parts is None:
            raise ValueError("pipeline context has no parts (run() first)")
        if nparts is None:
            nparts = ctx.nparts
        parts = ctx.parts
    parts = np.asarray(parts, dtype=np.int64)
    if nparts is None:
        nparts = int(parts.max()) + 1 if parts.size else 1
    n = graph.n
    if parts.shape != (n,):
        raise ValueError(f"parts has shape {parts.shape}, expected ({n},)")
    if parts.min() < 0 or parts.max() >= nparts:
        raise ValueError("parts out of range for nparts")
    if pad_to < 1:
        raise ValueError(f"pad_to must be >= 1, got {pad_to}")

    plan = _assemble_plan(graph, parts, nparts, pad_to)
    if chaos.should_fire("halo_truncate", n, nparts):
        plan = _truncate_exports(plan)

    # Always-on cheap self-check (O(nnz), no graph re-walk): a plan whose
    # remote edge sources are not all exported would silently read zeros in
    # every sweep.  A corrupt plan is rebuilt once with fault injection
    # muted — the repair path must not be re-corrupted.
    problems = verify_halo_plan(plan)
    if problems:
        with chaos.suppressed():
            plan = _assemble_plan(graph, parts, nparts, pad_to)
        obs.counter_add("guard_fallbacks", 1)
        rest = verify_halo_plan(plan)
        if rest:
            raise ValueError(f"halo plan invalid after rebuild: {rest}")

    # Wire volume of the plan — what the partition's edge cut costs the
    # runtime, per sweep per feature column (float32 ⇒ 4 bytes/word).
    words = plan.collective_words_per_feature
    obs.counter_add("halo_words", float(words))
    obs.counter_add("halo_bytes", 4.0 * words)
    obs.gauge_max("halo_max_degree", int(plan.halo))
    return plan


def _assemble_plan(graph, parts: np.ndarray, nparts: int,
                   pad_to: int) -> HaloPlan:
    """The O(nnz log nnz) host-side plan assembly (no validation, no
    telemetry — :func:`plan_halo_sharding` wraps it)."""
    n = graph.n

    def pad(k: int) -> int:
        return int(-(-k // pad_to) * pad_to)

    counts = np.bincount(parts, minlength=nparts)
    n_local = pad(max(1, int(counts.max())))

    # Slot assignment: ascending global id within each shard.
    order = np.argsort(parts, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_of = np.empty(n, dtype=np.int64)
    slot_of[order] = np.arange(n, dtype=np.int64) - starts[parts[order]]

    rows, cols, w = graph.rows, graph.indices, graph.weights
    pr, pc = parts[rows], parts[cols]
    cross = pr != pc

    # Exports of shard s: its nodes referenced by any other shard, in
    # ascending global id.  (Symmetric CSR ⇒ same set as boundary nodes.)
    exp_nodes = np.unique(cols[cross]) if cross.any() else np.empty(0, np.int64)
    exp_owner = parts[exp_nodes]
    eord = np.argsort(exp_owner, kind="stable")
    exp_nodes, exp_owner = exp_nodes[eord], exp_owner[eord]
    ecounts = np.bincount(exp_owner, minlength=nparts)
    halo = pad(int(ecounts.max())) if exp_nodes.size else 0
    estarts = np.concatenate([[0], np.cumsum(ecounts)[:-1]])
    epos = np.arange(exp_nodes.size, dtype=np.int64) - estarts[exp_owner]
    expos = np.full(n, -1, dtype=np.int64)   # export position of each node
    expos[exp_nodes] = epos

    export_idx = np.zeros((nparts, halo), dtype=np.int64)
    export_mask = np.zeros((nparts, halo), dtype=np.float32)
    if exp_nodes.size:
        export_idx[exp_owner, epos] = slot_of[exp_nodes]
        export_mask[exp_owner, epos] = 1.0

    # Incoming edges, grouped by destination shard.
    edge_counts = np.bincount(pr, minlength=nparts)
    max_edges = pad(max(1, int(edge_counts.max())))
    gord = np.argsort(pr, kind="stable")
    r_s, c_s, w_s, pr_s = rows[gord], cols[gord], w[gord], pr[gord]
    gstarts = np.concatenate([[0], np.cumsum(edge_counts)[:-1]])
    gpos = np.arange(r_s.size, dtype=np.int64) - gstarts[pr_s]

    edge_src = np.zeros((nparts, max_edges), dtype=np.int64)
    edge_dst = np.zeros((nparts, max_edges), dtype=np.int64)
    edge_weight = np.zeros((nparts, max_edges), dtype=np.float32)
    edge_mask = np.zeros((nparts, max_edges), dtype=np.float32)
    if r_s.size:
        local = pr_s == parts[c_s]
        remote_pos = np.where(local, 0, expos[c_s])   # guard -1 for locals
        src_combined = np.where(
            local, slot_of[c_s], n_local + parts[c_s] * halo + remote_pos
        )
        edge_dst[pr_s, gpos] = slot_of[r_s]
        edge_src[pr_s, gpos] = src_combined
        edge_weight[pr_s, gpos] = w_s
        edge_mask[pr_s, gpos] = 1.0

    return HaloPlan(
        n=n, n_shards=nparts, n_local=n_local, halo=halo, max_edges=max_edges,
        block_sizes=counts, shard_of=parts, slot_of=slot_of,
        export_idx=export_idx, export_mask=export_mask,
        edge_src=edge_src, edge_dst=edge_dst,
        edge_weight=edge_weight, edge_mask=edge_mask,
    )


def _truncate_exports(plan: HaloPlan) -> HaloPlan:
    """``halo_truncate`` chaos: drop the last real export row of every
    shard — the classic truncated-exchange bug a rank mismatch produces."""
    mask = plan.export_mask.copy()
    for s in range(plan.n_shards):
        real = np.flatnonzero(mask[s] > 0)
        if real.size:
            mask[s, real[-1]] = 0.0
    return dataclasses.replace(plan, export_mask=mask)


def verify_halo_plan(plan: HaloPlan) -> list:
    """Cheap structural audit of a plan (empty list == valid): every real
    remote edge source must point at an in-range, mask-1 export row, and
    the shard blocks must cover exactly ``n`` nodes."""
    problems: list = []
    if int(plan.block_sizes.sum()) != plan.n:
        problems.append(
            f"block sizes sum to {int(plan.block_sizes.sum())}, "
            f"expected {plan.n}")
    src = plan.edge_src[plan.edge_mask > 0]
    remote = src >= plan.n_local
    if remote.any():
        if plan.halo <= 0:
            problems.append("remote edge sources but halo == 0")
        else:
            rj = src[remote] - plan.n_local
            r, j = rj // plan.halo, rj % plan.halo
            bad_r = (r < 0) | (r >= plan.n_shards)
            if bad_r.any():
                problems.append(
                    f"{int(bad_r.sum())} remote sources index "
                    "a shard out of range")
            missing = int((plan.export_mask[r[~bad_r], j[~bad_r]]
                           < 1.0).sum())
            if missing:
                problems.append(
                    f"{missing} remote edge sources point at "
                    "unexported (masked-out) rows")
    return problems


# ---------------------------------------------------------------------------
# Feature movement: global order ↔ plan (per-shard block) order
# ---------------------------------------------------------------------------

def scatter_features(plan: HaloPlan, x: np.ndarray) -> np.ndarray:
    """Global ``(n, ...)`` features → per-shard ``(P, n_local, ...)`` blocks
    (padding slots zero).  The element-redistribution step a solver performs
    before timestepping."""
    x = np.asarray(x)
    if x.shape[0] != plan.n:
        raise ValueError(f"x has {x.shape[0]} rows, plan expects {plan.n}")
    out = np.zeros((plan.n_shards, plan.n_local) + x.shape[1:], dtype=x.dtype)
    out[plan.shard_of, plan.slot_of] = x
    return out


def gather_features(plan: HaloPlan, blocks: np.ndarray) -> np.ndarray:
    """Inverse of :func:`scatter_features`: ``(P, n_local, ...)`` blocks →
    global ``(n, ...)`` (padding slots dropped)."""
    blocks = np.asarray(blocks)
    if blocks.shape[:2] != (plan.n_shards, plan.n_local):
        raise ValueError(
            f"blocks has leading shape {blocks.shape[:2]}, "
            f"plan expects {(plan.n_shards, plan.n_local)}"
        )
    return blocks[plan.shard_of, plan.slot_of]


# ---------------------------------------------------------------------------
# Distributed adjacency matvec (one halo exchange per sweep)
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """`group.all_gather_rows`, differentiable: the gradient of the
    gathered buffer is summed over the ranks (one all-reduce: gloo has no
    reduce-scatter) and each rank keeps its own rows — every rank's
    exports feed every rank's edges."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return dist_group.all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        total = dist_group.all_reduce_sum(grad.contiguous(), ctx.group)
        r = dist_group.rank(ctx.group)
        return total[r * ctx.rows:(r + 1) * ctx.rows], None


def halo_exchange(x_local: torch.Tensor, export_idx: torch.Tensor,
                  export_mask: torch.Tensor, group) -> torch.Tensor:
    """One rank's halo exchange: gather every rank's exports and return the
    combined ``(n_local + P·halo, F)`` table edge sources index.
    Differentiable (the halo GraphCast trains through it); a plan with no
    exports (one shard) gathers nothing.  The take's backward adds into
    distinct rows but for the padding rows, whose gradient the mask makes
    zero, so its sum has one order."""
    exported = x_local.index_select(0, export_idx) * export_mask[:, None]
    if exported.shape[0] == 0:
        return x_local
    buf = _GatherRows.apply(exported, group)
    return torch.cat([x_local, buf], dim=0)


@functools.lru_cache(maxsize=32)
def _matvec_consts(plan: HaloPlan, group, device: torch.device) -> tuple:
    """This rank's rows of the plan on ``device``, copied once per
    (plan, group, device) rather than every call (`repro`'s
    ``_matvec_kernel`` cache)."""
    r = dist_group.rank(group)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a[r])).to(device, dtype)

    return (put(plan.edge_src, torch.int64), put(plan.edge_dst, torch.int64),
            put(plan.edge_weight, torch.float32),
            put(plan.export_idx, torch.int64),
            put(plan.export_mask, torch.float32))


def adjacency_matvec_distributed(plan: HaloPlan, group, x: np.ndarray, *,
                                 device=None) -> np.ndarray:
    """``y = A x`` for the plan's graph, each rank of ``group`` (None: the
    default group) one shard, with ONE export gather — wire volume ∝ edge
    cut — and one gather of the result blocks, so every rank returns the
    whole ``y``.

    ``x`` is host-side ``(n,)`` or ``(n, F)`` on every rank; the result
    matches its shape.  ``device``: where this rank computes
    (`repro_torch.dist.group.rank_device`; None: its card).  The dense
    oracle is ``A[dst, src] = w`` over the symmetric CSR.
    """
    grp = dist_group.active(group)
    if grp is None:
        raise ValueError("adjacency_matvec_distributed needs a process "
                         "group: torch.distributed is not initialized")
    n_ranks = dist_group.size(grp)
    if plan.n_shards != n_ranks:
        raise ValueError(
            f"plan has {plan.n_shards} shards but the process group has "
            f"{n_ranks} ranks")
    dev = dist_group.rank_device(device)
    x = np.asarray(x)
    squeeze = x.ndim == 1
    xb = scatter_features(plan, x.reshape(plan.n, -1).astype(np.float32))
    esrc, edst, ew, xidx, xmask = _matvec_consts(plan, grp, dev)
    xl = torch.from_numpy(xb[dist_group.rank(grp)]).to(dev)
    combined = halo_exchange(xl, xidx, xmask, grp)
    contrib = combined.index_select(0, esrc) * ew[:, None]
    yl = torch.zeros_like(xl).index_add_(0, edst, contrib)
    blocks = dist_group.all_gather_rows(yl, grp)
    y = gather_features(plan, blocks.cpu().numpy().reshape(
        plan.n_shards, plan.n_local, -1))
    return y[:, 0] if squeeze else y
