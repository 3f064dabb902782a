"""Graph batch container and the message-passing primitives, summed in a
fixed order.

Ports of `repro.models.gnn.common`: `GraphBatch`, `scatter_sum` (`repro`:
``jax.ops.segment_sum``), `gather` (``jnp.take``) and `segment_softmax`.

The order of the sums.  ``jax.ops.segment_sum`` gives one result on a
given device.  PyTorch's natural counterpart, ``index_add_``, adds with
float atomics on the card, and so does the backward of ``index_select``
(the backward of every gather): their bits change from run to run.  Here
`scatter_sum` and `gather` are a pair of autograd functions over one
:class:`SegmentPlan` of the index: `scatter_sum` adds each destination's
rows in a fixed order and its backward is a take; `gather` is a take and
its backward is the same ordered sum, keyed by the source index.  The
plan is built once per index on the host (a stable ``np.argsort`` and
row offsets) and cached on the batch: the graph of a batch is static.

A row may be long.  Padded edge slots all point at node 0 (the sampler
pads ``edge_src``/``edge_dst`` with 0; at ``minibatch_lg`` over 100,000
of the 168,960 slots), and a power-law graph has hubs that many sampled
edges read.  A sum that walks each row with one thread serialises the
whole batch on such a row.  So the plan splits every row longer than
:data:`RUN` entries into runs of :data:`RUN`, sums each run in order
(``torch.segment_reduce``: one thread a (segment, feature) adds the
segment's rows one after another, from zero, on the CPU and on the card),
and adds a long row's run partials in run order, :data:`RUN` at a time,
level by level, until one is left.  The order is a function of the
index alone: the same bits in every call, on either device, and the rows
of at most :data:`RUN` entries are added exactly in edge order, as a
sequential ``segment_sum`` adds them.  (The other way out, leaving the
masked slots out of the plan, would need every caller to have zeroed
them and would leave the hubs serial.)  No Pallas kernel lies on this
path: `repro` sums with ``jax.ops.segment_sum``.

Across ranks (`repro`'s ``gnn_rules``: nodes and edges striped over every
mesh axis).  Under a `MeshRules` whose ``nodes`` entry names axes, a rank
holds its stripe of the node arrays (N / D rows) and of the edge arrays
(E / D); the edge indices hold global node ids.  A layer reads the node
table once: :func:`node_table` all-gathers the stripe over the nodes'
axes in shard order (its backward reduce-scatters), and the takes of
`gather` read that one table with the rank's plans over all N rows, so
the gradients of a layer's takes add on the rank, each in its plan's
order, before the one reduce-scatter.  ``scatter_sum(..., rules)`` sums
the rank's edge stripe into all N rows in the plan's order, then
reduce-scatters the (N, ...) partial to the rank's node stripe; its
backward all-gathers the gradient and takes it at the rank's index.  The
table is not kept across layers: the backward reads the edges' inputs,
not the table.  Under `NO_SHARD` both keep the one-process code path and
its bits.

The order of the sums across ranks.  A rank's partial of every row is
summed in its plan's fixed order; the ranks' partials are then added by
the backend's reduce-scatter, one mesh axis after the other (``data``
before ``model``, `MeshRules.scatter`), in the order its algorithm fixes
for a given world size: gloo's reduce-scatter and NCCL's ring add the
ranks' buffers in a schedule that depends on the world size and the
ranks' order, not on the run.  So two runs on the same ranks give the
same bits.  They are not `repro`'s bits, nor the one process's: once a
row's entries fall on several ranks, its runs of `RUN` split at other
places.

A ``meta`` index (the dry run: shapes, no values) gets a plan of ``meta``
tensors sized by bounds that hold for any index of E entries into n rows
(`segment_plan`); nothing reads a value from it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.common import NO_SHARD, ShardRules, grad_scale

RUN = 32     # entries (or partials) one thread adds in order


@dataclasses.dataclass(frozen=True, eq=False)
class SegmentPlan:
    """The fixed order in which the entries of one index are summed.

    index   : (E,) int64 — each entry's row (the take of the backward).
    n       : rows of the sum.
    perm    : (E,) int64 — the entries, stably sorted by row.
    offsets : (S + 1,) int64 — the first level's segments over the sorted
              entries: the rows in order, a row longer than RUN split into
              runs of RUN (an empty row: one empty segment).
    first   : (n,) int64 — each row's first segment; None when no row is
              split (the segments are the rows).
    long_rows : (L,) int64 — the split rows, ascending (None: none).
    tree    : the levels that add a split row's partials: the first reads
              ``take`` of the first level's partials, each later one the
              level before's; each level's offsets group a row's partials
              RUN at a time, until one partial a row is left.
    """

    index: torch.Tensor
    n: int
    perm: torch.Tensor
    offsets: torch.Tensor
    first: torch.Tensor | None
    long_rows: torch.Tensor | None
    take: torch.Tensor | None
    tree: tuple

    def to(self, device) -> "SegmentPlan":
        def mv(t):
            return None if t is None else t.to(device)

        return SegmentPlan(index=mv(self.index), n=self.n, perm=mv(self.perm),
                           offsets=mv(self.offsets), first=mv(self.first),
                           long_rows=mv(self.long_rows), take=mv(self.take),
                           tree=tuple(mv(t) for t in self.tree))


def _offsets(lengths: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


def _runs(counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split each of the rows' ``counts`` into runs of RUN (at least one
    run a row): (runs a row, the runs' lengths row by row)."""
    nseg = np.maximum(1, -(-counts // RUN))
    row = np.repeat(np.arange(counts.size), nseg)
    k = np.arange(row.size) - (np.cumsum(nseg) - nseg)[row]
    return nseg, np.minimum(RUN, counts[row] - k * RUN)


def _meta_plan(E: int, n: int) -> SegmentPlan:
    """A plan of ``meta`` tensors for any index of ``E`` entries into ``n``
    rows, each size an upper bound: a row of c > RUN entries adds
    ⌈c/RUN⌉ − 1 < c/RUN segments to its one, so at most n + ⌈E/RUN⌉
    first-level segments; at most L = ⌊E/(RUN+1)⌋ rows are split, and
    their partials number the split segments plus L, at most ⌈E/RUN⌉ + L;
    the tree is one level of them into L rows (a real plan adds a level
    for a row of more than RUN² entries, each at most 1/RUN of the one
    before: left out)."""
    T = -(-E // RUN)
    L = min(n, E // (RUN + 1))

    def t(k):
        return torch.empty((k,), dtype=torch.int64, device="meta")

    return SegmentPlan(index=t(E), n=int(n), perm=t(E), offsets=t(n + T + 1),
                       first=t(n), long_rows=t(L), take=t(T + L),
                       tree=(t(L + 1),))


def segment_plan(index, n: int) -> SegmentPlan:
    """The :class:`SegmentPlan` of ``index`` (a tensor or array of rows in
    [0, n)), on ``index``'s device (host arrays: the CPU).  Host NumPy;
    reads a device index back once.  A ``meta`` index has no values: its
    plan is `_meta_plan`'s upper bound, of ``meta`` tensors."""
    if isinstance(index, torch.Tensor) and index.device.type == "meta":
        return _meta_plan(index.numel(), n)
    dev = index.device if isinstance(index, torch.Tensor) \
        else torch.device("cpu")
    idx = (index.detach().cpu().numpy() if isinstance(index, torch.Tensor)
           else np.asarray(index)).astype(np.int64).reshape(-1)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(f"index out of range for {n} rows")
    perm = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=n)
    nseg, seg_len = _runs(counts)
    first = long_rows = take = None
    tree = []
    long = np.flatnonzero(nseg > 1)
    if long.size:
        seg_first = np.cumsum(nseg) - nseg
        first = seg_first
        long_rows = long
        m = nseg[long]
        take = np.repeat(seg_first[long], m) + (
            np.arange(m.sum()) - np.repeat(np.cumsum(m) - m, m))
        while True:
            g, lens = _runs(m)
            tree.append(_offsets(lens))
            if (g == 1).all():
                break
            m = g

    def put(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int64)).to(dev)

    return SegmentPlan(index=put(idx), n=int(n), perm=put(perm),
                       offsets=put(_offsets(seg_len)), first=put(first),
                       long_rows=put(long_rows), take=put(take),
                       tree=tuple(put(t) for t in tree))


def _segments(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Each segment's rows of the 2-D ``values`` added in order, from 0."""
    return torch.segment_reduce(values, "sum", offsets=offsets, axis=0,
                                unsafe=True)


def ordered_sum(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(E, ...) values summed into (plan.n, ...) rows in the plan's order:
    ``jax.ops.segment_sum(values, index, n)`` with fixed bits."""
    tail = values.shape[1:]
    if values.shape[0] != plan.perm.shape[0]:
        raise ValueError(f"{values.shape[0]} values for an index of "
                         f"{plan.perm.shape[0]}")
    if values.shape[0] == 0:
        return values.new_zeros((plan.n,) + tail)
    flat = values.reshape(values.shape[0], -1).index_select(0, plan.perm)
    part = _segments(flat, plan.offsets)
    if plan.first is None:
        return part.reshape((plan.n,) + tail)
    acc = part.index_select(0, plan.take)
    for offsets in plan.tree:
        acc = _segments(acc, offsets)
    out = part.index_select(0, plan.first)
    out.index_copy_(0, plan.long_rows, acc)     # distinct rows: no atomics
    return out.reshape((plan.n,) + tail)


class _ScatterSum(torch.autograd.Function):
    """Ordered sum forward; its backward is a take."""

    @staticmethod
    def forward(ctx, values, plan):
        ctx.plan = plan
        return ordered_sum(values, plan)

    @staticmethod
    def backward(ctx, grad):
        return grad.index_select(0, ctx.plan.index), None


class _Gather(torch.autograd.Function):
    """A take forward; its backward is the ordered sum keyed by the
    source index."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x.index_select(0, plan.index)

    @staticmethod
    def backward(ctx, grad):
        return ordered_sum(grad, ctx.plan), None


def _as_plan(index, n: int) -> SegmentPlan:
    if isinstance(index, SegmentPlan):
        if index.n != n:
            raise ValueError(f"plan of {index.n} rows used for {n}")
        return index
    return segment_plan(index, n)


class _StripeSum(torch.autograd.Function):
    """The rank's ordered sum of its edge stripe into all n rows, then the
    reduce-scatter to its node stripe; its backward is the all-gather of
    the gradient and a take."""

    @staticmethod
    def forward(ctx, values, plan, rules, entry):
        ctx.plan, ctx.rules, ctx.entry = plan, rules, entry
        return rules.scatter(ordered_sum(values, plan), entry, 0)

    @staticmethod
    def backward(ctx, grad):
        full = ctx.rules.gather(grad, ctx.entry, 0)
        return full.index_select(0, ctx.plan.index), None, None, None


def node_entry(rules: ShardRules):
    """The spec entry the node and edge stripes split over: `gnn_rules`'
    ``nodes`` (None under `NO_SHARD`, or where it names no axis).  The
    sums need the edges striped over the same axes."""
    if getattr(rules, "mesh", None) is None:
        return None
    nodes = rules.spec(("nodes",))[0]
    if nodes != rules.spec(("edges",))[0]:
        raise ValueError(f"nodes stripe over {nodes}, edges over "
                         f"{rules.spec(('edges',))[0]}: the sums need one "
                         "entry")
    return nodes


def global_rows(rows: int, rules: ShardRules = NO_SHARD) -> int:
    """The rows of every rank's node stripes together: ``rows`` (a
    stripe's) times the nodes' shard count."""
    entry = node_entry(rules)
    return rows if entry is None else rows * rules.count(entry)


def node_table(x: torch.Tensor, rules: ShardRules = NO_SHARD) -> torch.Tensor:
    """Every rank's stripe of ``x`` concatenated in shard order: the whole
    (N, ...) table.  Its backward reduce-scatters the gradient
    (`MeshRules.gather`).  Over one shard (`NO_SHARD`, or a mesh of one
    rank) the stripe is the table: ``x`` itself, no collective, so the
    gradients of the takes join ``x``'s others one by one, as in the one
    process, and a rank alone gives the one process's bits."""
    entry = node_entry(rules)
    if entry is None or rules.count(entry) == 1:
        return x
    return rules.gather(x, entry, 0)


def node_sum(x: torch.Tensor, rules: ShardRules = NO_SHARD) -> torch.Tensor:
    """Σ of ``x`` over the ranks of the node stripes (``psum``; ``x``
    under `NO_SHARD`)."""
    entry = node_entry(rules)
    return x if entry is None else rules.psum(x, entry)


def loss_share(loss: torch.Tensor, rules: ShardRules = NO_SHARD) -> torch.Tensor:
    """A global loss as this rank's share of the gradient (1 / ranks:
    `repro_torch.dist.sharding.reduce_grads` sums the shares)."""
    if node_entry(rules) is None or rules.n_ranks == 1:
        return loss
    return grad_scale(loss, 1.0 / rules.n_ranks)


def scatter_sum(values: torch.Tensor, index, n: int,
                rules: ShardRules = NO_SHARD) -> torch.Tensor:
    """Σ values into n rows (the GNN aggregation primitive), each row's
    entries in the plan's fixed order.  ``index``: a :class:`SegmentPlan`
    (cached by `GraphBatch.plan`) or a tensor of rows (planned here).

    Under ``rules`` striping the nodes, ``values`` and ``index`` are the
    rank's edge stripe (global rows, ``n`` the global count) and the
    result its node stripe (n / shards rows): the ordered sum into all n
    rows, reduce-scattered over the nodes' axes."""
    plan = _as_plan(index, n)
    entry = node_entry(rules)
    if entry is None:
        return _ScatterSum.apply(values, plan)
    return _StripeSum.apply(values, plan, rules, entry)


def gather(x: torch.Tensor, index) -> torch.Tensor:
    """``x``'s rows at ``index`` (a :class:`SegmentPlan` or a tensor); the
    gradient sums back in the plan's fixed order."""
    return _Gather.apply(x, _as_plan(index, x.shape[0]))


def segment_softmax(logits: torch.Tensor, segment_ids, n: int) -> torch.Tensor:
    """Numerically-stable softmax over segments (GAT-style edge softmax):
    the segment max (order-free), then the ordered sums."""
    plan = _as_plan(segment_ids, n)
    idx = plan.index.reshape((-1,) + (1,) * (logits.dim() - 1)) \
        .expand_as(logits)
    mx = logits.new_full((n,) + logits.shape[1:], float("-inf")) \
        .scatter_reduce(0, idx, logits, "amax", include_self=True)
    ex = torch.exp(logits - gather(mx, plan))
    z = scatter_sum(ex, plan, n)
    return ex / torch.clamp(gather(z, plan), min=1e-30)


_TENSOR_FIELDS = ("node_feat", "edge_src", "edge_dst", "node_mask",
                  "edge_mask", "positions", "species", "graph_ids", "targets")


@dataclasses.dataclass
class GraphBatch:
    """Static-shape graph batch (`repro`'s, field for field).

    node_feat : (N, F) float — input node features (may be zeros).
    edge_src/edge_dst : (E,) int32 — COO edge index (messages src→dst).
    node_mask / edge_mask : (N,)/(E,) float — 1 for real entries (padding).
    positions : (N, 3) float or None — for equivariant models.
    species : (N,) int32 or None — atomic species.
    graph_ids : (N,) int32 or None — graph membership (batched molecules).
    n_graphs : int.
    targets : model-specific supervision.

    :meth:`plan` builds and caches the :class:`SegmentPlan` of an index
    field; :meth:`to` moves the tensors and the cached plans.
    """

    node_feat: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    positions: torch.Tensor | None = None
    species: torch.Tensor | None = None
    graph_ids: torch.Tensor | None = None
    targets: torch.Tensor | None = None
    n_graphs: int = 1
    plans: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @property
    def n_nodes(self) -> int:
        return self.node_mask.shape[0]

    def plan(self, field: str, n: int | None = None,
             rules: ShardRules = NO_SHARD) -> SegmentPlan:
        """The plan of index field ``field`` over ``n`` rows (default: the
        nodes of every rank's stripe, `global_rows`), built at first use;
        a field that is None (no species, no graph ids) indexes row 0 for
        every node, as `repro`'s models read it.  Under ``rules`` the
        batch is a rank's stripe and its plans are cached apart from the
        one-process plans of the same field and rows."""
        n = global_rows(self.n_nodes, rules) if n is None else int(n)
        key = (field, n, node_entry(rules))
        if key not in self.plans:
            index = getattr(self, field)
            if index is None:      # no species / graph ids: all row 0
                index = torch.zeros(self.n_nodes, dtype=torch.int32,
                                    device=self.node_mask.device)
            self.plans[key] = segment_plan(index, n)
        return self.plans[key]

    def to(self, device) -> "GraphBatch":
        moved = {f: None if getattr(self, f) is None
                 else getattr(self, f).to(device) for f in _TENSOR_FIELDS}
        return GraphBatch(**moved, n_graphs=self.n_graphs,
                          plans={k: p.to(device)
                                 for k, p in self.plans.items()})
