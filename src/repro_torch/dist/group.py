"""The port's stand-in for a JAX mesh axis: a `torch.distributed` group.

`repro` runs its distributed code under ``shard_map`` over one mesh axis of
the local devices.  The port runs it across the ranks of a process group,
one process a rank.  This module holds what the distributed paths need
about that group and nothing more:

* :func:`active` — the group a call runs over: the one passed, else the
  default group when `torch.distributed` is initialized, else ``None``
  (one process, `repro`'s one-device path);
* :func:`rank_device` — a rank's device: ``cuda:{local_rank % count}``
  (``device=None`` means the card, as everywhere in the port), the CPU
  only when asked for;
* :func:`pick_ranks` — `repro.dist.refine_sharded._pick_devices` counting
  ranks: the largest divisor of the shard count that the group holds;
* :func:`subgroup` — the group of the first ``d`` ranks, created by every
  rank of the parent (`torch.distributed.new_group` is collective);
* the collectives the distributed paths call, each chosen by the
  backend's name (:data:`_HOST_WIRE`), never by catching a failed call:
  NCCL moves device tensors; gloo is a host transport, so a tensor on the
  card goes to the host for the call and comes back (one copy each way:
  on one H100 at 700 W, gloo's own CUDA path gathered a megabyte in 4–15
  ms and its point-to-point calls on device tensors aborted the ranks);
  over a group of one rank a host-wire collective is its input, and makes
  no round trip through the host.  A backend with no entry raises;
* the collectives under autograd that the sharded models call
  (:func:`all_reduce`, :func:`all_gather`, :func:`reduce_scatter`,
  :func:`all_to_all`), each a `torch.autograd.Function` whose backward is
  its transpose — all-reduce ↔ all-reduce, all-gather ↔ reduce-scatter,
  all-to-all ↔ the reverse all-to-all — over the same wire.  With these,
  the gradient a rank computes is its share of the gradient of the sum of
  the ranks' losses (`repro_torch.dist.sharding`);
* :func:`census` — while active, every collective that moves data reports
  ``(op, local output bytes, group size, axis)`` (host values, no sync):
  the roofline's input (`repro_torch.launch.roofline`);
* :class:`AbstractGroup` — a group of ``size`` ranks seen from one of them,
  with no wire: each collective answers with a ``meta`` tensor of the
  right shape (and reports to the census), so a sharded step runs on one
  process with no ranks (`repro_torch.launch.dryrun`);
* :func:`destroy` — drop every group the port caches, then destroy the
  default group.  A rank calls it at its end in place of
  `torch.distributed.destroy_process_group`: a cached group outlived that
  call until the interpreter shut down, and a gloo group freed there
  aborted the rank now and then (``terminate called without an active
  exception``).
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# Backends the distributed paths run on, and whether a tensor crosses the
# wire from the host (gloo) or from its own device (NCCL).
_HOST_WIRE = {"gloo": True, "nccl": False}

# `all_gather_single` is the newer name of `all_gather_into_tensor` (the
# old one warns where both exist); the same signature.
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class AbstractGroup:
    """A group of ``size`` ranks seen from rank ``rank``, along mesh axis
    ``axis``: no process and no wire.  The collectives here answer it with
    ``meta`` tensors of the shape the real call returns (and refuse any
    other tensor), after reporting to the census."""

    def __init__(self, size: int, rank: int = 0, axis: str | None = None):
        self.size, self.rank, self.axis = int(size), int(rank), axis

    def __repr__(self) -> str:
        return f"AbstractGroup({self.size}, rank={self.rank}, axis={self.axis!r})"


def active(group=None):
    """``group``; else the default group when `torch.distributed` is
    initialized; else ``None`` (one process)."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def rank(group) -> int:
    if isinstance(group, AbstractGroup):
        return group.rank
    return dist.get_rank(group)


def size(group) -> int:
    if isinstance(group, AbstractGroup):
        return group.size
    return dist.get_world_size(group)


# ---------------------------------------------------------------------------
# The census of collectives
# ---------------------------------------------------------------------------

class Census:
    """The collectives a run moved data through: ``records`` holds one
    ``(op, bytes, group size, axis)`` a call, ``bytes`` the call's local
    output (`repro`'s HLO census counts the same); a group of one rank
    moves nothing and is not recorded.  ``axes`` names the real groups a
    `MeshRules` handed out (id → mesh axis)."""

    def __init__(self):
        self.records: list = []
        self.axes: dict = {}

    def axis_of(self, group):
        if isinstance(group, AbstractGroup):
            return group.axis
        return self.axes.get(id(group))


_CENSUS: Census | None = None


@contextlib.contextmanager
def census():
    """Record every collective of the body (`Census`); nests by taking
    over the outer census until the body ends."""
    global _CENSUS
    outer, _CENSUS = _CENSUS, Census()
    try:
        yield _CENSUS
    finally:
        _CENSUS = outer


def name_axis(group, axis: str) -> None:
    """Tell the active census that ``group`` runs along mesh ``axis``."""
    if _CENSUS is not None:
        _CENSUS.axes[id(group)] = axis


def _note(op: str, shape, x: torch.Tensor, group) -> None:
    """Report one collective of local output ``shape`` (x's type) to the
    active census: shape × element size, host values only."""
    if _CENSUS is None:
        return
    n = size(group)
    if n > 1:
        nbytes = x.element_size()
        for d in shape:
            nbytes *= int(d)
        _CENSUS.records.append((op, nbytes, n, _CENSUS.axis_of(group)))


def _abstract(x: torch.Tensor, shape) -> torch.Tensor:
    """An `AbstractGroup`'s answer: a ``meta`` tensor of ``shape``."""
    if x.device.type != "meta":
        raise ValueError(f"an AbstractGroup moves only meta tensors, got one "
                         f"on {x.device}")
    return x.new_empty(tuple(shape))


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when it names one (the CPU, or a
    card by index); ``None`` or ``"cuda"`` is ``cuda:{local_rank %
    device_count}``, ``LOCAL_RANK`` if the launcher set it, else the rank
    in the default group.  Raises without a card unless the CPU was asked
    for (`repro_torch.device.resolve_device`)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get(
        "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def pick_ranks(n_shards: int, group, max_devices: int | None = None) -> int:
    """Largest divisor of ``n_shards`` that fits the group's size (and
    ``max_devices``): each of the first ``d`` ranks then owns a contiguous
    block of ``n_shards / d`` shards."""
    avail = size(group) if max_devices is None \
        else min(max_devices, size(group))
    for d in range(min(n_shards, avail), 0, -1):
        if n_shards % d == 0:
            return d
    return 1


_SUBGROUPS: dict = {}


def subgroup(group, d: int):
    """The group of ``group``'s first ``d`` ranks (``group`` itself when it
    has ``d``).  Every rank of ``group`` must call this with the same ``d``:
    creating a group is collective.  Made once per (group, d) and kept."""
    if d == size(group):
        return group
    key = (group, d)
    if key not in _SUBGROUPS:
        ranks = [dist.get_global_rank(group, r) for r in range(d)]
        _SUBGROUPS[key] = dist.new_group(ranks)
    return _SUBGROUPS[key]


_RELEASE: list = []


def on_destroy(fn):
    """Register ``fn`` (no arguments) to drop a cache that holds groups;
    `destroy` calls it.  Returns ``fn``."""
    _RELEASE.append(fn)
    return fn


def destroy() -> None:
    """End this rank's part in `torch.distributed`: destroy the subgroups
    `subgroup` made, drop every cached reference to a group (`on_destroy`),
    then destroy the default group.  Every group is then freed while the
    interpreter is whole, not during its shutdown."""
    for g in _SUBGROUPS.values():
        if isinstance(g, dist.ProcessGroup):
            dist.destroy_process_group(g)
    _SUBGROUPS.clear()
    for fn in _RELEASE:
        fn()
    if dist.is_initialized():
        dist.destroy_process_group()


def _backend(group) -> str:
    name = str(dist.get_backend(group))
    if name not in _HOST_WIRE:
        raise NotImplementedError(
            f"torch.distributed backend {name!r} is not supported by the "
            f"distributed paths (have {sorted(_HOST_WIRE)})")
    return name


def _alone(group) -> bool:
    """A group of one rank on a host wire: the collective is its input."""
    return size(group) == 1 and _HOST_WIRE[_backend(group)]


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    if _HOST_WIRE[_backend(group)]:
        return x.cpu()
    return x


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along dim 0, in rank order (each
    rank's ``x`` has the same shape); on ``x``'s device."""
    shape = (size(group) * x.shape[0],) + tuple(x.shape[1:])
    _note("all-gather", shape, x, group)
    if isinstance(group, AbstractGroup):
        return _abstract(x, shape)
    if _alone(group):
        return x.contiguous()
    xw = _to_wire(x.contiguous(), group)
    out = xw.new_empty(shape)
    _all_gather_single(out, xw, group=group)
    return out.to(x.device)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of ``x``, a new tensor on ``x``'s device."""
    _note("all-reduce", x.shape, x, group)
    if isinstance(group, AbstractGroup):
        return _abstract(x, x.shape)
    if _alone(group):
        return x.clone()
    xw = _to_wire(x, group).clone()
    dist.all_reduce(xw, op=dist.ReduceOp.SUM, group=group)
    return xw.to(x.device)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the ranks of ``x``, a new tensor on ``x``'s
    device (``pmax``)."""
    _note("all-reduce", x.shape, x, group)
    if isinstance(group, AbstractGroup):
        return _abstract(x, x.shape)
    if _alone(group):
        return x.clone()
    xw = _to_wire(x, group).clone()
    dist.all_reduce(xw, op=dist.ReduceOp.MAX, group=group)
    return xw.to(x.device)


def shift(x: torch.Tensor, group) -> torch.Tensor:
    """One ring hop: send ``x`` to the next rank, return the previous
    rank's (``ppermute`` with ``i → i+1 mod n``)."""
    _note("collective-permute", x.shape, x, group)
    if isinstance(group, AbstractGroup):
        return _abstract(x, x.shape)
    n, r = size(group), rank(group)
    send = _to_wire(x.contiguous(), group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (r + 1) % n),
                      group=group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (r - 1) % n),
                      group=group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device)


def broadcast_object(obj, group, src: int = 0):
    """``obj`` of ``group``'s rank ``src`` on every rank of ``group``."""
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src),
                               group=group)
    return box[0]


# ---------------------------------------------------------------------------
# Collectives along a tensor dim, and their autograd Functions
# ---------------------------------------------------------------------------

def _row_major(x: torch.Tensor) -> torch.Tensor:
    """``x`` with row-major strides.  Moving a dim back after a collective
    can leave a dim of size 1 with another stride, which `contiguous`
    keeps (the tensor counts as contiguous); a kernel may then take
    another path than on a row-major tensor, with other bits (a decode
    step's (B, 1, d) stream against the one process's)."""
    want, step = [], 1
    for n in reversed(x.shape):
        want.append(step)
        step *= n
    if x.stride() == tuple(reversed(want)):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def gather_dim(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (a tiled
    ``all_gather``); row-major, on ``x``'s device."""
    moved = x.movedim(dim, 0)
    return _row_major(all_gather_rows(moved, group).movedim(0, dim))


def scatter_sum_dim(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Σ over the ranks of ``x``, of which this rank keeps chunk ``rank`` of
    ``size(group)`` equal chunks along ``dim`` (a tiled ``psum_scatter``);
    row-major."""
    n = size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} chunks")
    shape = list(x.shape)
    shape[dim] //= n
    _note("reduce-scatter", shape, x, group)
    if isinstance(group, AbstractGroup):
        return _abstract(x, shape)
    if _alone(group):
        return _row_major(x)
    xw = _to_wire(x.movedim(dim, 0).contiguous(), group)
    out = xw.new_empty((x.shape[dim] // n,) + tuple(xw.shape[1:]))
    _reduce_scatter_single(out, xw, op=dist.ReduceOp.SUM, group=group)
    return _row_major(out.to(x.device).movedim(0, dim))


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """All-to-all over dim 0: chunk ``j`` of ``size(group)`` equal chunks
    goes to rank ``j``, and chunk ``i`` of the result came from rank
    ``i``."""
    n = size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split into "
                         f"{n} chunks")
    _note("all-to-all", x.shape, x, group)
    if isinstance(group, AbstractGroup):
        return _abstract(x, x.shape)
    if _alone(group):
        return x.contiguous()
    xw = _to_wire(x.contiguous(), group)
    out = torch.empty_like(xw)
    dist.all_to_all_single(out, xw, group=group)
    return out.to(x.device)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_sum_dim(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return scatter_sum_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks (``psum``); its backward all-reduces the
    gradient."""
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """`gather_dim` (``all_gather(tiled=True)``); its backward is the
    reduce-scatter of the gradient along ``dim``."""
    return _AllGather.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """`scatter_sum_dim` (``psum_scatter(tiled=True)``); its backward
    all-gathers the gradient along ``dim``."""
    return _ReduceScatter.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """`exchange` (``all_to_all(split_axis=0, concat_axis=0)``); its
    backward sends each gradient chunk back where its rows came from."""
    return _AllToAll.apply(x, group)
