"""Meshes: a `DeviceMesh` over the running ranks, and an abstract one.

Port of `repro.launch.mesh`.  `repro` lays its mesh over the devices of
one process; the port lays a torch `DeviceMesh` over the ranks of the
default process group, one rank a device (`repro_torch.dist.group`).

* :class:`MeshShape` — an abstract mesh (axis names and sizes, no
  process group), as `jax.sharding.AbstractMesh`: the sharding rules
  (`repro_torch.dist.sharding`) take it to compute specs and per-device
  bytes for a mesh larger than the one running, e.g. `repro`'s (16, 16)
  pod.
* :func:`make_mesh` — a `DeviceMesh` of the given shape over the running
  ranks, row-major (the last axis varies fastest, as `jax.make_mesh`
  lays out devices); :func:`make_debug_mesh` — its one-axis case.

* :func:`make_production_mesh` — `repro`'s production meshes, (16, 16)
  ``("data", "model")`` and (2, 16, 16) ``("pod", "data", "model")``, as
  `MeshShape`s laid over an H100 cluster (:class:`Topology`): nodes of 8
  H100 SXM cards on NVSwitch, InfiniBand between nodes, devices numbered
  row-major so the last axis varies fastest.  A ``model`` group of 16
  therefore spans two nodes and every ``data`` or ``pod`` group crosses
  InfiniBand: :meth:`Topology.link_bw` gives each axis the bandwidth of
  the slowest link its group crosses.
* :class:`RankView` — one rank's view of a `MeshShape`: its coordinates
  and an `AbstractGroup` per axis, so a `MeshRules` on it runs a sharded
  step on ``meta`` tensors in one process (the dry run).

The mesh's device type follows the default group's backend: ``"cuda"``
under NCCL, ``"cpu"`` under gloo (a host transport; gloo ranks may still
compute on the card, their collectives cross through the host).
"""

from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

# The H100 SXM5 cluster's links, per card and per direction (NVIDIA H100
# Tensor Core GPU datasheet, SXM5 column: NVLink 900 GB/s in both
# directions; one ConnectX-7 NDR InfiniBand port of 400 Gb/s per card).
NVLINK_BW = 450e9          # bytes/s, a card to the NVSwitch, one way
IB_BW = 50e9               # bytes/s, a card to the InfiniBand fabric
NODE_CARDS = 8             # H100 SXM cards per node, on one NVSwitch


class MeshShape:
    """An abstract mesh: ``shape`` maps each axis name to its size, in
    order (`jax.sharding.Mesh.shape`'s form); no devices, no group."""

    def __init__(self, shape, axis_names):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ "
                             "in length")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))

    def __repr__(self) -> str:
        return f"MeshShape({tuple(self.shape.values())}, {self.axis_names})"


def axis_names(mesh) -> tuple:
    """The axis names of a `MeshShape`, a `DeviceMesh` or a JAX mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """Axis name → size, for a `MeshShape`, a `DeviceMesh` or a JAX
    mesh."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def make_mesh(shape, names):
    """A `DeviceMesh` of ``shape`` with axes ``names`` over the ranks of
    the default group (their count must be the product of ``shape``).
    Every rank must call it: creating the axes' groups is collective."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the group has {dist.get_world_size()}")
    kind = "cuda" if str(dist.get_backend()) == "nccl" else "cpu"
    return init_device_mesh(kind, shape, mesh_dim_names=tuple(names))


def make_debug_mesh(n_devices: int | None = None, axis: str = "data"):
    """A one-axis mesh over ``n_devices`` ranks (all the running ranks when
    None) — tests only, as `repro`'s."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return make_mesh((n,), (axis,))


@dataclasses.dataclass(frozen=True)
class Topology:
    """Cards in nodes of ``node_cards`` on one NVSwitch (``nvlink_bw`` a
    card), nodes joined by InfiniBand (``ib_bw`` a card)."""

    node_cards: int = NODE_CARDS
    nvlink_bw: float = NVLINK_BW
    ib_bw: float = IB_BW

    def link_bw(self, mesh, axis: str) -> float:
        """The bandwidth of the slowest link a group along ``axis`` crosses:
        NVLink when the group's devices (row-major numbering) lie in one
        node, InfiniBand otherwise."""
        sizes = axis_sizes(mesh)
        names = list(sizes)
        stride = math.prod(sizes[a] for a in names[names.index(axis) + 1:])
        span = stride * sizes[axis]          # devices from first to last + 1
        inside = span <= self.node_cards and self.node_cards % span == 0
        return self.nvlink_bw if inside else self.ib_bw


H100_CLUSTER = Topology()


class ProductionMesh(MeshShape):
    """A `MeshShape` laid over a cluster (``topology``)."""

    def __init__(self, shape, axis_names, topology: Topology = H100_CLUSTER):
        super().__init__(shape, axis_names)
        self.topology = topology

    def __repr__(self) -> str:
        return (f"ProductionMesh({tuple(self.shape.values())}, "
                f"{self.axis_names})")


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """`repro`'s production mesh, abstract: (16, 16) ``("data", "model")``
    = 256 cards, or with ``multi_pod`` (2, 16, 16) ``("pod", "data",
    "model")`` = 512, on the H100 cluster (`H100_CLUSTER`: 32 or 64 nodes
    of 8).  The ``pod`` axis carries only data-parallel traffic by the
    sharding rules, and always crosses InfiniBand."""
    if multi_pod:
        return ProductionMesh((2, 16, 16), ("pod", "data", "model"))
    return ProductionMesh((16, 16), ("data", "model"))


class RankView(MeshShape):
    """Rank ``rank`` (row-major) of an abstract mesh, with the
    `DeviceMesh` methods a `MeshRules` calls: ``get_coordinate`` and
    ``get_group``, whose groups are `AbstractGroup`s (no process, no
    wire)."""

    def __init__(self, mesh, rank: int = 0):
        super().__init__(tuple(axis_sizes(mesh).values()), axis_names(mesh))
        n = math.prod(self.shape.values())
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} outside a mesh of {n}")
        coord, r = [], rank
        for size in reversed(list(self.shape.values())):
            coord.append(r % size)
            r //= size
        self.coord = tuple(reversed(coord))

    def get_coordinate(self) -> tuple:
        return self.coord

    def get_group(self, axis: str):
        from repro_torch.dist.group import AbstractGroup

        i = self.axis_names.index(axis)
        return AbstractGroup(self.shape[axis], self.coord[i], axis)

    def __repr__(self) -> str:
        return (f"RankView({tuple(self.shape.values())}, {self.axis_names}, "
                f"coord={self.coord})")
