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

The mesh's device type follows the default group's backend: ``"cuda"``
under NCCL, ``"cpu"`` under gloo (a host transport; gloo ranks may still
compute on the card, their collectives cross through the host).
:func:`make_production_mesh` (the TPU pod topology and its H100 / NVLink
analogue) waits for the launch slice (ROADMAP D5) and raises.
"""

from __future__ import annotations

import math

import torch.distributed as dist


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


def make_production_mesh(*, multi_pod: bool = False):
    """`repro`'s (16, 16) / (2, 16, 16) TPU pod meshes: their H100 /
    NVLink analogue is the launch slice's (ROADMAP D5)."""
    raise NotImplementedError(
        "make_production_mesh: the production topology (repro's "
        f"{'(2, 16, 16)' if multi_pod else '(16, 16)'} pod mesh, and its "
        "H100 / NVLink analogue) waits for the launch slice (ROADMAP D5); "
        "use MeshShape for specs and make_mesh over running ranks")
