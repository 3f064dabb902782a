"""Fault-tolerant checkpointing: atomic save, restore, keep-last-k.

Port of `repro.train.checkpoint` with its file format, so that a
checkpoint written by either package loads in the other:
``ckpt_%08d.npz`` holding arrays ``a0``, ``a1``, … and a ``manifest`` JSON
(step, leaf names, dtypes, shapes, extra).  The leaves come in JAX's
flattening order (dict keys sorted) and are named as
``jax.tree_util.keystr`` names them (``['layers']['wq']``).  A file is
written to a temporary name and renamed into place, so a preemption
mid-write never leaves a torn latest checkpoint; `CheckpointManager`
keeps the last ``keep`` and restores the newest that loads.

Trees are nested dicts (and lists) of tensors or arrays; a tensor is saved
from the host (``.cpu().numpy()``: NumPy's types, so no bfloat16 leaf).
`load_checkpoint` returns tensors on the devices of ``like``'s leaves.

Elastic restart: `reshard` places a host tree on a mesh of ranks, each
rank keeping its block of every leaf (`repro`'s ``reshard``, whose
``device_put`` with a ``NamedSharding`` puts each device's block on it);
`unshard` gathers a placed tree back to full arrays on every rank, as
`repro` persists a sharded tree, so a checkpoint written from one mesh
restores onto another (4 ranks → 8) bit for bit.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_unflatten


def _flatten_with_names(tree, path: str = "") -> tuple[list, list]:
    """(names, leaves) in JAX's order, names as ``keystr`` writes them."""
    if isinstance(tree, dict):
        names, leaves = [], []
        for k in sorted(tree):
            n, l = _flatten_with_names(tree[k], f"{path}[{k!r}]")
            names += n
            leaves += l
        return names, leaves
    if isinstance(tree, (list, tuple)):
        names, leaves = [], []
        for i, v in enumerate(tree):
            n, l = _flatten_with_names(v, f"{path}[{i}]")
            names += n
            leaves += l
        return names, leaves
    if tree is None:
        return [], []
    return [path], [tree]


def _placed(arr: np.ndarray, like):
    """A loaded array as a tensor on the device of ``like`` (a tensor), or
    as it is."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(like.device)
    return arr


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, step: int, tree, *,
                    extra: dict | None = None) -> str:
    """Atomic save of a tree; returns the final file path."""
    os.makedirs(path, exist_ok=True)
    names, leaves = _flatten_with_names(tree)
    arrays = {f"a{i}": _host(l) for i, l in enumerate(leaves)}
    manifest = {
        "step": int(step),
        "names": names,
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "shapes": [list(a.shape) for a in arrays.values()],
        "extra": extra or {},
    }
    final = os.path.join(path, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, manifest=json.dumps(manifest), **arrays)
        os.replace(tmp, final)  # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return final


def load_checkpoint(file: str, like):
    """Restore into the structure of ``like``: (step, tree, manifest)."""
    with np.load(file, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        leaves = [z[f"a{i}"] for i in range(len(manifest["names"]))]
    like_leaves = tree_leaves(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, expected {len(like_leaves)}")
    tree = tree_unflatten(like, [_placed(a, l)
                                 for a, l in zip(leaves, like_leaves)])
    return manifest["step"], tree, manifest


class CheckpointManager:
    """Keep-last-k manager with torn-file tolerance."""

    _PAT = re.compile(r"ckpt_(\d+)\.npz$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def all_steps(self) -> list:
        out = []
        for f in os.listdir(self.directory):
            m = self._PAT.match(f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_file(self) -> str | None:
        steps = self.all_steps()
        return (os.path.join(self.directory, f"ckpt_{steps[-1]:08d}.npz")
                if steps else None)

    def save(self, step: int, tree, *, extra: dict | None = None) -> str:
        f = save_checkpoint(self.directory, step, tree, extra=extra)
        self._gc()
        return f

    def restore_latest(self, like):
        """Newest valid checkpoint (skipping torn files); None if none."""
        for step in reversed(self.all_steps()):
            f = os.path.join(self.directory, f"ckpt_{step:08d}.npz")
            try:
                return load_checkpoint(f, like)
            except Exception:
                continue  # torn/corrupt → try previous
        return None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            try:
                os.unlink(os.path.join(self.directory, f"ckpt_{s:08d}.npz"))
            except OSError:
                pass


def reshard(tree, mesh, spec_tree, device=None):
    """This rank's placement of a host tree on ``mesh`` (a `DeviceMesh`
    over the running ranks): each leaf's block under its spec
    (`repro_torch.dist.sharding.local_slice` at this rank's coordinates),
    copied to ``device`` (None: this rank's card, `dist.group.rank_device`)
    — the elastic-restart path: the mesh may differ from the one the tree
    was saved from."""
    from repro_torch.dist.group import rank_device
    from repro_torch.dist.sharding import local_slice, spec_map
    from repro_torch.launch.mesh import axis_names

    dev = rank_device(device)
    coords = dict(zip(axis_names(mesh), mesh.get_coordinate()))

    def put(x, spec):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.asarray(x))
        return local_slice(t, spec, coords, mesh).to(dev, copy=True)

    return spec_map(put, tree, spec_tree)


def unshard(tree, mesh, spec_tree):
    """The full leaves of a tree placed by `reshard`, on every rank: each
    leaf's blocks all-gathered along the dims its spec shards (the tensors
    stay on their devices)."""
    from repro_torch.dist.group import gather_dim
    from repro_torch.dist.sharding import entry_axes, spec_map

    def full(x, spec):
        for dim, entry in enumerate(spec):
            for a in reversed(entry_axes(entry)):
                x = gather_dim(x, mesh.get_group(a), dim)
        return x

    return spec_map(full, tree, spec_tree)
