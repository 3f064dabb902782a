"""Logical-axis → mesh-axis sharding rules for every model family.

Port of `repro.dist.sharding`.  Models name the axes of their weights and
activations (``"batch"``, ``"heads"``, ``"experts"`` …) through the
`repro_torch.models.common.ShardRules` hook; :class:`MeshRules` maps them
onto the mesh axes (``"pod"``, ``"data"``, ``"model"``).  The mapping is
divisibility-guarded, as `repro`'s: a logical axis whose dimension does
not divide its mesh axes' product stays replicated, and each mesh axis is
used once (the first logical axis that asks for it wins), so one rule set
serves every config from the 1.1B dense LM to the 123B GQA model.

The mesh is a `repro_torch.launch.mesh.MeshShape` (specs only, any size),
a torch `DeviceMesh` over the running ranks, or a
`repro_torch.launch.mesh.RankView` (one rank of an abstract mesh: the
sharded models run on ``meta`` tensors, the dry run).  On a `DeviceMesh` the
rules also run the sharded models: `repro` leaves the partitioning of its
math to GSPMD, the port's models slice their work by the spec
:meth:`MeshRules.spec` returns for each actual shape and call the
collectives here (`repro_torch.dist.group`'s autograd Functions, one mesh
axis at a time), so ``shard`` returns its input unchanged.

Gradients follow GSPMD's sum: under a `MeshRules` a loss is the global
loss on every rank, and the gradient a rank computes is its share of the
gradient of the sum of the ranks' losses, each counted 1 / (ranks);
:func:`reduce_grads` sums each leaf's shares over the ranks that hold the
same slice (the mesh axes its spec leaves out), and :func:`global_norm`
counts each slice once.

* :class:`Spec` — the port's ``PartitionSpec``: a tuple, one entry per
  dim, each None, a mesh axis, or a tuple of axes (a one-axis tuple is its
  name, as `PartitionSpec` normalises it).
* :func:`placements` — a spec's DTensor placements per mesh dim;
  :func:`local_slice` — what the rank at given coordinates holds.
* :func:`lm_rules`, :func:`gnn_rules`, :func:`recsys_rules`;
  :func:`param_specs_lm`, :func:`cache_specs_lm`, :func:`batch_specs_lm`,
  :func:`param_specs_recsys` — `repro`'s rule tables and spec trees, over
  the port's parameter keys (`repro`'s).
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist import group as dist_group
from repro_torch.launch.mesh import axis_names, axis_sizes
from repro_torch.models.common import ShardRules, tree_leaves, tree_map


def _entry(d):
    if d is None or isinstance(d, str):
        return d
    d = tuple(d)
    if not d:
        return None
    return d[0] if len(d) == 1 else d


class Spec(tuple):
    """A ``PartitionSpec``: one entry per dim — None (replicated), a mesh
    axis name, or a tuple of axis names (sharded over their product, the
    first axis major)."""

    def __new__(cls, *dims):
        return super().__new__(cls, tuple(_entry(d) for d in dims))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _linear(axes, coords: dict, sizes: dict) -> int:
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def local_slice(x: torch.Tensor, spec, coords: dict, mesh) -> torch.Tensor:
    """The block of ``x`` that the rank at ``coords`` (axis name → index)
    of ``mesh`` holds under ``spec``: along each sharded dim, chunk
    ``linear index`` of ``Π sizes`` equal chunks (a view)."""
    sizes = axis_sizes(mesh)
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n} shards)")
        c = x.shape[dim] // n
        x = x.narrow(dim, _linear(axes, coords, sizes) * c, c)
    return x


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` for a
    mesh axis that shards tensor dim ``dim``, ``Replicate()`` for one that
    shards none.  An entry over several axes must name them in the mesh's
    order (DTensor shards a dim over mesh dims left to right)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's "
                             f"order {names}")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return tuple(out)


class MeshRules(ShardRules):
    """`ShardRules` bound to a mesh and a logical → mesh-axis table.

    ``table`` maps a logical name to a mesh axis, a tuple of axes (sharded
    over their product) or None (replicated); names of axes the mesh lacks
    are dropped.  On a `DeviceMesh` the rules also know this rank's
    coordinates and run the collectives the sharded models call
    (:meth:`psum`, :meth:`gather`, :meth:`all_to_all`)."""

    def __init__(self, mesh, table: dict):
        self.mesh = mesh
        self.table = dict(table)
        self.layer_specs = None
        self.sizes = axis_sizes(mesh)

    @property
    def mesh_axis_names(self) -> tuple:
        return axis_names(self.mesh)

    def _axes_for(self, name):
        ent = self.table.get(name)
        if ent is None:
            return None
        ent = tuple(a for a in entry_axes(ent) if a in self.sizes)
        return ent or None

    def spec(self, logical, shape=None) -> Spec:
        """The spec of a tuple of logical axis names: each mesh axis used
        at most once (the first logical axis wins), and a dim that its
        axes' product does not divide stays replicated."""
        used: set = set()
        dims = []
        for i, name in enumerate(logical):
            axes = self._axes_for(name) if name is not None else None
            if axes:
                axes = tuple(a for a in axes if a not in used)
            if axes and shape is not None:
                if int(shape[i]) % math.prod(self.sizes[a] for a in axes):
                    axes = None
            if axes:
                used.update(axes)
                dims.append(axes)
            else:
                dims.append(None)
        return Spec(*dims)

    def shard(self, x: torch.Tensor, logical) -> torch.Tensor:
        """The tensor unchanged: the port's models slice their work
        explicitly, there is no GSPMD to constrain."""
        return x

    # -- this rank on a DeviceMesh ---------------------------------------

    def _device_mesh(self):
        if not hasattr(self.mesh, "get_group"):
            raise TypeError(f"{self.mesh!r} is an abstract mesh: it gives "
                            "specs, a sharded run needs a DeviceMesh")
        return self.mesh

    @property
    def coords(self) -> dict:
        """Axis name → this rank's index along it."""
        return dict(zip(self.mesh_axis_names,
                        self._device_mesh().get_coordinate()))

    def count(self, entry) -> int:
        """The number of shards of a spec entry (1 when replicated)."""
        return math.prod(self.sizes[a] for a in entry_axes(entry))

    def index(self, entry) -> int:
        """This rank's shard of a spec entry (0 when replicated)."""
        return _linear(entry_axes(entry), self.coords, self.sizes)

    def group(self, axis: str):
        g = self._device_mesh().get_group(axis)
        dist_group.name_axis(g, axis)
        return g

    @property
    def n_ranks(self) -> int:
        return math.prod(self.sizes.values())

    def local(self, x: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of ``x`` under ``spec``."""
        return local_slice(x, spec, self.coords, self.mesh)

    def psum(self, x: torch.Tensor, entry) -> torch.Tensor:
        """Σ over the ranks along the entry's axes (one axis at a time),
        under autograd."""
        for a in entry_axes(entry):
            x = dist_group.all_reduce(x, self.group(a))
        return x

    def pmax(self, x: torch.Tensor, entry) -> torch.Tensor:
        """The elementwise max along the entry's axes (no gradient)."""
        for a in entry_axes(entry):
            x = dist_group.all_reduce_max(x, self.group(a))
        return x

    def gather(self, x: torch.Tensor, entry, dim: int) -> torch.Tensor:
        """The shards along the entry's axes concatenated along ``dim`` in
        shard order, under autograd (its backward reduce-scatters)."""
        for a in reversed(entry_axes(entry)):
            x = dist_group.all_gather(x, self.group(a), dim)
        return x

    def scatter(self, x: torch.Tensor, entry, dim: int) -> torch.Tensor:
        """Σ over the ranks along the entry's axes, each rank keeping its
        shard of ``dim`` (``psum_scatter(tiled=True)``; the inverse order
        of :meth:`gather`), under autograd (its backward all-gathers)."""
        for a in entry_axes(entry):
            x = dist_group.reduce_scatter(x, self.group(a), dim)
        return x

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """`repro_torch.dist.group.all_to_all` over one mesh axis."""
        return dist_group.all_to_all(x, self.group(axis))


def _data_axes(mesh) -> tuple:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _model_axis(mesh):
    return "model" if "model" in axis_names(mesh) else None


def lm_rules(mesh, *, seq_shard: bool = True) -> MeshRules:
    """Transformer LM rules: DP over pod/data, TP (+SP) over model.

    ``seq_shard`` maps the residual stream's sequence dim (``act_seq``)
    onto the model axis; heads, FFN, vocab and experts shard over model;
    expert weights FSDP over data."""
    model = _model_axis(mesh)
    data = _data_axes(mesh)
    return MeshRules(mesh, {
        "batch": data,
        "act_seq": model if seq_shard else None,
        "seq": None,
        "heads": model,
        "kv_heads": model,
        "embed": None,
        "ffn": model,
        "vocab": model,
        "experts": model,
        "expert_ffn": None,
        "fsdp": data,
    })


def gnn_rules(mesh) -> MeshRules:
    """GNN rules: nodes/edges stripe over every mesh axis (graph DP)."""
    names = axis_names(mesh)
    every = tuple(a for a in ("pod", "data", "model") if a in names)
    return MeshRules(mesh, {
        "nodes": every,
        "edges": every,
        "batch": _data_axes(mesh),
    })


def recsys_rules(mesh) -> MeshRules:
    """Recsys rules: user batch over data axes, item vocab over model."""
    return MeshRules(mesh, {
        "batch": _data_axes(mesh),
        "vocab": _model_axis(mesh),
    })


def param_specs_recsys(cfg, params_abs, mesh) -> dict:
    """SASRec's spec tree: ``item_embed``'s rows over the vocab's axes
    (``Spec("model", None)``, divisibility-guarded), every other leaf
    replicated."""
    specs = tree_map(lambda _: Spec(), params_abs)
    specs["item_embed"] = recsys_rules(mesh).spec(
        ("vocab", None), tuple(params_abs["item_embed"].shape))
    return specs


# ---------------------------------------------------------------------------
# LM param / cache / batch specs (placement, checkpoint reshard)
# ---------------------------------------------------------------------------

_LAYER_LOGICAL = {
    "attn_norm": (None,),
    "ffn_norm": (None,),
    "wq": (None, "heads", None),
    "wk": (None, "kv_heads", None),
    "wv": (None, "kv_heads", None),
}
_FFN_LOGICAL = {
    "wi": (None, "ffn"),
    "wg": (None, "ffn"),
    "wo": ("ffn", None),
}
_MOE_LOGICAL = {
    "router": (None, None),
    "wi": ("experts", "fsdp", None),
    "wg": ("experts", "fsdp", None),
    "wo": ("experts", None, "fsdp"),
    "shared_wi": (None, "ffn"),
    "shared_wg": (None, "ffn"),
    "shared_wo": ("ffn", None),
}


def lm_logical(keys: tuple, ndim: int) -> tuple:
    """The logical axes of the LM parameter at path ``keys`` (``("layers",
    "moe", "wi")``), with a leading None for the stacked layer dim."""
    name, parent = keys[-1], (keys[-2] if len(keys) > 1 else None)
    stacked = keys[0] == "layers"
    if name == "embed":
        logical = ("vocab", None)
    elif name == "head":
        logical = (None, "vocab")
    elif name == "final_norm":
        logical = (None,)
    elif parent == "ffn":
        logical = _FFN_LOGICAL[name]
    elif parent == "moe":
        logical = _MOE_LOGICAL[name]
    elif name in _LAYER_LOGICAL:
        logical = _LAYER_LOGICAL[name]
    elif name == "wo":
        logical = ("heads", None, None)   # attention out-projection
    else:
        logical = (None,) * (ndim - int(stacked))
    return ((None,) + tuple(logical)) if stacked else tuple(logical)


def tree_specs(rules: MeshRules, tree: dict, layer: bool = False) -> dict:
    """The rules' spec of every leaf of an LM parameter tree (`repro`'s
    keys; leaves are anything with a ``shape``, their full shapes).  With
    ``layer`` the tree is one layer of ``layers``, its leaves without the
    stacked dim."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        ndim = len(t.shape)
        if layer:
            logical = lm_logical(("layers",) + path, ndim + 1)[1:]
        else:
            logical = lm_logical(path, ndim)
        return rules.spec(logical, tuple(t.shape))

    return walk(tree, ())


def param_specs_lm(cfg, params_abs, mesh) -> dict:
    """The spec tree of an LM parameter tree (stacked layers, `repro`'s
    keys; leaves are anything with a ``shape``): attention, FFN and expert
    weights over "model" (tensor parallel), expert weights also FSDP over
    the data axes, embed and head over the vocab dim; every entry
    divisibility-guarded by the leaf's shape."""
    return tree_specs(lm_rules(mesh), params_abs)


def cache_specs_lm(cfg, mesh) -> dict:
    """KV-cache specs: (layers, batch, seq, kv_heads, d_head)."""
    data = _data_axes(mesh)
    model = _model_axis(mesh)
    if model is not None and cfg.n_kv_heads % axis_sizes(mesh)[model] != 0:
        model = None
    spec = Spec(None, data if data else None, None, model, None)
    return {"k": spec, "v": spec}


def batch_specs_lm(mesh) -> dict:
    """Token batch specs: batch dim over the data axes."""
    data = _data_axes(mesh)
    spec = Spec(data if data else None, None)
    return {"tokens": spec, "labels": spec}


def spec_leaves(spec_tree) -> list:
    """A spec tree's specs in JAX's leaf order (a `Spec` is a leaf)."""
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree) for s in spec_leaves(spec_tree[k])]
    return [spec_tree]


def spec_bytes(tree_abs, spec_tree, mesh, dtype_bytes=None) -> int:
    """Bytes one device holds of ``tree_abs`` (leaves with ``shape`` and
    ``dtype``) placed by ``spec_tree`` on ``mesh``: each leaf's numel over
    its shard count (``dtype_bytes`` overrides the leaves' size)."""
    sizes = axis_sizes(mesh)
    total = 0
    for leaf, spec in zip(tree_leaves(tree_abs), spec_leaves(spec_tree)):
        n = math.prod(sizes[a] for e in spec for a in entry_axes(e))
        size = dtype_bytes or leaf.element_size()
        total += leaf.numel() // n * size
    return total


# ---------------------------------------------------------------------------
# Gradients of sharded trees
# ---------------------------------------------------------------------------

def replica_axes(spec, rules: MeshRules) -> tuple:
    """The mesh axes a spec leaves out: the ranks along them hold the same
    slice."""
    used = {a for e in spec for a in entry_axes(e)}
    return tuple(a for a in rules.mesh_axis_names if a not in used)


def spec_map(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over a tree and its spec tree (a `Spec` is a
    leaf)."""
    if isinstance(tree, dict):
        return {k: spec_map(fn, v, spec_tree[k]) for k, v in tree.items()}
    return fn(tree, spec_tree)


def reduce_grads(grads, spec_tree, rules: MeshRules):
    """Each leaf's gradient shares summed over the ranks that hold the
    same slice (`replica_axes`), one axis at a time (no autograd)."""
    def one(g, spec):
        for a in replica_axes(spec, rules):
            # one all-reduce a mesh axis: a torch group spans one axis,
            # where GSPMD's psum takes them together (a loop over axes,
            # not over data)
            g = dist_group.all_reduce_sum(g, rules.group(a))  # repro: ignore[DIST101]
        return g

    return spec_map(one, grads, spec_tree)


def global_norm(tree, spec_tree, rules: MeshRules) -> torch.Tensor:
    """√(Σ over the leaves of the whole (unsharded) tree of Σ x²), in
    fp32, on every rank: each leaf's local Σ x², counted on the first
    replica of its slice only, summed over the ranks in one all-reduce,
    then over the leaves in JAX's order (`train.optimizer.global_norm`'s
    order, so one rank gives its bits)."""
    leaves = tree_leaves(tree)
    specs = spec_leaves(spec_tree)
    coords = rules.coords
    sq = []
    for leaf, spec in zip(leaves, specs):
        s = torch.sum(leaf.float() ** 2)
        if any(coords[a] for a in replica_axes(spec, rules)):
            s = torch.zeros_like(s)
        sq.append(s)
    sums = torch.stack(sq)
    for a in rules.mesh_axis_names:
        # one all-reduce a mesh axis, as in `reduce_grads`
        sums = dist_group.all_reduce_sum(sums, rules.group(a))  # repro: ignore[DIST101]
    total = sums[0]
    for i in range(1, len(leaves)):
        total = total + sums[i]
    return torch.sqrt(total)


__all__ = [
    "MeshRules", "Spec", "batch_specs_lm", "cache_specs_lm", "entry_axes",
    "global_norm", "gnn_rules", "lm_logical", "lm_rules",
    "local_slice", "param_specs_lm", "param_specs_recsys", "placements",
    "recsys_rules",
    "reduce_grads", "replica_axes", "spec_bytes", "spec_leaves", "spec_map",
    "tree_specs",
]
