"""DIST rules: collective discipline across ranks (the port's counterparts
of `repro`'s DIST001 and DIST002).

The port's distributed code calls the collectives of `dist/group.py` and
of `dist.sharding.MeshRules` on every rank of a group.  A collective inside
a loop body of such a protocol function multiplies the wire volume per
sweep (the sharded refinement is built on one fused gather a sweep), and
an axis name that no mesh has is a typo `DeviceMesh.get_group` reports
only at run time, on every rank at once.
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import Rule, dotted, receiver, suffix

# Names that are collectives wherever they are called from (bare, on
# `dist_group`, `torch.distributed`, a `MeshRules`…).
COLLECTIVES = frozenset({
    # MeshRules
    "psum", "pmax",
    # dist/group.py
    "all_reduce", "all_reduce_sum", "all_reduce_max", "all_gather",
    "all_gather_rows", "gather_dim", "scatter_sum_dim", "reduce_scatter",
    "all_to_all", "broadcast", "broadcast_object",
    # torch.distributed
    "all_gather_into_tensor", "all_gather_single", "reduce_scatter_tensor",
    "reduce_scatter_single", "all_to_all_single", "all_gather_object",
    "broadcast_object_list", "batch_isend_irecv",
})
# Names that are collectives only on a group module or a rules object
# (`torch.gather`, `Tensor.scatter`, `np.roll`-like `shift` are not).
RECEIVED_COLLECTIVES = frozenset({"gather", "scatter", "shift", "exchange",
                                  "send", "recv", "isend", "irecv"})
_GROUP_MODULES = frozenset({"dist", "dist_group", "group",
                            "torch.distributed"})
_RULES = re.compile(r"(^|[._])rules$")
# MeshRules methods: the index of the argument that names mesh axes
_AXIS_ARG = {"psum": 1, "pmax": 1, "gather": 1, "scatter": 1,
             "all_to_all": 1, "group": 0, "count": 0, "index": 0}
_LOGICAL_ARG = {"spec": 0, "shard": 1}


def rules_receiver(node: ast.Call) -> bool:
    """``<…>rules.method(...)``: a call on a `MeshRules`."""
    recv = receiver(node)
    return bool(recv) and bool(_RULES.search(recv))


def collective(node: ast.Call) -> str | None:
    """The collective's name if ``node`` calls one, else None."""
    name = dotted(node.func)
    sfx = suffix(name)
    if not name:
        return None
    if name.startswith(("torch.", "np.", "numpy.")) \
            and not name.startswith("torch.distributed."):
        return None
    if sfx in COLLECTIVES:
        return sfx
    if sfx in RECEIVED_COLLECTIVES:
        recv = receiver(node)
        if recv in _GROUP_MODULES or rules_receiver(node):
            return sfx
    return None


def _strings(arg) -> list:
    """The string literals of one argument (a name, or a tuple of names,
    nested)."""
    return [(n, n.value) for n in ast.walk(arg)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


class CollectiveInLoop(Rule):
    id = "DIST101"
    repro_id = "DIST001"
    name = "collective-inside-loop-body"
    rationale = ("A protocol function (one that takes a `group` or `rules`) "
                 "runs on every rank; a collective at loop depth >= 1 in it "
                 "multiplies the wire volume per sweep, where the protocol "
                 "is one fused collective a sweep.  A loop the protocol "
                 "needs carries a suppression naming why.")
    node_types = (ast.Call,)

    def check_node(self, node, ctx):
        name = collective(node)
        if name is None or not ctx.protocol or ctx.loop_depth < 1:
            return
        yield ctx.diag(
            self, node,
            f"collective `{name}` at loop depth {ctx.loop_depth} inside a "
            "protocol function — hoist it or batch the payload into one "
            "collective")


class UnknownAxisName(Rule):
    id = "DIST102"
    repro_id = "DIST002"
    name = "unknown-axis-name"
    rationale = ("A mesh axis given to a `Spec`, `make_mesh` or a "
                 "`MeshRules` collective must be one of the production "
                 "meshes' axes (`launch/mesh.py`), and a logical axis given "
                 "to `rules.spec`/`rules.shard` one of the rule tables' "
                 "names (`dist/sharding.py`); a typo fails at run time, on "
                 "every rank, far from the typo.")
    node_types = (ast.Call,)

    def _bad(self, node, literals, vocab, what, ctx):
        for n, value in literals:
            if value not in vocab:
                yield ctx.diag(self, n,
                               f"{what} {value!r} is not one of "
                               f"{sorted(vocab)}")

    def check_node(self, node, ctx):
        axes, logical = ctx.project.mesh_axes, ctx.project.logical_axes
        sfx = suffix(dotted(node.func))
        if axes and sfx == "Spec" and not rules_receiver(node):
            for arg in node.args:
                yield from self._bad(node, _strings(arg), axes, "mesh axis",
                                     ctx)
        elif axes and sfx == "make_mesh" and len(node.args) > 1:
            yield from self._bad(node, _strings(node.args[1]), axes,
                                 "mesh axis", ctx)
        elif rules_receiver(node):
            if axes and sfx in _AXIS_ARG and len(node.args) > _AXIS_ARG[sfx]:
                yield from self._bad(node, _strings(node.args[_AXIS_ARG[sfx]]),
                                     axes, "mesh axis", ctx)
            elif logical and sfx in _LOGICAL_ARG \
                    and len(node.args) > _LOGICAL_ARG[sfx]:
                yield from self._bad(
                    node, _strings(node.args[_LOGICAL_ARG[sfx]]), logical,
                    "logical axis", ctx)
