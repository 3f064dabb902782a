"""TRC rules: host syncs and branches on values where there is no value
(the port's counterparts of `repro`'s TRC001 and TRC002).

`repro`'s hazards are JAX traces; the port has two places of the same kind.
A ``register_fake`` rule runs on ``meta`` tensors, which have shapes and no
values: a ``.item()`` or a Python ``if`` on a value fails there, or reads
nothing.  And an obs call takes host values only (ROADMAP's ground rule):
the trace records counters and tags as the caller hands them, so a
``.item()`` inside its arguments is a device sync the instrumentation
adds, on every call, even with tracing off.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Rule, dotted
from repro_torch.analysis.rules.obs_rules import obs_call

SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
SYNC_CALLS = frozenset({"torch.cuda.synchronize"})
# Tensor methods that read a value (a reduction or a test of one)
VALUE_METHODS = frozenset({
    "any", "all", "item", "sum", "max", "min", "mean", "equal", "allclose",
    "isnan", "isinf", "isfinite", "nonzero", "count_nonzero", "tolist",
    "argmax", "argmin",
})
# torch functions that answer from the state of the process, not a value
_TORCH_STATIC = ("torch.is_", "torch.cuda.is_", "torch.are_", "torch.get_",
                 "torch.device", "torch.Size", "torch.dtype", "torch.finfo",
                 "torch.iinfo", "torch.jit.", "torch.compiler.",
                 "torch.distributed.is_", "torch.version")


def sync_call(node: ast.Call) -> str | None:
    """``.item()``-family methods and `torch.cuda.synchronize`: the call's
    text, else None."""
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in SYNC_METHODS and not node.args:
        return f".{node.func.attr}()"
    name = dotted(node.func)
    if name in SYNC_CALLS:
        return f"{name}()"
    return None


class HostSync(Rule):
    id = "TRC101"
    repro_id = "TRC001"
    name = "host-sync-in-fake-rule-or-obs-argument"
    rationale = ("A `register_fake` rule runs on meta tensors (no values), "
                 "and obs calls take host values only: `.item()`, "
                 "`.tolist()`, `.cpu()`, `.numpy()` or "
                 "`torch.cuda.synchronize()` inside a fake rule, or inside "
                 "an argument of `span`/`trace`/`timed`/`counter_add`/"
                 "`gauge_set`/`gauge_max`, syncs the device (or fails on "
                 "meta).")
    node_types = (ast.Call,)

    def check_node(self, node, ctx):
        what = sync_call(node)
        if what and ctx.fake:
            yield ctx.diag(self, node,
                           f"`{what}` inside a register_fake rule: meta "
                           "tensors have no value to sync")
            return
        if ctx.fake or not obs_call(node):
            return
        args = list(node.args[1:]) + [kw.value for kw in node.keywords]
        for arg in args:
            for n in ast.walk(arg):
                if isinstance(n, ast.Call) and sync_call(n):
                    yield ctx.diag(
                        self, n,
                        f"`{sync_call(n)}` inside an argument of an obs "
                        "call: obs calls take host values only — read the "
                        "value once, outside the call")


def _reads_value(test) -> str | None:
    for n in ast.walk(test):
        if not isinstance(n, ast.Call):
            continue
        name = dotted(n.func) or ""
        if name.startswith("torch.") and not name.startswith(_TORCH_STATIC):
            return name
        if isinstance(n.func, ast.Attribute) \
                and n.func.attr in VALUE_METHODS:
            return f".{n.func.attr}"
    return None


class ValueBranch(Rule):
    id = "TRC102"
    repro_id = "TRC002"
    name = "python-branch-on-tensor-value-in-fake-rule"
    rationale = ("A `register_fake` rule runs on meta tensors: a Python "
                 "`if`/`while`/`assert` (or ternary) whose test reads a "
                 "tensor's value has no value to read; branch on shapes "
                 "and types only.")
    node_types = (ast.If, ast.While, ast.Assert, ast.IfExp)

    def check_node(self, node, ctx):
        if not ctx.fake:
            return
        what = _reads_value(node.test)
        if what:
            kind = type(node).__name__.lower()
            yield ctx.diag(
                self, node,
                f"Python `{kind}` on a tensor's value (`{what}(...)`) "
                "inside a register_fake rule — a meta tensor has none")
