"""OBS rules: instrumentation drift (`repro`'s OBS001 and OBS002, the same
rules over the port's registry).

Span and metric names are load-bearing: the manifest's drift guard
(`obs.export.validate_manifest`) and the tests join on them.  The runtime
guard only sees names on executed paths; these rules pin every call site:
a name used anywhere in the port must be declared in
`repro_torch.obs.registry` (``register(...)`` for metrics, ``SPAN_NAMES`` /
``SPAN_PREFIXES`` for spans).
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Rule, dotted, suffix

SPAN_FNS = frozenset({"span", "timed", "trace"})
METRIC_FNS = frozenset({"counter_add", "gauge_set", "gauge_max"})


def obs_call(node: ast.Call, fns=SPAN_FNS | METRIC_FNS) -> str | None:
    """The obs entry point's name if this is a call to one, else None.
    Accepts ``obs.span(...)``, ``trace.span(...)`` and a bare ``span(...)``;
    rejects unrelated ``.trace()`` methods by requiring a string-literal or
    f-string first argument."""
    sfx = suffix(dotted(node.func))
    if sfx not in fns or not node.args:
        return None
    first = node.args[0]
    if isinstance(first, ast.Constant) and isinstance(first.value, str):
        return sfx
    if isinstance(first, ast.JoinedStr):
        return sfx
    return None


def _static_prefix(js: ast.JoinedStr) -> str:
    out = []
    for part in js.values:
        if isinstance(part, ast.Constant) and isinstance(part.value, str):
            out.append(part.value)
        else:
            break
    return "".join(out)


class UndeclaredSpan(Rule):
    id = "OBS001"
    repro_id = "OBS001"
    name = "undeclared-span-name"
    rationale = ("Every span name must be declared in "
                 "`obs/registry.py` (`SPAN_NAMES`/`SPAN_PREFIXES`) so the "
                 "drift guard and trace consumers share one vocabulary; "
                 "an undeclared span silently escapes the manifest "
                 "validation.")
    node_types = (ast.Call,)

    def check_node(self, node, ctx):
        if not obs_call(node, SPAN_FNS):
            return
        proj = ctx.project
        if not proj.span_names and not proj.span_prefixes:
            return                      # no registry in scope
        first = node.args[0]
        if isinstance(first, ast.Constant):
            name = first.value
            if not proj.span_declared(name):
                yield ctx.diag(self, node,
                               f"span name {name!r} is not declared in "
                               "obs/registry.py (SPAN_NAMES/SPAN_PREFIXES)")
        else:                           # f-string: the static prefix decides
            prefix = _static_prefix(first)
            if not prefix:
                yield ctx.diag(self, node,
                               "span name is fully dynamic (f-string with "
                               "no static prefix) — declare a stable "
                               "prefix in obs/registry.py")
            elif not any(prefix.startswith(p) or p.startswith(prefix)
                         for p in proj.span_prefixes):
                yield ctx.diag(self, node,
                               f"span prefix {prefix!r} is not declared in "
                               "obs/registry.py SPAN_PREFIXES")


class UnregisteredMetric(Rule):
    id = "OBS002"
    repro_id = "OBS002"
    name = "unregistered-metric-name"
    rationale = ("`counter_add`/`gauge_set`/`gauge_max` names must be "
                 "registered in `obs/registry.py`: unregistered names "
                 "merge with default counter semantics and carry no "
                 "unit/description, so exporters and tables mislabel "
                 "them.")
    node_types = (ast.Call,)

    def check_node(self, node, ctx):
        if not obs_call(node, METRIC_FNS):
            return
        proj = ctx.project
        if not proj.metric_names:
            return
        first = node.args[0]
        if isinstance(first, ast.JoinedStr):
            yield ctx.diag(self, node,
                           "metric name is dynamic (f-string); metric "
                           "names must be static literals registered in "
                           "obs/registry.py")
        elif first.value not in proj.metric_names:
            yield ctx.diag(self, node,
                           f"metric {first.value!r} is not registered in "
                           "obs/registry.py — register() it with a kind "
                           "and description")
