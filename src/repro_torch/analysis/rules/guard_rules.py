"""GRD rules: guard-code hygiene (`repro`'s GRD001 and GRD002, the same
rules over the port's catalogs).

Chaos sites and GuardError codes are string-keyed protocols: a typo'd site
never fires (the chaos test silently tests nothing), and an uncataloged
error code cannot be branched on by callers.  Both catalogs live in one
place (`guard/chaos.py` ``FAULT_SITES``, `guard/errors.py` ``KNOWN_CODES``)
and every literal use must come from them.
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import Diagnostic, Rule, dotted, suffix

_SITE_FNS = frozenset({"should_fire", "enabled", "overlay", "configure"})
_KEBAB = re.compile(r"^[a-z0-9]+(-[a-z0-9]+)*$")


def _chaos_base(name: str | None) -> bool:
    """Only calls rooted at the chaos module (or a bare ``should_fire`` /
    ``overlay``): ``.enabled(`` / ``.configure(`` are common method names
    elsewhere."""
    if not name:
        return False
    parts = name.split(".")
    if len(parts) >= 2:
        return parts[-2] == "chaos"
    return parts[0] in ("should_fire", "overlay")


class UnknownChaosSite(Rule):
    id = "GRD001"
    repro_id = "GRD001"
    name = "unknown-chaos-site"
    rationale = ("A fault site name not in `chaos.FAULT_SITES` never "
                 "fires: the chaos test that references it exercises "
                 "nothing, silently.")
    node_types = (ast.Call,)

    def check_node(self, node, ctx):
        sites = ctx.project.fault_sites
        if not sites:
            return
        name = dotted(node.func)
        sfx = suffix(name)
        if sfx not in _SITE_FNS or not _chaos_base(name) or not node.args:
            return
        first = node.args[0]
        if sfx in ("should_fire", "enabled"):
            cands = ([first.value]
                     if isinstance(first, ast.Constant)
                     and isinstance(first.value, str) else [])
        else:                            # overlay/configure take iterables
            cands = [n.value for n in ast.walk(first)
                     if isinstance(n, ast.Constant)
                     and isinstance(n.value, str)]
        for site in cands:
            if site not in sites:
                yield ctx.diag(self, node,
                               f"chaos site {site!r} is not in "
                               f"chaos.FAULT_SITES {sorted(sites)} — it "
                               "can never fire")


class GuardCodeDiscipline(Rule):
    id = "GRD002"
    repro_id = "GRD002"
    name = "guard-code-discipline"
    rationale = ("GuardError/GuardIssue codes are the stable machine-"
                 "readable API: each literal code must be kebab-case, "
                 "cataloged in `guard/errors.py` KNOWN_CODES, and the "
                 "catalog itself must be duplicate-free.")
    node_types = (ast.Call,)

    def check_node(self, node, ctx):
        if suffix(dotted(node.func)) not in ("GuardError", "GuardIssue"):
            return
        if not node.args:
            return
        first = node.args[0]
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            return
        code = first.value
        if not _KEBAB.match(code):
            yield ctx.diag(self, node,
                           f"guard code {code!r} is not a kebab-case slug")
        codes = ctx.project.guard_codes
        if codes and code not in codes:
            yield ctx.diag(self, node,
                           f"guard code {code!r} is not cataloged in "
                           "guard/errors.py KNOWN_CODES")

    def finalize(self, project):
        seen: set = set()
        for code in project.guard_code_list:
            if code in seen and project.guard_codes_path:
                yield Diagnostic(rule=self.id,
                                 path=project.guard_codes_path,
                                 line=1, col=1,
                                 message=f"KNOWN_CODES lists {code!r} more "
                                         "than once — codes must be "
                                         "unique")
            seen.add(code)
