"""Visitor framework of the port's static analyzer.

Port of `repro.analysis.engine`: one AST walk per file, shared by every
rule, with a stack of :class:`Frame` objects so a rule inspecting a node
knows the *execution context* of the enclosing function, not just its
syntax.  `repro`'s contexts are JAX's (``jit``, ``shard_map``,
``pallas_call``); the port's are torch's:

* ``fake``  — the body is a shape rule that ``meta`` tensors run: the
  function is registered with ``register_fake`` (decorated with
  ``@op.register_fake`` / ``@torch.library.register_fake(...)``, or passed
  to such a call), or it is nested inside one.  A meta tensor has a shape
  and a type and no value, so a host sync or a branch on a value has
  nothing to read there.
* ``protocol`` — the function takes a ``group`` or ``rules`` parameter
  (or is nested in one that does): a collective-protocol helper, run on
  every rank of a group or a mesh (`repro`'s ``axis_name`` helpers).
* ``ref`` — the file is a kernel's plain version (``kernels/<name>/
  ref.py``): what the tests and the card checks hold the kernel to.
* ``loop_depth`` — lexical loop nesting inside the current function (a
  ``for``'s iterable counts at the depth outside it: it runs once).

Tracking is name-based and intra-module: ``fn = functools.partial(f, …)``
followed by ``op.register_fake(fn)`` marks ``f``; aliases resolve through
simple assignments in the enclosing scopes.

Suppressions, `repro`'s syntax: a ``# repro: ignore[RULE1,RULE2]`` (or a
bare ``# repro: ignore``) comment on the flagged line or the line directly
above silences the listed rules (all rules when bare) for that line.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re

# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: rule id, location, human message."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


# ---------------------------------------------------------------------------
# Project context: the vocabularies rules check names against
# ---------------------------------------------------------------------------


def _literal_strings(node) -> list:
    """Every string constant anywhere in ``node``'s subtree (source order)."""
    return [n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def _parse_assign_tuples(tree: ast.Module, names) -> dict:
    """``{name: [string literals]}`` for top-level assignments to ``names``."""
    out = {n: [] for n in names}
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        for tgt in stmt.targets:
            if isinstance(tgt, ast.Name) and tgt.id in out:
                out[tgt.id] = _literal_strings(stmt.value)
    return out


class Project:
    """Repo-level vocabularies, parsed statically from their source of
    truth so the analyzer never imports the code it checks (`repro`'s,
    and two of the port's own):

    * ``metric_names`` — ``register("…", …)`` literals in
      ``obs/registry.py`` (counter/gauge names).
    * ``span_names`` / ``span_prefixes`` — the ``SPAN_NAMES`` /
      ``SPAN_PREFIXES`` declarations in ``obs/registry.py``.
    * ``fault_sites`` — ``FAULT_SITES`` in ``guard/chaos.py``.
    * ``guard_codes`` — ``KNOWN_CODES`` in ``guard/errors.py`` (with
      literal duplicates preserved for the uniqueness check).
    * ``mesh_axes`` — the axis names of the production meshes
      (``ProductionMesh(shape, names)`` in ``launch/mesh.py``).
    * ``logical_axes`` — the logical names of the rule tables (the keys of
      each ``MeshRules(mesh, {…})`` in ``dist/sharding.py``).
    """

    def __init__(self, root: str | None = None, *,
                 metric_names=None, span_names=None, span_prefixes=None,
                 fault_sites=None, guard_codes=None, mesh_axes=None,
                 logical_axes=None):
        self.root = root
        self.metric_names = set(metric_names or ())
        self.span_names = set(span_names or ())
        self.span_prefixes = tuple(span_prefixes or ())
        self.fault_sites = set(fault_sites or ())
        self.guard_code_list = list(guard_codes or ())
        self.guard_codes = set(self.guard_code_list)
        self.guard_codes_path = None
        self.mesh_axes = set(mesh_axes or ())
        self.logical_axes = set(logical_axes or ())
        if root:
            self._discover(root)

    def _find(self, root: str, rel: str):
        """Locate ``rel`` (e.g. ``obs/registry.py``) under ``root``."""
        direct = os.path.join(root, rel)
        if os.path.isfile(direct):
            return direct
        for dirpath, dirs, _files in os.walk(root):
            dirs.sort()
            cand = os.path.join(dirpath, rel)
            if os.path.isfile(cand):
                return cand
        return None

    def _parse(self, root: str, rel: str):
        path = self._find(root, rel)
        if path is None:
            return None, None
        with open(path, encoding="utf-8") as f:
            return path, ast.parse(f.read())

    def _discover(self, root: str) -> None:
        _, tree = self._parse(root, os.path.join("obs", "registry.py"))
        if tree is not None:
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "register"
                        and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    self.metric_names.add(node.args[0].value)
            spans = _parse_assign_tuples(tree, ("SPAN_NAMES",
                                                "SPAN_PREFIXES"))
            self.span_names.update(spans["SPAN_NAMES"])
            self.span_prefixes = self.span_prefixes + tuple(
                spans["SPAN_PREFIXES"])
        _, tree = self._parse(root, os.path.join("guard", "chaos.py"))
        if tree is not None:
            sites = _parse_assign_tuples(tree, ("FAULT_SITES",))
            self.fault_sites.update(sites["FAULT_SITES"])
        path, tree = self._parse(root, os.path.join("guard", "errors.py"))
        if tree is not None:
            codes = _parse_assign_tuples(tree, ("KNOWN_CODES",))
            self.guard_code_list.extend(codes["KNOWN_CODES"])
            self.guard_codes = set(self.guard_code_list)
            self.guard_codes_path = path
        _, tree = self._parse(root, os.path.join("launch", "mesh.py"))
        if tree is not None:
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and suffix(dotted(node.func)) == "ProductionMesh"
                        and len(node.args) > 1):
                    self.mesh_axes.update(_literal_strings(node.args[1]))
        _, tree = self._parse(root, os.path.join("dist", "sharding.py"))
        if tree is not None:
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and suffix(dotted(node.func)) == "MeshRules"
                        and len(node.args) > 1
                        and isinstance(node.args[1], ast.Dict)):
                    self.logical_axes.update(
                        k.value for k in node.args[1].keys
                        if isinstance(k, ast.Constant))

    def span_declared(self, name: str) -> bool:
        if name in self.span_names:
            return True
        return any(name.startswith(p) for p in self.span_prefixes)


# ---------------------------------------------------------------------------
# Name helpers
# ---------------------------------------------------------------------------


def dotted(node) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def suffix(name: str | None) -> str | None:
    """Last dotted component (``torch.distributed.all_reduce`` →
    ``all_reduce``)."""
    return name.rsplit(".", 1)[-1] if name else None


def receiver(call: ast.Call) -> str | None:
    """The dotted object a method is called on (``rules`` in
    ``rules.psum(x, "data")``), None for a bare name or an expression."""
    if isinstance(call.func, ast.Attribute):
        return dotted(call.func.value)
    return None


FAKE_REGISTRARS = frozenset({"register_fake", "impl_abstract"})
PROTOCOL_PARAMS = frozenset({"group", "rules"})

_DEF_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


# ---------------------------------------------------------------------------
# Module index: lexical scopes + fake marks
# ---------------------------------------------------------------------------


class _Scope:
    __slots__ = ("node", "parent", "assigns", "defs")

    def __init__(self, node, parent):
        self.node = node
        self.parent = parent
        self.assigns: dict = {}     # name -> value expression at this level
        self.defs: dict = {}        # name -> def node at this level

    def lookup_assign(self, name):
        s = self
        while s is not None:
            if name in s.assigns:
                return s.assigns[name]
            s = s.parent
        return None

    def lookup_def(self, name):
        s = self
        while s is not None:
            if name in s.defs:
                return s.defs[name]
            s = s.parent
        return None


class ModuleIndex:
    """Pre-pass over one module: scope tree and the functions registered
    as fake (meta) rules."""

    def __init__(self, tree: ast.Module):
        self.scope_of: dict = {}        # id(def/module node) -> _Scope
        self.fake: set = set()          # id(def node) of fake rules
        self._calls: list = []          # (Call node, enclosing _Scope)
        self._build(tree, None)
        self._mark_decorators()
        self._mark_calls()

    def _build(self, node, parent: _Scope | None) -> _Scope:
        scope = _Scope(node, parent)
        self.scope_of[id(node)] = scope

        def rec(n):
            for child in ast.iter_child_nodes(n):
                if isinstance(child, _DEF_NODES):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                        scope.defs[child.name] = child
                    self._build(child, scope)
                    continue
                if isinstance(child, ast.Assign) and len(child.targets) == 1:
                    tgt = child.targets[0]
                    if isinstance(tgt, ast.Name):
                        scope.assigns[tgt.id] = child.value
                if isinstance(child, ast.Call):
                    self._calls.append((child, scope))
                rec(child)

        rec(node)
        return scope

    def _resolve_callable(self, expr, scope: _Scope, depth: int = 0):
        """Candidate function nodes an expression may evaluate to:
        follows Name aliases and ``functools.partial(f, …)``."""
        if depth > 6 or expr is None:
            return
        if isinstance(expr, _DEF_NODES):
            yield expr
        elif isinstance(expr, ast.Name):
            d = scope.lookup_def(expr.id)
            if d is not None:
                yield d
            val = scope.lookup_assign(expr.id)
            if val is not None and not isinstance(val, ast.Name):
                yield from self._resolve_callable(val, scope, depth + 1)
        elif isinstance(expr, ast.Call):
            if suffix(dotted(expr.func)) == "partial" and expr.args:
                yield from self._resolve_callable(expr.args[0], scope,
                                                  depth + 1)

    @staticmethod
    def _registrar(node) -> bool:
        """``op.register_fake`` / ``torch.library.register_fake`` (bare or
        called with the op's name)."""
        if isinstance(node, ast.Call):
            node = node.func
        return suffix(dotted(node)) in FAKE_REGISTRARS

    def _mark_decorators(self) -> None:
        for scope in list(self.scope_of.values()):
            node = scope.node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and any(self._registrar(d) for d in node.decorator_list):
                self.fake.add(id(node))

    def _mark_calls(self) -> None:
        for call, scope in self._calls:
            # op.register_fake(fn) / torch.library.register_fake("op", fn)
            # / torch.library.register_fake("op")(fn)
            if suffix(dotted(call.func)) in FAKE_REGISTRARS:
                cands = [a for a in call.args
                         if not isinstance(a, ast.Constant)]
            elif isinstance(call.func, ast.Call) \
                    and self._registrar(call.func):
                cands = list(call.args)
            else:
                continue
            for expr in cands:
                for node in self._resolve_callable(expr, scope):
                    self.fake.add(id(node))


# ---------------------------------------------------------------------------
# Walk context handed to rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Frame:
    node: object
    fake: bool = False
    protocol: bool = False       # takes (or inherits) a group/rules param
    loop_depth: int = 0


def _is_ref_file(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return (os.path.basename(path) == "ref.py" and len(parts) >= 3
            and parts[-3] == "kernels")


class FileContext:
    """Per-file state rules read during the walk."""

    def __init__(self, path: str, tree: ast.Module, source: str,
                 project: Project):
        self.path = path
        self.tree = tree
        self.source = source
        self.project = project
        self.index = ModuleIndex(tree)
        self.ref = _is_ref_file(path)
        self.frames: list = [Frame(node=tree)]

    @property
    def frame(self) -> Frame:
        return self.frames[-1]

    @property
    def fake(self) -> bool:
        return self.frame.fake

    @property
    def protocol(self) -> bool:
        return self.frame.protocol

    @property
    def loop_depth(self) -> int:
        return self.frame.loop_depth

    def lookup(self, name: str):
        """Innermost assignment expression bound to ``name`` (per-scope)."""
        for frame in reversed(self.frames):
            scope = self.index.scope_of.get(id(frame.node))
            if scope is not None:
                val = scope.lookup_assign(name)
                if val is not None:
                    return val
        return None

    def diag(self, rule: "Rule", node, message: str) -> Diagnostic:
        return Diagnostic(rule=rule.id, path=self.path,
                          line=getattr(node, "lineno", 1),
                          col=getattr(node, "col_offset", 0) + 1,
                          message=message)


class Rule:
    """Base class of the catalog (see ``rules/``).

    Subclasses set ``id``/``name``/``rationale`` (and ``repro_id``, the id
    of `repro`'s rule it stands for) and implement any of:

    * ``node_types`` + :meth:`check_node` — called for every matching AST
      node with the live :class:`FileContext`;
    * :meth:`observe_module` — called once per file after its walk, to
      accumulate cross-file state;
    * :meth:`finalize` — called once per run, after every file.
    """

    id: str = "RULE000"
    repro_id: str = ""
    name: str = ""
    rationale: str = ""
    node_types: tuple = ()

    def check_node(self, node, ctx: FileContext):
        return ()

    def observe_module(self, ctx: FileContext):
        return ()

    def finalize(self, project: Project):
        return ()


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*ignore(?:\[\s*([A-Za-z0-9_,\s]+?)\s*\])?")


def parse_suppressions(source: str) -> dict:
    """``{line_number: set of rule ids}`` (empty set == all rules);
    a suppression covers its own line and the line below it."""
    out: dict = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = (set(r.strip() for r in m.group(1).split(",") if r.strip())
                 if m.group(1) else set())
        for ln in (i, i + 1):
            if ln in out and out[ln] and rules:
                out[ln] |= rules
            elif rules and ln not in out:
                out[ln] = set(rules)
            else:
                out[ln] = set()      # bare ignore wins: all rules
    return out


def _suppressed(diag: Diagnostic, supp: dict) -> bool:
    if diag.line not in supp:
        return False
    rules = supp[diag.line]
    return not rules or diag.rule in rules


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------


def _collect_params(node) -> set:
    args = node.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return set(names)


def _walk_file(ctx: FileContext, rules_by_type: dict) -> list:
    diags: list = []

    def dispatch(node):
        for rule in rules_by_type.get(type(node), ()):
            diags.extend(rule.check_node(node, ctx))

    def visit(node):
        if isinstance(node, _DEF_NODES):
            parent = ctx.frame
            frame = Frame(
                node=node,
                fake=parent.fake or id(node) in ctx.index.fake,
                protocol=parent.protocol
                or bool(PROTOCOL_PARAMS & _collect_params(node)),
            )
            ctx.frames.append(frame)
            dispatch(node)
            for child in ast.iter_child_nodes(node):
                visit(child)
            ctx.frames.pop()
            return
        dispatch(node)
        if isinstance(node, (ast.For, ast.AsyncFor)):
            # the target and the iterable are evaluated once, the body a
            # time per item
            visit(node.target)
            visit(node.iter)
            ctx.frame.loop_depth += 1
            for child in node.body:
                visit(child)
            ctx.frame.loop_depth -= 1
            for child in node.orelse:
                visit(child)
            return
        loop = isinstance(node, ast.While)
        if loop:
            ctx.frame.loop_depth += 1
        for child in ast.iter_child_nodes(node):
            visit(child)
        if loop:
            ctx.frame.loop_depth -= 1

    visit(ctx.tree)
    return diags


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _expand(paths) -> list:
    files: list = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files.extend(os.path.join(dirpath, n)
                             for n in sorted(names) if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    return files


def _by_type(rules) -> dict:
    out: dict = {}
    for rule in rules:
        for t in rule.node_types:
            out.setdefault(t, []).append(rule)
    return out


def analyze_source(source: str, *, path: str = "<memory>",
                   project: Project | None = None,
                   rules=None) -> list:
    """Analyze one source string (fixtures, tests)."""
    from repro_torch.analysis.rules import all_rules

    rules = list(rules) if rules is not None else all_rules()
    project = project or Project()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Diagnostic(rule="PARSE", path=path, line=e.lineno or 1,
                           col=(e.offset or 0) + 1,
                           message=f"syntax error: {e.msg}")]
    ctx = FileContext(path, tree, source, project)
    diags = _walk_file(ctx, _by_type(rules))
    for rule in rules:
        diags.extend(rule.observe_module(ctx))
    supp = parse_suppressions(source)
    return [d for d in diags if not _suppressed(d, supp)]


def analyze_paths(paths, *, root: str | None = None,
                  project: Project | None = None, rules=None) -> list:
    """Run the catalog over files/directories; returns sorted findings."""
    from repro_torch.analysis.rules import all_rules

    rules = list(rules) if rules is not None else all_rules()
    files = _expand(paths)
    if project is None:
        base = root
        if base is None and files:
            base = os.path.commonpath([os.path.abspath(f) for f in files])
            if os.path.isfile(base):
                base = os.path.dirname(base)
        project = Project(base)
    rules_by_type = _by_type(rules)
    diags: list = []
    supp_by_path: dict = {}
    for f in files:
        try:
            with open(f, encoding="utf-8") as fh:
                source = fh.read()
        except OSError as e:
            diags.append(Diagnostic(rule="PARSE", path=f, line=1, col=1,
                                    message=f"unreadable: {e}"))
            continue
        supp_by_path[f] = parse_suppressions(source)
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            diags.append(Diagnostic(
                rule="PARSE", path=f, line=e.lineno or 1,
                col=(e.offset or 0) + 1, message=f"syntax error: {e.msg}"))
            continue
        ctx = FileContext(f, tree, source, project)
        diags.extend(_walk_file(ctx, rules_by_type))
        for rule in rules:
            diags.extend(rule.observe_module(ctx))
    for rule in rules:
        diags.extend(rule.finalize(project))
    diags = [d for d in diags
             if not _suppressed(d, supp_by_path.get(d.path, {}))]
    return sorted(diags, key=lambda d: (d.path, d.line, d.col, d.rule))


def findings_json(diags, *, rules=None) -> str:
    """The machine-readable report (`repro`'s schema)."""
    from repro_torch.analysis.rules import all_rules

    rules = list(rules) if rules is not None else all_rules()
    counts: dict = {}
    for d in diags:
        counts[d.rule] = counts.get(d.rule, 0) + 1
    return json.dumps({
        "schema": "repro.analysis/v1",
        "findings": [d.to_dict() for d in diags],
        "counts": counts,
        "rules": [{"id": r.id, "name": r.name} for r in rules],
    }, indent=2)
