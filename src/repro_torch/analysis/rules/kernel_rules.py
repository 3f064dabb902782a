"""PAL rules: the hand-written kernels' contracts (the port's counterparts
of `repro`'s PAL001 and PAL002).

`repro`'s Pallas kernels declare their grids and block specs in Python,
where a rank mismatch indexes the wrong blocks.  The port's kernels are
CUDA C++ loaded with `ctypes` (`kernels/_build.py`, no torch headers):
each binding's prototype in ``kernels/<name>/cuda.py`` is a list of C
types that no compiler checks against the ``extern "C"`` function of that
name in ``csrc/*.cu``, and a wrong count shifts every argument after it.
And every kernel ships as a triple — ``cuda.py`` + ``csrc/*.cu``, the plain
version ``ref.py`` and the dispatch ``ops.py`` — whose dispatch imports
both and never answers a failed kernel call with the plain result (no
fallback hides the card).
"""

from __future__ import annotations

import ast
import glob
import os
import re

from repro_torch.analysis.engine import Diagnostic, Rule, dotted

_EXTERN = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(([^)]*)\)\s*\{',
                     re.S)


def c_arities(source: str) -> dict:
    """``{name: parameter count}`` of every ``extern "C"`` function
    defined in a CUDA source (comments stripped)."""
    source = re.sub(r"//[^\n]*|/\*.*?\*/", "", source, flags=re.S)
    out = {}
    for m in _EXTERN.finditer(source):
        params = m.group(2).strip()
        out[m.group(1)] = 0 if params in ("", "void") else \
            params.count(",") + 1
    return out


def _arity(expr) -> int | None:
    """The static length of a prototype list (``[ptr] * 4 + [i32, ptr]``),
    None if it is not one."""
    if isinstance(expr, (ast.List, ast.Tuple)):
        if any(isinstance(e, ast.Starred) for e in expr.elts):
            return None
        return len(expr.elts)
    if isinstance(expr, ast.BinOp):
        if isinstance(expr.op, ast.Add):
            a, b = _arity(expr.left), _arity(expr.right)
            return None if a is None or b is None else a + b
        if isinstance(expr.op, ast.Mult):
            for lst, k in ((expr.left, expr.right), (expr.right, expr.left)):
                n = _arity(lst)
                if n is not None and isinstance(k, ast.Constant) \
                        and isinstance(k.value, int):
                    return n * k.value
    return None


def _module_dicts(tree) -> dict:
    """Top-level ``NAME = {…: "str", …}`` assignments: name → the dict's
    string values (the kernels' names by dtype)."""
    out = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, ast.Dict):
            vals = [v.value for v in stmt.value.values
                    if isinstance(v, ast.Constant)
                    and isinstance(v.value, str)]
            if vals and len(vals) == len(stmt.value.values):
                out[stmt.targets[0].id] = vals
    return out


def prototypes(tree) -> list:
    """``(name, arity, node)`` of every ctypes prototype in a binding
    module: a dict literal ``{"fn": [types…]}`` or a comprehension
    ``{name: [types…] for name in TABLE.values()}`` over a module-level
    table of names."""
    tables = _module_dicts(tree)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                n = _arity(v)
                if n is not None and isinstance(k, ast.Constant) \
                        and isinstance(k.value, str):
                    out.append((k.value, n, k))
        elif isinstance(node, ast.DictComp) and len(node.generators) == 1:
            n = _arity(node.value)
            it = node.generators[0].iter
            name = dotted(it.func) if isinstance(it, ast.Call) else None
            if n is not None and name and name.endswith(".values") \
                    and name[:-len(".values")] in tables:
                out.extend((fn, n, node)
                           for fn in tables[name[:-len(".values")]])
    return out


def _kernel_dir(path: str) -> str | None:
    """``kernels/<name>`` for a module directly inside one, else None."""
    kdir = os.path.dirname(path)
    if os.path.basename(os.path.dirname(kdir)) != "kernels":
        return None
    return kdir


class BindingArity(Rule):
    id = "PAL101"
    repro_id = "PAL001"
    name = "ctypes-prototype-arity-mismatch"
    rationale = ("Each ctypes prototype in `kernels/<name>/cuda.py` must "
                 "list as many argument types as the `extern \"C\"` "
                 "function of that name in `csrc/*.cu` takes: no compiler "
                 "checks the pair, and a wrong count shifts every argument "
                 "after it.")
    node_types = ()

    def observe_module(self, ctx):
        if os.path.basename(ctx.path) != "cuda.py" \
                or _kernel_dir(ctx.path) is None:
            return
        arities: dict = {}
        for cu in sorted(glob.glob(os.path.join(_kernel_dir(ctx.path),
                                                "csrc", "*.cu"))):
            with open(cu, encoding="utf-8") as f:
                arities.update(c_arities(f.read()))
        for name, n, node in prototypes(ctx.tree):
            if name not in arities:
                yield ctx.diag(self, node,
                               f"ctypes prototype {name!r}: no extern \"C\" "
                               "function of that name in csrc/*.cu")
            elif arities[name] != n:
                yield ctx.diag(self, node,
                               f"ctypes prototype {name!r} lists {n} "
                               f"argument type(s); the extern \"C\" "
                               f"function takes {arities[name]}")


def _imports_of(tree) -> tuple:
    """(module and name components imported, names imported from a
    ``ref`` module)."""
    mods: set = set()
    from_ref: set = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.module:
            mods.add(n.module.rsplit(".", 1)[-1])
            mods.update(a.name for a in n.names)
            if n.module.rsplit(".", 1)[-1] == "ref":
                from_ref.update(a.asname or a.name for a in n.names)
        elif isinstance(n, ast.Import):
            for a in n.names:
                mods.add(a.name.rsplit(".", 1)[-1])
    return mods, from_ref


def _plain_call(node, from_ref) -> bool:
    """A call of the plain version: a name imported from ``ref``, or
    ``ref.<fn>(...)``."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func) or ""
    return name in from_ref or name.startswith("ref.")


class KernelTriple(Rule):
    id = "PAL102"
    repro_id = "PAL002"
    name = "kernel-triple-contract"
    rationale = ("Every `kernels/<name>/` package ships `cuda.py` + "
                 "`csrc/*.cu` (the kernel), `ref.py` (the plain version) "
                 "and `ops.py` (the dispatch); `ops.py` imports both, and "
                 "no exception handler in it answers a failed kernel call "
                 "with the plain result: on a CUDA tensor a build or launch "
                 "failure raises.")
    node_types = ()

    def __init__(self):
        self._triples: dict = {}      # dir -> {basename: (path, tree)}

    def observe_module(self, ctx):
        base = os.path.basename(ctx.path)
        kdir = _kernel_dir(ctx.path)
        if kdir is None or base not in ("cuda.py", "ref.py", "ops.py"):
            return ()
        self._triples.setdefault(kdir, {})[base] = (ctx.path, ctx.tree)
        if base != "ops.py":
            return ()
        _, from_ref = _imports_of(ctx.tree)
        return [ctx.diag(self, h, "ops.py answers a failed call with the "
                         "plain version — on a CUDA tensor the dispatch "
                         "must raise, not fall back")
                for h in ast.walk(ctx.tree)
                if isinstance(h, ast.ExceptHandler)
                and any(_plain_call(n, from_ref)
                        for stmt in h.body for n in ast.walk(stmt))]

    def finalize(self, project):
        for kdir in sorted(self._triples):
            seen = self._triples[kdir]
            anchor = next(iter(seen.values()))[0]
            pkg = os.path.basename(kdir)
            for want in ("cuda.py", "ref.py", "ops.py"):
                if want not in seen and not os.path.isfile(
                        os.path.join(kdir, want)):
                    yield _diag(self.id, anchor,
                                f"kernel package {pkg!r} is missing {want} "
                                "— every kernel ships as a cuda/ref/ops "
                                "triple")
            if not glob.glob(os.path.join(kdir, "csrc", "*.cu")):
                yield _diag(self.id, anchor,
                            f"kernel package {pkg!r} has no csrc/*.cu: the "
                            "binding has no kernel source")
            if "ops.py" in seen:
                path, tree = seen["ops.py"]
                mods, _ = _imports_of(tree)
                for dep in ("cuda", "ref"):
                    if dep not in mods:
                        yield _diag(self.id, path,
                                    f"ops.py dispatch does not import the "
                                    f"`{dep}` module")


def _diag(rule_id, path, message):
    return Diagnostic(rule=rule_id, path=path, line=1, col=1,
                      message=message)
