"""DET rules: ambient nondeterminism (the port's counterparts of `repro`'s
DET001 and DET002, and its DET003).

Every random draw in the port takes an explicit `torch.Generator` (or a
seeded NumPy one), so reruns are bit-identical and the card's runs replay
the CPU's.  The wall clock has no place in a fake (shape) rule or in a
kernel's plain version, which the kernel is held to; set-iteration order
is the third way ambient state leaks back in.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Rule, dotted

_CLOCK_ROOTS = ("time.", "datetime.")
_TORCH_RANDOM = frozenset({"rand", "randn", "randint", "randperm", "normal",
                           "bernoulli", "multinomial"})
_TORCH_SEEDS = frozenset({"torch.manual_seed", "torch.cuda.manual_seed",
                          "torch.cuda.manual_seed_all",
                          "torch.random.manual_seed", "torch.seed"})
_LEGACY_NP_RANDOM = frozenset({
    "rand", "randn", "randint", "random", "random_sample", "choice",
    "shuffle", "permutation", "normal", "uniform", "standard_normal",
    "seed", "binomial", "poisson", "exponential",
})
_STDLIB_RANDOM = frozenset({
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "uniform", "sample", "gauss", "normalvariate", "betavariate",
})


class WallClock(Rule):
    id = "DET101"
    repro_id = "DET001"
    name = "wall-clock-in-fake-rule-or-plain-version"
    rationale = ("`time.*` / `datetime.*` inside a `register_fake` rule or "
                 "a kernel's `ref.py` makes the shape rule or the plain "
                 "version the kernel is held to depend on when it runs — "
                 "timings belong in the caller (`repro_torch.obs.timed`).")
    node_types = (ast.Call,)

    def check_node(self, node, ctx):
        if not (ctx.fake or ctx.ref):
            return
        name = dotted(node.func) or ""
        if name.startswith(_CLOCK_ROOTS):
            where = "a register_fake rule" if ctx.fake else \
                "a kernel's plain version"
            yield ctx.diag(self, node,
                           f"`{name}()` inside {where} reads the wall clock")


class UnseededRandom(Rule):
    id = "DET102"
    repro_id = "DET002"
    name = "unseeded-global-rng"
    rationale = ("A torch draw without `generator=` (and `torch.manual_seed`"
                 ", which reseeds the process), the legacy global "
                 "`np.random.*`, a seedless `np.random.default_rng()` and "
                 "stdlib `random.*` draw from ambient process state; every "
                 "RNG in the port is an explicit Generator so reruns replay "
                 "bit for bit.")
    node_types = (ast.Call,)

    def check_node(self, node, ctx):
        name = dotted(node.func)
        if not name:
            return
        parts = name.split(".")
        if name in _TORCH_SEEDS:
            yield ctx.diag(self, node,
                           f"`{name}` seeds the process-global torch RNG; "
                           "draw from an explicit `torch.Generator`")
        elif (len(parts) == 2 and parts[0] == "torch"
                and parts[1] in _TORCH_RANDOM
                and not any(kw.arg == "generator" for kw in node.keywords)):
            yield ctx.diag(self, node,
                           f"`{name}` without `generator=` draws from the "
                           "process-global torch RNG; pass a seeded "
                           "`torch.Generator`")
        elif (len(parts) == 3 and parts[0] in ("np", "numpy")
                and parts[1] == "random"):
            if parts[2] == "default_rng":
                if not node.args and not node.keywords:
                    yield ctx.diag(self, node,
                                   "`np.random.default_rng()` without a "
                                   "seed draws entropy from the OS; pass "
                                   "an explicit seed")
            elif parts[2] in _LEGACY_NP_RANDOM:
                yield ctx.diag(self, node,
                               f"`{name}` uses the legacy *global* NumPy "
                               "RNG; use a seeded "
                               "`np.random.default_rng(seed)` Generator")
        elif (len(parts) == 2 and parts[0] == "random"
                and parts[1] in _STDLIB_RANDOM):
            yield ctx.diag(self, node,
                           f"`{name}` draws from the process-global stdlib "
                           "RNG; use a seeded `random.Random(seed)` or a "
                           "NumPy Generator")


class SetIterationOrder(Rule):
    id = "DET003"
    repro_id = "DET003"
    name = "set-iteration-order"
    rationale = ("Iterating a set directly yields hash order, which varies "
                 "across processes (PYTHONHASHSEED) — data fed to device "
                 "tensors or emitted into reports must come from "
                 "`sorted(...)` or an ordered container.")
    node_types = (ast.For, ast.comprehension)

    def _is_set_expr(self, expr) -> bool:
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return True
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
            return expr.func.id in ("set", "frozenset")
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitOr, ast.BitAnd, ast.Sub)):
            return self._is_set_expr(expr.left) or self._is_set_expr(
                expr.right)
        return False

    def check_node(self, node, ctx):
        it = node.iter
        if self._is_set_expr(it):
            # comprehension nodes carry no lineno; anchor on the iterable
            yield ctx.diag(self, it,
                           "iteration over a set is hash-ordered (varies "
                           "across processes); wrap in `sorted(...)` "
                           "before the order can feed device tensors")
