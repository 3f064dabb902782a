"""repro_torch.guard and the guarded pipeline vs repro.guard.

Everything the guard does is host NumPy in both packages, so the port is
held to `repro` bit for bit: validation codes and repairs, budgets and
packing, the failure taxonomy, the escalation ladder's reports, the chaos
draws, the output closer and, end to end, the labels and `GuardReport` of
a guarded run under each chaos site (the solves on these meshes take the
same decisions in fp32 on both sides, so labels are compared exactly).

Also pinned here:

* the fault the guard repairs: on a graph of two components, the port's
  default `partition` (guarded, as `repro`'s is) gives `repro`'s labels;
* a healthy guarded run gives the labels of ``guard=False``;
* a failure of a kernel (`KernelError`) or of the card inside the guard's
  catches propagates instead of taking a fallback rung.
"""

import dataclasses
import subprocess

import numpy as np
import pytest
import torch

import repro.configs.parrsb as cfg_j
import repro.core.pipeline as pipe_j
import repro.dist.partition_aware as pa_j
import repro.guard as guard_j
import repro.mesh as mesh_j
import repro_torch.configs.parrsb as cfg_t
import repro_torch.core.pipeline as pipe_t
import repro_torch.core.rsb as rsb_t
import repro_torch.dist.partition_aware as pa_t
import repro_torch.dist.refine_sharded as rs_t
import repro_torch.guard as guard_t
import repro_torch.mesh as mesh_t
from repro.core.fiedler import FiedlerResult as FiedlerResult_j
from repro.mesh.graphs import build_csr as build_csr_j
from repro_torch.core.fiedler import FiedlerResult as FiedlerResult_t
from repro_torch.core.refine import edge_cut
from repro_torch.kernels import _build
from repro_torch.kernels._build import KernelError
from repro_torch.mesh.graphs import build_csr as build_csr_t

SEEDS = [0, 1, 2, 3, 4]
PACKAGES = {"j": (guard_j, mesh_j, build_csr_j, FiedlerResult_j),
            "t": (guard_t, mesh_t, build_csr_t, FiedlerResult_t)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(fn):
    """``fn(guard, mesh, build_csr, FiedlerResult)`` in each package."""
    return fn(*PACKAGES["j"]), fn(*PACKAGES["t"])


def _outcome(fn):
    """(kind, payload): the value, or the GuardError's code."""
    try:
        return "ok", fn()
    except Exception as exc:          # noqa: BLE001 — compared across packages
        return type(exc).__name__, getattr(exc, "code", str(exc))


def _graph_with(m, build_csr, n=36, *, rng, self_loops=0, dup_edges=0,
                bad_w=0, neg_w=0):
    """tests/test_guard.py's defective 6x6 grid (raw COO, not coalesced)."""
    g = m.grid_graph_2d(6, 6)
    src, dst, w = [g.rows], [g.indices], [np.asarray(g.weights, float)]
    if self_loops:
        nodes = rng.choice(n, self_loops, replace=False)
        src.append(nodes)
        dst.append(nodes)
        w.append(np.ones(self_loops))
    if dup_edges:
        pick = rng.choice(g.rows.size, dup_edges, replace=False)
        src.append(g.rows[pick])
        dst.append(g.indices[pick])
        w.append(np.ones(dup_edges))
    src, dst = np.concatenate(src), np.concatenate(dst)
    w = np.concatenate(w)
    if bad_w:
        w[rng.choice(w.size, bad_w, replace=False)] = np.nan
    if neg_w:
        w[rng.choice(w.size, neg_w, replace=False)] = -1.0
    order = np.argsort(src, kind="stable")
    indptr = np.searchsorted(src[order], np.arange(n + 1))
    return dataclasses.replace(g, indptr=indptr, indices=dst[order],
                               weights=w[order])


def _graph_eq(a, b):
    return (a.n == b.n and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.weights, b.weights))


def _two_grids(m, build_csr, a=(12, 11), b=(7, 9)):
    """One graph of two `grid_graph_2d` components, no coords."""
    ga, gb = m.grid_graph_2d(*a), m.grid_graph_2d(*b)
    src = np.concatenate([ga.rows, gb.rows + ga.n])
    dst = np.concatenate([ga.indices, gb.indices + ga.n])
    w = np.concatenate([ga.weights, gb.weights])
    return build_csr(src, dst, ga.n + gb.n, weights=w, symmetrize=False)


# ---------------------------------------------------------------------------
# Front door checks and validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,n", [("4", 10), (0, 10), (11, 10), ("x", 10),
                                     (None, 10), (2.5, 10), (1, 0)])
def test_validate_nparts_matches(value, n):
    j, t = _both(lambda gd, *_: _outcome(lambda: gd.validate_nparts(value, n)))
    assert j == t


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("defect", [dict(self_loops=3), dict(dup_edges=4),
                                    dict(bad_w=2), dict(neg_w=2)])
def test_validate_graph_strict_and_sanitize(seed, defect):
    def run(gd, m, build_csr, _):
        g = _graph_with(m, build_csr, rng=np.random.default_rng(seed),
                        **defect)
        strict = _outcome(lambda: gd.validate_graph(g))
        report = gd.GuardReport()
        g2, _, _ = gd.validate_graph(g, sanitize=True, report=report)
        return strict, report.to_dict(), g2

    (sj, rj, gj), (st, rt, gt) = _both(run)
    assert sj == st and sj[0] == "GuardError"
    assert rj == rt and rt["sanitize_fixes"] > 0
    assert _graph_eq(gj, gt)


@pytest.mark.parametrize("seed", SEEDS)
def test_validate_graph_node_data(seed):
    def run(gd, m, *_):
        rng = np.random.default_rng(seed)
        g = m.grid_graph_2d(6, 6)
        w = np.ones(36)
        w[rng.choice(36, 3, replace=False)] = np.nan
        c = rng.random((36, 2))
        c[rng.choice(36, 2, replace=False)] = np.inf
        codes = (_outcome(lambda: gd.validate_graph(g, weights=w)),
                 _outcome(lambda: gd.validate_graph(g, coords=c)))
        report = gd.GuardReport()
        _, c2, w2 = gd.validate_graph(g, coords=c, weights=w, sanitize=True,
                                      report=report)
        return codes, report.to_dict(), c2, w2

    (kj, rj, cj, wj), (kt, rt, ct, wt) = _both(run)
    assert kj == kt and rj == rt
    assert np.array_equal(cj, ct) and np.array_equal(wj, wt)
    assert np.all(np.isfinite(ct)) and np.all(wt > 0)


def test_validate_graph_malformed_and_zero_degree():
    def run(gd, m, build_csr, _):
        g = m.grid_graph_2d(4, 4)
        bad = dataclasses.replace(g, indptr=g.indptr[:-1].copy())
        codes = [_outcome(lambda s=s: gd.validate_graph(bad, sanitize=s))
                 for s in (False, True)]
        g18 = build_csr(g.rows, g.indices, 18, weights=g.weights,
                        symmetrize=False)
        report = gd.GuardReport()
        gd.validate_graph(g18, report=report)
        labels, ncomp = gd.component_labels(g18)
        return codes, report.to_dict(), labels, ncomp

    (cj, rj, lj, nj), (ct, rt, lt, nt) = _both(run)
    assert cj == ct and ct[0] == ("GuardError", "malformed-csr")
    assert rj == rt and any(i["code"] == "zero-degree-node"
                            for i in rt["issues"])
    assert np.array_equal(lj, lt) and nj == nt == 3


def test_validate_mesh_strict_and_sanitize():
    def run(gd, m, *_):
        box = m.box_mesh(4, 4, 3)
        coords = np.asarray(box.coords).copy()
        coords[5] = np.nan
        weights = np.asarray(box.weights, float).copy()
        weights[7] = -3.0
        bad = dataclasses.replace(box, coords=coords, weights=weights)
        strict = _outcome(lambda: gd.validate_mesh(bad))
        empty = _outcome(lambda: gd.validate_mesh(bad, nparts=99))
        report = gd.GuardReport()
        fixed = gd.validate_mesh(bad, sanitize=True, report=report)
        return strict, empty, report.to_dict(), fixed.coords, fixed.weights

    j, t = _both(run)
    assert j[:3] == t[:3] and t[2]["sanitize_fixes"] == 2
    assert np.array_equal(j[3], t[3]) and np.array_equal(j[4], t[4])


# ---------------------------------------------------------------------------
# Component budgets and packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_budgets_and_packing(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 8))
    nparts = int(rng.integers(k, 40))
    w = rng.random(k) * rng.integers(1, 100)
    kp = int(rng.integers(2, 6))
    wp = rng.random(int(rng.integers(kp + 1, 40)))
    j, t = _both(lambda gd, *_: (gd.proportional_budgets(w, nparts),
                                 gd.pack_components(wp, kp),
                                 _outcome(lambda: gd.proportional_budgets(
                                     [1.0, 1.0, 1.0], 2))))
    assert np.array_equal(j[0], t[0]) and t[0].sum() == nparts
    assert np.array_equal(j[1], t[1])
    assert j[2] == t[2] == ("GuardError", "bad-nparts")


# ---------------------------------------------------------------------------
# Failure taxonomy, fallback vector, the escalation ladder
# ---------------------------------------------------------------------------

def _res(FR, vec, lam=0.1, residual=1e-6, breakdown=False):
    return FR(vector=np.asarray(vec, float), eigenvalue=lam,
              residual=residual, iterations=3, method="lanczos",
              breakdown=breakdown)


def test_failure_reason_and_fallback_vector():
    good = np.linspace(-1, 1, 8)
    nan_v = good.copy()
    nan_v[3] = np.nan

    def run(gd, m, b, FR):
        reasons = [gd.failure_reason(None, 8)] + [
            gd.failure_reason(_res(FR, v, **kw), size)
            for v, kw, size in [(good, dict(breakdown=True), 8),
                                (nan_v, {}, 8), (good, dict(lam=np.nan), 8),
                                (np.zeros(8), {}, 8),
                                (good, dict(lam=1e-9, residual=1.0), 8),
                                (good, {}, 8), (np.zeros(1), {}, 1)]]
        coords = np.stack([np.linspace(0, 1, 10), np.linspace(0, 5, 10)], 1)
        vecs = [gd.fallback_vector(10, coords), gd.fallback_vector(4),
                gd.fallback_vector(4, np.zeros((4, 3)))]
        return reasons, vecs

    (rj, vj), (rt, vt) = _both(run)
    assert rj == rt == ["exception", "breakdown", "nonfinite-vector",
                        "nonfinite-eigenpair", "degenerate-vector",
                        "stalled-residual", None, None]
    assert all(np.array_equal(a, b) for a, b in zip(vj, vt))


LADDERS = {   # policy, {call index: healthy result}
    "retry": (dict(max_retries=2), {0}),
    "switch": (dict(max_retries=1), {1}),
    "exhaust": (dict(max_retries=2), set()),
    "no-switch": (dict(max_retries=1, switch_method=False), set()),
}


@pytest.mark.parametrize("case", sorted(LADDERS))
@pytest.mark.parametrize("method", ["lanczos", "inverse"])
def test_ladder_matches(case, method):
    policy_kw, healthy = LADDERS[case]

    def run(gd, m, b, FR):
        calls = []

        def solve_fn(meth, seed):
            calls.append((meth, seed))
            if len(calls) - 1 in healthy:
                return _res(FR, np.linspace(-1, 1, 16))
            raise RuntimeError("scripted failure")

        sg = gd.SolverGuard(gd.GuardPolicy(**policy_kw), seed=3,
                            method=method)
        res, why = sg.admit(_res(FR, np.zeros(16)), level=2, p_lo=5, size=16)
        out = sg.rescue(solve_fn, why, level=2, p_lo=5, size=16)
        return why, calls, out.method, out.vector, sg.report.to_dict()

    j, t = _both(run)
    assert j[0] == t[0] == "degenerate-vector"
    assert j[1] == t[1] and j[2] == t[2] and j[4] == t[4]
    assert np.array_equal(j[3], t[3])


def test_deadline_skips_straight_to_fallback():
    def run(gd, m, b, FR):
        sg = gd.SolverGuard(gd.GuardPolicy(max_retries=5, deadline=-1.0),
                            seed=0, method="lanczos")
        out = sg.rescue(lambda meth, s: pytest.fail("must not re-solve"),
                        "breakdown", level=0, p_lo=0, size=8)
        return sg.expired(), out.method, sg.report.to_dict()

    j, t = _both(run)
    assert j == t and t[0] and t[1] == "fallback-index"


_ACCEL = getattr(torch, "AcceleratorError", None)
_DEVICE_FAULTS = [KernelError("launch failed"),
                  torch.OutOfMemoryError("CUDA out of memory")] + (
    [_ACCEL("CUDA error: an illegal memory access")] if _ACCEL else [])


@pytest.mark.parametrize("fault", _DEVICE_FAULTS)
def test_rescue_propagates_device_faults(fault):
    """A re-solve that fails in a kernel or on the card (by the error's
    type) raises, on any device; a solver's own error off the card is a
    failed attempt, as in `repro`, whatever its message says."""
    def solve_fn(meth, seed):
        raise fault

    sg = guard_t.SolverGuard(guard_t.GuardPolicy(), seed=0, method="lanczos",
                             device=torch.device("cpu"))
    with pytest.raises(type(fault)):
        sg.rescue(solve_fn, "breakdown", level=0, p_lo=0, size=8)
    assert guard_t.device_fault(fault)
    assert not guard_t.absorbable(fault, torch.device("cpu"))

    for err in (ValueError("unknown fiedler method"),
                RuntimeError("CUDA error: words in a message")):
        def solver_error(meth, seed, _e=err):
            raise _e

        out = sg.rescue(solver_error, "breakdown", level=0, p_lo=0, size=8)
        assert out.method == "fallback-index"
        assert not guard_t.device_fault(err)
        assert guard_t.absorbable(err, None)


@pytest.mark.parametrize("err", [ValueError("bad input"),
                                 TypeError("not contiguous"),
                                 RuntimeError("Expected all tensors to be on "
                                              "the same device, cuda:0 and "
                                              "cpu")])
def test_rescue_on_the_card_absorbs_no_exception(err):
    """On the card an exception from a re-solve is a fault of the port,
    whatever its type: it raises instead of taking a fallback rung.  A
    result that `admit` rejects still climbs the ladder there."""
    card = torch.device("cuda")
    sg = guard_t.SolverGuard(guard_t.GuardPolicy(), seed=0, method="lanczos",
                             device=card)

    def solve_fn(meth, seed):
        raise err

    with pytest.raises(type(err)):
        sg.rescue(solve_fn, "breakdown", level=0, p_lo=0, size=8)
    assert not guard_t.absorbable(err, card)
    assert guard_t.absorbable(err, torch.device("cpu"))

    def degenerate(meth, seed):
        return FiedlerResult_t(vector=np.zeros(8), eigenvalue=1.0,
                               residual=0.0, iterations=1,
                               method=meth)

    out = sg.rescue(degenerate, "breakdown", level=0, p_lo=0, size=8)
    assert out.method == "fallback-index"
    assert sg.report.retries == 1 and sg.report.fallbacks == 2


def test_kernel_error_inside_engine_rescue_propagates(monkeypatch):
    """A `KernelError` from a rescue re-solve inside the RSB engine is not
    absorbed by the ladder."""
    g = mesh_t.grid_graph_2d(16, 16)

    def broken(*a, **k):
        raise KernelError("ell_spmv_cuda: launch failed with CUDA error 700")

    monkeypatch.setattr(rsb_t, "fiedler_from_graph", broken)
    with pytest.raises(KernelError, match="launch failed"):
        pipe_t.PartitionPipeline(
            pre="none", guard=True, guard_kw={"chaos": ("solver_nan",)},
            device="cpu").run(g, 4)


def test_kernel_error_inside_sharded_pass_propagates(monkeypatch):
    mesh = mesh_t.box_mesh(6, 6, 4)

    def broken(*a, **k):
        raise KernelError("connection_table_batched: launch failed")

    monkeypatch.setattr(rs_t, "connection_table_batched", broken)
    with pytest.raises(KernelError, match="launch failed"):
        pipe_t.partition(mesh, 4, refine="repair+refine-sharded",
                         device="cpu")


# ---------------------------------------------------------------------------
# Chaos: the same draws, the same state machine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rate", [(0, 1.0), (3, 0.5), (7, 0.25),
                                       (11, 0.0)])
def test_should_fire_table(seed, rate):
    keys = [(lv, p) for lv in range(4) for p in range(0, 40, 3)]

    def run(gd, *_):
        with gd.chaos.overlay(("solver_nan", "cg_divergence"), seed=seed,
                              rate=rate):
            fired = [gd.chaos.should_fire(site, *k)
                     for site in gd.chaos.FAULT_SITES for k in keys]
        return fired, gd.chaos.active()

    j, t = _both(run)
    assert j == t and not t[1]
    if 0.0 < rate < 1.0:
        assert 0 < sum(t[0]) < 2 * len(keys)


def test_chaos_suppressed_configure_and_env(monkeypatch):
    chaos = guard_t.chaos
    assert chaos.FAULT_SITES == guard_j.chaos.FAULT_SITES
    with chaos.overlay(("deadline",)):
        assert chaos.enabled("deadline")
        with chaos.suppressed():
            assert not chaos.enabled("deadline")
            assert not chaos.should_fire("deadline")
        assert chaos.enabled("deadline")
    assert not chaos.active()
    with pytest.raises(ValueError):
        chaos.configure(("not-a-site",))
    saved = dict(chaos._state)
    monkeypatch.setenv("REPRO_CHAOS", "solver_nan, halo_truncate")
    monkeypatch.setenv("REPRO_CHAOS_SEED", "5")
    monkeypatch.setenv("REPRO_CHAOS_RATE", "0.5")
    try:
        chaos._load_env()
        assert chaos._state["sites"] == {"solver_nan", "halo_truncate"}
        assert chaos._state["seed"] == 5 and chaos._state["rate"] == 0.5
        monkeypatch.setenv("REPRO_CHAOS", "nope")
        with pytest.raises(ValueError, match="unknown fault sites"):
            chaos._load_env()
    finally:
        chaos._state.update(saved)
    assert not chaos.active()


# ---------------------------------------------------------------------------
# Output invariant: check + closer
# ---------------------------------------------------------------------------

def test_check_output_taxonomy():
    def run(gd, m, *_):
        g = m.grid_graph_2d(16, 16)
        good = (np.arange(g.n) // (g.n // 4)).clip(0, 3)
        frag = good.copy()
        frag[0] = 3
        return [gd.check_output(g, x, 4) for x in
                (good, None, good[:-1], good.astype(float), good + 7, frag)]

    j, t = _both(run)
    assert j == t and t[0] == [] and any("disconnected" in p for p in t[5])


@pytest.mark.parametrize("seed", SEEDS)
def test_enforce_output_from_garbage(seed):
    def run(gd, m, *_):
        g = m.grid_graph_2d(16, 16)
        rng = np.random.default_rng(seed)
        garbage = rng.integers(-5, 9, g.n)
        w = 1.0 + rng.integers(0, 2, g.n)
        report = gd.GuardReport()
        parts = gd.enforce_output(g, garbage, 4, weights=w, report=report)
        frag = (np.arange(g.n) // (g.n // 4)).clip(0, 3)
        frag[rng.choice(g.n, 6, replace=False)] = 0
        report2 = gd.GuardReport()
        repaired = gd.enforce_output(g, frag, 4, report=report2)
        return (parts, report.to_dict(), repaired, report2.to_dict(),
                gd.check_output(g, parts, 4, weights=w),
                gd.enforce_output(g, None, 4))

    j, t = _both(run)
    for a, b in zip(j, t):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
    assert t[4] == [] and t[1]["fallbacks"] >= 1


# ---------------------------------------------------------------------------
# The guarded pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nparts", [2, 4, 5])
def test_disconnected_graph_default_matches_repro(nparts):
    """The fault the guard repairs: `repro`'s default run is guarded and
    splits each component by its own budget; the port's default run does
    the same (an unguarded run cut 31 at 4 parts, and 35 at 5)."""
    gj, gt = _two_grids(mesh_j, build_csr_j), _two_grids(mesh_t, build_csr_t)
    want = pipe_j.partition(gj, nparts)
    got = pipe_t.partition(gt, nparts, device="cpu")
    assert np.array_equal(got, want)
    assert edge_cut(gt, got) == {2: 0.0, 4: 20.0, 5: 28.0}[nparts]
    ctx = pipe_t.PartitionPipeline(device="cpu").run(gt, nparts)
    assert ctx.report.guard.components == 2 and ctx.config["components"] == 2
    assert [s.kind for s in ctx.stages][0] == "guard"


def test_more_components_than_parts_packs():
    def run(pipe, b):
        src = np.arange(0, 24, 2)
        g = b(np.concatenate([src, src + 1]), np.concatenate([src + 1, src]),
              24, symmetrize=False)
        return pipe(g)

    cj = run(lambda g: pipe_j.PartitionPipeline(
        pre="none", post=("repair",), guard=True).run(g, 3), build_csr_j)
    ct = run(lambda g: pipe_t.PartitionPipeline(
        pre="none", post=("repair",), guard=True, device="cpu").run(g, 3),
        build_csr_t)
    assert np.array_equal(cj.parts, ct.parts)
    assert cj.report.guard.to_dict() == ct.report.guard.to_dict()
    assert ct.report.engine == "pack-components"


def _pebble(m):
    return m.pebble_mesh(10, 10, 10, n_pebbles=6, seed=0)


PARITY_RUNS = {   # name: pipeline keywords (8 parts)
    "default": dict(),
    "rsb_inverse_jacobi": dict(bisect_kw=dict(method="inverse")),
    "rsb_inverse_amg": dict(bisect_kw=dict(method="inverse",
                                           precond="amg")),
    "kway": dict(post=("repair", "kway")),
    "repair+refine-sharded": dict(post=("repair", "refine-sharded")),
}


@pytest.fixture(scope="module")
def pebble_t():
    return _pebble(mesh_t)


@pytest.mark.parametrize("name", sorted(PARITY_RUNS))
def test_guard_on_off_bit_identical(pebble_t, name):
    kw = PARITY_RUNS[name]
    on = pipe_t.PartitionPipeline(guard=True, device="cpu", **kw).run(
        pebble_t, 8)
    off = pipe_t.PartitionPipeline(guard=False, device="cpu", **kw).run(
        pebble_t, 8)
    assert np.array_equal(on.parts, off.parts)
    assert np.array_equal(on.parts_raw, off.parts_raw)
    assert on.report.guard is not None and on.report.guard.clean
    assert off.report.guard is None
    assert on.config["guard"] and not off.config["guard"]
    assert [s.name for s in on.stages if s.kind == "guard"] == \
        ["validate", "finalize"]
    assert not any("host-fallback" in s.info["stages"]
                   for s in on.stages if s.kind == "post")


def test_guard_env_switch(monkeypatch):
    g = mesh_t.grid_graph_2d(16, 16)
    monkeypatch.setenv("REPRO_GUARD", "off")
    ctx = pipe_t.PartitionPipeline(pre="none", device="cpu").run(g, 2)
    assert not ctx.config["guard"] and ctx.report.guard is None
    assert not any(s.kind == "guard" for s in ctx.stages)
    monkeypatch.setenv("REPRO_GUARD", "on")
    ctx = pipe_t.PartitionPipeline(pre="none", device="cpu").run(g, 2)
    assert ctx.config["guard"] and ctx.report.guard is not None
    monkeypatch.delenv("REPRO_GUARD")
    assert pipe_t._guard_enabled(None)


CHAOS_SITES = ["solver_nan", "empty_split", "cg_divergence", "deadline",
               "halo_truncate"]


def _chaos_kw(site):
    """`benchmarks/smoke_check.py::check_chaos`'s configuration: inverse
    iteration for ``cg_divergence``, the sharded chain for
    ``halo_truncate``."""
    return dict(pre="rcb", bisect="rsb-batched",
                post=(("repair", "refine-sharded") if site == "halo_truncate"
                      else ("repair", "refine")),
                bisect_kw={"method": "inverse"} if site == "cg_divergence"
                else {}, guard=True, guard_kw={"chaos": (site,)})


@pytest.fixture(scope="module")
def chaos_mesh():
    return (mesh_j.pebble_mesh(8, 8, 8, n_pebbles=3, seed=0),
            mesh_t.pebble_mesh(8, 8, 8, n_pebbles=3, seed=0))


@pytest.mark.parametrize("site", CHAOS_SITES)
def test_chaos_end_to_end_matches_repro(chaos_mesh, site):
    """Labels and GuardReport equal `repro`'s under each site.  The fp32
    re-solves of ``cg_divergence`` (its rung 2 is Lanczos) agree exactly
    on this mesh, so labels are compared exactly there too."""
    mj, mt = chaos_mesh
    cj = pipe_j.PartitionPipeline(**_chaos_kw(site)).run(mj, 8)
    ct = pipe_t.PartitionPipeline(device="cpu", **_chaos_kw(site)).run(mt, 8)
    assert np.array_equal(ct.parts, cj.parts)
    assert ct.report.guard.to_dict() == cj.report.guard.to_dict()
    gr = ct.report.guard
    assert sorted(np.unique(ct.parts)) == list(range(8))
    assert guard_t.count_disconnected(ct.require_graph(), ct.parts, 8) == 0
    w = np.asarray(mt.weights, np.float64)
    pw = np.bincount(ct.parts, weights=w, minlength=8)
    assert pw.max() <= 1.10 * w.sum() / 8
    post = {s.name: s.info["stages"] for s in ct.stages if s.kind == "post"}
    if site == "halo_truncate":        # the plan is rebuilt, not degraded
        assert gr.fallbacks == 0
        assert post["refine-sharded"] == ["refine-sharded"]
    else:
        assert gr.fallbacks > 0
    assert gr.deadline_expired == (site == "deadline")
    assert not guard_t.chaos.active() and not guard_j.chaos.active()


def test_cg_divergence_sets_breakdown_record():
    g = mesh_t.grid_graph_2d(16, 16)
    with guard_t.chaos.overlay(("cg_divergence",)):
        parts, report = rsb_t.rsb_partition_graph(g, 2, method="inverse",
                                                  device="cpu")
    assert any(r.breakdown for r in report.records)
    assert parts.shape == (g.n,) and report.guard is None


def test_halo_truncate_detected_and_rebuilt():
    gj, gt = mesh_j.grid_graph_2d(16, 16), mesh_t.grid_graph_2d(16, 16)
    parts = (np.arange(gt.n) // (gt.n // 4)).clip(0, 3)
    clean = pa_t.plan_halo_sharding(gt, parts, 4)
    assert pa_t.verify_halo_plan(clean) == []
    assert pa_t.verify_halo_plan(pa_t._truncate_exports(clean)) != []
    with guard_t.chaos.overlay(("halo_truncate",)):
        rebuilt = pa_t.plan_halo_sharding(gt, parts, 4)
    with guard_j.chaos.overlay(("halo_truncate",)):
        rebuilt_j = pa_j.plan_halo_sharding(gj, parts, 4)
    assert pa_t.verify_halo_plan(rebuilt) == []
    for f in dataclasses.fields(clean):
        a, b, c = (getattr(x, f.name) for x in (clean, rebuilt, rebuilt_j))
        assert np.array_equal(a, b) and np.array_equal(b, c), f.name


# ---------------------------------------------------------------------------
# The preset sweep (tests/test_guard.py:529-571) over the port's presets
# ---------------------------------------------------------------------------

def _pathological_mesh(m, kind, seed):
    rng = np.random.default_rng(seed)
    box = m.box_mesh(4, 4, 3)
    coords = np.asarray(box.coords).copy()
    weights = np.asarray(box.weights, float).copy()
    if kind == "nan-coords":
        coords[rng.choice(box.nelems, 3, replace=False)] = np.nan
    elif kind == "bad-weights":
        weights[rng.choice(box.nelems, 3, replace=False)] = np.nan
        weights[rng.choice(box.nelems, 2, replace=False)] = -2.0
    return dataclasses.replace(box, coords=coords, weights=weights)


PRESETS = sorted(cfg_t.PIPELINE_PRESETS)


def test_presets_cover_repro_but_reference():
    """Every preset of repro is ported, ``reference`` included."""
    assert set(PRESETS) == set(cfg_j.PIPELINE_PRESETS)
    assert "reference" in PRESETS


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("kind", ["nan-coords", "bad-weights"])
def test_presets_strict_mode_raises_typed(preset, kind):
    def run(cfg, m, **kw):
        mesh = _pathological_mesh(m, kind, seed=0)
        pipe = cfg.make_pipeline(preset, config=cfg.make_smoke_config(),
                                 guard=True, **kw)
        return _outcome(lambda: pipe.run(mesh, 4))

    got = run(cfg_t, mesh_t, device="cpu")
    assert got[0] == "GuardError"
    assert got == run(cfg_j, mesh_j)


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("preset", PRESETS)
def test_presets_sanitize_mode_upholds_invariant(preset, seed):
    kind = ["nan-coords", "bad-weights"][seed % 2]

    def run(cfg, m, **kw):
        return cfg.make_pipeline(
            preset, config=cfg.make_smoke_config(), guard=True,
            guard_kw={"sanitize": True}, **kw).run(
                _pathological_mesh(m, kind, seed), 4)

    ct, cj = run(cfg_t, mesh_t, device="cpu"), run(cfg_j, mesh_j)
    gr = ct.report.guard
    assert gr.validated and gr.sanitize_fixes > 0
    assert gr.to_dict() == cj.report.guard.to_dict()
    assert np.array_equal(ct.parts, cj.parts)
    parts = np.asarray(ct.parts)
    assert parts.shape == (48,) and parts.min() >= 0 and parts.max() < 4
    if "repair" in cfg_t.PIPELINE_PRESETS[preset]["post"]:
        assert guard_t.count_disconnected(ct.require_graph(), parts, 4) == 0
        assert sorted(np.unique(parts)) == [0, 1, 2, 3]


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_disconnected_graph(preset):
    def run(cfg, m, b, **kw):
        g = _two_grids(m, b, (4, 4), (4, 4))
        coords = np.concatenate([
            np.mgrid[0:4, 0:4].reshape(2, -1).T,
            np.mgrid[0:4, 0:4].reshape(2, -1).T + 100.0]).astype(float)
        return g, cfg.make_pipeline(preset, config=cfg.make_smoke_config(),
                                    guard=True, **kw).run(g, 2, coords=coords)

    g, ct = run(cfg_t, mesh_t, build_csr_t, device="cpu")
    _, cj = run(cfg_j, mesh_j, build_csr_j)
    assert ct.report.guard.components == 2
    assert np.array_equal(ct.parts, cj.parts)
    parts = np.asarray(ct.parts)
    assert parts.shape == (g.n,) and parts.min() >= 0 and parts.max() < 2
    if "repair" in cfg_t.PIPELINE_PRESETS[preset]["post"]:
        assert guard_t.count_disconnected(g, parts, 2) == 0


# ---------------------------------------------------------------------------
# KernelError: one type for every toolchain or launch fault
# ---------------------------------------------------------------------------

def test_kernel_error_type_and_messages(tmp_path, monkeypatch):
    assert issubclass(KernelError, RuntimeError)
    with pytest.raises(KernelError, match="ell_spmv_cuda: launch failed "
                       "with CUDA error 700"):
        _build.check_launch("ell_spmv_cuda", 700)
    _build.check_launch("ell_spmv_cuda", 0)

    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(KernelError, match="nvcc not found"):
        _build.build(src)

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(
                            a, 2, "", "k.cu(1): error: bad"))
    with pytest.raises(KernelError, match=r"nvcc failed \(2\) on k.cu"):
        _build.build(src)

    def fake_build(source):
        path = tmp_path / "libbroken.so"
        path.write_bytes(b"not a shared library")
        return path, ""

    monkeypatch.setattr(_build, "build", fake_build)
    with pytest.raises(KernelError, match="cannot load libbroken.so"):
        _build.load(src, {"fn": ()})
