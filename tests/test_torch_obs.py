"""repro_torch.obs: the port of repro.obs, held to it.

The counterparts of tests/test_obs.py (span nesting, the disabled fast
path, merge semantics, manifests, REPRO_OBS=off parity, the pipeline's
trace); the registry and span vocabulary equal to `repro`'s; a span tree
and counters equal to `repro`'s for the same runs — the span-name tree
exactly, every host-deterministic counter exactly, and the solver
counters by key only (their values follow the fp32 solves); the trace's
``guard_fallbacks`` equal to `repro`'s under each chaos site; manifests
readable by either package's loader; and the profiler ranges, with the
``REPRO_OBS_TORCH`` gate off and on.
"""

import dataclasses
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.configs.parrsb as cfg_j
import repro.core.pipeline as pipe_j
import repro.mesh as mesh_j
import repro.obs as obs_j
import repro_torch.configs.parrsb as cfg_t
import repro_torch.mesh as mesh_t
from repro_torch import obs
from repro_torch.core.pipeline import PartitionPipeline
from repro_torch.dist.partition_aware import plan_halo_sharding
from repro_torch.mesh import dual_graph, pebble_mesh

_PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
# Counters whose values follow the fp32 solves (compared by key only).
SOLVER_METRICS = {"residual_max", "lanczos_restarts", "inverse_outer_iters",
                  "cg_inner_iters"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _obs_on():
    """Every test starts with tracing on (both packages) and an empty
    span stack."""
    prev, prev_j = obs.set_enabled(True), obs_j.set_enabled(True)
    yield
    obs.set_enabled(prev)
    obs_j.set_enabled(prev_j)


# ---------------------------------------------------------------------------
# Span tree: nesting, ordering, timing (tests/test_obs.py's counterparts)
# ---------------------------------------------------------------------------

def test_span_nesting_and_ordering():
    with obs.trace("root", run=1) as root:
        with obs.span("a"):
            obs.counter_add("hits", 2)
            with obs.span("a1"):
                pass
            with obs.span("a2"):
                pass
        with obs.span("b"):
            pass
    assert [c.name for c in root.children] == ["a", "b"]
    a = root.find("a")
    assert [c.name for c in a.children] == ["a1", "a2"]
    assert a.counters == {"hits": 2.0}
    assert root.tags == {"run": 1}
    assert [s.name for s in root.walk()] == ["root", "a", "a1", "a2", "b"]
    assert a.t0 >= root.t0 and a.t1 <= root.t1 + 1e-9
    assert root.seconds >= a.seconds


def test_timed_measures_inside_and_outside_traces():
    with obs.trace("root") as root:
        with obs.timed("work") as t:
            pass
        assert isinstance(t, obs.Span)
        with obs.stopwatch() as sw:      # never a span, traced or not
            pass
    assert root.find("work") is t
    assert [c.name for c in root.children] == ["work"]
    assert not isinstance(sw, obs.Span) and sw.seconds >= 0.0
    with obs.timed("loose") as t2:
        pass
    assert not isinstance(t2, obs.Span)
    assert t2.seconds >= 0.0


def test_exception_pops_span_stack():
    with pytest.raises(RuntimeError):
        with obs.trace("root"):
            with obs.span("inner"):
                raise RuntimeError("boom")
    assert obs.current_span() is None


def test_disabled_span_is_shared_noop_singleton():
    with obs.disabled():
        s1 = obs.span("x")
        s2 = obs.span("y", tag=1)
        assert s1 is obs.NOOP_SPAN and s2 is obs.NOOP_SPAN
        with s1:
            pass
        assert obs.current_span() is None
        with obs.trace("root") as t:
            pass
        assert not isinstance(t, obs.Span) and t.seconds >= 0.0
        obs.counter_add("nope")
        obs.gauge_set("nope", 1)
        obs.gauge_max("nope", 1)
    assert obs.span("loose") is obs.NOOP_SPAN


def test_env_switch_is_repro_obs(monkeypatch):
    import importlib
    tr = importlib.import_module("repro_torch.obs.trace")
    for value, want in (("off", False), ("0", False), ("No", False),
                        ("on", True), ("1", True)):
        monkeypatch.setenv("REPRO_OBS", value)
        assert tr._env_enabled() is want
    monkeypatch.delenv("REPRO_OBS")
    assert tr._env_enabled()


def test_counters_sum_over_subtree():
    with obs.trace("root") as root:
        obs.counter_add("fm_moves", 3)
        with obs.span("child"):
            obs.counter_add("fm_moves", 4)
    assert root.total_counters()["fm_moves"] == 7.0


def test_gauge_aggregation_follows_registry():
    with obs.trace("root") as root:
        obs.gauge_max("residual_max", 0.5)
        obs.gauge_set("edge_cut", 100.0)
        with obs.span("child"):
            obs.gauge_max("residual_max", 0.2)
            obs.gauge_set("edge_cut", 80.0)
            obs.gauge_set("amg_levels", 4)
            obs.gauge_set("ml_coarsen_ratio", 0.5)
        obs.gauge_set("ml_coarsen_ratio", 0.25)
    total = root.total_counters()
    assert total["residual_max"] == 0.5
    assert total["edge_cut"] == 80.0
    assert total["amg_levels"] == 4
    assert total["ml_coarsen_ratio"] == 0.25    # min-gauge


def test_gauge_max_within_one_span():
    with obs.trace("root") as root:
        obs.gauge_max("residual_max", 0.1)
        obs.gauge_max("residual_max", 0.3)
        obs.gauge_max("residual_max", 0.2)
    assert root.gauges["residual_max"] == 0.3


def test_merge_metrics_unregistered_defaults():
    dst = {}
    obs.merge_metrics(dst, {"custom": 1.0}, kind="counter")
    obs.merge_metrics(dst, {"custom": 2.0}, kind="counter")
    assert dst["custom"] == 3.0
    g = {}
    obs.merge_metrics(g, {"g": 1.0}, kind="gauge")
    obs.merge_metrics(g, {"g": 0.5}, kind="gauge")
    assert g["g"] == 1.0


def test_percentiles_nearest_rank():
    secs = [float(i) for i in range(101)]
    p = obs.percentiles(secs)
    assert p["p50"] == 50.0 and p["p99"] == 99.0
    assert obs.percentiles([]) == {"p50": 0.0, "p99": 0.0}


def test_render_elides_and_reports_off():
    with obs.trace("root") as root:
        with obs.timed("work", level=0):
            obs.counter_add("fm_moves", 3)
    text = obs.render(root, max_depth=2)
    assert text.splitlines()[0].startswith("root")
    assert "fm_moves=3" in text and "level=0" in text
    assert "REPRO_OBS=off" in obs.render(None)


# ---------------------------------------------------------------------------
# The registry and span vocabulary are repro's
# ---------------------------------------------------------------------------

def test_registry_and_vocabulary_equal_repro():
    got = {k: dataclasses.asdict(v) for k, v in obs.registered().items()}
    want = {k: dataclasses.asdict(v) for k, v in obs_j.registered().items()}
    assert got == want
    from repro.obs import registry as reg_j
    assert obs.SPAN_NAMES == reg_j.SPAN_NAMES
    assert obs.SPAN_PREFIXES == reg_j.SPAN_PREFIXES
    assert obs.SCHEMA == obs_j.SCHEMA
    for name in ("partition", "level:3", "sweep:0", "mlevel:2", "engine",
                 "order", "device", "dual_graph", "fiedler:lanczos"):
        assert obs.span_declared(name) == reg_j.span_declared(name)


_SPAN_CALL = re.compile(r"obs\.(?:span|timed|trace)\(\s*(f?)\"([^\"]*)\"")


def test_every_span_name_in_the_port_is_declared():
    """`repro`'s lint rule OBS001, for the port: every span()/timed()/
    trace() name in src/repro_torch is in the vocabulary (an f-string by
    its literal prefix)."""
    names = []
    for f in sorted(_PORT.rglob("*.py")):
        for fmt, name in _SPAN_CALL.findall(f.read_text()):
            names.append((f.name, name.split("{")[0] if fmt else name))
    assert len(names) >= 25
    bad = [(f, n) for f, n in names if not obs.span_declared(n)]
    assert bad == []


def test_register_validates_kinds():
    with pytest.raises(ValueError):
        obs.register("x_bad", "histogram")
    with pytest.raises(ValueError):
        obs.register("x_bad", "counter", agg="max")
    with pytest.raises(ValueError):
        obs.register("x_bad", "gauge", agg="sum")
    assert obs.lookup("x_bad") is None


# ---------------------------------------------------------------------------
# Manifests: round trip, validation, and repro's loader
# ---------------------------------------------------------------------------

def test_manifest_round_trip(tmp_path):
    with obs.trace("partition", nparts=4) as root:
        with obs.span("bisect:rsb-batched"):
            obs.counter_add("fiedler_solves", 3)
            obs.gauge_set("amg_levels", 2)
    path = str(tmp_path / "run.jsonl")
    config = {"pre": "none", "bisect": "rsb-batched", "post": []}
    obs.write_manifest(root, path, name="t", config=config)
    header, loaded = obs.load_manifest(path)
    assert header["schema"] == obs.SCHEMA
    assert header["config"] == config
    assert header["totals"]["metrics"]["fiedler_solves"] == 3.0
    assert [s.name for s in loaded.walk()] == [s.name for s in root.walk()]
    b = loaded.find("bisect:rsb-batched")
    assert b.counters == {"fiedler_solves": 3.0}
    assert b.gauges == {"amg_levels": 2}
    assert loaded.tags == {"nparts": 4}
    assert abs(loaded.seconds - root.seconds) < 1e-9
    with open(path) as f:
        for line in f:
            json.loads(line)
    with pytest.raises(ValueError, match="not a repro.obs manifest"):
        bad = tmp_path / "bad.jsonl"
        bad.write_text('{"type": "span"}\n')
        obs.load_manifest(str(bad))


def test_validate_manifest_flags_missing_stage_span(tmp_path):
    with obs.trace("partition") as root:
        with obs.span("pre:rcb"):
            pass
    path = str(tmp_path / "bad.jsonl")
    obs.write_manifest(root, path, name="t", config={
        "pre": "rcb", "bisect": "rsb-batched", "post": ["repair"]})
    problems = obs.validate_manifest(path)
    missing = {p.split("'")[1] for p in problems if "missing span" in p}
    assert missing == {"bisect:rsb-batched", "solve", "split", "post:repair"}
    assert obs.validate_manifest(str(tmp_path / "none.jsonl"))[0].startswith(
        "unreadable manifest")


@pytest.mark.parametrize("config", [
    {"pre": "none", "bisect": "rcb", "post": ["repair", "kway"]},
    {"pre": "rcb", "bisect": "rsb-recursive", "post": [], "guard": True},
    {"pre": "none", "bisect": "multilevel", "post": ["repair"]},
    {"pre": "rcb", "bisect": "rsb-batched", "post": [], "components": 2},
])
def test_expected_span_names_from_config(config):
    assert obs.expected_span_names(config) == obs_j.expected_span_names(config)


@pytest.fixture(scope="module")
def small_mesh():
    return pebble_mesh(6, 6, 6, n_pebbles=2, seed=3)


def test_pipeline_records_trace_and_manifest(small_mesh, tmp_path):
    pipe = PartitionPipeline(pre="rcb", bisect="rsb-batched",
                             post=("repair", "refine"), device="cpu")
    ctx = pipe.run(small_mesh, 4)
    root = ctx.trace
    assert root is not None and root.name == "partition"
    for name in obs.expected_span_names(ctx.config):
        assert root.find(name) is not None, name
    for rec in ctx.stages:
        if rec.kind == "setup":       # the port's own record, no span
            continue
        span = root.find(f"{rec.kind}:{rec.name}")
        assert span is not None
        assert abs(span.seconds - rec.seconds) < 0.05
    path = ctx.export_manifest(str(tmp_path / "m.jsonl"))
    assert obs.validate_manifest(path) == []
    # the port's manifest is repro's format: repro loads and validates it
    header, loaded = obs_j.load_manifest(path)
    assert header["schema"] == obs_j.SCHEMA
    assert [s.name for s in loaded.walk()] == [s.name for s in root.walk()]
    assert obs_j.validate_manifest(path) == []
    tpath = ctx.export_trace_events(str(tmp_path / "t.json"))
    events = json.load(open(tpath))["traceEvents"]
    assert {e["name"] for e in events} >= {"partition", "solve", "split"}


def test_repro_obs_off_parity(small_mesh):
    pipe = PartitionPipeline(pre="rcb", bisect="rsb-batched",
                             post=("repair", "refine"), device="cpu")
    ctx_on = pipe.run(small_mesh, 4)
    with obs.disabled():
        ctx_off = pipe.run(small_mesh, 4)
    assert np.array_equal(ctx_on.parts, ctx_off.parts)
    assert np.array_equal(ctx_on.parts_raw, ctx_off.parts_raw)
    assert ctx_off.trace is None
    assert ctx_off.export_manifest() is None
    assert ctx_off.report.seconds > 0
    assert ctx_off.report.post.seconds > 0
    assert all(lv.solve_seconds > 0 for lv in ctx_off.report.levels)
    assert all(s.seconds >= 0 for s in ctx_off.stages)
    assert [s.name for s in ctx_off.stages] == [s.name for s in ctx_on.stages]


def test_repro_obs_dir_auto_manifest(small_mesh, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path))
    PartitionPipeline(bisect="rcb", post=(), device="cpu").run(small_mesh, 4)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".jsonl")]
    assert len(files) == 1
    assert obs.validate_manifest(str(tmp_path / files[0])) == []


def test_recursive_engine_split_seconds(small_mesh):
    pipe = PartitionPipeline(pre="rcb", bisect="rsb-recursive", post=(),
                             device="cpu")
    ctx = pipe.run(small_mesh, 4)
    assert all(lv.split_seconds > 0 for lv in ctx.report.levels)
    assert all(r.split_seconds > 0 for r in ctx.report.records)
    assert len(ctx.trace.find_all("solve")) == len(ctx.report.records)


def test_halo_plan_emits_wire_volume(small_mesh):
    graph = dual_graph(small_mesh)
    parts = np.arange(graph.n) % 4
    with obs.trace("root") as root:
        plan = plan_halo_sharding(graph, parts, 4)
    assert root.counters["halo_words"] == plan.collective_words_per_feature
    assert root.counters["halo_bytes"] == 4.0 * plan.collective_words_per_feature
    assert root.gauges["halo_max_degree"] == plan.halo


# ---------------------------------------------------------------------------
# The same runs, the same trees and counters as repro's
# ---------------------------------------------------------------------------

def _tree(span):
    return (span.name, [_tree(c) for c in span.children])


def _assert_same_trace(tj, tt):
    assert _tree(tt) == _tree(tj)
    a, b = tj.total_counters(), tt.total_counters()
    assert set(b) == set(a)
    for k in set(a) - SOLVER_METRICS:
        assert b[k] == a[k], k


@pytest.fixture(scope="module")
def chaos_mesh():
    return (mesh_j.pebble_mesh(8, 8, 8, n_pebbles=3, seed=0),
            mesh_t.pebble_mesh(8, 8, 8, n_pebbles=3, seed=0))


RUNS = {   # name: (preset, make_pipeline overrides) — 8 parts
    "default": ("default", {}),
    "kway-sharded": ("default", dict(post=("kway-sharded",))),
    "multilevel": ("multilevel", {}),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_span_tree_and_counters_equal_repro(chaos_mesh, name):
    preset, kw = RUNS[name]
    mj, mt = chaos_mesh
    cj = cfg_j.make_pipeline(preset, **kw).run(mj, 8)
    ct = cfg_t.make_pipeline(preset, device="cpu", **kw).run(mt, 8)
    assert np.array_equal(ct.parts, cj.parts)
    _assert_same_trace(cj.trace, ct.trace)
    total = ct.trace.total_counters()
    if name == "kway-sharded":
        assert total["sharded_gathers"] == total["sharded_sweeps"] > 0
        assert len(ct.trace.find_all("sweep:0")) == 1
    if name == "default":
        assert total["fiedler_solves"] == len(ct.report.records)


CHAOS_SITES = ["solver_nan", "empty_split", "cg_divergence", "deadline",
               "halo_truncate"]


@pytest.mark.parametrize("site", CHAOS_SITES)
def test_guard_fallbacks_in_trace_equal_repro(site):
    """`benchmarks/smoke_check.py::check_chaos`'s configuration per site,
    on a 212-element mesh into 4 parts."""
    kw = dict(pre="rcb", bisect="rsb-batched",
              post=(("repair", "refine-sharded") if site == "halo_truncate"
                    else ("repair", "refine")),
              bisect_kw={"method": "inverse"} if site == "cg_divergence"
              else {}, guard=True, guard_kw={"chaos": (site,)})
    mj = mesh_j.pebble_mesh(6, 6, 6, n_pebbles=2, seed=3)
    mt = mesh_t.pebble_mesh(6, 6, 6, n_pebbles=2, seed=3)
    cj = pipe_j.PartitionPipeline(**kw).run(mj, 4)
    ct = PartitionPipeline(device="cpu", **kw).run(mt, 4)
    tj, tt = cj.trace.total_counters(), ct.trace.total_counters()
    assert tt.get("guard_fallbacks") == tj.get("guard_fallbacks")
    assert tt.get("guard_retries") == tj.get("guard_retries")
    assert tt.get("guard_deadline_expired") == tj.get("guard_deadline_expired")
    assert ct.report.guard.to_dict() == cj.report.guard.to_dict()
    if site != "halo_truncate":
        # the report's fallbacks all stem from the solver ladder here
        assert tt["guard_fallbacks"] == ct.report.guard.fallbacks > 0
    _assert_same_trace(cj.trace, ct.trace)


# ---------------------------------------------------------------------------
# Profiler ranges (repro.obs.jaxprof's counterpart)
# ---------------------------------------------------------------------------

def test_annotate_is_free_with_the_gate_off(monkeypatch):
    monkeypatch.delenv("REPRO_OBS_TORCH", raising=False)
    import contextlib
    assert isinstance(obs.annotate("fiedler:lanczos"),
                      contextlib.nullcontext)
    assert obs.maybe_start_trace() is None
    assert obs.maybe_stop_trace(None) is None


def test_annotate_range_seen_by_the_profiler(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_OBS_TORCH", "1")
    monkeypatch.setenv("REPRO_OBS_TORCH_DIR", str(tmp_path))
    cap = obs.maybe_start_trace()
    assert cap is not None
    with obs.annotate("fiedler:lanczos"):
        torch.ones(64).cumsum(0)
    path = obs.maybe_stop_trace(cap)
    names = {e.name for e in cap.profile.events()}
    assert "fiedler:lanczos" in names
    assert os.path.dirname(path) == str(tmp_path)
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "fiedler:lanczos" for e in events)


def test_solve_sites_open_their_ranges(monkeypatch, small_mesh):
    """A traced Lanczos partition puts its packed solves under
    ``fiedler:lanczos_packed:N…`` ranges in the capture."""
    monkeypatch.setenv("REPRO_OBS_TORCH", "1")
    monkeypatch.setenv("REPRO_OBS_TORCH_DIR", "unused")
    cap = obs.maybe_start_trace()
    PartitionPipeline(post=(), device="cpu").run(small_mesh, 2)
    cap.profile.stop()
    names = {e.name for e in cap.profile.events()}
    assert any(n.startswith("fiedler:lanczos_packed:N") for n in names)
