"""Tests for ``repro_torch.analysis`` — the port's AST contract checker —
held to `repro.analysis` where the two share a rule.

* Per rule: each of the 13 counterparts' bad snippet (kept here; the
  kernel rules' as small trees written to a temporary directory) gives
  exactly one diagnostic, of that rule, at its ``# <- RULE`` marker line,
  and a ``# repro: ignore[RULE]`` above the marker silences it.
* The analyzer reports 0 findings over ``src/repro_torch``.
* On `repro`'s own fixtures for the rules that are the same (DET003,
  OBS001, OBS002, GRD001, GRD002) the port's engine gives `repro`'s
  (rule, line, col).
* The port's `Project` vocabularies (span names and prefixes, metrics,
  fault sites, guard codes) equal those `repro`'s `Project` reads from
  ``src/repro``.
* A copy of the port's tree with a plain fallback inserted into one
  ``ops.py`` fires PAL102 (the counterpart of PAL002) there and only
  there.
* The CLI exits with 0, 1 and 2 where `repro`'s does.
"""

import glob
import json
import os
import shutil
import textwrap

import pytest

from repro.analysis import analyze_paths as analyze_paths_j
from repro.analysis import analyze_source as analyze_source_j
from repro.analysis.__main__ import main as main_j
from repro.analysis.engine import Project as ProjectJ
from repro.analysis.rules import rule_ids as rule_ids_j
from repro_torch.analysis import all_rules, analyze_paths, analyze_source
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.engine import (ModuleIndex, Project, findings_json,
                                         parse_suppressions)
from repro_torch.analysis.rules import rule_ids
from repro_torch.analysis.rules.kernel_rules import c_arities, prototypes

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src", "repro_torch")
SRC_J = os.path.join(REPO, "src", "repro")
FIXTURES_J = os.path.join(HERE, "analysis_fixtures")


@pytest.fixture(scope="module")
def project():
    return Project(SRC)


def _src(text: str) -> str:
    return textwrap.dedent(text).lstrip("\n")


# One bad snippet a case: the case's rule is the text before any "/".
SNIPPETS = {
    "TRC101": _src('''
        import torch

        _op = torch.library.custom_op("t::f", mutates_args=())(lambda x: x)


        @_op.register_fake
        def _shape(x):
            n = x.sum().item()  # <- TRC101
            return x.new_empty((n,))
        '''),
    "TRC101/obs": _src('''
        from repro_torch import obs


        def count(t):
            obs.counter_add("lanczos_iters", t.sum().item())  # <- TRC101
        '''),
    "TRC102": _src('''
        import torch


        @torch.library.register_fake("t::g")
        def _shape(x):
            if torch.any(x < 0):  # <- TRC102
                return x.new_empty(x.shape)
            return x.new_empty(x.shape[:1])
        '''),
    "DET101": _src('''
        import time

        import torch


        def _shape(x):
            t0 = time.perf_counter()  # <- DET101
            return x.new_empty(x.shape), t0


        op = torch.library.custom_op("t::h", mutates_args=())(lambda x: x)
        op.register_fake(_shape)
        '''),
    "DET101/ref": _src('''
        import datetime


        def plain(x):
            stamp = datetime.datetime.now()  # <- DET101
            return x, stamp
        '''),
    "DET102": _src('''
        import torch


        def draw(n, g):
            a = torch.randn(n, 4, generator=g)
            return a + torch.randn(n, 4)  # <- DET102
        '''),
    "DET102/seed": _src('''
        import torch


        def setup():
            torch.manual_seed(0)  # <- DET102
        '''),
    "DET003": _src('''
        def order(xs):
            return [x for x in set(xs)]  # <- DET003
        '''),
    "DIST101": _src('''
        from repro_torch.dist import group as dist_group


        def sweep(x, group, n):
            total = dist_group.all_reduce_sum(x, group)
            for _ in range(n):
                x = dist_group.all_reduce_sum(x, group)  # <- DIST101
            return x, total
        '''),
    "DIST101/rules": _src('''
        def lookups(rules, xs):
            out = []
            for x in xs:
                out.append(rules.gather(x, "model", 0))  # <- DIST101
            return out
        '''),
    "DIST102": _src('''
        def place(rules, x):
            return rules.psum(x, "modle")  # <- DIST102
        '''),
    "DIST102/spec": _src('''
        from repro_torch.dist.sharding import Spec

        ROWS = Spec("model", None)
        USERS = Spec(("pod", "dta"), None)  # <- DIST102
        '''),
    "DIST102/logical": _src('''
        def heads(rules, shape):
            return rules.spec(("batch", "hedas"), shape)  # <- DIST102
        '''),
    "OBS001": _src('''
        from repro_torch import obs


        def run():
            with obs.span("not_a_declared_span"):  # <- OBS001
                pass
        '''),
    "OBS002": _src('''
        from repro_torch import obs


        def run():
            obs.counter_add("no_such_metric", 1)  # <- OBS002
        '''),
    "GRD001": _src('''
        from repro_torch.guard import chaos


        def maybe(x):
            if chaos.should_fire("no_such_site"):  # <- GRD001
                return -x
            return x
        '''),
    "GRD002": _src('''
        from repro_torch.guard.errors import GuardError


        def fail():
            raise GuardError("no-such-code", "boom")  # <- GRD002
        '''),
}
# The snippets that name a kernel's ref.py
PATHS = {"DET101/ref": os.path.join("kernels", "k", "ref.py")}

CU = _src('''
    // a kernel of three pointers, a count and a stream
    extern "C" int k_fwd(const void* a, const void* b, void* c,
                         long long n, void* stream) {
      return 0;
    }
    ''')
GOOD_CUDA = _src('''
    import ctypes

    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    _FUNCS = {"f32": "k_fwd"}


    def _load(build):
        table = {name: [ptr] * 3 + [i64, ptr] for name in _FUNCS.values()}
        table.update({"k_fwd": [ptr] * 3 + [i64, ptr]})
        return build.load("k.cu", table)
    ''')
GOOD_OPS = _src('''
    from pkg.kernels.k import cuda
    from pkg.kernels.k.ref import k_ref


    def k(x, prefer="auto"):
        if prefer == "ref":
            return k_ref(x)
        try:
            return cuda.k_cuda(x)
        except RuntimeError as e:
            raise ValueError("k: the kernel failed") from e
    ''')
# The kernel rules: a tree of files; one of them carries the marker.
TREES = {
    "PAL101": {"cuda.py": _src('''
        import ctypes

        ptr, i32 = ctypes.c_void_p, ctypes.c_int


        def _load(build):
            return build.load("k.cu", {
                "k_fwd": [ptr] * 3 + [i32, i32, ptr],  # <- PAL101
            })
        '''), "ops.py": GOOD_OPS},
    "PAL101/missing": {"cuda.py": _src('''
        import ctypes

        ptr = ctypes.c_void_p
        _FUNCS = {"f32": "k_fwd", "bf16": "k_fwd_bf16"}


        def _load(build):
            return build.load("k.cu", {  # <- PAL101
                name: [ptr] * 4 + [ptr] for name in _FUNCS.values()})
        '''), "ops.py": GOOD_OPS},
    "PAL102": {"cuda.py": GOOD_CUDA, "ops.py": _src('''
        from pkg.kernels.k import cuda
        from pkg.kernels.k.ref import k_ref


        def k(x):
            try:
                return cuda.k_cuda(x)
            except RuntimeError:  # <- PAL102
                return k_ref(x)
        ''')},
}


def rule_of(case: str) -> str:
    return case.split("/")[0]


def marker_line(source: str, rule: str) -> int:
    for i, line in enumerate(source.splitlines(), start=1):
        if f"# <- {rule}" in line:
            return i
    raise AssertionError(f"snippet for {rule} has no marker line")


def suppressed(source: str, rule: str, tag: str | None = None) -> str:
    lines = source.splitlines()
    mark = f"# repro: ignore[{tag or rule}]" if tag != "" else \
        "# repro: ignore"
    indent = len(lines[marker_line(source, rule) - 1]) - len(
        lines[marker_line(source, rule) - 1].lstrip())
    lines.insert(marker_line(source, rule) - 1, " " * indent + mark)
    return "\n".join(lines) + "\n"


def write_tree(root, files: dict) -> str:
    """``files`` as ``root/kernels/k/…`` with the CUDA source and a plain
    ``ref.py``; returns the package directory."""
    kdir = os.path.join(root, "kernels", "k")
    os.makedirs(os.path.join(kdir, "csrc"))
    with open(os.path.join(kdir, "csrc", "k.cu"), "w") as f:
        f.write(CU)
    files = dict({"ref.py": "def k_ref(x):\n    return x\n"}, **files)
    for name, text in files.items():
        with open(os.path.join(kdir, name), "w") as f:
            f.write(text)
    return kdir


def marked_file(files: dict, rule: str) -> str:
    return next(n for n, t in files.items() if f"# <- {rule}" in t)


# ---------------------------------------------------------------------------
# Per rule: the snippet fires exactly once, at the marker; its suppression
# silences it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SNIPPETS)
def test_rule_fires_once_at_marker(case, project):
    rule, source = rule_of(case), SNIPPETS[case]
    diags = analyze_source(source, project=project,
                           path=PATHS.get(case, "<memory>"))
    assert [(d.rule, d.line) for d in diags] == \
        [(rule, marker_line(source, rule))], [d.render() for d in diags]
    assert diags[0].message


@pytest.mark.parametrize("case", SNIPPETS)
@pytest.mark.parametrize("tag", ["rule", "bare"])
def test_rule_suppressed_by_ignore(case, tag, project):
    rule = rule_of(case)
    source = suppressed(SNIPPETS[case], rule, rule if tag == "rule" else "")
    assert analyze_source(source, project=project,
                          path=PATHS.get(case, "<memory>")) == []


@pytest.mark.parametrize("case", TREES)
def test_kernel_rule_fires_once_at_marker(case, tmp_path, project):
    rule, files = rule_of(case), TREES[case]
    kdir = write_tree(str(tmp_path), files)
    name = marked_file(files, rule)
    diags = analyze_paths([str(tmp_path)], project=project)
    assert [(d.rule, os.path.basename(d.path), d.line) for d in diags] == \
        [(rule, name, marker_line(files[name], rule))], \
        [d.render() for d in diags]
    assert os.path.dirname(diags[0].path) == kdir


@pytest.mark.parametrize("case", TREES)
def test_kernel_rule_suppressed_by_ignore(case, tmp_path, project):
    rule, files = rule_of(case), dict(TREES[case])
    name = marked_file(files, rule)
    files[name] = suppressed(files[name], rule)
    write_tree(str(tmp_path), files)
    assert analyze_paths([str(tmp_path)], project=project) == []


def test_every_rule_has_a_case():
    assert {rule_of(c) for c in list(SNIPPETS) + list(TREES)} == \
        set(rule_ids())


def test_wrong_rule_suppression_does_not_silence(project):
    source = suppressed(SNIPPETS["TRC101"], "TRC101", "TRC102")
    assert [d.rule for d in analyze_source(source, project=project)] == \
        ["TRC101"]


def test_kernel_triple_members_and_imports(tmp_path, project):
    """A package with only a binding: ref.py, ops.py missing; an ops.py
    importing neither module; a package with no csrc."""
    kdir = tmp_path / "kernels" / "lonely"
    kdir.mkdir(parents=True)
    (kdir / "cuda.py").write_text("def lonely(x):\n    return x\n")
    bare = tmp_path / "kernels" / "bare"
    bare.mkdir(parents=True)
    for name in ("cuda.py", "ref.py"):
        (bare / name).write_text("X = 1\n")
    (bare / "ops.py").write_text("import torch\n")
    diags = analyze_paths([str(tmp_path)], project=project)
    assert {d.rule for d in diags} == {"PAL102"}
    lonely = sorted(d.message for d in diags if "lonely" in d.path)
    assert any("missing ref.py" in m for m in lonely)
    assert any("missing ops.py" in m for m in lonely)
    assert any("no csrc" in m for m in lonely)
    assert sorted(d.message.split("`")[1] for d in diags
                  if d.path.endswith(os.path.join("bare", "ops.py"))) == \
        ["cuda", "ref"]


def test_fallback_inserted_in_a_copy_of_the_tree_fires(tmp_path, project):
    """The port's own tree with `_run` of K5's ops.py answering a failed
    kernel call with the plain version: one PAL102, there."""
    copy = tmp_path / "repro_torch"
    shutil.copytree(SRC, copy, ignore=shutil.ignore_patterns("__pycache__"))
    ops = copy / "kernels" / "embedding_bag" / "ops.py"
    text = ops.read_text()
    old = ("    return cuda.embedding_bag_cuda(\n"
           "        table, indices.to(torch.int32).contiguous(),\n"
           "        segments.to(torch.int32).contiguous(), "
           "weights.contiguous(), n_bags,\n"
           "        split=split)\n")
    assert old in text
    new = ("    try:\n" + textwrap.indent(old, "    ")
           + "    except RuntimeError:\n"
           "        return embedding_bag_ref(table, indices, segments, "
           "n_bags,\n"
           "                                 weights=weights)\n")
    ops.write_text(text.replace(old, new))
    diags = analyze_paths([str(copy)])
    assert [(d.rule, d.path) for d in diags] == [("PAL102", str(ops))], \
        [d.render() for d in diags]
    assert "fall back" in diags[0].message


# ---------------------------------------------------------------------------
# Engine mechanics
# ---------------------------------------------------------------------------


def test_protocol_and_fake_contexts(project):
    """No finding outside the contexts: a loop with a collective in a
    function with no group/rules, a sync in an ordinary function, a
    `for` whose iterable is the collective, and `torch.gather` in a
    protocol loop."""
    source = _src('''
        import torch
        from repro_torch.dist import group as dist_group


        def plain(x, g, n):
            for _ in range(n):
                x = dist_group.all_reduce_sum(x, g)
            return x.sum().item()


        def waits(ops, group):
            for work in dist_group.all_gather_rows(ops, group):
                work.wait()


        def picks(rules, xs, idx):
            return [torch.gather(x, 1, idx) for x in xs] + [
                x.gather(1, idx) for x in xs]
        ''')
    assert analyze_source(source, project=project) == []


def test_fake_rules_of_the_port_are_seen():
    """K5's and K6's shape rules (K6's forward, its forward with the
    logsumexp, and its backward) are fake frames (TRC101/TRC102/DET101
    have something to check on the real tree)."""
    import ast

    for k, n in (("embedding_bag", 1), ("flash_attention", 3)):
        path = os.path.join(SRC, "kernels", k, "ops.py")
        with open(path) as f:
            index = ModuleIndex(ast.parse(f.read()))
        assert len(index.fake) == n, k


def test_binding_prototypes_of_the_port_match_their_sources():
    """Every ctypes prototype of the four bindings is found and has its
    CUDA function's arity (PAL101 checks something on the real tree)."""
    import ast

    seen = {}
    for k in ("ell_spmv", "embedding_bag", "flash_attention", "segment_sum"):
        kdir = os.path.join(SRC, "kernels", k)
        with open(os.path.join(kdir, "cuda.py")) as f:
            protos = prototypes(ast.parse(f.read()))
        arity = {}
        for cu in glob.glob(os.path.join(kdir, "csrc", "*.cu")):
            with open(cu) as f:
                arity.update(c_arities(f.read()))
        assert protos, k
        for name, n, _ in protos:
            assert arity[name] == n, name
            seen[name] = n
    assert set(seen) == {"ell_spmv_f32", "ell_spmv_bf16",
                         "ell_spmv_batched_f32", "ell_spmv_batched_bf16",
                         "embedding_bag_fwd", "flash_attention_fwd",
                         "flash_attention_bwd", "segment_sum_f32",
                         "segment_sum_batched_f32"}


def test_syntax_error_becomes_parse_diagnostic(project):
    diags = analyze_source("def f(:\n", project=project)
    assert [d.rule for d in diags] == ["PARSE"]


def test_parse_suppressions_covers_line_and_next():
    supp = parse_suppressions(
        "x = 1\n# repro: ignore[TRC101,DET102]\ny = 2\nz = 3\n")
    assert supp[2] == supp[3] == {"TRC101", "DET102"}
    assert 4 not in supp


def test_findings_json_schema(project):
    diags = analyze_source(SNIPPETS["DET102"], project=project)
    report = json.loads(findings_json(diags))
    assert report["schema"] == "repro.analysis/v1"
    assert report["counts"] == {"DET102": 1}
    assert {r["id"] for r in report["rules"]} == set(rule_ids())


def test_catalog_has_one_counterpart_for_each_repro_rule():
    ids = rule_ids()
    assert len(ids) == len(set(ids)) == len(all_rules()) == 13
    assert sorted(r.repro_id for r in all_rules()) == sorted(rule_ids_j())
    same = {r.id for r in all_rules() if r.id == r.repro_id}
    assert same == {"DET003", "OBS001", "OBS002", "GRD001", "GRD002"}


# ---------------------------------------------------------------------------
# Against repro
# ---------------------------------------------------------------------------


def test_src_tree_is_clean():
    """The burn-down contract: the port's tree has zero findings."""
    diags = analyze_paths([SRC])
    assert diags == [], "\n".join(d.render() for d in diags)


@pytest.mark.parametrize("rule", ["DET003", "OBS001", "OBS002", "GRD001",
                                  "GRD002"])
def test_shared_rules_give_repros_findings_on_its_fixtures(rule, project):
    with open(os.path.join(FIXTURES_J, f"bad_{rule.lower()}.py")) as f:
        source = f.read()
    want = [(d.rule, d.line, d.col)
            for d in analyze_source_j(source, project=ProjectJ(SRC_J))]
    got = [(d.rule, d.line, d.col)
           for d in analyze_source(source, project=project)]
    assert got == want and len(got) == 1


def test_project_vocabularies_equal_repros(project):
    theirs = ProjectJ(SRC_J)
    assert project.metric_names == theirs.metric_names
    assert project.span_names == theirs.span_names
    assert project.span_prefixes == theirs.span_prefixes
    assert project.fault_sites == theirs.fault_sites
    assert project.guard_code_list == theirs.guard_code_list
    assert project.mesh_axes == {"pod", "data", "model"}
    assert {"batch", "vocab", "heads", "experts"} <= project.logical_axes


@pytest.mark.parametrize("case", ["clean", "findings", "missing"])
def test_cli_exit_codes_match_repros(case, tmp_path, capsys):
    if case == "clean":
        args, args_j = [SRC], [SRC_J]
    elif case == "findings":
        bad = os.path.join(FIXTURES_J, "bad_det003.py")
        args, args_j = [bad, "--root", SRC], [bad, "--root", SRC_J]
    else:
        args = args_j = [str(tmp_path / "no_such_dir")]
    want = main_j(args_j)
    assert main(args) == want == {"clean": 0, "findings": 1,
                                  "missing": 2}[case]
    capsys.readouterr()


def test_cli_json_output_and_rule_list(tmp_path, capsys):
    out = tmp_path / "findings.json"
    bad = tmp_path / "bad.py"
    bad.write_text(SNIPPETS["DET102"])
    assert main([str(bad), "--root", SRC, "--format", "json",
                 "--output", str(out)]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["counts"] == {"DET102": 1}
    assert json.loads(out.read_text()) == report
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for r in all_rules():
        assert r.id in listed and f"repro {r.repro_id}" in listed


def test_repro_analyzer_still_clean_on_repro():
    """`repro`'s analyzer, unchanged, over `repro`'s tree."""
    assert analyze_paths_j([SRC_J]) == []
