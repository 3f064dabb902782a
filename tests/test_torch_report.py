"""The run serializers against `repro`'s: `RSBReport.to_dict`,
`BisectionRecord.to_dict`, `LevelRecord.to_dict`, `StageRecord.to_dict`
and `PartitionContext.stats` of a port run have `repro`'s keys at every
level and its values, times aside; a solve's eigenvalue may differ
within the solve's ``tol`` and its residual (a norm of a difference of
fp32 vectors) by 5%, as the fp32 device arithmetic differs.
"""

import numpy as np
import pytest
import torch

import repro.mesh as mesh_j
import repro_torch.mesh as mesh_t
from repro.configs.parrsb import make_pipeline as make_j
from repro_torch.configs.parrsb import make_pipeline as make_t

TIMES = {"seconds", "solve_seconds", "split_seconds"}
TOL = 1e-3      # the default preset's Lanczos tolerance


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=["default", "kway-sharded"])
def runs(request):
    kw = {"post": ("kway-sharded",)} if request.param == "kway-sharded" \
        else {}
    cj = make_j("default", **kw).run(
        mesh_j.pebble_mesh(8, 8, 8, n_pebbles=3, seed=0), 8)
    ct = make_t("default", device="cpu", **kw).run(
        mesh_t.pebble_mesh(8, 8, 8, n_pebbles=3, seed=0), 8)
    assert np.array_equal(cj.parts, ct.parts)
    return cj, ct


def _same(a, b, path="") -> None:
    """``a`` (repro's) and ``b`` (the port's) agree: keys, and values but
    times, eigenvalues and residuals as the module docstring says."""
    assert type(a) is type(b) or {type(a), type(b)} <= {list, tuple}, path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif path.rsplit(".", 1)[-1] in TIMES:
        pass
    elif path.endswith(".eigenvalue"):
        assert abs(b - a) <= TOL * abs(a), path
    elif path.endswith(".residual"):
        assert b == pytest.approx(a, rel=0.05), path
    else:
        assert a == b, path


def test_report_to_dict_matches_repro(runs):
    cj, ct = runs
    _same(cj.report.to_dict(), ct.report.to_dict(), "report")


def test_stats_match_repro(runs):
    cj, ct = runs
    _same(cj.stats(), ct.stats(), "stats")
    assert ct.stats()["seconds"] == pytest.approx(ct.seconds)
