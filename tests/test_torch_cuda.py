"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
the kernels have no CPU mode.  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-5 (fp32 accumulation in the kernel and the plain
version; only the summation order differs), bf16 2e-2 (one bf16 ulp of the
rounded output is ~4e-3 relative).  The inverse solve through K2 is held
to the same solve on the CPU: eigenvalue within ``rel=1e-3`` and
|cos| ≥ 0.999 (the solves stop at ``tol=1e-4``).  K3 and K4 add each
part's weights in the plain version's slot order, so they are held to it
bit for bit, and a sharded refinement on the card (K4 every sweep) to the
same run on the CPU label for label (integer weights: exact sums).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ell_spmv import cuda, ops, ref

TOLS = {torch.float32: dict(atol=1e-5, rtol=1e-5),
        torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _slabs(shape, seed, dtype, device):
    """Random transposed-ELL slabs ``shape`` = (..., w, n) and x (..., n)."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    cols = torch.from_numpy(rng.integers(0, n, shape).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=shape[:-2] + (n,)).astype(np.float32))
    return cols.to(device), vals.to(device, dtype), x.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(1000, 27), (4096, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_ref_on_card(card, n, w, dtype):
    """K1."""
    args = _slabs((w, n), 7, dtype, card)
    before = cuda.LAUNCHES
    got = ops.ell_spmv(*args, prefer="kernel")
    torch.cuda.synchronize()
    assert cuda.LAUNCHES == before + 1
    want = ref.ell_spmv_ref(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,w", [(3, 1000, 5), (4, 128, 27), (32, 8192, 32),
                                   (1, 262144, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_kernel_matches_ref_on_card(card, B, n, w, dtype):
    """K2, up to the full run's level-0 and level-5 shapes."""
    args = _slabs((B, w, n), 8, dtype, card)
    before = cuda.BATCHED_LAUNCHES
    got = ops.ell_spmv_batched(*args, prefer="kernel")
    torch.cuda.synchronize()
    assert cuda.BATCHED_LAUNCHES == before + 1
    want = ref.ell_spmv_batched_ref(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["jacobi", "amg"])
def test_inverse_solve_on_card_matches_cpu(card, precond):
    from repro_torch.core.fiedler import fiedler_from_graph_batched
    from repro_torch.mesh import grid_graph_2d

    graphs = [grid_graph_2d(16, 25), grid_graph_2d(24, 14)]
    kw = dict(method="inverse", precond=precond, tol=1e-4)
    before = cuda.BATCHED_LAUNCHES
    on_card = fiedler_from_graph_batched(graphs, device=card, **kw)
    assert cuda.BATCHED_LAUNCHES > before
    on_cpu = fiedler_from_graph_batched(graphs, device="cpu", **kw)
    for a, b in zip(on_cpu, on_card):
        assert b.eigenvalue == pytest.approx(a.eigenvalue, rel=1e-3)
        cos = abs(a.vector @ b.vector) / (np.linalg.norm(a.vector)
                                          * np.linalg.norm(b.vector))
        assert cos >= 0.999


def _tables(lead, B, w, m, nparts, seed, device, integer=True):
    """Random connection-table inputs: labels lead+(m,), cols/wts
    lead+(B, w)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, nparts, lead + (m,)).astype(np.int32)
    cols = rng.integers(0, m, lead + (B, w)).astype(np.int32)
    wts = (rng.integers(1, 5, lead + (B, w)) if integer
           else rng.normal(size=lead + (B, w))).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (labels, cols, wts))


@pytest.mark.cuda
@pytest.mark.parametrize("B,w,m,nparts", [(37, 5, 120, 13), (8, 1, 9, 1),
                                          (130, 3, 200, 129), (16384, 27, 32768, 128),
                                          (1320, 26, 88320, 64), (50, 40, 300, 300)])
@pytest.mark.parametrize("integer", [True, False])
def test_connection_table_kernel_on_card(card, B, w, m, nparts, integer):
    """K3, up to the benchmark's and the full sweep's root shapes; w > 32
    and nparts > 256 walk their chunks."""
    from repro_torch.kernels.segment_sum import cuda as ss_cuda
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.kernels.segment_sum import ref as ss_ref

    args = _tables((), B, w, m, nparts, 9, card, integer)
    before = ss_cuda.LAUNCHES
    got = ss_ops.connection_table(*args, nparts, prefer="kernel")
    torch.cuda.synchronize()
    assert ss_cuda.LAUNCHES == before + 1
    want = ss_ref.connection_table_ref(*args, nparts)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,w,m,nparts", [(3, 40, 6, 90, 9), (5, 17, 3, 50, 33),
                                            (64, 1320, 26, 88320, 64)])
def test_connection_table_batched_kernel_on_card(card, G, B, w, m, nparts):
    """K4, up to the full box's sweep shape (64 shards)."""
    from repro_torch.kernels.segment_sum import cuda as ss_cuda
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.kernels.segment_sum import ref as ss_ref

    for integer in (True, False):
        args = _tables((G,), B, w, m, nparts, 10, card, integer)
        before = ss_cuda.BATCHED_LAUNCHES
        got = ss_ops.connection_table_batched(*args, nparts, prefer="kernel")
        torch.cuda.synchronize()
        assert ss_cuda.BATCHED_LAUNCHES == before + 1
        assert torch.equal(got, ss_ref.connection_table_batched_ref(*args,
                                                                    nparts))


@pytest.mark.cuda
def test_sharded_refinement_on_card_matches_cpu(card):
    from repro_torch.core.rcb import rcb_parts
    from repro_torch.core.refine import balance_corridor
    from repro_torch.dist.refine_sharded import (build_frontier_plan,
                                                 refine_sharded_host,
                                                 run_sharded_sweeps)
    from repro_torch.kernels.segment_sum import cuda as ss_cuda
    from repro_torch.mesh import box_mesh, dual_graph

    mesh = box_mesh(12, 10, 8)
    g = dual_graph(mesh)
    rng = np.random.default_rng(3)
    parts = rcb_parts(mesh.coords, 16, mesh.weights)
    sel = rng.random(g.n) < 0.12
    parts[sel] = rng.integers(0, 16, sel.sum())
    corr = balance_corridor(parts, 16, mesh.weights, 0.05)
    fp = build_frontier_plan(g, parts, 16, weights=mesh.weights)
    before = ss_cuda.BATCHED_LAUNCHES
    out, rec, info = run_sharded_sweeps(fp, parts, 16, sweeps=10,
                                        corridor=corr, device=card)
    assert ss_cuda.BATCHED_LAUNCHES - before == info["gathers"] == len(rec) > 0
    for other in (run_sharded_sweeps(fp, parts, 16, sweeps=10, corridor=corr,
                                     device="cpu"),
                  refine_sharded_host(fp, parts, 16, sweeps=10, corridor=corr)):
        assert np.array_equal(out, other[0])
        assert [r.moves for r in rec] == [r.moves for r in other[1]]
        assert info["cut"] == other[2]["cut"]
    assert info["moves"] > 0
