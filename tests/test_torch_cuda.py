"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
the kernels have no CPU mode.  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-5 (fp32 accumulation in the kernel and the plain
version; only the summation order differs), bf16 2e-2 (one bf16 ulp of the
rounded output is ~4e-3 relative).  The inverse solve through K2 is held
to the same solve on the CPU: eigenvalue within ``rel=1e-3`` and
|cos| ≥ 0.999 (the solves stop at ``tol=1e-4``).
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
