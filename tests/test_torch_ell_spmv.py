"""K1 in repro_torch vs repro's Pallas kernel.

On the CPU the port's `ops.ell_spmv` runs its plain PyTorch version; the
JAX side runs the Pallas kernel itself in interpret mode
(``prefer="pallas"``), on the shapes of tests/test_kernels.py.  Both
accumulate in fp32 in a different order: fp32 agrees to 2e-5 (a few ulps
of sums of up to 27 unit-variance products), bf16 to 2e-2 (one bf16 ulp
of the rounded output is ~4e-3 relative).  The CUDA kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py, and
chip_smoke.py at the main path's shape).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ell_spmv.ops as ops_j
import repro.kernels.ell_spmv.ref as ref_j
from repro_torch.core.laplacian import EllLaplacian
from repro_torch.kernels.ell_spmv import cuda, ops, ref

SHAPES = [(128, 4), (256, 27), (1000, 8), (4096, 3)]
DTYPES = {"float32": (jnp.float32, torch.float32, dict(atol=2e-5, rtol=2e-5)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2))}


def _inputs(n, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, (n, w)).astype(np.int32),
            rng.normal(size=(n, w)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32))


def _port_args(cols, vals, x, tdtype, device="cpu"):
    return (torch.from_numpy(np.ascontiguousarray(cols.T)).to(device),
            torch.from_numpy(np.ascontiguousarray(vals.T)).to(device, tdtype),
            torch.from_numpy(x).to(device, tdtype))


@pytest.mark.parametrize("n,w", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ell_spmv_matches_pallas(n, w, dtype):
    jdtype, tdtype, tol = DTYPES[dtype]
    cols, vals, x = _inputs(n, w, seed=n * 31 + w)
    want = np.asarray(ops_j.ell_spmv(jnp.asarray(cols),
                                     jnp.asarray(vals, jdtype),
                                     jnp.asarray(x, jdtype), prefer="pallas"),
                      np.float32)
    args = _port_args(cols, vals, x, tdtype)
    for got in (ops.ell_spmv(*args), ops.ell_spmv(*args, prefer="ref"),
                ref.ell_spmv_ref(*args)):
        assert got.dtype == tdtype and got.shape == (n,)
        np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_lap_apply_matches_pallas():
    n, w = 512, 6
    cols, vals, x = _inputs(n, w, seed=5)
    vals = np.abs(vals)
    diag = vals.sum(1)
    want = ops_j.lap_apply(jnp.asarray(cols), jnp.asarray(vals),
                           jnp.asarray(diag), jnp.asarray(x), prefer="pallas")
    ct, vt, xt = _port_args(cols, vals, x, torch.float32)
    dt = torch.from_numpy(diag)
    for got in (ops.lap_apply(ct, vt, dt, xt), ref.lap_apply_ref(ct, vt, dt, xt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("B,n,w", [(2, 256, 8), (3, 1000, 5)])
def test_batched_ref_matches_repro_ref(B, n, w):
    """The batched plain version (K2's) against repro's oracle."""
    rng = np.random.default_rng(B * n + w)
    cols = rng.integers(0, n, (B, w, n)).astype(np.int32)
    vals = rng.normal(size=(B, w, n)).astype(np.float32)
    x = rng.normal(size=(B, n)).astype(np.float32)
    want = ref_j.ell_spmv_batched_ref(jnp.asarray(cols), jnp.asarray(vals),
                                      jnp.asarray(x))
    got = ref.ell_spmv_batched_ref(torch.from_numpy(cols), torch.from_numpy(vals),
                                   torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_dispatch_contract_on_cpu():
    """``prefer="kernel"`` raises on CPU tensors, the wrapper refuses them
    before any build, and nothing on the CPU counts as a launch."""
    cols, vals, x = _port_args(*_inputs(64, 3, seed=1), torch.float32)
    before = cuda.LAUNCHES
    ops.ell_spmv(cols, vals, x)
    ops.lap_apply(cols, vals, torch.ones(64), x)
    assert cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.ell_spmv(cols, vals, x, prefer="kernel")
    with pytest.raises(ValueError, match="unknown prefer"):
        ops.ell_spmv(cols, vals, x, prefer="pallas")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda.ell_spmv_cuda(cols, vals, x)
    assert cuda.LAUNCHES == before


def test_operator_dispatch_and_2d_only():
    """`EllLaplacian` routes through ops (use_kernel=True) or the plain
    version directly; both agree.  A 2-D operator takes K1's route only;
    the same slabs with a leading batch dim take K2's, with the same sums."""
    cols, vals, x = _inputs(300, 5, seed=2)
    ct, vt, xt = _port_args(cols, vals, x, torch.float32)
    diag = torch.from_numpy(np.abs(vals).sum(1))
    a = EllLaplacian(ct, vt, diag, 300, use_kernel=True).apply(xt)
    b = EllLaplacian(ct, vt, diag, 300, use_kernel=False).apply(xt)
    assert torch.equal(a, b)
    for use_kernel in (True, False):
        c = EllLaplacian(ct[None], vt[None], diag[None], 300,
                         use_kernel=use_kernel).apply(xt[None])
        assert c.shape == (1, 300) and torch.equal(c[0], a)

