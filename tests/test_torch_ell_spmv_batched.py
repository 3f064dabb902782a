"""K2 (the batched ELL SpMV) and the 3-D `EllLaplacian` in repro_torch vs repro.

On the CPU the port's `ops.ell_spmv_batched` runs its plain PyTorch version;
the JAX side runs repro's plain version and its Pallas kernel in interpret
mode (``prefer="pallas"``), on the shapes of tests/test_kernels.py.

Tolerances: fp32 1e-5 (both sum at most 27 unit-variance fp32 products per
row, in another order), bf16 2e-2 (one bf16 ulp of the rounded output is
~4e-3 relative).  The batched operator's host arrays are compared bit for
bit (the same NumPy fill), its apply to 2e-5 (sums of up to 8 products).
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, and chip_smoke.py at the main path's shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.laplacian as lap_j
import repro.kernels.ell_spmv.ops as ops_j
import repro.kernels.ell_spmv.ref as ref_j
import repro.mesh as mesh_j
import repro_torch.core.laplacian as lap_t
import repro_torch.mesh as mesh_t
from repro_torch.kernels.ell_spmv import cuda, ops, ref

SHAPES = [(2, 256, 8), (3, 1000, 5), (4, 128, 27), (1, 512, 6)]
DTYPES = {"float32": (jnp.float32, torch.float32, dict(atol=1e-5, rtol=1e-5)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2))}


def _inputs(B, n, w, seed):
    """Row-major (B, n, w) operands, as repro's kernels take them."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, (B, n, w)).astype(np.int32),
            rng.normal(size=(B, n, w)).astype(np.float32),
            rng.normal(size=(B, n)).astype(np.float32))


def _port_args(cols, vals, x, tdtype, device="cpu"):
    """The port's transposed (B, w, n) layout."""
    return (torch.from_numpy(np.ascontiguousarray(cols.swapaxes(1, 2))).to(device),
            torch.from_numpy(np.ascontiguousarray(vals.swapaxes(1, 2))).to(
                device, tdtype),
            torch.from_numpy(x).to(device, tdtype))


@pytest.mark.parametrize("B,n,w", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batched_matches_repro(B, n, w, dtype):
    jdtype, tdtype, tol = DTYPES[dtype]
    cols, vals, x = _inputs(B, n, w, seed=B * 1000 + n + w)
    cj, vj, xj = (jnp.asarray(cols), jnp.asarray(vals, jdtype),
                  jnp.asarray(x, jdtype))
    want_ref = np.asarray(ref_j.ell_spmv_batched_ref(
        cj.swapaxes(-1, -2), vj.swapaxes(-1, -2), xj), np.float32)
    want_pallas = np.asarray(ops_j.ell_spmv_batched(cj, vj, xj, prefer="pallas"),
                             np.float32)
    args = _port_args(cols, vals, x, tdtype)
    for got in (ops.ell_spmv_batched(*args),
                ops.ell_spmv_batched(*args, prefer="ref"),
                ref.ell_spmv_batched_ref(*args)):
        assert got.dtype == tdtype and got.shape == (B, n)
        for want in (want_ref, want_pallas):
            np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_batched_dispatch_contract_on_cpu():
    """``auto`` on CPU tensors is the plain version and counts no launch;
    ``kernel`` raises; the wrapper refuses CPU tensors before any build."""
    args = _port_args(*_inputs(3, 64, 4, seed=1), torch.float32)
    before = cuda.BATCHED_LAUNCHES, cuda.LAUNCHES
    assert torch.equal(ops.ell_spmv_batched(*args),
                       ref.ell_spmv_batched_ref(*args))
    assert (cuda.BATCHED_LAUNCHES, cuda.LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.ell_spmv_batched(*args, prefer="kernel")
    with pytest.raises(ValueError, match="unknown prefer"):
        ops.ell_spmv_batched(*args, prefer="pallas")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda.ell_spmv_batched_cuda(*args)
    assert (cuda.BATCHED_LAUNCHES, cuda.LAUNCHES) == before


def _engine_graphs(m):
    return [m.grid_graph_2d(16, 16), m.grid_graph_2d(10, 20)]


@pytest.mark.parametrize("n_pad,width_pad,b_pad", [(256, 8, 2), (512, 16, 4)])
def test_batched_laplacian_host_arrays_bit_identical(n_pad, width_pad, b_pad):
    """`ell_laplacian_batched` builds (B, w, n) int32/float32 straight on the
    host: the same bits as repro's (B, n, w) arrays after its transpose,
    batch-padding problems included."""
    op_j = lap_j.ell_laplacian_batched(_engine_graphs(mesh_j), n_pad, width_pad,
                                       b_pad)
    Ct, Vt, D = lap_t.batched_ell_arrays(_engine_graphs(mesh_t), n_pad,
                                         width_pad, b_pad)
    assert Ct.dtype == np.int32 and Vt.dtype == np.float32
    assert Ct.flags.c_contiguous and Vt.flags.c_contiguous
    assert np.array_equal(Ct, np.asarray(op_j.cols).swapaxes(1, 2))
    assert np.array_equal(Vt, np.asarray(op_j.vals).swapaxes(1, 2))
    assert np.array_equal(D.astype(np.float32), np.asarray(op_j.diag))
    op_t = lap_t.ell_laplacian_batched(_engine_graphs(mesh_t), n_pad, width_pad,
                                       b_pad, device="cpu")
    assert op_t.cols_t.shape == (b_pad, width_pad, n_pad)
    assert op_t.cols_t.is_contiguous() and op_t.n == n_pad


def test_batched_laplacian_apply_matches_jax():
    """The operators of tests/test_kernels.py:61, through the kernel route
    (``use_kernel=True``: the plain version on CPU tensors) and the plain
    route, against repro's inline apply and its Pallas-routed apply."""
    import dataclasses

    op_j = lap_j.ell_laplacian_batched(_engine_graphs(mesh_j), 256, 8, 2)
    x = np.random.default_rng(3).normal(size=(2, 256)).astype(np.float32)
    want = np.asarray(op_j.apply(jnp.asarray(x)))
    want_k = np.asarray(dataclasses.replace(op_j, use_kernel=True).apply(
        jnp.asarray(x)))
    np.testing.assert_allclose(want_k, want, atol=2e-5)
    xt = torch.from_numpy(x)
    for use_kernel in (True, False):
        op_t = lap_t.ell_laplacian_batched(_engine_graphs(mesh_t), 256, 8, 2,
                                           device="cpu", use_kernel=use_kernel)
        np.testing.assert_allclose(op_t.apply(xt).numpy(), want, atol=2e-5)
        np.testing.assert_allclose(op_t(xt).numpy(), want_k, atol=2e-5)

