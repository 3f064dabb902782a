"""K3/K4's plain versions in repro_torch vs repro's connection table.

On the CPU the port's `ops.connection_table[_batched]` run the plain
PyTorch slot loop; the JAX side runs the Pallas kernels themselves in
interpret mode (``prefer="pallas"``) and `repro`'s one-hot oracle
(``prefer="ref"``), on the shapes of tests/test_kernels.py.  Weights are
integers, so every fp32 sum is exact and the tables must be equal bit for
bit.  The CUDA kernels are held against the plain version on the card
(tests/test_torch_cuda.py, and chip_smoke.py at the sweep's shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_sum import ops as ops_j
from repro_torch.kernels.segment_sum import cuda, ops, ref

SHAPES = [(37, 5, 120, 13), (8, 1, 9, 1), (256, 27, 300, 64),
          (130, 3, 200, 129), (5, 4, 16, 2)]
BATCHED = [(3, 40, 6, 90, 9), (1, 64, 2, 30, 4), (5, 17, 3, 50, 33)]


def _inputs(shape, m, nparts, seed):
    rng = np.random.default_rng(seed)
    lead = shape[:-2]
    return (rng.integers(0, nparts, lead + (m,)).astype(np.int32),
            rng.integers(0, m, shape).astype(np.int32),
            rng.integers(1, 5, shape).astype(np.float32))


@pytest.mark.parametrize("B,w,m,nparts", SHAPES)
def test_connection_table_matches_repro(B, w, m, nparts):
    labels, cols, wts = _inputs((B, w), m, nparts, B + w)
    got = ops.connection_table(torch.from_numpy(labels), torch.from_numpy(cols),
                               torch.from_numpy(wts), nparts).numpy()
    for prefer in ("pallas", "ref", "auto"):
        want = np.asarray(ops_j.connection_table(
            jnp.asarray(labels), jnp.asarray(cols), jnp.asarray(wts), nparts,
            prefer=prefer))
        np.testing.assert_array_equal(got, want, err_msg=prefer)
    onehot = ref.connection_table_onehot(torch.from_numpy(labels),
                                         torch.from_numpy(cols),
                                         torch.from_numpy(wts), nparts)
    np.testing.assert_array_equal(got, onehot.numpy())


@pytest.mark.parametrize("G,B,w,m,nparts", BATCHED)
def test_connection_table_batched_matches_repro(G, B, w, m, nparts):
    labels, cols, wts = _inputs((G, B, w), m, nparts, G * B)
    tl, tc, tw = map(torch.from_numpy, (labels, cols, wts))
    got = ops.connection_table_batched(tl, tc, tw, nparts).numpy()
    for prefer in ("pallas", "ref"):
        want = np.asarray(ops_j.connection_table_batched(
            jnp.asarray(labels), jnp.asarray(cols), jnp.asarray(wts), nparts,
            prefer=prefer))
        np.testing.assert_array_equal(got, want, err_msg=prefer)
    for g in range(G):     # the batched table is G single ones
        np.testing.assert_array_equal(
            got[g], ops.connection_table(tl[g], tc[g], tw[g], nparts).numpy())


def test_slot_order_matches_repro_on_float_weights():
    """The slot loop adds in `repro`'s ``_xla_loop`` order: equal bit for
    bit on random fp32 weights too, where another summation order would
    differ in the last bits."""
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 7, 500).astype(np.int32)
    cols = rng.integers(0, 500, (300, 27)).astype(np.int32)
    wts = rng.normal(size=(300, 27)).astype(np.float32)
    got = ops.connection_table(torch.from_numpy(labels), torch.from_numpy(cols),
                               torch.from_numpy(wts), 7).numpy()
    want = np.asarray(ops_j.connection_table(
        jnp.asarray(labels), jnp.asarray(cols), jnp.asarray(wts), 7,
        prefer="auto"))
    np.testing.assert_array_equal(got, want)


def test_empty_boundary():
    labels = torch.zeros(7, dtype=torch.int32)
    out = ops.connection_table(labels, torch.zeros((0, 4), dtype=torch.int32),
                               torch.zeros((0, 4)), 7)
    assert out.shape == (0, 7) and out.dtype == torch.float32
    out = ops.connection_table_batched(
        labels.expand(2, 7), torch.zeros((2, 5, 0), dtype=torch.int32),
        torch.zeros((2, 5, 0)), 7)
    assert out.shape == (2, 5, 7) and not out.any()


def test_padding_is_inert():
    """Weight-0 padding entries contribute nothing regardless of col."""
    labels = torch.tensor([0, 1, 2, 1], dtype=torch.int32)
    cols = torch.tensor([[1, 3, 0], [2, 0, 0]], dtype=torch.int32)
    wts = torch.tensor([[2.0, 5.0, 0.0], [3.0, 0.0, 0.0]])
    for prefer in ("auto", "ref"):
        out = ops.connection_table(labels, cols, wts, 3, prefer=prefer)
        np.testing.assert_array_equal(out.numpy(), [[0.0, 7.0, 0.0],
                                                    [0.0, 0.0, 3.0]])


def test_dispatch_contract():
    labels, cols, wts = map(torch.from_numpy, _inputs((4, 3), 10, 3, 0))
    before = (cuda.LAUNCHES, cuda.BATCHED_LAUNCHES)
    with pytest.raises(ValueError, match="no CPU mode"):
        ops.connection_table(labels, cols, wts, 3, prefer="kernel")
    with pytest.raises(ValueError, match="no CPU mode"):
        ops.connection_table_batched(labels[None], cols[None], wts[None], 3,
                                     prefer="kernel")
    with pytest.raises(ValueError, match="unknown prefer"):
        ops.connection_table(labels, cols, wts, 3, prefer="pallas")
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda.connection_table_cuda(labels, cols, wts, 3)
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda.connection_table_batched_cuda(labels[None], cols[None],
                                           wts[None], 3)
    assert (cuda.LAUNCHES, cuda.BATCHED_LAUNCHES) == before
