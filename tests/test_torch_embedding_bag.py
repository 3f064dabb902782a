"""K5's plain version and dispatch in repro_torch vs repro's embedding bag.

On the CPU `ops.embedding_bag` runs the plain PyTorch version
(`ref.embedding_bag_ref`, what the CUDA kernel computes); the JAX side runs
`repro`'s oracle `embedding_bag_ref` (compared on every row) and the
Pallas kernel itself in interpret mode (``ops.embedding_bag(...,
prefer="pallas")``, compared on the rows of non-empty bags only: the
Pallas kernel never writes an empty bag's row).  Shapes are
tests/test_kernels.py's, inputs come from NumPy.

Tolerances are per element, relative to the size of the bag's terms
``Σ_i |w_i · table[idx_i]|`` (the sum can cancel; its terms cannot):
fp32 1e-5 (fp32 products and sums, only the order of the additions may
differ), bf16 2e-2 (`repro` rounds every product and partial sum to bf16,
the port sums in fp32 and rounds once; one bf16 ulp is 2^-8 relative).  A
bag of one in fp32 is bit-equal to ``jnp.take(table, idx) * w``.  The
CUDA kernel is held against the plain version on the card
(tests/test_torch_cuda.py, and chip_smoke.py at SASRec's shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as ops_j
from repro.kernels.embedding_bag.ref import embedding_bag_ref as ref_j
from repro.models.recsys import embedding_bag as model_bag_j
from repro_torch.kernels.embedding_bag import cuda, ops, ref
from repro_torch.models.recsys import embedding_bag as model_bag

SWEEP = [(100, 16, 64, 10), (500, 50, 300, 32), (64, 128, 128, 8)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker keeps the parallel workers from
    oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(V, d, nnz, B, seed, *, sorted_=True, weighted=False):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(0, V, nnz).astype(np.int32)
    seg = rng.integers(0, B, nnz).astype(np.int32)
    if sorted_:
        seg = np.sort(seg)
    w = rng.normal(size=nnz).astype(np.float32) if weighted else None
    return table, idx, seg, w


def _torch(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _term_size(table, idx, seg, w, B):
    """Σ_i |w_i · table[idx_i]| per bag and column, in float64."""
    rows = np.abs(table[idx].astype(np.float64))
    if w is not None:
        rows = rows * np.abs(w.astype(np.float64))[:, None]
    out = np.zeros((B, table.shape[1]))
    np.add.at(out, seg, rows)
    return out


def _assert_close(got, want, size, name, rows=slice(None)):
    diff = np.abs(_np(got)[rows] - _np(want)[rows])
    bound = TOL[name] * np.maximum(size[rows], 1e-30)
    assert (diff <= bound).all(), float((diff / bound).max())


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", SWEEP, ids=str)
def test_ref_matches_repro_on_all_rows(shape, name):
    tdt, jdt = DTYPES[name]
    table, idx, seg, _ = _case(*shape, seed=sum(shape))
    B = shape[3]
    # the table rounded to the working type first, so both sides see it
    table = _np(_torch(table, tdt))
    got = ref.embedding_bag_ref(_torch(table, tdt), _torch(idx), _torch(seg), B)
    want = ref_j(jnp.asarray(table, jdt), jnp.asarray(idx), jnp.asarray(seg), B)
    assert got.dtype == tdt and got.shape == (B, shape[1])
    _assert_close(got, want, _term_size(table, idx, seg, None, B), name)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", SWEEP, ids=str)
def test_ops_matches_pallas_interpret_on_visited_rows(shape, name):
    tdt, jdt = DTYPES[name]
    table, idx, seg, _ = _case(*shape, seed=sum(shape) + 1)
    B = shape[3]
    table = _np(_torch(table, tdt))
    before = cuda.LAUNCHES
    got = ops.embedding_bag(_torch(table, tdt), _torch(idx), _torch(seg), B)
    assert cuda.LAUNCHES == before      # a CPU tensor never reaches K5
    want = ops_j.embedding_bag(jnp.asarray(table, jdt), jnp.asarray(idx),
                               jnp.asarray(seg), B, prefer="pallas")
    visited = np.zeros(B, bool)
    visited[seg] = True
    _assert_close(got, want, _term_size(table, idx, seg, None, B), name,
                  rows=visited)


@pytest.mark.parametrize("name", list(DTYPES))
def test_weighted_and_unsorted(name):
    """tests/test_kernels.py's weighted, unsorted case: ``assume_sorted=
    False`` sorts the segments (stably) before the bag."""
    tdt, jdt = DTYPES[name]
    V, d, nnz, B = 80, 24, 100, 12
    table, idx, seg, w = _case(V, d, nnz, B, seed=7, sorted_=False,
                               weighted=True)
    table, w = _np(_torch(table, tdt)), _np(_torch(w, tdt))
    got = ops.embedding_bag(_torch(table, tdt), _torch(idx), _torch(seg), B,
                            weights=_torch(w, tdt), assume_sorted=False)
    size = _term_size(table, idx, seg, w, B)
    want = ref_j(jnp.asarray(table, jdt), jnp.asarray(idx), jnp.asarray(seg),
                 B, weights=jnp.asarray(w, jdt))
    _assert_close(got, want, size, name)
    want_p = ops_j.embedding_bag(jnp.asarray(table, jdt), jnp.asarray(idx),
                                 jnp.asarray(seg), B,
                                 weights=jnp.asarray(w, jdt),
                                 assume_sorted=False, prefer="pallas")
    visited = np.zeros(B, bool)
    visited[seg] = True
    _assert_close(got, want_p, size, name, rows=visited)


@pytest.mark.parametrize("prefer", ["auto", "ref"])
def test_empty_bags_are_zero_rows(prefer):
    V, d, B = 40, 20, 9
    rng = np.random.default_rng(3)
    table = rng.normal(size=(V, d)).astype(np.float32)
    seg = np.repeat(np.array([0, 2, 3, 7], np.int32), [3, 1, 4, 2])
    idx = rng.integers(0, V, seg.size).astype(np.int32)
    got = ops.embedding_bag(_torch(table), _torch(idx), _torch(seg), B,
                            prefer=prefer)
    empty = np.setdiff1d(np.arange(B), seg)
    assert torch.equal(got[empty], torch.zeros((empty.size, d)))
    want = ref_j(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg), B)
    _assert_close(got, want, _term_size(table, idx, seg, None, B), "float32")
    # no entries at all: every bag is empty
    none = ops.embedding_bag(_torch(table), _torch(idx[:0]), _torch(seg[:0]),
                             B, prefer=prefer)
    assert torch.equal(none, torch.zeros((B, d)))


@pytest.mark.parametrize("V,n", [(1000, 64), (1024, 1000)])
def test_bag_of_one_is_bit_equal_to_take_times_weight(V, n):
    """SASRec's sequence lookup: bags of one row, weight √50 in fp32."""
    d = 50
    rng = np.random.default_rng(V + n)
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(0, V, n).astype(np.int32)
    w = np.full(n, np.sqrt(d), np.float32)
    got = ops.embedding_bag(_torch(table), _torch(idx),
                            torch.arange(n, dtype=torch.int32), n,
                            weights=_torch(w))
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0)
                      * np.sqrt(d))
    np.testing.assert_array_equal(got.numpy(), want)


def test_int64_indices_and_segments():
    """torch indices are int64; ops converts them for the kernel."""
    table, idx, seg, w = _case(100, 16, 64, 10, seed=5, weighted=True)
    got = ops.embedding_bag(_torch(table), _torch(idx).long(),
                            _torch(seg).long(), 10, weights=_torch(w))
    want = ops.embedding_bag(_torch(table), _torch(idx), _torch(seg), 10,
                             weights=_torch(w))
    assert torch.equal(got, want)


def test_prefer_contract():
    table, idx, seg, _ = _case(10, 4, 6, 3, seed=0)
    args = (_torch(table), _torch(idx), _torch(seg), 3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.embedding_bag(*args, prefer="cuda")
    with pytest.raises(ValueError, match="unknown prefer"):
        ops.embedding_bag(*args, prefer="pallas")
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda.embedding_bag_cuda(args[0], args[1], args[2],
                                torch.ones(6), 3)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_model_embedding_bag_matches_repro(mode, weighted):
    """`models.recsys.embedding.embedding_bag` on unsorted segments with an
    empty bag (5): zeros for sum and mean, -inf for max, as repro's
    segment reductions give."""
    V, d, B = 50, 8, 6
    rng = np.random.default_rng(11)
    table = rng.normal(size=(V, d)).astype(np.float32)
    seg = rng.permutation(np.array([0, 0, 1, 1, 1, 2, 3, 3, 4, 4, 4, 4],
                                   np.int32))
    idx = rng.integers(0, V, seg.size).astype(np.int32)
    w = rng.normal(size=seg.size).astype(np.float32) if weighted else None
    got = model_bag(_torch(table), _torch(idx), _torch(seg), B, mode=mode,
                    weights=None if w is None else _torch(w))
    want = model_bag_j(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg),
                       B, mode=mode,
                       weights=None if w is None else jnp.asarray(w))
    assert got.shape == (B, d)
    if mode == "max":
        np.testing.assert_array_equal(got[5].numpy(), np.full(d, -np.inf))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=0)
    else:
        assert torch.equal(got[5], torch.zeros(d))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_model_embedding_bag_rejects_unknown_mode():
    with pytest.raises(ValueError):
        model_bag(torch.zeros((3, 2)), torch.zeros(1, dtype=torch.int32),
                  torch.zeros(1, dtype=torch.int32), 1, mode="min")
