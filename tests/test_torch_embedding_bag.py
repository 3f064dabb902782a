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

import re

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


# --- csrc/embedding_bag.cu's tiles of entries, emulated in NumPy ---------
#
# The CPU test runs have no CUDA compiler, so every index map of the kernel
# (each warp's tile of entries, its heads and the skip of a bag that began
# in an earlier tile, the walk of an owned bag past its tile in windows of
# entries, the work items (entry, chunk) of a tile of bags of one, VEC and
# alignment, the zero rows of empty bags) is run here lane by lane, with
# the kernel's own constants read from its source.  Products and sums are
# float32 NumPy scalars, each rounded once as __fmul_rn / __fadd_rn round
# it.  Every VEC-wide load and store asserts its alignment, every read its
# bounds, and every element of out must be written once.

_CONSTS = {k: int(v) for k, v in re.findall(
    r"constexpr int (k\w+) = (\d+);", cuda.SOURCE.read_text())}
_TILE = _CONSTS["kTile"]                # entries a tile: a warp's lanes
_WARPS = _CONSTS["kThreads"] // 32      # tiles a block


def _grid(nnz):
    """``launch``'s blocks for nnz entries (one tile when nnz = 0)."""
    tiles = -(-nnz // _TILE) if nnz else 1
    return -(-tiles // _WARPS)


def _vec(d, base):
    """``launch_type``'s VEC: table and out at element offsets ``base``
    from a 16-byte boundary."""
    for v in (4, 2):
        if d % v == 0 and base[0] % v == 0 and base[1] % v == 0:
            return v
    return 1


def _ffs(m):
    """``__ffs(m) - 1``: the lowest set bit's place (m != 0)."""
    return (m & -m).bit_length() - 1


def _emulate(table, idx, seg, w, n_bags, base=(0, 0), mutate=None, es=4):
    """K5's out (n_bags, d) for float32 table (V, d), idx/seg int32, w
    float32, with table and out at element offsets ``base`` and elements
    of ``es`` bytes (4: fp32, 2: bf16, whose values the float32 arrays
    hold; es only names the type here).  ``mutate`` names one index map
    to break."""
    del es
    V, d = table.shape
    nnz = idx.size
    VEC = _vec(d, base)
    nch = d // VEC
    L, f32 = _TILE, np.float32
    tab = np.concatenate([np.zeros(base[0], f32), table.reshape(-1)])
    out = np.zeros(base[1] + n_bags * d, f32)
    writes = np.zeros(n_bags * d, np.int64)

    def load(p):                        # a Pack at table element p
        a = base[0] + p
        assert a % VEC == 0, "row load off its VEC alignment"
        assert 0 <= p and p + VEC <= V * d, "row load past the table"
        return tab[a:a + VEC]

    def store(p, x):                    # a Pack at out element p
        a = base[1] + p
        assert a % VEC == 0, "store off its VEC alignment"
        assert 0 <= p and p + VEC <= n_bags * d, "store past out"
        out[a:a + VEC] = x
        writes[p:p + VEC] += 1

    def store_row(bag, col, acc):
        if 0 <= bag < n_bags:
            store(bag * d + col, acc)

    def zero_rows(lo, hi):
        lo, hi = max(lo, 0), min(hi, n_bags)
        for lane in range(L):
            for q in range(lane, (hi - lo) * nch, L):
                store(lo * d + q * VEC, np.zeros(VEC, f32))

    def g_seg(p):
        assert 0 <= p < nnz, f"seg read at {p}"
        return int(seg[p])

    def entries(b):                     # load_entry, lane by lane
        s = np.zeros(L, np.int64)
        i = np.zeros(L, np.int64)
        wv = np.zeros(L, f32)
        k = min(max(nnz - b, 0), L)
        s[:k], i[:k], wv[:k] = seg[b:b + k], idx[b:b + k], w[b:b + k]
        return s, i, wv

    def walk_bag(t0, s, i, wv, h, bag):
        A = _CONSTS["kAhead"]
        for c0 in range(0, nch, L):
            acc = {c: np.zeros(VEC, f32) for c in range(c0, min(c0 + L, nch))}
            b, ws, wi, ww, p = t0, s, i, wv, h
            while True:
                stop = sum(1 << ln for ln in range(L) if ln >= p and (
                    b + ln >= nnz or ws[ln] != bag))
                q = _ffs(stop) + (mutate == "ext") if stop else L
                for p in range(p, q, A):
                    for u in range(A):
                        if p + u < min(q, L):
                            for c in acc:
                                x = load(int(wi[p + u]) * d + c * VEC)
                                acc[c] = (acc[c] + f32(ww[p + u]) * x
                                          ).astype(f32)
                if stop or b + L >= nnz:
                    break
                b += L
                ws, wi, ww = entries(b)
                p = 0
                if mutate == "carry":
                    acc = {c: np.zeros(VEC, f32) for c in acc}
            for c in acc:
                store_row(bag, c * VEC, acc[c])

    def walk_ones(n, s, i, wv):
        items, K = n * nch, _CONSTS["kOnes"]
        dj, dc = divmod(L + (mutate == "step"), nch)
        for lane in range(L):
            j, c = divmod(lane, nch)
            for _ in range(0, items, L * K):
                xs = []
                for _ in range(K):
                    if j < n:
                        xs.append((j, c, load(int(i[j]) * d + c * VEC)))
                    c, j = c + dc, j + dj
                    if c >= nch:
                        c, j = c - nch, j + 1
                for jj, cc, x in xs:
                    store_row(int(s[jj]), cc * VEC,
                              (f32(0) + f32(wv[jj]) * x).astype(f32))

    for blk in range(_grid(nnz)):
        for warp in range(_WARPS):
            t0 = (blk * _WARPS + warp) * L
            if t0 > nnz or (t0 == nnz and t0 > 0):
                continue
            n = min(L - (mutate == "tile_end"), nnz - t0)
            t1 = t0 + n
            # 1. the tile's entries, the seg before and after it
            s, i, wv = entries(t0)
            prev = np.concatenate([[g_seg(t0 - 1) if t0 > 0 else 0], s[:-1]])
            after = g_seg(t1) if t1 < nnz else 0
            # 2. heads (a ballot) and the heads that follow empty bags
            heads = gaps = 0
            for ln in range(n):
                first = t0 + ln == 0 or (mutate == "no_skip" and ln == 0)
                if first or s[ln] != prev[ln]:
                    heads |= 1 << ln
                    if (s[ln] > 0) if t0 + ln == 0 else \
                            (s[ln] > prev[ln] + 1):
                        gaps |= 1 << ln
            # 3. zero rows
            for p in range(L):
                if gaps >> p & 1:
                    lo = 0 if t0 + p == 0 else int(prev[p]) + 1
                    zero_rows(lo, int(s[p]) + (mutate == "gap"))
            last = int(s[n - 1]) if n > 0 else int(s[0])
            if t1 == nnz:
                zero_rows(last + 1 if n > 0 else 0, n_bags)
            # 4. the owned bags
            is_open = n > 0 and t1 < nnz and after == last \
                and mutate != "open"
            if heads == (1 << n) - 1 and not is_open:
                walk_ones(n, s, i, wv)
            else:
                for h in range(L):
                    if heads >> h & 1:
                        walk_bag(t0, s, i, wv, h, int(s[h]))
    assert (writes == 1).all(), "an element of out written other than once"
    return out[base[1]:].reshape(n_bags, d)


def _runs(lengths, seed, V, d):
    """Sorted bags of the given lengths (0 = empty bag): table, idx, seg,
    w (float32) and n_bags."""
    rng = np.random.default_rng(seed)
    seg = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    idx = rng.integers(0, V, seg.size).astype(np.int32)
    table = rng.normal(size=(V, d)).astype(np.float32)
    w = rng.normal(size=seg.size).astype(np.float32)
    return table, idx, seg, w, len(lengths)


# name -> (bag lengths, V, d, base)
EMULATED = {
    # tiles of bags of one, then one whose last bag runs on past the tile
    "bags_of_one": ([1] * (2 * _TILE + 31) + [3], 300, 50, (0, 0)),
    "pooled_crossing": (list(np.random.default_rng(1).integers(1, 65, 40)),
                        200, 12, (0, 0)),
    "longer_than_two_tiles": ([3, 2 * _TILE + 50, 1, 7], 100, 6, (2, 2)),
    "ends_at_tile_end": ([_TILE // 4] * 8 + [5], 90, 8, (0, 4)),
    "one_bag": ([3 * _TILE + 11], 50, 4, (1, 3)),
    "empty_lead_mid_trail": ([0, 0, 3, 1, 0, 0, 0, 4, _TILE, 0, 2, 0, 0],
                             70, 10, (0, 0)),
    "gap_at_tile_start": ([_TILE, 0, 0, 5, 1], 40, 2, (0, 0)),
    "nnz0": ([0] * 7, 20, 6, (0, 0)),
    "small_tiles": (list(np.random.default_rng(2).integers(0, 90, 25)), 120,
                    5, (3, 1)),
    "d1": ([1, 2, 0, 40, 1] * 30, 60, 1, (0, 1)),
    # 301 chunks a row: the walk's passes of 32 chunks
    "wide_rows": ([2, 0, 300, 1], 30, 301, (0, 0)),
    "vec4": ([1] * 100 + [7, 0, 9], 64, 16, (0, 0)),
    # rows of 129 chunks, bags of 1-64 entries over many windows
    "batches": (list(np.random.default_rng(3).integers(1, 65, 14)), 80, 129,
                (0, 0)),
}


def _emulated_case(case):
    lengths, V, d, base = EMULATED[case]
    return _runs(lengths, len(case), V, d), base


@pytest.mark.parametrize("case", list(EMULATED))
def test_tile_emulation_matches_plain_and_pallas(case):
    """The kernel's index maps give the plain version's rows bit for bit
    (fp32, nnz order), every row of out written once, and the Pallas
    kernel's rows (interpret mode) on the non-empty bags."""
    (table, idx, seg, w, B), base = _emulated_case(case)
    got = _emulate(table, idx, seg, w, B, base)
    want = ref.embedding_bag_ref(_torch(table), _torch(idx), _torch(seg), B,
                                 weights=_torch(w)).numpy()
    np.testing.assert_array_equal(got, want)
    if idx.size:
        pallas = ops_j.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                     jnp.asarray(seg), B,
                                     weights=jnp.asarray(w), prefer="pallas")
        visited = np.zeros(B, bool)
        visited[seg] = True
        _assert_close(got, pallas, _term_size(table, idx, seg, w, B),
                      "float32", rows=visited)
    lengths, V, d, _ = EMULATED[case]
    ends = np.cumsum(lengths)
    if case == "longer_than_two_tiles":
        assert lengths[1] > 2 * _TILE
    if case == "ends_at_tile_end":
        assert ends[3] == _TILE
    if case == "bags_of_one":          # a tile of heads whose last runs on
        assert ends[-2] % _TILE == _TILE - 1
    if case == "small_tiles":
        assert idx.size > 20 * _TILE
    if case in ("d1", "wide_rows", "vec4", "bags_of_one"):
        assert _vec(d, base) == {"d1": 1, "wide_rows": 1, "vec4": 4,
                                 "bags_of_one": 2}[case]


def test_tile_emulation_in_bf16():
    """bf16 tables and weights: the fp32 sum in nnz order, rounded to bf16
    once, is the plain version's bf16 row bit for bit."""
    (table, idx, seg, w, B), base = _emulated_case("pooled_crossing")
    t16, w16 = _torch(table, torch.bfloat16), _torch(w, torch.bfloat16)
    got = _emulate(t16.float().numpy(), idx, seg, w16.float().numpy(), B,
                   base, es=2)
    want = ref.embedding_bag_ref(t16, _torch(idx), _torch(seg), B,
                                 weights=w16)
    assert torch.equal(torch.from_numpy(got).to(torch.bfloat16), want)


def test_tiles_at_the_cards_shapes():
    """Blocks a launch at chip_smoke.py's K5 cases, a tile of 32 entries a
    warp, as the kernel's header states them."""
    assert _TILE == 32 and _WARPS == 4
    assert _grid(10**6) == 7813               # retrieval
    assert _grid(409_600) == 3200             # bulk (serve_bulk's chunk)
    assert _grid(2_127_448) == 16621          # pooled
    assert _grid(25_600) == 200               # lookup (serve_p99)
    assert _grid(50) == 1 and _grid(0) == 1   # one user's sequence; nnz = 0
    assert _vec(50, (0, 0)) == 2 and _vec(50, (1, 0)) == 1


@pytest.mark.parametrize("mutate", ["tile_end", "no_skip", "gap", "open",
                                    "ext", "step", "carry"])
def test_tile_emulation_catches_a_wrong_map(mutate):
    """One wrong index map breaks the rows (or trips an alignment, bounds
    or write-once check) on one of five inputs: bags crossing tile ends,
    with and without empty bags between them, one bag over four tiles,
    tiles of bags of one and one whose last bag runs on, and bags over
    many windows of wide rows.  The mutations: the tile's end one short, no
    skip of a bag begun in an earlier tile, a gap range one long, the
    running-on last bag ignored, a bag's end in a window one late, the
    work items' step, the sum not carried from window to window.  The
    emulation tells a right map from a wrong one."""
    broke = []
    for case in ("pooled_crossing", "empty_lead_mid_trail", "one_bag",
                 "bags_of_one", "batches"):
        (table, idx, seg, w, B), base = _emulated_case(case)
        want = _emulate(table, idx, seg, w, B, base)
        try:
            got = _emulate(table, idx, seg, w, B, base, mutate=mutate)
        except (AssertionError, IndexError):
            broke.append(True)
            continue
        broke.append(not np.array_equal(got, want))
    assert any(broke)
