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
# alignment, the zero rows of empty bags; a long bag's runs from its head,
# walked by its owner or, in the split launch, by the tiles and the windows'
# warps into the workspace's slots, the windows' 32-way search for a bag's
# head, their records and the combine's groups) is run here lane by lane,
# with the kernel's own constants read from its source.  Products and sums
# are float32 NumPy scalars, each rounded once as __fmul_rn / __fadd_rn
# round it.  Every VEC-wide load and store asserts its alignment, every
# read its bounds (a partial: that it was written first), and every
# element of out and every window's record must be written once.

_CONSTS = {k: int(v) for k, v in re.findall(
    r"constexpr int (k\w+) = (\d+);", cuda.SOURCE.read_text())}
_TILE = _CONSTS["kTile"]                # entries a tile: a warp's lanes
_WARPS = _CONSTS["kThreads"] // 32      # tiles a block
_RUN, _GROUP = _CONSTS["kRun"], _CONSTS["kGroup"]    # R, G


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


class _Walk:
    """``Walk``: the window of entries at ``base`` (lane l's seg, idx and
    weight in s[l], i[l], w[l]) and the next entry's lane ``p``."""

    def __init__(self, base, s, i, w, p):
        self.base, self.s, self.i, self.w, self.p = base, s, i, w, p


def _emulate(table, idx, seg, w, n_bags, base=(0, 0), mutate=None, es=4,
             split=False):
    """K5's out (n_bags, d) for float32 table (V, d), idx/seg int32, w
    float32, with table and out at element offsets ``base`` and elements
    of ``es`` bytes (4: fp32, 2: bf16, whose values the float32 arrays
    hold; es only names the type here); ``split``: the split launch (the
    tiles, the windows' runs into the workspace, then the combine), else
    the one launch.  ``mutate`` names one index map to break."""
    del es
    V, d = table.shape
    nnz = idx.size
    VEC = _vec(d, base)
    nch = d // VEC
    L, f32 = _TILE, np.float32
    R, G = _CONSTS["kRun"], _CONSTS["kGroup"]
    tab = np.concatenate([np.zeros(base[0], f32), table.reshape(-1)])
    out = np.zeros(base[1] + n_bags * d, f32)
    writes = np.zeros(n_bags * d, np.int64)
    nwin = -(-nnz // R) if split else 0
    part = np.zeros((2 * nwin, d), f32)
    filled = np.zeros((2 * nwin, d), bool)      # partials written so far
    rec = np.full(2 * nwin, -7, np.int64)       # the workspace's garbage
    rec_writes = np.zeros(2 * nwin, np.int64)

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

    def put(slot, col, acc):            # a partial's Pack
        assert 0 <= slot < 2 * nwin, f"partial slot {slot}"
        part[slot, col:col + VEC] = acc
        filled[slot, col:col + VEC] = True

    def get(slot, col):
        assert 0 <= slot < 2 * nwin and filled[slot, col:col + VEC].all(), \
            f"partial slot {slot} read before it was written"
        return part[slot, col:col + VEC]

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

    def zeros(cs):
        return {c: np.zeros(VEC, f32) for c in cs}

    def add_run(k, bag, cap, acc, ahead):
        """add_run: the bag's entries from the walk's place into acc (one
        VEC-wide sum a chunk of the pass), at most cap; how many."""
        added = 0
        while True:
            stop = [ln for ln in range(L) if ln >= k.p and (
                k.base + ln >= nnz or k.s[ln] != bag)]
            q = stop[0] + (mutate == "ext") if stop else L
            q = min(q, k.p + cap - added)
            more = q == L and k.base + L < nnz
            nxt = entries(k.base + L) if more else None
            for p in range(k.p, q, ahead):
                for u in range(ahead):
                    if p + u < min(q, L):
                        for c in acc:
                            x = load(int(k.i[p + u]) * d + c * VEC)
                            acc[c] = (acc[c] + f32(k.w[p + u]) * x
                                      ).astype(f32)
            added += q - k.p
            if not more:
                k.p = q
                return added
            k.base, (k.s, k.i, k.w), k.p = k.base + L, nxt, 0
            if mutate == "carry":
                for c in acc:
                    acc[c] = np.zeros(VEC, f32)
            if added == cap:
                return added

    def walk_long(k, bag, part_):
        """walk_long: the later runs of a bag whose run 0 filled R, each
        folded into its group as the next one starts."""
        grp, tot = zeros(part_), zeros(part_)
        r = 1
        while True:
            for c in part_:
                g = (grp[c] + part_[c]).astype(f32)
                if r % G == 0:
                    tot[c] = (tot[c] + g).astype(f32)
                    g = np.zeros(VEC, f32)
                grp[c], part_[c] = g, np.zeros(VEC, f32)
            if add_run(k, bag, R, part_, _CONSTS["kAhead"]) < R:
                break
            r += 1
        for c in part_:
            part_[c] = (tot[c] + (grp[c] + part_[c]).astype(f32)).astype(f32)

    def passes():
        for c0 in range(0, nch, L):
            yield range(c0, min(c0 + L, nch))

    def walk_bag(t0, s, i, wv, h, bag):
        """walk_bag: run 0 from the head; past R entries (the one launch
        only: the split launch walks no long bag here) walk_long."""
        for cs in passes():
            k, acc = _Walk(t0, s, i, wv, h), zeros(cs)
            if add_run(k, bag, R, acc, _CONSTS["kAhead"]) == R and not split:
                walk_long(k, bag, acc)
            for c in acc:
                store_row(bag, c * VEC, acc[c])

    def run_to_slot(start, bag, slot, cap=R):
        for cs in passes():
            k = _Walk(start.base, start.s, start.i, start.w, start.p)
            acc = zeros(cs)
            add_run(k, bag, cap - (mutate == "r_off"), acc,
                    _CONSTS["kAhead"])
            for c in acc:
                put(slot, c * VEC, acc[c])

    def bag_head(bag, s0):              # the 32-way search, step by step
        lo, hi = 0, s0
        while lo < hi:
            step = (hi - lo + 31) // 32
            ge = [q >= hi or g_seg(q) >= bag
                  for q in (lo + ln * step for ln in range(L))]
            if not any(ge):
                lo += 31 * step + 1
                continue
            f = ge.index(True)
            if f == 0:
                break
            hi = min(hi, lo + f * step)
            lo += (f - 1) * step + 1
        return lo

    def window_run(j):
        s0, head, runs = j * R, -1, 0
        if j > 0:
            bag = g_seg(s0)
            if g_seg(s0 - 1) == bag:
                h = bag_head(bag, s0)
                assert (seg[h:s0] == bag).all() and (h == 0 or
                                                     seg[h - 1] != bag)
                r = -(-(s0 - h) // R)
                s1 = h + r * R
                if mutate == "abs":     # runs at multiples of R
                    r, s1 = j - h // R, s0
                starts = s1 < nnz and g_seg(s1) == bag
                on = s1 + R < nnz and g_seg(s1 + R) == bag
                if starts:
                    run_to_slot(_Walk(s1, *entries(s1), 0), bag, 2 * j)
                    if not on:
                        head, runs = h, r + 1
        rec[j], rec[nwin + j] = head, runs
        rec_writes[[j, nwin + j]] += 1

    def combine(j):
        h = int(rec[j])
        if h < 0:
            return
        runs, bag, jh = int(rec[nwin + j]), g_seg(h), h // R
        runs -= mutate == "drop_last"

        def slot(r):
            return 2 * (jh + r) + (r == 0)

        groups = -(-runs // G)
        for cs in passes():
            sums = {}
            for g in range(groups):     # each warp's groups, in any order
                r0, r1 = g * G, min(g * G + G, runs)
                order = range(r1 - 1, r0 - 1, -1) if mutate == "reversed" \
                    else range(r0, r1)
                for c in cs:
                    acc = np.zeros(VEC, f32)
                    for r in order:
                        acc = (acc + get(slot(r), c * VEC)).astype(f32)
                    sums[g, c] = acc
            for (g, c), acc in sums.items():
                put(slot(g * G), c * VEC, acc)
            order = range(groups - 1, -1, -1) if mutate == "reversed" \
                else range(groups)
            for c in cs:                # warp 0, after the barrier
                acc = np.zeros(VEC, f32)
                for g in order:
                    acc = (acc + get(slot(g * G), c * VEC)).astype(f32)
                store_row(bag, c * VEC, acc)

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

    win_blocks = -(-nwin // _WARPS)     # the windows' blocks come first
    for blk in range(win_blocks + _grid(nnz)):
        for warp in range(_WARPS):
            if blk < win_blocks:
                j = blk * _WARPS + warp
                if j < nwin:
                    window_run(j)
                continue
            t0 = ((blk - win_blocks) * _WARPS + warp) * L
            if t0 > nnz or (t0 == nnz and t0 > 0):
                continue
            n = min(L - (mutate == "tile_end"), nnz - t0)
            t1 = t0 + n
            # 1. the tile's entries, the seg before and after it (and R on)
            s, i, wv = entries(t0)
            prev = np.concatenate([[g_seg(t0 - 1) if t0 > 0 else 0], s[:-1]])
            after = g_seg(t1) if t1 < nnz else 0
            reach = R - (mutate == "exact_long")
            # 2. heads (a ballot), the heads that follow empty bags, long
            heads = gaps = longs = 0
            for ln in range(n):
                first = t0 + ln == 0 or (mutate == "no_skip" and ln == 0)
                if first or s[ln] != prev[ln]:
                    heads |= 1 << ln
                    if (s[ln] > 0) if t0 + ln == 0 else \
                            (s[ln] > prev[ln] + 1):
                        gaps |= 1 << ln
                    if split and t0 + ln + reach < nnz and \
                            g_seg(t0 + ln + reach) == s[ln]:
                        longs |= 1 << ln
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
                    if not heads >> h & 1:
                        continue
                    if longs >> h & 1:
                        cap = R - (t0 + h) % R if mutate == "abs" else R
                        run_to_slot(_Walk(t0, s, i, wv, h), int(s[h]),
                                    2 * ((t0 + h) // R) + 1, cap)
                    else:
                        walk_bag(t0, s, i, wv, h, int(s[h]))
    for j in range(nwin):               # the second launch
        combine(j)
    assert (rec_writes == 1).all(), "a window's record written other than once"
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


def _runs_ref(table, idx, seg, w, B):
    """The plain version of the kernel's order (runs of R past R), fp32."""
    return ref.embedding_bag_runs_ref(_torch(table), _torch(idx),
                                      _torch(seg), B, weights=_torch(w),
                                      run=_RUN, group=_GROUP).numpy()


@pytest.mark.parametrize("case", list(EMULATED))
def test_tile_emulation_matches_plain_and_pallas(case):
    """The kernel's index maps give the plain version's rows bit for bit
    (fp32: nnz order on bags of at most R entries, runs past R), every row
    of out written once, and the Pallas kernel's rows (interpret mode) on
    the non-empty bags."""
    (table, idx, seg, w, B), base = _emulated_case(case)
    got = _emulate(table, idx, seg, w, B, base)
    np.testing.assert_array_equal(got, _runs_ref(table, idx, seg, w, B))
    lengths, V, d, _ = EMULATED[case]
    short = np.asarray(lengths) <= _RUN
    want = ref.embedding_bag_ref(_torch(table), _torch(idx), _torch(seg), B,
                                 weights=_torch(w)).numpy()
    np.testing.assert_array_equal(got[short], want[short])
    if idx.size:
        pallas = ops_j.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                     jnp.asarray(seg), B,
                                     weights=jnp.asarray(w), prefer="pallas")
        visited = np.zeros(B, bool)
        visited[seg] = True
        _assert_close(got, pallas, _term_size(table, idx, seg, w, B),
                      "float32", rows=visited)
    ends = np.cumsum(lengths)
    if case == "longer_than_two_tiles":
        assert lengths[1] > 2 * _TILE
    if case == "ends_at_tile_end":
        assert ends[3] == _TILE
    if case == "bags_of_one":          # a tile of heads whose last runs on
        assert ends[-2] % _TILE == _TILE - 1
    if case == "small_tiles":
        assert idx.size > 20 * _TILE
    if case == "wide_rows":            # one bag of two runs
        assert _RUN < lengths[2] <= 2 * _RUN
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


# Long bags (more than R entries): name -> (bag lengths, V, d, base).  A
# long bag is cut into runs of R from its head; the split launch sums the
# runs on the tiles and the windows' warps and adds them in the combine.
LONG = {
    # R - 1, R, R + 1 and 2R + 5 entries among short and empty bags
    "run_edges": ([0, 3, _RUN - 1, _RUN, 0, _RUN + 1, 1, 2 * _RUN + 5, 0],
                  40, 3, (0, 0)),
    # more than G runs (two groups), its head off a window's edge
    "two_groups": ([5, (_GROUP + 1) * _RUN + 7, 2], 30, 2, (0, 0)),
    # one bag holding ~96% of the entries, most at weight 0: a
    # vocab-parallel rank's row 0
    "vocab_row0": ([24 * _RUN] + [1, 0, 2] * 80, 50, 2, (0, 0)),
    # rows of 129 chunks (VEC 1, passes of 32 chunks) at odd offsets
    "wide_long": ([1, _RUN + 40, 0, 3], 20, 129, (1, 1)),
}


def _long_case(case):
    lengths, V, d, base = LONG[case]
    table, idx, seg, w, B = _runs(lengths, len(case) + 100, V, d)
    if case == "vocab_row0":           # foreign ids: weight 0
        w[(seg == 0) & (np.arange(seg.size) % 25 != 0)] = 0.0
    return (table, idx, seg, w, B), base


@pytest.mark.parametrize("split", [False, True], ids=["one_launch", "split"])
@pytest.mark.parametrize("case", list(LONG))
def test_run_emulation_matches_runs_ref(case, split):
    """Long bags, by their owner alone (one launch) and split across
    warps: the run-order plain version's rows bit for bit, every row and
    record written once, and `repro`'s oracle within 1e-5 of Σ|terms|."""
    (table, idx, seg, w, B), base = _long_case(case)
    got = _emulate(table, idx, seg, w, B, base, split=split)
    np.testing.assert_array_equal(got, _runs_ref(table, idx, seg, w, B))
    want = ref_j(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg), B,
                 weights=jnp.asarray(w))
    _assert_close(got, want, _term_size(table, idx, seg, w, B), "float32")
    lengths = np.asarray(LONG[case][0])
    assert lengths.max() > _RUN
    if case == "two_groups":
        assert -(-lengths[1] // _RUN) > _GROUP


@pytest.mark.parametrize("case", list(EMULATED))
def test_split_emulation_matches_one_launch(case):
    """The split launch on short bags: the one launch's bits (no bag is
    long, every window records none)."""
    (table, idx, seg, w, B), base = _emulated_case(case)
    np.testing.assert_array_equal(
        _emulate(table, idx, seg, w, B, base, split=True),
        _emulate(table, idx, seg, w, B, base))


def test_run_emulation_in_bf16():
    """bf16 tables and weights, split: the fp32 runs and groups rounded to
    bf16 once are the plain run-order version's bf16 rows bit for bit."""
    (table, idx, seg, w, B), base = _long_case("run_edges")
    t16, w16 = _torch(table, torch.bfloat16), _torch(w, torch.bfloat16)
    got = _emulate(t16.float().numpy(), idx, seg, w16.float().numpy(), B,
                   base, es=2, split=True)
    want = ref.embedding_bag_runs_ref(t16, _torch(idx), _torch(seg), B,
                                      weights=w16, run=_RUN, group=_GROUP)
    assert torch.equal(torch.from_numpy(got).to(torch.bfloat16), want)


@pytest.mark.parametrize("mutate", ["abs", "reversed", "r_off", "drop_last",
                                    "exact_long"])
def test_run_emulation_catches_a_wrong_map(mutate):
    """One wrong map of the split launch breaks the rows (or trips a
    bounds, read-before-write or write-once check) on one of the long
    cases: runs counted from multiples of R (not the bag's head), the
    combine's order reversed, runs of R - 1, the last partial dropped, a
    bag of exactly R entries sent down the long path."""
    broke = []
    for case in ("run_edges", "two_groups", "vocab_row0"):
        (table, idx, seg, w, B), base = _long_case(case)
        want = _runs_ref(table, idx, seg, w, B)
        try:
            got = _emulate(table, idx, seg, w, B, base, mutate=mutate,
                           split=True)
        except (AssertionError, IndexError):
            broke.append(True)
            continue
        broke.append(not np.array_equal(got, want))
    assert any(broke)


@pytest.mark.parametrize("name", list(DTYPES))
def test_runs_ref_is_nnz_order_on_short_bags(name):
    """Bags of at most R entries are one run of one group: the run-order
    plain version is the nnz-order one bit for bit (on the CPU, whose
    ``index_add_`` adds in nnz order), on any R."""
    tdt, _ = DTYPES[name]
    lengths = list(np.random.default_rng(4).integers(0, _RUN + 1, 60))
    table, idx, seg, w, B = _runs(lengths, 9, 70, 12)
    t, wt = _torch(table, tdt), _torch(w, tdt)
    want = ref.embedding_bag_ref(t, _torch(idx), _torch(seg), B, weights=wt)
    for run in (_RUN, max(lengths), 1 << 20):
        got = ref.embedding_bag_runs_ref(t, _torch(idx), _torch(seg), B,
                                         weights=wt, run=run, group=_GROUP)
        assert torch.equal(got, want), run


@pytest.mark.parametrize("name", list(DTYPES))
def test_runs_ref_matches_repro_on_a_transposed_zipf_bag(name):
    """The backward's shape at a small size: a Zipf(1.2) lookup's entries
    sorted by row (bags of up to ~10^4 entries), weight 1, the output's
    gradient as the table; `repro`'s oracle within the tolerance of Σ|terms|
    (fp32 1e-5, bf16 2e-2)."""
    tdt, jdt = DTYPES[name]
    rng = np.random.default_rng(12)
    n, rows, d = 40_000, 3000, 6
    ids = (rng.zipf(1.2, n) % rows).astype(np.int32)
    order = np.argsort(ids, kind="stable")
    seg, idx = ids[order], order.astype(np.int32)
    dout = _np(_torch(rng.normal(size=(n, d)).astype(np.float32), tdt))
    w = np.ones(n, np.float32)
    got = ref.embedding_bag_runs_ref(_torch(dout, tdt), _torch(idx),
                                     _torch(seg), rows,
                                     weights=_torch(w, tdt), run=_RUN,
                                     group=_GROUP)
    want = ref_j(jnp.asarray(dout, jdt), jnp.asarray(idx), jnp.asarray(seg),
                 rows, weights=jnp.asarray(w, jdt))
    assert np.bincount(seg).max() > _GROUP * _RUN / 2
    _assert_close(got, want, _term_size(dout, idx, seg, w, rows), name)
