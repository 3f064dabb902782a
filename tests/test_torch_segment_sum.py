"""K3/K4's plain versions in repro_torch vs repro's connection table.

On the CPU the port's `ops.connection_table[_batched]` run the plain
PyTorch slot loop; the JAX side runs the Pallas kernels themselves in
interpret mode (``prefer="pallas"``) and `repro`'s one-hot oracle
(``prefer="ref"``), on the shapes of tests/test_kernels.py.  Weights are
integers, so every fp32 sum is exact and the tables must be equal bit for
bit.  The CUDA kernels are held against the plain version on the card
(tests/test_torch_cuda.py, and chip_smoke.py at the sweep's shapes).
"""

import re

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


# --- csrc/segment_sum.cu's tiling, emulated in NumPy -----------------------
#
# The CPU test runs have no CUDA compiler, so every index
# map of the kernel (tiles of R rows, the shard of each row, the staged
# slabs and their shift into a 16-byte line, the unaligned heads and
# tails, the chunks of parts, the padded table stride, the ragged last
# tile, the 16-byte stores) is run here thread by thread, with the
# kernel's own constants read from its source.  Global arrays are word
# arrays at a word address ``base + j``; ``base & 3`` is a tensor's place in
# its 16-byte line.  Every 16-byte copy and store asserts its alignment,
# every read its bounds, and every table entry must be written once.

_CONSTS = {k: int(v) for k, v in re.findall(
    r"constexpr int (k\w+) = (\d+);", cuda.SOURCE.read_text())}
_T = _CONSTS["kThreads"]


def _round4(n):
    return (n + 3) & ~3


def _stride(nparts):
    return (min(nparts, _CONSTS["kChunk"]) + 1) | 1


def _tiling(rows, w, sms):
    """Rows per tile and slots staged at a time, as ``launch`` picks them."""
    R = _CONSTS["kRows"]
    while R > 1 and -(-rows // R) < _CONSTS["kFill"] * sms:
        R >>= 1
    if w > _CONSTS["kSlab"]:
        return 1, _CONSTS["kSlab"]
    return min(R, _CONSTS["kSlab"] // w), w


class _Mem:
    """A global array of 32-bit words at word address ``base``."""

    def __init__(self, a, base):
        self.w, self.base = np.ascontiguousarray(a).reshape(-1).view(np.uint32), base

    def __getitem__(self, addr):
        j = addr - self.base
        assert 0 <= j < self.w.size, f"read past the array at word {j}"
        return self.w[j]


def _emulate(labels, cols, wts, nparts, sms=132, base=(0, 0, 0, 0),
             mutate=None):
    """The kernel's table for labels (G, m), cols/wts (G, B, w), with the
    tensors at word addresses ``base`` (labels, cols, wts, out).
    ``mutate`` names one offset to break."""
    G, B, w = cols.shape
    m, rows = labels.shape[-1], G * B
    R, kc = _tiling(rows, w, sms)
    S = _stride(nparts) - (mutate == "stride") * 2
    chunk, U = _CONSTS["kChunk"], _CONSTS["kUnroll"]
    lab_g, cols_g, wts_g = (_Mem(a, b) for a, b in zip((labels, cols, wts),
                                                        base))
    out = np.zeros(rows * nparts, np.float32)
    writes = np.zeros(rows * nparts, np.int64)
    ob = base[3]
    tabw, goffw = _round4(R * S), _round4(2 * R)
    area_c = tabw + goffw
    area_w = area_c + _round4(R * kc) + 4
    smem = np.zeros(area_w + _round4(R * kc) + 4, np.uint32)
    assert smem.size == tabw + goffw + 2 * (_round4(R * kc) + 4)
    assert smem.size <= _round4(_CONSTS["kRows"] * _stride(2**30)) \
        + _round4(2 * _CONSTS["kRows"]) + 2 * (_CONSTS["kSlab"] + 4)
    tab = smem[:tabw].view(np.float32)

    def misalign(addr):
        return 0 if mutate == "shift" else addr & 3

    def stage(s, src, g0, n):
        """s[0, n) = the words at address g0 on: cp.async and single words."""
        head = min((4 - misalign(g0)) & 3, n)
        nvec = (n - head) >> 2
        for tid in range(_T):
            for j in range(tid, head, _T):
                smem[s + j] = src[g0 + j]
            for v in range(tid, nvec, _T):
                d, g = s + head + 4 * v, g0 + head + 4 * v
                assert d % 4 == 0 and g % 4 == 0, "cp.async off 16 bytes"
                smem[d:d + 4] = [src[g + i] for i in range(4)]
            for j in range(head + 4 * nvec + tid, n, _T):
                smem[s + j] = src[g0 + j]

    for r0 in range(0, rows, R):
        nr = min(R, rows - r0)
        goff = [((r0 if mutate == "goff" else r0 + t) // B) * m
                for t in range(nr)]
        whole = kc == w
        for p0 in range(0, nparts, chunk):
            cw = min(chunk, nparts - p0)
            for k0 in range(0, w, kc):
                kn = min(kc, w - k0)
                n = nr * kn
                off = r0 * w + k0 + (mutate == "slab")
                lab = area_c + misalign(cols_g.base + off)
                wt = area_w + misalign(wts_g.base + off)
                assert lab + n <= area_c + _round4(R * kc) + 4
                assert wt + n <= smem.size
                load = p0 == 0 or not whole
                if load:
                    stage(lab, cols_g, cols_g.base + off, n)
                    stage(wt, wts_g, wts_g.base + off, n)
                if k0 == 0:
                    tab[:_round4(nr * S)] = 0
                if load:            # gather, thread by thread
                    dr, dk = divmod(_T + (mutate == "step"), kn)
                    for tid in range(_T):
                        row, k = divmod(tid, kn)
                        for e0 in range(tid, n, _T * U):
                            v = []
                            for u in range(U):
                                e = e0 + u * _T
                                v.append(lab_g[lab_g.base + goff[row]
                                               + int(smem[lab + e].view(np.int32))]
                                         if e < n else 0)
                                k, row = k + dk, row + dr
                                if k >= kn:
                                    k, row = k - kn, row + 1
                            for u in range(U):
                                if e0 + u * _T < n:
                                    smem[lab + e0 + u * _T] = v[u]
                q0 = 0 if mutate == "chunk" else p0
                for t in range(nr):          # sum_row: a thread a row
                    ls = smem[lab + t * kn:lab + (t + 1) * kn].view(np.int32)
                    vs = smem[wt + t * kn:wt + (t + 1) * kn].view(np.float32)
                    for k in range(kn):
                        q = (int(ls[k]) - q0) & 0xFFFFFFFF
                        if q < cw:
                            tab[t * S + q] += vs[k]

            def put(e_out, x):
                out[e_out - ob] = x
                writes[e_out - ob] += 1

            if cw == nparts:                 # store_tile
                d0 = ob + r0 * nparts
                n = nr * cw
                head = min((4 - (d0 & 3)) & 3, n)
                nvec = (n - head) >> 2
                for e in range(head):
                    put(d0 + e, tab[(e // cw) * S + e % cw])
                dr, dq = divmod(4 * _T, cw)
                for tid in range(_T):
                    row, q = divmod(head + 4 * tid, cw)
                    for v in range(tid, nvec, _T):
                        d = d0 + head + 4 * v
                        assert d % 4 == 0, "float4 store off 16 bytes"
                        rr, qq = row, q
                        for i in range(4):
                            put(d + i, tab[rr * S + qq])
                            qq += 1
                            if qq == cw:
                                qq, rr = 0, rr + 1
                        q, row = q + dq, row + dr
                        if q >= cw:
                            q, row = q - cw, row + 1
                for e in range(head + 4 * nvec, n):
                    put(d0 + e, tab[(e // cw) * S + e % cw])
            else:                            # store_rows
                d0 = ob + r0 * nparts + p0
                dr, dq = divmod(_T, cw)
                for tid in range(_T):
                    row, q = divmod(tid, cw)
                    for _ in range(tid, nr * cw, _T):
                        put(d0 + row * nparts + q, tab[row * S + q])
                        q, row = q + dq, row + dr
                        if q >= cw:
                            q, row = q - cw, row + 1
    assert (writes == 1).all(), "a table entry written other than once"
    return out.reshape(G, B, nparts)


# (G, B, w, m, nparts, sms, base): sms < 132 forces wider tiles onto small
# rows; base puts each tensor elsewhere in its 16-byte line.
TILING = {
    "w1": (2, 37, 1, 20, 5, 1, (0, 1, 2, 3)),
    "w40": (3, 23, 40, 60, 7, 1, (1, 0, 3, 2)),
    "nparts1": (2, 45, 6, 30, 1, 1, (0, 3, 1, 1)),
    "nparts300": (1, 70, 9, 80, 300, 2, (2, 2, 0, 3)),
    "ragged": (1, 300, 5, 90, 12, 1, (0, 0, 0, 1)),
    "straddle": (5, 2 * _CONSTS["kRows"] + 3, 4, 40, 9, 1, (3, 1, 2, 0)),
    "short_shards": (6, 17, 3, 25, 33, 1, (1, 1, 1, 1)),
    "k3_bench_like": (1, 260, 27, 300, 128, 1, (0, 0, 0, 0)),
    "wide_rows": (1, 3, 4100, 50, 6, 1, (1, 2, 3, 1)),
}


def _tiling_inputs(G, B, w, m, nparts, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, nparts + 1, (G, m)).astype(np.int32)
    cols = rng.integers(0, m, (G, B, w)).astype(np.int32)
    wts = rng.normal(size=(G, B, w)).astype(np.float32)
    return labels, cols, wts


@pytest.mark.parametrize("case", list(TILING))
def test_tiling_emulation_matches_plain_and_pallas(case):
    """The kernel's index maps give the plain slot loop's table bit for bit
    on fp32 weights, and the Pallas kernel's (interpret mode); labels -1
    and nparts add nothing."""
    G, B, w, m, nparts, sms, base = TILING[case]
    labels, cols, wts = _tiling_inputs(G, B, w, m, nparts, len(case))
    R, kc = _tiling(G * B, w, sms)
    got = _emulate(labels, cols, wts, nparts, sms, base)
    want = ref.connection_table_batched_ref(*map(torch.from_numpy,
                                                 (labels, cols, wts)), nparts)
    np.testing.assert_array_equal(got, want.numpy())
    if w <= 64:    # the interpreted Pallas kernel unrolls the slot loop
        pallas = np.asarray(ops_j.connection_table_batched(
            jnp.asarray(labels), jnp.asarray(cols), jnp.asarray(wts), nparts,
            prefer="pallas"))
        np.testing.assert_array_equal(got, pallas)
    if case == "straddle":
        assert R == _CONSTS["kRows"] and B % R == 3
    if case == "wide_rows":
        assert (R, kc) == (1, _CONSTS["kSlab"])


def test_tiling_at_the_cards_shapes():
    """Rows per tile at phase 8's shapes on 132 SMs, as the kernel's header
    states them."""
    assert _tiling(64 * 1463, 26, 132) == (64, 26)      # K4 main
    assert _tiling(16384, 27, 132) == (16, 27)          # K3 bench
    assert _tiling(1463, 26, 132) == (2, 26)            # K3 root
    assert _tiling(3 * 40, 6, 132) == (1, 6)            # K4 tiny
    assert _tiling(100, 40, 1) == (32, 40)
    assert _tiling(1000, 200, 1) == (20, 200)           # kSlab / w


@pytest.mark.parametrize("mutate", ["slab", "shift", "goff", "chunk", "step",
                                    "stride"])
def test_tiling_emulation_catches_a_wrong_offset(mutate):
    """One wrong offset breaks the table (or trips an alignment, bounds or
    write-once check) on one of two shapes: 64-row tiles that straddle
    shards, 150 parts in two chunks; and 8-row tiles of a 40-part table.
    The emulation tells a right map from a wrong one."""
    broke = []
    for G, B, w, m, nparts, sms in ((3, 70, 5, 40, 150, 1),
                                    (3, 70, 5, 40, 40, 6)):
        labels, cols, wts = _tiling_inputs(G, B, w, m, nparts, 11)
        want = ref.connection_table_batched_ref(
            *map(torch.from_numpy, (labels, cols, wts)), nparts).numpy()
        base = (0, 1, 2, 3)
        np.testing.assert_array_equal(_emulate(labels, cols, wts, nparts, sms,
                                               base), want)
        try:
            got = _emulate(labels, cols, wts, nparts, sms, base,
                           mutate=mutate)
        except (AssertionError, IndexError):
            broke.append(True)
            continue
        broke.append(not np.array_equal(got, want))
    assert _tiling(210, 5, 6)[0] == 8
    assert any(broke)
