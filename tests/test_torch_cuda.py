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
same run on the CPU label for label (integer weights: exact sums); on the
card the guard's two catches let every exception through.  K6,
the flash attention, is held to its plain version with
tests/test_kernels.py's `_tol` (fp32 2e-5, bf16 2e-2), its split-KV decode
route also to itself (repeated calls bit-identical), and the smoke LM's
greedy tokens on the card to the CPU's exactly (fp32; logits within
1e-3), the MoE smoke LMs' likewise, and `moe_apply` on the card to
itself bit for bit.  The gather-scatter Laplacian (no kernel of its own: an ordered
``segment_reduce`` and a take) is held to its CPU apply within 1e-5 of
Σ|terms| and to itself bit for bit on repeated calls, and the
``reference`` preset (recursive engine, K1 in its AMG levels) on the
card to the CPU run label for label.  K5, the embedding bag, is held to its plain version per element
relative to the bag's Σ|w·row| (fp32 1e-5: the plain version adds with
atomics in another order; bf16 2e-2), and bit for bit on bags of one in
fp32; bags of more than R entries bit for bit against the run-order plain
version (elementwise sums: the same bits on the card), split across warps
or not, twice; a vocab slice's owned rows bit for bit against the whole
table's backward; the smoke SASRec on the card to the CPU run: user states within
1e-5, streamed top-100 ids identical.  Training: K6 with a sliding window
on its three routes against the plain mask; K6's and K5's gradients
against autograd through their plain versions, K5's bit-identical twice;
K6's backward kernel against the plain recompute (fp32 1e-5, bf16 2e-2 of
each gradient's max) and in fp32 against the emulation of its tiles
(1e-6), bit-identical twice;
a smoke LM and a smoke SASRec train step bit-identical twice.  The dry
run's view of K6 and K5: `FlopCounterMode` over a launch on the card
counts the tiles K6's loops multiply (tests/_k6_tiles.py) and two FLOPs an
element of each of K5's entries; their shape rule on meta tensors gives
the real output's shape, type and strides in every case above.  The GNNs
(no kernel of their own: a fixed-order ``segment_reduce`` and a take) —
the ordered scatter and its backward against ``index_add_`` within 1e-5
of Σ|terms| and bit-identical twice; one smoke train step of each arch on
the card against the CPU within 1e-5 (loss, relative; parameters).
"""

import re

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
                                          (1320, 26, 88320, 64), (50, 40, 300, 300),
                                          (3, 4100, 50, 6), (2, 4100, 50, 300)])
@pytest.mark.parametrize("integer", [True, False])
def test_connection_table_kernel_on_card(card, B, w, m, nparts, integer):
    """K3, up to the benchmark's and the full sweep's root shapes; nparts
    above kChunk (128) walks its chunks, and w above kSlab (4096) takes
    one row a tile, staged a slab of slots at a time."""
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
                                            (64, 1320, 26, 88320, 64),
                                            (64, 1463, 26, 97472, 64),
                                            (2, 3, 8197, 70, 140)])
def test_connection_table_batched_kernel_on_card(card, G, B, w, m, nparts):
    """K4, up to the full box's sweep shapes (64 shards; the fourth is
    chip_smoke.py's K4 ``main``), and rows of three slabs past kSlab slots
    (the last ragged) with two chunks of parts."""
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


def _segsum_tile_rows():
    """K3/K4's widest tile (kRows) and the tiles per SM it aims at (kFill),
    from the kernel's source."""
    from repro_torch.kernels.segment_sum import cuda as ss_cuda

    src = ss_cuda.SOURCE.read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                 for k in ("kRows", "kFill"))


def _offset_view(a, offset):
    """``a`` as a contiguous view ``offset`` elements into a larger
    tensor."""
    big = torch.empty(a.numel() + offset, dtype=a.dtype, device=a.device)
    view = big[offset:].view(a.shape)
    view.copy_(a)
    return view


SEGSUM_EDGES = ["straddle", "labels_outside", "storage_offset", "nparts1000",
                "repeated"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEGSUM_EDGES)
@pytest.mark.parametrize("integer", [True, False])
def test_connection_table_edges_on_card(card, case, integer):
    """K4's edges, bit for bit against the plain version: 64-row (kRows) tiles
    that straddle shards (G = 5, B = 3 past a multiple of the tile);
    labels -1 and nparts (they add nothing); contiguous views with a
    storage offset (taken, at every place in a 16-byte line); nparts =
    1000 (eight chunks of parts); 20 repeated calls bit-identical."""
    from repro_torch.kernels.segment_sum import cuda as ss_cuda
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.kernels.segment_sum import ref as ss_ref

    G, B, w, m, nparts = 3, 200, 26, 500, 64
    if case == "straddle":
        rows, fill = _segsum_tile_rows()
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        G, B = 5, rows * -(-fill * sms // 5) + 3
    elif case == "nparts1000":
        nparts = 1000
    args = _tables((G,), B, w, m, nparts, 11, card, integer)
    if case == "labels_outside":
        rng = np.random.default_rng(12)
        args = (torch.from_numpy(rng.integers(-1, nparts + 1, (G, m))
                                 .astype(np.int32)).to(card), *args[1:])
        assert (args[0] == -1).any() and (args[0] == nparts).any()
    if case == "storage_offset":
        args = tuple(_offset_view(a, o) for a, o in zip(args, (1, 2, 3)))
        assert all(a.is_contiguous() and a.storage_offset() for a in args)
    want = ss_ref.connection_table_batched_ref(*args, nparts)
    calls = 20 if case == "repeated" else 1
    before = ss_cuda.BATCHED_LAUNCHES
    got = [ss_ops.connection_table_batched(*args, nparts, prefer="kernel")
           for _ in range(calls)]
    torch.cuda.synchronize()
    assert ss_cuda.BATCHED_LAUNCHES == before + calls
    assert all(torch.equal(g, want) for g in got)
    if case == "storage_offset":   # K3 on the same views, shard 0
        flat = ss_ops.connection_table(args[0][0], args[1][0], args[2][0],
                                       nparts, prefer="kernel")
        assert torch.equal(flat, want[0])


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


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_sharded_sweep_across_ranks_on_card(card, backend, world, tmp_path):
    """The sweep across a process group on the card (gloo: 2 ranks sharing
    it, their collectives through the host; NCCL: one rank, a real
    communicator) gives the one-process card labels, K4 every sweep."""
    import _dist_ranks
    from repro_torch.core.rcb import rcb_parts
    from repro_torch.core.refine import balance_corridor
    from repro_torch.dist.refine_sharded import (build_frontier_plan,
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
    ss_cuda.build()                 # once, before the ranks load it
    fp = build_frontier_plan(g, parts, 16, weights=mesh.weights)
    out, rec, _ = run_sharded_sweeps(fp, parts, 16, sweeps=10, corridor=corr,
                                     device=card)
    ranks = _dist_ranks.run_ranks(
        _dist_ranks.run_cases,
        {"sweep": ("case_sweep", dict(graph=g, parts=parts, nparts=16,
                                      weights=mesh.weights, corridor=corr,
                                      device="cuda"))},
        world, tmp_path, backend=backend)
    for got in ranks:
        got = got["sweep"]
        assert np.array_equal(got["labels"], out)
        assert got["moves"] == [r.moves for r in rec]
        assert got["k4"] == got["counters"]["sharded_gathers"] == len(rec)
        assert got["info"]["ranks"] == world


@pytest.mark.cuda
def test_guard_catches_raise_on_card(card, monkeypatch):
    """On the card neither guard catch absorbs an exception, whatever its
    type: a failing table build in the sharded pass, and a failing rescue
    re-solve in the guarded RSB engine, both raise."""
    import repro_torch.core.rsb as rsb
    import repro_torch.dist.refine_sharded as rs
    from repro_torch.core.pipeline import PartitionPipeline
    from repro_torch.core.rcb import rcb_parts
    from repro_torch.mesh import box_mesh, dual_graph, grid_graph_2d

    def generic(*a, **k):
        raise RuntimeError("launch failed")

    mesh = box_mesh(6, 6, 4)
    parts = rcb_parts(mesh.coords, 4, mesh.weights)
    monkeypatch.setattr(rs, "connection_table_batched", generic)
    with pytest.raises(RuntimeError, match="launch failed"):
        rs.refine_sharded_stage(dual_graph(mesh), parts, 4,
                                weights=mesh.weights, device=card)
    monkeypatch.setattr(rsb, "fiedler_from_graph", generic)
    with pytest.raises(RuntimeError, match="launch failed"):
        PartitionPipeline(pre="none", guard=True,
                          guard_kw={"chaos": ("solver_nan",)},
                          device=card).run(grid_graph_2d(16, 16), 4)


# (B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal): the smoke LM's prefill
# and decode, tinyllama's at full width (kv_len < Skv in decode), the
# shapes of tests/test_kernels.py:139-145, one non-causal call and the edges
# of the bf16 prefill route.
FLASH_CASES = {
    "smoke_prefill": (4, 16, 16, 4, 2, 16, None, None, True),
    "smoke_decode": (4, 1, 48, 4, 2, 16, 20, 21, True),
    "prefill": (4, 512, 512, 32, 4, 64, None, None, True),
    "decode": (4, 1, 576, 32, 4, 64, 549, 550, True),
    "k1": (2, 64, 64, 4, 2, 32, None, None, True),
    "k2": (1, 100, 100, 4, 4, 64, None, None, True),
    "k3": (2, 1, 200, 8, 2, 64, None, None, True),
    "k4": (1, 128, 256, 4, 1, 32, None, None, True),
    "k5": (1, 48, 48, 2, 2, 128, None, None, True),
    "noncausal": (2, 64, 96, 4, 2, 32, None, None, False),
    # the bf16 prefill route's edges: Sq·G not a multiple of its 128-row
    # tile, G ∈ {1, 2, 4, 8}, D ∈ {16, 128}, Skv not a multiple of its
    # 64-key tile, a prefill continuing a cached prefix, the long prefill
    "rows100_g8": (1, 100, 100, 32, 4, 64, None, None, True),
    "rows33_g4": (2, 33, 33, 16, 4, 64, None, None, True),
    "g1": (1, 200, 200, 4, 4, 64, None, None, True),
    "g2": (2, 77, 77, 8, 4, 32, None, None, True),
    "d128": (1, 300, 300, 16, 2, 128, None, None, True),
    "d16": (2, 70, 70, 8, 1, 16, None, None, True),
    "skv_ragged": (1, 90, 150, 32, 4, 64, None, None, True),
    "continuation": (1, 128, 700, 32, 4, 64, 512, 640, True),
    "long_prefill": (1, 4096, 4096, 32, 4, 64, None, None, True),
    # the split-KV decode route (Sq·G <= 16): the `long` serve run's step;
    # kv_len 1, 63, 64, 65 and 577, so runs end on and off tile edges;
    # G = 1 at 16 positions and G = 2 at 8 whose causal ends cross a tile
    # edge (a run with valid keys for some rows and none for others); a
    # continuation of 4 positions (G = 4) over a longer kv_len, D = 16; a
    # non-causal call over kv_len < Skv
    "long_decode": (1, 1, 4096, 32, 4, 64, 4095, 4096, True),
    "decode_kv1": (2, 1, 64, 32, 4, 64, 0, 1, True),
    "decode_kv63": (2, 1, 128, 32, 4, 64, 62, 63, True),
    "decode_kv64": (2, 1, 128, 32, 4, 64, 63, 64, True),
    "decode_kv65": (2, 1, 128, 32, 4, 64, 64, 65, True),
    "decode_kv577": (4, 1, 640, 32, 4, 64, 576, 577, True),
    "decode_g1_sq16": (2, 16, 300, 4, 4, 32, 184, 200, True),
    "decode_g2_sq8": (1, 8, 200, 8, 4, 128, 60, 68, True),
    "decode_continuation": (1, 4, 1000, 16, 4, 16, 126, 900, True),
    "decode_noncausal": (2, 2, 300, 8, 4, 64, 0, 250, False),
}
_FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
              torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_on_card(card, case, dtype):
    """K6 against the plain version, on strided views (q, k and v
    transposed from head-major buffers: only the head dim is contiguous)."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal = FLASH_CASES[case]
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.normal(size=(B, H, Sq, D)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(2, B, Hkv, Skv, D))
                          .astype(np.float32))
    q = q.to(card, dtype).transpose(1, 2)
    kv = kv.to(card, dtype).transpose(2, 3)
    k, v = kv[0], kv[1]
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    before = fa_cuda.LAUNCHES
    got = fa_ops.flash_attention(q, k, v, prefer="cuda", **kw)
    torch.cuda.synchronize()
    assert fa_cuda.LAUNCHES == before + 1
    want = fa_ref.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["smoke_decode", "k4", "decode", "rows33_g4",
                                  "long_decode", "decode_g1_sq16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_unaligned_rows_on_card(card, case, dtype):
    """Rows of D + 1 elements (strides not a multiple of 16 bytes): K6
    stages its tiles element by element instead of 16 bytes at a time."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal = FLASH_CASES[case]
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(card, dtype)[..., :D]
               for s in ((B, Sq, H, D + 1), (B, Skv, Hkv, D + 1),
                         (B, Skv, Hkv, D + 1)))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    got = fa_ops.flash_attention(q, k, v, prefer="cuda", **kw)
    want = fa_ref.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_FLASH_TOL[dtype])


def _decode_inputs(case, card, dtype, seed):
    B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(card, dtype)
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    return q, k, v, dict(causal=causal, q_offset=q_offset, kv_len=kv_len)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_decode_is_deterministic(card, dtype):
    """The split-KV decode route at `long_decode` (32 splits on an H100):
    20 calls, every other one while a matrix product on a second stream
    holds SMs, so the splits finish in another order; the outputs are
    bit-identical (the last block merges the partials in split order) and
    each call is one launch."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ref as fa_ref

    q, k, v, kw = _decode_inputs("long_decode", card, dtype, 13)
    side = torch.cuda.Stream()
    a = torch.randn(4096, 4096, device=card)
    torch.cuda.synchronize()
    outs = []
    for i in range(20):
        if i % 2:
            with torch.cuda.stream(side):
                for _ in range(4):
                    torch.mm(a, a)
        before = fa_cuda.LAUNCHES
        outs.append(fa_cuda.flash_attention_cuda(q, k, v, **kw))
        assert fa_cuda.LAUNCHES == before + 1
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    want = fa_ref.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(outs[0].float().cpu().numpy(),
                               want.float().cpu().numpy(), **_FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_decode_on_two_streams(card):
    """Decode calls in flight at once on two streams (each stream has its
    own ticket counters), each against the plain version."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ref as fa_ref

    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    inputs = [_decode_inputs(case, card, torch.bfloat16, 14 + i)
              for i, case in enumerate(("long_decode", "decode_kv577"))]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(5):
        for s, (q, k, v, kw), out in zip(streams, inputs, outs):
            with torch.cuda.stream(s):
                out.append(fa_cuda.flash_attention_cuda(q, k, v, **kw))
    torch.cuda.synchronize()
    for (q, k, v, kw), out in zip(inputs, outs):
        want = fa_ref.flash_attention_plain(q, k, v, **kw).float().cpu()
        for got in out:
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.numpy(),
                                       **_FLASH_TOL[torch.bfloat16])


# The sliding window on K6's three routes: (B, Sq, Skv, H, Hkv, D,
# q_offset, kv_len, window).  Windows whose lower edge falls mid-tile, on a
# tile edge, of one key, past every key; the bf16 prefill at D = 64 and
# 128 (wgmma) and 16 (mma.sync); a continuation over a cached prefix; the
# decode route far into a cache (its splits cut [kv_start, kv_end)), at G
# = 1 over 16 positions, and a window that reaches every key.
WINDOW_CASES = {
    "prefill_w64": (2, 300, 300, 32, 4, 64, None, None, 64),
    "prefill_w100": (1, 333, 333, 16, 4, 64, None, None, 100),
    "prefill_w1": (1, 70, 70, 8, 2, 32, None, None, 1),
    "prefill_d128_w129": (1, 300, 300, 16, 2, 128, None, None, 129),
    "prefill_d16_w37": (2, 70, 70, 8, 1, 16, None, None, 37),
    "continuation_w200": (1, 128, 700, 32, 4, 64, 512, 640, 200),
    "decode_w4096": (1, 1, 8192, 32, 4, 64, 8191, 8192, 4096),
    "decode_w65": (2, 1, 640, 32, 4, 64, 576, 577, 65),
    "decode_g1_sq16_w30": (2, 16, 300, 4, 4, 32, 184, 200, 30),
    "decode_w_all": (1, 1, 600, 32, 4, 64, 550, 551, 10**6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WINDOW_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_window_on_card(card, case, dtype):
    """K6 with a sliding window against the plain version's mask."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, Sq, Skv, H, Hkv, D, q_offset, kv_len, window = WINDOW_CASES[case]
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(card, dtype)
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len, window=window)
    before = fa_cuda.LAUNCHES
    got = fa_ops.flash_attention(q, k, v, prefer="cuda", **kw)
    torch.cuda.synchronize()
    assert fa_cuda.LAUNCHES == before + 1
    want = fa_ref.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_grad_on_card(card, dtype, window):
    """dq, dk, dv through K6's autograd function (the kernel's forward, the
    backward kernel: dQ, then dK and dV, summed in a fixed order) against
    autograd through the plain version on the card (fp32 1e-5, bf16 2e-2
    of each gradient's max: the kernel sums in another order, and in bf16
    rounds p / l and ds before their products); each kernel launched
    once."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, S, H, Hkv, D = 2, 256, 32, 4, 64
    rng = np.random.default_rng(22)
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D))]

    def grads(prefer):
        q, k, v = (torch.from_numpy(a).to(card, dtype).requires_grad_()
                   for a in arrays[:3])
        out = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                     prefer=prefer)
        out.backward(torch.from_numpy(arrays[3]).to(card, dtype))
        return [t.grad.float().cpu() for t in (q, k, v)]

    before, before_bwd = fa_cuda.LAUNCHES, fa_cuda.BACKWARD_LAUNCHES
    got = grads("auto")
    assert fa_cuda.LAUNCHES == before + 1
    assert fa_cuda.BACKWARD_LAUNCHES == before_bwd + 1
    want = grads("ref")
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


# K6's backward kernel: (B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal,
# window).  FLASH_BWD_SHAPE is ragged: Sq, Skv and kv_len off the 64-row
# tiles, queries after a prefix of 60 keys, keys past kv_len; every row
# sees a key.
FLASH_BWD_SHAPE = (2, 150, 230, 2, 60, 210)      # B, Sq, Skv, Hkv, q0, kv_len
FLASH_BWD_CASES = {
    "end_aligned": (1, 256, 256, 4, 4, 64, 0, 256, True, None),
    "noncausal": (2, 100, 140, 4, 2, 32, 0, 120, False, None),
    "noncausal_window": (1, 90, 200, 4, 1, 16, 40, 190, False, 50),
    "tinyllama_heads": (1, 300, 300, 32, 4, 64, 0, 300, True, None),
    "window_d128": (1, 333, 333, 16, 2, 128, 0, 333, True, 100),
    "window_mid_tile": (2, 200, 700, 8, 1, 64, 480, 680, True, 150),
}


def _bwd_inputs(case, card, dtype, seed, layout="contiguous"):
    """q, k, v, dout of ``case``: contiguous; ``transposed`` from head-major
    buffers (only the head dim contiguous); ``unaligned`` rows of D + 1
    elements (strides not a multiple of 16 bytes)."""
    B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal, window = case
    rng = np.random.default_rng(seed)
    pad = 1 if layout == "unaligned" else 0
    shapes = ((B, Sq, H, D + pad), (B, Skv, Hkv, D + pad),
              (B, Skv, Hkv, D + pad), (B, Sq, H, D + pad))
    out = []
    for s in shapes:
        a = rng.normal(size=s).astype(np.float32)
        if layout == "transposed":
            t = torch.from_numpy(a.transpose(0, 2, 1, 3).copy()).to(card, dtype)
            out.append(t.transpose(1, 2))
        else:
            out.append(torch.from_numpy(a).to(card, dtype)[..., :D])
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    return (*out, kw)


# bf16 at D >= 64 (the saved-statistics route) against its emulation in
# bf16 (`flash_attention_grads_tiles(..., stats=)`: P and dS rounded where
# the kernel rounds them, the sums in fp32), of each gradient's max: one
# bf16 ulp of the largest gradient (2^-7 of it at most).  Both round their
# fp32 sums to bf16 last, and the kernel's ex2.approx and its own order of
# the sums put a sum on the other side of a rounding edge now and then
# (3.9e-3 of the max, one ulp, in the first card run)
FLASH_SAVED_EMU_TOL = 2.0 ** -7


def _check_backward(card, dtype, case, seed, layout="contiguous"):
    """The backward kernel twice against `flash_attention_grads` (fp32
    1e-5, bf16 2e-2 of each gradient's max) and, in fp32, the emulation of
    its tiles (`flash_attention_grads_tiles`, 1e-6, evaluated in float64 on
    the same values: the kernel's own rounding alone, where two fp32
    versions of the same sums differ by ~6e-7 of the max between
    themselves); bf16 at D >= 64 takes the kernel's forward's output and
    logsumexp and is held to its emulation in bf16 within
    FLASH_SAVED_EMU_TOL: the same bits twice, two launches counted,
    contiguous outputs of the inputs' shapes."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ref as fa_ref

    q, k, v, do, kw = _bwd_inputs(case, card, dtype, seed, layout)
    saved = {}
    if fa_cuda.takes_stats(dtype, q.shape[-1]):
        saved = dict(zip(("out", "lse"), fa_cuda.flash_attention_cuda(
            q, k, v, return_lse=True, **kw)))
    before = fa_cuda.BACKWARD_LAUNCHES
    got = fa_cuda.flash_attention_bwd_cuda(q, k, v, do, **kw, **saved)
    again = fa_cuda.flash_attention_bwd_cuda(q, k, v, do, **kw, **saved)
    torch.cuda.synchronize()
    assert fa_cuda.BACKWARD_LAUNCHES == before + 2
    for a, b, x in zip(got, again, (q, k, v)):
        assert torch.equal(a, b)
        assert a.shape == x.shape and a.dtype == dtype and a.is_contiguous()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    want = fa_ref.flash_attention_grads(q, k, v, do, **kw)
    for a, b in zip(got, want):
        b = b.float()
        assert float((a.float() - b).abs().max()) <= tol * float(b.abs().max())
    if dtype == torch.float32:
        tiles = fa_ref.flash_attention_grads_tiles(
            q.double(), k.double(), v.double(), do.double(), **kw)
        for a, b in zip(got, tiles):
            assert float((a.double() - b).abs().max()) \
                <= 1e-6 * float(b.abs().max())
    if saved:
        tiles = fa_ref.flash_attention_grads_tiles(
            *(t.cpu() for t in (q, k, v, do)), **kw,
            stats=(saved["out"].cpu(), saved["lse"].cpu()))
        for a, b in zip(got, tiles):
            b = b.float()
            assert float((a.float().cpu() - b).abs().max()) \
                <= FLASH_SAVED_EMU_TOL * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernel_on_card(card, dtype, D, G, window):
    """K6's backward kernel at every head dim, G 1 and 8, with and without
    a window, on FLASH_BWD_SHAPE's ragged edges, q_offset and kv_len."""
    B, Sq, Skv, Hkv, q_offset, kv_len = FLASH_BWD_SHAPE
    _check_backward(card, dtype, (B, Sq, Skv, G * Hkv, Hkv, D, q_offset,
                                  kv_len, True, window), seed=D + G)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_BWD_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_cases_on_card(card, case, dtype):
    _check_backward(card, dtype, FLASH_BWD_CASES[case], seed=41)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["transposed", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_views_on_card(card, dtype, layout):
    """Strided views: 16-byte copies from head-major buffers, and rows of
    D + 1 elements staged element by element."""
    _check_backward(card, dtype, FLASH_BWD_CASES["window_mid_tile"], seed=42,
                    layout=layout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_flops_and_meta_shape_on_card(card, dtype):
    """`FlopCounterMode` over the backward operator on the card counts 18·D
    FLOPs a pair of the tiles its launches visit (tests/_k6_tiles.py); its
    shape rule on meta tensors gives the card's dq, dk, dv."""
    from torch.utils.flop_counter import FlopCounterMode

    from _k6_tiles import bwd_pairs
    from repro_torch.kernels.flash_attention import ops  # noqa: F401 (the operator)

    from _k6_tiles import bwd_wg_dq_pairs
    from repro_torch.kernels.flash_attention import cuda as fa_cuda

    case = FLASH_BWD_CASES["window_mid_tile"]
    q, k, v, do, kw = _bwd_inputs(case, card, dtype, seed=43)
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    args = (kw["causal"], kw["q_offset"], kw["kv_len"], kw["window"])
    pair_args = (Sq, kw["q_offset"], kw["kv_len"], kw["causal"], kw["window"])
    saved, want = (), 18 * D * B * H * bwd_pairs(*pair_args)
    if fa_cuda.takes_stats(dtype, D):   # bf16 at D = 64 here
        saved = fa_cuda.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        want = 6 * D * B * Hkv * bwd_wg_dq_pairs(Sq, H // Hkv, *pair_args[1:]) \
            + 8 * D * B * H * bwd_pairs(*pair_args)
    with FlopCounterMode(display=False) as fc:
        real = torch.ops.repro_torch.flash_attention_backward(q, k, v, do,
                                                              *args, *saved)
    assert fc.get_total_flops() == want > 0
    meta = torch.ops.repro_torch.flash_attention_backward(
        *(_meta_like(t) for t in (q, k, v, do)), *args,
        *(_meta_like(t) for t in saved))
    for m, r in zip(meta, real):
        assert m.device.type == "meta"
        assert (m.shape, m.dtype, m.stride()) == (r.shape, r.dtype, r.stride())


@pytest.mark.cuda
def test_flash_attention_backward_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.flash_attention import cuda as fa_cuda

    q, k, v, do, kw = _bwd_inputs(FLASH_BWD_CASES["noncausal"], card,
                                  torch.float32, seed=44)
    with pytest.raises(ValueError, match="dout must match"):
        fa_cuda.flash_attention_bwd_cuda(q, k, v, do[:, :-1], **kw)
    with pytest.raises(TypeError):
        fa_cuda.flash_attention_bwd_cuda(q, k, v.bfloat16(), do, **kw)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa_cuda.flash_attention_bwd_cuda(q.cpu(), k, v, do, **kw)
    with pytest.raises(ValueError, match="head dim"):
        fa_cuda.flash_attention_bwd_cuda(q[..., :24], k[..., :24],
                                         v[..., :24], do[..., :24], **kw)
    # the saved-statistics route: bf16 at D = 64 takes out and lse, and
    # nothing else does
    qb, kb, vb, dob, kwb = _bwd_inputs(FLASH_BWD_CASES["end_aligned"], card,
                                       torch.bfloat16, seed=44)
    out, lse = fa_cuda.flash_attention_cuda(qb, kb, vb, return_lse=True,
                                            **kwb)
    with pytest.raises(ValueError, match="needs the forward's out and lse"):
        fa_cuda.flash_attention_bwd_cuda(qb, kb, vb, dob, **kwb)
    with pytest.raises(ValueError, match="needs the forward's out and lse"):
        fa_cuda.flash_attention_bwd_cuda(qb, kb, vb, dob, out=out, **kwb)
    with pytest.raises(ValueError, match="lse must be"):
        fa_cuda.flash_attention_bwd_cuda(qb, kb, vb, dob, out=out,
                                         lse=lse[:, :, :-1], **kwb)
    with pytest.raises(ValueError, match="lse must be"):
        fa_cuda.flash_attention_bwd_cuda(qb, kb, vb, dob, out=out,
                                         lse=lse.double(), **kwb)
    with pytest.raises(ValueError, match="out must be"):
        fa_cuda.flash_attention_bwd_cuda(qb, kb, vb, dob, out=out[:, :-1],
                                         lse=lse, **kwb)
    with pytest.raises(ValueError, match="bf16 at D >= 64 only"):
        fa_cuda.flash_attention_bwd_cuda(q, k, v, do, out=out.float(),
                                         lse=lse, **kw)
    with pytest.raises(ValueError, match="return_lse takes bf16"):
        fa_cuda.flash_attention_cuda(q, k, v, return_lse=True, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tinyllama_heads", "window_mid_tile",
                                  "window_d128", "noncausal"])
def test_flash_attention_forward_lse_on_card(card, case):
    """The forward with its logsumexp (the saved-statistics route's): the
    lse against `ref.flash_attention_lse2` (1e-5 of its largest magnitude,
    rows that see a key) and the output bits equal to the same call's
    without it (the LSE flag adds a store and nothing else)."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ref as fa_ref

    c = FLASH_BWD_CASES[case]
    if c[5] < 64:
        c = c[:5] + (64,) + c[6:]
    q, k, v, _, kw = _bwd_inputs(c, card, torch.bfloat16, seed=45)
    before = fa_cuda.LAUNCHES
    out, lse = fa_cuda.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    plain_out = fa_cuda.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_cuda.LAUNCHES == before + 2
    assert torch.equal(out, plain_out)
    want = fa_ref.flash_attention_lse2(q, k, v, **kw)
    seen = torch.isfinite(want)
    assert bool(seen.any())
    assert float((lse - want)[seen].abs().max()) \
        <= 1e-5 * float(want[seen].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [2, 300])
def test_flash_attention_grad_saves_out_and_lse_on_card(card, Sq):
    """bf16 at D = 64 under autograd saves (q, k, v, out, lse), ``out``
    the tensor it returns; a decode-shaped call (Sq = 2, G = 8) takes the
    prefill route with the logsumexp too; one launch each way, the
    gradients against autograd through the plain version (2e-2 of each
    max)."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, Skv, H, Hkv, D = 2, 300, 8, 1, 64
    rng = np.random.default_rng(46)
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D), (B, Sq, H, D))]
    kw = dict(causal=True, q_offset=Skv - Sq - 10, kv_len=Skv - 10)

    def grads(prefer):
        leaves = [torch.from_numpy(a).to(card, torch.bfloat16).requires_grad_()
                  for a in arrays[:3]]
        out = fa_ops.flash_attention(*leaves, prefer=prefer, **kw)
        saved = out.grad_fn.saved_tensors if prefer == "auto" else None
        out.backward(torch.from_numpy(arrays[3]).to(card, torch.bfloat16))
        return [t.grad.float().cpu() for t in leaves], out, saved, leaves

    before, before_bwd = fa_cuda.LAUNCHES, fa_cuda.BACKWARD_LAUNCHES
    got, out, saved, leaves = grads("auto")
    assert fa_cuda.LAUNCHES == before + 1
    assert fa_cuda.BACKWARD_LAUNCHES == before_bwd + 1
    assert len(saved) == 5
    assert all(s.data_ptr() == t.data_ptr() for s, t in zip(saved, leaves))
    assert saved[3].data_ptr() == out.data_ptr()
    assert saved[4].shape == (B, H, Sq) and saved[4].dtype == torch.float32
    want = grads("ref")[0]
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_grad_on_card(card, dtype):
    """K5's backward (K5 on the transposed problem) against autograd through
    the plain version in fp32 on the same values (fp32 1e-5, bf16 2e-2 of
    the gradient's max: the plain backward adds with atomics in another
    order), two backward passes bit-identical, rows no entry reads
    zero."""
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.embedding_bag import ops as eb_ops

    rng = np.random.default_rng(23)
    V, d, nnz, n_bags = 5000, 50, 40000, 3000
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = torch.from_numpy(rng.zipf(1.2, nnz) % (V - 100)).to(card)
    seg = torch.from_numpy(np.sort(rng.integers(0, n_bags, nnz))).to(card)
    w = torch.from_numpy(rng.normal(size=nnz).astype(np.float32)).to(card)
    dout = torch.from_numpy(rng.normal(size=(n_bags, d)).astype(np.float32)
                            ).to(card, dtype)

    def grad(prefer):
        t = torch.from_numpy(table).to(card, dtype).requires_grad_()
        eb_ops.embedding_bag(t, idx, seg, n_bags, weights=w,
                             prefer=prefer).backward(dout)
        return t.grad

    before = eb_cuda.LAUNCHES
    g1, g2 = grad("auto"), grad("auto")
    torch.cuda.synchronize()
    assert eb_cuda.LAUNCHES == before + 4        # forward + backward, twice
    assert torch.equal(g1, g2)
    assert float(g1[V - 100:].abs().max()) == 0.0
    # the plain version's autograd in fp32 (in bf16 its atomics add into
    # the bf16 gradient one entry at a time, far coarser than K5's sum)
    table32 = torch.from_numpy(table).to(card, dtype).float().requires_grad_()
    eb_ops.embedding_bag(table32, idx, seg, n_bags, weights=w.to(dtype),
                         prefer="ref").backward(dout.float())
    want = table32.grad
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((g1.float() - want).abs().max()) <= tol * float(
        want.abs().max())


@pytest.mark.cuda
def test_train_steps_on_card_are_bit_identical(card):
    """Two identical train steps from one state give the same bits on the
    card: the smoke LM (fp32, two microbatches; K6 forward twice a layer
    and microbatch under remat, K5 forward and backward a microbatch) and
    the smoke SASRec (three K5 lookups and their backward)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import recsys_batches, token_batches
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.launch.cells import lm_train_step, recsys_train_step
    from repro_torch.models import transformer as tt
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.recsys import init_sasrec
    from repro_torch.train.optimizer import adamw_init

    cfg = get_arch("tinyllama-1.1b").make_smoke_config()
    params = tt.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    batch = {k: v.to(card) for k, v in next(token_batches(
        4, 32, cfg.vocab)).items()}
    runs = []
    for _ in range(2):
        k6, k5 = fa_cuda.LAUNCHES, eb_cuda.LAUNCHES
        runs.append(lm_train_step(cfg, params, adamw_init(params), batch,
                                  microbatch=2))
        assert fa_cuda.LAUNCHES - k6 == 2 * cfg.n_layers * 2
        assert eb_cuda.LAUNCHES - k5 == 2 * 2
    assert torch.equal(runs[0][2], runs[1][2])
    for a, b in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a, b)

    scfg = get_arch("sasrec").make_smoke_config()
    sp = init_sasrec(scfg, torch.Generator(device=card).manual_seed(1))
    sb = {k: v.to(card) for k, v in next(recsys_batches(
        64, scfg.seq_len, scfg.n_items, seed=2)).items()}
    s1 = recsys_train_step(scfg, sp, adamw_init(sp), sb)
    s2 = recsys_train_step(scfg, sp, adamw_init(sp), sb)
    assert torch.equal(s1[2], s2[2])
    for a, b in zip(tree_leaves(s1[0]), tree_leaves(s2[0])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_generate_on_card_matches_cpu(card):
    """The smoke LM (fp32) through `generate` on the card, every attention
    call on K6, against the CPU run: identical greedy tokens, and prefill
    and full-forward logits within 1e-3."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as tt

    cfg = get_arch("tinyllama-1.1b").make_smoke_config()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    cpu = tt.Transformer(cfg, params)
    gpu = tt.Transformer(cfg, params).to(card)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 16)))
    fa_cuda.LAUNCHES = 0
    toks_gpu, _, _ = generate(cfg, gpu, prompts.to(card), 12)
    assert fa_cuda.LAUNCHES == cfg.n_layers * 12
    toks_cpu, _, _ = generate(cfg, cpu, prompts, 12)
    assert torch.equal(toks_gpu.cpu(), toks_cpu)
    full = torch.cat([prompts, toks_cpu], 1)
    with torch.inference_mode():
        torch.testing.assert_close(tt.forward(gpu, full.to(card)).cpu(),
                                   tt.forward(cpu, full), atol=1e-3, rtol=0)
        torch.testing.assert_close(tt.prefill(gpu, prompts.to(card))[0].cpu(),
                                   tt.prefill(cpu, prompts)[0], atol=1e-3,
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["deepseek-moe-16b", "qwen3-moe-30b-a3b"])
def test_moe_generate_on_card_matches_cpu(card, arch_id):
    """The MoE smoke LMs (fp32) through `generate` on the card against the
    CPU run: identical greedy tokens, full-forward logits within 1e-3."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as tt

    cfg = get_arch(arch_id).make_smoke_config()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    cpu = tt.Transformer(cfg, params)
    gpu = tt.Transformer(cfg, params).to(card)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 16)))
    fa_cuda.LAUNCHES = 0
    toks_gpu, _, _ = generate(cfg, gpu, prompts.to(card), 12)
    assert fa_cuda.LAUNCHES == cfg.n_layers * 12
    toks_cpu, _, _ = generate(cfg, cpu, prompts, 12)
    assert torch.equal(toks_gpu.cpu(), toks_cpu)
    full = torch.cat([prompts, toks_cpu], 1)
    with torch.inference_mode():
        torch.testing.assert_close(tt.forward(gpu, full.to(card)).cpu(),
                                   tt.forward(cpu, full), atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_apply_on_card_is_deterministic(card, dtype):
    """Two card calls of `moe_apply` give the same bits (the combine adds
    in a fixed order, no atomics), with tokens dropped past capacity."""
    from repro_torch.models import moe as mt

    moe = mt.MoEConfig(n_experts=16, top_k=4, n_shared=1, d_ff_expert=64,
                       capacity_factor=0.5)
    p = {k: v.to(card, dtype) for k, v in
         mt.init_moe(moe, 128, torch.Generator().manual_seed(0),
                     torch.float32).items()}
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 96, 128)).astype(np.float32)).to(card, dtype)
    _, _, top_e = mt.route(moe, p["router"], x.reshape(-1, 128))
    _, keep, _ = mt.dispatch(moe, top_e, 4 * 96)
    assert not bool(keep.all())
    runs = [mt.moe_apply(moe, p, x, dtype) for _ in range(5)]
    for y in runs[1:]:
        assert torch.equal(y, runs[0])


# K5 cases: (V, d, nnz, n_bags, kind); kind "sorted" (tests/test_kernels.py's
# sweep), "unsorted" (weighted; ops sorts), "empty" (bags 0 and every
# third bag empty), "one" (bags of one, weight √d: SASRec's lookups).
BAG_CASES = {
    "sweep_a": (100, 16, 64, 10, "sorted"),
    "sweep_b": (500, 50, 300, 32, "sorted"),
    "sweep_c": (64, 128, 128, 8, "sorted"),
    "weighted_unsorted": (80, 24, 100, 12, "unsorted"),
    "empty": (300, 50, 400, 90, "empty"),
    "one": (1000, 50, 4096, 4096, "one"),
    "wide_odd": (200, 301, 500, 40, "sorted"),
}


def _bag_case(case, device, dtype):
    V, d, nnz, B, kind = BAG_CASES[case]
    rng = np.random.default_rng(len(case))
    table = torch.from_numpy(rng.normal(size=(V, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, V, nnz).astype(np.int32))
    if kind == "one":
        seg = torch.arange(nnz, dtype=torch.int32)
        w = torch.full((nnz,), float(np.sqrt(d)))
    else:
        ids = np.arange(B)
        if kind == "empty":
            ids = ids[(ids % 3 != 0)]
        seg = rng.choice(ids, nnz).astype(np.int32)
        if kind != "unsorted":
            seg = np.sort(seg)
        seg = torch.from_numpy(seg)
        w = torch.from_numpy(rng.normal(size=nnz).astype(np.float32))
    return (table.to(device, dtype), idx.to(device), seg.to(device),
            w.to(device, dtype), B, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BAG_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_kernel_on_card(card, case, dtype):
    """K5 against its plain version on the card (empty bags: zero rows)."""
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag import ref as eb_ref

    table, idx, seg, w, B, kind = _bag_case(case, card, dtype)
    sort = kind == "unsorted"
    before = eb_cuda.LAUNCHES
    got = eb_ops.embedding_bag(table, idx, seg, B, weights=w,
                               assume_sorted=not sort, prefer="cuda")
    torch.cuda.synchronize()
    assert eb_cuda.LAUNCHES == before + 1
    want = eb_ref.embedding_bag_ref(table, idx, seg, B, weights=w)
    size = eb_ref.embedding_bag_ref(table.float().abs(), idx, seg, B,
                                    weights=w.float().abs())
    if kind == "one" and dtype == torch.float32:
        assert torch.equal(got, want)
        assert torch.equal(got, table[idx.long()] * w[:, None])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol * size).all()), float((diff / size.clamp(
        min=1e-30)).max())
    empty = torch.bincount(seg.long(), minlength=B) == 0
    assert bool((got[empty] == 0).all())


def _bag_tile():
    """K5's entries a tile (``kTile`` in embedding_bag.cu: a warp's
    lanes, read from the source)."""
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda

    return int(re.search(r"constexpr int kTile = (\d+);",
                         eb_cuda.SOURCE.read_text()).group(1))


# K5's tile edges: bag lengths (0 = an empty bag) for a tile of T entries.
BAG_EDGES = {
    "longer_than_two_tiles": lambda T: [3, 2 * T + 50, 1, 7],
    "ends_at_tile_end": lambda T: [T // 4] * 8 + [5],
    "one_bag": lambda T: [3 * T + 11],
    "empty_lead_and_trail": lambda T: [0] * 5 + [2, 1, 0, T + 3] + [0] * 6,
    "gap_at_tile_start": lambda T: [T, 0, 0, 5, 1],
    "nnz0": lambda T: [0] * 9,
    # many tiles of bags of one, then a bag over two tile ends, one that
    # ends at a tile's end, and empty bags
    "full_tiles": lambda T: [1] * (256 * 274) + [2 * T + 50, T - 50 % T, 0,
                                                 0, 5],
}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [1, 50, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(BAG_EDGES))
def test_embedding_bag_kernel_tile_edges(card, case, dtype, d, offset):
    """K5 at its tiles' edges, bit for bit against the plain version on
    the CPU, which adds in nnz order and rounds once as the kernel does;
    ``offset`` = 1 puts the table at an odd storage offset (VEC = 1)."""
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.embedding_bag import ref as eb_ref

    lengths = BAG_EDGES[case](_bag_tile())
    rng = np.random.default_rng(len(case) + d)
    B, V = len(lengths), 300
    seg = torch.from_numpy(np.repeat(np.arange(B, dtype=np.int32), lengths))
    idx = torch.from_numpy(rng.integers(0, V, seg.numel()).astype(np.int32))
    flat = torch.from_numpy(rng.normal(size=V * d + offset).astype(
        np.float32)).to(dtype)
    table = flat[offset:].view(V, d)
    w = torch.from_numpy(rng.normal(size=seg.numel()).astype(np.float32)
                         ).to(dtype)
    want = eb_ref.embedding_bag_ref(table, idx, seg, B, weights=w)
    gt = flat.to(card)[offset:].view(V, d)
    assert gt.storage_offset() == offset and gt.is_contiguous()
    before = eb_cuda.LAUNCHES
    got = eb_cuda.embedding_bag_cuda(gt, idx.to(card), seg.to(card),
                                     w.to(card), B)
    torch.cuda.synchronize()
    assert eb_cuda.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)
    empty = torch.tensor(lengths) == 0
    assert bool((got[empty.to(card)] == 0).all())


def _bag_run_shape():
    """K5's (R, G): entries a run of a long bag, runs a group."""
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda

    return eb_cuda.run_shape()


# K5's long bags (more than R entries): (bag lengths, table rows, which
# entries' weights are 0) for R.  The Zipf case is a lookup's transposed
# bag: 10^6 entries sorted by table row.
BAG_LONG = {
    "run_edges": lambda R: ([0, 0, R - 1, 0, R, 0, R + 1, 2 * R + 5, 0, 3],
                            300),
    "one_1e5": lambda R: ([0, 2, 0, 100_000, 0, 1, 0], 500),
    "zipf_transposed": lambda R: (np.bincount(np.random.default_rng(5).zipf(
        1.2, 10**6) % 20_000, minlength=20_000).tolist(), 10**6),
    # a vocab-parallel rank's row 0: ~96% of the entries, at weight 0
    "vocab_row0": lambda R: ([480_000] + [1, 0, 3, 2] * 5_000, 10**6),
}


def _long_bag_case(case, dtype, d, offset, card):
    """Sorted segments of BAG_LONG[case], table rows from the seed (a
    flat buffer at ``offset`` elements), weights (0 on ~96% of the
    vocab_row0 bag): CPU tensors and the table on the card."""
    lengths, V = BAG_LONG[case](_bag_run_shape()[0])
    rng = np.random.default_rng(len(case) + d)
    B = len(lengths)
    seg = torch.from_numpy(np.repeat(np.arange(B, dtype=np.int32), lengths))
    idx = torch.from_numpy(rng.integers(0, V, seg.numel()).astype(np.int32))
    w = rng.normal(size=seg.numel()).astype(np.float32)
    if case == "vocab_row0":
        w[:lengths[0]][np.arange(lengths[0]) % 25 != 0] = 0.0
    flat = torch.from_numpy(rng.normal(size=V * d + offset).astype(
        np.float32)).to(dtype).to(card)
    table = flat[offset:].view(V, d)
    assert table.storage_offset() == offset and table.is_contiguous()
    return table, idx.to(card), seg.to(card), torch.from_numpy(w).to(
        card, dtype), B, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [1, 50, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(BAG_LONG))
def test_embedding_bag_long_bags_on_card(card, case, dtype, d, offset):
    """Bags of more than R entries (and empty bags beside them), split
    across warps and walked by their owner alone: both bit for bit
    against the run-order plain version (elementwise sums, the same bits
    on the card as on the CPU), the split twice the same bits, and within
    tolerance of ``index_add_``'s sum (fp32 1e-5, bf16 2e-2 of Σ|terms|);
    empty bags are zero rows."""
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.embedding_bag import ref as eb_ref

    table, idx, seg, w, B, lengths = _long_bag_case(case, dtype, d, offset,
                                                    card)
    R, G = _bag_run_shape()
    assert max(lengths) > R
    before = eb_cuda.LAUNCHES
    got = eb_cuda.embedding_bag_cuda(table, idx, seg, w, B, split=True)
    again = eb_cuda.embedding_bag_cuda(table, idx, seg, w, B, split=True)
    alone = eb_cuda.embedding_bag_cuda(table, idx, seg, w, B)
    torch.cuda.synchronize()
    assert eb_cuda.LAUNCHES == before + 3
    want = eb_ref.embedding_bag_runs_ref(table, idx, seg, B, weights=w,
                                         run=R, group=G)
    assert torch.equal(got, want)
    assert torch.equal(again, got)
    assert torch.equal(alone, got)
    size = eb_ref.embedding_bag_ref(table.float().abs(), idx, seg, B,
                                    weights=w.float().abs())
    plain = eb_ref.embedding_bag_ref(table, idx, seg, B, weights=w)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    diff = (got.float() - plain.float()).abs()
    assert bool((diff <= tol * size).all()), float((diff / size.clamp(
        min=1e-30)).max())
    empty = torch.tensor(lengths, device=card) == 0
    assert bool((got[empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [0, 1])
def test_embedding_bag_vocab_slice_backward_rows_on_card(card, rank):
    """A vocab-parallel rank's backward (its rows of two; foreign ids at
    its row 0, weight 0) against the whole table's, both through K5's
    split transposed bag: every owned row but row 0 bit for bit (its
    entries, their order and so its runs are the whole table's), row 0
    within 1e-5 of Σ|terms| of its owned part.  The ids are Zipf(1.2)
    from the middle of the vocab, so rank 1's rows hold the long bags and
    rank 0's row 0 most (~91%) of the entries."""
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.embedding_bag import ops as eb_ops

    rng = np.random.default_rng(17)
    V, d, n = 200_000, 50, 600_000
    rows = V // 2
    ids = torch.from_numpy(((rng.zipf(1.2, n) - 1 + rows) % V).astype(
        np.int32)).to(card)
    dout = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                            ).to(card)
    full = torch.from_numpy(rng.normal(size=(V, d)).astype(np.float32)
                            ).to(card)
    seg = torch.arange(n, dtype=torch.int32, device=card)
    weight = 7.0

    def grad(table, idx, w):
        t = table.clone().requires_grad_()
        eb_ops.embedding_bag(t, idx, seg, n, weights=w, bags_of_one=True
                             ).backward(dout)
        return t.grad

    whole = grad(full, ids, torch.full((n,), weight, device=card))
    local = ids.long() - rank * rows
    own = (local >= 0) & (local < rows)
    before = eb_cuda.LAUNCHES
    part = grad(full[rank * rows:(rank + 1) * rows],
                torch.where(own, local, 0).to(torch.int32),
                own.float() * weight)
    torch.cuda.synchronize()
    assert eb_cuda.LAUNCHES == before + 2
    mine = whole[rank * rows:(rank + 1) * rows]
    assert torch.equal(part[1:], mine[1:])
    counts = torch.bincount(local[own], minlength=rows)
    R, _ = _bag_run_shape()
    if rank == 1:
        assert int(counts[1:].max()) > 10 * R       # long owned bags
    else:
        assert float((~own).float().mean()) > 0.85  # row 0's share
    size = (dout.abs() * weight)[own & (local == 0)].sum(0)
    assert bool(((part[0] - mine[0]).abs() <= 1e-5 * size).all())


@pytest.mark.cuda
def test_embedding_bag_kernel_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda

    table = torch.zeros((10, 4), device=card)
    idx = torch.zeros(3, dtype=torch.int32, device=card)
    w = torch.ones(3, device=card)
    with pytest.raises(TypeError, match="int32"):
        eb_cuda.embedding_bag_cuda(table, idx.long(), idx, w, 2)
    with pytest.raises(TypeError, match="share"):
        eb_cuda.embedding_bag_cuda(table, idx, idx, w.double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        eb_cuda.embedding_bag_cuda(table.t(), idx, idx, w, 2)


@pytest.mark.cuda
def test_sasrec_smoke_on_card_matches_cpu(card):
    """The smoke SASRec (fp32) on the card, both lookups on K5, against the
    CPU run: user states within 1e-5, streamed top-100 ids identical,
    candidate scores within 1e-4; one K5 launch per user chunk of the
    top-k and two per retrieval."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.launch.cells import recsys_retrieval, recsys_serve_topk
    from repro_torch.models.recsys import SASRec, init_sasrec

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_arch("sasrec").make_smoke_config()
        params = init_sasrec(cfg, torch.Generator().manual_seed(0))
        cpu, gpu = SASRec(cfg, params), SASRec(cfg, params).to(card)
        seq = next(recsys_batches(64, cfg.seq_len, cfg.n_items, seed=1))[
            "item_seq"]
        seq[:8, :5] = 0                                  # left padding
        eb_cuda.LAUNCHES = 0
        vg, ig = recsys_serve_topk(cfg, gpu, seq.to(card), user_chunk=32)
        assert eb_cuda.LAUNCHES == 2
        vc, ic = recsys_serve_topk(cfg, cpu, seq, user_chunk=32)
        assert torch.equal(ig.cpu(), ic)
        torch.testing.assert_close(vg.cpu(), vc, atol=1e-5, rtol=0)
        torch.testing.assert_close(gpu.user_state(seq.to(card)).cpu(),
                                   cpu.user_state(seq), atol=1e-5, rtol=0)
        cand = torch.randperm(cfg.n_items, generator=torch.Generator()
                              .manual_seed(0)) + 1
        eb_cuda.LAUNCHES = 0
        sg = recsys_retrieval(cfg, gpu, seq[:1].to(card), cand.to(card))
        assert eb_cuda.LAUNCHES == 2
        torch.testing.assert_close(sg.cpu(), recsys_retrieval(
            cfg, cpu, seq[:1], cand), atol=1e-4, rtol=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# The gather-scatter Laplacian and the recursive engine on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_gs_apply_on_card_matches_cpu(card, batched):
    from repro_torch.core import fiedler as fd
    from repro_torch.core import gather_scatter as gs
    from repro_torch.mesh import box_mesh, pebble_mesh

    vg = pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1).vert_gid
    if batched:
        parts = [vg[:800], vg[800:]]
        L = {d: fd._padded_gs_laplacian_batched(parts, 1024, 2, device=d)
             for d in ("cpu", card)}
        shape = (2, 1024)
    else:
        vg = box_mesh(40, 32, 24).vert_gid
        L = {d: gs.weighted_laplacian(vg, device=d) for d in ("cpu", card)}
        shape = (vg.shape[0],)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape)
                         .astype(np.float32))
    want = L["cpu"].apply(x).numpy()
    scale = (L["cpu"].degree_full * x.abs()
             + L["cpu"].adj_apply(x.abs())).numpy()
    got = L[card].apply(x.to(card))
    again = L[card].apply(x.to(card))
    assert torch.equal(got, again)            # deterministic on the card
    got = got.cpu().numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * np.maximum(scale, 1.0))


@pytest.mark.cuda
def test_reference_preset_on_card_matches_cpu(card):
    from repro_torch.configs.parrsb import make_pipeline
    from repro_torch.core.pipeline import partition
    from repro_torch.core.refine import edge_cut
    from repro_torch.mesh import pebble_mesh

    mesh = pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1)
    on_card = make_pipeline("reference", device=card).run(mesh, 16)
    on_cpu = make_pipeline("reference", device="cpu").run(mesh, 16)
    assert np.array_equal(on_card.parts, on_cpu.parts)
    assert edge_cut(on_card.require_graph(), on_card.parts) <= 1.05 * 8918.0
    assert on_card.report.guard.clean
    before = cuda.LAUNCHES
    partition(pebble_mesh(10, 10, 10, n_pebbles=6, seed=0), 8,
              partitioner="rsb_inverse", precond="amg", engine="recursive",
              device=card)
    assert cuda.LAUNCHES > before             # K1 in the AMG levels


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 512])
def test_gnn_ordered_scatter_on_card(card, d):
    """`scatter_sum` and `gather`'s backward at a sampled batch's layout
    (most slots padded onto row 0, a power-law source side) against
    ``index_add_``, and the same bits twice."""
    from repro_torch.models.gnn.common import (gather, ordered_sum,
                                               scatter_sum, segment_plan)

    rng = np.random.default_rng(d)
    E, n = 40_000, 30_000
    idx = np.minimum(rng.zipf(1.5, E) - 1, n - 1)
    idx[rng.random(E) < 0.6] = 0
    v = torch.from_numpy(rng.normal(size=(E, d)).astype(np.float32)).to(card)
    it = torch.from_numpy(idx).to(card)
    plan = segment_plan(it, n)
    got = scatter_sum(v, plan, n)
    want = torch.zeros(n, d, device=card).index_add_(0, it, v)
    terms = torch.zeros(n, d, device=card).index_add_(0, it, v.abs())
    assert float(((got - want).abs() / terms.clamp(min=1e-30)).max()) <= 1e-5
    assert torch.equal(got, scatter_sum(v, plan, n))
    cpu = ordered_sum(v.cpu(), segment_plan(idx, n))
    assert float(((got.cpu() - cpu).abs()).max()) <= \
        1e-5 * float(terms.max())
    x = torch.zeros(n, d, device=card, requires_grad=True)
    grads = []
    for _ in range(2):
        (g,) = torch.autograd.grad((gather(x, plan) * v).sum(), x)
        grads.append(g)
    assert torch.equal(grads[0], grads[1])
    assert float(((grads[0] - want).abs() / terms.clamp(min=1e-30)).max()) \
        <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["meshgraphnet", "graphcast", "nequip",
                                     "mace"])
def test_gnn_smoke_step_on_card_matches_cpu(card, arch_id):
    """One `gnn_train_step` of the smoke config on the launcher's data,
    on the card against the CPU, and twice on the card: the same bits."""
    from repro_torch.launch.cells import gnn_train_step
    from repro_torch.launch.train import make_loss_and_data
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.optimizer import adamw_init

    cfg, params, _, data = make_loss_and_data(arch_id, True, 8, 8, 0,
                                              device="cpu")
    batch = next(data)
    out = {}
    for dev in ("cpu", "cuda", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        out.setdefault(dev, []).append(
            gnn_train_step(arch_id, cfg, p, adamw_init(p), batch.to(dev)))
    (cpu,), (a, b) = out["cpu"], out["cuda"]
    assert abs(float(a[2]) - float(cpu[2])) <= 1e-5 * abs(float(cpu[2]))
    for x, y in zip(tree_leaves(a[0]), tree_leaves(cpu[0])):
        assert float((x.cpu() - y).abs().max()) <= 1e-5
    assert torch.equal(a[2], b[2])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[0]),
                                                  tree_leaves(b[0])))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 512])
def test_gnn_sharded_scatter_sum_at_world_size_one_on_card(card, d,
                                                           tmp_path):
    """`scatter_sum` under `gnn_rules` on one NCCL rank (a (1, 1) mesh: the
    ordered sum, then a reduce-scatter over a group of one) against the
    one-process sum on the card, bit for bit, and the take's backward
    (the node table's reduce-scatter of the ordered sum) likewise."""
    import _dist_ranks

    rng = np.random.default_rng(d + 1)
    E, n = 40_000, 30_000
    idx = np.minimum(rng.zipf(1.5, E) - 1, n - 1)
    idx[rng.random(E) < 0.6] = 0
    v = rng.normal(size=(E, d)).astype(np.float32)
    (got,) = _dist_ranks.run_ranks(
        _dist_ranks.run_cases,
        {"sum": ("case_stripe_sum", dict(index=idx, values=v, n=n,
                                         device="cuda"))},
        1, tmp_path, backend="nccl")
    sharded, one, grad = got["sum"]
    np.testing.assert_array_equal(sharded, one)
    np.testing.assert_array_equal(grad, one)


# ---------------------------------------------------------------------------
# The dry run's view of K6 and K5 (src/repro_torch/launch/dryrun.py): their
# FLOP formulas on the card's own launches, and their shape rule for meta
# tensors against the real outputs of every case above.
# ---------------------------------------------------------------------------

# (case table, case, dtype): a causal bf16 prefill, a windowed one, the
# split-KV decode
K6_FLOP_CASES = {"causal": (FLASH_CASES, "prefill", torch.bfloat16),
                 "window": (WINDOW_CASES, "prefill_w100", torch.bfloat16),
                 "decode": (FLASH_CASES, "long_decode", torch.bfloat16)}


def _flash_inputs(table, case, device, dtype, seed=31):
    if table is WINDOW_CASES:
        B, Sq, Skv, H, Hkv, D, q_offset, kv_len, window = table[case]
        causal = True
    else:
        B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal = table[case]
        window = None
    kv_len = Skv if kv_len is None else kv_len
    q_offset = kv_len - Sq if q_offset is None else q_offset
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(device, dtype)
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    return q, k, v, (causal, q_offset, kv_len, window)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K6_FLOP_CASES))
def test_flash_attention_flops_on_card(card, name):
    """`FlopCounterMode` over one K6 launch on the card counts the tiles
    the kernel's loops multiply (tests/_k6_tiles.py), not the S × S
    product; the output equals the plain version's."""
    from torch.utils.flop_counter import FlopCounterMode

    from _k6_tiles import kernel_pairs
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    table, case, dtype = K6_FLOP_CASES[name]
    q, k, v, (causal, q_offset, kv_len, window) = _flash_inputs(
        table, case, card, dtype)
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    before = fa_cuda.LAUNCHES
    with FlopCounterMode(display=False) as fc:
        got = fa_ops.flash_attention(q, k, v, prefer="cuda", **kw)
    torch.cuda.synchronize()
    assert fa_cuda.LAUNCHES == before + 1
    want = 4 * D * B * Hkv * kernel_pairs(Sq, H // Hkv, D, q_offset, kv_len,
                                          causal, window, True)
    assert fc.get_total_flops() == want > 0
    if Sq > 16:        # prefill: the masked tiles are skipped
        assert want < 4 * D * B * H * Sq * kv_len
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        fa_ref.flash_attention_plain(q, k, v, **kw).float().cpu().numpy(),
        **_FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BAG_CASES))
def test_embedding_bag_flops_on_card(card, case):
    """`FlopCounterMode` over one K5 launch counts two FLOPs an element of
    each entry's row: the kernel's tile loop visits every entry once."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.embedding_bag import ops as eb_ops

    table, idx, seg, w, B, kind = _bag_case(case, card, torch.float32)
    before = eb_cuda.LAUNCHES
    with FlopCounterMode(display=False) as fc:
        eb_ops.embedding_bag(table, idx, seg, B, weights=w,
                             assume_sorted=kind != "unsorted", prefer="cuda")
    torch.cuda.synchronize()
    assert eb_cuda.LAUNCHES == before + 1
    assert fc.get_total_flops() == 2 * idx.numel() * table.shape[1]


def _meta_like(t):
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device="meta")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [("flash", c) for c in FLASH_CASES]
                         + [("window", c) for c in WINDOW_CASES])
def test_flash_attention_meta_shape_matches_card(card, case, dtype):
    """K6's shape rule on meta tensors gives the card's output: its shape,
    type and (contiguous) strides."""
    kind, name = case
    table = FLASH_CASES if kind == "flash" else WINDOW_CASES
    q, k, v, args = _flash_inputs(table, name, card, dtype)
    real = torch.ops.repro_torch.flash_attention(q, k, v, *args)
    meta = torch.ops.repro_torch.flash_attention(
        _meta_like(q), _meta_like(k), _meta_like(v), *args)
    assert meta.device.type == "meta"
    assert (meta.shape, meta.dtype, meta.stride()) == (real.shape, real.dtype,
                                                       real.stride())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(BAG_CASES))
def test_embedding_bag_meta_shape_matches_card(card, case, dtype):
    """K5's shape rule on meta tensors gives the card's output."""
    table, idx, seg, w, B, kind = _bag_case(case, card, dtype)
    if kind == "unsorted":
        order = torch.argsort(seg, stable=True)
        idx, seg, w = idx[order], seg[order], w[order]
    real = torch.ops.repro_torch.embedding_bag(table, idx, seg, w, B)
    meta = torch.ops.repro_torch.embedding_bag(
        *(_meta_like(t) for t in (table, idx, seg, w)), B)
    assert meta.device.type == "meta"
    assert (meta.shape, meta.dtype, meta.stride()) == (real.shape, real.dtype,
                                                       real.stride())
