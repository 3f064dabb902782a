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
fp32; the smoke SASRec on the card to the CPU run: user states within
1e-5, streamed top-100 ids identical.  Training: K6 with a sliding window
on its three routes against the plain mask; K6's and K5's gradients
against autograd through their plain versions, K5's bit-identical twice;
a smoke LM and a smoke SASRec train step bit-identical twice.  The GNNs
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
    plain recompute's backward) against autograd through the plain
    version on the card: the same plain gradient, summed over the
    backward's query blocks in another order (fp32 1e-5, bf16 2e-2 of each
    gradient's max)."""
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

    before = fa_cuda.LAUNCHES
    got = grads("auto")
    assert fa_cuda.LAUNCHES == before + 1
    want = grads("ref")
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


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
