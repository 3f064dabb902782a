#!/usr/bin/env python3
"""Drive the PyTorch port (`repro_torch`, under src/) on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # no full-size runs (phases 5-7)

Phases, each printing JSON lines:

1. ``device``  — the card's name, and ``nvidia-smi``'s name and power limit
   (also printed raw on a line of its own).
2. ``build``   — compile K1 and K2 (both in kernels/ell_spmv/csrc/
   ell_spmv.cu), K3 and K4 (both in kernels/segment_sum/csrc/
   segment_sum.cu), K6 (kernels/flash_attention/csrc/flash_attention.cu)
   and K5 (kernels/embedding_bag/csrc/embedding_bag.cu) from the
   checkout's sources, one nvcc per source (sm_90a), all started together;
   seconds and the compiler's register report for every kernel.
3. ``kernels`` — each kernel against its plain PyTorch version on the card,
   in fp32 (tolerance 1e-5) and bf16 (2e-2) of each row's Σ|vals·x| (the
   size of the terms the two fp32 sums add in another order), timed by
   CUDA events (50 calls
   queued back to back, median of 20 such rounds, after 10 warm-up calls)
   beside its bound and cuSPARSE's CSR product (block-diagonal for K2).
   K1 at the main path's shape (the root level's packed operator of
   ``box_mesh(80, 64, 48)``: N = 262144, w = 32) and at a ragged N = 1000,
   w = 27; then one packed Lanczos restart at the main shape: its time and,
   from `torch.profiler`, the CUDA kernels it issues.  K2 at the inverse
   path's shapes: ``main`` (the level-5 operator of the full box: 32 blocks
   of 7,680 elements, (32, 32, 8192)), ``level0`` ((1, 32, 262144)), two
   ragged shapes and ``amg_coarsest`` (the last `BatchedAMG` level of the
   main shape, launch-bound), with K2's device time per launch at ``main``
   and ``level0`` from `torch.profiler`; then one AMG-preconditioned flexcg
   iteration at the main shape: its time, CUDA kernels and K2 launches.
   Every timing is taken before the first profiler session.
4. ``quality`` — the quality mesh (``pebble_mesh(12, 12, 12, n_pebbles=5,
   warp=0.15, seed=1)``, 1,669 elements) into 16 parts with the
   ``default``, ``raw`` and ``geometric`` presets and with inverse iteration
   (``partitioner="rsb_inverse"``, Jacobi and AMG) on the card, checked
   against the port on the CPU (the plain matvecs), the JAX cut recorded in
   BENCH_partition.json (8918), and the invariants; then
   ``pebble_mesh(10, 10, 10, n_pebbles=6, seed=0)`` into 8 parts by inverse
   iteration, against BENCH_partition.json's ``partition_time_smoke`` cuts.
   Then the k-way presets (``kway``, ``quality``, ``quality-kway``) on the
   quality mesh, card against CPU and ``kway`` against the recorded JAX cut
   (8764); and the sharded refinement protocol of
   ``benchmarks/partition_time.py::run_sharded`` on the 959-element mesh
   (Lanczos raw labels, then ``repair+refine``, ``repair+refine-sharded``
   and ``kway-sharded``, 8 sweeps): card labels against the CPU's from the
   same raw labels, cuts against the recorded JAX cuts (4690 / 4679 /
   4319), K4 launches against the sweeps run.
5. ``full``    — ``box_mesh(80, 64, 48)`` (245,760 elements) into 64 parts,
   ``default`` preset (Lanczos, K1), on the card: seconds per stage (host
   and device), per level, K1 launches, peak device memory, the cut against
   the ``geometric`` preset's.
6. ``full_inverse`` — the same box and parts by AMG-preconditioned inverse
   iteration (the paper's solver, K2): the same records plus inner flexcg
   iterations per level; the cut against the ``geometric`` cut of ``full``.
7. ``full_sharded`` — the post chains of ``run_sharded`` on ``full``'s raw
   labels (no second eigensolve): ``repair+refine`` on the host, then
   ``repair+refine-sharded`` and ``kway-sharded`` (8 sweeps, K4 every
   sweep) on the card: seconds split into plan build, sweeps and host
   admission, halo, w, m, moves and K4 launches per sweep, peak memory,
   cuts; the sharded cut within 1% of the host refined cut; the card's
   sweep labels against the NumPy mirror's on the same plan, from the raw
   labels and from a seeded perturbation of them (2% of the elements).
8. ``kernels`` (segment_sum) — K4 at the sweep's shape (``main``: the
   frontier plan of ``full``'s raw labels, 64 shards; with ``--quick``,
   of RCB labels of the same box) and a tiny one, K3 at
   ``benchmarks/kernels.py``'s shape and at ``main``'s first shard, each
   against the plain version (equal bit for bit on integer and on random
   fp32 weights), timed by the profiler's device time (by CUDA events
   where the profiler traces no kernel, as ``dev_ms_by`` says) and by
   CUDA events, beside the bound, the plain version and one
   ``index_add_`` of the same weights by CUDA events (``library_ms``) and
   by the profiler over all its kernels (``library_dev_ms``).

9. ``kernels`` (flash_attention) — K6 against its plain version
   (`ref.flash_attention_plain`) in fp32 (2e-5) and bf16 (2e-2, atol and
   rtol as tests/test_kernels.py's ``_tol``) at the serve path's shapes
   (tinyllama: H = 32, Hkv = 4, D = 64; ``prefill`` B=4, S=512,
   ``long_prefill`` B=1, S=4096, ``decode`` B=4 over a 576-row cache with
   kv_len 575, ``continuation`` 128 queries after a 512-row cached prefix,
   ``long_decode`` one query over 4096 rows), at tests/test_kernels.py's
   five shapes and one non-causal call: error, CUDA-event ms, profiler
   device ms, TFLOP/s, the kernel that ran (every bf16 call with Sq·G > 16
   must run ``flash_attention_kernel_bf16``, every call with Sq·G <= 16,
   fp32 and bf16, the split-KV ``flash_attention_kernel_decode``),
   the bound, the plain version's ms and one
   ``scaled_dot_product_attention`` call's ms by events (``library_ms``)
   and by the profiler over all its kernels (``library_dev_ms``; keys
   sliced to kv_len, an explicit mask where the queries are not top-left
   aligned).
10. ``serve`` — `tinyllama-1.1b` at full width (``make_config()``, bf16,
    parameters from a seeded generator) through `launch.serve.generate`:
    ``requests`` (batch 4, prompt 512, 64 greedy steps) and ``long``
    (batch 1, prompt 4096, 16 steps), each with prefill ms, decode ms,
    tok/s, p50/p99 step ms, peak memory and K6 launches (= 22 x steps);
    a profile of one ``requests`` prefill and decode step and of one
    ``long`` decode step over its 4096 cached rows (CUDA kernels, device
    ms, K6's share); and three checks: (a) the K6 model's prefill and
    decode logits against the same model with the plain attention
    (``attn_prefer="ref"``) on the card, max |Δ| ≤ 3e-2 of max |logit|;
    (b) the last of 7 decode steps (and the prefill before them) against
    a full `forward` over the same tokens, ≤ 5e-2 of max |logit| (bf16
    through 22 layers: two GEMM shapes round differently); (c) the smoke
    config in fp32: greedy tokens on the card identical to the CPU's,
    logits within 1e-3.
11. ``kernels`` (embedding_bag) — K5 against its plain version
    (`ref.embedding_bag_ref`) in fp32 and bf16: over SASRec's full table
    (1,000,448 × 50) ``lookup`` (``serve_p99``'s 25,600 items, bags of
    one, weight √50), ``retrieval`` (10^6 bags of one, a seeded
    permutation of the items), ``bulk`` (``serve_bulk``'s chunk: 8,192
    users × 50 Zipf items, 409,600 bags of one, weight √50) and
    ``pooled`` (65,536 bags of 1-64 Zipf items, weighted); then
    tests/test_kernels.py's three shapes, its weighted unsorted case and a
    case with empty bags.  fp32 bags of one
    bit-equal to ``table[idx]·w``, otherwise within 1e-5 (fp32) or 2e-2
    (bf16) of each bag's Σ|w·row|, empty bags zero; error, CUDA-event ms,
    profiler device ms, the bound (idx, seg and w once, each distinct row
    once, the output once, over 3.35 TB/s; ``bound_ms_all_rows`` counts
    every entry's row), the plain version's ms and one
    ``F.embedding_bag(mode="sum", per_sample_weights=...)`` call's ms
    (``library_ms``, offsets by ``searchsorted``).
12. ``recsys`` — `sasrec` at its published widths (``make_config()``,
    fp32, parameters from a seeded generator; the table is 200,089,600 B)
    through `launch.cells`: ``serve_p99`` (512 users, top-100 over every
    table row in 64 slices) and ``retrieval_cand`` (1 user, 10^6
    candidates), 30 calls each: p50/p99 ms, users/s, peak memory, K5
    launches (1 and 2 a call); ``serve_bulk`` (262,144 users in 32 chunks
    of 8,192) once: wall s, users/s, peak memory, 32 K5 launches; a
    profile of one ``serve_p99`` call, after one unrecorded call in the
    same profiler session (CUDA kernels, device ms, K5's share, busy
    share); and three checks: (a) user states with K5 equal
    to the plain lookup's (``bag_prefer="ref"``) bit for bit; (b) the
    streamed top-100 of ``serve_p99`` against ``torch.topk`` of the full
    (512, 1,000,448) score matrix: values within 1e-5, ids equal where the
    scores are more than 1e-5 apart; (c) the smoke config, left-padded
    users, on the card against the CPU: states within 1e-5, top-100 ids
    identical.

Then the line ``{"kernels": [...]}`` (every ported kernel: launches on its
main path — K1 in ``full``, K2 in ``full_inverse``, K4 in the two sharded
chains of ``full_sharded``, K3 on none, K6 in the two ``serve`` runs, K5
in the three ``recsys`` runs, with the counters set to 0 just before each
— error against the plain version, times and bound), the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits nonzero without the last line; so does a
machine without a CUDA card, or a directory that lacks the repository's
src/.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
QUALITY_JAX_CUT = 8918.0      # BENCH_partition.json, quality, rsb_weighted
QUALITY_KWAY_JAX_CUT = 8764.0  # BENCH_partition.json, quality, rsb_weighted_kway
SMOKE_INV_RAW, SMOKE_INV_CUT = 4891.0, 4626.0   # partition_time_smoke, inverse
# BENCH_partition.json, partition_sharded: the three chains' JAX cuts
SHARDED_JAX_CUTS = {"repair+refine": 4690.0, "repair+refine-sharded": 4679.0,
                    "kway-sharded": 4319.0}
SHARDED_CHAINS = {"repair+refine": (("repair", "refine"), {}),
                  "repair+refine-sharded": (("repair", "refine-sharded"),
                                            {"sweeps": 8}),
                  "kway-sharded": (("kway-sharded",), {"sweeps": 8})}
N_SLOTS = 262144              # next_pow2(245,760): the full run's packed size
K2_BLOCKS, K2_BLOCK = 32, 7680    # tree level 5 of the 64-part run
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
INVERSE_AMG = dict(method="inverse", precond="amg")
# K6 cases: (B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal); None = the
# end-aligned default of `ops.flash_attention`.
FLASH_CASES = {
    "prefill": (4, 512, 512, 32, 4, 64, None, None, True),
    "long_prefill": (1, 4096, 4096, 32, 4, 64, None, None, True),
    "decode": (4, 1, 576, 32, 4, 64, 574, 575, True),
    "k1": (2, 64, 64, 4, 2, 32, None, None, True),
    "k2": (1, 100, 100, 4, 4, 64, None, None, True),
    "k3": (2, 1, 200, 8, 2, 64, None, None, True),
    "k4": (1, 128, 256, 4, 1, 32, None, None, True),
    "k5": (1, 48, 48, 2, 2, 128, None, None, True),
    "noncausal": (2, 64, 96, 4, 2, 32, None, None, False),
    # a prefill chunk after a cached prefix of 512 rows
    "continuation": (1, 128, 700, 32, 4, 64, 512, 640, True),
    # the `long` serve run's decode step over its 4096 rows
    "long_decode": (1, 1, 4096, 32, 4, 64, 4095, 4096, True),
}
# bf16 calls with more than this many flattened (position, head) rows take
# K6's bf16 prefill kernel; calls with at most this many, fp32 and bf16,
# its split-KV decode kernel
FLASH_DECODE_ROWS = 16
FLASH_PREFILL_KERNEL = "flash_attention_kernel_bf16"
FLASH_DECODE_KERNEL = "flash_attention_kernel_decode"
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# serve runs: (batch, prompt_len, steps)
SERVE_RUNS = {"requests": (4, 512, 64), "long": (1, 4096, 16)}
SERVE_TOL_REF = 3e-2       # (a) K6 model vs plain-attention model, bf16
SERVE_TOL_FORWARD = 5e-2   # (b) decode vs full forward, bf16
# K5 cases: name → (n_bags, kind); "lookup", "retrieval" and "pooled" run
# over SASRec's full table (make_config(): 1,000,448 × 50), the rest over
# tables of their own (V, d).
BAG_CASES = {
    "lookup": dict(kind="sequence"),          # serve_p99's 512 × 50 items
    "retrieval": dict(kind="candidates"),     # 10^6 candidates
    "bulk": dict(kind="bulk"),                # serve_bulk's 8,192 × 50 items
    "pooled": dict(kind="pooled"),            # 65,536 bags of 1-64 rows
    "sweep_a": dict(kind="sorted", V=100, d=16, nnz=64, B=10),
    "sweep_b": dict(kind="sorted", V=500, d=50, nnz=300, B=32),
    "sweep_c": dict(kind="sorted", V=64, d=128, nnz=128, B=8),
    "weighted_unsorted": dict(kind="unsorted", V=80, d=24, nnz=100, B=12),
    "empty": dict(kind="empty", V=300, d=50, nnz=400, B=90),
}
RECSYS_REPS = 30           # serve_p99 and retrieval_cand calls each
BULK_CHUNK = 8192          # users a serve_bulk chunk (recsys_serve_topk)
RECSYS_K = 100
RECSYS_STATE_TOL = 1e-5    # (c) smoke states, card vs CPU
RECSYS_TOPK_TOL = 1e-5     # (b) streamed vs full top-k values


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke check failed: {what}")


def time_ms(fn, reps: int = 50, rounds: int = 20, warmup: int = 10) -> float:
    """Device time of one call in ms: ``reps`` calls queued back to back
    between two CUDA events (so the card does not wait on the host between
    calls), divided by ``reps``; the median over ``rounds``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / reps)
    return statistics.median(per_call)


def wall_s(fn, reps: int = 3) -> float:
    """Host seconds of one call that ends in a device sync (median)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def csr_of(cols_t, vals_t):
    """The same matrix as a CSR tensor (nonzeros only) for cuSPARSE; a
    batched (B, w, n) operator becomes its block-diagonal (B·n, B·n) CSR."""
    if cols_t.ndim == 3:
        B, w, n = cols_t.shape
        offs = (torch.arange(B, device=cols_t.device) * n).view(B, 1, 1)
        cols_t = (cols_t.long() + offs).permute(1, 0, 2).reshape(w, B * n)
        vals_t = vals_t.permute(1, 0, 2).reshape(w, B * n)
    w, n = cols_t.shape
    nz = vals_t != 0
    rows = torch.arange(n, device=cols_t.device).expand(w, n)[nz]
    cols = cols_t.long()[nz]
    vals = vals_t[nz]
    order = torch.argsort(rows * n + cols)
    rows, cols, vals = rows[order], cols[order], vals[order]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=cols_t.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, cols, vals, size=(n, n))


def kernel_cases(tag, cases, kernel, plain):
    """Each case (c, v32, x32) against the plain version in fp32 and bf16,
    with its times, bound and (fp32) cuSPARSE time.  Works for K1 (2-D
    slabs) and K2 (3-D slabs: B problems).

    Both versions accumulate in fp32 in another order, so a row's
    difference is bounded by the size of its terms, not of its sum: the
    check is |kernel − plain| ≤ tol · Σ_k |vals·x| per row.  (On the coarse
    AMG levels the terms are sums of many fine edge weights and cancel;
    there |y| says nothing about the rounding.)"""
    rows = []
    for case, (c, v32, x32) in cases.items():
        B = c.shape[0] if c.ndim == 3 else 1
        w, n = c.shape[-2:]
        for dtype in (torch.float32, torch.bfloat16):
            v, x = v32.to(dtype), x32.to(dtype)
            got = kernel(c, v, x)
            want = plain(c, v, x)
            size = plain(c, v.float().abs(), x.float().abs())
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            rel = float((diff / size.clamp(min=1e-30)).max())
            check(rel <= TOL[dtype],
                  f"{tag} {case} {dtype}: max err {err}, {rel} of Σ|vals·x|")
            nbytes = (4 + v.element_size()) * B * n * w \
                + 2 * x.element_size() * B * n
            bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ops_ms = 2 * B * n * w / FP32_FLOPS_PER_S * 1e3
            row = dict(case=case, dtype=str(dtype).split(".")[-1], B=B, n=n,
                       w=w, nnz=int((v32 != 0).sum()), max_abs_err=err,
                       max_err_of_terms=rel,
                       kernel_ms=time_ms(lambda: kernel(c, v, x)),
                       ref_ms=time_ms(lambda: plain(c, v, x)),
                       bound_ms=max(bound_bytes_ms, bound_ops_ms),
                       bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                       else "operations",
                       bytes=nbytes, library_ms=None)
            if dtype == torch.float32:
                A = csr_of(c, v)
                xf = x.reshape(-1)
                lib = A @ xf
                torch.cuda.synchronize()
                lib_diff = (lib - want.reshape(-1)).abs()
                check(bool((lib_diff <= 1e-4 * size.reshape(-1)).all()),
                      f"cuSPARSE {tag} {case} disagrees with the plain version")
                row["library_ms"] = time_ms(lambda: A @ xf)
            row["kernel_GBps"] = nbytes / (row["kernel_ms"] * 1e-3) / 1e9
            rows.append(row)
    return rows


def device_profile(fn, warmup: int = 0) -> dict:
    """CUDA kernels one call of ``fn`` issues, by name, from torch.profiler:
    {name: [count, device ms]}.  With ``warmup`` > 0 the session first
    runs ``fn`` that many times unrecorded (a profiler schedule): a
    session can lose the first kernels it sees."""
    from torch.profiler import ProfilerActivity, profile, schedule

    sched = schedule(wait=0, warmup=warmup, active=1) if warmup else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        for i in range(warmup + 1):
            fn()
            torch.cuda.synchronize()
            if i < warmup:
                prof.step()
    by_name: dict = {}
    for e in prof.events():
        # a schedule's step marker is a device-side range, not a kernel
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.name.startswith("ProfilerStep"):
            d = by_name.setdefault(e.name, [0, 0.0])
            d[0] += 1
            d[1] += e.time_range.elapsed_us() / 1e3
    return by_name


def profiled_ms(fn, kernel_name, calls=20, sessions=2):
    """Device ms per launch of the CUDA kernel whose name holds
    ``kernel_name``, over ``calls`` calls of ``fn`` in one torch.profiler
    session, the number of CUDA events that session traced, and the
    kernel's full name.  The profiler does not trace the card on every
    machine (it has traced nothing there while the kernel ran and matched
    its plain version), so a session that misses the kernel is tried
    again, and after ``sessions`` misses the time and name are None: the
    caller then reports the CUDA-event time."""
    for _ in range(sessions):
        by_name = device_profile(lambda: [fn() for _ in range(calls)])
        k = [(n, v) for n, v in by_name.items() if kernel_name in n]
        traced = sum(v[0] for v in by_name.values())
        if k:
            name, (count, ms) = k[0]
            return ms / count, traced, name
    return None, traced, None


def profiled_call_ms(fn, calls=20, sessions=3):
    """Device ms of one call of ``fn``: every CUDA kernel's device ms over
    ``calls`` calls in one torch.profiler session (after ``calls`` calls
    unrecorded), summed and divided by ``calls``.  A session is taken only
    where each kernel's launch count is a whole multiple of ``calls`` (the
    profiler can trace a session in part); one that is not is tried
    again, and after ``sessions`` such the result is None."""
    for _ in range(sessions):
        by_name = device_profile(lambda: [fn() for _ in range(calls)],
                                 warmup=1)
        if by_name and all(n % calls == 0 for n, _ in by_name.values()):
            return sum(ms for _, ms in by_name.values()) / calls
    return None


def top_kernels(by_name, k=8):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:k]
    return [dict(name=n[:80], count=v[0], ms=v[1]) for n, v in top]


def phase_kernels(root):
    """K1 at the main path's shapes and one packed Lanczos restart at the
    main shape (level 0: one problem, the segment count pinned to 64 as in
    the 64-part run), timed.  Returns the rows and a function that profiles
    the restart and emits the phase line (profiles come after every timing:
    a torch.profiler session can leave launch overhead behind)."""
    from repro_torch.core.fiedler import _pack_layout, _packed_ell_laplacian
    from repro_torch.core.lanczos import _packed_restart, _seg_onehot
    from repro_torch.kernels.ell_spmv import cuda, ref

    t0 = time.perf_counter()
    offs, N, n_seg, seg, mask = _pack_layout([root.n], N_SLOTS, 64)
    op = _packed_ell_laplacian([root], offs, N, 32, device="cuda")
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=N).astype(np.float32)).cuda()
    cases = {"main": (op.cols_t, op.vals_t, x / torch.linalg.vector_norm(x))}
    cols = torch.from_numpy(rng.integers(0, 1000, (27, 1000)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(27, 1000)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=1000).astype(np.float32))
    cases["ragged"] = (cols.cuda(), vals.cuda(), x.cuda())
    rows = kernel_cases("K1", cases, cuda.ell_spmv_cuda, ref.ell_spmv_ref)

    seg_d = torch.from_numpy(seg.astype(np.int64)).cuda()
    mask_d = torch.from_numpy(mask).cuda()
    S = _seg_onehot(seg_d, n_seg, torch.float32)
    count = torch.clamp(S @ mask_d, min=1.0)
    q = torch.from_numpy(rng.normal(size=N).astype(np.float32)).cuda() * mask_d
    q = q / torch.linalg.vector_norm(q)

    def restart():
        return _packed_restart(op, q, mask_d, seg_d, S, count, 20)

    before = cuda.LAUNCHES
    restart()
    torch.cuda.synchronize()
    k1_per_restart = cuda.LAUNCHES - before
    restart_ms = time_ms(restart, reps=2, rounds=5, warmup=2)

    def profile_and_emit():
        by_name = device_profile(restart)
        k1 = [v for k, v in by_name.items() if "ell_spmv_kernel" in k]
        emit("kernels", kernel="ell_spmv", setup_seconds=setup_s, cases=rows,
             restart=dict(
                 window=20, N=N, n_seg=n_seg, ms=restart_ms,
                 k1_launches=k1_per_restart,
                 k1_profiled_ms_per_launch=k1[0][1] / k1[0][0] if k1 else None,
                 cuda_kernels=sum(v[0] for v in by_name.values()) or None,
                 device_ms=sum(v[1] for v in by_name.values()) or None,
                 top=top_kernels(by_name)))

    return rows, profile_and_emit


def phase_kernels_batched(root):
    """K2 at the inverse path's shapes and one AMG-preconditioned flexcg
    iteration at the main shape, timed.  Returns the rows and a function
    that profiles them and emits the phase line."""
    from repro_torch.core.amg import amg_setup_batched
    from repro_torch.core.flexcg import flexcg
    from repro_torch.core.laplacian import ell_laplacian_batched
    from repro_torch.kernels.ell_spmv import cuda, ref
    from repro_torch.mesh.graphs import extract_subgraphs

    t0 = time.perf_counter()
    subs = extract_subgraphs(root, [np.arange(b * K2_BLOCK, (b + 1) * K2_BLOCK)
                                    for b in range(K2_BLOCKS)])
    n_pad = 1 << (K2_BLOCK - 1).bit_length()
    op = ell_laplacian_batched(subs, n_pad, 32, K2_BLOCKS, device="cuda")
    op0 = ell_laplacian_batched([root], N_SLOTS, 32, 1, device="cuda")
    pre = amg_setup_batched(subs, n_pad, K2_BLOCKS, device="cuda")
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)

    def unit_x(B, n):
        x = torch.from_numpy(rng.normal(size=(B, n)).astype(np.float32)).cuda()
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    coarse = pre.ops[-1]
    cases = {"main": (op.cols_t, op.vals_t, unit_x(K2_BLOCKS, n_pad)),
             "level0": (op0.cols_t, op0.vals_t, unit_x(1, N_SLOTS))}
    for B, n, w in ((3, 1000, 5), (4, 128, 27)):
        cols = rng.integers(0, n, (B, w, n)).astype(np.int32)
        vals = rng.normal(size=(B, w, n)).astype(np.float32)
        cases[f"ragged_{B}x{n}x{w}"] = (torch.from_numpy(cols).cuda(),
                                         torch.from_numpy(vals).cuda(),
                                         unit_x(B, n))
    cases["amg_coarsest"] = (coarse.cols_t, coarse.vals_t,
                             unit_x(K2_BLOCKS, coarse.n))
    rows = kernel_cases("K2", cases, cuda.ell_spmv_batched_cuda,
                        ref.ell_spmv_batched_ref)

    # One AMG-preconditioned flexcg iteration at the main shape: tol 0 keeps
    # every problem active, so maxiter iterations run (a multiple of the
    # loop's flag-read cadence, 4, so no frozen pass follows).  Differences
    # of maxiter = 8 and 4 (24 and 4 for the time) leave the loop body alone,
    # with its share of the flag reads, as the main path runs it.
    mask = torch.zeros(K2_BLOCKS, n_pad, device="cuda")
    mask[:, :K2_BLOCK] = 1.0
    b = unit_x(K2_BLOCKS, n_pad) * mask

    def cg(m):
        return flexcg(op, b, precond=pre, mask=mask, tol=0.0, maxiter=m)

    counts = []
    for m in (4, 8):
        before = cuda.BATCHED_LAUNCHES
        check(int(cg(m).iters.min()) == m, f"flexcg ran {m} iterations")
        counts.append(cuda.BATCHED_LAUNCHES - before)
    k2_per_iter = (counts[1] - counts[0]) / 4
    check(k2_per_iter > 0, "flexcg iteration: K2 never launched")
    iter_ms = (wall_s(lambda: cg(24)) - wall_s(lambda: cg(4))) / 20 * 1e3

    def profile_and_emit():
        # K2's device time per launch at the two 69 MB shapes: unlike the
        # queued event timing, it does not depend on how fast the host can
        # launch.  Then the `main` row's event timing again, after profiler
        # sessions.
        profiled = {}
        for case in ("main", "level0"):
            args = cases[case]
            by_name = device_profile(
                lambda: [cuda.ell_spmv_batched_cuda(*args) for _ in range(20)])
            k2 = [cnt_ms for name, cnt_ms in by_name.items()
                  if "ell_spmv_batched_kernel" in name]
            profiled[case] = k2[0][1] / k2[0][0] if k2 else None
        main_after = time_ms(lambda: cuda.ell_spmv_batched_cuda(*cases["main"]))
        p4, p8 = device_profile(lambda: cg(4)), device_profile(lambda: cg(8))
        per_iter = {k: [(v[0] - p4.get(k, [0, 0.0])[0]) / 4,
                        (v[1] - p4.get(k, [0, 0.0])[1]) / 4]
                    for k, v in p8.items()}
        k2 = [v for k, v in p8.items() if "ell_spmv_batched_kernel" in k]
        emit("kernels", kernel="ell_spmv_batched", setup_seconds=setup_s,
             amg_levels=len(pre.ops), amg_sizes=list(pre.sizes), cases=rows,
             profiled_ms_per_launch=profiled, main_ms_after_profiler=main_after,
             flexcg_iteration=dict(
                 B=K2_BLOCKS, n_pad=n_pad, ms=iter_ms, k2_launches=k2_per_iter,
                 k2_profiled_ms_per_launch=k2[0][1] / k2[0][0] if k2 else None,
                 cuda_kernels=sum(v[0] for v in per_iter.values()),
                 device_ms=sum(v[1] for v in per_iter.values()),
                 top=top_kernels(per_iter)))

    return rows, profile_and_emit


def run_preset(preset, mesh, nparts, device, **overrides):
    from repro_torch.configs.parrsb import make_pipeline
    from repro_torch.core.metrics import partition_metrics
    from repro_torch.core.refine import balance_corridor

    t0 = time.perf_counter()
    ctx = make_pipeline(preset, device=device, **overrides).run(mesh, nparts)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pm = partition_metrics(ctx.require_graph(), ctx.parts, nparts,
                           weights=mesh.weights)
    floor, cap = balance_corridor(ctx.parts_raw, nparts, mesh.weights, 0.05)
    pw = np.bincount(ctx.parts, weights=mesh.weights, minlength=nparts)
    return ctx, pm, wall, bool(pw.min() >= floor and pw.max() <= cap), \
        int((np.bincount(ctx.parts, minlength=nparts) > 0).sum())


def stage_split(ctx) -> list:
    out = []
    for s in ctx.stages:
        dev = float(s.info.get("device_seconds", 0.0))
        out.append(dict(kind=s.kind, name=s.name, seconds=s.seconds,
                        device_seconds=dev, host_seconds=s.seconds - dev))
    return out


def level_rows(ctx) -> list:
    return [dict(level=lv.level, nodes=lv.n_nodes, buckets=lv.buckets,
                 iterations=lv.iterations, inner_iterations=lv.inner_iterations,
                 order_s=lv.order_seconds, solve_s=lv.solve_seconds,
                 device_s=lv.device_seconds, split_s=lv.split_seconds)
            for lv in ctx.report.levels]


def run_chains(graph, raw, nparts, weights, device) -> dict:
    """`run_sharded`'s post chains from one set of raw labels on ``device``:
    per chain the labels, cut, invariants, seconds (split for the sharded
    stage into plan build, sweeps and host admission), moves per sweep,
    K4 launches and peak device memory."""
    from repro_torch.core.metrics import partition_metrics
    from repro_torch.core.pipeline import run_post_stages
    from repro_torch.core.refine import balance_corridor
    from repro_torch.kernels.segment_sum import cuda as ss_cuda

    floor, cap = balance_corridor(raw, nparts, weights, 0.05)
    out = {}
    for name, (post, kw) in SHARDED_CHAINS.items():
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = ss_cuda.BATCHED_LAUNCHES
        t0 = time.perf_counter()
        parts, agg, records = run_post_stages(graph, raw, nparts, post,
                                              weights=weights,
                                              post_kw=dict(kw), device=device)
        wall = time.perf_counter() - t0
        pm = partition_metrics(graph, parts, nparts, weights=weights)
        pw = np.bincount(parts, weights=weights, minlength=nparts)
        row = dict(parts=parts, cut=pm.edge_cut,
                   disconnected=pm.disconnected_parts,
                   corridor=bool(pw.min() >= floor and pw.max() <= cap),
                   nonempty=int((np.bincount(parts, minlength=nparts) > 0).sum()),
                   seconds=wall, k4_launches=ss_cuda.BATCHED_LAUNCHES - before,
                   stages=[dict(name=r.name, seconds=r.seconds) for r in records],
                   moves_per_sweep=[r.moves for r in agg.sweeps])
        sharded = [r.info["sharded"] for r in records if "sharded" in r.info]
        if sharded:
            info = sharded[0]
            stage_s = next(r.seconds for r in records if "sharded" in r.info)
            row.update(gathers=info["gathers"], sweeps_run=len(agg.sweeps),
                       k4_per_sweep=row["k4_launches"] / max(info["gathers"], 1),
                       halo=info["halo"], w=info["w"], m=info["m"],
                       plan_s=info["plan_seconds"],
                       sweeps_s=info.get("sweep_seconds"),
                       admit_s=info.get("admit_seconds"),
                       rest_s=stage_s - info["plan_seconds"]
                       - info.get("sweep_seconds", 0.0))
        if device == "cuda":
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out[name] = row
    return out


def check_chains(tag, runs, nparts) -> None:
    host = runs["repair+refine"]["cut"]
    for name, r in runs.items():
        check(r["disconnected"] == 0 and r["corridor"] and r["nonempty"] == nparts,
              f"{tag} {name}: disconnected parts, corridor or an empty part")
        if name == "repair+refine":
            continue
        check(r["k4_launches"] == r["gathers"] == r["sweeps_run"] > 0,
              f"{tag} {name}: K4 launches {r['k4_launches']}, gathers "
              f"{r['gathers']}, sweeps {r['sweeps_run']}")
        if name == "repair+refine-sharded":
            check(r["cut"] <= 1.01 * host,
                  f"{tag}: sharded cut {r['cut']} above 1.01 x the host "
                  f"refined cut {host}")


def chain_rows(runs) -> dict:
    return {k: {kk: vv for kk, vv in v.items() if kk != "parts"}
            for k, v in runs.items()}


def phase_quality():
    from repro_torch.core.metrics import partition_metrics
    from repro_torch.kernels.ell_spmv import cuda
    from repro_torch.mesh import pebble_mesh

    mesh = pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1)
    runs = {p: ("K1", p, {}) for p in ("default", "raw", "geometric")}
    for pc in ("jacobi", "amg"):
        runs[f"rsb_inverse_{pc}"] = ("K2", "default",
                                     dict(method="inverse", precond=pc))
    out = {}
    for name, (kernel, preset, bkw) in runs.items():
        counter = "LAUNCHES" if kernel == "K1" else "BATCHED_LAUNCHES"
        before = getattr(cuda, counter)
        ctx, pm, wall, corridor, nonempty = run_preset(
            preset, mesh, 16, "cuda", bisect_kw=bkw)
        launches = getattr(cuda, counter) - before
        _, pm_cpu, _, _, _ = run_preset(preset, mesh, 16, "cpu", bisect_kw=bkw)
        out[name] = dict(cut=pm.edge_cut, cut_cpu=pm_cpu.edge_cut,
                         disconnected=pm.disconnected_parts,
                         w_imb=pm.weighted_imbalance, corridor=corridor,
                         seconds=wall, launches={kernel: launches},
                         precond=ctx.report.precond, stages=stage_split(ctx))
        check(pm.disconnected_parts == 0, f"quality {name}: disconnected parts")
        check(corridor and nonempty == 16, f"quality {name}: corridor/empty part")
        check(abs(pm.edge_cut - pm_cpu.edge_cut) <= 0.02 * pm_cpu.edge_cut,
              f"quality {name}: card cut {pm.edge_cut} vs CPU {pm_cpu.edge_cut}")
        if name != "geometric":
            check(launches > 0, f"quality {name}: {kernel} never launched")
    check(out["default"]["cut"] <= 1.05 * QUALITY_JAX_CUT,
          f"quality default cut {out['default']['cut']} > 1.05 x {QUALITY_JAX_CUT}")
    check(out["default"]["cut"] < out["geometric"]["cut"],
          "quality default cut not below the geometric cut")

    smoke = pebble_mesh(10, 10, 10, n_pebbles=6, seed=0)
    inverse_smoke = {}
    for pc in ("jacobi", "amg"):
        ctx, pm, wall, corridor, nonempty = run_preset(
            "default", smoke, 8, "cuda",
            bisect_kw=dict(method="inverse", precond=pc))
        raw = partition_metrics(ctx.require_graph(), ctx.parts_raw, 8).edge_cut
        inverse_smoke[pc] = dict(cut=pm.edge_cut, raw_cut=raw, seconds=wall,
                                 disconnected=pm.disconnected_parts,
                                 corridor=corridor)
        check(pm.edge_cut <= 1.05 * SMOKE_INV_CUT and raw <= 1.05 * SMOKE_INV_RAW,
              f"smoke inverse {pc}: cut {pm.edge_cut} / raw {raw} above 1.05 x "
              f"{SMOKE_INV_CUT} / {SMOKE_INV_RAW}")
        check(pm.disconnected_parts == 0 and corridor and nonempty == 8,
              f"smoke inverse {pc}: invariants")

    # The k-way presets (repair + hill-climbing k-way FM, host) on the card.
    kway = {}
    for preset in ("kway", "quality", "quality-kway"):
        ctx, pm, wall, corridor, nonempty = run_preset(preset, mesh, 16, "cuda")
        _, pm_cpu, _, _, _ = run_preset(preset, mesh, 16, "cpu")
        kway[preset] = dict(cut=pm.edge_cut, cut_cpu=pm_cpu.edge_cut,
                            disconnected=pm.disconnected_parts,
                            corridor=corridor, seconds=wall,
                            kway=ctx.report.post.kway.row(),
                            stages=stage_split(ctx))
        check(pm.disconnected_parts == 0 and corridor and nonempty == 16,
              f"quality {preset}: invariants")
        check(abs(pm.edge_cut - pm_cpu.edge_cut) <= 0.02 * pm_cpu.edge_cut,
              f"quality {preset}: card cut {pm.edge_cut} vs CPU {pm_cpu.edge_cut}")
    check(kway["kway"]["cut"] <= 1.05 * QUALITY_KWAY_JAX_CUT,
          f"quality kway cut {kway['kway']['cut']} > 1.05 x {QUALITY_KWAY_JAX_CUT}")

    # The sharded protocol of benchmarks/partition_time.py::run_sharded.
    from repro_torch.core.pipeline import PartitionPipeline

    # The chains run on the card and on the CPU from the card's raw labels
    # (the two fp32 Lanczos solves may split a few elements differently).
    ctx = PartitionPipeline(pre="rcb", bisect="rsb-batched",
                            bisect_kw=dict(tol=1e-3), post=(),
                            device="cuda").run(smoke, 8)
    sharded = run_chains(ctx.require_graph(), ctx.parts_raw, 8, ctx.weights,
                         "cuda")
    sharded_cpu = run_chains(ctx.require_graph(), ctx.parts_raw, 8,
                             ctx.weights, "cpu")
    check_chains("smoke sharded", sharded, 8)
    for name, r in sharded.items():
        check(np.array_equal(r["parts"], sharded_cpu[name]["parts"]),
              f"smoke sharded {name}: card labels differ from the CPU's "
              f"(cuts {r['cut']}, {sharded_cpu[name]['cut']})")
        check(r["cut"] <= 1.05 * SHARDED_JAX_CUTS[name],
              f"smoke sharded {name}: cut {r['cut']} > 1.05 x the recorded "
              f"{SHARDED_JAX_CUTS[name]}")
    emit("quality", mesh="pebble_mesh(12,12,12,n_pebbles=5,warp=0.15,seed=1)",
         nelems=mesh.nelems, nparts=16, jax_cut=QUALITY_JAX_CUT, presets=out,
         kway_presets=kway, kway_jax_cut=QUALITY_KWAY_JAX_CUT,
         inverse_smoke=dict(mesh="pebble_mesh(10,10,10,n_pebbles=6,seed=0)",
                            nelems=smoke.nelems, nparts=8,
                            jax_cut=SMOKE_INV_CUT, jax_raw_cut=SMOKE_INV_RAW,
                            runs=inverse_smoke),
         sharded_smoke=dict(mesh="pebble_mesh(10,10,10,n_pebbles=6,seed=0)",
                            nparts=8, recorded_jax_cuts=SHARDED_JAX_CUTS,
                            raw_cut=partition_metrics(
                                ctx.require_graph(), ctx.parts_raw, 8).edge_cut,
                            chains=chain_rows(sharded),
                            cpu_cuts={k: v["cut"]
                                      for k, v in sharded_cpu.items()}))


def phase_full(box):
    from repro_torch.kernels.ell_spmv import cuda

    torch.cuda.reset_peak_memory_stats()
    cuda.LAUNCHES = cuda.BATCHED_LAUNCHES = 0   # this path's counts start here
    ctx, pm, wall, corridor, nonempty = run_preset("default", box, 64, "cuda")
    launches = cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    _, gpm, gwall, _, _ = run_preset("geometric", box, 64, "cuda")
    emit("full", mesh="box_mesh(80,64,48)", nelems=box.nelems, nparts=64,
         seconds=wall, stages=stage_split(ctx), levels=level_rows(ctx),
         k1_launches=launches, max_memory_allocated=peak, cut=pm.edge_cut,
         geometric_cut=gpm.edge_cut, geometric_seconds=gwall,
         disconnected=pm.disconnected_parts, w_imb=pm.weighted_imbalance,
         corridor=corridor, nonempty_parts=nonempty)
    check(nonempty == 64, "full: an empty part")
    check(pm.disconnected_parts == 0, "full: disconnected parts")
    check(corridor, "full: balance corridor broken")
    check(launches > 0, "full: K1 never launched on the main path")
    # On a box RCB's planar block cuts are already near optimal, and the
    # default schedule caps each warm-started Lanczos refinement at 3
    # restarts, so RSB can land a few percent above them: repro itself
    # does (identical labels to the port on box_mesh(60, 48, 36), 64 parts:
    # 313371 against RCB's 307836).  The check bounds the gap.
    check(pm.edge_cut <= 1.05 * gpm.edge_cut,
          f"full: cut {pm.edge_cut} above 1.05 x the geometric cut {gpm.edge_cut}")
    return launches, gpm.edge_cut, ctx


def phase_full_inverse(box, geometric_cut):
    from repro_torch.kernels.ell_spmv import cuda

    torch.cuda.reset_peak_memory_stats()
    cuda.LAUNCHES = cuda.BATCHED_LAUNCHES = 0   # this path's counts start here
    ctx, pm, wall, corridor, nonempty = run_preset("default", box, 64, "cuda",
                                                   bisect_kw=INVERSE_AMG)
    launches, k1 = cuda.BATCHED_LAUNCHES, cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    emit("full_inverse", mesh="box_mesh(80,64,48)", nelems=box.nelems,
         nparts=64, bisect_kw=INVERSE_AMG, seconds=wall,
         stages=stage_split(ctx), levels=level_rows(ctx),
         k2_launches=launches, k1_launches=k1, max_memory_allocated=peak,
         cut=pm.edge_cut, geometric_cut=geometric_cut,
         disconnected=pm.disconnected_parts, w_imb=pm.weighted_imbalance,
         corridor=corridor, nonempty_parts=nonempty,
         precond=ctx.report.precond)
    check(nonempty == 64, "full_inverse: an empty part")
    check(pm.disconnected_parts == 0, "full_inverse: disconnected parts")
    check(corridor, "full_inverse: balance corridor broken")
    check(launches > 0, "full_inverse: K2 never launched on the main path")
    check(pm.edge_cut <= 1.05 * geometric_cut,
          f"full_inverse: cut {pm.edge_cut} above 1.05 x the geometric cut "
          f"{geometric_cut}")
    return launches


def mirror_check(tag, graph, parts, weights, nparts, sweeps=8):
    """The card's sweeps against the NumPy mirror on the same plan: labels,
    moves per sweep and the tracked cut must be identical (integer
    weights: every fp32 sum is exact).  Returns the record and the plan."""
    from repro_torch.core.refine import balance_corridor
    from repro_torch.dist.refine_sharded import (build_frontier_plan,
                                                 refine_sharded_host,
                                                 run_sharded_sweeps)

    corr = balance_corridor(parts, nparts, weights, 0.05)
    fp = build_frontier_plan(graph, parts, nparts, weights=weights)
    out, rec, info = run_sharded_sweeps(fp, parts, nparts, sweeps=sweeps,
                                        corridor=corr, device="cuda")
    t0 = time.perf_counter()
    out_h, rec_h, info_h = refine_sharded_host(fp, parts, nparts,
                                               sweeps=sweeps, corridor=corr)
    host_s = time.perf_counter() - t0
    check(np.array_equal(out, out_h), f"{tag}: card labels differ from the "
          f"NumPy mirror's ({int((out != out_h).sum())} elements)")
    check([r.moves for r in rec] == [r.moves for r in rec_h]
          and info["cut"] == info_h["cut"], f"{tag}: moves or cut differ")
    return dict(moves_per_sweep=[r.moves for r in rec], cut=info["cut"],
                gathers=info["gathers"], sweeps_s=info["sweep_seconds"],
                admit_s=info["admit_seconds"], mirror_s=host_s,
                halo=fp.plan.halo, w=fp.w), fp


def phase_full_sharded(ctx):
    """`run_sharded`'s chains on the full box's raw labels (``full``'s
    context: no second eigensolve), then the card's sweeps against the
    NumPy mirror.  Returns the K3 and K4 launches of the chains, the
    frontier plan of the raw labels (K4's ``main`` shape) and the labels."""
    from repro_torch.kernels.segment_sum import cuda as ss_cuda

    g, raw, w = ctx.require_graph(), ctx.parts_raw, ctx.weights
    ss_cuda.LAUNCHES = ss_cuda.BATCHED_LAUNCHES = 0  # this path's counts
    runs = run_chains(g, raw, 64, w, "cuda")
    launches = {"K3": ss_cuda.LAUNCHES, "K4": ss_cuda.BATCHED_LAUNCHES}
    check_chains("full_sharded", runs, 64)
    check(launches["K4"] > 0, "full_sharded: K4 never launched")
    mirror_raw, fp = mirror_check("full_sharded raw", g, raw, w, 64)
    rng = np.random.default_rng(0)
    perturbed = raw.copy()
    pick = rng.random(raw.size) < 0.02
    perturbed[pick] = rng.integers(0, 64, int(pick.sum()))
    mirror_pert, _ = mirror_check("full_sharded perturbed", g, perturbed, w, 64)
    check(sum(mirror_pert["moves_per_sweep"]) > 0,
          "full_sharded perturbed: the sweeps moved nothing")
    emit("full_sharded", mesh="box_mesh(80,64,48)", nelems=g.n, nparts=64,
         chains=chain_rows(runs), launches=launches,
         mirror=dict(raw=mirror_raw, perturbed_2pct=mirror_pert))
    return launches, fp, raw


def quick_plan(box=None):
    """The frontier plan of RCB labels of ``box`` (``box_mesh(80, 64,
    48)`` by default) into 64 parts, and the labels: phase 8's sweep
    under ``--quick``.  Phase 8 alone on the card:
    ``python3 -c "import chip_smoke as cs;
    cs.phase_kernels_segsum(*cs.quick_plan())"``."""
    from repro_torch.core.rcb import rcb_parts
    from repro_torch.dist.refine_sharded import build_frontier_plan
    from repro_torch.mesh import box_mesh, dual_graph

    box = box_mesh(80, 64, 48) if box is None else box
    parts = rcb_parts(box.coords, 64, box.weights)
    return build_frontier_plan(dual_graph(box), parts, 64,
                               weights=box.weights), parts


def segsum_arrays(fp, parts):
    """Phase 8's inputs as NumPy arrays: K4 ``main`` (the sweep's table
    from ``fp`` and the labels ``parts``), K4 ``tiny``, K3 ``bench`` and K3
    ``root`` (``main``'s first shard), each as (labels, cols, wts,
    nparts)."""
    from repro_torch.dist.refine_sharded import _combined_labels_host

    main = (_combined_labels_host(fp, parts).astype(np.int32),
            fp.ell_cols.astype(np.int32), fp.ell_wts.astype(np.float32))
    rng = np.random.default_rng(2)

    def rand(lead, B, w, m, nparts):
        return (rng.integers(0, nparts, lead + (m,)).astype(np.int32),
                rng.integers(0, m, lead + (B, w)).astype(np.int32),
                rng.integers(1, 5, lead + (B, w)).astype(np.float32))

    return {"K4 main": (*main, 64),
            "K4 tiny": (*rand((3,), 40, 6, 90, 9), 9),
            "K3 bench": (*rand((), 16384, 27, 32768, 128), 128),
            "K3 root": (main[0][0], main[1][0], main[2][0], 64)}


def segsum_cases(arrays):
    """``segsum_arrays``' cases on the card, each as (kernel, plain,
    labels, cols, wts, nparts); K3 ``root`` is a view into ``main``'s
    tensors."""
    from repro_torch.kernels.segment_sum import cuda as ss_cuda
    from repro_torch.kernels.segment_sum import ref as ss_ref

    k3 = (ss_cuda.connection_table_cuda, ss_ref.connection_table_ref)
    k4 = (ss_cuda.connection_table_batched_cuda,
          ss_ref.connection_table_batched_ref)
    cases = {}
    for case, (*arrs, nparts) in arrays.items():
        if case == "K3 root":
            main = cases["K4 main"]
            cases[case] = (*k3, main[2][0], main[3][0], main[4][0], nparts)
            continue
        dev = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                    for a in arrs)
        cases[case] = (*(k3 if dev[1].ndim == 2 else k4), *dev, nparts)
    return cases


def phase_kernels_segsum(fp, parts):
    """K3 and K4 against the plain version and timed (see the module
    docstring).  The library yardstick is one ``index_add_`` of the weights
    into the flattened table at a precomputed index (atomics; timing
    only), by CUDA events (``library_ms``) and by the profiler's device
    time over all its kernels (``library_dev_ms``).  It does less work
    than the kernel: it does not zero the table, gathers no label, and its
    index is computed before the timing."""
    rows = {}
    for case, (kernel, plain, labels, cols, wts, nparts) in \
            segsum_cases(segsum_arrays(fp, parts)).items():
        G = cols.shape[0] if cols.ndim == 3 else 1
        B, w = cols.shape[-2:]
        got, want = kernel(labels, cols, wts, nparts), plain(labels, cols,
                                                             wts, nparts)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{case}: integer weights, kernel "
              f"differs from the plain version by {float((got - want).abs().max())}")
        rng = np.random.default_rng(3)
        fw = torch.from_numpy(rng.normal(size=tuple(wts.shape))
                              .astype(np.float32)).cuda()
        gotf, wantf = kernel(labels, cols, fw, nparts), plain(labels, cols,
                                                              fw, nparts)
        torch.cuda.synchronize()
        err = float((gotf - wantf).abs().max())
        rel = float(((gotf - wantf).abs().amax(-1)
                     / fw.abs().sum(-1).clamp(min=1e-30)).max())
        check(torch.equal(gotf, wantf),
              f"{case}: fp32 weights, max err {err}, {rel} of Σ|w|")

        lab = torch.gather(labels.reshape(G, -1).long(), 1,
                           cols.reshape(G, -1).long())
        rowid = torch.arange(G * B, device="cuda").repeat_interleave(w)
        index = rowid * nparts + lab.reshape(-1)
        flat = torch.zeros(G * B * nparts, device="cuda")
        lib = torch.zeros_like(flat).index_add_(0, index, wts.reshape(-1))
        check(torch.allclose(lib.reshape(want.shape), want),
              f"{case}: index_add_ disagrees with the plain version")
        uniq = torch.unique(cols.reshape(G, -1).long()
                            + torch.arange(G, device="cuda")[:, None]
                            * labels.shape[-1]).numel()
        nbytes = 4 * (2 * G * B * w + G * B * nparts + uniq)
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = G * B * w / FP32_FLOPS_PER_S * 1e3
        kernel_ms = time_ms(lambda: kernel(labels, cols, wts, nparts))
        dev_ms, profiler_events, _ = profiled_ms(
            lambda: kernel(labels, cols, wts, nparts), "segment_sum_kernel")
        rows[case] = dict(
            G=G, B=B, w=w, m=labels.shape[-1], nparts=nparts, max_abs_err=err,
            max_err_of_weights=rel,
            dev_ms=dev_ms if dev_ms is not None else kernel_ms,
            dev_ms_by="profiler" if dev_ms is not None else "cuda_events",
            profiler_cuda_events=profiler_events, kernel_ms=kernel_ms,
            ref_ms=time_ms(lambda: plain(labels, cols, wts, nparts),
                           reps=5, rounds=5, warmup=2),
            library_ms=time_ms(lambda: flat.index_add_(0, index,
                                                       wts.reshape(-1))),
            library_dev_ms=profiled_call_ms(
                lambda: flat.index_add_(0, index, wts.reshape(-1))),
            bytes=nbytes, bound_ms=max(bound_bytes_ms, bound_ops_ms),
            bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
            else "operations")
    emit("kernels", kernel="segment_sum", cases=rows)
    return rows


def time_auto(fn) -> float:
    """`time_ms` with the repetitions scaled to the call: calls above 1 ms
    run 5 rounds of ~20 ms each, so a slow plain version does not run for
    minutes."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    one = a.elapsed_time(b)
    if one < 1.0:
        return time_ms(fn)
    return time_ms(fn, reps=max(1, int(20 / one)), rounds=5, warmup=1)


def flash_work(B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal, elsize):
    """Bytes (q, the keys and values the queries need, o; each once) and
    flops (4·D per unmasked (query, key) pair and head) of one call."""
    qpos = q_offset + np.arange(Sq)
    if causal:
        keys = np.clip(np.minimum(kv_len, qpos + 1), 0, None)
        kv_used = int(keys.max()) if Sq else 0
    else:
        keys = np.full(Sq, kv_len)
        kv_used = kv_len
    nbytes = elsize * (2 * B * Sq * H * D + 2 * B * kv_used * Hkv * D)
    flops = 4 * D * H * B * int(keys.sum())
    return nbytes, flops


def sdpa_call(q, k, v, causal, q_offset, kv_len):
    """One `scaled_dot_product_attention` call computing the same function
    (the yardstick; the port never calls it).  Its causal mask is aligned
    top-left, right only where the queries start at key 0, so the keys are
    sliced to kv_len and any other alignment gets an explicit mask."""
    import torch.nn.functional as F

    Sq = q.shape[1]
    qt = q.transpose(1, 2)
    kt, vt = k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2)
    kw = dict(enable_gqa=True)
    if causal and q_offset == 0 and Sq == kv_len:
        kw["is_causal"] = True
    elif causal and q_offset < kv_len - 1:   # else every query sees every key
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kw["attn_mask"] = qpos[:, None] >= torch.arange(kv_len,
                                                        device=q.device)[None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw).transpose(1, 2)


def phase_kernels_flash():
    """K6 against its plain version at every case of FLASH_CASES, fp32 and
    bf16, timed beside its bound, the plain version and SDPA."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    rows = {}
    for seed, (case, (B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal)) in \
            enumerate(FLASH_CASES.items()):
        kv_len = Skv if kv_len is None else kv_len
        q_offset = kv_len - Sq if q_offset is None else q_offset
        rng = np.random.default_rng(seed)
        q32 = torch.from_numpy(rng.normal(size=(B, Sq, H, D)).astype(np.float32)).cuda()
        k32 = torch.from_numpy(rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)).cuda()
        v32 = torch.from_numpy(rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)

            def kernel():
                return fa_cuda.flash_attention_cuda(q, k, v, **kw)

            def plain():
                return flash_attention_plain(q, k, v, **kw)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            tol = FLASH_TOL[dtype]
            excess = float((diff - tol * want.float().abs()).max())
            check(excess <= tol, f"K6 {case} {dtype}: max err {err} "
                  f"(atol = rtol = {tol})")
            lib = sdpa_call(q, k, v, causal, q_offset, kv_len)
            lib_err = float((lib().float() - want.float()).abs().max())
            check(lib_err <= (1e-3 if dtype == torch.float32 else 5e-2),
                  f"SDPA {case} {dtype} disagrees with the plain version "
                  f"by {lib_err}")
            nbytes, flops = flash_work(B, Sq, Skv, H, Hkv, D, q_offset,
                                       kv_len, causal, q.element_size())
            bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
                else FP32_FLOPS_PER_S
            bound_ops_ms = flops / peak * 1e3
            kernel_ms = time_auto(kernel)
            dev_ms, traced, kname = profiled_ms(kernel,
                                                "flash_attention_kernel")
            # the route: a bf16 prefill runs the bf16 prefill kernel, a
            # decode call (either type) the split-KV decode kernel
            if Sq * (H // Hkv) <= FLASH_DECODE_ROWS and kname is not None:
                check(FLASH_DECODE_KERNEL in kname,
                      f"K6 {case} {dtype} ran {kname}, not the decode kernel")
            elif dtype == torch.bfloat16 and kname is not None:
                check(FLASH_PREFILL_KERNEL in kname,
                      f"K6 {case} bf16 ran {kname}, not the prefill kernel")
            lib_dev_ms = profiled_call_ms(lib)
            k_ms = dev_ms if dev_ms is not None else kernel_ms
            rows[(case, str(dtype).split(".")[-1])] = dict(
                case=case, dtype=str(dtype).split(".")[-1], B=B, Sq=Sq,
                Skv=Skv, H=H, Hkv=Hkv, D=D, q_offset=q_offset, kv_len=kv_len,
                causal=causal, max_abs_err=err, library_max_abs_err=lib_err,
                kernel_ms=kernel_ms,
                dev_ms=k_ms,
                dev_ms_by="profiler" if dev_ms is not None else "cuda_events",
                profiler_cuda_events=traced, kernel_name=kname,
                tflops=flops / (k_ms * 1e-3) / 1e12, ref_ms=time_auto(plain),
                library_ms=time_auto(lib), library_dev_ms=lib_dev_ms,
                library_tflops=flops / (lib_dev_ms * 1e-3) / 1e12
                if lib_dev_ms else None, bytes=nbytes, flops=flops,
                bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                else "operations")
            del got, want
    emit("kernels", kernel="flash_attention", cases=list(rows.values()))
    return rows


def logit_gap(got, want) -> float:
    """max |got − want| / max |want|, in fp32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def phase_serve():
    """`tinyllama-1.1b` at full width served through `generate` (see the
    module docstring); returns K6's launches over the two runs."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as tt
    from repro_torch.obs import percentiles

    arch = get_arch("tinyllama-1.1b")
    cfg = arch.make_config()
    t0 = time.perf_counter()
    model = tt.Transformer(cfg, tt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0)))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())

    def prompts_of(B, P):
        return torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (B, P))).cuda()

    # Warm-up (cuBLAS handles and workspaces, K6's library load) outside
    # the counted runs.
    generate(cfg, model, prompts_of(4, 512), 2)
    generate(cfg, model, prompts_of(1, 4096), 2)

    runs, kept = {}, {}
    fa_cuda.LAUNCHES = 0                 # the serve path's count starts here
    for name, (B, P, steps) in SERVE_RUNS.items():
        prompts = prompts_of(B, P)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = fa_cuda.LAUNCHES
        toks, t_pre, step_s = generate(cfg, model, prompts, steps)
        launches = fa_cuda.LAUNCHES - before
        check(launches == cfg.n_layers * steps,
              f"serve {name}: {launches} K6 launches, not "
              f"{cfg.n_layers} x {steps}")
        t_dec = sum(step_s)
        pct = percentiles(step_s)
        runs[name] = dict(
            batch=B, prompt_len=P, steps=steps, prefill_ms=t_pre * 1e3,
            prefill_tok_per_s=B * P / t_pre, decode_ms=t_dec * 1e3,
            tok_per_s=B * (steps - 1) / t_dec, p50_step_ms=pct["p50"] * 1e3,
            p99_step_ms=pct["p99"] * 1e3,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            k6_launches=launches, sample_tokens=toks[0, :12].tolist())
        kept[name] = (prompts, toks)
    k6_launches = fa_cuda.LAUNCHES

    prompts, toks = kept["requests"]
    B, P, steps = SERVE_RUNS["requests"]
    with torch.inference_mode():
        # Where the time goes: one `requests` prefill and decode step and
        # one `long` decode step, timed on the host clock, then profiled (a
        # profiler session can leave launch overhead behind, so the wall
        # times come first).
        cache = tt.init_cache(cfg, B, P + 1, "cuda")
        # the `long` run's decode step: one row after its 4096 cached rows
        long_p, long_t = kept["long"]
        long_P = SERVE_RUNS["long"][1]
        long_cache = tt.init_cache(cfg, 1, long_P + 1, "cuda")
        _, long_cache = tt.prefill(model, long_p, long_cache)
        parts = {"prefill": lambda: tt.prefill(model, prompts, cache),
                 "decode_step": lambda: tt.decode_step(model, cache,
                                                       toks[:, :1], P),
                 "long_decode_step": lambda: tt.decode_step(
                     model, long_cache, long_t[:, :1], long_P)}
        wall = {part: wall_s(fn) * 1e3 for part, fn in parts.items()}
        profile = {}
        for part, fn in parts.items():
            by_name = device_profile(fn)
            k6 = [v for n, v in by_name.items() if "flash_attention_kernel" in n]
            profile[part] = dict(
                wall_ms=wall[part],
                cuda_kernels=sum(v[0] for v in by_name.values()),
                device_ms=sum(v[1] for v in by_name.values()),
                k6_launches=sum(v[0] for v in k6),
                k6_ms=sum(v[1] for v in k6) if k6 else None,
                top=top_kernels(by_name))

        # (a) K6 against the plain attention, same weights and inputs.
        logits = {}
        for prefer in ("auto", "ref"):
            model.attn_prefer = prefer
            cache = tt.init_cache(cfg, B, P + 1, "cuda")
            lp, cache = tt.prefill(model, prompts, cache)
            ld, _ = tt.decode_step(model, cache, toks[:, :1], P)
            logits[prefer] = (lp, ld)
        model.attn_prefer = "auto"
        gap_ref = {"prefill": logit_gap(logits["auto"][0], logits["ref"][0]),
                   "decode": logit_gap(logits["auto"][1], logits["ref"][1])}
        check(max(gap_ref.values()) <= SERVE_TOL_REF,
              f"serve (a): K6 vs plain attention logits {gap_ref}")
        del logits

        # (b) decode consistency: 7 decode steps after a prefill of the
        # served tokens, against one forward over all of them.
        seq = torch.cat([prompts, toks], dim=1)[:, :P + steps - 1]
        S = seq.shape[1]
        full = tt.forward(model, seq)
        cache = tt.init_cache(cfg, B, S, "cuda")
        lp, cache = tt.prefill(model, seq[:, :S - 7], cache)
        gap_fwd = {"prefill": logit_gap(lp[:, 0], full[:, S - 8])}
        for t in range(S - 7, S):
            ld, cache = tt.decode_step(model, cache, seq[:, t:t + 1], t)
        gap_fwd["last_decode"] = logit_gap(ld[:, 0], full[:, S - 1])
        check(max(gap_fwd.values()) <= SERVE_TOL_FORWARD,
              f"serve (b): decode vs forward logits {gap_fwd}")
        del full, cache

    # (c) the smoke config in fp32: card against CPU.
    smoke = arch.make_smoke_config()
    params = tt.init_params(smoke, torch.Generator().manual_seed(0))
    cpu, gpu = tt.Transformer(smoke, params), tt.Transformer(smoke, params).cuda()
    sp = torch.from_numpy(np.random.default_rng(0).integers(0, smoke.vocab, (4, 16)))
    tg, _, _ = generate(smoke, gpu, sp.cuda(), 32)
    tc, _, _ = generate(smoke, cpu, sp, 32)
    with torch.inference_mode():
        seq = torch.cat([sp, tc], dim=1)
        smoke_gap = float((tt.forward(gpu, seq.cuda()).cpu()
                           - tt.forward(cpu, seq)).abs().max())
    check(torch.equal(tg.cpu(), tc), "serve (c): smoke tokens on the card "
          "differ from the CPU's")
    check(smoke_gap <= 1e-3, f"serve (c): smoke logits differ by {smoke_gap}")

    emit("serve", arch=cfg.name, dtype=str(cfg.dtype).split(".")[-1],
         n_params=cfg.n_params(), weight_bytes=weight_bytes, init_s=init_s,
         runs=runs, k6_launches=k6_launches, profile=profile,
         check_a_ref_gap=gap_ref, check_a_tol=SERVE_TOL_REF,
         check_b_forward_gap=gap_fwd, check_b_tol=SERVE_TOL_FORWARD,
         check_c=dict(config=smoke.name, steps=32, tokens_equal=True,
                      max_abs_logit_gap=smoke_gap))
    del model
    torch.cuda.empty_cache()
    return k6_launches


def zipf_items(rng, shape, n_items):
    """`recsys_batches`' item draw: Zipf(1.2) popularity in [1, n_items)."""
    return (rng.zipf(1.2, size=shape) % (n_items - 1) + 1).astype(np.int32)


def bag_inputs(case, spec, table_full, serve_seq, n_items):
    """(table, indices, segments, weights, n_bags) on the card, fp32;
    segments sorted except in the ``unsorted`` case."""
    rng = np.random.default_rng(len(case))
    kind = spec["kind"]
    dev = table_full.device
    if kind in ("sequence", "candidates", "bulk"):    # bags of one row
        if kind == "sequence":
            idx = serve_seq.reshape(-1).to(torch.int32)
            weight = float(np.sqrt(table_full.shape[1]))
        elif kind == "bulk":
            idx = torch.from_numpy(zipf_items(
                rng, BULK_CHUNK * serve_seq.shape[1], n_items)).to(dev)
            weight = float(np.sqrt(table_full.shape[1]))
        else:
            gen = torch.Generator(device=dev).manual_seed(1)
            idx = (torch.randperm(n_items, generator=gen, device=dev)
                   + 1).to(torch.int32)
            weight = 1.0
        n = idx.numel()
        return (table_full, idx,
                torch.arange(n, dtype=torch.int32, device=dev),
                torch.full((n,), weight, device=dev), n)
    if kind == "pooled":
        n = 65536
        seg = np.repeat(np.arange(n, dtype=np.int32),
                        rng.integers(1, 65, n))
        idx = zipf_items(rng, seg.size, n_items)
        table = table_full
    else:
        n = spec["B"]
        table = torch.from_numpy(rng.normal(
            size=(spec["V"], spec["d"])).astype(np.float32)).to(dev)
        idx = rng.integers(0, spec["V"], spec["nnz"]).astype(np.int32)
        bags = np.arange(n)
        if kind == "empty":
            bags = bags[bags % 3 != 0]
        seg = rng.choice(bags, spec["nnz"]).astype(np.int32)
        if kind != "unsorted":
            seg = np.sort(seg)
    w = rng.normal(size=seg.size).astype(np.float32)
    return (table, torch.from_numpy(idx).to(dev),
            torch.from_numpy(seg).to(dev), torch.from_numpy(w).to(dev), n)


def bag_library(table, idx, seg, w, n_bags):
    """One `F.embedding_bag(mode="sum", per_sample_weights=...)` call of the
    same function (the yardstick; the port never calls it), its offsets
    from ``searchsorted`` over the sorted segments."""
    import torch.nn.functional as F

    idx64 = idx.long()
    offsets = torch.searchsorted(seg, torch.arange(
        n_bags, dtype=seg.dtype, device=seg.device))
    return lambda: F.embedding_bag(idx64, table, offsets, mode="sum",
                                   per_sample_weights=w)


def phase_kernels_bag(table_full, serve_seq, n_items):
    """K5 against its plain version at every case of BAG_CASES, fp32 and
    bf16, timed beside its bound, the plain version and F.embedding_bag."""
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    rows = {}
    for case, spec in BAG_CASES.items():
        t32, idx, seg, w32, n = bag_inputs(case, spec, table_full, serve_seq,
                                       n_items)
        for dtype in (torch.float32, torch.bfloat16):
            table, w = t32.to(dtype), w32.to(dtype)
            if spec["kind"] == "unsorted":
                got = eb_ops.embedding_bag(table, idx, seg, n, weights=w,
                                           assume_sorted=False, prefer="cuda")
                order = torch.argsort(seg, stable=True)
                i_s, s_s, w_s = idx[order], seg[order], w[order]
            else:
                i_s, s_s, w_s = idx, seg, w

            def kernel():
                return eb_cuda.embedding_bag_cuda(table, i_s, s_s, w_s, n)

            def plain():
                return embedding_bag_ref(table, i_s, s_s, n, weights=w_s)

            if spec["kind"] != "unsorted":
                got = kernel()
            want = plain()
            size = embedding_bag_ref(table.float().abs(), i_s, s_s, n,
                                     weights=w_s.float().abs())
            lib = bag_library(table, i_s, s_s, w_s, n)
            lib_out = lib()
            torch.cuda.synchronize()
            one = spec["kind"] in ("sequence", "candidates", "bulk")
            tol = TOL[dtype]
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            rel = float((diff / size.clamp(min=1e-30)).max())
            if one and dtype == torch.float32:
                check(torch.equal(got, want) and torch.equal(
                    got, table[i_s.long()] * w_s[:, None]),
                    f"K5 {case}: a bag of one is not bit-equal to take·w")
            check(bool((diff <= tol * size).all()),
                  f"K5 {case} {dtype}: {rel} of Σ|w·row| (tol {tol})")
            empty = torch.bincount(s_s.long(), minlength=n) == 0
            check(bool((got[empty] == 0).all()),
                  f"K5 {case}: an empty bag's row is not zero")
            lib_rel = float(((lib_out.float() - want.float()).abs()
                             / size.clamp(min=1e-30)).max())
            check(lib_rel <= tol, f"F.embedding_bag {case} {dtype} "
                  f"disagrees with the plain version: {lib_rel}")
            nnz, d, el = i_s.numel(), table.shape[1], table.element_size()
            distinct = int(torch.unique(i_s).numel())
            nbytes = nnz * (4 + 4 + el) + distinct * d * el + n * d * el
            bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ops_ms = 2 * nnz * d / FP32_FLOPS_PER_S * 1e3
            kernel_ms = time_auto(kernel)
            dev_ms, traced, _ = profiled_ms(kernel, "embedding_bag_kernel")
            rows[(case, str(dtype).split(".")[-1])] = dict(
                case=case, dtype=str(dtype).split(".")[-1], V=table.shape[0],
                d=d, nnz=nnz, n_bags=n, rows_distinct=distinct,
                empty_bags=int(empty.sum()), max_abs_err=err,
                max_err_of_terms=rel, library_max_err_of_terms=lib_rel,
                kernel_ms=kernel_ms,
                dev_ms=dev_ms if dev_ms is not None else kernel_ms,
                dev_ms_by="profiler" if dev_ms is not None else "cuda_events",
                profiler_cuda_events=traced, ref_ms=time_auto(plain),
                library_ms=time_auto(lib), bytes=nbytes,
                bound_ms_all_rows=(nnz * (4 + 4 + el) + nnz * d * el
                                   + n * d * el) / HBM_BYTES_PER_S * 1e3,
                bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                else "operations")
            del got, want, size, lib_out
    emit("kernels", kernel="embedding_bag", cases=list(rows.values()))
    return rows


def topk_ids_agree(vals, ids, want_v, want_i, full, tol):
    """Streamed top-k against the top-(k+1) of the full score matrix:
    values within ``tol``, each id carrying its reported score, and ids
    equal at every rank more than ``tol`` from its neighbours.  Returns
    the share of ranks compared and the largest value gap."""
    k = vals.shape[1]
    gap_v = float((vals - want_v[:, :k]).abs().max())
    carried = float((torch.gather(full, 1, ids) - vals).abs().max())
    step = (want_v[:, :-1] - want_v[:, 1:]).abs()            # (B, k)
    apart = step > tol
    apart[:, 1:] &= step[:, :k - 1] > tol
    same = bool((ids[apart] == want_i[:, :k][apart]).all())
    check(gap_v <= tol and carried <= tol and same,
          f"recsys (b): streamed top-{k} vs full: value gap {gap_v}, "
          f"carried {carried}, ids equal where apart {same}")
    return float(apart.float().mean()), gap_v


def phase_recsys():
    """SASRec at its published widths (fp32, parameters from a seeded
    generator) through `launch.cells`: ``serve_p99``, ``retrieval_cand``
    and ``serve_bulk``; a profile of one ``serve_p99`` call; checks a-c.
    Returns the K5 phase's rows and K5's launches over the three runs."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.launch.cells import recsys_retrieval, recsys_serve_topk
    from repro_torch.models.recsys import SASRec, init_sasrec
    from repro_torch.obs import percentiles

    arch = get_arch("sasrec")
    cfg = arch.make_config()
    shapes = arch.shapes
    t0 = time.perf_counter()
    model = SASRec(cfg, init_sasrec(
        cfg, torch.Generator(device="cuda").manual_seed(0)))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    table_bytes = model.item_embed.numel() * model.item_embed.element_size()
    check(table_bytes == 200_089_600, f"SASRec table is {table_bytes} B")

    def users(B, seed):
        return next(recsys_batches(B, cfg.seq_len, cfg.n_items,
                                   seed=seed))["item_seq"].cuda()

    B99 = shapes["serve_p99"]["batch"]
    seq99 = users(B99, 0)
    bag_rows = phase_kernels_bag(model.item_embed.detach(), seq99,
                                 cfg.n_items)
    n_cand = shapes["retrieval_cand"]["n_candidates"]
    cand = (torch.randperm(n_cand, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda") + 1).to(torch.int32)
    seq1 = users(shapes["retrieval_cand"]["batch"], 2)
    B_bulk = shapes["serve_bulk"]["batch"]
    seq_bulk = users(B_bulk, 3)

    runs = {}
    with torch.inference_mode():
        # Warm-up (cuBLAS handles, K5's library load) outside the counts.
        recsys_serve_topk(cfg, model, seq99, k=RECSYS_K)
        recsys_retrieval(cfg, model, seq1, cand)
        torch.cuda.synchronize()

        eb_cuda.LAUNCHES = 0             # the recsys path's count starts here
        for name, fn, per_call, B in (
                ("serve_p99", lambda: recsys_serve_topk(
                    cfg, model, seq99, k=RECSYS_K), 1, B99),
                ("retrieval_cand", lambda: recsys_retrieval(
                    cfg, model, seq1, cand), 2, 1)):
            torch.cuda.reset_peak_memory_stats()
            secs = []
            for _ in range(RECSYS_REPS):
                before = eb_cuda.LAUNCHES
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                check(eb_cuda.LAUNCHES - before == per_call,
                      f"recsys {name}: {eb_cuda.LAUNCHES - before} K5 "
                      f"launches a call, not {per_call}")
            vals = out[0] if isinstance(out, tuple) else out
            check(bool(torch.isfinite(vals).all()),
                  f"recsys {name}: non-finite scores")
            pct = percentiles(secs)
            runs[name] = dict(
                batch=B, calls=RECSYS_REPS, p50_ms=pct["p50"] * 1e3,
                p99_ms=pct["p99"] * 1e3, users_per_s=B / pct["p50"],
                k5_launches_per_call=per_call,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                out_shape=list(vals.shape))
        torch.cuda.reset_peak_memory_stats()
        before = eb_cuda.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vb, ib = recsys_serve_topk(cfg, model, seq_bulk, k=RECSYS_K,
                                   user_chunk=BULK_CHUNK)
        torch.cuda.synchronize()
        bulk_s = time.perf_counter() - t0
        bulk_launches = eb_cuda.LAUNCHES - before
        n_chunks = -(-B_bulk // BULK_CHUNK)
        check(bulk_launches == n_chunks,
              f"recsys serve_bulk: {bulk_launches} K5 launches, not "
              f"{n_chunks}")
        check(tuple(vb.shape) == (B_bulk, RECSYS_K)
              and bool(torch.isfinite(vb).all()),
              "recsys serve_bulk: bad or non-finite top-k")
        runs["serve_bulk"] = dict(
            batch=B_bulk, wall_s=bulk_s, users_per_s=B_bulk / bulk_s,
            k5_launches=bulk_launches,
            max_memory_allocated=torch.cuda.max_memory_allocated())
        del vb, ib, seq_bulk
        k5_launches = eb_cuda.LAUNCHES

        # Where the time goes: one serve_p99 call, timed, then profiled.
        wall_ms = wall_s(lambda: recsys_serve_topk(cfg, model, seq99,
                                                   k=RECSYS_K)) * 1e3
        by_name = device_profile(lambda: recsys_serve_topk(cfg, model, seq99,
                                                           k=RECSYS_K),
                                 warmup=1)
        k5 = [v for n, v in by_name.items() if "embedding_bag_kernel" in n]
        dev_ms = sum(v[1] for v in by_name.values())
        profile = dict(wall_ms=wall_ms,
                       cuda_kernels=sum(v[0] for v in by_name.values()),
                       device_ms=dev_ms, busy=dev_ms / wall_ms if by_name
                       else None, k5_launches=sum(v[0] for v in k5),
                       k5_ms=sum(v[1] for v in k5) if k5 else None,
                       top=top_kernels(by_name))

        # (a) K5 against the plain lookup, same weights and users.
        h = model.user_state(seq99)
        model.bag_prefer = "ref"
        h_ref = model.user_state(seq99)
        model.bag_prefer = "auto"
        check(torch.equal(h, h_ref), "recsys (a): user states with K5 differ "
              "from the plain lookup's")

        # (b) streamed top-100 against topk of the full score matrix.
        vals, ids = recsys_serve_topk(cfg, model, seq99, k=RECSYS_K)
        full = h[:, -1] @ model.item_embed.T                 # (512, 1000448)
        want_v, want_i = torch.topk(full, RECSYS_K + 1, dim=1)
        share, gap_v = topk_ids_agree(vals, ids, want_v, want_i, full,
                                      RECSYS_TOPK_TOL)
        del full, h, h_ref

    # (c) the smoke config on the card against the CPU.
    smoke = arch.make_smoke_config()
    params = init_sasrec(smoke, torch.Generator().manual_seed(0))
    cpu, gpu = SASRec(smoke, params), SASRec(smoke, params).cuda()
    sseq = next(recsys_batches(64, smoke.seq_len, smoke.n_items,
                               seed=1))["item_seq"]
    sseq[:8, :5] = 0                                        # left padding
    with torch.inference_mode():
        state_gap = float((gpu.user_state(sseq.cuda()).cpu()
                           - cpu.user_state(sseq)).abs().max())
        _, ig = recsys_serve_topk(smoke, gpu, sseq.cuda(), k=RECSYS_K)
        _, ic = recsys_serve_topk(smoke, cpu, sseq, k=RECSYS_K)
    check(state_gap <= RECSYS_STATE_TOL,
          f"recsys (c): smoke states differ by {state_gap}")
    check(torch.equal(ig.cpu(), ic), "recsys (c): smoke top-k ids on the "
          "card differ from the CPU's")

    emit("recsys", arch=cfg.name, dtype=str(cfg.dtype).split(".")[-1],
         table_rows=cfg.table_rows, table_bytes=table_bytes,
         n_params=cfg.n_params(), init_s=init_s, k=RECSYS_K, runs=runs,
         k5_launches=k5_launches, profile=profile,
         check_a_bit_equal=True,
         check_b=dict(max_value_gap=gap_v, ranks_compared=share,
                      tol=RECSYS_TOPK_TOL),
         check_c=dict(config=smoke.name, max_state_gap=state_gap,
                      topk_ids_equal=True))
    del model
    torch.cuda.empty_cache()
    return bag_rows, k5_launches


def kernel_entry(name, source, replaces, launches, row) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["ref_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="skip the full-size runs")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core.rcb import rcb_order
    from repro_torch.kernels.ell_spmv import cuda
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.segment_sum import cuda as ss_cuda
    from repro_torch.mesh import box_mesh, dual_graph

    # fp32 products in full fp32 (the plain versions and the fp32 LM)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # One nvcc per source, started together.
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        built = list(pool.map(lambda mod: mod.build(),
                              (cuda, ss_cuda, fa_cuda, eb_cuda)))
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[path.name for path, _ in built],
         ptxas=[ln for _, report in built for ln in report.splitlines()
                if "entry function" in ln or "registers" in ln or "spill" in ln])

    box = box_mesh(80, 64, 48)
    root = dual_graph(box).sub(rcb_order(box.coords, box.weights))  # level 0
    # Everything is timed before the first torch.profiler session; the
    # profile functions hold the kernel phase's tensors until they are
    # dropped, before the full-size runs measure peak memory.
    k1_rows, k1_profiles = phase_kernels(root)
    k2_rows, k2_profiles = phase_kernels_batched(root)
    k1_profiles()
    k2_profiles()
    del k1_profiles, k2_profiles
    phase_quality()
    k1_launches = k2_launches = None
    ss_launches = {"K3": None, "K4": None}
    if not args.quick:
        k1_launches, geometric_cut, full_ctx = phase_full(box)
        k2_launches = phase_full_inverse(box, geometric_cut)
        ss_launches, fp, sweep_parts = phase_full_sharded(full_ctx)
        del full_ctx
    else:
        fp, sweep_parts = quick_plan(box)
    ss_rows = phase_kernels_segsum(fp, sweep_parts)
    del fp, sweep_parts
    fa_rows = phase_kernels_flash()
    k6_launches = phase_serve()
    bag_rows, k5_launches = phase_recsys()

    def main_f32(rows):
        return next(r for r in rows
                    if r["case"] == "main" and r["dtype"] == "float32")

    def segsum_row(case):
        r = ss_rows[case]
        return dict(r, kernel_ms=r["dev_ms"])   # see ``dev_ms_by``

    # K6 at the `requests` prefill's shape, bf16, by device time
    flash_row = dict(fa_rows[("prefill", "bfloat16")],
                     kernel_ms=fa_rows[("prefill", "bfloat16")]["dev_ms"])

    # K5 at the retrieval lookup's shape (10^6 bags of one), fp32, by
    # device time
    bag_row = dict(bag_rows[("retrieval", "float32")],
                   kernel_ms=bag_rows[("retrieval", "float32")]["dev_ms"])

    src = "src/repro_torch/kernels/ell_spmv/csrc/ell_spmv.cu"
    ss_src = "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu"
    print(json.dumps({"kernels": [
        kernel_entry("ell_spmv", src, "src/repro/kernels/ell_spmv/kernel.py:45",
                     k1_launches, main_f32(k1_rows)),
        kernel_entry("ell_spmv_batched", src,
                     "src/repro/kernels/ell_spmv/kernel.py:81", k2_launches,
                     main_f32(k2_rows)),
        kernel_entry("segment_sum", ss_src,
                     "src/repro/kernels/segment_sum/kernel.py:49",
                     ss_launches["K3"], segsum_row("K3 root")),
        kernel_entry("segment_sum_batched", ss_src,
                     "src/repro/kernels/segment_sum/kernel.py:92",
                     ss_launches["K4"], segsum_row("K4 main")),
        kernel_entry("flash_attention",
                     "src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention.cu",
                     "src/repro/kernels/flash_attention/kernel.py:86",
                     k6_launches, flash_row),
        kernel_entry("embedding_bag",
                     "src/repro_torch/kernels/embedding_bag/csrc/"
                     "embedding_bag.cu",
                     "src/repro/kernels/embedding_bag/kernel.py:42",
                     k5_launches, bag_row),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
