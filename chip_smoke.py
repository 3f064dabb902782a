#!/usr/bin/env python3
"""Drive the PyTorch port (`repro_torch`, under src/) on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # no full-size runs (phases 5-7c;
                                     # 7a on RCB labels of the full box)

Phases, each printing JSON lines:

1. ``device``  — the card's name, and ``nvidia-smi``'s name and power limit
   (also printed raw on a line of its own).
2. ``build``   — compile K1 and K2 (both in kernels/ell_spmv/csrc/
   ell_spmv.cu), K3 and K4 (both in kernels/segment_sum/csrc/
   segment_sum.cu), K6 (kernels/flash_attention/csrc/flash_attention.cu),
   K6's backward (kernels/flash_attention/csrc/flash_attention_bwd.cu)
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
   ``obs_overhead``: one packed Lanczos solve of one restart profiled with
   tracing off, on, and on with the profiler ranges: the same CUDA events
   by name (kernels and copies) in all three.  Every timing is taken
   before the first profiler session, the gather-scatter one of phase 4c
   included.
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
   4319), K4 launches against the sweeps run.  ``obs``: ``default``
   with ``REPRO_OBS`` off and on (labels bit-identical, both walls, the
   trace's counters), then once in a profiler capture under
   ``REPRO_OBS_TORCH=1``: every K1 kernel in the capture launched inside
   a ``fiedler:lanczos…`` range (joined by correlation id).
   ``guard`` — on the quality mesh, ``default`` and ``rsb_inverse`` (AMG)
   with the guard on and off on the card (labels bit-identical, the guard's
   report clean); the two-component graph (``grid_graph_2d(12, 11)`` and
   ``(7, 9)``, no coords) at 2, 4 and 5 parts, the card's default labels
   against the CPU's, cuts beside `repro`'s (0, 20, 28); the
   ``multilevel-quality`` and ``multilevel`` presets, cut within 1.05 x the
   recorded JAX cut (8916).
   ``chaos`` — ``benchmarks/smoke_check.py::check_chaos``'s mesh
   (``pebble_mesh(8, 8, 8, n_pebbles=3, seed=0)``, 8 parts) under each
   fault site on the card: full labels, 0 disconnected parts, weighted
   imbalance <= 1.10, the guard report equal to the CPU port's for the same
   configuration, fallbacks > 0 (``halo_truncate``: the plan rebuilt clean,
   no host fallback); K1 launches inside ``solver_nan``'s rescues, K2 in
   ``cg_divergence``, K4 after ``halo_truncate``'s rebuild; the trace's
   ``guard_fallbacks`` and ``guard_retries`` equal to the report's
   (``benchmarks/smoke_check.py::check_chaos``), and for
   ``halo_truncate`` the one rebuild.
4c. ``reference`` — the ``reference`` preset (the recursive engine on the
   matrix-free gather-scatter Laplacian) on the quality mesh into 16
   parts: card labels equal to the CPU's, the cut within 1.05 x the JAX
   cut (8918, BENCH_partition.json's ``rsb_weighted_recursive``), the
   invariants, a clean guard report; ``engine="recursive"`` on its dual
   graph as a Graph (K1 every matvec, counted by the profiler); the
   recursive AMG-preconditioned inverse solve on the 959-element mesh (K1
   in the AMG levels); and ``gs_against_ell``: at the full box's root
   shape (N = 262144) the GS apply against K1's ELL Laplacian of the same
   dual graph within 1e-5 of Σ|terms|, bit-identical on a second call,
   and device ms by CUDA events of one GS apply (the port's ordered
   gather; float32 atomics and ``segment_reduce`` beside it), one K1
   matvec and one ELL apply, each beside its bound (each input read once
   over 3.35 TB/s).
5. ``full``    — ``box_mesh(80, 64, 48)`` (245,760 elements) into 64 parts,
   ``default`` preset (Lanczos, K1, guarded by default), on the card:
   seconds per stage (host and device; ``guard:validate`` and
   ``guard:finalize`` among them, and finalize's check re-run part by
   part: ``finalize_split``), per level, K1 launches, peak device memory,
   the cut against the ``geometric`` preset's; the guard's report must be
   clean (no retry, fallback, expired deadline or host fallback).  This
   phase, ``full_inverse``, ``full_sharded`` (one trace per chain:
   ``sharded_gathers == sharded_sweeps`` = the chain's gathers) and
   ``full_reference`` print their trace's span tree at depth 2 and put its
   root counters in their line.
6. ``full_inverse`` — the same box and parts by AMG-preconditioned inverse
   iteration (the paper's solver, K2): the same records plus inner flexcg
   iterations per level; the cut against the ``geometric`` cut of ``full``;
   ``finalize_split``; a clean guard report.
7. ``full_sharded`` — the post chains of ``run_sharded`` on ``full``'s raw
   labels (no second eigensolve): ``repair+refine`` on the host, then
   ``repair+refine-sharded`` and ``kway-sharded`` (8 sweeps, K4 every
   sweep) on the card: seconds split into plan build, sweeps and host
   admission, halo, w, m, moves and K4 launches per sweep, peak memory,
   cuts; the sharded cut within 1% of the host refined cut; the card's
   sweep labels against the NumPy mirror's on the same plan, from the raw
   labels and from a seeded perturbation of them (2% of the elements).
   Each chain runs in the guard's post-stage envelope; its report must be
   clean.
7a. ``dist`` — the distribution layer across processes on the card
   (`phase_dist`): four gloo ranks sharing the card (their collectives
   through the host) and one NCCL rank (a real communicator whose gathers
   degenerate), spawned together after the kernels are built, each with
   one torch thread and a ``file://`` rendezvous.  (a) The 959-element
   protocol's chains on both groups: labels = the one-process card
   labels of phase 4, cuts within 1.05 x 4679 / 4319, K4 = gathers =
   sweeps on every rank; (b) both sharded chains of ``full_sharded`` on
   ``full``'s raw labels across the 4 ranks (G = 16), guarded: labels =
   ``full_sharded``'s bit for bit, gathers = sweeps, the sweep seconds and
   the bytes a sweep gathers; (c) the halo matvec under a 4-shard RCB plan
   of the full box's dual graph against K1's ELL matvec on one process
   (1e-5 of max|y|); (d) the distributed gather-scatter Laplacian of the
   full box (4 blocks of elements; 1 under NCCL) against the one-process
   apply (1e-5 of Σ|terms|); (e) ``ring_allreduce`` against ``all_reduce``
   (bit-equal on integer-valued floats, 1e-6 otherwise); (f)
   ``fiedler_pair_from_graph`` on the quality mesh's dual graph on the
   card (K1 launches > 0, counted from 0 just before) against the CPU's
   (λ₂, λ₃ within 1e-4, the pair's span cos ≥ 0.999); (g) the halo
   GraphCast at full width (16 × 512, 227 vars, recompute on) on
   ``stencil_graph_3d(16, 16, 16)`` split by the RSB ``default`` preset
   into 4 parts (NCCL: one shard): every rank's forward block, loss and
   all-reduced gradients against the one-process full-graph run on the
   card (1e-4 of max), the ranks' gradients bit-equal, the plan's words
   per feature beside an RCB plan's.  A rank that fails fails the phase.  Under ``--quick`` the full-width inputs are RCB labels
   of the box with 0.2% moved at random and their one-process chains.
7b. ``full_multilevel`` — the ``multilevel`` preset (host V-cycle, no
   kernel: launches checked 0) on ``box_mesh(40, 32, 24)`` into 64 parts:
   seconds per stage, the V-cycle's levels, coarsest size and solver, FM
   and balance moves, the cut within 1.01 x `repro`'s 137,965, a clean
   guard report.  The full box's run (~75 s of host NumPy, no kernel) is
   not repeated here: the CPU tests hold the V-cycle to `repro` bit for
   bit.
7c. ``full_reference`` — the ``reference`` preset on the same box into 64
   parts (every node on its sub-mesh's gather-scatter Laplacian): seconds
   per stage split host / device, per level, kernel launches, the trace's
   counters, one GS Lanczos restart at the root shape profiled (wall ms,
   CUDA kernels, device ms), the cut within 1.05 x the ``geometric`` cut
   of ``full``, the invariants and a clean guard report.
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
   ``long_decode`` one query over 4096 rows), at the MoE serve path's
   shapes (D = 128; deepseek-moe-16b, H = Hkv = 16: ``deepseek_prefill``
   B=4, S=512 and ``deepseek_decode`` B=4 over 576 rows with kv_len 575;
   qwen3-moe-30b-a3b, H = 32, Hkv = 4: ``qwen3_prefill``,
   ``qwen3_decode``), at tests/test_kernels.py's
   five shapes and one non-causal call: error, CUDA-event ms, profiler
   device ms, TFLOP/s, the kernel that ran (every bf16 call with Sq·G > 16
   must run ``flash_attention_kernel_bf16``, every call with Sq·G <= 16,
   fp32 and bf16, the split-KV ``flash_attention_kernel_decode``),
   the bound, the plain version's ms and one
   ``scaled_dot_product_attention`` call's ms by events (``library_ms``)
   and by the profiler over all its kernels (``library_dev_ms``; keys
   sliced to kv_len, an explicit mask where the queries are not top-left
   aligned).  The sliding window (FLASH_WINDOW_CASES, fp32 and bf16):
   ``window_prefill`` (tinyllama's heads, B 1, S = 8192, window 4096),
   ``window_decode`` (one query at position 524,287 over a 524,288-row
   cache slice, window 4096: its device ms is printed beside
   ``long_decode``'s, both reading 4,096 keys) and ``window_ragged`` (a
   window of 100, its lower edge mid-tile), each bound on the window's
   keys.  Then K6's gradient (``grad``): dq, dk, dv through its autograd
   function on the card (K6's forward, its backward kernel) against
   autograd through the plain version at the ``prefill`` shape, fp32
   (1e-5) and bf16 (2e-2 of each max), without and with a window of 128,
   with both passes' ms beside SDPA's forward and backward on the same
   inputs and the pair's bound, and the backward kernel's own device ms
   (the profiler, its two kernels), plain ms and bound; and at
   ``train_4k`` (``train``'s attention: B 4, S 4096, tinyllama's heads,
   bf16) the backward kernel once against `ref.flash_attention_grads`
   (2e-2 of each max), its device ms a launch (bf16 at D >= 64: the route
   that reads the forward's output and logsumexp, given by the forward
   with ``return_lse``), SDPA's backward alone (its forward run once
   before; the kernels line's ``library_ms``), SDPA's forward and
   backward, the bounds (the table's 5 products; the route's own 7) and
   the mma.sync route's recorded device ms (RECORDED_BWD_DEV_MS, not
   measured in the run).
10. ``serve`` — `tinyllama-1.1b` at full width (``make_config()``, bf16,
    parameters from a seeded generator, built one layer at a time by
    `build_model`) through `launch.serve.generate`:
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
10a. ``serve_window`` — the sliding-window `tinyllama-1.1b`
    (``make_sliding_window_config(4096)``, full width, bf16, seeded
    weights, `build_model`): (a) the K6 model against the plain-attention
    model at a prompt of 8192 and one decode step, ≤ 3e-2 of max |logit|;
    (b) a prefill of 4,193 and 7 decode steps against one forward over
    4,200 tokens, ≤ 5e-2; (c) the smoke config with a window of 8, fp32,
    card against CPU (tokens identical, logits ≤ 1e-3).  Then the
    ``long_500k`` shape: batch 1, a 524,288-token prompt, prefill and 16
    decode steps: prefill s, p50/p99 step ms, peak memory, the cache's
    bytes, K6 launches (= 22 × 17); the last step profiled (K6's device
    ms at that position) and held to the plain attention over the whole
    cache with the window's mask (≤ 3e-2).
10b. ``train`` — `tinyllama-1.1b` at its published widths trained through
    `launch.cells.lm_train_step`: bf16 compute, fp32 masters and AdamW,
    remat, train_4k's sequence of 4096; the global batch cut from 256 to
    16 (4 microbatches of 4), one `token_batches` batch repeated; one
    unrecorded step, then 4: step s, tokens/s, 6·N·tokens / step s over
    989 TFLOP/s (remat's recompute not counted), peak memory, K6 launches
    (= 22 × 4 × 4 × 2: remat runs each layer's forward twice), K6's
    backward's (= 22 × 4 × 4) and K5's (= 4 × 4 × 2); one microbatch
    profiled, its attention backward's device ms (each launch's, and its
    share of the microbatch's device time) beside the plain
    recompute's in an earlier profile (PLAIN_BACKWARD_MS: ~980 ms of
    elementwise passes and 174.8 of fp32 products; copied from PERF.md,
    not measured in the run).  Checks: (a) the loss finite and lower after
    the 4 steps;
    (b) on one microbatch of 2 sequences, the loss and every gradient leaf
    with K6 against the plain attention, and a control's (the plain
    attention's output rounded to 4 mantissa bits, its gradient passed
    straight through): the loss's relative gap and the largest ‖Δ‖₂ /
    ‖g‖₂ over the leaves, each limit (TRAIN_LOSS_LIMIT,
    TRAIN_GRAD_LIMIT) between K6's reading and the control's; (c) the smoke config in fp32, 3 steps, card against CPU
    (loss and params ≤ 1e-5); (d) one step again from the first state:
    the same bits; (e) `fit` on the smoke config on the card, preempted
    after step 7 of 20 and resumed, bit-equal to an uninterrupted run; (f)
    a `CheckpointManager` save and restore of the full-width params and
    AdamW state in a temporary directory, timed, bit for bit.  Every
    check runs before the phase fails.  The unrecorded step runs under
    `FlopCounterMode`, and its peak of allocated memory is kept, for phase
    ``launch`` (b).
10c. ``serve_moe`` — ``deepseek-moe-16b`` (28 layers, 64 experts top-6 + 2
    shared), ``qwen3-moe-30b-a3b`` (48 layers, 128 experts top-8) and the
    dense ``command-r-35b`` (40 layers, d 8192) at full width in bf16, each
    built one layer at a time on the card (`build_model`: 33.8, 61.1 and
    64.8 GB of weights) after the earlier phases' tensors are freed, and
    freed before the next: ``requests`` and (MoE) ``long`` through
    `generate`, with ``serve``'s numbers, ``init_s``, weight bytes and K6
    launches (= layers x steps); one ``requests`` decode step profiled
    under ``REPRO_OBS_TORCH=1`` (device ms by ``moe:route`` /
    ``moe:dispatch`` / ``moe:experts`` / ``moe:combine`` / ``moe:shared``
    range and K6, joined by correlation id) beside its floor (every weight
    but the embedding and the cache's rows once over 3.35 TB/s: the
    static-capacity dispatch multiplies every expert each step); the share
    of (token, choice) pairs past capacity in the ``requests`` prefill,
    counted from the routing. The profiled step and the decode steps of
    (a) and (b) are fed seeded random ids (the greedy tokens of random
    weights repeat one id). Checks: (a) (MoE) a forward over the
    ``requests`` prompts, then their prefill and 32 teacher-forced steps
    with K6 against the plain attention, (b) (MoE) the prompts' prefill
    and 63 teacher-forced steps against one forward over the same 2,300
    tokens with capacity_factor = E / top_k (no drops), both with forward
    hooks on every MoE layer recomputing the expert sets: the share of
    (token, layer) pairs whose sets differ ((b)'s over the prefill's
    positions and over the steps') at most the arch's limit, and a
    control's — the same run with the plain attention's output rounded to
    4 mantissa bits in place of K6 — above it; the logit gaps (<= 3e-2 /
    5e-2 of max |logit|) over the rows routed alike in every layer; (c) the smoke
    config in fp32, card against CPU (tokens identical, logits <= 1e-3);
    (d) (MoE) one full-width MoE layer in fp32 at 512 tokens, card against
    CPU: expert ids and keep mask equal, y <= 1e-5 of max |y|, two card
    calls bit-identical. Every arch runs before the phase fails.
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

12b. ``recsys_train`` — `sasrec` at its published widths (fp32, AdamW)
    trained through `launch.cells.recsys_train_step` on train_batch's
    65,536 users × 50 (uncut): one unrecorded step, then 5: step ms,
    users/s, peak memory, K5 launches (6 a step: three lookups and their
    transposed-bag backward, each of those two kernels), one step
    profiled (K5's device ms beside the step's, the top kernels); K5's
    backward alone at the ``pos_items`` lookup's shape (3,276,800 entries
    into 1,000,448 rows) and at model rank 1's slice of two (500,224 rows,
    the foreign ~96% of the entries at row 0, weight 0): bit for bit
    against the run-order plain version, against one
    ``embedding_dense_backward`` call (1e-5 of each row's Σ|terms|), its
    device ms below that call's, timed beside its bound, the plain
    version and the whole backward with its sort.  Checks: (a)
    gradients with K5, with the plain lookups and their autograd, and
    with the plain ones in fp64: K5's largest gap to fp64 (of each leaf's
    max) at most 1.1 × the plain fp32 one's (two fp32 orders of a row's
    ~10^6 entries already differ by ~1e-5); (b) one step again from the
    first state: the same bits; (c) the smoke config, one step, card
    against CPU (loss and params ≤ 1e-5).  Every check runs before the
    phase fails.

13. ``gnn`` — the four GNNs of `repro` at their published widths (fp32,
    AdamW with ``OPT_CFG``, seeded parameters) through
    `launch.cells.gnn_train_step`: `meshgraphnet` (15 × 128) and
    `graphcast` (16 × 512, 227 vars) on ``full_graph_sm`` (``rmat_graph(
    2708, 5278)``, d_feat 1,433, padded to 10,556 edge slots) and
    ``minibatch_lg`` (`sample_neighbors` of 1,024 seeds, fan-out (15, 10),
    from ``rmat_graph(232965, 2000000)`` — the parent cut from 114.6M
    edges; the static capacity 169,984 × 168,960, d_feat 602), `nequip` (5
    × 32) and `mace` (2 × 128, ν 3) on ``molecule`` (128 × 30 atoms, 8,192
    edges): one unrecorded step and 3 timed (median), peak memory,
    ``gnn_model_flops`` over the step against 67 TFLOP/s, whether
    GraphCast recomputed its layers at ``minibatch_lg`` (the peak without
    recompute at 2 and 4 layers extrapolated to 16, against 70 GB).
    Checks: (a) the loss falls over the 4 steps (one cell an arch); (b)
    two identical steps give the same bits (`meshgraphnet` at
    ``minibatch_lg``, `mace`); (c) each smoke config, one step, card
    against CPU ≤ 1e-5; (d) `nequip` and `mace` energies at full width
    unchanged under a rotation and a translation (rtol 1e-4, atol 1e-3);
    (e) the ordered sum and `gather`'s backward against ``index_add_`` at
    ``minibatch_lg``'s destinations and sources, d 128 and 512: ≤ 1e-5 of
    Σ|terms|, the same bits twice, both device ms beside the bytes bound;
    (f) one GraphCast ``minibatch_lg`` step profiled: device ms, kernels,
    the top eight, the takes' and the sums' shares.  Every check runs
    before the phase fails.  No kernel of the port lies on this path.
14. ``shard`` — `repro`'s sharding rules across ranks: 4 gloo ranks
    sharing the card (their collectives through the host), then 1 NCCL
    rank at world size 1, each laying `DeviceMesh`es over its group; every
    LM runs sequence parallel (`lm_rules`: the residual stream each rank's
    slice of the sequence between blocks, a prompt of 512 over 4).
    (a) `mistral-large-123b` cut to 2 layers at full width, bf16, tensor
    parallel over ``model`` = 4 (`build_model` with `lm_rules`: each rank
    draws the layers and keeps its slices; vocab-parallel K5 lookup and
    head): a 4 × 512 prefill and 16 greedy steps against the one-process
    model of the same seed teacher-forced on the ranks' tokens —
    ‖Δ‖₂ / ‖ref‖₂ of the logit rows ≤ SHARD_GAP_LIMIT, a limit set between
    that reading and a control's (the one-process model with its attention
    rounded to 4 mantissa bits), which must exceed it; a token that
    differs from the one-process argmax only at a near tie; each rank's
    weight bytes beside the one-process total; the greedy run's bytes on
    the wire a rank (the census) equal to the dry run's census of the same
    run on meta tensors, beside that census without sequence parallelism
    (PR 30's layout).  (b) `deepseek-moe-16b`, 2 layers, ``impl="shardmap"``
    (expert parallelism), at the capacity factor E / top_k under which
    nothing drops, the same runs and gate; at the published capacity
    factor two prefills bit-identical as expert parallelism (capacity per
    rank) and two as the pjit dispatch (`repro`'s default: capacity from
    the global token count), each one's dropped share and capacities; the
    pjit prefill's last logits against the one-process published model's
    under (a)'s gate and control, the gloo ranks' the same bits, the NCCL
    rank's the one process's; one full-width MoE layer in fp32 on 512
    tokens against one-process `moe_apply`, ≤ 2e-4 of max|y|, as expert
    parallelism with no drops and as the pjit dispatch at the published
    capacity factor.  (c) a deepseek train step
    (1 layer, fp32 compute, no drops, no recompute; 4 × 256 tokens) on
    (data, model) = (2, 2): the loss within 2e-3 of the one-process
    step's; every rank's clipped gradient (AdamW's first moment after the
    step) within 1e-4 of each leaf's max from the one-process step's
    slices (saved by the parent, mapped by the ranks); every param further
    than 1e-4 of its leaf's max from the one-process step's lies where the
    one-process gradient is within 1e-4 of the leaf's max|g| of 0 (AdamW's
    first step moves an entry by lr · g / (|g| + eps): a gradient at the
    rounding's distance from 0 moves it either way); one step twice the
    same bits; its bytes on the wire as (a)'s.  (d) the NCCL rank runs (a)–(c) on (1, 1) meshes: tokens,
    logits, loss and params bit-identical to one process.  (e) the step's
    attention, norm, router and shared-expert leaves gathered from the
    (2, 2) mesh, saved by rank 0 and restored onto a (1, 2) mesh of ranks
    0 and 1, bit for bit.  (f) host only: each LM config's bytes a device
    under `param_specs_lm` on (16, 16) and on one 8-card node (1, 8), bf16
    weights and the fp32 train state, beside 80 GB.  (g) K6 at mistral's
    local heads (24 over 2; the prefill, and a decode step over a strided
    view of 2 of a cache's 8 KV heads) and K5's vocab-slice lookup (foreign
    ids at weight 0) against their plain versions, timed.  (h) SASRec
    across ranks at its published widths (fp32, a 1,000,448 × 50 table, 2
    blocks, sequence 50) under `recsys_rules` on (data 2, model 2) (NCCL:
    (1, 1)): the users over ``data``, the table's rows over ``model``, its
    three lookups vocab-parallel on K5: ``serve_p99`` (512 users, top-100
    streamed over each rank's rows, one gather of the winners),
    ``retrieval_cand`` (1 user × 10^6 candidates over ``model``) and
    SHARD_RECSYS_STEPS train steps on 8,192 users (``train_batch``'s
    65,536 cut: the gloo wire runs through the host), twice from one
    state, against the parent's one-process runs of the same seed: states
    and retrieval scores within 1e-5 of max, top-100 values within 1e-5
    and ids equal where the scores are more than 1e-5 apart, both losses
    within 1e-5 (relative), params within 1e-4 of each leaf's max, the
    two runs the same bits, K5's forward and backward launches on every
    rank; a control (each rank's rows shifted by one) must miss the
    states gate; K5 at model rank 1's slice of the sequence lookup (foreign
    ids at weight 0) against its plain version, timed beside its bound and
    ``F.embedding_bag``.  (i) The GNNs across ranks at their published
    widths (fp32, AdamW with ``OPT_CFG``), GraphCast cut to 8 of its 16
    layers (SHARD_GNN_LAYERS): MeshGraphNet and GraphCast on
    ``full_graph_sm``, NequIP and MACE on ``molecule``, under
    `gnn_rules` on (data 2, model 2) (NCCL: (1, 1)), each rank its stripe
    of the nodes and edges: SHARD_GNN_STEPS steps from one state and the
    first step again (its loss, first moment and params: the same bits),
    against the parent's one-process steps of the same seed: every loss
    within 1e-5 (relative), the clipped gradient (the first moment after
    one step) within 1e-4 of each leaf's max, every param after one step
    within 1e-4 of its leaf's max or at a gradient within 1e-4 of the
    leaf's max|g| of 0 (as (c)), the two runs the same bits, the NCCL
    rank bit for bit; a control (each gloo rank's node stripe taken from
    the next rank, its own edges) must miss the gradient gate; each arch's
    seconds a step per rank beside the one process's, and its
    collectives' bytes a step; the part (reference, slowest gloo rank,
    NCCL rank) within SHARD_GNN_SECONDS.  K6 and K5 launches are counted
    from 0 on every rank over (a)–(c) and (h) (K6 = 2 × 17 in (a) and (b)'s
    greedy runs on every rank, K5 = 17 on a gloo rank; (b)'s four
    published prefills add 8 K6 and 4 K5 a rank) and join the ``kernels``
    line.  Every check runs before the phase fails.
15. ``launch`` — the dry run (`repro_torch.launch.dryrun`), host work
    after every phase on the card, in LAUNCH_PROCS spawned processes: (a)
    every runnable cell of ``all_cells()`` on `repro`'s (16, 16) and (2,
    16, 16) production meshes over the H100 cluster, on meta tensors: one
    ``launch_cell`` line a cell (live GB a device, ``fits_80gb``, the
    dominant term, the roofline fraction, the three terms, the bound),
    beside the card's name and power limit; every cell must run, the 32
    GNN rows included (the sharded GNN step under `gnn_rules`).  (b) Phase
    ``train``'s step against its dry run on the card's one-device mesh
    (the exec pass at full depth, FLOPs and bytes by layer differencing):
    real / dry FLOPs (`FlopCounterMode` over ``train``'s unrecorded step)
    within LAUNCH_FLOP_GATE, real / dry peak (that step's) inside
    LAUNCH_MEM_GATE, the dry run's bound (``bound_s``, as each cell's
    record carries it: each op's own roofline summed over the step's ops,
    which an eager step runs one after another) / ``train``'s median step
    inside LAUNCH_TIME_GATE, and controls that must miss: the dry run with
    K6 counted as its plain version (each gate), and the depth-2 census
    taken for the whole step (the time gate, from below).  No launch of its own.
    Every check runs before the phase fails.

Then ``done`` (the script's seconds), the line ``{"kernels": [...]}``
(every ported kernel: launches on its
main path — K1 in ``full``, K2 in ``full_inverse``, K4 in the two sharded
chains of ``full_sharded`` (``dist`` prints its own per rank), K3 on none,
K6 in the two ``serve`` runs, ``serve_window``'s long_500k run, the 4
steps of ``train`` and the five ``serve_moe`` runs, K6's backward in the
4 steps of ``train`` and ``shard`` (c), K5 in the three
``recsys`` runs, the 5 steps of ``recsys_train`` and the 4 of ``train``,
and both in ``shard``'s ranks over (a)–(c) and K5 over (h),
with the counters set to 0 just before each
— error against the plain version, times and bound), the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits nonzero without the last line; so does a
machine without a CUDA card, or a directory that lacks the repository's
src/.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
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
QUALITY_REF_JAX_CUT = 8918.0  # BENCH_partition.json, quality, rsb_weighted_recursive
SMOKE_INV_RAW, SMOKE_INV_CUT = 4891.0, 4626.0   # partition_time_smoke, inverse
# BENCH_partition.json, partition_sharded: the three chains' JAX cuts
SHARDED_JAX_CUTS = {"repair+refine": 4690.0, "repair+refine-sharded": 4679.0,
                    "kway-sharded": 4319.0}
SHARDED_CHAINS = {"repair+refine": (("repair", "refine"), {}),
                  "repair+refine-sharded": (("repair", "refine-sharded"),
                                            {"sweeps": 8}),
                  "kway-sharded": (("kway-sharded",), {"sweeps": 8})}
# BENCH_partition.json, quality: the multilevel preset's cut (16 parts)
QUALITY_ML_JAX_CUT = 8916.0
# `repro`'s default (guarded) cuts on the two-component graph of
# two_grids() (repro/core/pipeline.py, CPU; ROADMAP Queue 3)
TWO_GRIDS_JAX_CUTS = {2: 0.0, 4: 20.0, 5: 28.0}
# `repro`'s multilevel cut of box_mesh(40, 32, 24) into 64 parts (CPU,
# NumPy 2.0.2), whose V-cycle the port reproduces bit for bit on the card's
# host (NumPy 2.3.5)
MEDIUM_ML_JAX_CUT = 137965.0
CHAOS_SITES = ("solver_nan", "empty_split", "cg_divergence", "deadline",
               "halo_truncate")
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
    # serve_moe's shapes: deepseek-moe-16b (MHA, G = 1) and
    # qwen3-moe-30b-a3b (G = 8), D = 128: requests prefill and decode
    "deepseek_prefill": (4, 512, 512, 16, 16, 128, None, None, True),
    "deepseek_decode": (4, 1, 576, 16, 16, 128, 574, 575, True),
    "qwen3_prefill": (4, 512, 512, 32, 4, 128, None, None, True),
    "qwen3_decode": (4, 1, 576, 32, 4, 128, 574, 575, True),
}
# K6 with a sliding window: FLASH_CASES' fields and the window.  The
# sliding-window tinyllama's prefill at 8192 (window 4096), its decode step
# at long_500k's last prompt position over a 524,288-row cache slice, and a
# window of 100 whose lower edge falls mid-tile
FLASH_WINDOW_CASES = {
    "window_prefill": (1, 8192, 8192, 32, 4, 64, None, None, True, 4096),
    "window_decode": (1, 1, 524288, 32, 4, 64, 524287, 524288, True, 4096),
    "window_ragged": (2, 700, 700, 32, 4, 64, None, None, True, 100),
}
# K6's gradient on the card: the `prefill` shape, without and with a window
FLASH_GRAD_CASE, FLASH_GRAD_WINDOW = "prefill", 128
FLASH_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# K6's backward at `train`'s attention (train_4k, tinyllama's heads, bf16):
# (B, S, H, Hkv, D)
FLASH_GRAD_TRAIN = (4, 4096, 32, 4, 64)
FLASH_BWD_KERNELS = "flash_bwd_"     # both backward kernels' names hold it
# K6's backward at train_4k before the saved-statistics route: the mma.sync
# route's device ms on one H100 80GB HBM3 at 700 W (PERF.md §6, K6's row);
# printed beside the run's own reading, not measured in it
RECORDED_BWD_DEV_MS = 6.5812
# the plain attention backward (`ref.flash_attention_grads`) in a profiled
# tinyllama microbatch on one H100 before the backward kernel (PERF.md §5):
# ms of elementwise passes over the scores and of fp32 products
PLAIN_BACKWARD_MS = (980.0, 174.8)
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
SERVE_SMOKE_TOL = 1e-3     # (c) smoke logits, card vs CPU, fp32
# serve_moe: the archs at full width, each built one layer at a time
# serve_window: make_sliding_window_config(4096) at full width, bf16
SERVE_WINDOW = 4096
SERVE_WINDOW_PROMPT_A = 8192   # (a) prompt (batch 1)
SERVE_WINDOW_SEQ_B = 4200      # (b) tokens: a prefill of 4193, 7 steps
SERVE_WINDOW_SMOKE = 8         # (c) the smoke config's window
LONG_500K = (1, 524288, 16)    # long_500k: batch, prompt, decode steps
# train: tinyllama at its published widths, train_4k's sequence; the
# global batch cut from 256 to 16 (4 microbatches of 4)
TRAIN_BATCH, TRAIN_MICRO, TRAIN_SEQ, TRAIN_STEPS = 16, 4, 4096, 4
TRAIN_GRAD_ROWS = 2            # (b): one microbatch of 2 sequences
TRAIN_CONTROL_BITS = 4         # (b)'s control: the plain attention's output
                               # rounded to 4 mantissa bits
# (b): over the gradient leaves, the largest ‖Δ‖₂ / ‖g‖₂ against the plain
# attention's, its limit between K6's reading (0.0100) and the control's
# (0.0273-0.0285) on the card; the loss's relative gap does not separate
# the two (both 1e-6-2e-5, PERF.md §6) and is held to a bound
TRAIN_GRAD_LIMIT = 0.0165
TRAIN_LOSS_TOL = 1e-4
TRAIN_SMOKE_TOL = 1e-5         # (c) loss (relative) and params, card vs CPU
TRAIN_FIT = (20, 7)            # (e) steps, preempted after this step
# recsys_train: sasrec at its published widths, train_batch's users
RECSYS_TRAIN_STEPS = 5
RECSYS_TRAIN_TOL = 1e-5        # (c) card vs CPU
RECSYS_TRAIN_FP64_SLACK = 1.1  # (a) K5's gap to fp64 over the plain one's
SERVE_MOE_ARCHS = ("deepseek-moe-16b", "qwen3-moe-30b-a3b", "command-r-35b")
SERVE_MOE_STEPS_A = 32     # teacher-forced decode steps of check (a)
# Routing flips: the share of (token, layer) pairs whose expert sets differ,
# (a) between K6 and the plain attention and (b) between the prefill and
# decode steps and the forward over the same positions (the prefill's
# positions and the steps' apart), is at most the arch's limit, and each
# control's, the plain attention with its output rounded to
# SERVE_MOE_CONTROL_BITS explicit mantissa bits (bf16 keeps 7) in place of
# K6, above it.  Each limit lies between the two readings on the H100
# (PERF.md §6, PR 24)
SERVE_MOE_FLIP_MAX = {"deepseek-moe-16b": 0.055, "qwen3-moe-30b-a3b": 0.1}
SERVE_MOE_CONTROL_BITS = (4,)
MOE_LAYER_TOKENS = 512     # (d) one full-width MoE layer, card vs CPU
MOE_LAYER_TOL = 1e-5       # (d) of max|y|, fp32
# (d) least top-k router-logit margin of the input: logits are O(1) sums
# of 2,048 fp32 products, rounded ~1e-6 apart by two summation orders
MOE_LAYER_MARGIN = 1e-4
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


def profiled_call_ms(fn, calls=20, sessions=6):
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


def trace_counters(tag, trace) -> dict:
    """A traced run's root counters (its subtree totals, `repro`'s merge
    semantics); its span tree at depth 2 goes out first, on lines of its
    own.  A missing trace fails: ``REPRO_OBS`` is on by default."""
    from repro_torch import obs

    check(trace is not None, f"{tag}: no trace recorded (REPRO_OBS off?)")
    print(f"[trace {tag}]\n" + obs.render(trace, max_depth=2), flush=True)
    return trace.total_counters()


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
                 top=top_kernels(by_name)),
             obs_overhead=obs_restart_check(op, N, n_seg, seg, mask, q))

    return rows, profile_and_emit


def obs_restart_check(op, N, n_seg, seg, mask, q) -> dict:
    """One packed Lanczos solve of one restart (`lanczos_fiedler_batched`,
    ``max_restarts=1``) profiled with tracing off, on (inside a trace) and
    on with the profiler ranges (``REPRO_OBS_TORCH=1``): the CUDA events
    by name — kernels and copies — must be the same in all three, so the
    obs layer adds no kernel and no device-to-host copy."""
    import os

    from repro_torch import obs
    from repro_torch.core.lanczos import lanczos_fiedler_batched

    b0 = q.cpu().numpy()

    def solve():
        lanczos_fiedler_batched(op, N, seg=seg, n_seg=n_seg, mask=mask,
                                b0=b0, window=20, max_restarts=1, tol=0.0)

    counts = {}
    solve()
    for mode in ("off", "on", "on+ranges"):
        if mode == "on+ranges":
            os.environ["REPRO_OBS_TORCH"] = "1"
        try:
            if mode == "off":
                with obs.disabled():
                    by_name = device_profile(solve, warmup=1)
            else:
                with obs.trace("bench:obs_restart"):
                    by_name = device_profile(solve, warmup=1)
        finally:
            os.environ.pop("REPRO_OBS_TORCH", None)
        counts[mode] = {k: v[0] for k, v in by_name.items()}
    row = {mode: dict(cuda_events=sum(c.values()),
                      memcpy_dtoh=sum(n for k, n in c.items() if "DtoH" in k))
           for mode, c in counts.items()}
    row["identical"] = counts["off"] == counts["on"] == counts["on+ranges"]
    check(row["identical"], f"obs overhead: the restart's CUDA events differ "
          f"with obs on: {row}")
    check(row["off"]["cuda_events"] > 0, "obs overhead: nothing traced")
    return row


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


def gs_apply_variant(L, x, seg=None):
    """The gather-scatter Laplacian's apply with another segment sum in
    place of the port's ordered gather — float32 atomics (``index_add_``),
    or with ``seg`` = (perm, offsets) ``torch.segment_reduce`` over the
    ids sorted once: the alternatives the port did not take, timed beside
    it only."""
    (_, h), = L.terms
    K = h.gid.shape[-1]
    u = x[:, None].expand(x.shape[0], K).reshape(-1)
    if seg is None:
        summed = torch.zeros(h.occ.shape[1], device=x.device).index_add_(
            0, h.take, u)
    else:
        summed = torch.segment_reduce(u.index_select(0, seg[0]), "sum",
                                      offsets=seg[1])
    return L.degree_full * x - summed.index_select(0, h.take).view(-1, K).sum(-1)


def gs_against_ell(box, perm, root):
    """The gather-scatter Laplacian against K1's packed ELL Laplacian of
    the same dual graph at the root shape of the full box (the level-0
    packed layout: N = 262144 slots): agreement within 1e-5 of Σ|terms|
    on a seeded x, and device ms by CUDA events of one GS apply (the
    port's ordered gather; float32 atomics and ``segment_reduce`` beside
    it), one K1 matvec and the ELL apply, each beside its bound: every
    input read once and the output written once over 3.35 TB/s.  Timed
    before the first profiler session."""
    from repro_torch.core.fiedler import (_pack_layout, _packed_ell_laplacian,
                                          _packed_gs_laplacian)
    from repro_torch.kernels.ell_spmv import cuda

    offs, N, _, _, _ = _pack_layout([root.n], N_SLOTS, 64)
    t0 = time.perf_counter()
    gs = _packed_gs_laplacian([box.vert_gid[perm]], offs, N, device="cuda")
    torch.cuda.synchronize()
    gs_setup_s = time.perf_counter() - t0
    ell = _packed_ell_laplacian([root], offs, N, 32, device="cuda")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=N).astype(np.float32)).cuda()
    y_gs, y_ell = gs.apply(x), ell.apply(x)
    scale = torch.clamp(gs.degree_full * x.abs() + gs.adj_apply(x.abs()),
                        min=1.0)
    err = float(((y_gs - y_ell).abs() / scale).max())
    (_, h), = gs.terms
    K, M, n_used = h.gid.shape[-1], h.occ.shape[0], h.occ.shape[1]
    counts = torch.bincount(h.take, minlength=n_used)
    seg = (torch.argsort(h.take, stable=True),
           torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]))
    errs = {}
    for name, y in (("atomic", gs_apply_variant(gs, x)),
                    ("segment_reduce", gs_apply_variant(gs, x, seg))):
        errs[name] = float(((y - y_ell).abs() / scale).max())
    repeat_equal = bool(torch.equal(y_gs, gs.apply(x)))
    check(err <= 1e-5, f"GS against ELL: {err} > 1e-5 of the terms")
    check(repeat_equal, "GS apply: two calls on the card differ")
    gs_bytes = 2 * N * 4 + M * n_used * 8 + N * K * 8 + N * 4
    k1_bytes = 2 * ell.cols_t.numel() * 4 + 2 * N * 4
    ell_bytes = k1_bytes + N * 4
    row = dict(
        N=N, K=K, ids_used=n_used, max_multiplicity=M, w=ell.cols_t.shape[0],
        gs_setup_seconds=gs_setup_s, max_rel_err=err,
        max_rel_err_variants=errs, repeat_bit_identical=repeat_equal,
        gs_apply_ms=time_ms(lambda: gs.apply(x)),
        gs_apply_atomic_ms=time_ms(lambda: gs_apply_variant(gs, x)),
        gs_apply_segment_reduce_ms=time_ms(
            lambda: gs_apply_variant(gs, x, seg), reps=10, rounds=5),
        k1_matvec_ms=time_ms(lambda: cuda.ell_spmv_cuda(ell.cols_t,
                                                         ell.vals_t, x)),
        ell_apply_ms=time_ms(lambda: ell.apply(x)),
        gs_bound_ms=gs_bytes / HBM_BYTES_PER_S * 1e3,
        k1_bound_ms=k1_bytes / HBM_BYTES_PER_S * 1e3,
        ell_apply_bound_ms=ell_bytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes")
    return row


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


def run_chains(graph, raw, nparts, weights, device, guarded=False,
               names=tuple(SHARDED_CHAINS)) -> dict:
    """`run_sharded`'s post chains from one set of raw labels on ``device``:
    per chain the labels, cut, invariants, seconds (split for the sharded
    stage into plan build, sweeps and host admission), moves per sweep,
    K4 launches and peak device memory.  ``guarded``: each chain runs in
    the guard's post-stage envelope, as a guarded pipeline runs it (a
    ``SolverGuard`` of the default policy), and the row has its report.
    ``names``: the chains to run (all three by default)."""
    from repro_torch import obs
    from repro_torch.core.metrics import partition_metrics
    from repro_torch.core.pipeline import run_post_stages
    from repro_torch.core.refine import balance_corridor
    from repro_torch.guard import GuardPolicy, GuardReport, SolverGuard
    from repro_torch.kernels.segment_sum import cuda as ss_cuda

    floor, cap = balance_corridor(raw, nparts, weights, 0.05)
    out = {}
    for name in names:
        post, kw = SHARDED_CHAINS[name]
        post_kw = dict(kw)
        greport = GuardReport() if guarded else None
        if guarded:
            post_kw["guard"] = SolverGuard(GuardPolicy(), seed=0,
                                           method="post", report=greport)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = ss_cuda.BATCHED_LAUNCHES
        t0 = time.perf_counter()
        with obs.trace(f"bench:sharded/{name}") as root:
            parts, agg, records = run_post_stages(graph, raw, nparts, post,
                                                  weights=weights,
                                                  post_kw=post_kw,
                                                  device=device)
        wall = time.perf_counter() - t0
        pm = partition_metrics(graph, parts, nparts, weights=weights)
        pw = np.bincount(parts, weights=weights, minlength=nparts)
        row = dict(parts=parts, cut=pm.edge_cut,
                   disconnected=pm.disconnected_parts,
                   corridor=bool(pw.min() >= floor and pw.max() <= cap),
                   nonempty=int((np.bincount(parts, minlength=nparts) > 0).sum()),
                   seconds=wall, k4_launches=ss_cuda.BATCHED_LAUNCHES - before,
                   stages=[dict(name=r.name, seconds=r.seconds,
                                steps=r.info["stages"]) for r in records],
                   moves_per_sweep=[r.moves for r in agg.sweeps],
                   trace=root)
        if guarded:
            row["guard"] = dict(report=greport.to_dict(),
                                host_fallback=host_fallbacks(records))
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
        c = r["trace"].total_counters()
        check(c.get("sharded_gathers") == c.get("sharded_sweeps")
              == r["gathers"] and c.get("halo_bytes") == 4 * c["halo_words"],
              f"{tag} {name}: trace counters {c} against {r['gathers']} "
              "gathers")
        if name == "repair+refine-sharded":
            check(r["cut"] <= 1.01 * host,
                  f"{tag}: sharded cut {r['cut']} above 1.01 x the host "
                  f"refined cut {host}")


def chain_rows(runs) -> dict:
    return {k: {kk: (vv.total_counters() if kk == "trace" else vv)
                for kk, vv in v.items() if kk != "parts"}
            for k, v in runs.items()}


def host_fallbacks(records) -> list:
    """The post stages whose sharded sweeps degraded to the host refiner."""
    return [r.name for r in records
            if r.kind == "post" and "host-fallback" in r.info["stages"]]


def guard_row(ctx) -> dict:
    """The guard's part of a pipeline run: its stages' seconds and report."""
    secs = {s.name: s.seconds for s in ctx.stages if s.kind == "guard"}
    gr = ctx.report.guard
    return dict(validate_s=secs.get("validate"),
                finalize_s=secs.get("finalize"),
                report=None if gr is None else gr.to_dict(),
                host_fallback=host_fallbacks(ctx.stages))


def finalize_split(ctx, nparts) -> dict:
    """``guard:finalize``'s check re-run part by part on the run's final
    labels and graph (the same work as `check_output`): the same-part edge
    filter, `connected_labels`, the two ``np.unique`` counts and the
    corridor's ``bincount``, in host seconds; and the rounds of
    `connected_labels`' min-label propagation and its pointer-doubling
    steps, counted by a copy of its loop."""
    from repro_torch.mesh.graphs import connected_labels

    g, p = ctx.require_graph(), np.asarray(ctx.parts)
    t0 = time.perf_counter()
    same = p[g.rows] == p[g.indices]
    src, dst = g.rows[same], g.indices[same]
    t1 = time.perf_counter()
    labels = connected_labels(g.n, src, dst)
    t2 = time.perf_counter()
    fragments = int(np.unique(labels).size - np.unique(p).size)
    t3 = time.perf_counter()
    np.bincount(p, weights=ctx.weights, minlength=nparts)
    t4 = time.perf_counter()
    label, rounds, doublings = np.arange(g.n, dtype=np.int64), 0, 0
    while src.size:
        rounds += 1
        m = np.minimum(label[src], label[dst])
        np.minimum.at(label, src, m)
        np.minimum.at(label, dst, m)
        while True:
            nxt = label[label]
            if np.array_equal(nxt, label):
                break
            label, doublings = nxt, doublings + 1
        if (label[src] == label[dst]).all():
            break
    return dict(filter_s=t1 - t0, connected_labels_s=t2 - t1,
                unique_s=t3 - t2, bincount_s=t4 - t3, fragments=fragments,
                rounds=rounds, doublings=doublings)


def check_clean(tag, row) -> None:
    """A healthy full-size run: guarded, no retry, fallback or expired
    deadline, and no sharded stage on the host fallback."""
    rep = row["report"]
    check(rep is not None, f"{tag}: the run was not guarded")
    check(rep["retries"] == rep["fallbacks"] == 0
          and not rep["deadline_expired"] and not row["host_fallback"],
          f"{tag}: guard report not clean: {rep}, host fallback in "
          f"{row['host_fallback']}")


def two_grids():
    """One graph of two `grid_graph_2d` components (12x11 and 7x9), no
    coords: the input on which an unguarded default run differs from
    `repro`'s guarded one."""
    from repro_torch.mesh import grid_graph_2d
    from repro_torch.mesh.graphs import build_csr

    a, b = grid_graph_2d(12, 11), grid_graph_2d(7, 9)
    return build_csr(np.concatenate([a.rows, b.rows + a.n]),
                     np.concatenate([a.indices, b.indices + a.n]), a.n + b.n,
                     weights=np.concatenate([a.weights, b.weights]),
                     symmetrize=False)


def phase_guard():
    """The guard on the quality mesh: guard on against guard off on the
    card (bit-identical labels), the two-component graph's default labels
    on the card against the CPU's, and the multilevel presets' cuts."""
    from repro_torch.core.pipeline import partition
    from repro_torch.core.refine import edge_cut
    from repro_torch.kernels.ell_spmv import cuda
    from repro_torch.mesh import pebble_mesh

    mesh = pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1)
    onoff = {}
    for name, bkw in (("default", {}), ("rsb_inverse_amg", INVERSE_AMG)):
        row = {}
        ctxs = {}
        for guard in (True, False):
            before = cuda.LAUNCHES + cuda.BATCHED_LAUNCHES
            ctx, pm, wall, corridor, nonempty = run_preset(
                "default", mesh, 16, "cuda", bisect_kw=bkw, guard=guard)
            ctxs[guard] = ctx
            row["on" if guard else "off"] = dict(
                cut=pm.edge_cut, seconds=wall,
                launches=cuda.LAUNCHES + cuda.BATCHED_LAUNCHES - before)
        on, off = ctxs[True], ctxs[False]
        row["guard"] = guard_row(on)
        row["identical"] = bool(np.array_equal(on.parts, off.parts)
                                and np.array_equal(on.parts_raw, off.parts_raw))
        onoff[name] = row
        check(row["identical"], f"guard {name}: guarded labels differ from "
              "the unguarded run's on the card")
        check_clean(f"guard {name}", row["guard"])
        check(off.report.guard is None, f"guard {name}: guard=False guarded")

    g = two_grids()
    two = {}
    for k, jax_cut in TWO_GRIDS_JAX_CUTS.items():
        card = partition(g, k, device="cuda")
        cpu = partition(g, k, device="cpu")
        two[k] = dict(cut=edge_cut(g, card), jax_cut=jax_cut,
                      equal_to_cpu=bool(np.array_equal(card, cpu)))
        check(two[k]["equal_to_cpu"], f"guard two_grids {k}: card labels "
              "differ from the CPU's")

    ml = {}
    for preset in ("multilevel-quality", "multilevel"):
        ctx, pm, wall, corridor, nonempty = run_preset(preset, mesh, 16,
                                                       "cuda")
        ml[preset] = dict(cut=pm.edge_cut, seconds=wall,
                          disconnected=pm.disconnected_parts,
                          corridor=corridor, levels=ctx.report.ml.levels,
                          coarse_solver=ctx.report.ml.coarse_solver,
                          guard=guard_row(ctx))
        check(pm.disconnected_parts == 0 and corridor and nonempty == 16,
              f"guard {preset}: invariants")
        check(pm.edge_cut <= 1.05 * QUALITY_ML_JAX_CUT,
              f"guard {preset}: cut {pm.edge_cut} > 1.05 x "
              f"{QUALITY_ML_JAX_CUT}")
        check_clean(f"guard {preset}", ml[preset]["guard"])
    emit("guard", mesh="pebble_mesh(12,12,12,n_pebbles=5,warp=0.15,seed=1)",
         nparts=16, on_off=onoff,
         two_grids=dict(graph="grid_graph_2d(12,11) + grid_graph_2d(7,9)",
                        parts=two),
         multilevel=dict(jax_cut=QUALITY_ML_JAX_CUT, presets=ml))


def chaos_pipeline(site, device):
    """`benchmarks/smoke_check.py::check_chaos`'s configuration for one
    fault site: inverse iteration for ``cg_divergence``, the sharded chain
    for ``halo_truncate``."""
    from repro_torch.core.pipeline import PartitionPipeline

    return PartitionPipeline(
        pre="rcb", bisect="rsb-batched",
        post=(("repair", "refine-sharded") if site == "halo_truncate"
              else ("repair", "refine")),
        bisect_kw={"method": "inverse"} if site == "cg_divergence" else {},
        guard=True, guard_kw={"chaos": (site,)}, device=device)


def phase_chaos():
    """Each chaos site on ``pebble_mesh(8, 8, 8, n_pebbles=3, seed=0)``
    into 8 parts on the card: the output invariants, the guard report
    against the CPU port's for the same configuration, and the kernels
    where each site puts them (K1 inside the rescues of ``solver_nan``, K2
    in ``cg_divergence``, K4 after ``halo_truncate``'s plan rebuild)."""
    from repro_torch.dist import plan_halo_sharding, verify_halo_plan
    from repro_torch.guard import chaos, count_disconnected, policy
    from repro_torch.kernels.ell_spmv import cuda
    from repro_torch.kernels.segment_sum import cuda as ss_cuda
    from repro_torch.mesh import pebble_mesh

    mesh = pebble_mesh(8, 8, 8, n_pebbles=3, seed=0)
    w = np.asarray(mesh.weights, np.float64)
    rescue = {"K1": 0, "K2": 0}
    plain_rescue = policy.SolverGuard.rescue

    def counted_rescue(self, *a, **k):
        k1, k2 = cuda.LAUNCHES, cuda.BATCHED_LAUNCHES
        try:
            return plain_rescue(self, *a, **k)
        finally:
            rescue["K1"] += cuda.LAUNCHES - k1
            rescue["K2"] += cuda.BATCHED_LAUNCHES - k2

    rows = {}
    policy.SolverGuard.rescue = counted_rescue
    try:
        for site in CHAOS_SITES:
            rescue.update(K1=0, K2=0)
            k1, k2, k4 = (cuda.LAUNCHES, cuda.BATCHED_LAUNCHES,
                          ss_cuda.BATCHED_LAUNCHES)
            t0 = time.perf_counter()
            ctx = chaos_pipeline(site, "cuda").run(mesh, 8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"K1": cuda.LAUNCHES - k1,
                        "K2": cuda.BATCHED_LAUNCHES - k2,
                        "K4": ss_cuda.BATCHED_LAUNCHES - k4}
            in_rescue = dict(rescue)
            cpu = chaos_pipeline(site, "cpu").run(mesh, 8)
            gr = ctx.report.guard
            parts = ctx.parts
            pw = np.bincount(parts, weights=w, minlength=8)
            traced = trace_counters(f"chaos[{site}]", ctx.trace)
            row = dict(seconds=wall, launches=launches,
                       rescue_launches=in_rescue, report=gr.to_dict(),
                       trace_guard=dict(
                           fallbacks=traced.get("guard_fallbacks", 0.0),
                           retries=traced.get("guard_retries", 0.0),
                           deadline_expired=traced.get(
                               "guard_deadline_expired", 0.0)),
                       report_equal_to_cpu=gr.to_dict()
                       == cpu.report.guard.to_dict(),
                       labels_differing_from_cpu=int((parts != cpu.parts).sum()),
                       disconnected=count_disconnected(ctx.require_graph(),
                                                       parts, 8),
                       w_imb=float(pw.max() / (w.sum() / 8)),
                       host_fallback=host_fallbacks(ctx.stages))
            tag = f"chaos[{site}]"
            check(sorted(np.unique(parts)) == list(range(8)),
                  f"{tag}: labels do not cover 0..7")
            check(row["disconnected"] == 0, f"{tag}: disconnected parts")
            check(row["w_imb"] <= 1.10, f"{tag}: weighted imbalance "
                  f"{row['w_imb']:.3f} > 1.10")
            check(row["report_equal_to_cpu"], f"{tag}: guard report "
                  f"{gr.to_dict()} differs from the CPU port's "
                  f"{cpu.report.guard.to_dict()}")
            if site == "halo_truncate":
                # The plan self-check rebuilds the truncated plan, so the
                # sweeps run on the clean plan: no fallback, K4 launches.
                g = ctx.require_graph()
                clean = plan_halo_sharding(g, parts, 8)
                with chaos.overlay(("halo_truncate",)):
                    rebuilt = plan_halo_sharding(g, parts, 8)
                row["plan_rebuilt"] = bool(
                    not verify_halo_plan(rebuilt)
                    and np.array_equal(rebuilt.export_mask, clean.export_mask))
                check(row["plan_rebuilt"], f"{tag}: plan not rebuilt clean")
                check(not row["host_fallback"] and launches["K4"] > 0,
                      f"{tag}: K4 never launched after the rebuild")
                check(row["trace_guard"]["fallbacks"] == 1.0,
                      f"{tag}: trace guard_fallbacks "
                      f"{row['trace_guard']['fallbacks']}, not the one rebuild")
            else:
                check(gr.fallbacks > 0, f"{tag}: guard report shows no "
                      "fallbacks: the fault was not exercised")
                # benchmarks/smoke_check.py::check_chaos's trace check
                check(row["trace_guard"]["fallbacks"] == gr.fallbacks
                      and row["trace_guard"]["retries"] == gr.retries,
                      f"{tag}: trace guard counters {row['trace_guard']} "
                      f"differ from the report's {gr.to_dict()}")
            if site == "solver_nan":
                check(in_rescue["K1"] > 0, f"{tag}: no K1 in the rescues")
            if site == "cg_divergence":
                check(launches["K2"] > 0, f"{tag}: K2 never launched")
            if site == "deadline":
                check(gr.deadline_expired, f"{tag}: deadline not expired")
            rows[site] = row
    finally:
        policy.SolverGuard.rescue = plain_rescue
    emit("chaos", mesh="pebble_mesh(8,8,8,n_pebbles=3,seed=0)",
         nelems=mesh.nelems, nparts=8, sites=rows)


def quality_obs(mesh) -> dict:
    """The ``default`` preset on the quality mesh with ``REPRO_OBS`` off
    and on (labels bit-identical, both walls), then once under
    ``REPRO_OBS_TORCH=1`` in a profiler capture: every K1 kernel the
    capture holds was launched inside a ``fiedler:lanczos…`` range."""
    import os

    from repro_torch import obs
    from repro_torch.kernels.ell_spmv import cuda

    with obs.disabled():
        off, _, wall_off, _, _ = run_preset("default", mesh, 16, "cuda")
    on, _, wall_on, _, _ = run_preset("default", mesh, 16, "cuda")
    row = dict(seconds_off=wall_off, seconds_on=wall_on,
               identical=bool(np.array_equal(on.parts, off.parts)
                              and np.array_equal(on.parts_raw,
                                                 off.parts_raw)),
               trace_counters=trace_counters("quality default", on.trace))
    check(row["identical"], "quality obs: labels differ with REPRO_OBS off")
    check(off.trace is None, "quality obs: a trace with REPRO_OBS off")

    os.environ["REPRO_OBS_TORCH"] = "1"
    os.environ["REPRO_OBS_TORCH_DIR"] = str(ROOT / "build" / "torchprof")
    try:
        cap = obs.maybe_start_trace()
        before = cuda.LAUNCHES
        run_preset("default", mesh, 16, "cuda")
        launches = cuda.LAUNCHES - before
        path = obs.maybe_stop_trace(cap)
    finally:
        os.environ.pop("REPRO_OBS_TORCH", None)
        os.environ.pop("REPRO_OBS_TORCH_DIR", None)
    ranged = ranged_k1(path)
    row["profiler_ranges"] = dict(ranged, k1_launches=launches)
    check(0 < ranged["k1_kernels"] == ranged["k1_in_ranges"]
          and ranged["k1_kernels"] <= launches,
          f"quality obs: K1 kernels outside the fiedler:lanczos ranges: "
          f"{row['profiler_ranges']}")
    return row


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
    obs_rows = quality_obs(mesh)

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
         obs=obs_rows,
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
    return (ctx.require_graph(), ctx.parts_raw, ctx.weights,
            {k: v["parts"] for k, v in sharded.items()})


def phase_full(box):
    from repro_torch.kernels.ell_spmv import cuda

    torch.cuda.reset_peak_memory_stats()
    cuda.LAUNCHES = cuda.BATCHED_LAUNCHES = 0   # this path's counts start here
    ctx, pm, wall, corridor, nonempty = run_preset("default", box, 64, "cuda")
    launches = cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    counters = trace_counters("full", ctx.trace)
    _, gpm, gwall, _, _ = run_preset("geometric", box, 64, "cuda")
    guard = guard_row(ctx)
    emit("full", mesh="box_mesh(80,64,48)", nelems=box.nelems, nparts=64,
         trace_counters=counters,
         seconds=wall, stages=stage_split(ctx), levels=level_rows(ctx),
         k1_launches=launches, max_memory_allocated=peak, cut=pm.edge_cut,
         geometric_cut=gpm.edge_cut, geometric_seconds=gwall,
         disconnected=pm.disconnected_parts, w_imb=pm.weighted_imbalance,
         corridor=corridor, nonempty_parts=nonempty, guard=guard,
         finalize_split=finalize_split(ctx, 64))
    check_clean("full", guard)
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
    counters = trace_counters("full_inverse", ctx.trace)
    emit("full_inverse", mesh="box_mesh(80,64,48)", nelems=box.nelems,
         nparts=64, bisect_kw=INVERSE_AMG, seconds=wall,
         trace_counters=counters,
         stages=stage_split(ctx), levels=level_rows(ctx),
         k2_launches=launches, k1_launches=k1, max_memory_allocated=peak,
         cut=pm.edge_cut, geometric_cut=geometric_cut,
         disconnected=pm.disconnected_parts, w_imb=pm.weighted_imbalance,
         corridor=corridor, nonempty_parts=nonempty,
         precond=ctx.report.precond, guard=guard_row(ctx),
         finalize_split=finalize_split(ctx, 64))
    check_clean("full_inverse", guard_row(ctx))
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
    frontier plan of the raw labels (K4's ``main`` shape), the labels, and
    each chain's labels."""
    from repro_torch.kernels.segment_sum import cuda as ss_cuda

    g, raw, w = ctx.require_graph(), ctx.parts_raw, ctx.weights
    ss_cuda.LAUNCHES = ss_cuda.BATCHED_LAUNCHES = 0  # this path's counts
    runs = run_chains(g, raw, 64, w, "cuda", guarded=True)
    launches = {"K3": ss_cuda.LAUNCHES, "K4": ss_cuda.BATCHED_LAUNCHES}
    for name, r in runs.items():
        trace_counters(f"full_sharded {name}", r["trace"])
    check_chains("full_sharded", runs, 64)
    for name, r in runs.items():
        check_clean(f"full_sharded {name}", r["guard"])
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
    return launches, fp, raw, {k: v["parts"] for k, v in runs.items()}


# ---------------------------------------------------------------------------
# Phase 7a: the distribution layer across processes
# ---------------------------------------------------------------------------

DIST_WORLD = 4                # gloo ranks sharing the card
DIST_TIMEOUT = 600.0          # seconds the ranks of one group may take
DIST_TOL = 1e-5               # matvec and GS apply: of max|y| / Σ|terms|


def _dist_entry(rank, world, backend, workdir, payload_path):
    """One rank: a fresh group over a ``file://`` rendezvous, one torch
    thread, :func:`dist_rank` on the pickled payload, its result pickled
    next to it."""
    import pickle

    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":                 # NCCL takes the current device
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{workdir}/rdv",
                            rank=rank, world_size=world)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        out = dist_rank(payload)
        with open(f"{workdir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        from repro_torch.dist import group as dist_group

        dist_group.destroy()


def start_ranks(payload, world: int, backend: str):
    """Spawn ``world`` ranks of a fresh ``backend`` group running
    :func:`dist_rank` on ``payload`` (pickled once, read by each rank)."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.TemporaryDirectory(prefix=f"dist_{backend}_")
    path = f"{tmp.name}/payload.pkl"
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    ctx = mp.start_processes(_dist_entry,
                             args=(world, backend, tmp.name, path),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, tmp, world


def join_ranks(handle, timeout: float = DIST_TIMEOUT) -> list:
    """Every rank's result in rank order.  A rank that raises or dies
    raises here (`ProcessContext.join`, which stops the others), as does
    the timeout."""
    import pickle

    ctx, tmp, world = handle
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        check(time.monotonic() < deadline,
              f"dist: {world} ranks still running after {timeout} s")
    out = []
    for r in range(world):
        with open(f"{tmp.name}/rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def stop_ranks(handle) -> None:
    """Kill every rank of ``handle`` still running and remove its files."""
    ctx, tmp, _ = handle
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join()
    tmp.cleanup()


def dist_rank(payload) -> dict:
    """What one rank of the dist phase runs, each case on its card across
    the default group: the post chains of ``run_sharded`` (``smoke``, and
    the two sharded ones of ``full`` at full width, guarded), the halo matvec (``matvec``), the
    distributed GS Laplacian (``gs``: this rank's block of elements), the
    ring (``ring``: ``ring_allreduce`` and ``all_reduce`` of this rank's
    vectors) and the halo GraphCast (``halo``: `halo_rank`)."""
    import torch.distributed as dist

    from repro_torch.dist import (adjacency_matvec_distributed,
                                  dist_lap_apply_allreduce,
                                  plan_halo_sharding, ring_allreduce)
    from repro_torch.dist import group as dist_group

    r, world = dist.get_rank(), dist.get_world_size()
    out = {}
    # the smoke protocol whole; at full width the two sharded chains (the
    # host chain has nothing to spread over the ranks)
    for key, nparts, guarded, names in (
            ("smoke", 8, False, tuple(SHARDED_CHAINS)),
            ("full", 64, True, ("repair+refine-sharded", "kway-sharded"))):
        if key not in payload:
            continue
        g, raw, w = payload[key]
        runs = run_chains(g, raw, nparts, w, "cuda", guarded=guarded,
                          names=names)
        out[key] = {name: dict(
            parts=row["parts"], cut=row["cut"], k4=row["k4_launches"],
            gathers=row.get("gathers"), sweeps_run=row.get("sweeps_run"),
            halo=row.get("halo"),
            sweeps_s=row.get("sweeps_s"), admit_s=row.get("admit_s"),
            plan_s=row.get("plan_s"), seconds=row["seconds"],
            counters=row["trace"].total_counters(),
            guard=row.get("guard")) for name, row in runs.items()}
    if "matvec" in payload:
        g, parts, x = payload["matvec"]
        plan = plan_halo_sharding(g, parts, world)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = adjacency_matvec_distributed(plan, None, x)
        out["matvec"] = dict(y=y, seconds=time.perf_counter() - t0,
                             halo=plan.halo)
    if "gs" in payload:
        gid, x, deg, n_global = payload["gs"]
        rows = slice(r * len(x) // world, (r + 1) * len(x) // world)
        dev = dist_group.rank_device(None)
        args = (torch.from_numpy(gid[rows]).to(dev),
                torch.from_numpy(x[rows]).to(dev),
                torch.from_numpy(deg[rows]).to(dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = dist_lap_apply_allreduce(*args, n_global, None)
        torch.cuda.synchronize()
        out["gs"] = dict(y=y.cpu().numpy(), seconds=time.perf_counter() - t0)
    if "ring" in payload:
        dev = dist_group.rank_device(None)
        out["ring"] = {}
        for kind, xs in payload["ring"].items():
            x = torch.from_numpy(xs[r]).to(dev)
            out["ring"][kind] = (
                ring_allreduce(x, None).cpu().numpy(),
                dist_group.all_reduce_sum(x, dist.group.WORLD).cpu().numpy())
    if "halo" in payload:
        out["halo"] = halo_rank(payload["halo"])
    if "shard" in payload:
        out["shard"] = shard_rank(payload["shard"])
    return out


GNN_HALO_SIDE = 16             # dist (g): stencil_graph_3d(16, 16, 16)
GNN_HALO_TOL = 1e-4            # dist (g): of max|out|, of each leaf's max


def halo_rank(payload) -> dict:
    """Dist case (g) on one rank: the full-width halo GraphCast on this
    rank's shard of the payload's plan, its loss differentiated across the
    group with recompute (five processes share the card: 16 layers' saved
    activations of the whole graph take ~43 GB) and the gradients
    all-reduced; the forward block, the loss, a digest of the gradients
    (rank 0 also returns them), the seconds and the peak memory."""
    import hashlib

    import torch.distributed as dist

    from repro_torch.dist import group as dist_group
    from repro_torch.dist import plan_halo_sharding
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.gnn.halo import (graphcast_halo_local,
                                             graphcast_halo_loss,
                                             halo_batch_from_plan)
    from repro_torch.train.train_loop import value_and_grad

    g, parts, feat, tgt = payload
    r, world = dist.get_rank(), dist.get_world_size()
    dev = dist_group.rank_device(None)
    plan = plan_halo_sharding(g, parts, world)
    cfg = gnn_config("graphcast", None)
    p = tree_map(lambda t: t.to(dev), gnn_init("graphcast", cfg, "cpu"))
    b = halo_batch_from_plan(plan, feat, tgt, device=dev).shard(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = value_and_grad(
        lambda q, bb: graphcast_halo_loss(cfg, q, bb, remat=True))(p, b)
    grads = tree_map(lambda x: dist_group.all_reduce_sum(x, dist.group.WORLD),
                     grads)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        pred = graphcast_halo_local(cfg, p, b)
    leaves = [x.cpu().numpy() for x in tree_leaves(grads)]
    digest = hashlib.sha1(b"".join(x.tobytes() for x in leaves)).hexdigest()
    return dict(pred=pred.cpu().numpy(), loss=float(loss), digest=digest,
                grads=leaves if r == 0 else None, seconds=seconds,
                max_memory_allocated=peak, halo=plan.halo)


def halo_inputs():
    """Dist case (g)'s graph, its RSB ``default`` labels (4 parts, on the
    card), an RCB plan's labels beside them, and seeded features and
    targets at GraphCast's published width."""
    from repro_torch.configs.parrsb import make_pipeline
    from repro_torch.core.rcb import rcb_parts
    from repro_torch.mesh import grid_coords_3d, stencil_graph_3d

    s = GNN_HALO_SIDE
    g = stencil_graph_3d(s, s, s)
    coords = grid_coords_3d(s, s, s)
    t0 = time.perf_counter()
    rsb = make_pipeline("default", device="cuda").run(
        g, DIST_WORLD, coords=coords).parts
    rsb_s = time.perf_counter() - t0
    rcb = rcb_parts(coords, DIST_WORLD)
    cfg = gnn_config("graphcast", None)
    rng = np.random.default_rng(12)
    feat = rng.normal(size=(g.n, cfg.d_in)).astype(np.float32)
    tgt = (0.1 * rng.normal(size=(g.n, cfg.n_vars))).astype(np.float32)
    return g, rsb, rcb, feat, tgt, rsb_s


def halo_reference(g, feat, tgt) -> tuple:
    """The one-process full-graph GraphCast on the card: forward, loss and
    gradients (NumPy leaves, recompute on), with the ranks' weights."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.gnn import graphcast_forward, graphcast_loss
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.train.train_loop import value_and_grad

    cfg = gnn_config("graphcast", None)
    p = tree_map(lambda t: t.cuda(), gnn_init("graphcast", cfg, "cpu"))
    b = GraphBatch(node_feat=torch.from_numpy(feat),
                   edge_src=torch.from_numpy(g.indices.astype(np.int32)),
                   edge_dst=torch.from_numpy(g.rows.astype(np.int32)),
                   node_mask=torch.ones(g.n), edge_mask=torch.ones(g.nnz),
                   targets=torch.from_numpy(tgt)).to("cuda")
    with torch.no_grad():
        out = graphcast_forward(cfg, p, b).cpu().numpy()
    loss, grads = value_and_grad(lambda q, bb: graphcast_loss(
        cfg, q, bb, remat=True))(p, b)
    return out, float(loss), [x.cpu().numpy() for x in tree_leaves(grads)]


def halo_check(backend, ranks, g, parts, ref) -> dict:
    """Every rank of one group held to the one-process reference."""
    from repro_torch.dist import plan_halo_sharding

    out, loss, grads = ref
    plan = plan_halo_sharding(g, parts, len(ranks))
    scale = float(np.abs(out).max())
    fwd = []
    for r, rk in enumerate(ranks):
        rows = np.flatnonzero(plan.shard_of == r)
        got = rk["halo"]["pred"][plan.slot_of[rows]]
        fwd.append(float(np.abs(got - out[rows]).max()) / scale)
    loss_gaps = [abs(rk["halo"]["loss"] - loss) / abs(loss) for rk in ranks]
    grad_gap = max(float(np.abs(a - w).max()) / max(float(np.abs(w).max()),
                                                     1e-30)
                   for a, w in zip(ranks[0]["halo"]["grads"], grads))
    same = len({rk["halo"]["digest"] for rk in ranks}) == 1
    check(max(fwd) <= GNN_HALO_TOL and max(loss_gaps) <= GNN_HALO_TOL
          and grad_gap <= GNN_HALO_TOL and same,
          f"dist {backend} halo GraphCast: forward {fwd}, loss {loss_gaps}, "
          f"gradients {grad_gap}, digests alike {same}")
    return dict(forward_gap=fwd, loss_gap=loss_gaps, grad_gap=grad_gap,
                ranks_agree=same, halo=ranks[0]["halo"]["halo"],
                collective_words_per_feature=plan.collective_words_per_feature,
                seconds=[rk["halo"]["seconds"] for rk in ranks],
                max_memory_allocated=[rk["halo"]["max_memory_allocated"]
                                      for rk in ranks])


def dist_inputs_quick(box):
    """``--quick``'s inputs for phase 7a at full width: RCB labels of the
    box into 64 parts with 0.2% of them moved at random (no eigensolve),
    and the one-process card runs of the two sharded chains of
    ``run_sharded`` from them (guarded)."""
    from repro_torch.core.rcb import rcb_parts
    from repro_torch.mesh import dual_graph

    g = dual_graph(box)
    raw = rcb_parts(box.coords, 64, box.weights)
    rng = np.random.default_rng(0)
    pick = rng.random(raw.size) < 0.002
    raw[pick] = rng.integers(0, 64, int(pick.sum()))
    runs = run_chains(g, raw, 64, box.weights, "cuda", guarded=True,
                      names=("repair+refine-sharded", "kway-sharded"))
    return g, raw, box.weights, {k: v["parts"] for k, v in runs.items()}


def dist_references(graph, x_mv, L, x_gs):
    """What phase 7a holds the ranks to, computed on this process while
    they run: K1's adjacency matvec of ``graph`` on ``x_mv``, the GS
    apply of ``L`` on ``x_gs`` and its Σ|terms|; and (f), the pair solve
    on the quality mesh, checked here."""
    from repro_torch.core.fiedler import (_padded_ell_laplacian,
                                          best_cut_in_pair,
                                          fiedler_pair_from_graph, next_pow2)
    from repro_torch.kernels.ell_spmv import cuda
    from repro_torch.mesh import dual_graph, pebble_mesh

    n_pad = next_pow2(graph.n)
    ell = _padded_ell_laplacian(graph, n_pad,
                                next_pow2(int(graph.degrees.max())),
                                device="cuda")
    y_ell = ell.adj_apply(torch.from_numpy(
        np.pad(x_mv, (0, n_pad - graph.n))).cuda())[:graph.n].cpu().numpy()
    xg = torch.from_numpy(x_gs).cuda()
    y_gs = L.apply(xg).cpu().numpy()
    gs_scale = (L.degree_full * xg.abs() + L.adj_apply(xg.abs())) \
        .clamp(min=1.0).cpu().numpy()

    qg = dual_graph(pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1))
    cuda.LAUNCHES = 0                     # this path's K1 count starts here
    t0 = time.perf_counter()
    y1, y2, l2, l3 = fiedler_pair_from_graph(qg, device="cuda")
    pair_s = time.perf_counter() - t0
    pair_k1 = cuda.LAUNCHES
    c1, c2, c_l2, c_l3 = fiedler_pair_from_graph(qg, device="cpu")
    basis = [np.linalg.qr(np.stack(p, 1).astype(np.float64))[0]
             for p in ((y1, y2), (c1, c2))]
    pair_cos = float(np.linalg.svd(basis[0].T @ basis[1],
                                   compute_uv=False).min())
    _, theta, pair_cut = best_cut_in_pair(qg, y1, y2)
    check(pair_k1 > 0, "dist: fiedler_pair_from_graph launched no K1")
    check(abs(l2 - c_l2) <= 1e-4 * c_l2 and abs(l3 - c_l3) <= 1e-4 * c_l3,
          f"dist pair: eigenvalues {l2}, {l3} against the CPU's {c_l2}, "
          f"{c_l3}")
    check(pair_cos >= 0.999, f"dist pair: span cos {pair_cos} < 0.999")
    return y_ell, y_gs, gs_scale, dict(
        n=qg.n, lambda2=l2, lambda3=l3, cpu_lambda2=c_l2, cpu_lambda3=c_l3,
        span_min_cos=pair_cos, k1=pair_k1, seconds=pair_s, best_theta=theta,
        best_cut=pair_cut)


def phase_dist(smoke, box, full):
    """Phase 7a: the distribution layer across processes on the card.

    ``smoke``: (graph, raw labels, weights, card labels by chain) of the
    959-element protocol (phase 4); ``full``: the same of the full box
    (``full``'s raw labels and ``full_sharded``'s card labels; under
    ``--quick``, `dist_inputs_quick`'s).  Four gloo ranks share the card
    (their collectives through the host) and one NCCL rank runs alone (a
    real communicator whose gathers degenerate), both started together.
    (a) the smoke chains on both groups: labels = the one-process card
    labels, cuts within 1.05 x the recorded ones, K4 on every rank;
    (b) both sharded chains on the full box across the 4 ranks (G = 16):
    labels = the one-process card labels, gathers = sweeps, the sweep
    seconds and the bytes a sweep gathers; (c) the halo matvec under a
    4-shard RCB plan of the full box's dual graph against K1's ELL
    matvec on one process (1e-5 of max|y|); (d) the distributed GS
    Laplacian of the full box (4 blocks of elements; NCCL: one) against
    the one-process GS apply (1e-5 of Σ|terms|); (e) the ring against
    ``all_reduce`` (bit-equal on integer-valued floats, 1e-6 otherwise);
    (f) `fiedler_pair_from_graph` on the quality mesh's dual graph on the
    card, K1 launched, against the CPU (λ within tol, span cos ≥ 0.999);
    (g) the halo GraphCast at full width on ``stencil_graph_3d(16, 16,
    16)``, the RSB ``default`` labels into 4 parts (NCCL: one shard): every
    rank's forward block, loss and all-reduced gradients against the
    one-process full-graph run on the card (1e-4 of max), the ranks'
    gradients bit-equal, the plan's words per feature beside an RCB
    plan's.  Returns the phase's row."""
    from repro_torch.core.gather_scatter import gs_setup, weighted_laplacian
    from repro_torch.core.rcb import rcb_parts

    t_phase = time.perf_counter()
    sg, sraw, sw, s_ref = smoke
    fg, fraw, fw, f_ref = full
    rng = np.random.default_rng(11)
    x_mv = rng.normal(size=fg.n).astype(np.float32)
    h = gs_setup(box.vert_gid, device="cuda")
    L = weighted_laplacian(box.vert_gid, device="cuda")
    x_gs = rng.normal(size=box.nelems).astype(np.float32)
    gs_payload = (h.gid.cpu().numpy(), x_gs, L.degree_full.cpu().numpy(),
                  h.n_global)
    ring = {"ints": rng.integers(-1000, 1000, (DIST_WORLD, 1 << 16))
            .astype(np.float32),
            "rand": rng.normal(size=(DIST_WORLD, 1 << 16)).astype(np.float32)}
    hg, h_rsb, h_rcb, h_feat, h_tgt, h_rsb_s = halo_inputs()
    h_one = np.zeros(hg.n, dtype=np.int64)          # NCCL: one shard
    with contextlib.ExitStack() as ranks_alive:
        gloo = start_ranks(dict(smoke=(sg, sraw, sw), full=(fg, fraw, fw),
                                matvec=(fg, rcb_parts(box.coords, DIST_WORLD,
                                                      box.weights), x_mv),
                                gs=gs_payload, ring=ring,
                                halo=(hg, h_rsb, h_feat, h_tgt)),
                           DIST_WORLD, "gloo")
        ranks_alive.callback(stop_ranks, gloo)
        nccl = start_ranks(dict(smoke=(sg, sraw, sw), gs=gs_payload,
                                ring={k: v[:1] for k, v in ring.items()},
                                halo=(hg, h_one, h_feat, h_tgt)),
                           1, "nccl")
        ranks_alive.callback(stop_ranks, nccl)
        refs = dist_references(fg, x_mv, L, x_gs)
        t_ref = time.perf_counter()
        h_ref = halo_reference(hg, h_feat, h_tgt)
        h_ref_s = time.perf_counter() - t_ref
        t_wait = time.perf_counter()
        got = {"gloo": join_ranks(gloo), "nccl": join_ranks(nccl)}
        wait_s = time.perf_counter() - t_wait
    y_ell, y_gs, gs_scale, pair = refs
    row = {}
    for backend, ranks in got.items():
        rb = row[backend] = dict(world=len(ranks))
        for key, ref, nsh in (("smoke", s_ref, 8), ("full", f_ref, 64)):
            if key not in ranks[0]:
                continue
            chains = {}
            for name in ranks[0][key]:
                want = ref[name]
                per = [rk[key][name] for rk in ranks]
                for i, c in enumerate(per):
                    check(np.array_equal(c["parts"], want),
                          f"dist {backend} {key} {name} rank {i}: labels "
                          "differ from the one-process card run's")
                    if name == "repair+refine":
                        continue
                    check(c["k4"] > 0 and c["k4"] == c["gathers"]
                          == c["sweeps_run"] == c["counters"]["sharded_gathers"]
                          == c["counters"]["sharded_sweeps"],
                          f"dist {backend} {key} {name} rank {i}: K4 "
                          f"{c['k4']}, gathers {c['gathers']}, sweeps "
                          f"{c['sweeps_run']}, counters {c['counters']}")
                    if c["guard"] is not None:
                        check_clean(f"dist {backend} {key} {name} rank {i}",
                                    c["guard"])
                c0 = per[0]
                chains[name] = dict(
                    cut=c0["cut"], seconds=[c["seconds"] for c in per],
                    k4_per_rank=[c["k4"] for c in per],
                    gathers=c0["gathers"], sweeps_s=[c["sweeps_s"] for c in per],
                    admit_s=[c["admit_s"] for c in per],
                    plan_s=[c["plan_s"] for c in per],
                    counters=c0["counters"], halo=c0["halo"])
                if c0["halo"] is not None:
                    # the packed buffer of every shard, and the (G, 3)
                    # scalars of every shard, a sweep (float32)
                    chains[name].update(
                        gather_bytes_per_sweep=4 * nsh * (3 * c0["halo"]
                                                          + 2 * nsh),
                        scalar_gather_bytes_per_sweep=4 * 3 * nsh)
                if key == "smoke" and name in SHARDED_JAX_CUTS:
                    check(c0["cut"] <= 1.05 * SHARDED_JAX_CUTS[name],
                          f"dist {backend} smoke {name}: cut {c0['cut']} > "
                          f"1.05 x {SHARDED_JAX_CUTS[name]}")
            rb[key] = chains
        if "matvec" in ranks[0]:
            ys = [rk["matvec"]["y"] for rk in ranks]
            err = float(np.abs(ys[0] - y_ell).max() / np.abs(y_ell).max())
            check(all(np.array_equal(y, ys[0]) for y in ys),
                  f"dist {backend} matvec: the ranks' y differ")
            check(err <= DIST_TOL, f"dist {backend} matvec: {err} > "
                  f"{DIST_TOL} of max|y| against K1's ELL matvec")
            rb["matvec"] = dict(max_rel_err=err, halo=ranks[0]["matvec"]["halo"],
                                seconds=[rk["matvec"]["seconds"]
                                         for rk in ranks])
        y = np.concatenate([rk["gs"]["y"] for rk in ranks])
        err = float((np.abs(y - y_gs) / gs_scale).max())
        check(err <= DIST_TOL, f"dist {backend} GS apply: {err} > "
              f"{DIST_TOL} of the terms against the one-process apply")
        rb["gs"] = dict(max_rel_err=err,
                        seconds=[rk["gs"]["seconds"] for rk in ranks])
        for i, rk in enumerate(ranks):
            for kind, (a, b) in rk["ring"].items():
                ok = (np.array_equal(a, b) if kind == "ints" else
                      float(np.abs(a - b).max()) <= 1e-6 * float(np.abs(b).max()))
                check(ok, f"dist {backend} ring {kind} rank {i}: ring "
                      "differs from all_reduce")
        rb["ring"] = {k: float(np.abs(a - b).max())
                      for k, (a, b) in ranks[0]["ring"].items()}
        rb["halo"] = halo_check(backend, ranks, hg,
                                h_rsb if backend == "gloo" else h_one, h_ref)
    from repro_torch.dist import plan_halo_sharding

    row["halo_graph"] = dict(
        side=GNN_HALO_SIDE, nodes=hg.n, nnz=hg.nnz, rsb_s=h_rsb_s,
        reference_s=h_ref_s,
        rsb_words_per_feature=plan_halo_sharding(
            hg, h_rsb, DIST_WORLD).collective_words_per_feature,
        rcb_words_per_feature=plan_halo_sharding(
            hg, h_rcb, DIST_WORLD).collective_words_per_feature)
    row["pair"] = pair
    row["wait_s"] = wait_s
    row["seconds"] = time.perf_counter() - t_phase
    emit("dist", **row)
    return row


def phase_full_multilevel():
    """The ``multilevel`` preset on ``box_mesh(40, 32, 24)`` into 64 parts:
    host NumPy only (no kernel launches; checked), guarded; its stages,
    the V-cycle's statistics, the cut within 1.01 x `repro`'s on the same
    input.  (The full box's run, ~75 s of host NumPy with no kernel, is
    left to the CPU tests, which hold the V-cycle to `repro` bit for
    bit.)"""
    from repro_torch.kernels.ell_spmv import cuda
    from repro_torch.kernels.segment_sum import cuda as ss_cuda
    from repro_torch.mesh import box_mesh

    def launches():
        return (cuda.LAUNCHES + cuda.BATCHED_LAUNCHES + ss_cuda.LAUNCHES
                + ss_cuda.BATCHED_LAUNCHES)

    mesh = box_mesh(40, 32, 24)
    before = launches()
    ctx, pm, wall, corridor, nonempty = run_preset("multilevel", mesh, 64,
                                                   "cuda")
    n_launches = launches() - before
    ml = ctx.report.ml
    guard = guard_row(ctx)
    emit("full_multilevel", mesh="box_mesh(40,32,24)", nelems=mesh.nelems,
         nparts=64, kernels="none: the V-cycle is host NumPy",
         kernel_launches=n_launches, seconds=wall, stages=stage_split(ctx),
         ml=dict(levels=ml.levels, n_fine=ml.n_fine,
                 n_coarsest=ml.n_coarsest, coarsen_ratio=ml.coarsen_ratio,
                 coarse_solver=ml.coarse_solver,
                 coarsen_s=ml.coarsen_seconds,
                 coarsest_s=ml.coarsest_seconds,
                 refine_s=ml.refine_seconds, coarse_cut=ml.coarse_cut,
                 fm_moves=ml.fm_moves, balance_moves=ml.balance_moves),
         cut=pm.edge_cut, jax_cut=MEDIUM_ML_JAX_CUT,
         equal_to_jax_cut=pm.edge_cut == MEDIUM_ML_JAX_CUT,
         disconnected=pm.disconnected_parts, w_imb=pm.weighted_imbalance,
         corridor=corridor, nonempty_parts=nonempty, guard=guard,
         full_box="not run: host NumPy only (CPU tests hold it to repro)")
    check(n_launches == 0, f"full_multilevel: {n_launches} kernel launches")
    check_clean("full_multilevel", guard)
    check(pm.edge_cut <= 1.01 * MEDIUM_ML_JAX_CUT,
          f"full_multilevel: box_mesh(40,32,24) cut {pm.edge_cut} above "
          f"1.01 x repro's {MEDIUM_ML_JAX_CUT}")


def ranged_k1(trace_path) -> dict:
    """From a torch.profiler Chrome trace: K1's kernels, and how many of
    them were launched inside a ``fiedler:lanczos…`` range, by range name
    (`range_device_ms`)."""
    parts = range_device_ms(trace_path, "fiedler:lanczos",
                            kernel="ell_spmv_kernel")
    total = sum(v[0] for v in parts.values())
    return dict(k1_kernels=total,
                k1_in_ranges=total - parts.get("other", [0])[0],
                by_range={k: v[0] for k, v in sorted(parts.items())})


def phase_reference(gs_row):
    """The ``reference`` preset (recursive engine, matrix-free
    gather-scatter solves) on the quality mesh on the card against the
    CPU; ``engine="recursive"`` on its dual graph as a Graph (K1 on every
    matvec, counted by the profiler) and the AMG-preconditioned recursive
    inverse solve on the 959-element mesh (K1 in the AMG levels); and the
    GS-against-ELL comparison at the full box's root shape."""
    from repro_torch.core.metrics import partition_metrics
    from repro_torch.core.pipeline import partition
    from repro_torch.kernels.ell_spmv import cuda
    from repro_torch.mesh import dual_graph, pebble_mesh

    mesh = pebble_mesh(12, 12, 12, n_pebbles=5, warp=0.15, seed=1)
    before = cuda.LAUNCHES + cuda.BATCHED_LAUNCHES
    ctx, pm, wall, corridor, nonempty = run_preset("reference", mesh, 16,
                                                   "cuda")
    launches = cuda.LAUNCHES + cuda.BATCHED_LAUNCHES - before
    counters = trace_counters("reference", ctx.trace)
    cpu, pm_cpu, wall_cpu, _, _ = run_preset("reference", mesh, 16, "cpu")
    w = np.asarray(mesh.weights, np.float64)
    pw = np.bincount(ctx.parts, weights=w, minlength=16) / (w.sum() / 16)
    row = dict(cut=pm.edge_cut, cut_cpu=pm_cpu.edge_cut,
               labels_differing_from_cpu=int((ctx.parts != cpu.parts).sum()),
               seconds=wall, seconds_cpu=wall_cpu,
               disconnected=pm.disconnected_parts, corridor=corridor,
               balance_range=[float(pw.min()), float(pw.max())],
               kernel_launches=launches, stages=stage_split(ctx),
               levels=level_rows(ctx), guard=guard_row(ctx),
               trace_counters=counters)
    check(row["labels_differing_from_cpu"] == 0,
          f"reference: {row['labels_differing_from_cpu']} card labels differ "
          "from the CPU's")
    check(pm.edge_cut <= 1.05 * QUALITY_REF_JAX_CUT,
          f"reference: cut {pm.edge_cut} > 1.05 x {QUALITY_REF_JAX_CUT}")
    check(pm.disconnected_parts == 0 and corridor and nonempty == 16,
          "reference: invariants")
    check_clean("reference", row["guard"])

    # the graph engine: fiedler_from_graph on every node, K1 every matvec
    g = dual_graph(mesh)
    k1_before = cuda.LAUNCHES
    labels = {}

    def graph_run():
        labels["card"] = partition(g, 16, coords=mesh.coords,
                                   weights=mesh.weights, engine="recursive",
                                   device="cuda")

    t0 = time.perf_counter()
    by_name = device_profile(graph_run)
    graph_wall = time.perf_counter() - t0
    k1_prof = sum(v[0] for k, v in by_name.items() if "ell_spmv_kernel" in k)
    labels["cpu"] = partition(g, 16, coords=mesh.coords, weights=mesh.weights,
                              engine="recursive", device="cpu")
    gpm = partition_metrics(g, labels["card"], 16)
    graph = dict(seconds_profiled=graph_wall, cut=gpm.edge_cut,
                 cut_cpu=partition_metrics(g, labels["cpu"], 16).edge_cut,
                 labels_differing_from_cpu=int(
                     (labels["card"] != labels["cpu"]).sum()),
                 disconnected=gpm.disconnected_parts,
                 k1_launches=cuda.LAUNCHES - k1_before,
                 k1_kernels_profiled=k1_prof)
    check(k1_prof > 0, "reference graph engine: the profiler saw no K1")
    check(gpm.disconnected_parts == 0, "reference graph engine: invariants")

    # the recursive inverse solve: AMG levels through K1
    smoke = pebble_mesh(10, 10, 10, n_pebbles=6, seed=0)
    k1_before = cuda.LAUNCHES
    t0 = time.perf_counter()
    inv = partition(smoke, 8, partitioner="rsb_inverse", precond="amg",
                    engine="recursive", device="cuda")
    inv_wall = time.perf_counter() - t0
    inv_cpu = partition(smoke, 8, partitioner="rsb_inverse", precond="amg",
                        engine="recursive", device="cpu")
    ipm = partition_metrics(dual_graph(smoke), inv, 8)
    inverse = dict(seconds=inv_wall, cut=ipm.edge_cut,
                   cut_cpu=partition_metrics(dual_graph(smoke), inv_cpu,
                                             8).edge_cut,
                   labels_differing_from_cpu=int((inv != inv_cpu).sum()),
                   disconnected=ipm.disconnected_parts,
                   k1_launches=cuda.LAUNCHES - k1_before)
    check(inverse["k1_launches"] > 0, "reference inverse: K1 never launched")
    check(ipm.disconnected_parts == 0, "reference inverse: invariants")
    emit("reference", mesh="pebble_mesh(12,12,12,n_pebbles=5,warp=0.15,seed=1)",
         nelems=mesh.nelems, nparts=16, jax_cut=QUALITY_REF_JAX_CUT,
         preset=row, graph_engine=graph,
         inverse_amg=dict(mesh="pebble_mesh(10,10,10,n_pebbles=6,seed=0)",
                          nparts=8, **inverse),
         gs_against_ell=gs_row)


def phase_full_reference(box, geometric_cut):
    """The ``reference`` preset on the full box into 64 parts: every node
    solved on its sub-mesh's gather-scatter Laplacian; stages split host /
    device, levels, the trace's counters, kernel launches (none expected:
    the GS apply is plain PyTorch), one GS Lanczos restart at the root
    profiled, and the cut against the ``geometric`` cut of ``full``."""
    from repro_torch.core.fiedler import _noise_b0, _padded_gs_laplacian
    from repro_torch.core.lanczos import lanczos_fiedler
    from repro_torch.core.rcb import rcb_order
    from repro_torch.kernels.ell_spmv import cuda

    torch.cuda.reset_peak_memory_stats()
    before = cuda.LAUNCHES + cuda.BATCHED_LAUNCHES
    ctx, pm, wall, corridor, nonempty = run_preset("reference", box, 64,
                                                   "cuda")
    launches = cuda.LAUNCHES + cuda.BATCHED_LAUNCHES - before
    peak = torch.cuda.max_memory_allocated()
    counters = trace_counters("full_reference", ctx.trace)
    guard = guard_row(ctx)

    # one Lanczos restart of the root solve's shape on its GS operator
    vg = box.vert_gid[rcb_order(box.coords, box.weights)]
    op = _padded_gs_laplacian(vg, N_SLOTS, device="cuda")
    mask = (torch.arange(N_SLOTS, device="cuda") < box.nelems).float()
    b0 = torch.from_numpy(_noise_b0(0, N_SLOTS)).cuda()

    def restart():
        lanczos_fiedler(op, N_SLOTS, mask=mask, b0=b0, window=20,
                        max_restarts=1, tol=0.0)

    restart()
    restart_wall_ms = wall_s(restart) * 1e3
    by_name = device_profile(restart, warmup=1)
    emit("full_reference", mesh="box_mesh(80,64,48)", nelems=box.nelems,
         nparts=64, seconds=wall, stages=stage_split(ctx),
         levels=level_rows(ctx), kernel_launches=launches,
         max_memory_allocated=peak, cut=pm.edge_cut,
         geometric_cut=geometric_cut, disconnected=pm.disconnected_parts,
         w_imb=pm.weighted_imbalance, corridor=corridor,
         nonempty_parts=nonempty, guard=guard, trace_counters=counters,
         gs_restart=dict(window=20, N=N_SLOTS, wall_ms=restart_wall_ms,
                         cuda_kernels=sum(v[0] for v in by_name.values()),
                         device_ms=sum(v[1] for v in by_name.values()),
                         top=top_kernels(by_name)),
         finalize_split=finalize_split(ctx, 64))
    check_clean("full_reference", guard)
    check(nonempty == 64, "full_reference: an empty part")
    check(pm.disconnected_parts == 0, "full_reference: disconnected parts")
    check(corridor, "full_reference: balance corridor broken")
    check(pm.edge_cut <= 1.05 * geometric_cut,
          f"full_reference: cut {pm.edge_cut} above 1.05 x the geometric "
          f"cut {geometric_cut}")


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


def flash_work(B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal, elsize,
               window=None):
    """Bytes (q, the keys and values the queries need, o; each once) and
    flops (4·D per unmasked (query, key) pair and head) of one call; with a
    window, only the keys some query's window reaches."""
    qpos = q_offset + np.arange(Sq)
    hi = np.minimum(kv_len, qpos + 1) if causal else np.full(Sq, kv_len)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, int)
    keys = np.clip(hi - lo, 0, None)
    kv_used = int(hi.max() - lo.min()) if Sq else 0
    nbytes = elsize * (2 * B * Sq * H * D + 2 * B * kv_used * Hkv * D)
    flops = 4 * D * H * B * int(keys.sum())
    return nbytes, flops


def sdpa_call(q, k, v, causal, q_offset, kv_len, window=None):
    """One `scaled_dot_product_attention` call computing the same function
    (the yardstick; the port never calls it).  Its causal mask is aligned
    top-left, right only where the queries start at key 0, so the keys are
    sliced to kv_len (with a window, from the first query's first visible
    key) and any other alignment, or a window, gets an explicit mask."""
    import torch.nn.functional as F

    Sq = q.shape[1]
    lo = max(0, q_offset - window + 1) if window else 0
    qt = q.transpose(1, 2)
    kt, vt = (t[:, lo:kv_len].transpose(1, 2) for t in (k, v))
    kw = dict(enable_gqa=True)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(lo, kv_len, device=q.device)
    if window:
        mask = (qpos[:, None] >= kpos[None]) & (qpos[:, None] - kpos[None]
                                                < window)
        if not bool(mask.all()):               # else every query sees every key
            kw["attn_mask"] = mask
    elif causal and q_offset == 0 and Sq == kv_len:
        kw["is_causal"] = True
    elif causal and q_offset < kv_len - 1:   # else every query sees every key
        kw["attn_mask"] = qpos[:, None] >= kpos[None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw).transpose(1, 2)


def phase_kernels_flash():
    """K6 against its plain version at every case of FLASH_CASES and
    FLASH_WINDOW_CASES, fp32 and bf16, timed beside its bound, the plain
    version and SDPA; then K6's gradient (`flash_grad_rows`).  Returns the
    forward's rows and the gradient's."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    rows = {}
    cases = {**{c: v + (None,) for c, v in FLASH_CASES.items()},
             **FLASH_WINDOW_CASES}
    for seed, (case, (B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal,
                      window)) in enumerate(cases.items()):
        kv_len = Skv if kv_len is None else kv_len
        q_offset = kv_len - Sq if q_offset is None else q_offset
        rng = np.random.default_rng(seed)
        q32 = torch.from_numpy(rng.normal(size=(B, Sq, H, D)).astype(np.float32)).cuda()
        k32 = torch.from_numpy(rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)).cuda()
        v32 = torch.from_numpy(rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
                      window=window)

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
            lib = sdpa_call(q, k, v, causal, q_offset, kv_len, window)
            lib_err = float((lib().float() - want.float()).abs().max())
            check(lib_err <= (1e-3 if dtype == torch.float32 else 5e-2),
                  f"SDPA {case} {dtype} disagrees with the plain version "
                  f"by {lib_err}")
            nbytes, flops = flash_work(B, Sq, Skv, H, Hkv, D, q_offset,
                                       kv_len, causal, q.element_size(),
                                       window)
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
                causal=causal, window=window, max_abs_err=err,
                library_max_abs_err=lib_err,
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
        del q32, k32, v32
    wd, ld = rows[("window_decode", "bfloat16")], rows[("long_decode",
                                                         "bfloat16")]
    grad = flash_grad_rows()
    emit("kernels", kernel="flash_attention", cases=list(rows.values()),
         window_decode_vs_long_decode=dict(
             window_decode_dev_ms=wd["dev_ms"], long_decode_dev_ms=ld["dev_ms"],
             ratio=wd["dev_ms"] / ld["dev_ms"]),
         grad=grad)
    return rows, grad


def backward_dev_ms(fn, calls=10, sessions=2):
    """Device ms of one call of ``fn``, a K6 backward call, over ``calls``
    calls in one torch.profiler session (after one unrecorded): its two
    kernels' time summed, and each kernel's ms a call by name; (None,
    None) where no session traced both kernels of every call."""
    for _ in range(sessions):
        by_name = device_profile(lambda: [fn() for _ in range(calls)],
                                 warmup=1)
        k = {n: v for n, v in by_name.items() if FLASH_BWD_KERNELS in n}
        if len(k) == 2 and all(v[0] == calls for v in k.values()):
            return (sum(v[1] for v in k.values()) / calls,
                    {n[:72]: v[1] / calls for n, v in k.items()})
    return None, None


def flash_bwd_times(q, k, v, dout, kw) -> dict:
    """K6's backward kernel alone on (q, k, v, dout) (bf16 at D >= 64 with
    the output and logsumexp of the kernel's forward, run once before):
    ms a call by CUDA events and by the profiler (its two kernels, and
    each one's), the plain recompute's ms (`ref.flash_attention_grads`),
    and its bound: q and dout read, dq written, the keys and values the
    queries need read, dk and dv written whole, each once (and the saved
    output and logsumexp read); 5 products of 2·D FLOPs per unmasked
    (query, key) pair and head (S, dP, dV, dQ, dK) over the peak of the
    inputs' type.  ``bwd_route_bound_ms``: the same with the products the
    route runs (9, or 7 from the saved statistics)."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_grads

    saved = {}
    if fa_cuda.takes_stats(q.dtype, q.shape[-1]):
        saved = dict(zip(("out", "lse"), fa_cuda.flash_attention_cuda(
            q, k, v, return_lse=True, **kw)))

    def kernel():
        return fa_cuda.flash_attention_bwd_cuda(q, k, v, dout, **kw, **saved)

    def plain():
        return flash_attention_grads(q, k, v, dout, **kw)

    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    el = q.element_size()
    nbytes, flops = flash_work(B, Sq, Skv, H, Hkv, D, kw["q_offset"],
                               kw["kv_len"], kw["causal"], el, kw["window"])
    nbytes += el * (B * Sq * H * D + 2 * B * Skv * Hkv * D)
    if saved:
        nbytes += el * B * Sq * H * D + 4 * B * H * Sq
    product = flops // 2
    flops = 5 * product
    route_flops = (7 if saved else 9) * product
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / peak * 1e3
    events_ms = time_auto(kernel)
    dev_ms, by_kernel = backward_dev_ms(kernel)
    return dict(bwd_route="saved_stats_wgmma" if saved else "recompute",
                bwd_route_flops=route_flops,
                bwd_route_bound_ms=max(bound_bytes_ms,
                                       route_flops / peak * 1e3),
                bwd_ms=events_ms,
                bwd_dev_ms=dev_ms if dev_ms is not None else events_ms,
                bwd_dev_ms_by="profiler" if dev_ms is not None
                else "cuda_events",
                bwd_kernels_ms=by_kernel, bwd_plain_ms=time_auto(plain),
                bwd_bytes=nbytes, bwd_flops=flops,
                bwd_tflops=flops / ((dev_ms or events_ms) * 1e-3) / 1e12,
                bwd_bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bwd_bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                else "operations")


def flash_grad_train_row() -> dict:
    """K6's backward at ``train``'s attention (FLASH_GRAD_TRAIN, bf16,
    causal, no window): the kernel once against `ref.flash_attention_grads`
    (2e-2 of each gradient's max), its times and bound (`flash_bwd_times`)
    beside SDPA's backward alone (its forward run once before), and K6's
    forward and backward through its autograd function beside SDPA's on
    the same inputs, with the pair's bound (the forward's bytes twice, its
    FLOPs three times)."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_grads

    B, S, H, Hkv, D = FLASH_GRAD_TRAIN
    dtype = torch.bfloat16
    rng = np.random.default_rng(41)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                     .cuda().to(dtype)
                     for sh in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D),
                                (B, S, H, D)))
    kw = dict(causal=True, q_offset=0, kv_len=S, window=None)
    out, lse = fa_cuda.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    before = fa_cuda.BACKWARD_LAUNCHES
    got = fa_cuda.flash_attention_bwd_cuda(q, k, v, dout, out=out, lse=lse,
                                           **kw)
    torch.cuda.synchronize()
    check(fa_cuda.BACKWARD_LAUNCHES == before + 1,
          "K6 backward train_4k: the kernel did not launch once")
    want = flash_attention_grads(q, k, v, dout, **kw)
    diffs = [(a.float() - b.float()).abs().max() for a, b in zip(got, want)]
    errs = [float(d / b.float().abs().max()) for d, b in zip(diffs, want)]
    tol = FLASH_GRAD_TOL[dtype]
    check(max(errs) <= tol, f"K6 backward train_4k: dq, dk, dv off by "
          f"{errs} of their max (tol {tol})")
    del got, want, out, lse
    times = flash_bwd_times(q, k, v, dout, kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    sdpa = sdpa_call(*leaves, True, 0, S)

    def k6_grads():
        fa_ops.flash_attention(*leaves, causal=True).backward(dout)

    def sdpa_grads():
        sdpa().backward(dout)

    sdpa_out = sdpa()

    def sdpa_backward():        # SDPA's backward alone, its forward kept
        torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True)

    nbytes, flops = flash_work(B, S, S, H, Hkv, D, 0, S, True, 2)
    bound_bytes_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 3 * flops / BF16_FLOPS_PER_S * 1e3
    row = dict(case="train_4k", dtype="bfloat16", window=None,
               shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D),
               rel_err_dq_dk_dv=errs, max_abs_err=float(max(diffs)), tol=tol,
               ms=time_auto(k6_grads), sdpa_fwd_bwd_ms=time_auto(sdpa_grads),
               sdpa_bwd_ms=time_auto(sdpa_backward),
               bound_ms=max(bound_bytes_ms, bound_ops_ms),
               bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
               else "operations",
               recorded_mma_sync_bwd_dev_ms=RECORDED_BWD_DEV_MS,
               recorded_note="the mma.sync route's (PERF.md), not "
                             "measured in this run", **times)
    row["bwd_vs_sdpa_bwd"] = row["bwd_dev_ms"] / row["sdpa_bwd_ms"]
    del leaves, sdpa_out
    return row


def flash_grad_rows() -> list:
    """K6's gradient on the card: dq, dk, dv through its autograd function
    (the kernel's forward, the backward kernel) against autograd through
    the plain version, at FLASH_GRAD_CASE's shape in fp32 and bf16,
    without and with a window; each pass's ms by CUDA events, beside
    SDPA's forward and backward on the same inputs (the yardstick) and the
    bound of the forward and backward: the forward's bytes twice (dout
    read, dq, dk and dv written besides) and its FLOPs three times (QKᵀ
    and PV forward; dV, dP, dQ and dK backward); the backward kernel's own
    times and bound (`flash_bwd_times`).  Then the ``train_4k`` row
    (`flash_grad_train_row`)."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, Sq, Skv, H, Hkv, D = FLASH_CASES[FLASH_GRAD_CASE][:6]
    rng = np.random.default_rng(40)
    arrays = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()
              for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                        (B, Sq, H, D))]
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, FLASH_GRAD_WINDOW):
            dout = arrays[3].to(dtype)

            def grads(prefer):
                leaves = [a.to(dtype, copy=True).requires_grad_()
                          for a in arrays[:3]]
                fa_ops.flash_attention(*leaves, causal=True, window=window,
                                       prefer=prefer).backward(dout)
                return [t.grad for t in leaves]

            before, before_b = fa_cuda.LAUNCHES, fa_cuda.BACKWARD_LAUNCHES
            got = grads("auto")
            check(fa_cuda.LAUNCHES == before + 1
                  and fa_cuda.BACKWARD_LAUNCHES == before_b + 1,
                  "K6 grad: the forward and the backward kernel did not "
                  "launch once each")
            want = grads("ref")
            errs = [float((a.float() - b.float()).abs().max()
                          / b.float().abs().max()) for a, b in zip(got, want)]
            tol = FLASH_GRAD_TOL[dtype]
            check(max(errs) <= tol, f"K6 grad {dtype} window={window}: "
                  f"dq, dk, dv off by {errs} of their max (tol {tol})")
            leaves = [a.to(dtype, copy=True).requires_grad_()
                      for a in arrays[:3]]
            sdpa = sdpa_call(*leaves, True, 0, Skv, window)

            def sdpa_grads():
                sdpa().backward(dout)

            nbytes, flops = flash_work(B, Sq, Skv, H, Hkv, D, 0, Skv, True,
                                       leaves[0].element_size(), window)
            peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
                else FP32_FLOPS_PER_S
            bound_bytes_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
            bound_ops_ms = 3 * flops / peak * 1e3
            bwd = flash_bwd_times(
                *(a.to(dtype) for a in arrays[:3]), dout,
                dict(causal=True, q_offset=0, kv_len=Skv, window=window))
            out.append(dict(case=FLASH_GRAD_CASE, dtype=str(dtype).split(".")[-1],
                            window=window, rel_err_dq_dk_dv=errs, tol=tol,
                            ms=time_auto(lambda: grads("auto")),
                            plain_autograd_ms=time_auto(lambda: grads("ref")),
                            sdpa_fwd_bwd_ms=time_auto(sdpa_grads),
                            bound_ms=max(bound_bytes_ms, bound_ops_ms),
                            bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                            else "operations", **bwd))
            del leaves
    out.append(flash_grad_train_row())
    return out


def logit_gap(got, want) -> float:
    """max |got − want| / max |want|, in fp32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def phase_serve():
    """`tinyllama-1.1b` at full width served through `generate` (see the
    module docstring); returns K6's launches over the two runs."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tt

    arch = get_arch("tinyllama-1.1b")
    cfg = arch.make_config()
    t0 = time.perf_counter()
    model = tt.build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())

    def prompts_of(B, P):
        return torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (B, P))).cuda()

    runs, kept, k6_launches = serve_runs(cfg, model, SERVE_RUNS, prompts_of)

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

    emit("serve", arch=cfg.name, dtype=str(cfg.dtype).split(".")[-1],
         n_params=cfg.n_params(), weight_bytes=weight_bytes, init_s=init_s,
         runs=runs, k6_launches=k6_launches, profile=profile,
         check_a_ref_gap=gap_ref, check_a_tol=SERVE_TOL_REF,
         check_b_forward_gap=gap_fwd, check_b_tol=SERVE_TOL_FORWARD,
         check_c=smoke_on_card(arch))
    del model
    torch.cuda.empty_cache()
    return k6_launches


def phase_serve_window():
    """The sliding-window `tinyllama-1.1b` (window 4096) at full width in
    bf16: checks a-c, then the long_500k shape (one 524,288-token prompt,
    prefill and 16 decode steps); returns K6's launches over that run."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.tinyllama_1_1b import make_sliding_window_config
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.models import transformer as tt
    from repro_torch.obs import percentiles

    t_phase = time.perf_counter()
    cfg = make_sliding_window_config(SERVE_WINDOW)
    t0 = time.perf_counter()
    model = tt.build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(6)

    def ids(B, n):
        return torch.from_numpy(rng.integers(0, cfg.vocab, (B, n))).cuda()

    with torch.inference_mode():
        # (a) K6 against the plain attention: a prefill of 8192 (past the
        # window) and one decode step
        P = SERVE_WINDOW_PROMPT_A
        prompt, nxt = ids(1, P), ids(1, 1)
        logits = {}
        for prefer in ("auto", "ref"):
            model.attn_prefer = prefer
            cache = tt.init_cache(cfg, 1, P + 1, "cuda")
            lp, cache = tt.prefill(model, prompt, cache)
            ld, _ = tt.decode_step(model, cache, nxt, P)
            logits[prefer] = (lp, ld)
            del cache
        model.attn_prefer = "auto"
        gap_ref = {"prefill": logit_gap(logits["auto"][0], logits["ref"][0]),
                   "decode": logit_gap(logits["auto"][1], logits["ref"][1])}
        check(max(gap_ref.values()) <= SERVE_TOL_REF,
              f"serve_window (a): K6 vs plain attention logits {gap_ref}")
        del logits
        torch.cuda.empty_cache()

        # (b) a prefill and 7 decode steps against one forward
        seq = ids(1, SERVE_WINDOW_SEQ_B)
        S = seq.shape[1]
        full = tt.forward(model, seq)
        cache = tt.init_cache(cfg, 1, S, "cuda")
        lp, cache = tt.prefill(model, seq[:, :S - 7], cache)
        gap_fwd = {"prefill": logit_gap(lp[:, 0], full[:, S - 8])}
        for t in range(S - 7, S):
            ld, cache = tt.decode_step(model, cache, seq[:, t:t + 1], t)
        gap_fwd["last_decode"] = logit_gap(ld[:, 0], full[:, S - 1])
        check(max(gap_fwd.values()) <= SERVE_TOL_FORWARD,
              f"serve_window (b): decode vs forward logits {gap_fwd}")
        del full, cache
        torch.cuda.empty_cache()

        # long_500k: prefill 524,288 tokens, then 16 greedy decode steps
        B, P, steps = LONG_500K
        prompt = ids(B, P)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa_cuda.LAUNCHES = 0                  # this run's count starts here
        cache = tt.init_cache(cfg, B, P + steps, "cuda")
        cache_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
        t0 = time.perf_counter()
        lp, cache = tt.prefill(model, prompt, cache)
        tok = torch.argmax(lp[:, -1], dim=-1, keepdim=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        step_s = []
        for i in range(steps):
            t0 = time.perf_counter()
            last = tok
            ld, cache = tt.decode_step(model, cache, tok, P + i)
            tok = torch.argmax(ld[:, -1], dim=-1, keepdim=True)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = fa_cuda.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        check(launches == cfg.n_layers * (1 + steps),
              f"serve_window long_500k: {launches} K6 launches, not "
              f"{cfg.n_layers} x {1 + steps}")
        check(bool(torch.isfinite(ld).all()),
              "serve_window long_500k: non-finite logits")
        pos = P + steps - 1
        # the last step again, profiled (it rewrites its own cache row with
        # the same values), then with the plain attention over the whole
        # cache and the window's mask
        by_name = device_profile(lambda: tt.decode_step(model, cache, last, pos))
        k6 = [v for n, v in by_name.items() if "flash_attention_kernel" in n]
        model.attn_prefer = "ref"
        ld_ref, _ = tt.decode_step(model, cache, last, pos)
        model.attn_prefer = "auto"
        gap_long = logit_gap(ld, ld_ref)
        check(gap_long <= SERVE_TOL_REF,
              f"serve_window long_500k: last step vs plain attention {gap_long}")
        pct = percentiles(step_s)
        long_run = dict(
            batch=B, prompt_len=P, steps=steps, prefill_s=prefill_s,
            prefill_tok_per_s=B * P / prefill_s, p50_step_ms=pct["p50"] * 1e3,
            p99_step_ms=pct["p99"] * 1e3, max_memory_allocated=peak,
            cache_bytes=cache_bytes, k6_launches=launches,
            last_step=dict(position=pos,
                           cuda_kernels=sum(v[0] for v in by_name.values()),
                           device_ms=sum(v[1] for v in by_name.values()),
                           k6_launches=sum(v[0] for v in k6),
                           k6_dev_ms=sum(v[1] for v in k6) if k6 else None,
                           gap_vs_plain=gap_long))
        del cache, prompt, ld, ld_ref

    smoke = dataclasses.replace(get_arch("tinyllama-1.1b").make_smoke_config(),
                                attn="sliding_window", window=SERVE_WINDOW_SMOKE)
    emit("serve_window", arch=cfg.name, window=cfg.window,
         dtype=str(cfg.dtype).split(".")[-1], init_s=init_s,
         long_500k=long_run, check_a_ref_gap=gap_ref,
         check_a_tol=SERVE_TOL_REF, check_b_forward_gap=gap_fwd,
         check_b_tol=SERVE_TOL_FORWARD,
         check_c=smoke_on_card(get_arch("tinyllama-1.1b"), smoke),
         seconds=time.perf_counter() - t_phase)
    del model
    torch.cuda.empty_cache()
    return launches


def tree_gap(got, want, norm="l2") -> float:
    """The largest relative gap over the leaves: ‖got − want‖₂ / ‖want‖₂
    (``norm="l2"``), or max |got − want| / max |want| (``"max"``)."""
    from repro_torch.models.common import tree_leaves

    def gap(a, b):
        d, b = (a.double() - b.double()), b.double()
        if norm == "max":
            return d.abs().max() / b.abs().max().clamp_min(1e-300)
        return d.norm() / b.norm().clamp_min(1e-300)

    return max(float(gap(a, b)) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))


def trees_equal(a, b) -> bool:
    from repro_torch.models.common import tree_leaves

    return all(torch.equal(x, y.to(x.device))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def phase_train():
    """`tinyllama-1.1b` trained at its published widths (bf16 compute, fp32
    masters and AdamW, remat): one unrecorded step and TRAIN_STEPS steps
    on one `token_batches` batch, and checks a-f, every one run before
    the phase fails on those that failed; returns K6's, K6's backward's
    and K5's launches over the recorded steps, and for phase ``launch``
    (b) the unrecorded step's FLOPs (`FlopCounterMode`) and peak above the card's other
    tensors, its arguments' bytes and the median step."""
    import itertools
    import tempfile

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.launch.cells import lm_train_step
    from repro_torch.models import transformer as tt
    from repro_torch.models.common import count_params, tree_leaves, tree_map
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import fit, value_and_grad

    t_phase = time.perf_counter()
    failures = []

    def gate(cond, what):
        if not cond:
            failures.append(what)

    arch = get_arch("tinyllama-1.1b")
    cfg = arch.make_config()
    check(cfg.remat and arch.shapes["train_4k"]["seq_len"] == TRAIN_SEQ,
          "train: tinyllama's config or train_4k changed")
    t0 = time.perf_counter()
    params = tt.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(params)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves((params, opt)))
    batch = {k: v.cuda() for k, v in next(token_batches(
        TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=0)).items()}

    def step(p, o):
        return lm_train_step(cfg, p, o, batch, microbatch=TRAIN_MICRO)

    p0 = params
    batch_bytes = sum(t.numel() * t.element_size() for t in batch.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as flops:      # for `launch` (b)
        params, opt, loss0 = step(p0, opt)             # unrecorded
    torch.cuda.synchronize()
    # the step's own peak: what it held above the card's other tensors
    first_peak = torch.cuda.max_memory_allocated() - base + state_bytes \
        + batch_bytes
    first = {"params": [t.cpu() for t in tree_leaves(params)],
             "loss": loss0.cpu()}
    fa_cuda.LAUNCHES = fa_cuda.BACKWARD_LAUNCHES = 0   # the recorded steps
    eb_cuda.LAUNCHES = 0
    secs, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    k6, k6b, k5 = (fa_cuda.LAUNCHES, fa_cuda.BACKWARD_LAUNCHES,
                   eb_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(secs)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the loss after the TRAIN_STEPS updates, on the same batch
    with torch.no_grad():
        mb = TRAIN_BATCH // TRAIN_MICRO
        loss_after = sum(float(tt.loss_fn(cfg, params, {
            k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}))
            for i in range(TRAIN_MICRO)) / TRAIN_MICRO
    # where a step's time goes: one microbatch's forward and backward
    mb_batch = {k: v[:TRAIN_BATCH // TRAIN_MICRO] for k, v in batch.items()}
    by_name = device_profile(lambda: value_and_grad(
        lambda p, b: tt.loss_fn(cfg, p, b))(params, mb_batch))
    k6_prof = [v for n, v in by_name.items() if "flash_attention_kernel" in n]
    bwd_prof = [v for n, v in by_name.items() if FLASH_BWD_KERNELS in n]
    profile = dict(cuda_kernels=sum(v[0] for v in by_name.values()),
                   device_ms=sum(v[1] for v in by_name.values()),
                   k6_launches=sum(v[0] for v in k6_prof),
                   k6_ms=sum(v[1] for v in k6_prof),
                   k6_backward_kernels=sum(v[0] for v in bwd_prof),
                   k6_backward_ms=sum(v[1] for v in bwd_prof),
                   k6_backward_share=sum(v[1] for v in bwd_prof)
                   / max(sum(v[1] for v in by_name.values()), 1e-9),
                   k6_backward_ms_by_kernel={
                       n[:72]: v[1] for n, v in by_name.items()
                       if FLASH_BWD_KERNELS in n},
                   # not measured here: copied from the record
                   recorded_plain_backward_ms=dict(
                       elementwise=PLAIN_BACKWARD_MS[0],
                       fp32_products=PLAIN_BACKWARD_MS[1],
                       source="PERF.md §5: the plain recompute's passes, "
                              "profiled before the backward kernel"),
                   top=top_kernels(by_name))
    del by_name
    parts_s = {"steps": sum(secs)}
    run = dict(arch=cfg.name, dtype=str(cfg.dtype).split(".")[-1],
               n_params=n_params, remat=cfg.remat, seq_len=TRAIN_SEQ,
               global_batch=TRAIN_BATCH, microbatches=TRAIN_MICRO,
               reduced=f"global batch {arch.shapes['train_4k']['global_batch']}"
                       f" -> {TRAIN_BATCH} ({TRAIN_MICRO} microbatches of "
                       f"{TRAIN_BATCH // TRAIN_MICRO}); one batch repeated",
               init_s=init_s, steps=TRAIN_STEPS, step_s=secs,
               median_step_s=step_s, tokens_per_s=tokens / step_s,
               mfu_6nd=6 * n_params * tokens / step_s / BF16_FLOPS_PER_S,
               mfu_note="6·N·tokens / step s over 989 TFLOP/s; remat's "
                        "recompute not counted",
               max_memory_allocated=peak, state_bytes=state_bytes,
               loss_first=float(loss0), losses=losses,
               loss_after=loss_after, k6_launches=k6,
               k6_backward_launches=k6b, k5_launches=k5,
               microbatch_profile=profile)
    emit("train_run", **run)
    # (a) finite and lower
    gate(all(np.isfinite(losses)) and np.isfinite(loss_after)
         and loss_after < float(loss0),
         f"train (a): loss {float(loss0)} -> {losses} -> {loss_after}")
    gate(k6 == cfg.n_layers * TRAIN_MICRO * TRAIN_STEPS * 2,
         f"train: {k6} K6 launches, not {cfg.n_layers} x {TRAIN_MICRO} x "
         f"{TRAIN_STEPS} x 2 (remat)")
    gate(k6b == cfg.n_layers * TRAIN_MICRO * TRAIN_STEPS,
         f"train: {k6b} K6 backward launches, not {cfg.n_layers} x "
         f"{TRAIN_MICRO} x {TRAIN_STEPS}")
    gate(k5 == TRAIN_MICRO * TRAIN_STEPS * 2,
         f"train: {k5} K5 launches, not {TRAIN_MICRO} x {TRAIN_STEPS} x 2")

    # (d) one step again from the first state: the same bits
    torch.cuda.synchronize()
    t_part = time.perf_counter()
    again, _, loss_again = step(p0, adamw_init(p0))
    check_d = bool(torch.equal(loss_again.cpu(), first["loss"])
                   and all(torch.equal(a.cpu(), b) for a, b in
                           zip(tree_leaves(again), first["params"])))
    gate(check_d, "train (d): two identical steps gave different bits")
    del again, first, p0
    torch.cuda.empty_cache()
    parts_s["d"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (b) one microbatch's loss and gradients: K6 against the plain
    # attention, and the control (the plain attention rounded coarser)
    sub = {k: v[:TRAIN_GRAD_ROWS] for k, v in batch.items()}

    def loss_and_grads(prefer):
        return value_and_grad(lambda p, b: tt.loss_fn(
            cfg, p, b, attn_prefer=prefer))(params, sub)

    torch.cuda.empty_cache()
    l_ref, g_ref = loss_and_grads("ref")      # compared on the card
    readings = {}
    for name, ctx in (("k6", contextlib.nullcontext()),
                      ("control", coarse_attention(TRAIN_CONTROL_BITS,
                                                   grad=True))):
        with ctx:
            l, g = loss_and_grads("auto" if name == "k6" else "ref")
        readings[name] = dict(
            loss_gap=abs(float(l) - float(l_ref)) / abs(float(l_ref)),
            grad_gap=tree_gap(g, g_ref), grad_gap_max=tree_gap(g, g_ref, "max"))
        del g
    del g_ref
    check_b = dict(rows=TRAIN_GRAD_ROWS, loss_tol=TRAIN_LOSS_TOL,
                   grad_limit=TRAIN_GRAD_LIMIT,
                   control_bits=TRAIN_CONTROL_BITS, **readings)
    emit("train_check_b", **check_b)
    k6r, ctl = readings["k6"], readings["control"]
    gate(k6r["loss_gap"] <= TRAIN_LOSS_TOL
         and k6r["grad_gap"] <= TRAIN_GRAD_LIMIT < ctl["grad_gap"],
         f"train (b): K6 {k6r}, control {ctl}, loss tol {TRAIN_LOSS_TOL}, "
         f"grad limit {TRAIN_GRAD_LIMIT}")
    parts_s["b"] = time.perf_counter() - t_part

    # (f) a full-width checkpoint of params and AdamW state, saved and
    # restored bit for bit, in a temporary directory removed afterwards
    tree = {"params": params, "opt": opt}
    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=1)
        t0 = time.perf_counter()
        f = mgr.save(TRAIN_STEPS + 1, tree)
        save_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(f)
        t0 = time.perf_counter()
        restored_step, restored, _ = mgr.restore_latest(tree)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    check_f = restored_step == TRAIN_STEPS + 1 and trees_equal(restored, tree)
    gate(check_f, "train (f): the restored checkpoint differs")
    ckpt_row = dict(bytes=file_bytes, state_bytes=state_bytes,
                    save_s=save_s, restore_s=load_s)
    del restored, tree, opt, params, batch
    torch.cuda.empty_cache()
    parts_s["f"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (c) the smoke config in fp32: three steps, card against CPU
    smoke = arch.make_smoke_config()
    sp = tt.init_params(smoke, torch.Generator().manual_seed(0))
    sb = next(token_batches(4, 32, smoke.vocab, seed=1))
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), sp)
        o, ls = adamw_init(p), []
        b = {k: v.to(dev) for k, v in sb.items()}
        for _ in range(3):
            p, o, l = lm_train_step(smoke, p, o, b, microbatch=2)
            ls.append(float(l))
        runs[dev] = (p, ls)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][1],
                                                      runs["cpu"][1]))
    param_gap = max(float((a.cpu() - b).abs().max()) for a, b in
                    zip(tree_leaves(runs["cuda"][0]),
                        tree_leaves(runs["cpu"][0])))
    gate(loss_gap <= TRAIN_SMOKE_TOL and param_gap <= TRAIN_SMOKE_TOL,
         f"train (c): card vs CPU loss {loss_gap}, params {param_gap}")

    # (e) fit on the card, preempted and resumed, against an uninterrupted
    # run (one repeated batch: `fit` restarts the data on resume)
    class Preempted(RuntimeError):
        pass

    def preempt(s):
        if s == TRAIN_FIT[1]:
            raise Preempted()

    sbc = {k: v.cuda() for k, v in sb.items()}

    def fit_run(d, **kw):
        return fit(lambda p, b: tt.loss_fn(smoke, p, b),
                   tree_map(lambda t: t.cuda(), sp), itertools.repeat(sbc),
                   steps=TRAIN_FIT[0], opt_cfg=AdamWConfig(lr=1e-3),
                   ckpt_dir=d, ckpt_every=2, log_every=100,
                   log=lambda s: None, **kw)

    with tempfile.TemporaryDirectory() as d:
        try:
            fit_run(os.path.join(d, "run"), preemption_hook=preempt)
            check(False, "train (e): the preemption hook did not fire")
        except Preempted:
            pass
        resumed = fit_run(os.path.join(d, "run"))
        whole = fit_run(os.path.join(d, "whole"))
    check_e = trees_equal(resumed.params, whole.params)
    parts_s["c_e"] = time.perf_counter() - t_part
    gate(check_e, "train (e): the resumed fit differs from the uninterrupted "
         "one")

    emit("train", **run, check_b=check_b,
         check_c=dict(loss_gap=loss_gap, param_gap=param_gap,
                      tol=TRAIN_SMOKE_TOL),
         check_d_bit_identical=check_d, check_e_resume_bit_identical=check_e,
         check_f=dict(ckpt_row, bit_identical=check_f), failures=failures,
         parts_s=parts_s, seconds=time.perf_counter() - t_phase)
    check(not failures, "train: " + "; ".join(failures))
    torch.cuda.empty_cache()
    return k6, k6b, k5, dict(flops=flops.get_total_flops(),
                             peak_bytes=first_peak,
                             args_bytes=state_bytes + batch_bytes,
                             step_s=step_s)


class RoutingCapture:
    """Forward hooks on every MoE layer of ``model``: for each call of a
    layer, the expert sets (B, S, k, ascending ids) that `models.moe.route`
    picks from the captured input, in call order (prefill: layer 0 … L−1,
    then each decode step)."""

    def __init__(self, model):
        from repro_torch.models import moe as mt

        self.records = []

        def hook(module, args, out):
            h, moe = args
            _, _, top_e = mt.route(moe, module.router,
                                   h.reshape(-1, h.shape[-1]))
            self.records.append(top_e.sort(-1).values.view(*h.shape[:2], -1))

        self.handles = [layer.moe.register_forward_hook(hook)
                        for layer in model.layers]

    def close(self):
        for handle in self.handles:
            handle.remove()

    def by_layer(self, n_layers):
        """Per layer, the sets of every call joined along the sequence:
        [(B, S_total, k)]."""
        return [torch.cat(self.records[i::n_layers], 1)
                for i in range(n_layers)]


def routing_diff(run_a, run_b) -> dict:
    """Two runs' routing over the same tokens (lists by layer from
    `RoutingCapture.by_layer`): the share of (token, layer) pairs whose
    expert sets differ, and which tokens are routed alike in every layer
    (B, S)."""
    differ = torch.stack([(sa != sb).any(-1)
                          for sa, sb in zip(run_a, run_b)])    # (L, B, S)
    return dict(flip_share=float(differ.float().mean()),
                pairs=int(differ.numel()), flips=int(differ.sum()),
                alike=~differ.any(0))


@contextlib.contextmanager
def coarse_attention(bits, grad=False):
    """Checks (a) and (b)'s control: inside, every attention call of the LM
    runs the plain attention with its output rounded to ``bits`` explicit
    mantissa bits (bf16 keeps 7; round to nearest even), a stand-in for an
    attention kernel that computes coarser than bf16.  With ``grad`` the
    rounding passes the plain attention's gradient straight through (the
    train phase's control)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.models import transformer as tt

    scale = 2.0 ** (bits + 1)

    def attention(q, k, v, *, prefer, **kw):
        out = flash_attention_plain(q, k, v, **kw)
        m, e = torch.frexp(out.detach().float())
        coarse = torch.ldexp(torch.round(m * scale) / scale, e).to(out.dtype)
        return out + (coarse - out).detach() if grad else coarse

    kept = tt.flash_attention
    tt.flash_attention = attention
    try:
        yield
    finally:
        tt.flash_attention = kept


def dropped_share(capture_layers, moe, n_tokens) -> float:
    """Share of (token, choice) pairs past their expert's capacity, over
    every layer, counted from the routing alone: each expert keeps its
    first C = capacity(moe, T) entries."""
    from repro_torch.models.moe import capacity

    C = capacity(moe, n_tokens)
    dropped = total = 0
    for sets in capture_layers:
        counts = torch.bincount(sets.reshape(-1), minlength=moe.n_experts)
        dropped += int((counts - C).clamp_min(0).sum())
        total += sets.numel()
    return dropped / total


def gated_gap(got, want, rows_alike) -> tuple:
    """`logit_gap` over the rows routed alike (a bool per row of the
    leading dims), and how many rows that is."""
    n = int(rows_alike.sum())
    if n == 0:
        return None, 0
    return logit_gap(got[rows_alike], want[rows_alike]), n


def range_device_ms(trace_path, prefix, *, kernel=None, within=None,
                    names=None) -> dict:
    """The device events (kernels, copies, fills) of a torch.profiler Chrome
    trace by the innermost range named ``prefix…`` their launch lies in
    (the launch's runtime call, joined to the event by its correlation id,
    on the same thread), else ``"other"`` (also an event with no launch in
    the trace): {bucket: [count, ms]}.  Only kernels whose name holds
    ``kernel``, where given; only events launched inside a range named
    ``within``, where given; a kernel whose name holds a key of ``names``
    goes to that key's bucket, whatever its range."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    annotations = [(e["tid"], e["ts"], e["ts"] + e["dur"], str(e["name"]))
                   for e in events if e.get("cat") == "user_annotation"]
    outer = [r for r in annotations if r[3] == within]
    ranges = sorted((r for r in annotations if r[3].startswith(prefix)),
                    key=lambda r: r[2] - r[1])          # innermost first
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out: dict = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset") or (
                kernel is not None and kernel not in e["name"]):
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        tid, ts = (launch["tid"], launch["ts"]) if launch else (None, None)
        if within is not None and not any(
                t == tid and a <= ts <= b for t, a, b, _ in outer):
            continue
        name = next((n for key, n in (names or {}).items()
                     if key in e["name"]), None) or next(
            (n for t, a, b, n in ranges if t == tid and a <= ts <= b),
            "other")
        d = out.setdefault(name, [0, 0.0])
        d[0] += 1
        d[1] += e["dur"] / 1e3
    return out


def profile_decode_step(model, cache, tok, pos) -> dict:
    """Two decode steps in one torch.profiler capture under
    ``REPRO_OBS_TORCH=1`` (the MoE layer's ``moe:*`` ranges on), each in a
    range of its own; the second step's device ms split by range."""
    import os

    from repro_torch import obs
    from repro_torch.models import transformer as tt

    os.environ["REPRO_OBS_TORCH"] = "1"
    os.environ["REPRO_OBS_TORCH_DIR"] = str(ROOT / "build" / "torchprof")
    try:
        with torch.inference_mode():
            cap = obs.maybe_start_trace()
            for i in range(2):
                with torch.profiler.record_function(f"serve_moe:step{i}"):
                    tt.decode_step(model, cache, tok, pos)
                torch.cuda.synchronize()
            path = obs.maybe_stop_trace(cap)
    finally:
        os.environ.pop("REPRO_OBS_TORCH", None)
        os.environ.pop("REPRO_OBS_TORCH_DIR", None)
    parts = range_device_ms(path, "moe:", within="serve_moe:step1",
                            names={"flash_attention_kernel": "k6"})
    total = sum(v[1] for v in parts.values())
    return dict(cuda_events=sum(v[0] for v in parts.values()),
                device_ms=total,
                by_range={k: dict(count=v[0], ms=v[1],
                                  share=v[1] / total if total else None)
                          for k, v in sorted(parts.items())})


def decode_floor_ms(model, B, pos) -> float:
    """The least device ms of one decode step at position ``pos``: every
    weight but the embedding read once (the static-capacity dispatch
    multiplies every expert each step), and the KV cache's first pos + 1
    rows of every layer, over 3.35 TB/s."""
    cfg = model.cfg
    weights = sum(p.numel() * p.element_size() for n, p in
                  model.named_parameters() if n != "embed")
    kv = 2 * cfg.n_layers * B * (pos + 1) * cfg.n_kv_heads * cfg.d_head \
        * torch.finfo(cfg.dtype).bits // 8
    return (weights + kv) / HBM_BYTES_PER_S * 1e3


def teacher_forced(model, seq, P, steps):
    """Prefill seq[:, :P] into a cache, then ``steps`` decode steps fed
    seq's next tokens: the prefill's logits (B, V) and each step's (B,
    steps, V)."""
    from repro_torch.models import transformer as tt

    B = seq.shape[0]
    cache = tt.init_cache(model.cfg, B, P + steps, "cuda")
    lp, cache = tt.prefill(model, seq[:, :P], cache)
    out = []
    for t in range(P, P + steps):
        ld, cache = tt.decode_step(model, cache, seq[:, t:t + 1], t)
        out.append(ld[:, 0])
    return lp[:, 0], torch.stack(out, 1)


def serve_runs(cfg, model, runs_spec, prompts_of) -> tuple:
    """`generate` over each run of ``runs_spec`` (after one unrecorded
    2-step warm-up per shape): prefill ms, tok/s, p50/p99 step ms, peak
    memory and K6 launches (checked = n_layers × steps); the runs' K6
    launches, counted from 0 just before them."""
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.launch.serve import generate
    from repro_torch.obs import percentiles

    for B, P, _ in runs_spec.values():
        generate(cfg, model, prompts_of(B, P), 2)
    runs, kept = {}, {}
    fa_cuda.LAUNCHES = 0
    for name, (B, P, steps) in runs_spec.items():
        prompts = prompts_of(B, P)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = fa_cuda.LAUNCHES
        toks, t_pre, step_s = generate(cfg, model, prompts, steps)
        launches = fa_cuda.LAUNCHES - before
        check(launches == cfg.n_layers * steps,
              f"serve {cfg.name} {name}: {launches} K6 launches, not "
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
    return runs, kept, fa_cuda.LAUNCHES


def smoke_on_card(arch, smoke=None) -> dict:
    """(c) the arch's smoke config (or ``smoke``) in fp32 through
    `generate`: greedy tokens on the card identical to the CPU's,
    full-forward logits within 1e-3."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as tt

    smoke = smoke or arch.make_smoke_config()
    params = tt.init_params(smoke, torch.Generator().manual_seed(0))
    cpu, gpu = tt.Transformer(smoke, params), tt.Transformer(smoke, params).cuda()
    sp = torch.from_numpy(np.random.default_rng(0).integers(0, smoke.vocab, (4, 16)))
    tg, _, _ = generate(smoke, gpu, sp.cuda(), 32)
    tc, _, _ = generate(smoke, cpu, sp, 32)
    with torch.inference_mode():
        seq = torch.cat([sp, tc], dim=1)
        gap = float((tt.forward(gpu, seq.cuda()).cpu()
                     - tt.forward(cpu, seq)).abs().max())
    check(torch.equal(tg.cpu(), tc), f"serve (c) {smoke.name}: tokens on the "
          "card differ from the CPU's")
    check(gap <= SERVE_SMOKE_TOL, f"serve (c) {smoke.name}: logits differ by "
          f"{gap}")
    return dict(config=smoke.name, steps=32, tokens_equal=True,
                max_abs_logit_gap=gap)


def moe_layer_on_card(cfg) -> dict:
    """(d) one MoE layer at the config's full width in fp32 on the card
    against the CPU at MOE_LAYER_TOKENS tokens: expert ids and keep mask
    equal, y within 1e-5 of max|y|, two card calls bit-identical.  The
    input is the first of a seeded series whose every token has a top-k
    router-logit margin (k-th − (k+1)-th) above MOE_LAYER_MARGIN on the
    CPU: a near tie flips on the last bit of another summation order, a
    property of the input, not of the port."""
    from repro_torch.models import moe as mt

    moe, d = cfg.moe, cfg.d_model
    p = mt.init_moe(moe, d, torch.Generator().manual_seed(0), torch.float32)
    p["router"] = p["router"].to(cfg.dtype).float()    # as the model holds it
    for seed in range(16):
        x = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(1, MOE_LAYER_TOKENS, d)).astype(np.float32))
        _, _, top_e = mt.route(moe, p["router"], x[0])
        srt = (x[0] @ p["router"]).sort(-1, descending=True).values
        margin = float((srt[:, moe.top_k - 1] - srt[:, moe.top_k]).min())
        if margin > MOE_LAYER_MARGIN:
            break
    check(margin > MOE_LAYER_MARGIN, f"serve_moe (d) {cfg.name}: no input of "
          f"the series clears the top-k margin ({margin})")
    want = mt.moe_apply(moe, p, x, torch.float32)
    _, keep_cpu, _ = mt.dispatch(moe, top_e, MOE_LAYER_TOKENS)
    pc = {k: v.cuda() for k, v in p.items()}
    xc = x.cuda()
    _, _, top_e_card = mt.route(moe, pc["router"], xc[0])
    _, keep_card, _ = mt.dispatch(moe, top_e_card, MOE_LAYER_TOKENS)
    got = [mt.moe_apply(moe, pc, xc, torch.float32) for _ in range(2)]
    torch.cuda.synchronize()
    gap = float((got[0].cpu() - want).abs().max() / want.abs().max())
    row = dict(tokens=MOE_LAYER_TOKENS, input_seed=seed, top_k_margin=margin,
               top_e_equal=bool(torch.equal(top_e_card.cpu(), top_e)),
               keep_equal=bool(torch.equal(keep_card.cpu(), keep_cpu)),
               dropped=int((~keep_cpu).sum()), y_gap=gap,
               bit_identical=bool(torch.equal(got[0], got[1])))
    check(row["top_e_equal"] and row["keep_equal"],
          f"serve_moe (d) {cfg.name}: routing differs from the CPU's: {row}")
    check(gap <= MOE_LAYER_TOL, f"serve_moe (d) {cfg.name}: y differs by "
          f"{gap} of max|y|")
    check(row["bit_identical"], f"serve_moe (d) {cfg.name}: two card calls "
          "differ")
    return row


def serve_moe_arch(arch_id) -> tuple:
    """One arch of phase ``serve_moe`` (see the module docstring); returns
    its line and its K6 launches over the serve runs."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tt
    from repro_torch.models.moe import capacity

    t_arch = time.perf_counter()
    arch = get_arch(arch_id)
    cfg = arch.make_config()
    is_moe = cfg.moe is not None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = tt.build_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())

    def prompts_of(B, P):
        return torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (B, P))).cuda()

    spec = SERVE_RUNS if is_moe else {"requests": SERVE_RUNS["requests"]}
    runs, kept, k6_launches = serve_runs(cfg, model, spec, prompts_of)
    prompts, _ = kept["requests"]
    B, P, steps = SERVE_RUNS["requests"]
    # the decode traffic of the profile and checks (a), (b): seeded random
    # ids (the greedy tokens of random weights repeat one id)
    forced = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, steps))).cuda()
    row = dict(arch=cfg.name, dtype=str(cfg.dtype).split(".")[-1],
               n_params=cfg.n_params(), n_active_params=cfg.n_active_params(),
               weight_bytes=weight_bytes, resident_before_bytes=resident,
               init_s=init_s, init_peak_bytes=init_peak, runs=runs,
               k6_launches=k6_launches)

    with torch.inference_mode():
        cache = tt.init_cache(cfg, B, P + 1, "cuda")
        tt.prefill(model, prompts, cache)
        row["decode_floor_ms"] = decode_floor_ms(model, B, P)
        row["decode_profile"] = profile_decode_step(model, cache,
                                                    forced[:, :1], P)
        del cache

        # (a) K6 against the plain attention, same weights: (MoE) a forward
        # over the requests prompts (the prefill route, every position's
        # logits), then their prefill and 32 teacher-forced decode steps.
        seq = torch.cat([prompts, forced], dim=1)

        def run_a():
            cap = RoutingCapture(model) if is_moe else None
            out = (tt.forward(model, prompts) if is_moe else None,
                   *teacher_forced(model, seq, P, SERVE_MOE_STEPS_A))
            if cap is None:
                return out, None
            cap.close()
            return out, cap.by_layer(cfg.n_layers)

        logits, routing = {}, {}
        for prefer in ("auto", "ref"):
            model.attn_prefer = prefer
            logits[prefer], routing[prefer] = run_a()
        model.attn_prefer = "auto"
        (lf_a, lp_a, ld_a), (lf_r, lp_r, ld_r) = logits.pop("auto"), \
            logits.pop("ref")
        check_a = dict(tol=SERVE_TOL_REF, prefill_gap=logit_gap(lp_a, lp_r),
                       decode_gap=logit_gap(ld_a, ld_r))
        if is_moe:
            check_a["forward_gap"] = logit_gap(lf_a, lf_r)
            # sequence positions of the routing records: the forward's P,
            # the prefill's P, the steps
            diff = routing_diff(routing["auto"], routing["ref"])
            alike = diff.pop("alike")
            check_a.update(diff, flip_max=SERVE_MOE_FLIP_MAX[cfg.name])
            check_a["forward_gap_alike"], check_a["forward_rows_alike"] = \
                gated_gap(lf_a, lf_r, alike[:, :P])
            check_a["decode_gap_alike"], check_a["decode_rows_alike"] = \
                gated_gap(ld_a, ld_r, alike[:, 2 * P:])
            row["dropped_share_requests_prefill"] = dropped_share(
                [sets[:, :P] for sets in routing["auto"]], cfg.moe, B * P)
            del lf_a, lf_r
            # the controls: the same runs with a coarser attention, held to
            # the plain attention's routing as K6 is
            controls = {}
            for bits in SERVE_MOE_CONTROL_BITS:
                with coarse_attention(bits):
                    _, run_c = run_a()
                controls[str(bits)] = routing_diff(
                    run_c, routing["ref"])["flip_share"]
                del run_c
            check_a["control_flip_shares"] = controls
            del routing
        row["check_a"] = check_a

        if is_moe:
            # (b) the prompts' prefill and 63 teacher-forced decode steps
            # against one forward over the same 2,300 tokens, with C ≥ T
            # (capacity_factor = E / top_k): no token drops in either, so
            # they compute the same function.  Routing is compared apart
            # over the prefill's positions and the steps' (K6's decode
            # kernel, products of B rows); the controls run the prefill and
            # the steps with a coarser attention.
            E, k = cfg.moe.n_experts, cfg.moe.top_k
            model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=E / k))
            S = P + steps - 1
            seq = seq[:, :S]
            cap = RoutingCapture(model)
            full = tt.forward(model, seq)
            cap.close()
            run_full = cap.by_layer(cfg.n_layers)

            def run_b():
                cap = RoutingCapture(model)
                out = teacher_forced(model, seq, P, S - P)
                cap.close()
                return out, cap.by_layer(cfg.n_layers)

            def diff_b(run):
                return [routing_diff([r[:, part] for r in run_full],
                                     [r[:, part] for r in run])
                        for part in (slice(0, P), slice(P, S))]

            (lp, ld), run_dec = run_b()
            pre, dec = diff_b(run_dec)
            controls = {}
            for bits in SERVE_MOE_CONTROL_BITS:
                with coarse_attention(bits):
                    _, run_c = run_b()
                controls[str(bits)] = [d["flip_share"] for d in diff_b(run_c)]
                del run_c
            model.cfg = cfg
            want_p, want_d = full[:, P - 1], full[:, P:]
            check_b = dict(
                tol=SERVE_TOL_FORWARD, tokens=B * S, capacity_factor=E / k,
                capacity=capacity(cfg.moe, B * S), decode_steps=S - P,
                prefill_gap=logit_gap(lp, want_p),
                decode_gap=logit_gap(ld, want_d),
                flip_max=SERVE_MOE_FLIP_MAX[cfg.name])
            for part, d, i in (("prefill", pre, 0), ("decode", dec, 1)):
                check_b.update({
                    f"{part}_flip_share": d["flip_share"],
                    f"{part}_flips": d["flips"], f"{part}_pairs": d["pairs"],
                    f"{part}_control_flip_shares":
                        {b: v[i] for b, v in controls.items()}})
            check_b["prefill_gap_alike"], check_b["prefill_rows_alike"] = \
                gated_gap(lp, want_p, pre["alike"][:, P - 1])
            check_b["decode_gap_alike"], check_b["decode_rows_alike"] = \
                gated_gap(ld, want_d, dec["alike"])
            row["check_b"] = check_b
            del full, run_full, run_dec
    row["check_c"] = smoke_on_card(arch)
    if is_moe:
        row["check_d"] = moe_layer_on_card(cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t_arch
    return row, k6_launches


def serve_moe_failures(row) -> list:
    """Checks (a) and (b) of one ``serve_moe`` line.  Dense: the logit gaps
    within their bounds.  MoE: the gaps within their bounds over the rows
    routed alike in every layer (at least one such row a comparison), and
    each share of (token, layer) pairs whose expert sets differ ((a)'s;
    (b)'s over the prefill's positions and over the steps') within the
    arch's ``flip_max``, with every control's share above it: the run
    shows that the limit catches an attention coarser than bf16
    (SERVE_MOE_FLIP_MAX)."""
    out, name = [], row["arch"]
    for key in ("check_a", "check_b"):
        c = row.get(key)
        if c is None:
            continue
        if "flip_share" not in c:
            gaps = [c[k] for k in ("forward_gap", "prefill_gap", "decode_gap")
                    if k in c]
            if max(gaps) > c["tol"]:
                out.append(f"{name} {key}: logit gaps {gaps} above {c['tol']}")
            continue
        for part in ("forward", "prefill", "decode"):
            if f"{part}_rows_alike" not in c:
                continue
            gap, n = c[f"{part}_gap_alike"], c[f"{part}_rows_alike"]
            if n == 0:
                out.append(f"{name} {key}: no {part} row routed alike in "
                           "every layer")
            elif gap > c["tol"]:
                out.append(f"{name} {key}: {part} logit gap {gap} over "
                           f"{n} rows routed alike, above {c['tol']}")
        for part in ("", "prefill_", "decode_"):
            if f"{part}flip_share" not in c:
                continue
            share, limit = c[f"{part}flip_share"], c["flip_max"]
            if share > limit:
                out.append(f"{name} {key}: expert sets differ in {share} of "
                           f"the {part}(token, layer) pairs, above {limit}")
            for bits, ctl in c[f"{part}control_flip_shares"].items():
                if ctl <= limit:
                    out.append(f"{name} {key}: the {part}control at {bits} "
                               f"mantissa bits flips {ctl}, not above {limit}")
    return out


def phase_serve_moe():
    """`deepseek-moe-16b`, `qwen3-moe-30b-a3b` and `command-r-35b` at full
    width, each built one layer at a time on the card (see the module
    docstring); returns K6's launches over their serve runs.  Every arch
    runs before the phase fails on the checks of `serve_moe_failures`."""
    t_phase = time.perf_counter()
    failures, launches = [], 0
    for arch_id in SERVE_MOE_ARCHS:
        row, k6 = serve_moe_arch(arch_id)
        row["failures"] = serve_moe_failures(row)
        emit("serve_moe", **row)
        failures += row["failures"]
        launches += k6
    emit("serve_moe_done", seconds=time.perf_counter() - t_phase,
         k6_launches=launches, failures=failures)
    check(not failures, "serve_moe: " + "; ".join(failures))
    return launches


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


def bag_backward_inputs(table_rows, ids, d, slice_of=None):
    """The transposed bag of a lookup of ``ids`` (bags of one, weight 1)
    into (table_rows, d), or with ``slice_of`` = (n_model, rank) into that
    rank's rows with every foreign id at its row 0 and weight 0: (dout,
    idx, w_in, seg, rows, w, n_rows) — the output's gradient (seeded), the
    lookup's ids and weights, and K5's arguments (entries stable-sorted by
    row: the rows as segments, the entries' places as indices)."""
    n = ids.numel()
    idx = ids.reshape(-1).long()
    w_in = torch.ones(n, dtype=torch.float32, device="cuda")
    if slice_of is not None:
        n_model, rank = slice_of
        table_rows //= n_model
        local = idx - rank * table_rows
        own = (local >= 0) & (local < table_rows)
        idx, w_in = torch.where(own, local, 0), own.float()
    dout = torch.from_numpy(np.random.default_rng(41).normal(
        size=(n, d)).astype(np.float32)).cuda()
    order = torch.argsort(idx, stable=True)
    return (dout, idx, w_in, order.to(torch.int32),
            idx[order].to(torch.int32), w_in[order], table_rows)


def bag_backward_row(table_rows, ids, d, slice_of=None) -> dict:
    """K5's backward at one training lookup's shape: the transposed bag of
    ``ids`` (bags of one, weight 1) into a dense (table_rows, d) gradient —
    entries sorted by row, the output's gradient as the table — by K5's
    split launch, as `ops.EmbeddingBag.backward` calls it.  With
    ``slice_of`` = (n_model, rank), the vocab-parallel shape of that rank:
    its rows of the table, every foreign id at its row 0 and weight 0.
    Held bit for bit to the run-order plain version (on the card: its sums
    are elementwise) and to one `embedding_dense_backward` call of the
    same function (the weights folded into its input) within 1e-5 of each
    row's Σ|terms|; device ms (the profiler, every kernel of a call) gated
    below that call's, beside its bound, the plain version (`index_add_`)
    and the whole backward: the stable sort, the weights' gather and K5."""
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.embedding_bag.ref import (embedding_bag_ref,
                                                       embedding_bag_runs_ref)

    dout, idx, w_in, seg, rows, w, table_rows = bag_backward_inputs(
        table_rows, ids, d, slice_of)
    n = idx.numel()

    def kernel():
        return eb_cuda.embedding_bag_cuda(dout, seg, rows, w, table_rows,
                                          split=True)

    def whole():
        o = torch.argsort(idx, stable=True)
        return eb_cuda.embedding_bag_cuda(
            dout, o.to(torch.int32), idx[o].to(torch.int32), w_in[o],
            table_rows, split=True)

    def plain():
        return embedding_bag_ref(dout, seg, rows, table_rows, weights=w)

    dout_w = dout * w_in[:, None]

    def library():
        return torch.ops.aten.embedding_dense_backward(dout_w, idx,
                                                       table_rows, -1, False)

    got, lib = kernel(), library()
    run, group = eb_cuda.run_shape()
    runs = embedding_bag_runs_ref(dout, seg, rows, table_rows, weights=w,
                                  run=run, group=group)
    check(torch.equal(got, runs) and torch.equal(whole(), got),
          f"K5 backward {slice_of}: not the run-order plain version's bits")
    err = float((got - lib).abs().max() / lib.abs().max())
    # the two sum a row's entries in other orders: held to 1e-5 of the
    # row's Σ|terms| (K5 over |dout|), the tolerance of every fp32 sum here
    terms = eb_cuda.embedding_bag_cuda(dout.abs(), seg, rows, w.abs(),
                                       table_rows, split=True)
    excess = float(((got - lib).abs() - 1e-5 * terms).max())
    check(excess <= 0, f"K5 backward vs embedding_dense_backward: max "
          f"{err} of max |g|, past 1e-5 of Σ|terms| by {excess}")
    plain_err = float((plain() - lib).abs().max() / lib.abs().max())
    counts = torch.bincount(idx, minlength=table_rows)
    long_rows = counts > run
    del runs, terms
    dev_ms, lib_dev_ms = profiled_call_ms(kernel), profiled_call_ms(library)
    check(dev_ms is not None and lib_dev_ms is not None
          and dev_ms < lib_dev_ms, f"K5 backward {slice_of}: device "
          f"{dev_ms} ms, not below embedding_dense_backward's {lib_dev_ms}")
    nbytes = 4 * (n * d + 3 * n + table_rows * d)
    return dict(entries=n, rows=table_rows, d=d, slice_of=slice_of,
                own_share=float(w_in.mean()), rel_err_vs_library=err,
                plain_rel_err=plain_err,
                ms=time_auto(kernel), dev_ms=dev_ms,
                whole_ms=time_auto(whole),
                whole_dev_ms=profiled_call_ms(whole),
                plain_ms=time_auto(plain), library_ms=time_auto(library),
                library_dev_ms=lib_dev_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                run=run, group=group, long_rows=int(long_rows.sum()),
                long_entries=int(counts[long_rows].sum()),
                largest_row_entries=int(counts.max()))


def phase_recsys_train():
    """`sasrec` trained at its published widths (fp32, AdamW) on
    train_batch's 65,536 users: one unrecorded step and RECSYS_TRAIN_STEPS
    steps, checks a-c; returns K5's launches over the recorded steps."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.launch.cells import recsys_train_step
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.recsys import init_sasrec, sasrec_train_loss
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import value_and_grad

    t_phase = time.perf_counter()
    failures = []

    def gate(cond, what):
        if not cond:
            failures.append(what)

    arch = get_arch("sasrec")
    cfg = arch.make_config()
    B = arch.shapes["train_batch"]["batch"]
    params = init_sasrec(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = {k: v.cuda() for k, v in next(recsys_batches(
        B, cfg.seq_len, cfg.n_items, seed=4)).items()}

    def step(p, o):
        return recsys_train_step(cfg, p, o, batch)

    p0 = params
    torch.cuda.reset_peak_memory_stats()
    first = step(p0, adamw_init(p0))                  # unrecorded
    params, opt, loss0 = first
    eb_cuda.LAUNCHES = 0                              # the recorded steps
    secs, losses = [], []
    for _ in range(RECSYS_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    k5 = eb_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(secs)
    # where a step's time goes: K5's six launches (three lookups, three
    # transposed-bag backwards of two kernels each) beside the step's
    # other kernels
    by_name = device_profile(lambda: step(params, opt), warmup=1)
    k5_prof = [v for n, v in by_name.items() if "embedding_bag_" in n]
    profile = dict(cuda_kernels=sum(v[0] for v in by_name.values()),
                   device_ms=sum(v[1] for v in by_name.values()),
                   k5_kernels=sum(v[0] for v in k5_prof),
                   k5_ms=sum(v[1] for v in k5_prof),
                   top=top_kernels(by_name))
    del by_name
    run = dict(arch=cfg.name, dtype=str(cfg.dtype).split(".")[-1], users=B,
               seq_len=cfg.seq_len, steps=RECSYS_TRAIN_STEPS,
               step_ms=[s * 1e3 for s in secs], median_step_ms=step_s * 1e3,
               users_per_s=B / step_s, max_memory_allocated=peak,
               loss_first=float(loss0), losses=losses, k5_launches=k5,
               step_profile=profile)
    emit("recsys_train_run", **run)
    gate(k5 == 6 * RECSYS_TRAIN_STEPS,
         f"recsys_train: {k5} K5 launches, not 6 x {RECSYS_TRAIN_STEPS}")
    gate(all(np.isfinite(losses)), f"recsys_train: loss {float(loss0)} -> "
         f"{losses}")

    # (a) gradients with K5 against the plain lookups and their autograd,
    # both beside the plain ones in fp64
    def grads_of(prefer, dtype):
        p = tree_map(lambda t: t.to(dtype), p0)
        return value_and_grad(lambda q, b: sasrec_train_loss(
            cfg, q, b, bag_prefer=prefer))(p, batch)[1]

    g_k5, g_ref = grads_of("auto", torch.float32), grads_of("ref",
                                                            torch.float32)
    g_64 = grads_of("ref", torch.float64)
    gaps_a = dict(k5_vs_plain=tree_gap(g_k5, g_ref, "max"),
                  k5_vs_fp64=tree_gap(g_k5, g_64, "max"),
                  plain_vs_fp64=tree_gap(g_ref, g_64, "max"))
    # Two fp32 sums of one row's ~10^6 entries in other orders differ by
    # ~1e-5 of the leaf's max, and both sit ~6.5e-4 from fp64 (PERF.md
    # §6): K5 is held to be as close to the fp64 gradient as the plain
    # fp32 backward is, within RECSYS_TRAIN_FP64_SLACK
    gate(gaps_a["k5_vs_fp64"]
         <= RECSYS_TRAIN_FP64_SLACK * gaps_a["plain_vs_fp64"],
         f"recsys_train (a): K5 vs plain gradients {gaps_a}")
    del g_k5, g_ref, g_64
    # (b) the first step again: the same bits
    again = step(p0, adamw_init(p0))
    check_b = bool(torch.equal(again[2], first[2])
                   and trees_equal(again[0], first[0]))
    gate(check_b, "recsys_train (b): two identical steps gave different bits")
    del again, first

    # (c) the smoke config: one step, card against CPU
    smoke = arch.make_smoke_config()
    sp = init_sasrec(smoke, torch.Generator().manual_seed(0))
    sb = next(recsys_batches(64, smoke.seq_len, smoke.n_items, seed=1))
    sb["item_seq"][:8, :5] = 0                               # left padding
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), sp)
        out[dev] = recsys_train_step(smoke, p, adamw_init(p),
                                     {k: v.to(dev) for k, v in sb.items()})
    loss_gap = abs(float(out["cuda"][2]) - float(out["cpu"][2])) \
        / abs(float(out["cpu"][2]))
    param_gap = max(float((a.cpu() - b).abs().max()) for a, b in
                    zip(tree_leaves(out["cuda"][0]), tree_leaves(out["cpu"][0])))
    gate(loss_gap <= RECSYS_TRAIN_TOL and param_gap <= RECSYS_TRAIN_TOL,
         f"recsys_train (c): card vs CPU loss {loss_gap}, params {param_gap}")

    k5_backward = bag_backward_row(cfg.table_rows, batch["pos_items"],
                                   cfg.embed_dim)
    # (h)'s shape: model rank 1's rows of two, the foreign ids at row 0
    k5_backward_slice = bag_backward_row(cfg.table_rows, batch["pos_items"],
                                         cfg.embed_dim, slice_of=(2, 1))
    emit("recsys_train", **run, check_a=gaps_a,
         check_a_slack=RECSYS_TRAIN_FP64_SLACK,
         k5_backward=k5_backward, k5_backward_slice=k5_backward_slice,
         check_b_bit_identical=check_b,
         check_c=dict(loss_gap=loss_gap, param_gap=param_gap,
                      tol=RECSYS_TRAIN_TOL), failures=failures,
         seconds=time.perf_counter() - t_phase)
    check(not failures, "recsys_train: " + "; ".join(failures))
    del params, opt, p0, batch
    torch.cuda.empty_cache()
    return k5


GNN_STEPS = 3                  # measured steps, after one unrecorded
GNN_REMAT_LIMIT = 70e9         # bytes: GraphCast recomputes its layers above
GNN_SMOKE_TOL = 1e-5           # (c) loss (relative) and params, card vs CPU
GNN_ROT_TOL = dict(rtol=1e-4, atol=1e-3)   # (d), tests/test_models_gnn.py's
GNN_SCATTER_TOL = 1e-5         # (e) of Σ|terms|
GNN_PARENT = (232_965, 2_000_000)   # minibatch_lg's parent R-MAT (cut)
GNN_RUNS = (("meshgraphnet", "full_graph_sm"), ("meshgraphnet", "minibatch_lg"),
            ("graphcast", "full_graph_sm"), ("graphcast", "minibatch_lg"),
            ("nequip", "molecule"), ("mace", "molecule"))
GNN_FALL_CELL = {"meshgraphnet": "full_graph_sm", "graphcast": "full_graph_sm",
                 "nequip": "molecule", "mace": "molecule"}
GNN_SCATTER_KERNELS = ("segment_reduce", "index_copy")   # (f) the sums


def gnn_cell_batches(seed: int = 0,
                     cells=("full_graph_sm", "minibatch_lg", "molecule")
                     ) -> dict:
    """The GNN cells' host batches: ``full_graph_sm`` (``rmat_graph(2708,
    5278)`` by `gnn_full_batch`, d_feat 1,433, padded to 10,556 edge slots
    with masked slots at node 0, as ``_gnn_batch_abstract`` pads),
    ``minibatch_lg`` (`sample_neighbors` of 1,024 seeds, fan-out (15, 10),
    from ``rmat_graph(*GNN_PARENT)``, at the static capacity 169,984 ×
    168,960, d_feat 602: features and targets drawn for the sampled
    nodes, column 0 their normalised parent degree) and ``molecule``
    (``molecule_batches(128, 30, 64)``).  Node targets are drawn 227 wide
    (GraphCast's n_vars); MeshGraphNet takes the first 3.  ``cells``
    without ``minibatch_lg`` skips its parent graph."""
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.data.synthetic import gnn_full_batch, molecule_batches
    from repro_torch.mesh.graphs import rmat_graph
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.models.gnn.sampler import sample_neighbors

    t0 = time.perf_counter()
    out, info = {}, {}
    sm = GNN_SHAPES["full_graph_sm"]
    g = rmat_graph(sm["n_nodes"], sm["n_edges"] // 2, seed=seed)
    b = gnn_full_batch(g, d_feat=sm["d_feat"], d_out=227, seed=seed)
    pad = sm["n_edges"] - g.nnz
    z = torch.zeros(pad, dtype=torch.int32)
    out["full_graph_sm"] = dataclasses.replace(
        b, edge_src=torch.cat([b.edge_src, z]),
        edge_dst=torch.cat([b.edge_dst, z]),
        edge_mask=torch.cat([b.edge_mask, torch.zeros(pad)]), plans={})
    info["full_graph_sm"] = dict(nnz=g.nnz, padded_slots=pad)
    mol = GNN_SHAPES["molecule"]
    out["molecule"] = next(molecule_batches(mol["batch"], mol["n_nodes"],
                                            mol["n_edges"], seed=seed))
    info["molecule"] = dict(atoms=out["molecule"].n_nodes,
                            edges=int(out["molecule"].edge_src.shape[0]))
    if "minibatch_lg" not in cells:
        return out, dict(info, host_s=time.perf_counter() - t0)
    mb = GNN_SHAPES["minibatch_lg"]
    parent = rmat_graph(*GNN_PARENT, seed=seed)
    rng = np.random.default_rng(seed + 1)
    seeds = rng.choice(parent.n, mb["batch_nodes"], replace=False)
    sub = sample_neighbors(parent, seeds, mb["fanout"], rng=rng)
    n_real = int(sub.node_mask.sum())
    feat = np.zeros((sub.node_ids.size, mb["d_feat"]), np.float32)
    feat[:n_real] = rng.standard_normal((n_real, mb["d_feat"]),
                                        dtype=np.float32)
    deg = parent.degrees[sub.node_ids[:n_real]].astype(np.float32)
    feat[:n_real, 0] = (deg - deg.mean()) / max(deg.std(), 1.0)
    tgt = np.zeros((sub.node_ids.size, 227), np.float32)
    tgt[:n_real] = 0.1 * rng.standard_normal((n_real, 227), dtype=np.float32)
    out["minibatch_lg"] = GraphBatch(
        node_feat=torch.from_numpy(feat),
        edge_src=torch.from_numpy(sub.edge_src),
        edge_dst=torch.from_numpy(sub.edge_dst),
        node_mask=torch.from_numpy(sub.node_mask),
        edge_mask=torch.from_numpy(sub.edge_mask),
        targets=torch.from_numpy(tgt))
    info.update(host_s=time.perf_counter() - t0,
                minibatch_lg=dict(parent_nodes=parent.n,
                                  parent_nnz=parent.nnz, sampled_nodes=n_real,
                                  sampled_edges=int(sub.edge_mask.sum())))
    return out, info


def gnn_config(arch_id, cell, smoke=False):
    """The arch's config for the cell, as ``_gnn_cell`` sizes it (d_in from
    the cell's d_feat; ``cell`` None: ``make_config()``); the equivariant
    ones as the launcher's (no extra scalar features: the molecules carry
    none)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import GNN_SHAPES

    arch = get_arch(arch_id)
    if smoke:
        return arch.make_smoke_config()
    if cell is None:                   # the published config as it stands
        return arch.make_config()
    d_feat = GNN_SHAPES[cell].meta.get("d_feat", 0)
    if arch_id == "meshgraphnet":
        return arch.make_config(d_in=max(d_feat, 3), d_out=3)
    if arch_id == "graphcast":
        return arch.make_config(d_in=max(d_feat, 1))
    return arch.make_config()


def gnn_batch_for(arch_id, cfg, batch):
    """``batch`` with the arch's targets (MeshGraphNet: the first d_out
    columns), on the card."""
    if arch_id == "meshgraphnet":
        batch = dataclasses.replace(batch, targets=batch.targets[:, :cfg.d_out]
                                    .contiguous(), plans={})
    return batch.to("cuda")


def gnn_init(arch_id, cfg, device="cuda", seed=0):
    from repro_torch.models import gnn

    init = {"meshgraphnet": gnn.init_mgn, "graphcast": gnn.init_graphcast,
            "nequip": gnn.init_nequip, "mace": gnn.init_mace}[arch_id]
    return init(cfg, torch.Generator(device=device).manual_seed(seed))


def gnn_remat_choice(cfg, batch) -> dict:
    """Whether GraphCast recomputes its layers at ``batch``: the peak of one
    step without recompute at 2 and 4 layers, extrapolated linearly to
    the config's depth, against GNN_REMAT_LIMIT."""
    from repro_torch.launch.cells import gnn_train_step
    from repro_torch.train.optimizer import adamw_init

    peaks = {}
    for depth in (2, 4):
        c = dataclasses.replace(cfg, n_layers=depth)
        p = gnn_init("graphcast", c)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = gnn_train_step("graphcast", c, p, adamw_init(p), batch)
        torch.cuda.synchronize()
        peaks[depth] = torch.cuda.max_memory_allocated()
        del p, out
    per_layer = (peaks[4] - peaks[2]) / 2
    predicted = peaks[2] + (cfg.n_layers - 2) * per_layer
    return dict(peak_2_layers=peaks[2], peak_4_layers=peaks[4],
                per_layer_bytes=per_layer, predicted_peak=predicted,
                limit=GNN_REMAT_LIMIT, remat=bool(predicted > GNN_REMAT_LIMIT))


def gnn_run(arch_id, cell, batch, remat=False) -> tuple:
    """One (arch, cell) at full width: one unrecorded step, GNN_STEPS
    timed (median), peak memory, the FLOP share; returns (row, params0,
    the state after the first step, the step function)."""
    from repro_torch.launch.cells import gnn_model_flops, gnn_train_step
    from repro_torch.train.optimizer import adamw_init

    cfg = gnn_config(arch_id, cell)
    b = gnn_batch_for(arch_id, cfg, batch)
    p0 = gnn_init(arch_id, cfg)

    def step(p, o):
        return gnn_train_step(arch_id, cfg, p, o, b, remat=remat)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, loss0 = step(p0, adamw_init(p0))          # plans built here
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    secs, losses = [], [float(loss0)]
    for _ in range(GNN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    step_s = statistics.median(secs)
    n_nodes, n_edges = b.n_nodes, int(b.edge_src.shape[0])
    flops = gnn_model_flops(arch_id, cfg, n_nodes, n_edges)
    row = dict(arch=arch_id, cell=cell, n_layers=cfg.n_layers,
               d_hidden=cfg.d_hidden, nodes=n_nodes, edges=n_edges,
               first_step_s=first_s, step_ms=[s * 1e3 for s in secs],
               median_step_ms=step_s * 1e3,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               model_flops=flops, tflops=flops / step_s / 1e12,
               fp32_share=flops / step_s / FP32_FLOPS_PER_S,
               remat=remat, losses=losses)
    return row, (cfg, b, p0, step, params, opt)


def gnn_scatter_case(index, n, d, seed) -> dict:
    """(e): the ordered sum against ``index_add_`` at one index (the batch's
    destinations: `scatter_sum`; its sources: `gather`'s backward), d
    wide: the gap over Σ|terms|, both device ms (profiler), the bytes
    bound (the values and the index read once, the rows written once)."""
    from repro_torch.models.gnn.common import gather, scatter_sum, segment_plan

    gen = torch.Generator(device="cuda").manual_seed(seed)
    E = index.shape[0]
    v = torch.randn(E, d, generator=gen, device="cuda")
    plan = segment_plan(index, n)
    got = scatter_sum(v, plan, n)
    want = torch.zeros(n, d, device="cuda").index_add_(0, index, v)
    terms = torch.zeros(n, d, device="cuda").index_add_(0, index, v.abs())
    gap = float(((got - want).abs() / terms.clamp(min=1e-30)).max())
    same = bool(torch.equal(got, scatter_sum(v, plan, n)))
    x = torch.zeros(n, d, device="cuda", requires_grad=True)
    (g1,) = torch.autograd.grad((gather(x, plan) * v).sum(), x)
    (g2,) = torch.autograd.grad((gather(x, plan) * v).sum(), x)
    back_same = bool(torch.equal(g1, g2))
    back_gap = float(((g1 - want).abs() / terms.clamp(min=1e-30)).max())
    nbytes = E * d * 4 + E * 8 + n * d * 4
    row = dict(d=d, E=E, n=n, levels=len(plan.tree) + 1,
               longest_row=int(torch.bincount(index, minlength=n).max()),
               max_err_of_terms=gap, backward_max_err_of_terms=back_gap,
               bits_twice=same, backward_bits_twice=back_same,
               ordered_dev_ms=profiled_call_ms(
                   lambda: scatter_sum(v, plan, n), sessions=5),
               index_add_dev_ms=profiled_call_ms(
                   lambda: torch.zeros(n, d, device="cuda")
                   .index_add_(0, index, v), sessions=5),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    return row


def phase_gnn():
    """Phase 13: the four GNNs trained at their published widths (fp32,
    AdamW) through `launch.cells.gnn_train_step` on their cells, and the
    checks a-f; every check runs before the phase fails."""
    from repro_torch.launch.cells import gnn_train_step
    from repro_torch.models import gnn
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.optimizer import adamw_init

    t_phase = time.perf_counter()
    failures = []

    def gate(cond, what):
        if not cond:
            failures.append(what)

    batches, info = gnn_cell_batches()
    emit("gnn_cells", **info)
    gc_cfg = gnn_config("graphcast", "minibatch_lg")
    choice = gnn_remat_choice(gc_cfg, gnn_batch_for("graphcast", gc_cfg,
                                                    batches["minibatch_lg"]))
    runs = {}
    for arch_id, cell in GNN_RUNS:
        remat = arch_id == "graphcast" and cell == "minibatch_lg" \
            and choice["remat"]
        row, state = gnn_run(arch_id, cell, batches[cell], remat=remat)
        cfg, b, p0, step, params, opt = state
        if GNN_FALL_CELL[arch_id] == cell:                        # (a)
            row["check_a_loss_falls"] = bool(
                np.isfinite(row["losses"]).all()
                and row["losses"][-1] < row["losses"][0])
            gate(row["check_a_loss_falls"],
                 f"gnn (a) {arch_id} {cell}: loss {row['losses']}")
        if (arch_id, cell) in (("meshgraphnet", "minibatch_lg"),
                               ("mace", "molecule")):             # (b)
            a = step(p0, adamw_init(p0))
            c = step(p0, adamw_init(p0))
            row["check_b_bits_twice"] = bool(
                torch.equal(a[2], c[2]) and trees_equal(a[0], c[0]))
            gate(row["check_b_bits_twice"],
                 f"gnn (b) {arch_id} {cell}: two steps differ")
            del a, c
        if arch_id in ("nequip", "mace"):                         # (d)
            rng = np.random.default_rng(3)
            Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            if np.linalg.det(Q) < 0:
                Q[:, 0] *= -1
            energy = gnn.nequip_energy if arch_id == "nequip" \
                else gnn.mace_energy
            pos = b.positions.double()

            def e_at(x):
                bb = dataclasses.replace(b, positions=x.float())
                with torch.no_grad():
                    return energy(cfg, p0, bb).cpu().numpy()

            e1 = e_at(pos)
            e2 = e_at(pos @ torch.from_numpy(Q.T).cuda())
            e3 = e_at(pos + torch.from_numpy(rng.normal(size=3)).cuda())
            rot = float(np.abs(e2 - e1).max())
            tr = float(np.abs(e3 - e1).max())
            ok = bool(np.allclose(e2, e1, **GNN_ROT_TOL)
                      and np.allclose(e3, e1, **GNN_ROT_TOL))
            row["check_d"] = dict(rotation_gap=rot, translation_gap=tr,
                                  max_abs_energy=float(np.abs(e1).max()),
                                  ok=ok)
            gate(ok, f"gnn (d) {arch_id}: energies moved {rot}, {tr}")
        if arch_id == "graphcast" and cell == "minibatch_lg":     # (f)
            by_name = device_profile(lambda: step(params, opt), warmup=1)
            dev_ms = sum(v[1] for v in by_name.values())

            def is_sum(name):
                return any(k in name for k in GNN_SCATTER_KERNELS)

            def is_take(name):          # index_select's gather kernels
                low = name.lower()
                return ("gather" in low or "indexselect" in low) \
                    and not is_sum(name)

            def share(pick):
                return sum(v[1] for n, v in by_name.items() if pick(n)) \
                    / max(dev_ms, 1e-9)

            row["check_f_profile"] = dict(
                device_ms=dev_ms,
                cuda_kernels=sum(v[0] for v in by_name.values()),
                gather_share=share(is_take), scatter_share=share(is_sum),
                gather_scatter_kernels=[
                    dict(name=n[:100], count=v[0], ms=v[1])
                    for n, v in by_name.items() if is_take(n) or is_sum(n)],
                top=top_kernels(by_name))
            gate(dev_ms > 0, "gnn (f): the profiler traced no device time")
        if arch_id == "graphcast" and cell == "minibatch_lg":
            row["remat_choice"] = choice
        emit("gnn_run", **row)
        runs[(arch_id, cell)] = row
        del state, cfg, b, p0, step, params, opt
        torch.cuda.empty_cache()

    # (c) each smoke config, one step, card against CPU
    from repro_torch.launch.train import make_loss_and_data

    check_c = {}
    for arch_id in GNN_FALL_CELL:
        cfg, params, _, data = make_loss_and_data(arch_id, True, 8, 8, 0,
                                                  device="cpu")
        batch = next(data)
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            out[dev] = gnn_train_step(arch_id, cfg, p, adamw_init(p),
                                      batch.to(dev))
        loss_gap = abs(float(out["cuda"][2]) - float(out["cpu"][2])) \
            / abs(float(out["cpu"][2]))
        param_gap = max(float((a.cpu() - c).abs().max()) for a, c in
                        zip(tree_leaves(out["cuda"][0]),
                            tree_leaves(out["cpu"][0])))
        check_c[arch_id] = dict(loss_gap=loss_gap, param_gap=param_gap)
        gate(loss_gap <= GNN_SMOKE_TOL and param_gap <= GNN_SMOKE_TOL,
             f"gnn (c) {arch_id}: card vs CPU loss {loss_gap}, params "
             f"{param_gap}")

    # (e) the ordered sum against index_add_ at minibatch_lg's layout
    mb = batches["minibatch_lg"]
    check_e = []
    for which in ("edge_dst", "edge_src"):
        index = getattr(mb, which).long().cuda()
        for d in (128, 512):
            r = gnn_scatter_case(index, mb.n_nodes, d, seed=d)
            r["index"] = which
            check_e.append(r)
            gate(r["max_err_of_terms"] <= GNN_SCATTER_TOL
                 and r["backward_max_err_of_terms"] <= GNN_SCATTER_TOL
                 and r["bits_twice"] and r["backward_bits_twice"],
                 f"gnn (e) {which} d {d}: {r}")
    emit("gnn", runs=list(runs.values()), check_c=check_c,
         check_c_tol=GNN_SMOKE_TOL, check_e=check_e,
         check_e_tol=GNN_SCATTER_TOL, failures=failures,
         seconds=time.perf_counter() - t_phase)
    check(not failures, "gnn: " + "; ".join(failures))
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# Phase 14: shard — the sharding rules across ranks (tensor, data and
# expert parallelism; reshard; placements)
# ---------------------------------------------------------------------------

SHARD_WORLD = 4                 # gloo ranks sharing the card
SHARD_LAYERS = 2                # (a), (b): layers of mistral and deepseek
SHARD_TRAIN_LAYERS = 1          # (c): deepseek, fp32 compute
SHARD_RUN = (4, 512, 16)        # (a), (b): batch, prompt, greedy steps
SHARD_TRAIN_BATCH = (4, 256)    # (c): the global batch, split over data
SHARD_SEED = 0
# (a), (b): ‖Δ‖₂ / ‖ref‖₂ of every logit row (prefill's last position and
# each step's) against the one-process run on the same tokens; each limit
# lies between the sharded run's reading and a control's (the one-process
# run with its attention output rounded to SHARD_CONTROL_BITS mantissa
# bits), both read on the card
SHARD_GAP_LIMIT = {"mistral-large-123b": 1e-2, "deepseek-moe-16b": 1e-2}
SHARD_CONTROL_BITS = 4
SHARD_MOE_TOKENS = 512          # (b) one fp32 MoE layer, EP vs one process
SHARD_MOE_TOL = 2e-4            # (b): of max|y| (repro's gate)
SHARD_LOSS_TOL = 2e-3           # (c): repro's gate, EP loss vs pjit loss
SHARD_PARAM_TOL = 1e-4          # (c): of each leaf's max
# (c): AdamW's first step moves an entry by lr · g / (|g| + eps), so where
# the one-process gradient lies within the sharded run's rounding of 0 the
# two steps move it apart (by up to 2 lr); a param entry further than
# SHARD_PARAM_TOL from the one-process one must have |g| ≤ SHARD_FLAT_TOL
# of its leaf's max|g|
SHARD_FLAT_TOL = 1e-4
# (h) SASRec across ranks at its published widths: serve_p99 (512 users,
# top-100), retrieval_cand (1 user, 10^6 candidates) and train steps on
# train_batch's users cut from 65,536 to SHARD_RECSYS_USERS (the gloo
# ranks' wire runs through the host), against the one-process runs on the
# card (the parent's, same seed and inputs)
SHARD_RECSYS_USERS = 8192
SHARD_RECSYS_STEPS = 2
SHARD_RECSYS_TOL = 1e-5         # states and scores (of max), top-100
                                # values, loss (relative)
SHARD_RECSYS_PARAM_TOL = 1e-4   # params after the steps, of each leaf's max
SHARD_RECSYS_SEED = 0
# (i) the GNNs across ranks at their published widths (fp32, AdamW,
# OPT_CFG), GraphCast's depth cut (SHARD_GNN_LAYERS): MGN and GraphCast on
# full_graph_sm, NequIP and MACE on molecule, under gnn_rules (gloo: (data
# 2, model 2), each rank a quarter of the nodes and edges; NCCL: (1, 1)),
# SHARD_GNN_STEPS steps from one state and the first again, against the
# parent's one-process steps on the card (the same seed and batch)
SHARD_GNN_RUNS = (("meshgraphnet", "full_graph_sm"),
                  ("graphcast", "full_graph_sm"), ("nequip", "molecule"),
                  ("mace", "molecule"))
SHARD_GNN_STEPS = 2
# (i)'s depth cuts: GraphCast's 16 identical layers to 8 (its gloo ranks run
# through the host: 7.5–11.4 s of the part's 17.9–26.0 s at 16 layers on one
# H100's host, the spread the host's)
SHARD_GNN_LAYERS = {"graphcast": 8}
SHARD_GNN_LOSS_TOL = 1e-5       # relative, every step's loss
SHARD_GNN_GRAD_TOL = 1e-4       # the clipped gradient (AdamW's first
                                # moment after one step), of each leaf's max
SHARD_GNN_PARAM_TOL = 1e-4      # the params after one step, of each leaf's
                                # max; an entry further off must sit at a
                                # gradient within SHARD_FLAT_TOL of its
                                # leaf's max|g| of 0, as (c)'s (AdamW's
                                # first step moves it by ±lr on g's sign:
                                # MGN and GraphCast read 1.88e-4 / 1.35e-3
                                # of max on one H100 against the plain 1e-4)
SHARD_GNN_SEED = 0
SHARD_GNN_SECONDS = 25.0        # (i): reference + slowest gloo rank + NCCL
SHARD_PLACEMENTS = {"pod": ((16, 16), ("data", "model")),
                    "node": ((1, 8), ("data", "model"))}
SHARD_CARD_BYTES = 80e9


def shard_config(arch_id, layers, dtype=None, **moe_kw):
    """``arch_id``'s published config cut to ``layers`` layers; ``moe_kw``
    replaces fields of its MoE config."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(arch_id).make_config(),
                              n_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
    return cfg


def train_config(impl):
    """(c)'s config: deepseek cut to SHARD_TRAIN_LAYERS layers, fp32
    compute, no drops, no recompute (the same bits either way)."""
    cfg = shard_config("deepseek-moe-16b", SHARD_TRAIN_LAYERS,
                       dtype=torch.float32)
    return dataclasses.replace(
        shard_config("deepseek-moe-16b", SHARD_TRAIN_LAYERS,
                     dtype=torch.float32, impl=impl,
                     capacity_factor=no_drop(cfg)), remat=False)


def no_drop(cfg):
    """The MoE capacity factor E / top_k: C ≥ T, no token can drop."""
    return cfg.moe.n_experts / cfg.moe.top_k


def shard_greedy(model, prompts, steps, forced=None):
    """Prefill ``prompts`` (B, P) and ``steps`` decode steps, each fed the
    previous row's argmax (or ``forced[:, i]``): the tokens fed (B, steps)
    and the logit rows (B, steps + 1, V) in fp32, on the host."""
    from repro_torch.models import transformer as tt

    B, P = prompts.shape
    with torch.inference_mode():
        cache = tt.init_cache(model.cfg, B, P + steps, "cuda",
                              rules=model.rules)
        logits, cache = tt.prefill(model, prompts, cache)
        rows, toks = [logits[:, -1]], []
        for i in range(steps):
            nxt = rows[-1].argmax(-1) if forced is None else forced[:, i]
            toks.append(nxt)
            logits, cache = tt.decode_step(model, cache, nxt[:, None], P + i)
            rows.append(logits[:, -1])
    torch.cuda.synchronize()
    return torch.stack(toks, 1).cpu(), torch.stack(rows, 1).float().cpu()


@contextlib.contextmanager
def count_drops():
    """Inside, every `models.moe.dispatch` adds its dropped and total
    (token, choice) entries to the yielded [dropped, total, capacities]
    (the C of each call).  The pjit dispatch counts the global entries,
    the same on every rank."""
    from repro_torch.models import moe as mt

    kept, box = mt.dispatch, [0, 0, set()]

    def dispatch(moe, top_e, n_tokens):
        slot, keep, C = kept(moe, top_e, n_tokens)
        box[0] += int((~keep).sum())
        box[1] += keep.numel()
        box[2].add(C)
        return slot, keep, C

    mt.dispatch = dispatch
    try:
        yield box
    finally:
        mt.dispatch = kept


def shard_rank(p) -> dict:
    """What one rank of phase ``shard`` runs (every rank of the default
    group; gloo: 4 ranks sharing the card, NCCL: one), sequence parallel
    (`lm_rules`): (a) mistral's TP serve on a (1, world) mesh; (b)
    deepseek's EP serve there, then its prompts' prefill at the published
    capacity twice as expert parallelism and twice as the pjit dispatch
    (the global capacity), one fp32 MoE layer each way; (c) deepseek's
    train step on (2, world / 2) (NCCL: (1, 1)), twice from one state, its
    params and first moments against the one-process step's saved at
    ``p["ref_path"]``; the bytes on the wire of (a)'s greedy run and (c)'s
    step (the census); (e) with 4 ranks, the
    step's attention and router leaves gathered, saved by rank 0 and
    restored onto ranks 0 and 1.  K6 and K5 launches counted from 0 over
    (a)–(c)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import group as dist_group
    from repro_torch.dist.sharding import (lm_rules, local_slice,
                                           param_specs_lm, spec_leaves,
                                           tree_specs)
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.launch.cells import lm_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import collective_stats
    from repro_torch.models import transformer as tt
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.moe import init_moe
    from repro_torch.train.checkpoint import (load_checkpoint, reshard,
                                              save_checkpoint, unshard)
    from repro_torch.train.optimizer import adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_rank = time.perf_counter()
    world, r = dist.get_world_size(), dist.get_rank()
    tp = lm_rules(make_mesh((1, world), ("data", "model")))
    B, P, steps = SHARD_RUN
    out = dict(coords=tp.coords)
    fa_cuda.LAUNCHES = fa_cuda.BACKWARD_LAUNCHES = 0
    eb_cuda.LAUNCHES = 0

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    for key, arch in (("a", "mistral-large-123b"), ("b", "deepseek-moe-16b")):
        cfg = shard_config(arch, SHARD_LAYERS)
        if cfg.moe is not None:
            published = cfg.moe.capacity_factor
            cfg = shard_config(arch, SHARD_LAYERS, impl="shardmap",
                               capacity_factor=no_drop(cfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k6, k5 = fa_cuda.LAUNCHES, eb_cuda.LAUNCHES
        t0 = time.perf_counter()
        model = tt.build_model(cfg, torch.Generator(device="cuda")
                               .manual_seed(SHARD_SEED), tp)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        prompts = torch.from_numpy(p["prompts"][arch]).cuda()
        t0 = time.perf_counter()
        with dist_group.census() as cen:
            toks, rows = shard_greedy(model, prompts, steps)
        res = dict(tokens=toks.numpy(), logits=rows.numpy(), build_s=build_s,
                   run_s=time.perf_counter() - t0,
                   weight_bytes=sum(w.numel() * w.element_size()
                                    for w in model.parameters()),
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   k6=fa_cuda.LAUNCHES - k6, k5=eb_cuda.LAUNCHES - k5,
                   wire_bytes=collective_stats(cen.records).total_wire_bytes,
                   collectives=len(cen.records))
        if cfg.moe is not None:
            # the published capacity factor: the prompts' prefill twice as
            # expert parallelism (capacity per rank) and twice as the pjit
            # dispatch (capacity from the global token count)
            res["published"] = published
            for impl in ("shardmap", "pjit"):
                model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, impl=impl, capacity_factor=published))
                t0 = time.perf_counter()
                with torch.inference_mode():
                    with count_drops() as drops:
                        first, _ = tt.prefill(model, prompts)
                    again, _ = tt.prefill(model, prompts)
                res[impl] = dict(dropped=drops[0], entries=drops[1],
                                 capacity=sorted(drops[2]),
                                 bit_identical=bool(torch.equal(first,
                                                                again)),
                                 logits=first[:, -1].float().cpu().numpy(),
                                 seconds=time.perf_counter() - t0)
        out[key] = res
        del model
        free()

    # (b) one fp32 MoE layer at full width: EP against the parent's
    # one-process `moe_apply` on the same weights and tokens
    cfg = shard_config("deepseek-moe-16b", 1, dtype=torch.float32,
                       impl="shardmap", capacity_factor=8.0)
    full = init_moe(cfg.moe, cfg.d_model, torch.Generator(device="cuda")
                    .manual_seed(SHARD_SEED + 1), torch.float32)
    specs = tree_specs(tp, {"moe": full}, layer=True)["moe"]
    local = {k: tp.local(v, specs[k]).clone() for k, v in full.items()}
    del full
    x = torch.from_numpy(p["layer_x"]).cuda()
    pjit = shard_config("deepseek-moe-16b", 1, dtype=torch.float32,
                        capacity_factor=out["b"]["published"])
    with torch.inference_mode():
        y = tt._moe_shardmap_block(cfg, local, x, tp)
        with count_drops() as drops:
            y_pjit = tt._moe_pjit_block(pjit, local, x, tp)
    out["layer"] = dict(y=y.cpu().numpy(), pjit_y=y_pjit.cpu().numpy(),
                        pjit_dropped=drops[0], pjit_entries=drops[1])
    del local, x, y, y_pjit
    free()

    # (c) the train step: DP over data, TP and EP over model, FSDP experts
    shape = (2, world // 2) if world > 1 else (1, 1)
    rules = lm_rules(make_mesh(shape, ("data", "model")))
    cfg = train_config(impl="shardmap")
    full = tt.init_params(cfg, torch.Generator(device="cuda")
                          .manual_seed(SHARD_SEED + 2))
    specs = param_specs_lm(cfg, full, rules.mesh)
    params = reshard(full, rules.mesh, specs)
    del full
    free()
    opt = adamw_init(params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in p["train"].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k6, k6b, k5 = (fa_cuda.LAUNCHES, fa_cuda.BACKWARD_LAUNCHES,
                   eb_cuda.LAUNCHES)
    t0 = time.perf_counter()
    with dist_group.census() as cen:
        p1, o1, loss = lm_train_step(cfg, params, opt, batch, rules=rules)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    c = dict(mesh=shape, coords=rules.coords, loss=float(loss),
             step_s=step_s, peak_bytes=torch.cuda.max_memory_allocated(),
             k6=fa_cuda.LAUNCHES - k6, k5=eb_cuda.LAUNCHES - k5,
             k6_backward=fa_cuda.BACKWARD_LAUNCHES - k6b,
             wire_bytes=collective_stats(cen.records).total_wire_bytes,
             collectives=len(cen.records))
    p1b, _, loss_b = lm_train_step(cfg, params, opt, batch, rules=rules)
    c["repeat_equal"] = bool(float(loss_b) == float(loss) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(p1b))))
    o1 = {"m": o1["m"]}
    del p1b, params, opt
    free()
    ref = torch.load(p["ref_path"], mmap=True, weights_only=True)
    gaps, m_gaps, equal, off, flat = [], [], True, 0, True
    for got, m, want, want_m, spec in zip(
            tree_leaves(p1), tree_leaves(o1["m"]), tree_leaves(ref["params"]),
            tree_leaves(ref["m"]), spec_leaves(specs)):
        want = local_slice(want, spec, rules.coords, rules.mesh).cuda()
        want_m = local_slice(want_m, spec, rules.coords, rules.mesh).cuda()
        d = (got - want).abs()
        gaps.append(float(d.max() / want.abs().max()))
        m_scale = want_m.abs().max().clamp_min(1e-30)
        m_gaps.append(float((m - want_m).abs().max() / m_scale))
        far = d > SHARD_PARAM_TOL * want.abs().max()
        off += int(far.sum())
        flat = flat and bool((want_m[far].abs()
                              <= SHARD_FLAT_TOL * m_scale).all())
        equal = equal and bool(torch.equal(got, want)) \
            and bool(torch.equal(m, want_m))
    c.update(param_gap=max(gaps), grad_gap=max(m_gaps), params_off=off,
             params_off_flat=flat, n_local=sum(t.numel()
                                               for t in tree_leaves(p1)),
             params_equal=equal)
    del ref
    out["c"] = c
    out["k6"], out["k5"] = fa_cuda.LAUNCHES, eb_cuda.LAUNCHES
    out["k6_backward"] = fa_cuda.BACKWARD_LAUNCHES
    out["a_to_c_s"] = time.perf_counter() - t_rank

    if world == SHARD_WORLD:
        # (e) saved from the 4 ranks of (c)'s (2, 2) mesh, restored onto a
        # (1, 2) mesh of ranks 0 and 1
        keys = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo")
        sub = {"layers": {k: p1["layers"][k] for k in keys}}
        sub_specs = {"layers": {k: specs["layers"][k] for k in keys}}
        sub["layers"]["moe"] = {k: p1["layers"]["moe"][k] for k in
                                ("router", "shared_wi", "shared_wg",
                                 "shared_wo")}
        sub_specs["layers"]["moe"] = {k: specs["layers"]["moe"][k]
                                      for k in sub["layers"]["moe"]}
        t0 = time.perf_counter()
        whole = unshard(sub, rules.mesh, sub_specs)
        if r == 0:
            save_checkpoint(p["ckpt_dir"], 1, whole)
        dist.barrier()
        kind = "cuda" if str(dist.get_backend()) == "nccl" else "cpu"
        two = DeviceMesh(kind, torch.tensor([[0, 1]]),
                         mesh_dim_names=("data", "model"))
        e = dict(saved_from=shape, restored_onto=(1, 2),
                 bytes=sum(t.numel() * t.element_size()
                           for t in tree_leaves(whole)))
        if r < 2:
            _, restored, _ = load_checkpoint(
                f"{p['ckpt_dir']}/ckpt_00000001.npz", whole)
            specs2 = param_specs_lm(cfg, whole, two)
            back = reshard(restored, two, specs2)
            coords2 = dict(zip(two.mesh_dim_names, two.get_coordinate()))
            e["bit_identical"] = all(
                torch.equal(b, local_slice(w, s, coords2, two))
                for b, w, s in zip(tree_leaves(back), tree_leaves(whole),
                                   spec_leaves(specs2)))
            e["sharded_leaves"] = sum(any(x is not None for x in s)
                                      for s in spec_leaves(specs2))
        e["seconds"] = time.perf_counter() - t0
        dist.barrier()
        out["e"] = e
    del p1, o1
    free()
    out["h"] = shard_recsys_rank(p["recsys"])
    out["i"] = shard_gnn_rank(p["gnn"])
    return out


def shard_recsys_rank(p) -> dict:
    """(h) on one rank: SASRec's published config under `recsys_rules` on
    (data 2, model world / 2) (NCCL: (1, 1)), the weights drawn from the
    parent's seed and placed by `param_specs_recsys`: this rank's user
    states, streamed top-100 and retrieval block, the states again with
    each rank's rows shifted by one (the control), SHARD_RECSYS_STEPS
    train steps twice from one state (losses, bits, params against the
    parent's saved at ``p["ref_path"]``), and K5's forward and backward
    launches."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import (Spec, local_slice,
                                           param_specs_recsys, recsys_rules,
                                           spec_leaves)
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.launch.cells import (recsys_retrieval,
                                          recsys_serve_topk,
                                          recsys_train_step)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.recsys import SASRec, init_sasrec
    from repro_torch.models.recsys.sasrec import sasrec_train_loss
    from repro_torch.train.checkpoint import reshard
    from repro_torch.train.optimizer import adamw_init

    t_rank = time.perf_counter()
    world = dist.get_world_size()
    shape = (2, world // 2) if world > 1 else (1, 1)
    rules = recsys_rules(make_mesh(shape, ("data", "model")))
    cfg = get_arch("sasrec").make_config()
    full = init_sasrec(cfg, torch.Generator(device="cuda").manual_seed(
        SHARD_RECSYS_SEED))
    specs = param_specs_recsys(cfg, full, rules.mesh)
    params = reshard(full, rules.mesh, specs)
    shifted = reshard(dict(full, item_embed=full["item_embed"].roll(-1, 0)),
                      rules.mesh, specs)["item_embed"]
    del full
    users = Spec(("data",), None)
    seq = rules.local(torch.from_numpy(p["seq"]).cuda(), users)
    seq1 = torch.from_numpy(p["seq1"]).cuda()
    cand = rules.local(torch.from_numpy(p["cand"]).cuda(), Spec("model"))
    batch = {k: torch.from_numpy(v).cuda() for k, v in p["train"].items()}
    out = dict(mesh=shape, coords=rules.coords,
               table_rows_local=int(params["item_embed"].shape[0]))
    model = SASRec(cfg, params)
    chunk = p["user_chunk"] // shape[0]
    torch.cuda.synchronize()
    k5 = eb_cuda.LAUNCHES
    t0 = time.perf_counter()
    with torch.inference_mode():
        out["states"] = model.user_state(seq, rules).cpu().numpy()
        t1 = time.perf_counter()
        vals, ids = recsys_serve_topk(cfg, model, seq, k=RECSYS_K,
                                      user_chunk=chunk, rules=rules)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out["topk"] = (vals.cpu().numpy(), ids.cpu().numpy())
        t3 = time.perf_counter()
        scores = recsys_retrieval(cfg, model, seq1, cand, rules=rules)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        out["scores"] = scores.cpu().numpy()
        fwd = eb_cuda.LAUNCHES - k5
        # one step's loss alone: its forward launches (the three lookups)
        k5 = eb_cuda.LAUNCHES
        loss0 = float(sasrec_train_loss(cfg, params, {
            k: rules.local(v, users) for k, v in batch.items()}, rules=rules))
        fwd_step = eb_cuda.LAUNCHES - k5
    out.update(serve_s=t2 - t1, retrieval_s=t4 - t3, loss0=loss0,
               forward_s=time.perf_counter() - t0)
    with torch.inference_mode():      # the control: rows shifted by one
        ctl = SASRec(cfg, dict(params, item_embed=shifted))
        out["control_states"] = ctl.user_state(seq, rules).cpu().numpy()
    del ctl, shifted

    def steps():
        q, o, losses = params, adamw_init(params), []
        for _ in range(SHARD_RECSYS_STEPS):
            q, o, loss = recsys_train_step(cfg, q, o, batch, rules=rules)
            losses.append(float(loss))
        return q, losses

    torch.cuda.synchronize()
    k5 = eb_cuda.LAUNCHES
    t0 = time.perf_counter()
    q1, losses = steps()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train = eb_cuda.LAUNCHES - k5
    q2, losses2 = steps()
    out["repeat_equal"] = losses == losses2 and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(q1), tree_leaves(q2)))
    del q2
    # a step's launches past its loss's forward ones are its backward's
    # transposed bags
    out.update(k5_forward=fwd, k5_train=train,
               k5_train_forward=fwd_step * SHARD_RECSYS_STEPS,
               k5_train_backward=train - fwd_step * SHARD_RECSYS_STEPS,
               losses=losses, train_s=train_s)
    ref = torch.load(p["ref_path"], mmap=True, weights_only=True)
    gaps, equal = [], True
    for got, want, spec in zip(tree_leaves(q1), tree_leaves(ref),
                               spec_leaves(specs)):
        want = local_slice(want, spec, rules.coords, rules.mesh).cuda()
        gaps.append(float((got - want).abs().max() / want.abs().max()))
        equal = equal and bool(torch.equal(got, want))
    out.update(param_gap=max(gaps), params_equal=equal,
               seconds=time.perf_counter() - t_rank)
    del ref, q1, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shard_gnn_batch(arch_id, cfg, batch):
    """(i)'s whole batch of one arch: the cell's host batch with the
    arch's targets (`gnn_batch_for`, on the card), padded to a multiple
    of SHARD_WORLD (`pad_graph_batch`: the cells already are)."""
    from repro_torch.data.synthetic import pad_graph_batch

    return gnn_batch_for(arch_id, cfg, pad_graph_batch(batch, SHARD_WORLD))


def tree_gaps(got, want) -> list:
    """Each leaf's max |got − want| over its max |want|."""
    from repro_torch.models.common import tree_leaves

    return [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(tree_leaves(got), tree_leaves(want))]


def shard_gnn_config(arch_id, cell):
    """(i)'s config of one arch: `gnn_config`, cut to SHARD_GNN_LAYERS."""
    cfg = gnn_config(arch_id, cell)
    n = SHARD_GNN_LAYERS.get(arch_id)
    return cfg if n is None else dataclasses.replace(cfg, n_layers=n)


def shard_gnn_reference(path, batches) -> dict:
    """(i)'s one-process runs on the card (`NO_SHARD`): each arch's
    SHARD_GNN_STEPS steps from the ranks' seed, every step's loss and
    seconds; the first moment and params after the first step saved at
    ``path`` for the ranks."""
    from repro_torch.launch.cells import gnn_train_step
    from repro_torch.models.common import tree_map
    from repro_torch.train.optimizer import adamw_init

    t0 = time.perf_counter()
    out, saved = {}, {}
    for arch_id, cell in SHARD_GNN_RUNS:
        cfg = shard_gnn_config(arch_id, cell)
        b = shard_gnn_batch(arch_id, cfg, batches[cell])
        p = gnn_init(arch_id, cfg, seed=SHARD_GNN_SEED)
        o = adamw_init(p)
        losses, secs = [], []
        for i in range(SHARD_GNN_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            p, o, loss = gnn_train_step(arch_id, cfg, p, o, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            losses.append(float(loss))
            if i == 0:
                saved[arch_id] = tree_map(lambda t: t.cpu(), {
                    "m": o["m"], "params": p})
        out[arch_id] = dict(cell=cell, losses=losses, step_s=secs,
                            nodes=b.n_nodes, edges=int(b.edge_src.shape[0]))
        del p, o, b
    torch.save(saved, path)
    out["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shard_gnn_rank(p) -> dict:
    """(i) on one rank: each arch of SHARD_GNN_RUNS under `gnn_rules` on
    (data 2, model world / 2) (NCCL: (1, 1)), this rank's stripe of the
    whole batch (`launch.cells.stripe`), the params drawn from the
    parent's seed and whole: SHARD_GNN_STEPS steps (the first under the
    census: its collectives' bytes), the first again from the same state
    (the bits), the first step's loss, first moment and params against
    the parent's, and a control step with the node stripe of the next
    rank (its first moment must miss the gate)."""
    import torch.distributed as dist

    from repro_torch.dist import group as dist_group
    from repro_torch.dist.sharding import gnn_rules
    from repro_torch.launch.cells import gnn_train_step, stripe
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import collective_stats
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.optimizer import adamw_init

    t_rank = time.perf_counter()
    world, r = dist.get_world_size(), dist.get_rank()
    shape = (2, world // 2) if world > 1 else (1, 1)
    rules = gnn_rules(make_mesh(shape, ("data", "model")))
    ref = torch.load(p["ref_path"], mmap=True, weights_only=True)
    out = dict(mesh=shape, coords=rules.coords)
    for arch_id, cell in SHARD_GNN_RUNS:
        t_arch = time.perf_counter()
        cfg = shard_gnn_config(arch_id, cell)
        whole = shard_gnn_batch(arch_id, cfg, p["batches"][cell])
        mine = stripe(whole, rules)
        p0 = gnn_init(arch_id, cfg, seed=SHARD_GNN_SEED)

        def steps(b, n=SHARD_GNN_STEPS, record=False):
            q, o, losses, secs, first, wire = p0, adamw_init(p0), [], [], \
                None, None
            for i in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.ExitStack() as stack:
                    cen = stack.enter_context(dist_group.census()) \
                        if record and i == 0 else None
                    q, o, loss = gnn_train_step(arch_id, cfg, q, o, b,
                                                rules=rules)
                    torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(loss))
                if cen is not None:
                    wire = dict(records=len(cen.records),
                                out_bytes=sum(x[1] for x in cen.records),
                                wire_bytes=collective_stats(
                                    cen.records).total_wire_bytes)
                if i == 0:
                    first = (o["m"], q)
            return q, losses, secs, first, wire

        q1, losses, secs, (m1, p1), wire = steps(mine, record=True)
        _, losses2, _, (m2, p2), _ = steps(mine, n=1)   # the bits again
        m_ref = tree_map(lambda t: t.cuda(), ref[arch_id]["m"])
        p_ref = tree_map(lambda t: t.cuda(), ref[arch_id]["params"])
        off, flat = 0, True
        for got, want, g in zip(tree_leaves(p1), tree_leaves(p_ref),
                                tree_leaves(m_ref)):
            far = (got - want).abs() > SHARD_GNN_PARAM_TOL * want.abs().max()
            off += int(far.sum())
            flat = flat and bool((g[far].abs() <= SHARD_FLAT_TOL
                                  * g.abs().max()).all())
        res = dict(cell=cell, n_layers=getattr(cfg, "n_layers", None),
                   losses=losses, step_s=secs, wire=wire,
                   nodes_local=mine.n_nodes,
                   edges_local=int(mine.edge_src.shape[0]),
                   grad_gap=max(tree_gaps(m1, m_ref)),
                   param_gap=max(tree_gaps(p1, p_ref)), params_off=off,
                   params_off_flat=flat,
                   n_params=sum(t.numel() for t in tree_leaves(p1)),
                   repeat_equal=losses[:1] == losses2
                   and trees_equal(m1, m2) and trees_equal(p1, p2),
                   grads_equal=trees_equal(m1, m_ref),
                   params_equal=trees_equal(p1, p_ref))
        del q1, m1, p1, m2, p2, p_ref
        if world > 1:      # the control: the next rank's nodes, my edges
            other = stripe(whole, rules, (r + 1) % world)
            nodes = ["node_feat", "node_mask", "positions", "species",
                     "graph_ids"] + (["targets"] if whole.targets.dim() > 1
                                     else [])
            wrong = dataclasses.replace(mine, plans={}, **{
                f: getattr(other, f) for f in nodes
                if getattr(other, f) is not None})
            _, _, _, (m_ctl, _), _ = steps(wrong, n=1)
            res["control_grad_gap"] = max(tree_gaps(m_ctl, m_ref))
            del m_ctl
        res["seconds"] = time.perf_counter() - t_arch
        out[arch_id] = res
        del whole, mine, p0
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_rank
    return out


def shard_gnn_check(got, ref, need) -> dict:
    """(i)'s gates over every rank of each backend (module docstring)."""
    row = dict(tol_loss=SHARD_GNN_LOSS_TOL, tol_grad=SHARD_GNN_GRAD_TOL,
               tol_params=SHARD_GNN_PARAM_TOL, reference=ref)
    for arch_id, cell in SHARD_GNN_RUNS:
        want = ref[arch_id]["losses"]
        a = dict(cell=cell, one_process_step_s=ref[arch_id]["step_s"])
        for backend, ranks in got.items():
            rs = [rk["i"][arch_id] for rk in ranks]
            loss_gap = max(abs(x - w) / abs(w) for rk in rs
                           for x, w in zip(rk["losses"], want))
            b = dict(mesh=ranks[0]["i"]["mesh"], loss_gap=loss_gap,
                     grad_gap=max(x["grad_gap"] for x in rs),
                     param_gap=max(x["param_gap"] for x in rs),
                     params_off=sum(x["params_off"] for x in rs),
                     params_off_share=sum(x["params_off"] for x in rs)
                     / sum(x["n_params"] for x in rs),
                     params_off_flat=all(x["params_off_flat"] for x in rs),
                     repeat_equal=all(x["repeat_equal"] for x in rs),
                     step_s=[x["step_s"] for x in rs],
                     wire=rs[0]["wire"], seconds=[x["seconds"] for x in rs],
                     nodes_local=rs[0]["nodes_local"],
                     edges_local=rs[0]["edges_local"])
            tag = f"shard (i) {arch_id} {backend}"
            need(len({tuple(x["losses"]) for x in rs}) == 1,
                 f"{tag}: ranks return different losses")
            need(loss_gap <= SHARD_GNN_LOSS_TOL,
                 f"{tag}: loss {loss_gap} (relative) from one process")
            need(b["grad_gap"] <= SHARD_GNN_GRAD_TOL,
                 f"{tag}: the clipped gradient {b['grad_gap']} of max from "
                 "one process")
            need(b["params_off_flat"],
                 f"{tag}: {b['params_off']} params after one step further "
                 f"than {SHARD_GNN_PARAM_TOL} of max from one process, not "
                 f"all at a gradient within {SHARD_FLAT_TOL} of its leaf's "
                 "max of 0")
            need(b["repeat_equal"], f"{tag}: two runs differ")
            if backend == "nccl":
                b["equal"] = all(x["grads_equal"] and x["params_equal"]
                                 for x in rs) and loss_gap == 0.0
                need(b["equal"], f"{tag}: world size 1 differs from one "
                     "process")
            else:
                b["control_grad_gap"] = min(x["control_grad_gap"]
                                            for x in rs)
                need(b["control_grad_gap"] > SHARD_GNN_GRAD_TOL,
                     f"{tag}: the shifted-stripe control "
                     f"{b['control_grad_gap']} is inside the gate")
            a[backend] = b
        row[arch_id] = a
    return row


def shard_placements() -> dict:
    """(f) per-device parameter bytes of every LM config under
    `param_specs_lm`, on `repro`'s (16, 16) mesh and on one 8-card node
    (1, 8): bf16 weights, and the fp32 train state (masters and AdamW's
    two moments, 12 bytes a parameter), beside 80 GB."""
    from repro_torch.configs import REGISTRY
    from repro_torch.dist.sharding import param_specs_lm, spec_bytes
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.transformer import abstract_params

    rows = {}
    for arch_id, arch in sorted(REGISTRY.items()):
        if arch.family != "lm":
            continue
        cfg = arch.make_config()
        tree = abstract_params(cfg)
        row = dict(n_params=cfg.n_params(), bf16_bytes=2 * cfg.n_params())
        for name, (shape, axes) in SHARD_PLACEMENTS.items():
            mesh = MeshShape(shape, axes)
            specs = param_specs_lm(cfg, tree, mesh)
            w = spec_bytes(tree, specs, mesh, 2)
            row[name] = dict(bf16_bytes_per_device=w,
                             train_state_bytes_per_device=spec_bytes(
                                 tree, specs, mesh, 12),
                             bf16_fits=w <= SHARD_CARD_BYTES)
        rows[arch_id] = row
    return rows


def shard_kernel_checks() -> dict:
    """(g) K6 at mistral's local heads on a (1, 4) mesh (24 query heads
    over 2 KV heads: the prefill, and a decode step over a strided view of
    2 of a cache's 8 KV heads) and K5's vocab-parallel lookup (a quarter
    of the vocab's rows, foreign ids at weight 0), bf16, each against its
    plain version on the card, timed."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    g = torch.Generator(device="cuda").manual_seed(7)
    B, P, _ = SHARD_RUN
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf)

    rows = {}
    q, k, v = randn(B, P, 24, 128), randn(B, P, 2, 128), randn(B, P, 2, 128)
    cache_k, cache_v = randn(B, P + 16, 8, 128), randn(B, P + 16, 8, 128)
    qd = randn(B, 1, 24, 128)
    cases = {
        "prefill_24_2": ((q, k, v), dict(causal=True, q_offset=0, kv_len=P)),
        "decode_24_2_strided": ((qd, cache_k[:, :, 2:4], cache_v[:, :, 2:4]),
                                dict(causal=True, q_offset=P, kv_len=P + 1)),
    }
    for name, (args, kw) in cases.items():
        got = flash_attention(*args, **kw)
        want = flash_attention_plain(*args, **kw)
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        check(err <= FLASH_TOL[bf], f"shard (g) K6 {name}: {err} > "
              f"{FLASH_TOL[bf]} of max|out| against the plain version")
        rows[name] = dict(max_rel_err=err, tol=FLASH_TOL[bf],
                          kernel_ms=time_ms(lambda: flash_attention(
                              *args, **kw), reps=20, rounds=5),
                          ref_ms=time_ms(lambda: flash_attention_plain(
                              *args, **kw), reps=5, rounds=3, warmup=2))
    V, d = 32768, 12288
    rows_local = V // 4
    table = randn(rows_local, d)
    tok = torch.randint(0, V, (B * P,), generator=g, device="cuda")
    local = tok - 1 * rows_local                   # the rank at model 1
    own = (local >= 0) & (local < rows_local)
    ids = torch.where(own, local, 0).to(torch.int32)
    seg = torch.arange(B * P, dtype=torch.int32, device="cuda")
    w = own.to(bf)
    got = embedding_bag(table, ids, seg, B * P, weights=w)
    want = embedding_bag_ref(table, ids, seg, B * P, weights=w)
    rows["k5_vocab_slice"] = dict(
        rows=rows_local, width=d, bags=B * P, own_share=float(own.float()
                                                              .mean()),
        bit_equal=bool(torch.equal(got, want)),
        kernel_ms=time_ms(lambda: embedding_bag(table, ids, seg, B * P,
                                                weights=w), reps=20, rounds=5),
        ref_ms=time_ms(lambda: embedding_bag_ref(table, ids, seg, B * P,
                                                 weights=w), reps=5, rounds=3,
                       warmup=2))
    check(rows["k5_vocab_slice"]["bit_equal"], "shard (g) K5: the masked "
          "vocab-slice lookup differs from the plain version")
    return rows


def shard_train_reference(path, batch) -> dict:
    """(c)'s one-process step (`NO_SHARD`, ``impl="pjit"``, the ranks'
    seed): its params and first moments (0.1 × the clipped gradient)
    saved at ``path`` for the ranks."""
    from repro_torch.launch.cells import lm_train_step
    from repro_torch.models import transformer as tt
    from repro_torch.train.optimizer import adamw_init

    cfg = train_config(impl="pjit")
    params = tt.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(SHARD_SEED + 2))
    b = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p1, o1, loss = lm_train_step(cfg, params, adamw_init(params), b)
    torch.cuda.synchronize()
    row = dict(loss=float(loss), step_s=time.perf_counter() - t0,
               peak_bytes=torch.cuda.max_memory_allocated(),
               n_params=cfg.n_params())
    torch.save({"params": p1, "m": o1["m"]}, path)
    del params, p1, o1
    gc.collect()
    torch.cuda.empty_cache()
    return row


def shard_wire_meta(prompts) -> dict:
    """(a)'s greedy run (prefill and SHARD_RUN[2] steps) and (c)'s train
    step on rank 0's view of their meshes, on ``meta`` tensors (the dry
    run's `AbstractGroup` collectives; host only): the census's wire bytes
    a rank and its collectives, under `lm_rules` with sequence parallelism
    (what the ranks run) and without it (PR 30's layout)."""
    from repro_torch.dist import group as dist_group
    from repro_torch.dist.sharding import lm_rules
    from repro_torch.launch.cells import lm_train_cell
    from repro_torch.launch.mesh import MeshShape, RankView
    from repro_torch.launch.roofline import collective_stats
    from repro_torch.models import transformer as tt

    B, P, steps = SHARD_RUN
    names = ("data", "model")
    cfg_a = shard_config("mistral-large-123b", SHARD_LAYERS)
    cfg_c = train_config(impl="shardmap")
    out = {"a": {}, "c": {}}
    for name, sp in (("sp", True), ("no_sp", False)):
        rules = lm_rules(RankView(MeshShape((1, SHARD_WORLD), names), 0),
                         seq_shard=sp)
        model = tt.Transformer(cfg_a, tt.abstract_params(cfg_a), rules)
        tok = torch.from_numpy(prompts["mistral-large-123b"]).to("meta")
        with dist_group.census() as cen, torch.inference_mode():
            cache = tt.init_cache(cfg_a, B, P + steps, "meta", rules=rules)
            logits, cache = tt.prefill(model, tok, cache)
            for i in range(steps):
                logits, cache = tt.decode_step(
                    model, cache, logits[:, -1].argmax(-1)[:, None], P + i)
        out["a"][name] = dict(
            wire_bytes=collective_stats(cen.records).total_wire_bytes,
            collectives=len(cen.records))
        view = RankView(MeshShape((2, SHARD_WORLD // 2), names), 0)
        cell = lm_train_cell(cfg_c, *SHARD_TRAIN_BATCH, view, seq_shard=sp)
        with dist_group.census() as cen:
            cell.fn(*cell.abstract_args)
        out["c"][name] = dict(
            wire_bytes=collective_stats(cen.records).total_wire_bytes,
            collectives=len(cen.records))
    return out


def shard_layer_reference():
    """(b)'s fp32 MoE layer on one process: the rank's weights (same seed),
    the first of a seeded series of inputs (1, 512, d) whose every token's
    top-k router-logit margin clears MOE_LAYER_MARGIN, and `moe_apply`'s
    y with no drops and at the published capacity factor."""
    from repro_torch.models import moe as mt

    cfg = shard_config("deepseek-moe-16b", 1, dtype=torch.float32,
                       impl="shardmap", capacity_factor=8.0)
    p = mt.init_moe(cfg.moe, cfg.d_model, torch.Generator(device="cuda")
                    .manual_seed(SHARD_SEED + 1), torch.float32)
    for seed in range(16):
        x = torch.from_numpy(np.random.default_rng(100 + seed).normal(
            size=(1, SHARD_MOE_TOKENS, cfg.d_model)).astype(np.float32))
        srt = (x[0].cuda() @ p["router"]).sort(-1, descending=True).values
        k = cfg.moe.top_k
        margin = float((srt[:, k - 1] - srt[:, k]).min())
        if margin > MOE_LAYER_MARGIN:
            break
    check(margin > MOE_LAYER_MARGIN, f"shard (b) layer: no input of the "
          f"series clears the top-k margin ({margin})")
    published = shard_config("deepseek-moe-16b", 1).moe
    with torch.inference_mode():
        y = mt.moe_apply(cfg.moe, p, x.cuda(), torch.float32).cpu().numpy()
        with count_drops() as drops:
            y_pub = mt.moe_apply(published, p, x.cuda(),
                                 torch.float32).cpu().numpy()
    del p
    gc.collect()
    torch.cuda.empty_cache()
    return x.numpy(), (y, y_pub), dict(
        input_seed=100 + seed, top_k_margin=margin,
        published_capacity_factor=published.capacity_factor,
        published_capacity=sorted(drops[2]),
        published_dropped_share=drops[0] / drops[1])


def shard_recsys_inputs() -> dict:
    """(h)'s users, candidates and train batch (NumPy, from seeds):
    serve_p99's 512 users, retrieval_cand's user and 10^6 candidates (a
    permutation of the items), SHARD_RECSYS_USERS training users."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import recsys_batches

    arch = get_arch("sasrec")
    cfg, shapes = arch.make_config(), arch.shapes

    def users(B, seed):
        return {k: v.numpy() for k, v in next(recsys_batches(
            B, cfg.seq_len, cfg.n_items, seed=seed)).items()}

    B = shapes["serve_p99"]["batch"]
    n_cand = shapes["retrieval_cand"]["n_candidates"]
    return dict(seq=users(B, 0)["item_seq"],
                seq1=users(shapes["retrieval_cand"]["batch"], 2)["item_seq"],
                cand=(np.random.default_rng(1).permutation(n_cand)
                      + 1).astype(np.int32),
                train=users(SHARD_RECSYS_USERS, 4), user_chunk=min(B, 8192))


def bag_slice_row(table_full, seq, n_model, rank) -> dict:
    """K5 at (h)'s vocab-parallel lookup on one model rank: serve_p99's
    sequence lookup (512 × 50 ids at √d) over rank ``rank``'s rows of
    ``n_model``, foreign ids at row 0 and weight 0, against its plain
    version (bit for bit), timed beside its bound and one
    `F.embedding_bag` call on the same slice."""
    from repro_torch.kernels.embedding_bag import cuda as eb_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    rows = table_full.shape[0] // n_model
    table = table_full[rank * rows:(rank + 1) * rows]
    local = seq.reshape(-1).long() - rank * rows
    own = (local >= 0) & (local < rows)
    idx = torch.where(own, local, 0).to(torch.int32)
    n, d = idx.numel(), table.shape[1]
    seg = torch.arange(n, dtype=torch.int32, device=idx.device)
    w = own.float() * float(np.sqrt(d))

    def kernel():
        return eb_cuda.embedding_bag_cuda(table, idx, seg, w, n)

    def plain():
        return embedding_bag_ref(table, idx, seg, n, weights=w)

    lib = bag_library(table, idx, seg, w, n)
    got, want, lib_out = kernel(), plain(), lib()
    check(torch.equal(got, want), "shard (h) K5: the vocab-slice lookup "
          "differs from the plain version")
    distinct = int(torch.unique(idx).numel())
    nbytes = n * (4 + 4 + 4) + distinct * d * 4 + n * d * 4
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 2 * n * d / FP32_FLOPS_PER_S * 1e3
    dev_ms, traced, _ = profiled_ms(kernel, "embedding_bag_kernel")
    kernel_ms = time_auto(kernel)
    return dict(rows_local=rows, rank=rank, n_model=n_model, d=d, bags=n,
                own_share=float(own.float().mean()), rows_distinct=distinct,
                max_abs_err=float((got - want).abs().max()),
                library_max_abs_err=float((lib_out - want).abs().max()),
                kernel_ms=kernel_ms,
                dev_ms=dev_ms if dev_ms is not None else kernel_ms,
                dev_ms_by="profiler" if dev_ms is not None else "cuda_events",
                profiler_cuda_events=traced, ref_ms=time_auto(plain),
                library_ms=time_auto(lib), bytes=nbytes,
                bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                else "operations")


def shard_recsys_reference(path, inp) -> dict:
    """(h)'s one-process runs on the card (`NO_SHARD`, the ranks' seed and
    inputs): user states, the streamed top-100 and the full score matrix's
    top-101 values, the retrieval scores, the losses and params of
    SHARD_RECSYS_STEPS train steps (saved at ``path`` for the ranks), and
    K5 at model rank 1's slice of two."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import (recsys_retrieval,
                                          recsys_serve_topk,
                                          recsys_train_step)
    from repro_torch.models.recsys import SASRec, init_sasrec
    from repro_torch.train.optimizer import adamw_init

    t0 = time.perf_counter()
    cfg = get_arch("sasrec").make_config()
    params = init_sasrec(cfg, torch.Generator(device="cuda").manual_seed(
        SHARD_RECSYS_SEED))
    model = SASRec(cfg, params)
    seq = torch.from_numpy(inp["seq"]).cuda()
    with torch.inference_mode():
        states = model.user_state(seq)
        vals, ids = recsys_serve_topk(cfg, model, seq, k=RECSYS_K,
                                      user_chunk=inp["user_chunk"])
        want_v, _ = torch.topk(states[:, -1] @ model.item_embed.T,
                               RECSYS_K + 1, dim=1)
        scores = recsys_retrieval(cfg, model, torch.from_numpy(
            inp["seq1"]).cuda(), torch.from_numpy(inp["cand"]).cuda())
    batch = {k: torch.from_numpy(v).cuda() for k, v in inp["train"].items()}
    q, o, losses = params, adamw_init(params), []
    for _ in range(SHARD_RECSYS_STEPS):
        q, o, loss = recsys_train_step(cfg, q, o, batch)
        losses.append(float(loss))
    torch.save(q, path)
    out = dict(states=states.cpu().numpy(), vals=vals.cpu().numpy(),
               ids=ids.cpu().numpy(), want_v=want_v.cpu().numpy(),
               scores=scores.cpu().numpy(), losses=losses)
    out["k5_slice"] = bag_slice_row(model.item_embed.detach(), seq, 2, 1)
    out["seconds"] = time.perf_counter() - t0
    del model, params, q, o, states, want_v, scores
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shard_recsys_check(got, ref, need) -> dict:
    """(h)'s gates, every rank of each backend against the one-process
    runs: states (of max) and top-100 values within SHARD_RECSYS_TOL, ids
    equal where the full top-101's scores are more than that apart,
    retrieval scores within it (of max), both steps' losses within it
    (relative), params within SHARD_RECSYS_PARAM_TOL of each leaf's max,
    the two runs the same bits, K5's forward and backward launches; the
    control (rows shifted by one) must miss the states gate."""
    tol, k = SHARD_RECSYS_TOL, RECSYS_K
    row = {}
    for backend, ranks in got.items():
        hs = [rk["h"] for rk in ranks]
        shape = hs[0]["mesh"]
        nb = ref["states"].shape[0] // shape[0]
        nc = ref["scores"].shape[1] // shape[1]
        r = dict(mesh=shape, states=[], control=[], values=[], ids_equal=[],
                 scores=[], loss=[], params=[], repeat_equal=[],
                 k5_forward=[], k5_train=[], k5_train_backward=[],
                 serve_ms=[], retrieval_ms=[], train_step_ms=[], rank_s=[])
        for h in hs:
            d, m = h["coords"]["data"], h["coords"].get("model", 0)
            rows = slice(d * nb, (d + 1) * nb)
            want = ref["states"][rows]
            scale = float(np.abs(want).max())
            r["states"].append(float(np.abs(h["states"] - want).max())
                               / scale)
            r["control"].append(float(np.abs(h["control_states"]
                                             - want).max()) / scale)
            vals, ids = h["topk"]
            r["values"].append(float(np.abs(vals - ref["vals"][rows]).max()))
            step = np.abs(np.diff(ref["want_v"][rows], axis=1))   # (nb, k)
            apart = step > tol
            apart[:, 1:] &= step[:, :k - 1] > tol
            r["ids_equal"].append(bool(
                (ids[apart] == ref["ids"][rows][apart]).all()))
            sw = ref["scores"][:, m * nc:(m + 1) * nc]
            r["scores"].append(float(np.abs(h["scores"] - sw).max()
                                     / np.abs(ref["scores"]).max()))
            r["loss"].append(max(abs(a - b) / abs(b) for a, b in zip(
                [h["loss0"]] + h["losses"], ref["losses"][:1]
                + ref["losses"])))
            r["params"].append(h["param_gap"])
            r["repeat_equal"].append(h["repeat_equal"])
            for key in ("k5_forward", "k5_train", "k5_train_backward"):
                r[key].append(h[key])
            r["serve_ms"].append(h["serve_s"] * 1e3)
            r["retrieval_ms"].append(h["retrieval_s"] * 1e3)
            r["train_step_ms"].append(h["train_s"] / SHARD_RECSYS_STEPS
                                      * 1e3)
            r["rank_s"].append(h["seconds"])
        r["apart_share"] = float(apart.mean())
        for key, lim in (("states", tol), ("values", tol), ("scores", tol),
                         ("loss", tol), ("params", SHARD_RECSYS_PARAM_TOL)):
            need(max(r[key]) <= lim, f"shard (h) {backend}: {key} "
                 f"{max(r[key])} > {lim} from the one-process run")
        need(min(r["control"]) > tol, f"shard (h) {backend}: the shifted "
             f"rows' control reads {min(r['control'])}, inside {tol}")
        need(all(r["ids_equal"]), f"shard (h) {backend}: top-{k} ids differ "
             "where scores are apart")
        need(all(r["repeat_equal"]), f"shard (h) {backend}: two runs of "
             "the steps differ")
        need(min(r["k5_forward"]) > 0 and min(r["k5_train_backward"]) > 0,
             f"shard (h) {backend}: K5 forward {r['k5_forward']}, backward "
             f"{r['k5_train_backward']}")
        row[backend] = r
    return row


def l2_gap(got, want) -> float:
    """‖got − want‖₂ / ‖want‖₂ over every logit, in fp64."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm())


def shard_serve_reference(arch, prompts, gloo_tokens):
    """(a), (b): the one-process model (same seed, `NO_SHARD`): its own
    greedy run, and teacher-forced runs on the gloo ranks' tokens, with
    K6 and with the control attention; for a MoE arch, the prompts'
    prefill at the published capacity factor (the last position's logits)
    with K6 and with the control."""
    from repro_torch.models import transformer as tt

    cfg = shard_config(arch, SHARD_LAYERS)
    if cfg.moe is not None:
        cfg = shard_config(arch, SHARD_LAYERS, impl="shardmap",
                           capacity_factor=no_drop(cfg))
    model = tt.build_model(cfg, torch.Generator(device="cuda")
                           .manual_seed(SHARD_SEED))
    weight_bytes = sum(w.numel() * w.element_size()
                       for w in model.parameters())
    _, steps = gloo_tokens.shape
    pr = torch.from_numpy(prompts).cuda()
    own = shard_greedy(model, pr, steps)
    forced = torch.from_numpy(gloo_tokens).cuda()
    tf = shard_greedy(model, pr, steps, forced)
    with coarse_attention(SHARD_CONTROL_BITS):
        control = shard_greedy(model, pr, steps, forced)
    out = dict(own=own, tf=tf, control=control, weight_bytes=weight_bytes)
    if cfg.moe is not None:
        model.cfg = shard_config(arch, SHARD_LAYERS)     # published: pjit
        with torch.inference_mode():
            out["published"] = tt.prefill(model, pr)[0][:, -1].float().cpu()
            with coarse_attention(SHARD_CONTROL_BITS):
                out["published_control"] = tt.prefill(model, pr)[0][
                    :, -1].float().cpu()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shard_serve_check(key, arch, gloo, nccl, ref, need) -> dict:
    """(a), (b): the gloo ranks' greedy tokens and logits against the
    one-process run teacher-forced on them (tokens equal but where the
    one-process top two logits lie closer than that row's gap; ‖Δ‖₂ of
    every logit row ≤ the limit < the control's); every gloo rank's logits
    the same bits; the NCCL rank (world size 1) = the one-process greedy
    run bit for bit.  ``need(cond, what)`` records a failed check."""
    limit = SHARD_GAP_LIMIT[arch]
    g0 = gloo[0][key]
    for i, rk in enumerate(gloo):
        need(np.array_equal(rk[key]["tokens"], g0["tokens"])
              and np.array_equal(rk[key]["logits"], g0["logits"]),
              f"shard ({key}) gloo rank {i}: tokens or logits differ from "
              "rank 0's")
    tf_toks, tf_rows = ref["tf"]
    got = torch.from_numpy(g0["logits"])
    # the tokens: where the ranks' greedy token differs from the
    # one-process argmax on the same prefix, both logits must lie within
    # that row's gap of each other (a near tie)
    want_arg = tf_rows.argmax(-1)
    got_arg = got.argmax(-1)
    flips = (want_arg != got_arg)
    row_gap = (got - tf_rows).abs().amax(-1)
    tie = tf_rows.gather(-1, want_arg[..., None])[..., 0] \
        - tf_rows.gather(-1, got_arg[..., None])[..., 0]
    near = bool((tie[flips] <= 2 * row_gap[flips]).all())
    res = dict(gloo_world=len(gloo), limit=limit,
               gap_l2=l2_gap(got, tf_rows),
               gap_max=logit_gap(got, tf_rows),
               control_gap_l2=l2_gap(ref["control"][1], tf_rows),
               control_bits=SHARD_CONTROL_BITS,
               token_flips=int(flips.sum()), flips_near_ties=near,
               tokens_equal_own_greedy=bool(np.array_equal(
                   g0["tokens"], ref["own"][0].numpy())),
               sample_tokens=g0["tokens"][0, :8].tolist(),
               weight_bytes_per_rank=[rk[key]["weight_bytes"]
                                      for rk in gloo],
               weight_bytes_one_process=ref["weight_bytes"],
               peak_bytes_per_rank=[rk[key]["peak_bytes"] for rk in gloo],
               build_s=[rk[key]["build_s"] for rk in gloo],
               run_s=[rk[key]["run_s"] for rk in gloo],
               k6_per_rank=[rk[key]["k6"] for rk in gloo],
               k5_per_rank=[rk[key]["k5"] for rk in gloo])
    need(res["gap_l2"] <= limit < res["control_gap_l2"],
          f"shard ({key}) {arch}: logit gap {res['gap_l2']} (limit {limit}) "
          f"against the control's {res['control_gap_l2']}")
    need(near, f"shard ({key}) {arch}: a greedy token differs from the "
          "one-process argmax away from a near tie")
    n = nccl[0][key]
    own_toks, own_rows = ref["own"]
    res["nccl_bit_identical"] = bool(
        np.array_equal(n["tokens"], own_toks.numpy())
        and np.array_equal(n["logits"], own_rows.numpy()))
    need(res["nccl_bit_identical"], f"shard ({key}) {arch}: the NCCL rank "
          "(world size 1) differs from the one-process run")
    if key == "b":
        # the published capacity factor: expert parallelism's capacity per
        # rank (each rank its slice of the sequence) beside the pjit
        # dispatch's global capacity (every rank the global entries)
        res.update(published_capacity_factor=g0["published"],
                   no_drop_capacity_factor=no_drop(shard_config(arch, 1)))
        for impl in ("shardmap", "pjit"):
            runs = [rk[key][impl] for rk in gloo]
            if impl == "shardmap":
                share = sum(r["dropped"] for r in runs) / sum(
                    r["entries"] for r in runs)
            else:
                share = runs[0]["dropped"] / runs[0]["entries"]
            res[impl] = dict(dropped_share=share,
                             capacity=sorted({c for r in runs
                                              for c in r["capacity"]}),
                             bit_identical=all(r["bit_identical"]
                                               for r in runs),
                             seconds=[r["seconds"] for r in runs])
            need(res[impl]["bit_identical"], f"shard (b) {arch} {impl}: two "
                 "prefills at the published capacity factor differ")
        pj = res["pjit"]
        want = ref["published"]
        pj.update(gap_l2=l2_gap(g0["pjit"]["logits"], want),
                  gap_max=logit_gap(torch.from_numpy(g0["pjit"]["logits"]),
                                    want),
                  control_gap_l2=l2_gap(ref["published_control"], want),
                  limit=limit, ranks_equal=all(
                      np.array_equal(rk[key]["pjit"]["logits"],
                                     g0["pjit"]["logits"]) for rk in gloo),
                  nccl_bit_identical=bool(np.array_equal(
                      n["pjit"]["logits"], want.numpy())))
        need(pj["gap_l2"] <= limit < pj["control_gap_l2"],
             f"shard (b) {arch} pjit prefill: logit gap {pj['gap_l2']} "
             f"(limit {limit}) against the control's {pj['control_gap_l2']}")
        need(pj["ranks_equal"], f"shard (b) {arch} pjit: the gloo ranks' "
             "logits differ")
        need(pj["nccl_bit_identical"], f"shard (b) {arch} pjit: the NCCL "
             "rank (world size 1) differs from the one-process prefill")
    return res


def phase_shard():
    """Phase 14 (see the module docstring).  Every check runs before the
    phase fails.  Returns the K6 and K5 launches of (a)–(c) over every
    rank."""
    import tempfile

    t_phase = time.perf_counter()
    gc.collect()                    # the ranks share the card's memory
    torch.cuda.empty_cache()
    fails = []

    def need(cond, what):
        if not cond:
            fails.append(what)

    row = {"placements": shard_placements()}
    t0 = time.perf_counter()
    row["kernels"] = shard_kernel_checks()
    row["kernels_s"] = time.perf_counter() - t0
    B, P, _ = SHARD_RUN
    rng = np.random.default_rng(5)
    prompts = {arch: rng.integers(0, shard_config(arch, 1).vocab, (B, P))
               for arch in ("mistral-large-123b", "deepseek-moe-16b")}
    tb, ts = SHARD_TRAIN_BATCH
    toks = rng.integers(0, shard_config("deepseek-moe-16b", 1).vocab,
                        (tb, ts + 1))
    train = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    recsys = shard_recsys_inputs()
    gnn_batches, gnn_info = gnn_cell_batches(
        SHARD_GNN_SEED, cells=("full_graph_sm", "molecule"))
    tmp = tempfile.TemporaryDirectory(prefix="shard_")
    try:
        t0 = time.perf_counter()
        ref_h = shard_recsys_reference(f"{tmp.name}/ref_recsys.pt", recsys)
        row["h_reference_s"] = time.perf_counter() - t0
        recsys["ref_path"] = f"{tmp.name}/ref_recsys.pt"
        ref_i = shard_gnn_reference(f"{tmp.name}/ref_gnn.pt", gnn_batches)
        gnn = dict(batches=gnn_batches, ref_path=f"{tmp.name}/ref_gnn.pt")
        ref_path = f"{tmp.name}/ref_step.pt"
        t0 = time.perf_counter()
        row["c_reference"] = shard_train_reference(ref_path, train)
        row["c_reference"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        layer_x, layer_y, layer_row = shard_layer_reference()
        layer_row["reference_s"] = time.perf_counter() - t0
        payload = dict(shard=dict(prompts=prompts, train=train,
                                  ref_path=ref_path, layer_x=layer_x,
                                  ckpt_dir=f"{tmp.name}/ckpt",
                                  recsys=recsys, gnn=gnn))
        got = {}
        with contextlib.ExitStack() as alive:
            t0 = time.perf_counter()
            gloo = start_ranks(payload, SHARD_WORLD, "gloo")
            alive.callback(stop_ranks, gloo)
            got["gloo"] = [rk["shard"] for rk in join_ranks(gloo)]
            row["gloo_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        refs = {arch: shard_serve_reference(
            arch, prompts[arch], got["gloo"][0][key]["tokens"])
            for key, arch in (("a", "mistral-large-123b"),
                              ("b", "deepseek-moe-16b"))}
        row["serve_reference_s"] = time.perf_counter() - t0
        with contextlib.ExitStack() as alive:
            t0 = time.perf_counter()
            nccl = start_ranks(payload, 1, "nccl")
            alive.callback(stop_ranks, nccl)
            got["nccl"] = [rk["shard"] for rk in join_ranks(nccl)]
            row["nccl_s"] = time.perf_counter() - t0
    finally:
        tmp.cleanup()
    gloo, nccl = got["gloo"], got["nccl"]
    for key, arch in (("a", "mistral-large-123b"), ("b", "deepseek-moe-16b")):
        row[key] = shard_serve_check(key, arch, gloo, nccl, refs[arch],
                                     need)
        layers = SHARD_LAYERS
        for rk in gloo + nccl:
            need(rk[key]["k6"] == layers * (1 + SHARD_RUN[2]),
                  f"shard ({key}): {rk[key]['k6']} K6 launches, not "
                  f"{layers} x {1 + SHARD_RUN[2]}")
        for rk in gloo:
            need(rk[key]["k5"] == 1 + SHARD_RUN[2],
                  f"shard ({key}): {rk[key]['k5']} K5 launches on a gloo "
                  f"rank, not {1 + SHARD_RUN[2]}")
    # (b) the fp32 layer, every rank's y against moe_apply's: expert
    # parallelism with no drops, the pjit dispatch at the published capacity
    for backend, ranks in got.items():
        for impl, field, want in (("ep", "y", layer_y[0]),
                                  ("pjit", "pjit_y", layer_y[1])):
            gaps = [float(np.abs(rk["layer"][field] - want).max()
                          / np.abs(want).max()) for rk in ranks]
            need(max(gaps) <= SHARD_MOE_TOL, f"shard (b) layer {backend} "
                 f"{impl}: {max(gaps)} of max|y| from moe_apply > "
                 f"{SHARD_MOE_TOL}")
            layer_row[f"{backend}_{impl}_gap"] = max(gaps)
        layer_row[f"{backend}_pjit_dropped_share"] = (
            ranks[0]["layer"]["pjit_dropped"]
            / ranks[0]["layer"]["pjit_entries"])
    row["b_layer"] = dict(layer_row, tokens=SHARD_MOE_TOKENS,
                          tol=SHARD_MOE_TOL)
    # (a), (c): the bytes on the wire under sequence parallelism, measured
    # by the ranks' census, beside the dry run's census of the same step on
    # rank 0's view with and without it (PR 30's layout)
    wire = shard_wire_meta(prompts)
    for key in ("a", "c"):
        runs = [rk[key] for rk in gloo]
        got_w = runs[0]["wire_bytes"]
        wire[key].update(gloo_wire_bytes=got_w,
                         gloo_collectives=runs[0]["collectives"])
        need(all(r["wire_bytes"] == got_w for r in runs)
             and got_w == wire[key]["sp"]["wire_bytes"],
             f"shard ({key}): the ranks' wire bytes "
             f"{[r['wire_bytes'] for r in runs]} against the dry run's "
             f"{wire[key]['sp']['wire_bytes']}")
    row["wire"] = wire
    # (c) the train step
    ref_c = row["c_reference"]
    c = dict(tol_loss=SHARD_LOSS_TOL, tol_params=SHARD_PARAM_TOL,
             tol_flat=SHARD_FLAT_TOL)
    for backend, ranks in got.items():
        cs = [rk["c"] for rk in ranks]
        c[backend] = dict(
            mesh=cs[0]["mesh"], loss=cs[0]["loss"],
            rank_s=[rk["a_to_c_s"] for rk in ranks],
            loss_gap=abs(cs[0]["loss"] - ref_c["loss"]),
            param_gap=max(x["param_gap"] for x in cs),
            grad_gap=max(x["grad_gap"] for x in cs),
            params_off=sum(x["params_off"] for x in cs),
            params_off_share=sum(x["params_off"] for x in cs)
            / sum(x["n_local"] for x in cs),
            params_off_flat=all(x["params_off_flat"] for x in cs),
            repeat_equal=all(x["repeat_equal"] for x in cs),
            params_equal=all(x["params_equal"] for x in cs),
            step_s=[x["step_s"] for x in cs],
            peak_bytes=[x["peak_bytes"] for x in cs],
            k6=[x["k6"] for x in cs], k5=[x["k5"] for x in cs],
            k6_backward=[x["k6_backward"] for x in cs])
        cb = c[backend]
        need(len({x["loss"] for x in cs}) == 1, f"shard (c) {backend}: "
              "ranks return different losses")
        need(cb["loss_gap"] <= SHARD_LOSS_TOL, f"shard (c) {backend}: "
              f"loss {cb['loss']} vs one-process {ref_c['loss']}")
        need(cb["grad_gap"] <= SHARD_PARAM_TOL, f"shard (c) {backend}: "
             f"the clipped gradient {cb['grad_gap']} of max from the "
             "one-process step's")
        need(cb["params_off_flat"], f"shard (c) {backend}: "
             f"{cb['params_off']} params further than {SHARD_PARAM_TOL} of "
             "max from the one-process step's, not all at a gradient "
             f"within {SHARD_FLAT_TOL} of its leaf's max of 0")
        need(cb["repeat_equal"], f"shard (c) {backend}: two steps from "
              "one state differ")
        need(min(cb["k6"]) > 0 and min(cb["k5"]) > 0
             and min(cb["k6_backward"]) > 0,
             f"shard (c) {backend}: K6 {cb['k6']}, K5 {cb['k5']}, K6's "
             f"backward {cb['k6_backward']}")
    need(c["nccl"]["params_equal"] and c["nccl"]["loss_gap"] == 0.0,
          "shard (c) NCCL rank (world size 1): differs from the one-process "
          "step")
    row["c"] = c
    # (e) reshard
    e = [rk["e"] for rk in gloo]
    need(all(x.get("bit_identical", True) for x in e)
          and all("bit_identical" in x for x in e[:2]),
          "shard (e): the tree restored onto 2 ranks differs")
    row["e"] = dict(e[0], seconds=[x["seconds"] for x in e])
    # (h) SASRec across ranks
    from repro_torch.configs import get_arch

    train_users = get_arch("sasrec").shapes["train_batch"]["batch"]
    row["h"] = dict(shard_recsys_check(got, ref_h, need),
                    k5_slice=ref_h["k5_slice"],
                    reference_s=ref_h["seconds"],
                    tol=SHARD_RECSYS_TOL, param_tol=SHARD_RECSYS_PARAM_TOL,
                    cut=f"train_batch users {train_users} -> "
                        f"{SHARD_RECSYS_USERS}: the gloo wire runs through "
                        "the host")
    # (i) the GNNs across ranks
    i_row = shard_gnn_check(got, ref_i, need)
    i_row.update(host=gnn_info, seconds=ref_i["seconds"]
                 + max(rk["i"]["seconds"] for rk in gloo)
                 + nccl[0]["i"]["seconds"], limit_s=SHARD_GNN_SECONDS)
    need(i_row["seconds"] <= SHARD_GNN_SECONDS,
         f"shard (i): {i_row['seconds']:.2f} s > {SHARD_GNN_SECONDS}")
    row["i"] = i_row
    k6 = sum(rk["k6"] for rk in gloo + nccl)
    k6b = sum(rk["k6_backward"] for rk in gloo + nccl)
    k5 = sum(rk["k5"] + rk["h"]["k5_forward"] + rk["h"]["k5_train"]
             for rk in gloo + nccl)
    row.update(k6_launches=k6, k6_backward_launches=k6b, k5_launches=k5,
               failures=fails, seconds=time.perf_counter() - t_phase)
    emit("shard", **row)
    check(not fails, "; ".join(fails))
    return k6, k6b, k5


# phase 15, launch: the dry run (host) and its calibration on the card
LAUNCH_PROCS = 8               # host processes for the dry run's cells
LAUNCH_FLOP_GATE = 0.01        # |real FLOPs / dry-run FLOPs - 1| at most
LAUNCH_MEM_GATE = (0.9, 1.2)   # real step peak / dry-run peak inside
LAUNCH_TIME_GATE = (0.4, 1.0)  # roofline bound / measured step s inside


def launch_calibrate(job) -> dict:
    """Host: the dry run of phase ``train``'s step (tinyllama, TRAIN_BATCH
    × TRAIN_SEQ in TRAIN_MICRO microbatches) on the card's one-device
    mesh.  ``job`` = (control, part): part ``"exec"`` is the exec pass at
    full depth (the peak), ``"profile"`` the FLOPs and bytes by layer
    differencing, as the dry run counts a deep model, and the depth-2
    census alone (``depth2_*``: the differencing left out).  With
    ``control``, K6 is counted as its plain version (the full S × S
    scores; under autograd at bf16 and D >= 64, the plain output and
    logsumexp) — a dry run that must miss the gates; the kernel's dispatch
    is put back after it, since the worker goes on to other cells."""
    from repro_torch.kernels.flash_attention import ops, ref

    control, part = job
    kernel, kernel_lse = ops._forward, ops._forward_lse
    if control:
        def plain(q, k, v, causal, q_offset, kv_len, window):
            return ref.flash_attention_plain(q, k, v, causal=causal,
                                             q_offset=q_offset,
                                             kv_len=kv_len, window=window)

        def plain_lse(q, k, v, causal, q_offset, kv_len, window):
            kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
                      window=window)
            return (ref.flash_attention_plain(q, k, v, **kw),
                    ref.flash_attention_lse2(q, k, v, **kw))
        ops._forward, ops._forward_lse = plain, plain_lse
    try:
        return _launch_calibrate(part)
    finally:   # the worker goes on to other cells
        ops._forward, ops._forward_lse = kernel, kernel_lse


def _launch_calibrate(part: str) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import lm_train_cell
    from repro_torch.launch.mesh import MeshShape

    cfg = get_arch("tinyllama-1.1b").make_config()
    mesh = MeshShape((1, 1), ("data", "model"))

    def make(n):
        c = cfg if n is None else dataclasses.replace(cfg, n_layers=n)
        return lm_train_cell(c, TRAIN_BATCH, TRAIN_SEQ, mesh,
                             microbatch=TRAIN_MICRO)

    t0 = time.perf_counter()
    if part == "exec":
        out = dryrun.exec_pass(make(None))
    else:
        qs = {n: dryrun.profile_census(make(n), mesh) for n in (2, 4)}
        census = dryrun.layer_diff(qs, cfg.n_layers)
        out = dict(flops=census["flops"], bytes=census["bytes"],
                   op_s=census["op_s"],
                   bound_s=dryrun.step_bound(census["op_s"],
                                             census["collective_s"]),
                   depth2_flops=qs[2]["flops"], depth2_bytes=qs[2]["bytes"],
                   depth2_op_s=qs[2]["op_s"],
                   depth2_bound_s=dryrun.step_bound(qs[2]["op_s"],
                                                    qs[2]["collective_s"]))
    return dict(out, **{f"{part}_s": time.perf_counter() - t0})


def phase_launch(smi: str, real: dict):
    """The dry run, on the host after every phase on the card, in
    LAUNCH_PROCS spawned processes.  (a) Every runnable cell of
    ``all_cells()`` on both production meshes: one line a cell; every
    cell must run (70 ``ok``: LM, recsys and GNN; MoE as its published
    config says, ``impl="pjit"``).
    (b) Phase ``train``'s step against its dry run on the card's
    one-device mesh: real / dry FLOPs (``real``: `FlopCounterMode` over
    ``train``'s unrecorded step), real / dry peak (that step's peak above
    the card's other tensors, plus its arguments), and the dry run's bound
    (``bound_s``, the one each cell's record carries: `step_bound` of each
    op's own roofline summed, since the eager step runs its ops one after
    another) / ``train``'s median step, each inside its gate.  Controls
    that must miss: the dry run with K6 counted
    as its plain version (FLOPs, peak and the bound, too high) and the
    depth-2 census taken for the whole step (the bound, too low).  Every
    check runs before the phase fails."""
    import multiprocessing as mp

    from repro_torch.configs import all_cells
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

    t_phase = time.perf_counter()
    fails = []

    def need(cond, what):
        if not cond:
            fails.append(what)

    jobs = [(a, s, mp_, True, None) for a, s, _, skip in all_cells()
            if skip is None for mp_ in (False, True)]
    with mp.get_context("spawn").Pool(LAUNCH_PROCS) as pool:
        calib = pool.map_async(launch_calibrate, [
            (c, part) for c in (False, True) for part in ("exec", "profile")],
            chunksize=1)
        cells = pool.map_async(dryrun.sweep_one, jobs, chunksize=1).get()
        dry = calib.get()
    pool_s = time.perf_counter() - t_phase

    for rec in cells:
        row = dict(card=smi, arch=rec["arch"], shape=rec["shape"],
                   mesh=rec["mesh"], status=rec["status"])
        if rec["status"] == "ok":
            r = rec["roofline"]
            row.update(live_gb=rec["live_bytes_per_device"] / 1e9,
                       fits_80gb=rec["fits_80gb"], dominant=r["dominant"],
                       roofline_fraction=r["roofline_fraction"],
                       op_s=rec["op_s"], bound_s=rec["bound_s"],
                       compute_s=r["compute_s"], memory_s=r["memory_s"],
                       collective_s=r["collective_s"],
                       useful_fraction=r["useful_fraction"],
                       exec_s=rec["exec_compile_s"],
                       profile_s=rec["profile_compile_s"])
        else:
            row["reason"] = rec.get("reason") or rec.get("error")
        emit("launch_cell", **row)
    statuses = [rec["status"] for rec in cells]
    need("fail" not in statuses,
         f"launch (a): {statuses.count('fail')} cell(s) failed")
    need(all(rec["status"] == "ok" for rec in cells),
         "launch (a): " + ", ".join(
             f"{rec['arch']} × {rec['shape']} × {rec['mesh']}"
             for rec in cells if rec["status"] != "ok") + " did not run")

    dry_real, dry_control = ({**dry[i], **dry[i + 1]} for i in (0, 2))
    dry_depth2 = dict(dry_real, flops=dry_real["depth2_flops"],
                      bytes=dry_real["depth2_bytes"],
                      op_s=dry_real["depth2_op_s"],
                      bound_s=dry_real["depth2_bound_s"])

    def ratios(d):
        d["compute_s"] = d["flops"] / PEAK_FLOPS
        d["memory_s"] = d["bytes"] / HBM_BW
        return dict(flops=real["flops"] / d["flops"],
                    memory=real["peak_bytes"] / d["peak_bytes"],
                    time=d["bound_s"] / real["step_s"])

    def inside(r):
        return dict(flops=abs(r["flops"] - 1) <= LAUNCH_FLOP_GATE,
                    memory=LAUNCH_MEM_GATE[0] <= r["memory"]
                    <= LAUNCH_MEM_GATE[1],
                    time=LAUNCH_TIME_GATE[0] <= r["time"]
                    <= LAUNCH_TIME_GATE[1])

    got = ratios(dry_real)
    controls = {"k6_plain": (ratios(dry_control), ("flops", "memory", "time")),
                "depth2": (ratios(dry_depth2), ("time",))}
    for k, ok in inside(got).items():
        need(ok, f"launch (b): the {k} ratio {got[k]:.6g} is outside its "
                 "gate")
    for name, (ctl, gates) in controls.items():
        ok = inside(ctl)
        for k in gates:
            need(not ok[k], f"launch (b): the {name} control's {k} ratio "
                            f"{ctl[k]:.6g} is inside the gate")
    emit("launch", card=smi, cells=len(cells),
         ok=statuses.count("ok"), fail=statuses.count("fail"),
         pool_s=pool_s, procs=LAUNCH_PROCS,
         real=real, dry=dry_real, dry_control=dry_control,
         ratios=got, control_ratios={k: c for k, (c, _) in controls.items()},
         gates=dict(flops=LAUNCH_FLOP_GATE, memory=LAUNCH_MEM_GATE,
                    time=LAUNCH_TIME_GATE),
         failures=fails, seconds=time.perf_counter() - t_phase)
    check(not fails, "; ".join(fails))


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
    t_script = time.perf_counter()
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

    # One nvcc per source, started together; the full box is made on the
    # host meanwhile.  The build's seconds: until the last nvcc is done.
    def build(fn):
        return fn(), time.perf_counter()

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        builds = pool.map(build, (cuda.build, ss_cuda.build, fa_cuda.build,
                                  fa_cuda.build_backward, eb_cuda.build))
        box = box_mesh(80, 64, 48)
        perm = rcb_order(box.coords, box.weights)
        root = dual_graph(box).sub(perm)  # level 0
        built, ends = zip(*builds)
    emit("build", seconds=max(ends) - t0,
         libraries=[path.name for path, _ in built],
         ptxas=[ln for _, report in built for ln in report.splitlines()
                if "entry function" in ln or "registers" in ln or "spill" in ln])
    # Everything is timed before the first torch.profiler session; the
    # profile functions hold the kernel phase's tensors until they are
    # dropped, before the full-size runs measure peak memory.
    k1_rows, k1_profiles = phase_kernels(root)
    k2_rows, k2_profiles = phase_kernels_batched(root)
    gs_row = gs_against_ell(box, perm, root)
    k1_profiles()
    k2_profiles()
    del k1_profiles, k2_profiles
    smoke = phase_quality()
    phase_guard()
    phase_chaos()
    phase_reference(gs_row)
    k1_launches = k2_launches = None
    ss_launches = {"K3": None, "K4": None}
    if not args.quick:
        k1_launches, geometric_cut, full_ctx = phase_full(box)
        k2_launches = phase_full_inverse(box, geometric_cut)
        ss_launches, fp, sweep_parts, full_runs = phase_full_sharded(full_ctx)
        phase_dist(smoke, box, (full_ctx.require_graph(), full_ctx.parts_raw,
                                full_ctx.weights, full_runs))
        del full_ctx, full_runs
        phase_full_multilevel()
        phase_full_reference(box, geometric_cut)
    else:
        phase_dist(smoke, box, dist_inputs_quick(box))
        fp, sweep_parts = quick_plan(box)
    ss_rows = phase_kernels_segsum(fp, sweep_parts)
    del fp, sweep_parts
    fa_rows, fa_grad = phase_kernels_flash()
    k6_launches = phase_serve()
    k6_launches += phase_serve_window()
    k6_train, k6b_launches, k5_train, train_real = phase_train()
    k6_launches += k6_train
    k6_launches += phase_serve_moe()
    bag_rows, k5_launches = phase_recsys()
    k5_launches += k5_train + phase_recsys_train()
    phase_gnn()
    k6_shard, k6b_shard, k5_shard = phase_shard()
    k6_launches += k6_shard
    k6b_launches += k6b_shard
    k5_launches += k5_shard
    phase_launch(smi, train_real)

    def main_f32(rows):
        return next(r for r in rows
                    if r["case"] == "main" and r["dtype"] == "float32")

    def segsum_row(case):
        r = ss_rows[case]
        return dict(r, kernel_ms=r["dev_ms"])   # see ``dev_ms_by``

    # K6 at the `requests` prefill's shape, bf16, by device time
    flash_row = dict(fa_rows[("prefill", "bfloat16")],
                     kernel_ms=fa_rows[("prefill", "bfloat16")]["dev_ms"])

    # K6's backward at `train`'s attention (train_4k), bf16, by device time
    t4k = next(r for r in fa_grad if r["case"] == "train_4k")
    bwd_row = dict(max_abs_err=t4k["max_abs_err"], kernel_ms=t4k["bwd_dev_ms"],
                   ref_ms=t4k["bwd_plain_ms"], bound_ms=t4k["bwd_bound_ms"],
                   bound_by=t4k["bwd_bound_by"],
                   library_ms=t4k["sdpa_bwd_ms"])

    # K5 at the retrieval lookup's shape (10^6 bags of one), fp32, by
    # device time
    bag_row = dict(bag_rows[("retrieval", "float32")],
                   kernel_ms=bag_rows[("retrieval", "float32")]["dev_ms"])

    emit("done", seconds=time.perf_counter() - t_script, quick=args.quick)
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
        kernel_entry("flash_attention_backward",
                     "src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention_bwd.cu",
                     # no TPU kernel: the port's plain recompute
                     "src/repro_torch/kernels/flash_attention/ref.py:159",
                     k6b_launches, bwd_row),
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
