#!/usr/bin/env python3
"""K5's device and host times at chip_smoke.py's K5 main-path cases, and
``retrieval_cand``'s latency, for one or more checkouts.

    python3 tools/bag_ab.py ROOT [ROOT ...]        # needs one CUDA card

Each ROOT is a checkout of this repository (a ``git archive`` of another
commit unpacked into a git-ignored directory, say), or ``variant:NAME``:
this checkout with its kernel source edited as VARIANTS[NAME] says (built
from ``build/bag_variants/NAME/``).  First, here, the plain version
(`ref.embedding_bag_ref`) runs on the CPU at each case in fp32 and bf16
(it adds in nnz order and rounds once, as K5 does) and the SHA-1 of each
result is kept.  Then every ROOT runs in a process of its own, in the
order given, so a comparison of two commits on one card reads ``parent
change change parent``.  Each builds SASRec at its published widths
(``make_config()``, fp32, parameters from ``torch.Generator("cuda")``
seeded 0, as chip_smoke.py's phase 12) with its own package, makes the
cases with chip_smoke.py's ``bag_inputs`` (``lookup``: serve_p99's 25,600
bags of one; ``retrieval``: 10^6; ``bulk``: serve_bulk's chunk, 409,600;
``pooled``: 65,536 bags of 1-64 rows), builds its own K5 under its own
``build/`` and prints one JSON line: per case and type, whether K5's
result has the plain version's SHA-1 (``equal``), the profiler's device
ms per launch (``dev_ms``, chip_smoke.profiled_ms) and CUDA-event ms over
calls queued back to back (``ms``, chip_smoke.time_ms); the host µs per
call at ``lookup`` fp32 (``host_us``: the median of 5 rounds of 1,000
calls issued without a synchronisation); and ``retrieval_cand`` over 30
calls of `launch.cells.recsys_retrieval` (1 user, 10^6 candidates; each
call ends in a synchronisation): p50 and p99 ms, and the profiler's device
ms of one call over all its kernels.  Then K5's backward (``backward``):
the transposed bag of train_batch's ``pos_items`` (65,536 × 50 Zipf(1.2)
ids into SASRec's 1,000,448 rows) and of its vocab-parallel slice
(``pos_items_slice``: model rank 1's 500,224 rows of two, the foreign
ids at row 0 and weight 0), by chip_smoke.bag_backward_inputs, through
the checkout's wrapper as its ``EmbeddingBag.backward`` calls it (its
split launch where it has one): every kernel's device ms a call
(chip_smoke.profiled_call_ms) and each kernel's a launch, CUDA-event ms
(chip_smoke.time_auto), the SHA-1 of the result and whether it is the run-order plain version's
(``runs_equal``; the plain version run on the card here first, where its
elementwise sums give the CPU's bits).
"""

from __future__ import annotations

import hashlib
import inspect
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SOURCE = "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"
CASES = ("lookup", "retrieval", "bulk", "pooled")
# backward case -> chip_smoke.bag_backward_inputs' slice_of
BACKWARD = {"pos_items": None, "pos_items_slice": (2, 1)}
CALLS, ROUNDS, RETRIEVALS = 1000, 5, 30
# name -> [(text in the kernel's source, its replacement)]
VARIANTS = {
    "minblocks12": [("kMinBlocks = 8;", "kMinBlocks = 12;")],
    "ahead8": [("kAhead = 4;", "kAhead = 8;")],
    "ones8": [("kOnes = 4;", "kOnes = 8;")],
    # blocks of two warps, the same warps an SM
    "threads64": [("kThreads = 128;", "kThreads = 64;"),
                  ("kMinBlocks = 8;", "kMinBlocks = 16;")],
    # a long bag's runs: R, G and the rows a run's walk loads together
    "run128": [("kRun = 256;", "kRun = 128;")],
    "run512": [("kRun = 256;", "kRun = 512;")],
    "run1024": [("kRun = 256;", "kRun = 1024;")],
    "group8": [("kGroup = 32;", "kGroup = 8;")],
    "combahead8": [("kCombAhead = 16;", "kCombAhead = 8;")],
    "comb1024": [("kCombThreads = 256;", "kCombThreads = 1024;")],
    # the split launch's window warps after its tiles, not before
    "windows_last": [(
        "const int64_t win_warps = (a.nwin + kWarps - 1) / kWarps * kWarps;\n"
        "    if (warp < win_warps) {\n"
        "      if (warp < a.nwin) window_run<T, VEC>(a, warp, lane);\n"
        "      return;\n"
        "    }\n"
        "    warp -= win_warps;",
        "const int64_t tiles = a.nnz > 0 ? (a.nnz + kTile - 1) / kTile : 1;\n"
        "    const int64_t tile_warps = (tiles + kWarps - 1) / kWarps * kWarps;\n"
        "    if (warp >= tile_warps) {\n"
        "      if (warp - tile_warps < a.nwin)\n"
        "        window_run<T, VEC>(a, warp - tile_warps, lane);\n"
        "      return;\n"
        "    }")],
}


def variant_source(name: str) -> Path:
    """This checkout's kernel source with VARIANTS[name]'s edits."""
    text = (HERE / SOURCE).read_text()
    for old, new in VARIANTS[name]:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    path = HERE / "build" / "bag_variants" / name / "embedding_bag.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def sha1(t) -> str:
    """SHA-1 of a tensor's bytes."""
    import torch

    return hashlib.sha1(t.contiguous().cpu().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()


def host_us(fn, calls=CALLS, rounds=ROUNDS) -> float:
    """Host µs per call of ``fn``: the median over ``rounds`` rounds of
    ``calls`` calls with no synchronisation between them (the card is
    drained before and after each round)."""
    import torch

    fn()
    per = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(per)[rounds // 2]


def setup():
    """SASRec at its published widths on the card (this process's
    ``repro_torch``), serve_p99's users and chip_smoke: (cfg, arch, model,
    users, cs)."""
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.models.recsys import SASRec, init_sasrec

    arch = get_arch("sasrec")
    cfg = arch.make_config()
    model = SASRec(cfg, init_sasrec(
        cfg, torch.Generator(device="cuda").manual_seed(0)))

    def users(B, seed):
        return next(recsys_batches(B, cfg.seq_len, cfg.n_items,
                                   seed=seed))["item_seq"].cuda()

    return cfg, arch, model, users, cs


def case_inputs(cs, model, users, cfg):
    """{case: (table, idx, seg, w, n_bags)} in fp32 on the card."""
    seq99 = users(512, 0)
    table = model.item_embed.detach()
    return {case: cs.bag_inputs(case, cs.BAG_CASES[case], table, seq99,
                                cfg.n_items) for case in CASES}


def backward_inputs(cs, cfg):
    """{case: chip_smoke.bag_backward_inputs(...)} at BACKWARD's cases."""
    from repro_torch.data.synthetic import recsys_batches

    ids = next(recsys_batches(65_536, cfg.seq_len, cfg.n_items,
                              seed=4))["pos_items"].cuda()
    return {case: cs.bag_backward_inputs(cfg.table_rows, ids, cfg.embed_dim,
                                         slice_of)
            for case, slice_of in BACKWARD.items()}


def plain_hashes(path: str) -> None:
    """The plain version's SHA-1 on the CPU at every case and type, and
    the run-order plain version's at every backward case (on the card),
    into the JSON file ``path``."""
    import torch

    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels.embedding_bag.cuda import run_shape
    from repro_torch.kernels.embedding_bag.ref import (embedding_bag_ref,
                                                       embedding_bag_runs_ref)

    cfg, _, model, users, cs = setup()
    out = {}
    for case, (t, i, s, w, n) in case_inputs(cs, model, users, cfg).items():
        t, i, s, w = (x.cpu() for x in (t, i, s, w))
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            out[f"{case}|{name}"] = sha1(embedding_bag_ref(
                t.to(dtype), i, s, n, weights=w.to(dtype)))
    run, group = run_shape()
    for case, (dout, _, _, seg, rows, w, n) in backward_inputs(cs,
                                                               cfg).items():
        out[f"backward|{case}"] = sha1(embedding_bag_runs_ref(
            dout, seg, rows, n, weights=w, run=run, group=group))
    Path(path).write_text(json.dumps(out))


def one(root: str, path: str) -> dict:
    """The measurement for the checkout or variant ``root``, in this
    process."""
    variant = root.removeprefix("variant:") if root.startswith("variant:") \
        else None
    sys.path.insert(0, str(HERE / "src" if variant else Path(root) / "src"))
    import torch

    from repro_torch.kernels.embedding_bag import cuda as eb
    from repro_torch.launch.cells import recsys_retrieval
    from repro_torch.obs import percentiles

    if variant:
        eb.SOURCE = variant_source(variant)
    else:
        assert Path(eb.__file__).resolve().is_relative_to(
            Path(root).resolve())
    _, report = eb.build()
    cfg, arch, model, users, cs = setup()
    want = json.loads(Path(path).read_text())
    out = {"root": root, "device": cs.nvidia_smi(),
           "ptxas": [ln for ln in report.splitlines()
                     if "registers" in ln or "spill" in ln][:12],
           "cases": {}}
    for case, (t32, idx, seg, w32, n) in case_inputs(cs, model, users,
                                                     cfg).items():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            table, w = t32.to(dtype), w32.to(dtype)

            def call():
                return eb.embedding_bag_cuda(table, idx, seg, w, n)

            equal = sha1(call()) == want[f"{case}|{name}"]
            dev_ms, _, kname = cs.profiled_ms(call, "embedding_bag_kernel")
            row = dict(equal=equal, dev_ms=dev_ms, ms=cs.time_ms(call),
                       kernel=kname)
            if case == "lookup" and dtype == torch.float32:
                row["host_us"] = host_us(call)
            out["cases"][f"{case} {name}"] = row
            del table, w
    # the checkout's backward call: its split launch where it has one
    split = {"split": True} if "split" in inspect.signature(
        eb.embedding_bag_cuda).parameters else {}
    out["backward"] = {}
    for case, (dout, _, _, seg, rows, w, n) in backward_inputs(cs,
                                                               cfg).items():
        def back():
            return eb.embedding_bag_cuda(dout, seg, rows, w, n, **split)

        digest = sha1(back())
        by_name = cs.device_profile(lambda: [back() for _ in range(10)],
                                    warmup=1)
        out["backward"][case] = dict(
            sha1=digest, runs_equal=digest == want[f"backward|{case}"],
            dev_ms=cs.profiled_call_ms(back), ms=cs.time_auto(back),
            split=bool(split), by_kernel={
                n[:72]: ms / count for n, (count, ms) in by_name.items()})
        del dout, seg, rows, w
    shape = arch.shapes["retrieval_cand"]
    cand = (torch.randperm(shape["n_candidates"], generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda") + 1).to(torch.int32)
    seq1 = users(shape["batch"], 2)
    with torch.inference_mode():
        def retrieval():
            return recsys_retrieval(cfg, model, seq1, cand)

        for _ in range(3):
            retrieval()
        secs = []
        for _ in range(RETRIEVALS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            retrieval()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        pct = percentiles(secs)
        out["retrieval_cand"] = dict(
            calls=RETRIEVALS, p50_ms=pct["p50"] * 1e3,
            p99_ms=pct["p99"] * 1e3,
            mean_ms=statistics.mean(secs) * 1e3,
            dev_ms=cs.profiled_call_ms(retrieval))
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print(json.dumps(one(argv[1], argv[2])), flush=True)
        return 0
    if len(argv) == 2 and argv[0] == "--plain":
        plain_hashes(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "plain.json")
        t0 = time.perf_counter()
        rc |= subprocess.run([sys.executable, __file__, "--plain", path],
                             check=False).returncode
        print(json.dumps({"plain_s": time.perf_counter() - t0}), flush=True)
        for root in argv:
            rc |= subprocess.run([sys.executable, __file__, "--one", root,
                                  path], check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
