#!/usr/bin/env python3
"""K3/K4's device and host times at chip_smoke.py phase 8's cases, for one
or more checkouts.

    python3 tools/segsum_ab.py ROOT [ROOT ...]     # needs one CUDA card

Each ROOT is a checkout of this repository (a ``git archive`` of another
commit unpacked into a git-ignored directory, say), or ``variant:NAME``:
this checkout with its kernel source edited as VARIANTS[NAME] says (built
from ``build/segsum_variants/NAME/``).  The cases are built
once, here: K4 ``main`` from the frontier plan of RCB labels of
``box_mesh(80, 64, 48)`` into 64 parts (phase 8 under ``--quick``; the
full run's Lanczos labels take minutes to make), K4 ``tiny``, K3 ``bench``
and K3 ``root`` (``main``'s first shard, a view into its tensors).  Then
every ROOT runs in a process of its own, in the order given, so a
comparison of two commits on one card reads ``parent change change
parent``.  Each builds its own K3/K4 library under its own ``build/``,
holds each case to the plain version bit for bit (integer and random fp32
weights) and prints one JSON line: per case, the profiler's device ms per
launch (``dev_ms``, chip_smoke.profiled_ms), CUDA-event ms over calls
queued back to back (``ms``, chip_smoke.time_ms), the host's µs per call
(``host_us``: the median of 5 rounds of 1,000 calls issued without a
synchronisation), and one
``index_add_`` of the same weights at a precomputed index by events and
by the profiler over all its kernels; then the host µs per call of the
wrapper's parts at K3 ``root``: ``_check``, the stream lookup with and
without a device context, ``torch.empty``, the C launch alone, and
issuing ``index_add_``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
SOURCE = "src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu"
CALLS, ROUNDS = 1000, 5
# name -> [(text in the kernel's source, its replacement)]
VARIANTS = {
    "rows32": [("kRows = 64;", "kRows = 32;")],
    "rows128": [("kRows = 64;", "kRows = 128;")],
    "threads256": [("kThreads = 128;", "kThreads = 256;")],
    "unroll16": [("kUnroll = 8;", "kUnroll = 16;")],
    "batch1": [("kBatch = 8;", "kBatch = 1;")],
    "fill1": [("kFill = 4;", "kFill = 1;")],
    "fill2": [("kFill = 4;", "kFill = 2;")],
    "fill8": [("kFill = 4;", "kFill = 8;")],
    "threads64": [("kThreads = 128;", "kThreads = 64;")],
    # ablations: each drops one part of the work, so its table is wrong
    # by design and only its time means anything
    "no_sum": [("      if (tid < nr)\n        sum_row(",
                "      if (tid < 0)\n        sum_row(")],
    "no_gather": [("        gather(lab, goff, a.labels, n, kn);\n", "")],
    "no_zero": [("j < round4(nr * S) / 4;", "j < 0;")],
    "no_store": [("    if (cw == a.nparts)\n      store_tile(",
                  "    if (cw == a.nparts && a.m < 0)\n      store_tile(")],
    # neither the copies nor the gather: the sum reads stale shared memory
    "no_load": [("      const bool load = p0 == 0 || !whole;",
                 "      const bool load = false;")],
}


def variant_source(name: str) -> Path:
    """This checkout's kernel source with VARIANTS[name]'s edits."""
    text = (HERE / SOURCE).read_text()
    for old, new in VARIANTS[name]:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    path = HERE / "build" / "segsum_variants" / name / "segment_sum.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


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


def make_cases(path: str) -> None:
    """Phase 8's inputs (``--quick`` plan) into the .npz ``path``."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    arrays = cs.segsum_arrays(*cs.quick_plan())
    np.savez(path, **{f"{case}|{i}": a for case, arrs in arrays.items()
                      for i, a in enumerate(arrs)})


def load_cases(path: str) -> dict:
    with np.load(path) as z:
        out: dict = {}
        for key in z.files:
            case, i = key.split("|")
            out.setdefault(case, {})[int(i)] = z[key]
    return {case: tuple(d[i] if i < 3 else int(d[i]) for i in range(4))
            for case, d in out.items()}


def one(root: str, path: str) -> dict:
    """The measurement for the checkout or variant ``root``, in this
    process."""
    variant = root.removeprefix("variant:") if root.startswith("variant:") \
        else None
    sys.path.insert(0, str(HERE / "src" if variant else Path(root) / "src"))
    import torch

    from repro_torch.kernels.segment_sum import cuda as ss

    if variant:
        ss.SOURCE = variant_source(variant)
    else:
        assert Path(ss.__file__).resolve().is_relative_to(
            Path(root).resolve())
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    out = {"root": root, "device": cs.nvidia_smi(), "cases": {}}
    cases = cs.segsum_cases(load_cases(path))
    for case, (kernel, plain, labels, cols, wts, nparts) in cases.items():
        G = cols.shape[0] if cols.ndim == 3 else 1
        B, w = cols.shape[-2:]
        fw = torch.from_numpy(np.random.default_rng(3).normal(
            size=tuple(wts.shape)).astype(np.float32)).cuda()
        equal = [bool(torch.equal(kernel(labels, cols, x, nparts),
                                  plain(labels, cols, x, nparts)))
                 for x in (wts, fw)]
        lab = torch.gather(labels.reshape(G, -1).long(), 1,
                           cols.reshape(G, -1).long())
        index = torch.arange(G * B, device="cuda").repeat_interleave(w) \
            * nparts + lab.reshape(-1)
        flat = torch.zeros(G * B * nparts, device="cuda")
        flat_w = wts.reshape(-1)

        def call():
            return kernel(labels, cols, wts, nparts)

        def library():
            return flat.index_add_(0, index, flat_w)

        dev_ms, _, name = cs.profiled_ms(call, "segment_sum_kernel")
        out["cases"][case] = dict(
            shape=[G, B, w, labels.shape[-1], nparts], equal=equal,
            dev_ms=dev_ms, kernel=name, ms=cs.time_ms(call),
            host_us=host_us(call), library_ms=cs.time_ms(library),
            library_dev_ms=cs.profiled_call_ms(library))

    _, _, labels, cols, wts, nparts = cases["K3 root"]
    B, w = cols.shape
    index = cols.get_device()
    dev = cols.device
    lib = ss._load()
    table = torch.empty((B, nparts), device=dev)

    def context_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    def launch():
        return lib.segment_sum_f32(
            labels.data_ptr(), cols.data_ptr(), wts.data_ptr(),
            table.data_ptr(), B, w, labels.shape[-1], nparts,
            torch.cuda.current_stream(index).cuda_stream)

    flat = torch.zeros(B * nparts, device=dev)
    at = torch.arange(B * w, device=dev) % (B * nparts)
    out["host_parts_us"] = {
        "check": host_us(lambda: ss._check("x", labels, cols, wts, nparts, 2)),
        "stream_in_device_context": host_us(context_stream),
        "stream": host_us(lambda: torch.cuda.current_stream(index).cuda_stream),
        "raw_stream": host_us(lambda: torch._C._cuda_getCurrentRawStream(index)),
        "current_device": host_us(torch.cuda.current_device),
        "empty": host_us(lambda: torch.empty((B, nparts), device=dev)),
        "c_launch": host_us(launch),
        "index_add_": host_us(lambda: flat.index_add_(0, at, wts.reshape(-1))),
    }
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print(json.dumps(one(argv[1], argv[2])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "cases.npz")
        t0 = time.perf_counter()
        make_cases(path)
        print(json.dumps({"cases_built_s": time.perf_counter() - t0}),
              flush=True)
        for root in argv:
            rc |= subprocess.run([sys.executable, __file__, "--one", root,
                                  path], check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
