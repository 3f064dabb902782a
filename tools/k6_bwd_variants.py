#!/usr/bin/env python3
"""Where K6's backward spends its time: variants of its source, timed.

    python3 tools/k6_bwd_variants.py [OUT_DIR [VARIANT ...]]   # nvcc, one CUDA card

Each variant is a copy of ``csrc/flash_attention_bwd.cu`` with one or more
edits (VARIANTS below), built by nvcc like the kernel itself (all at once)
into OUT_DIR (default ``build/k6_bwd_variants``; where VARIANTs are named,
only those and ``base``) and called through its C entry point on bf16
inputs at chip_smoke.py's ``train_4k`` row (FLASH_GRAD_TRAIN: B 4, S 4096,
tinyllama's heads) and its ``prefill`` shape, causal, no window, with the
output and logsumexp of K6's forward (``return_lse``): the route bf16
takes at D = 64.  Each
variant's time is the profiler's device ms a call of each of its two
kernels (chip_smoke.backward_dev_ms), measured twice, in the order of
VARIANTS and then reversed; its dq, dk, dv at ``prefill`` are held to the
plain recompute (the largest gap of the three, of each one's max; the
ablations, marked ``x_``, drop part of the work and are wrong by design).
Prints one JSON line with the ptxas registers and spills of each variant's
bf16 D = 64 kernels.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"

_NS3 = ("constexpr int kWgStages = 2;", "constexpr int kWgStages = 3;")

# name -> [(text in the source, its replacement)]; the route timed is the
# one bf16 takes at D = 64 (the wgmma kernels, from the saved statistics)
VARIANTS = {
    "base": [],   # launch 2 with its producer warp (flash_bwd_dkv_ws)
    # the ring of walked tiles: 3 stages, not 2
    "ns3": [_NS3],
    # launch 1 at one block an SM (no register cap), and with one
    # warpgroup (64 rows) a block
    "dq_b1": [("constexpr int kDqMinBlocks = 2;", "constexpr int kDqMinBlocks = 1;")],
    "dq_g1": [("constexpr int kDqGroups = 2;", "constexpr int kDqGroups = 1;")],
    # launch 2 without its producer warp: one warpgroup a block, its own
    # cp.async copies and block barriers (flash_bwd_dkv_wg); and the
    # producer's ring at 3 and 4 stages
    "dkv_cpasync": [("constexpr bool kDkvProducer = true;", "constexpr bool kDkvProducer = false;")],
    "ws_ns3": [("constexpr int kWsStages = 2;", "constexpr int kWsStages = 3;")],
    "ws_ns4": [("constexpr int kWsStages = 2;", "constexpr int kWsStages = 4;")],
    # ablation: every tile taken as unmasked
    "x_nomask": [("  return k0 + nk <= a.kv_len &&", "  return a.Sq > 0 || k0 + nk <= a.kv_len &&"),
                 ("    if (k0 + kT > a.kv_len || (a.causal && k0 + kT - 1 > wpos_lo) ||\n"
                  "        (W && k0 <= upos_hi - a.window)) {", "    if (a.Sq < 0) {")],
    # ablation: the exponentials (ex2) dropped
    "x_noexp": [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                 "  y = x;")],
    # ablation: no walked tile copied after the ring's first fill (stale
    # stages are used again)
    "x_noload": [("    if (j + NS - 1 < nkv) load_kv(",
                  "    if (j + NS - 1 < nkv && a.Sq < 0) load_kv("),
                 ("    if (step + NS - 1 < steps) load_q(",
                  "    if (step + NS - 1 < steps && a.Sq < 0) load_q(")],
}


def build(out: Path, name: str, edits) -> tuple[str, Path | None, str]:
    from repro_torch.kernels import _build

    text = SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            return name, None, f"edit not found: {old[:60]!r}"
        text = text.replace(old, new)
    src = out / f"fab_{name}.cu"
    src.write_text(text)
    lib = out / f"libfab_{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True, check=False)
    report = []
    lines = proc.stderr.splitlines()
    for i, ln in enumerate(lines):
        m = re.search(r"entry function '.*?(flash_bwd_\w+?_w[gs])ILi64ELb0E", ln)
        if m:
            tail = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", tail)
            spill = re.search(r"(\d+) bytes spill stores", tail)
            report.append(f"{m.group(1)}: {regs and regs.group(1)} regs, "
                          f"{spill and spill.group(1)} B spilled")
    if proc.returncode != 0:
        report.append(proc.stderr[-400:])
    return name, lib if proc.returncode == 0 else None, "; ".join(report)


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_grads

    out = Path(argv[0]) if argv else ROOT / "build" / "k6_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    chosen = {n: e for n, e in VARIANTS.items()
              if len(argv) < 2 or n == "base" or n in argv[1:]}
    with concurrent.futures.ThreadPoolExecutor(len(chosen)) as pool:
        built = list(pool.map(lambda kv: build(out, *kv), chosen.items()))
    libs, notes = {}, {}
    for name, lib, note in built:
        notes[name] = note
        if lib is not None:
            libs[name] = lib
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).flash_attention_bwd
        fn.argtypes = fa_cuda.BWD_PROTOTYPES["flash_attention_bwd"]
        fn.restype = ctypes.c_int
        fns[name] = fn

    B, S, H, Hkv, D = cs.FLASH_GRAD_TRAIN
    Bp, Sp, _, Hp, Hkvp, Dp = cs.FLASH_CASES["prefill"][:6]
    shapes = {"train_4k": (B, S, H, Hkv, D), "prefill": (Bp, Sp, Hp, Hkvp, Dp)}
    times: dict = {}
    errs: dict = {}
    for case, (B, S, H, Hkv, D) in shapes.items():
        rng = np.random.default_rng(0)
        q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                       .cuda().bfloat16()
                       for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D),
                                 (B, S, H, D)))
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        o, lse = fa_cuda.flash_attention_cuda(q, k, v, causal=True, q_offset=0,
                                              kv_len=S, return_lse=True)
        stats = torch.empty(B * H * S, dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def caller(fn, name):
            def call():
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                        o.data_ptr(), lse.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        stats.data_ptr(), 1, B, S, S, H, Hkv, D,
                        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        *do.stride()[:3], 0, S, 1, 0, 1.0 / math.sqrt(D),
                        stream)
                if rc != 0:
                    raise RuntimeError(f"variant {name}: CUDA error {rc}")
            return call

        if case == "prefill":
            want = flash_attention_grads(q, k, v, do, causal=True, q_offset=0,
                                         kv_len=S)
            for name, fn in fns.items():
                caller(fn, name)()
                torch.cuda.synchronize()
                errs[name] = max(float((a.float() - b.float()).abs().max()
                                       / b.float().abs().max())
                                 for a, b in zip((dq, dk, dv), want))
        for name in list(fns) + list(fns)[::-1]:
            call = caller(fns[name], name)
            call()
            torch.cuda.synchronize()
            total, by_kernel = cs.backward_dev_ms(call)
            row = times.setdefault(case, {}).setdefault(name, [])
            row.append(dict(total=total, **{
                ("dq" if "_dq_" in n else "dkv"): ms
                for n, ms in (by_kernel or {}).items()}))
    print(json.dumps({"device": cs.nvidia_smi(), "ms": times,
                      "rel_err_prefill": errs,
                      "not_built": sorted(set(chosen) - set(libs)),
                      "ptxas": notes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
