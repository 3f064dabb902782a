#!/usr/bin/env python3
"""Where K6 spends its time: variants of its source, timed.

    python3 tools/k6_variants.py [OUT_DIR [VARIANT ...]]   # nvcc, one CUDA card

Each variant is a copy of ``csrc/flash_attention.cu`` with one edit
(VARIANTS below), built by nvcc like the kernel itself (all at once) into
OUT_DIR (default ``build/k6_variants``; where VARIANTs are named, only
those and ``base``) and called through its C entry point on
chip_smoke.py's bf16 inputs of the variant's route: the bf16 prefill's
``long_prefill`` and ``prefill``, the split-KV decode route's
``long_decode`` and ``decode``.  The ablations drop one part of the work
and compute something else: their outputs are wrong by design, and only
their times mean anything.  ``ns3`` and ``ns5`` change the prefill ring's
depth.  Prefill times are CUDA events over calls queued back to back
(chip_smoke.time_ms); decode times are the profiler's device time per
launch (chip_smoke.profiled_ms: a decode call is shorter than its launch
on the host).  Each variant is measured twice, in the order of VARIANTS
and then reversed.  The base source also runs the decode cases at other
split counts (``splits``).  Prints one JSON line.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"

# name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    # the exponentials: p = s * c2 - m2 without ex2
    "noexp": [("p[e] = exp2_approx(fmaf(s[nt][e], c2, -m2[e >> 1]));",
               "p[e] = fmaf(s[nt][e], c2, -m2[e >> 1]);")],
    # the row max, its shuffles and correction, the exponentials and row sum
    "nosoftmax": [
        ("    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};",
         "    if (a.Sq < 0) {\n"
         "    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};"),
        ("    float ls[2] = {0.0f, 0.0f};\n    uint32_t pa[NT / 2][4];",
         "    }\n    float corr[2] = {1.0f, 1.0f};\n"
         "    float ls[2] = {0.0f, 0.0f};\n    uint32_t pa[NT / 2][4];"),
        ("        p[e] = exp2_approx(fmaf(s[nt][e], c2, -m2[e >> 1]));\n"
         "        ls[e >> 1] += p[e];",
         "        p[e] = s[nt][e];")],
    # the K/V copies after the ring's first fill (tiles reuse stale stages)
    "noload": [("    if (j + NS - 1 < nkv) load_kv(j + NS - 1);",
                "    if (j + NS - 1 < nkv && j + NS - 1 < NS) load_kv(j + NS - 1);")],
    # the S = Q K^T wgmma (a branch no call takes; ptxas then serialises)
    "nos": [("        wgmma_ss_64x64(reinterpret_cast",
             "        if (a.Sq < 0) wgmma_ss_64x64(reinterpret_cast")],
    # the O += P V wgmma (the same)
    "nopv": [("          wgmma_rs_64x64_mn(",
              "          if (a.Sq < 0) wgmma_rs_64x64_mn(")],
    # ring depth at D = 64: 3 or 5 stages instead of 4
    "ns3": [("constexpr int NS = D == 64 ? 4", "constexpr int NS = D == 64 ? 3")],
    "ns5": [("constexpr int NS = D == 64 ? 4", "constexpr int NS = D == 64 ? 5")],
    # decode route: the last block's merge of the partials (it returns)
    "dec_nomerge": [("  if (!last_block) return;\n", "  return;\n")],
    # decode route: the fence, the ticket and the merge (every block
    # returns once its partial is written)
    "dec_noticket": [("  // The block's partial is visible device-wide before its ticket: the",
                      "  return;\n  // The block's partial is visible device-wide before its ticket: the")],
    # decode route: the merge folds 32 partials a round, not 16
    "dec_batch32": [("constexpr int kMergeBatch = 16;", "constexpr int kMergeBatch = 32;")],
    # decode route, bf16: the tensor-core products (S = Q K^T and P V)
    "dec_nomma": [("      for (int ks = 0; ks < KSTEPS; ++ks) {\n        // matrices: keys kw",
                   "      for (int ks = 0; ks < KSTEPS * (a.Sq < 0); ++ks) {\n        // matrices: keys kw"),
                  ("      for (int dp = 0; dp < DT / 2; ++dp) {\n        // matrices: keys kw",
                   "      for (int dp = 0; dp < DT / 2 * (a.Sq < 0); ++dp) {\n        // matrices: keys kw")],
    # decode route: the K/V tile copies (tiles use whatever the ring holds)
    "dec_noload": [("    if (t0 + j < t1) load_tile(t0 + j);",
                    "    if (t0 + j < t1 && a.Sq < 0) load_tile(t0 + j);"),
                   ("    if (t + NS - 1 < t1) load_tile(t + NS - 1);",
                    "    if (t + NS - 1 < t1 && a.Sq < 0) load_tile(t + NS - 1);")],
}

PREFILL_CASES = ("long_prefill", "prefill")
DECODE_CASES = ("long_decode", "decode")
SPLIT_FACTORS = (0.5, 1.0, 2.0)      # of decode_splits' count, base only


def build(out: Path, name: str, edits) -> tuple[str, Path | None, str]:
    from repro_torch.kernels import _build

    text = SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            return name, None, f"edit not found: {old[:60]!r}"
        text = text.replace(old, new)
    src = out / f"fa_{name}.cu"
    src.write_text(text)
    lib = out / f"libfa_{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True, check=False)
    notes = [ln for ln in proc.stderr.splitlines() if "C75" in ln or "error" in ln]
    return name, lib if proc.returncode == 0 else None, "\n".join(notes[:4])


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs

    out = Path(argv[0]) if argv else ROOT / "build" / "k6_variants"
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
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).flash_attention_fwd
        fn.argtypes = [ptr] * 4 + [i32] * 7 + [i64] * 9 + [i32] * 4 \
            + [ctypes.c_float, ptr, ptr, i32, ptr]
        fn.restype = ctypes.c_int
        fns[name] = fn
    from repro_torch.kernels.flash_attention import cuda as fa

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    times: dict = {}
    splits: dict = {}
    for case in PREFILL_CASES + DECODE_CASES:
        decode = case in DECODE_CASES
        B, Sq, Skv, H, Hkv, D, qo, kl, causal = cs.FLASH_CASES[case]
        kl = Skv if kl is None else kl
        qo = kl - Sq if qo is None else qo
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .cuda().bfloat16()
                   for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        n_split = fa.decode_splits(B, Hkv, Sq, causal=causal, q_offset=qo,
                                   kv_len=kl, n_sm=n_sm) if decode else 1
        counters = torch.zeros(B * Hkv, dtype=torch.int32, device="cuda")

        def caller(fn, n, name):
            ws = torch.empty(B * Hkv * n * Sq * H // Hkv * (D + 2),
                             dtype=torch.float32, device="cuda")

            def call():
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        1, B, Sq, Skv, H, Hkv, D, *q.stride()[:3],
                        *k.stride()[:3], *v.stride()[:3], qo, kl, int(causal),
                        0, 1.0 / math.sqrt(D), ws.data_ptr(), counters.data_ptr(),
                        n, stream)
                if rc != 0:
                    raise RuntimeError(f"variant {name}: CUDA error {rc}")
            return call

        def measure(call):
            call()
            torch.cuda.synchronize()
            if not decode:
                return cs.time_ms(call)
            ms, _, _ = cs.profiled_ms(call, "flash_attention_kernel")
            return ms

        names = [n for n in fns
                 if n == "base" or n.startswith("dec_") == decode]
        for name in names + names[::-1]:
            times.setdefault(case, {}).setdefault(name, []).append(
                measure(caller(fns[name], n_split, name)))
        if decode and "base" in fns:
            for f in SPLIT_FACTORS + SPLIT_FACTORS[::-1]:
                n = max(1, round(n_split * f))
                splits.setdefault(case, {}).setdefault(n, []).append(
                    measure(caller(fns["base"], n, "base")))
    print(json.dumps({"device": cs.nvidia_smi(), "ms": times,
                      "splits_ms": splits,
                      "not_built": sorted(set(chosen) - set(libs)),
                      "ptxas_notes": {n: v for n, v in notes.items() if v}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
