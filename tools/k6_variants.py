#!/usr/bin/env python3
"""Where K6's bf16 prefill spends its time: variants of its source, timed.

    python3 tools/k6_variants.py [OUT_DIR]     # needs nvcc and one CUDA card

Each variant is a copy of ``csrc/flash_attention.cu`` with one edit
(VARIANTS below), built by nvcc like the kernel itself (all at once) into
OUT_DIR (default ``build/k6_variants``) and called through its C entry
point on chip_smoke.py's bf16 ``long_prefill`` and ``prefill`` inputs.  The
ablations drop one part of a KV tile's work on the wgmma route (D = 64) and
compute something else: their outputs are wrong by design, and only their
times mean anything.  ``ns3`` and ``ns5`` change the ring's depth.  Times
are CUDA events over calls queued back to back (chip_smoke.time_ms), each
variant measured twice, in the order of VARIANTS and then reversed.  Prints
one JSON line.
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
}
CASES = ("long_prefill", "prefill")


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
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda kv: build(out, *kv), VARIANTS.items()))
    libs, notes = {}, {}
    for name, lib, note in built:
        notes[name] = note
        if lib is not None:
            libs[name] = lib
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).flash_attention_fwd
        fn.argtypes = [ptr] * 4 + [i32] * 7 + [i64] * 9 + [i32] * 3 \
            + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        fns[name] = fn
    times: dict = {}
    for case in CASES:
        B, Sq, Skv, H, Hkv, D, qo, kl, causal = cs.FLASH_CASES[case]
        kl = Skv if kl is None else kl
        qo = kl - Sq if qo is None else qo
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .cuda().bfloat16()
                   for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        order = list(fns) + list(fns)[::-1]
        for name in order:
            def call(fn=fns[name]):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        1, B, Sq, Skv, H, Hkv, D, *q.stride()[:3],
                        *k.stride()[:3], *v.stride()[:3], qo, kl, int(causal),
                        1.0 / math.sqrt(D), stream)
                if rc != 0:
                    raise RuntimeError(f"variant {name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            times.setdefault(case, {}).setdefault(name, []).append(cs.time_ms(call))
    print(json.dumps({"device": cs.nvidia_smi(), "ms": times,
                      "not_built": sorted(set(VARIANTS) - set(libs)),
                      "ptxas_notes": {n: v for n, v in notes.items() if v}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
