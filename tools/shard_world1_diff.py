#!/usr/bin/env python3
"""Where a sharded LM run at world size 1 first leaves the one process's
bits: chip_smoke.py's ``shard`` (a) greedy run (mistral-large-123b cut to
SHARD_LAYERS layers at full width, bf16, a SHARD_RUN prompt and its
greedy steps) as one process and as one NCCL rank under `lm_rules` on a
(1, 1) mesh, in this process, each attention and FFN block's output
compared.

    python3 tools/shard_world1_diff.py [ARCH]     # needs one CUDA card

Prints whether the tokens and each step's logits are the same bits, and
the first block whose output differs: its index (prefill's blocks first,
then each decode step's), kind, largest gap and the two outputs' strides.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.dist import group as dist_group  # noqa: E402
from repro_torch.dist.sharding import lm_rules  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402


def main(arch: str = "mistral-large-123b") -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    rdv = tempfile.mkdtemp(prefix="world1_")
    dist.init_process_group("nccl", init_method=f"file://{rdv}/rdv", rank=0,
                            world_size=1)
    cfg = cs.shard_config(arch, cs.SHARD_LAYERS)
    B, P, steps = cs.SHARD_RUN
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, P))).cuda()
    seen = []
    attention, ffn = tt.attention_block, tt.ffn_block

    def attention_spy(*a, **kw):
        y, kv = attention(*a, **kw)
        seen.append(("attention", y.detach().clone()))
        return y, kv

    def ffn_spy(*a, **kw):
        y = ffn(*a, **kw)
        seen.append(("ffn", y.detach().clone()))
        return y

    def greedy(rules):
        model = tt.build_model(cfg, torch.Generator(device="cuda")
                               .manual_seed(cs.SHARD_SEED), rules)
        seen.clear()
        toks, rows = cs.shard_greedy(model, prompts, steps)
        del model
        torch.cuda.empty_cache()
        return list(seen), toks, rows

    tt.attention_block, tt.ffn_block = attention_spy, ffn_spy
    try:
        one, t1, r1 = greedy(tt.NO_SHARD)
        rank, t2, r2 = greedy(lm_rules(make_mesh((1, 1), ("data", "model"))))
    finally:
        tt.attention_block, tt.ffn_block = attention, ffn
    print("tokens equal", torch.equal(t1, t2), "logit rows equal per step",
          [bool(torch.equal(r1[:, i], r2[:, i])) for i in range(r1.shape[1])])
    first = None
    for i, ((kind, a), (_, b)) in enumerate(zip(one, rank)):
        if not torch.equal(a, b):
            first = dict(block=i, kind=kind,
                         max_gap=float((a.float() - b.float()).abs().max()),
                         shape=tuple(a.shape), strides=(a.stride(),
                                                        b.stride()))
            break
    print("blocks", len(one), "first differing", first)
    dist_group.destroy()


if __name__ == "__main__":
    main(*sys.argv[1:])
