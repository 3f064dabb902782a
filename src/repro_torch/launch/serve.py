"""Serving launcher: batched KV-cache autoregressive decoding.

`python -m repro_torch.launch.serve --arch tinyllama-1.1b --batch 4
--steps 32` runs prefill + N decode steps of the smoke config on the card
(``--full``: the published config, e.g. ``--arch qwen3-moe-30b-a3b
--full``, built one layer at a time so that its 61 GB of bf16 weights fit
one card; ``--device cpu``: the plain attention on the CPU).  The dense
LMs and the MoE LMs (``deepseek-moe-16b``, ``qwen3-moe-30b-a3b``) take the
same path.  Parameters come from a `torch.Generator` and prompts from
NumPy's ``default_rng``, both seeded by ``--seed``; `repro`'s serve draws
them from `jax.random`, so the two runs give different tokens — parity
with `repro` goes through converted parameters (`repro_torch.convert`).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.guard import GuardError, check_positive_int
from repro_torch.models.transformer import (
    LMConfig,
    Transformer,
    build_model,
    decode_step,
    init_cache,
    prefill,
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _next_token(logits: torch.Tensor, temperature: float,
                generator: torch.Generator | None) -> torch.Tensor:
    """(B, V) logits → (B, 1) token ids: greedy, or sampled at
    ``temperature``."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(logits, dim=-1, keepdim=True)


def generate(cfg: LMConfig, model: Transformer, prompts: torch.Tensor,
             steps: int, *, temperature: float = 0.0,
             generator: torch.Generator | None = None):
    """Prefill ``prompts`` (B, P) and decode until ``steps`` tokens per
    sequence: the first from the prefill's logits, then one per decode step.

    Returns the tokens (B, steps), the prefill's seconds and each decode
    step's seconds.  Every timed section ends in a device sync: the per-
    token sync is the latency a client sees (`repro`'s ``serve.py``)."""
    device = prompts.device
    B, P = prompts.shape
    cache = init_cache(cfg, B, P + steps, device=device)
    with torch.inference_mode():
        with obs.timed("prefill", prompt_len=P) as t_pre:
            logits, cache = prefill(model, prompts, cache)
            tok = _next_token(logits[:, -1], temperature, generator)
            _sync(device)
        out, step_secs = [tok], []
        for i in range(steps - 1):
            with obs.timed("decode_step", step=i) as t_step:
                logits, cache = decode_step(model, cache, tok, P + i)
                tok = _next_token(logits[:, -1], temperature, generator)
                _sync(device)
            step_secs.append(t_step.seconds)
            out.append(tok)
    return torch.cat(out, dim=1), t_pre.seconds, step_secs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    # sizes stay untyped here: the guard's front door turns a bad value
    # into a diagnostic instead of argparse's bare "invalid int value"
    ap.add_argument("--batch", default=4)
    ap.add_argument("--prompt-len", default=16)
    ap.add_argument("--steps", default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    try:
        args.batch = check_positive_int("batch", args.batch)
        args.prompt_len = check_positive_int("prompt-len", args.prompt_len)
        args.steps = check_positive_int("steps", args.steps, minimum=2)
        if not (np.isfinite(args.temperature) and args.temperature >= 0):
            raise GuardError(
                "bad-argument",
                f"temperature must be a finite float >= 0, "
                f"got {args.temperature!r}",
                details={"name": "temperature",
                         "value": args.temperature})
    except GuardError as err:
        print(err.diagnostic(), file=sys.stderr)
        sys.exit(2)

    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise ValueError(f"serve launcher is for LM archs, not {arch.family}")
    cfg = arch.make_config() if args.full else arch.make_smoke_config()
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(cfg, gen)
    prompts = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.batch, args.prompt_len))).to(device)
    # One serve-run trace: generate's prefill span and one span per
    # decode step under a ``serve`` root, as in `repro`'s launcher.
    with obs.trace("serve", arch=cfg.name, batch=args.batch,
                   steps=args.steps):
        toks, t_prefill, step_secs = generate(
            cfg, model, prompts, args.steps, temperature=args.temperature,
            generator=gen)
    t_decode = sum(step_secs)

    toks = toks.cpu().numpy()
    tps = args.batch * (args.steps - 1) / max(t_decode, 1e-9)
    pct = obs.percentiles(step_secs)
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prefill={t_prefill*1e3:.1f}ms decode={t_decode*1e3:.1f}ms "
          f"({tps:.1f} tok/s)")
    print(f"[serve] decode step p50={pct['p50']*1e3:.2f}ms "
          f"p99={pct['p99']*1e3:.2f}ms over {len(step_secs)} steps")
    print(f"[serve] sample token ids: {toks[0, :12].tolist()}")


if __name__ == "__main__":
    main()
