"""Training launcher: `python -m repro_torch.launch.train --arch <id> [...]`.

Port of `repro.launch.train`: real AdamW steps through `train.fit`, the
smoke config by default (``--full``: the published config), with
checkpoint/resume (``--ckpt-dir``, ``--ckpt-every``) and a simulated node
failure (``--preempt-at N`` raises `SystemExit` after step N; rerun with
the same ``--ckpt-dir`` to resume).  Runs on the card (``--device`` cuda,
the default; no card raises) or on the CPU (``--device cpu``).  Every
family runs: ``lm``, ``recsys`` and ``gnn`` (batched molecules for
``mace``/``nequip``, one R-MAT graph for ``graphcast``/``meshgraphnet``,
as `repro`'s launcher).  Parameters come from a `torch.Generator` seeded
by ``--seed`` (not `jax.random`: parity with `repro` goes through
`repro_torch.convert`); the data are `repro`'s NumPy draws from the same
seed.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import (
    gnn_full_batch,
    molecule_batches,
    recsys_batches,
    token_batches,
)
from repro_torch.device import resolve_device
from repro_torch.models.common import count_params
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import fit


def _on(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


def make_loss_and_data(arch_id: str, smoke: bool, batch: int, seq: int,
                       seed: int, device=None):
    """(cfg, params, loss(params, batch), data) of ``arch_id``: the master
    tree on ``device`` (default the card) and an endless host iterator of
    batches, which the loss moves to the device."""
    arch = get_arch(arch_id)
    cfg = arch.make_smoke_config() if smoke else arch.make_config()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if arch.family == "lm":
        from repro_torch.models.transformer import init_params, loss_fn

        params = init_params(cfg, gen)
        data = token_batches(batch, seq, cfg.vocab, seed=seed)
        return cfg, params, (lambda p, b: loss_fn(cfg, p, _on(b, dev))), data
    if arch.family == "recsys":
        from repro_torch.models.recsys import init_sasrec, sasrec_train_loss

        params = init_sasrec(cfg, gen)
        data = recsys_batches(batch, cfg.seq_len, cfg.n_items, seed=seed)
        return cfg, params, (lambda p, b: sasrec_train_loss(
            cfg, p, _on(b, dev))), data
    # gnn
    from repro_torch.launch.cells import GNN_LOSSES
    from repro_torch.models import gnn

    loss = GNN_LOSSES[arch_id]
    if arch_id in ("mace", "nequip"):
        init = gnn.init_mace if arch_id == "mace" else gnn.init_nequip
        params = init(cfg, gen)
        data = molecule_batches(max(batch // 8, 2), 10, 20, seed=seed)
        return cfg, params, (lambda p, b: loss(cfg, p, b.to(dev))), data
    from repro_torch.mesh.graphs import rmat_graph

    g = rmat_graph(256, 1024, seed=seed)
    if arch_id == "graphcast":
        init = gnn.init_graphcast
        b = gnn_full_batch(g, d_feat=cfg.d_in, d_out=cfg.n_vars, seed=seed)
    else:
        init = gnn.init_mgn
        b = gnn_full_batch(g, d_feat=cfg.d_in, d_out=cfg.d_out, seed=seed)
    params = init(cfg, gen)
    b = b.to(dev)               # one static graph: planned once, on dev
    return cfg, params, (lambda p, bb: loss(cfg, p, bb)), iter(lambda: b, None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="full published config (default: smoke config)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--preempt-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, params, loss_fn, data = make_loss_and_data(
        args.arch, smoke=not args.full, batch=args.batch, seq=args.seq,
        seed=args.seed, device=args.device,
    )
    print(f"[train] arch={args.arch} params={count_params(params):,} "
          f"steps={args.steps}")

    hook = None
    if args.preempt_at is not None:
        def hook(step, _n=args.preempt_at):
            if step == _n:
                raise SystemExit(f"[train] simulated preemption at step {_n}")

    res = fit(
        loss_fn, params, Prefetcher(data, depth=2),
        steps=args.steps,
        opt_cfg=AdamWConfig(lr=args.lr, weight_decay=0.0),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=max(args.steps // 20, 1), preemption_hook=hook,
    )
    first = res.losses[0][1] if res.losses else float("nan")
    last = res.losses[-1][1] if res.losses else float("nan")
    print(f"[train] done: loss {first:.4f} → {last:.4f}")


if __name__ == "__main__":
    main()
