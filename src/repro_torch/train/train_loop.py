"""Fault-tolerant training loop + straggler-tolerant gradient quorum.

Port of `repro.train.train_loop`.  `fit` is resumable (`CheckpointManager`:
the newest valid checkpoint of ``ckpt_dir`` is restored, and one is saved
every ``ckpt_every`` steps and at the end), preemption-safe (an injected
``preemption_hook`` may raise; rerunning `fit` resumes bit-exactly), and
logs every ``log_every`` steps.  As in `repro`, a resumed run restarts the
data iterator from its first batch (`fit` takes a fresh iterator).

`make_train_step` is `repro`'s step without ``jax.jit`` (PyTorch runs
eagerly): `value_and_grad` of the loss over the parameter tree, then
`adamw_update`.  `quorum_grad_mean` averages per-shard gradients over the
responsive shards only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


def value_and_grad(loss_fn: Callable):
    """``jax.value_and_grad``: (params, *args) → (loss, grads), the loss
    detached and grads a tree like ``params`` (zeros where the loss does
    not reach a leaf)."""

    def fn(params, *args):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = loss_fn(p, *args)
        leaves = tree_leaves(p)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), tree_unflatten(p, [
            torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)])

    return fn


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig):
    """Generic train step: (params, opt_state, batch) → updated."""
    vg = value_and_grad(loss_fn)

    def step(params, opt_state, batch):
        loss, grads = vg(params, batch)
        params, opt_state, gnorm = adamw_update(opt_cfg, grads, opt_state,
                                                params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def quorum_grad_mean(grad_stack, alive: torch.Tensor):
    """Mean of per-shard grads over alive shards (straggler skip).

    grad_stack: tree with leading dim n_shards; alive: (n_shards,) 0/1."""
    denom = torch.clamp(alive.sum(), min=1.0)

    def one(g):
        w = alive.reshape((-1,) + (1,) * (g.ndim - 1)).to(g.dtype)
        return (g * w).sum(0) / denom.to(g.dtype)

    return tree_map(one, grad_stack)


@dataclasses.dataclass
class FitResult:
    params: dict
    opt_state: dict
    step: int
    losses: list


def fit(
    loss_fn: Callable,
    params,
    data_iter: Iterable,
    *,
    steps: int,
    opt_cfg: AdamWConfig = AdamWConfig(),
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    preemption_hook: Callable[[int], None] | None = None,
    log: Callable[[str], None] = print,
) -> FitResult:
    """Train with checkpoint/resume.  `preemption_hook(step)` may raise to
    simulate a node failure (tests); rerunning `fit` resumes."""
    opt_state = adamw_init(params)
    start = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr is not None:
        restored = mgr.restore_latest({"params": params, "opt": opt_state})
        if restored is not None:
            start, tree, _ = restored
            params, opt_state = tree["params"], tree["opt"]
            log(f"[fit] resumed from step {start}")

    step_fn = make_train_step(loss_fn, opt_cfg)
    losses = []
    t0 = time.perf_counter()
    it = iter(data_iter)
    for step in range(start, steps):
        batch = next(it)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % log_every == 0 or step + 1 == steps:
            loss = float(metrics["loss"])
            losses.append((step + 1, loss))
            dt = time.perf_counter() - t0
            log(f"[fit] step {step+1}/{steps} loss={loss:.4f} ({dt:.1f}s)")
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
        if preemption_hook is not None:
            preemption_hook(step + 1)
    if mgr is not None:
        mgr.save(steps, {"params": params, "opt": opt_state})
    return FitResult(params=params, opt_state=opt_state, step=steps,
                     losses=losses)
