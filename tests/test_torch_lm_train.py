"""LM training in repro_torch vs repro: `loss_fn` and its gradients, remat,
`lm_train_step`, the LM data and the training launcher.

`repro`'s `init_params` makes the fp32 master tree; it goes to NumPy and
into the port (`convert.tree_from_numpy`), so both packages
differentiate the same weights on the same NumPy-drawn batch.  On the CPU
every attention call of the port is K6's autograd function over its plain
version and every embedding lookup K5's.  Tolerances (fp32): the loss
1e-5 (relative), every gradient leaf 1e-4 of its max |·| (the two
packages sum the same products in other orders; `repro` trains through
its `blocked_attention` and the port through K6's plain recompute).  The
MoE config routes every token of every layer with a top-k gate margin
above 1e-5 (asserted, from the port's routing): a tie would flip an
expert set on a rounding difference, a property of the input.  Remat on
and off give the same bits in the port.  `lm_train_step` with two
microbatches: the loss 1e-5, the parameters after the AdamW step 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import lm_batch as lm_batch_j
from repro.data.synthetic import token_batches as token_batches_j
from repro.models import moe as mj
from repro.models import transformer as tj
from repro.train.optimizer import AdamWConfig as AdamWConfigJ
from repro.train.optimizer import adamw_init as adamw_init_j
from repro.train.optimizer import adamw_update as adamw_update_j
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.data.synthetic import lm_batch, token_batches
from repro_torch.launch import cells
from repro_torch.launch import train as train_cli
from repro_torch.models import moe as mt
from repro_torch.models import transformer as tt
from repro_torch.models.common import tree_leaves
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import value_and_grad

from _lm_port import port_config

DENSE = tj.LMConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                    dtype=jnp.float32)
CONFIGS = {
    "dense": DENSE,
    "window": dataclasses.replace(DENSE, attn="sliding_window", window=5),
    "moe": dataclasses.replace(DENSE, moe=mj.MoEConfig(
        n_experts=4, top_k=2, n_shared=1, d_ff_expert=32)),
    "moe_window": dataclasses.replace(DENSE, attn="sliding_window", window=6,
                                      moe=mj.MoEConfig(n_experts=4, top_k=2,
                                                       d_ff_expert=32)),
}
MARGIN = 1e-5
VG_J = jax.jit(lambda cfg, p, b: jax.value_and_grad(
    lambda q: tj.loss_fn(cfg, q, b))(p), static_argnums=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def setup(name, B=2, S=16, seed=0):
    cfg_j = CONFIGS[name]
    pj = tj.init_params(cfg_j, jax.random.PRNGKey(seed))
    p_np = jax.tree_util.tree_map(np.asarray, pj)
    batch = lm_batch_j(np.random.default_rng(seed + 1), B, S, cfg_j.vocab)
    bt = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return cfg_j, pj, batch, port_config(cfg_j), tree_from_numpy(
        p_np, device="cpu"), bt


def route_margins(monkeypatch):
    """Record the least top-k gate margin of every routing call."""
    seen = []
    route = mt.route

    def recording(moe, router, xt):
        gates, top_w, top_e = route(moe, router, xt)
        g = gates.detach().sort(-1, descending=True).values
        seen.append(float((g[:, moe.top_k - 1] - g[:, moe.top_k]).min()))
        return gates, top_w, top_e

    monkeypatch.setattr(mt, "route", recording)
    return seen


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_repro(name, monkeypatch):
    cfg_j, pj, batch, cfg, pt, bt = setup(name)
    margins = route_margins(monkeypatch)
    loss_j, g_j = VG_J(cfg_j, pj, batch)
    loss_t, g_t = value_and_grad(lambda p, b: tt.loss_fn(cfg, p, b))(pt, bt)
    if cfg.moe is not None:
        assert len(margins) == 2 * cfg.n_layers     # forward + remat
        assert min(margins) > MARGIN
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(g_j)[0]]
    for key, a, b in zip(names, tree_leaves(g_t), jax.tree_util.tree_leaves(g_j)):
        b = np.asarray(b)
        assert a.shape == b.shape, key
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max(), key
    if cfg.moe is not None:
        assert float(g_t["layers"]["moe"]["router"].abs().max()) > 0


@pytest.mark.parametrize("name", ["dense", "moe_window"])
def test_remat_is_bit_identical(name):
    _, _, _, cfg, pt, bt = setup(name, seed=2)
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = value_and_grad(lambda p, b: tt.loss_fn(c, p, b))(pt, bt)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert torch.equal(a, b)


def test_training_attention_runs_through_k6(monkeypatch):
    """Every attention call of the training forward goes through K6's
    autograd function; with remat each layer's runs twice (forward and
    the backward's recompute)."""
    from repro_torch.kernels.flash_attention import ops

    calls = []
    forward = ops.FlashAttention.forward

    def counting(ctx, *args):
        calls.append(args[-1])          # the window
        return forward(ctx, *args)

    monkeypatch.setattr(ops.FlashAttention, "forward", staticmethod(counting))
    _, _, _, cfg, pt, bt = setup("window")
    value_and_grad(lambda p, b: tt.loss_fn(cfg, p, b))(pt, bt)
    assert calls == [5] * (2 * cfg.n_layers)


def test_forward_dispatch_keeps_both_paths():
    _, _, batch, cfg, pt, bt = setup("dense")
    model = tt.Transformer(cfg, pt)
    with torch.no_grad():
        a = tt.forward(model, bt["tokens"])
        b = tt.forward(cfg, pt, bt["tokens"])
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def test_lm_train_step_matches_repro():
    """`lm_train_step(..., microbatch=2)` against `repro`'s
    ``_lm_train_cell`` step body: value-and-grad per microbatch, summed,
    divided, then AdamW(lr=1e-4)."""
    cfg_j, pj, _, cfg, pt, _ = setup("dense", seed=4)
    batch = lm_batch_j(np.random.default_rng(9), 4, 16, cfg_j.vocab)
    mb = {k: np.asarray(v).reshape(2, 2, 16) for k, v in batch.items()}
    loss_j, gsum = 0.0, None
    for i in range(2):
        l, g = VG_J(cfg_j, pj, {k: jnp.asarray(v[i]) for k, v in mb.items()})
        loss_j += float(l)
        gsum = g if gsum is None else jax.tree_util.tree_map(jnp.add, gsum, g)
    grads = jax.tree_util.tree_map(lambda g: g / 2, gsum)
    opt_cfg = AdamWConfigJ(lr=1e-4)
    assert dataclasses.asdict(opt_cfg) == dataclasses.asdict(cells.OPT_CFG)
    new_j, opt_j, _ = adamw_update_j(opt_cfg, grads, adamw_init_j(pj), pj)

    bt = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    new_t, opt_t, loss_t = cells.lm_train_step(cfg, pt, adamw_init(pt), bt,
                                               microbatch=2)
    np.testing.assert_allclose(float(loss_t), loss_j / 2, rtol=1e-5)
    for a, b in zip(tree_leaves(new_t), jax.tree_util.tree_leaves(new_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert int(opt_t["count"]) == 1
    # the state goes back to repro's layout and resumes there
    back = tree_to_numpy(opt_t)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, opt_j))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(opt_j)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    again = tree_from_numpy(back, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(again), tree_leaves(opt_t)))
    p_back = tree_to_numpy(new_t)
    assert jax.tree_util.tree_structure(p_back) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, new_j))


def test_lm_batches_match_repro():
    a = lm_batch(np.random.default_rng(3), 3, 20, 500)
    b = lm_batch_j(np.random.default_rng(3), 3, 20, 500)
    for k in ("tokens", "labels"):
        assert a[k].dtype == torch.int32
        np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    it, it_j = token_batches(2, 8, 100, seed=5), token_batches_j(2, 8, 100,
                                                                 seed=5)
    for _ in range(3):
        x, y = next(it), next(it_j)
        np.testing.assert_array_equal(x["tokens"].numpy(),
                                      np.asarray(y["tokens"]))


def test_train_cli_preempts_and_resumes(tmp_path, capsys):
    argv = ["--arch", "tinyllama-1.1b", "--steps", "6", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "2"]
    with pytest.raises(SystemExit, match="preemption at step 3"):
        train_cli.main(argv + ["--preempt-at", "3"])
    train_cli.main(argv)
    out = capsys.readouterr().out
    assert "[fit] resumed from step 2" in out
    assert "[train] done: loss" in out
    assert "[fit] step 6/6" in out


@pytest.mark.parametrize("arch_id", ["meshgraphnet", "graphcast", "nequip",
                                     "mace"])
def test_train_cli_runs_gnn(arch_id, capsys):
    train_cli.main(["--arch", arch_id, "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[train] arch={arch_id}" in out
    assert "[fit] step 2/2" in out and "[train] done: loss" in out
