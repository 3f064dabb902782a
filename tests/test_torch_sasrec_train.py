"""SASRec training in repro_torch vs repro: `sasrec_train_loss` and its
gradients, `recsys_train_step`, and the training launcher.

`repro`'s `init_sasrec` makes the parameters; they go to NumPy and into
the port (`convert.tree_from_numpy`), so both packages differentiate the
same weights on the same `recsys_batches` draw (left padding added, so
the mask matters).  On the CPU the three lookups run on K5's autograd
function over its plain version; its backward is the transposed bag
(tests/test_torch_train.py holds it to autograd through the plain
version).  Tolerances (fp32): the loss 1e-5 (relative), every gradient
leaf 1e-5 of its max |·|, the parameters after one AdamW step 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as get_arch_j
from repro.data.synthetic import recsys_batches as recsys_batches_j
from repro.models.recsys import sasrec as sj
from repro.train.optimizer import AdamWConfig as AdamWConfigJ
from repro.train.optimizer import adamw_init as adamw_init_j
from repro.train.optimizer import adamw_update as adamw_update_j
from repro_torch.configs import get_arch
from repro_torch.convert import sasrec_params_to_numpy, tree_from_numpy
from repro_torch.launch import cells
from repro_torch.launch import train as train_cli
from repro_torch.models.common import tree_leaves
from repro_torch.models.recsys import sasrec as st
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import value_and_grad

VG_J = jax.jit(lambda cfg, p, b: jax.value_and_grad(
    lambda q: sj.sasrec_train_loss(cfg, q, b))(p), static_argnums=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def setup(B=16, seed=0):
    cfg_j = get_arch_j("sasrec").make_smoke_config()
    cfg = get_arch("sasrec").make_smoke_config()
    pj = sj.init_sasrec(cfg_j, jax.random.PRNGKey(seed))
    batch = {k: np.array(v) for k, v in next(recsys_batches_j(
        B, cfg_j.seq_len, cfg_j.n_items, seed=seed + 1)).items()}
    batch["item_seq"][:4, :3] = 0                  # left padding
    batch["pos_items"][:2, :2] = 0
    pt = tree_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                         device="cpu")
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    return cfg_j, cfg, pj, pt, bj, bt


def test_train_loss_and_grads_match_repro():
    cfg_j, cfg, pj, pt, bj, bt = setup()
    loss_j, g_j = VG_J(cfg_j, pj, bj)
    loss_t, g_t = value_and_grad(
        lambda p, b: st.sasrec_train_loss(cfg, p, b))(pt, bt)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(g_j)[0]]
    for key, a, b in zip(names, tree_leaves(g_t), jax.tree_util.tree_leaves(g_j)):
        b = np.asarray(b)
        assert a.shape == b.shape, key
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max(), key
    # rows no lookup reads get a zero gradient (the dense table gradient)
    used = np.unique(np.concatenate([np.asarray(bj[k]).ravel() for k in bj]))
    unused = np.setdiff1d(np.arange(cfg.table_rows), used)
    assert float(g_t["item_embed"][torch.from_numpy(unused)].abs().max()) == 0


def test_user_state_tree_equals_module():
    _, cfg, _, pt, _, bt = setup(seed=3)
    model = st.SASRec(cfg, pt)
    assert torch.equal(model.user_state(bt["item_seq"]),
                       st.user_state(cfg, pt, bt["item_seq"]))
    back = sasrec_params_to_numpy(model)
    for a, b in zip(jax.tree_util.tree_leaves(back), tree_leaves(pt)):
        np.testing.assert_array_equal(a, b.numpy())


def test_train_loss_lookups_run_through_k5(monkeypatch):
    from repro_torch.kernels.embedding_bag import ops

    calls = []
    forward, backward = ops.EmbeddingBag.forward, ops.EmbeddingBag.backward
    monkeypatch.setattr(ops.EmbeddingBag, "forward", staticmethod(
        lambda ctx, *a: calls.append("fwd") or forward(ctx, *a)))
    monkeypatch.setattr(ops.EmbeddingBag, "backward", staticmethod(
        lambda ctx, *a: calls.append("bwd") or backward(ctx, *a)))
    _, cfg, _, pt, _, bt = setup(seed=5)
    value_and_grad(lambda p, b: st.sasrec_train_loss(cfg, p, b))(pt, bt)
    assert calls.count("fwd") == 3 and calls.count("bwd") == 3


def test_recsys_train_step_matches_repro():
    """`recsys_train_step` against `repro`'s ``_recsys_cell`` train step:
    value-and-grad, then AdamW(lr=1e-4)."""
    cfg_j, cfg, pj, pt, bj, bt = setup(seed=7)
    _, g_j = VG_J(cfg_j, pj, bj)
    new_j, _, _ = adamw_update_j(AdamWConfigJ(lr=1e-4), g_j, adamw_init_j(pj),
                                 pj)
    new_t, opt_t, loss_t = cells.recsys_train_step(cfg, pt, adamw_init(pt), bt)
    assert np.isfinite(float(loss_t)) and int(opt_t["count"]) == 1
    for a, b in zip(tree_leaves(new_t), jax.tree_util.tree_leaves(new_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_train_cli_sasrec_preempts_and_resumes(tmp_path, capsys):
    argv = ["--arch", "sasrec", "--steps", "4", "--batch", "8", "--device",
            "cpu", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    with pytest.raises(SystemExit, match="preemption at step 3"):
        train_cli.main(argv + ["--preempt-at", "3"])
    train_cli.main(argv)
    out = capsys.readouterr().out
    assert "[fit] resumed from step 2" in out
    assert "[fit] step 4/4" in out and "[train] done: loss" in out
