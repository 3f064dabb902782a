"""The port's MoE layer and MoE LMs vs repro's on converted parameters.

`repro`'s ``init_moe`` / ``init_params`` make the parameters; they go to
NumPy and into the port (`convert.lm_params_from_numpy` for whole models),
so both packages run the same weights on the same NumPy-drawn inputs.
Routing is a top-k, so a near tie can flip an expert set on a rounding
difference and make a token's output jump: every input here has a top-k
gate margin (k-th gate minus the (k+1)-th, per token) above 1e-5, asserted
in the test, so a tie would show as a property of the input, not as a
tolerance.  Tolerances: `moe_apply` in fp32, expert ids and the keep mask
bit-equal, y within 1e-5 of max|y| (the two sum the same fp32 products in
another order); the smoke LMs as tests/test_torch_transformer.py (fp32
logits and caches 1e-4, decode 5e-4, greedy tokens identical; bf16 5e-2
of max|logit|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as get_arch_j
from repro.models import moe as mj
from repro.models import transformer as tj
from repro.models.common import NO_SHARD
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import common, moe as mt, transformer as tt

from _lm_port import as_np, port_config, port_moe, tensors

MOE_ARCHS = ("deepseek-moe-16b", "qwen3-moe-30b-a3b")
MARGIN = 1e-5

FORWARD_J = jax.jit(tj.forward, static_argnums=0)
PREFILL_J = jax.jit(tj.prefill, static_argnums=0)
DECODE_J = jax.jit(tj.decode_step, static_argnums=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def top_margin(gates, k) -> float:
    """The least (k-th − (k+1)-th) gate over the tokens of gates (T, E)."""
    g = np.sort(np.asarray(gates, np.float64), axis=-1)[:, ::-1]
    return float((g[:, k - 1] - g[:, k]).min())


def repro_routing(moe, p, xt):
    """`repro`'s routing and dispatch (`repro/models/moe.py:62-79`) in JAX:
    gates, top-k ids and the keep mask in the (T, k) layout."""
    gates = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    _, top_e = jax.lax.top_k(gates, moe.top_k)
    T = xt.shape[0]
    C = mj.capacity(moe, T)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    seg_start = jnp.searchsorted(se, jnp.arange(moe.n_experts), side="left")
    pos_in_e = jnp.arange(T * moe.top_k) - seg_start[se]
    keep = jnp.zeros(T * moe.top_k, bool).at[order].set(pos_in_e < C)
    return (np.asarray(gates), np.asarray(top_e),
            np.asarray(keep).reshape(T, moe.top_k))


# (top_k, capacity factor): "drops" leaves some (token, choice) pairs past
# their expert's capacity; "no_drops" sets C >= T·k.
@pytest.mark.parametrize("n_shared", [0, 1, 2])
@pytest.mark.parametrize("top_k", [1, 2, 6])
@pytest.mark.parametrize("drops", [True, False], ids=["drops", "no_drops"])
def test_moe_apply_matches_repro(n_shared, top_k, drops):
    E, d, f, B, S = 8, 32, 16, 4, 32
    moe_j = mj.MoEConfig(n_experts=E, top_k=top_k, n_shared=n_shared,
                         d_ff_expert=f,
                         capacity_factor=0.25 if drops else float(E))
    p_j = mj.init_moe(moe_j, d, jax.random.PRNGKey(10 * top_k + n_shared),
                      jnp.float32)
    # the first input of a seeded series whose every token clears the margin
    for seed in range(20):
        x = np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)
        gates, top_e_j, keep_j = repro_routing(moe_j, p_j,
                                               jnp.asarray(x).reshape(-1, d))
        if top_margin(gates, top_k) > MARGIN:
            break
    assert top_margin(gates, top_k) > MARGIN
    assert (~keep_j).any() == drops
    want = np.asarray(mj.moe_apply(moe_j, p_j, jnp.asarray(x), NO_SHARD,
                                   jnp.float32))

    moe = port_moe(moe_j)
    p = tensors(p_j)
    xt = torch.from_numpy(x)
    _, top_w, top_e = mt.route(moe, p["router"], xt.reshape(-1, d))
    slot, keep, C = mt.dispatch(moe, top_e, B * S)
    assert C == mj.capacity(moe_j, B * S)
    np.testing.assert_array_equal(top_e.numpy(), top_e_j)
    np.testing.assert_array_equal(keep.numpy(), keep_j)
    got = mt.moe_apply(moe, p, xt, torch.float32).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_capacity_matches_repro():
    for E, k, cf in [(8, 2, 1.25), (64, 6, 1.25), (128, 8, 1.25), (8, 2, 2.0),
                     (64, 6, 64 / 6), (4, 1, 0.5)]:
        moe_j = mj.MoEConfig(n_experts=E, top_k=k, capacity_factor=cf)
        for T in [1, 2, 3, 4, 7, 8, 31, 100, 512, 2048, 2300, 4096]:
            assert mt.capacity(port_moe(moe_j), T) == mj.capacity(moe_j, T)


def test_load_balance_aux_matches_repro():
    rng = np.random.default_rng(3)
    gates = rng.random((50, 8)).astype(np.float32)
    gates /= gates.sum(-1, keepdims=True)
    top_e = np.argsort(-gates, axis=-1)[:, :2]
    want = float(mj.load_balance_aux(jnp.asarray(gates), jnp.asarray(top_e), 8))
    got = float(mt.load_balance_aux(torch.from_numpy(gates),
                                    torch.from_numpy(top_e), 8))
    assert abs(got - want) <= 1e-6


def test_moe_matches_dense_expert_oracle():
    """tests/test_models_lm.py's oracle on the port: with C ≥ T·k the sorted
    dispatch equals running every expert densely and mixing by the
    renormalised top-k gates."""
    moe_j = mj.MoEConfig(n_experts=4, top_k=2, n_shared=0, d_ff_expert=16,
                         capacity_factor=8.0)
    d = 32
    p = tensors(mj.init_moe(moe_j, d, jax.random.PRNGKey(0), jnp.float32))
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(1),
                                                     (2, 8, d))))
    y = mt.moe_apply(port_moe(moe_j), p, x, torch.float32)

    xt = x.reshape(-1, d)
    gates = torch.softmax(xt @ p["router"], dim=-1)
    top_w, top_e = torch.topk(gates, 2)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    outs = []
    for e in range(4):
        g = xt @ p["wg"][e]
        outs.append((g * torch.sigmoid(g) * (xt @ p["wi"][e])) @ p["wo"][e])
    outs = torch.stack(outs, 1)                               # (T, E, d)
    ref = sum(top_w[:, j:j + 1] * outs[torch.arange(len(xt)), top_e[:, j]]
              for j in range(2))
    torch.testing.assert_close(y.reshape(-1, d), ref, atol=2e-4, rtol=0)


def both_models(cfg_j, seed=0):
    params = tj.init_params(cfg_j, jax.random.PRNGKey(seed))
    model = lm_params_from_numpy(port_config(cfg_j),
                                 jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    return params, model


def tokens(cfg_j, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg_j.vocab, (B, S))


class RoutingMargin:
    """Forward hooks on every MoE layer of a port model: the least top-k
    gate margin over all the tokens and layers routed while it is open."""

    def __init__(self, model):
        self.least = np.inf
        self.handles = [layer.moe.register_forward_hook(self._hook)
                        for layer in model.layers]
        self.model = model

    def _hook(self, module, args, out):
        h, moe = args
        gates, _, _ = mt.route(moe, module.router, h.reshape(-1, h.shape[-1]))
        self.least = min(self.least, top_margin(gates.numpy(), moe.top_k))

    def close(self):
        for handle in self.handles:
            handle.remove()


def smoke_config(arch_id, dtype=jnp.float32):
    return dataclasses.replace(get_arch_j(arch_id).make_smoke_config(),
                               dtype=dtype)


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_forward_prefill_decode_match_repro(arch_id):
    """The smoke config in fp32: forward, prefill (logits and cache) and
    four decode steps, as tests/test_torch_transformer.py holds the dense
    model."""
    cfg = smoke_config(arch_id)
    params, model = both_models(cfg)
    margin = RoutingMargin(model)
    toks = tokens(cfg, 2, 24, 1)
    want = FORWARD_J(cfg, params, jnp.asarray(toks))
    got = tt.forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-4, rtol=1e-4)

    P = 8
    lj, cj = PREFILL_J(cfg, params, jnp.asarray(toks[:, :P]))
    ct = tt.init_cache(model.cfg, 2, P + 4)
    lt, ct = tt.prefill(model, torch.from_numpy(toks[:, :P]), ct)
    np.testing.assert_allclose(as_np(lt), as_np(lj), atol=1e-4, rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(as_np(ct[key][:, :, :P]), as_np(cj[key]),
                                   atol=1e-4, rtol=1e-4)
    cj = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0)))
          for k, v in cj.items()}
    for t in range(P, P + 4):
        dj, cj = DECODE_J(cfg, params, cj, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        dt, ct = tt.decode_step(model, ct, torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(as_np(dt), as_np(dj), atol=5e-4, rtol=5e-4)
    margin.close()
    assert margin.least > MARGIN


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_bf16_forward_and_decode_close_to_repro(arch_id):
    cfg = smoke_config(arch_id, jnp.bfloat16)
    params, model = both_models(cfg, seed=1)
    margin = RoutingMargin(model)
    toks = tokens(cfg, 2, 16, 6)
    want = as_np(FORWARD_J(cfg, params, jnp.asarray(toks)))
    got = as_np(tt.forward(model, torch.from_numpy(toks)))
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    lj, cj = PREFILL_J(cfg, params, jnp.asarray(toks[:, :12]))
    cj = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
          for k, v in cj.items()}
    _, ct = tt.prefill(model, torch.from_numpy(toks[:, :12]),
                       tt.init_cache(model.cfg, 2, 13))
    dj, _ = DECODE_J(cfg, params, cj, jnp.asarray(toks[:, 12:13]),
                     jnp.int32(12))
    dt, _ = tt.decode_step(model, ct, torch.from_numpy(toks[:, 12:13]), 12)
    assert np.abs(as_np(dt) - as_np(dj)).max() <= 5e-2 * np.abs(as_np(dj)).max()
    margin.close()
    assert margin.least > MARGIN


def _repro_generate(cfg, params, prompts, steps):
    """`repro/launch/serve.py`'s loop, greedy."""
    logits, cache = PREFILL_J(cfg, params, prompts)
    cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0)))
             for k, v in cache.items()}
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    out = [tok]
    for i in range(steps - 1):
        logits, cache = DECODE_J(cfg, params, cache, tok,
                                 jnp.int32(prompts.shape[1] + i))
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_generate_matches_repro_loop(arch_id):
    cfg_j = smoke_config(arch_id)
    params, model = both_models(cfg_j)
    margin = RoutingMargin(model)
    prompts = tokens(cfg_j, 4, 16, 16)
    toks, _, step_secs = serve.generate(model.cfg, model,
                                        torch.from_numpy(prompts), 12)
    assert toks.shape == (4, 12) and len(step_secs) == 11
    np.testing.assert_array_equal(
        toks.numpy(), _repro_generate(cfg_j, params, jnp.asarray(prompts), 12))
    margin.close()
    assert margin.least > MARGIN


@pytest.mark.parametrize("arch_id", MOE_ARCHS + ("command-r-35b",))
def test_layer_by_layer_build(arch_id):
    """`build_model` in bf16: every leaf in cfg.dtype, n_params leaves in
    all, the same weights as `init_params` cast (same generator, same
    draws), and `init_layer`'s leaves with `repro`'s shapes and spreads."""
    cfg = dataclasses.replace(get_arch(arch_id).make_smoke_config(),
                              dtype=torch.bfloat16)
    model = tt.build_model(cfg, torch.Generator().manual_seed(0))
    leaves = list(model.parameters())
    assert all(p.dtype == torch.bfloat16 for p in leaves)
    assert sum(p.numel() for p in leaves) == cfg.n_params()
    ref = tt.Transformer(cfg, tt.init_params(cfg, torch.Generator().manual_seed(0)))
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 ref.named_parameters(), strict=True):
        assert torch.equal(a, b), name

    cfg_j = get_arch_j(arch_id).make_smoke_config()
    layer = tt.init_layer(cfg, torch.Generator().manual_seed(1))
    layer_j = tj.init_layer(cfg_j, jax.random.PRNGKey(1))
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(layer)[0]}
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(layer_j)[0]}
    assert flat.keys() == flat_j.keys()
    for key, leaf in flat.items():
        assert tuple(leaf.shape) == flat_j[key].shape, key
        assert leaf.dtype == torch.float32
        if leaf.ndim > 1:                      # truncated normal, ±2σ
            want = float(np.std(np.asarray(flat_j[key])))
            assert abs(float(leaf.std()) / want - 1) < 0.15, key
    assert common.count_params(layer) * cfg.n_layers + 2 * cfg.vocab * cfg.d_model \
        + cfg.d_model == cfg.n_params()


def test_serve_cli_on_moe_arch(capsys):
    serve.main(["--arch", "deepseek-moe-16b", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--steps", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(ln.startswith("[serve] ") for ln in lines)
    assert "arch=deepseek-moe-smoke batch=2" in lines[0]
