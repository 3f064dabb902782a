"""The port's dense transformer vs repro's on converted parameters.

`repro`'s `init_params` makes the parameters; they go to NumPy and through
`repro_torch.convert.lm_params_from_numpy`, so both packages run the same
weights on the same tokens (from NumPy).  On the CPU every attention call
of the port is K6's plain version.  Tolerances (fp32): logits and caches
1e-4, decode logits 5e-4 (`tests/test_models_lm.py::
test_decode_matches_forward`'s bound); greedy tokens identical.  bf16: the
two packages round the layer's products and sums at other places (XLA
keeps excess precision inside its fusions, and `repro`'s decode
accumulates attention in bf16 where K6 accumulates in fp32), so logits
are held to 5e-2 of max |logit| and the greedy argmax is not compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as tj
from repro.models.common import rms_norm as rms_norm_j
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import common, moe as mt, transformer as tt

from _lm_port import TORCH_DTYPE, as_np, port_config

CONFIGS = {
    # tests/test_models_lm.py:22
    "tiny": tj.LMConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                        n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                        dtype=jnp.float32),
    # GQA with G = 4 and a 64-wide head, as tinyllama's
    "gqa": tj.LMConfig(name="g", n_layers=3, d_model=96, n_heads=8,
                       n_kv_heads=2, d_head=64, d_ff=160, vocab=300,
                       dtype=jnp.float32),
}


# `repro`'s entry points, compiled once per config (the eager scans are
# slow on the CPU).
FORWARD_J = jax.jit(tj.forward, static_argnums=0)
PREFILL_J = jax.jit(tj.prefill, static_argnums=0)
DECODE_J = jax.jit(tj.decode_step, static_argnums=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def both_models(cfg_j, seed=0):
    params = tj.init_params(cfg_j, jax.random.PRNGKey(seed))
    model = lm_params_from_numpy(port_config(cfg_j),
                                 jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    return params, model


def tokens(cfg_j, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg_j.vocab, (B, S))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_repro(name):
    cfg = CONFIGS[name]
    params, model = both_models(cfg)
    toks = tokens(cfg, 2, 24, 1)
    want = FORWARD_J(cfg, params, jnp.asarray(toks))
    got = tt.forward(model, torch.from_numpy(toks))
    assert got.shape == (2, 24, cfg.vocab)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_match_repro(name):
    """Prefill logits and cache, then four decode steps (the port writes
    its preallocated cache in place; `repro` returns a new one)."""
    cfg = CONFIGS[name]
    params, model = both_models(cfg)
    toks = tokens(cfg, 2, 12, 2)
    P = 8
    lj, cj = PREFILL_J(cfg, params, jnp.asarray(toks[:, :P]))
    lt, ct = tt.prefill(model, torch.from_numpy(toks[:, :P]))
    np.testing.assert_allclose(as_np(lt), as_np(lj), atol=1e-4, rtol=1e-4)
    for key in ("k", "v"):
        assert ct[key].shape == cj[key].shape
        np.testing.assert_allclose(as_np(ct[key]), as_np(cj[key]), atol=1e-4,
                                   rtol=1e-4)

    cj = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0)))
          for k, v in cj.items()}
    ct = tt.init_cache(model.cfg, 2, P + 4)
    _, ct = tt.prefill(model, torch.from_numpy(toks[:, :P]), ct)
    for t in range(P, 12):
        dj, cj = DECODE_J(cfg, params, cj, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        dt, ct2 = tt.decode_step(model, ct, torch.from_numpy(toks[:, t:t + 1]),
                                 t)
        assert ct2 is ct                         # written in place
        np.testing.assert_allclose(as_np(dt), as_np(dj), atol=5e-4, rtol=5e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(as_np(ct[key]), as_np(cj[key]), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_tokens_identical(name):
    cfg = CONFIGS[name]
    params, model = both_models(cfg, seed=3)
    prompt = tokens(cfg, 3, 6, 4)
    steps = 8
    lj, cj = PREFILL_J(cfg, params, jnp.asarray(prompt))
    cj = {k: jnp.pad(v, ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0)))
          for k, v in cj.items()}
    ct = tt.init_cache(model.cfg, 3, 6 + steps)
    lt, ct = tt.prefill(model, torch.from_numpy(prompt), ct)
    tok_j = jnp.argmax(lj[:, -1:], -1)
    tok_t = torch.argmax(lt[:, -1:], -1)
    out_j, out_t = [np.asarray(tok_j)], [tok_t.numpy()]
    for i in range(steps - 1):
        lj, cj = DECODE_J(cfg, params, cj, tok_j, jnp.int32(6 + i))
        lt, ct = tt.decode_step(model, ct, tok_t, 6 + i)
        tok_j = jnp.argmax(lj[:, -1:], -1)
        tok_t = torch.argmax(lt[:, -1:], -1)
        out_j.append(np.asarray(tok_j))
        out_t.append(tok_t.numpy())
    np.testing.assert_array_equal(np.concatenate(out_t, 1),
                                  np.concatenate(out_j, 1))


def test_decode_matches_forward():
    """tests/test_models_lm.py:64 on the port alone."""
    cfg = CONFIGS["gqa"]
    _, model = both_models(cfg)
    toks = torch.from_numpy(tokens(cfg, 2, 12, 5))
    full = tt.forward(model, toks)
    logits, cache = tt.prefill(model, toks[:, :8], tt.init_cache(model.cfg, 2, 12))
    torch.testing.assert_close(logits[:, 0], full[:, 7], atol=2e-4, rtol=0)
    for t in range(8, 12):
        dl, cache = tt.decode_step(model, cache, toks[:, t:t + 1], t)
        torch.testing.assert_close(dl[:, 0], full[:, t], atol=5e-4, rtol=0)


def test_bf16_forward_and_decode_close_to_repro():
    cfg = dataclasses.replace(CONFIGS["gqa"], dtype=jnp.bfloat16)
    params, model = both_models(cfg)
    toks = tokens(cfg, 2, 16, 6)
    want = as_np(FORWARD_J(cfg, params, jnp.asarray(toks)))
    got = as_np(tt.forward(model, torch.from_numpy(toks)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 5e-2 * scale
    lj, cj = PREFILL_J(cfg, params, jnp.asarray(toks[:, :12]))
    cj = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
          for k, v in cj.items()}
    _, ct = tt.prefill(model, torch.from_numpy(toks[:, :12]),
                       tt.init_cache(model.cfg, 2, 13))
    dj, _ = DECODE_J(cfg, params, cj, jnp.asarray(toks[:, 12:13]),
                     jnp.int32(12))
    dt, _ = tt.decode_step(model, ct, torch.from_numpy(toks[:, 12:13]), 12)
    assert np.abs(as_np(dt) - as_np(dj)).max() <= 5e-2 * np.abs(as_np(dj)).max()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rope_and_rms_norm_match_repro(dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 12), (2, 9))
    want = tj.rope(jnp.asarray(x, dtype), jnp.asarray(pos), 1e4)
    got = tt.rope(torch.from_numpy(x).to(TORCH_DTYPE[dtype]),
                  torch.from_numpy(np.ascontiguousarray(pos)), 1e4)
    tol = 1e-6 if dtype == jnp.float32 else 1e-2
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)
    h = rng.normal(size=(3, 5, 32)).astype(np.float32)
    g = rng.normal(size=(32,)).astype(np.float32)
    want = rms_norm_j(jnp.asarray(h, dtype), jnp.asarray(g), 1e-5)
    got = common.rms_norm(torch.from_numpy(h).to(TORCH_DTYPE[dtype]),
                          torch.from_numpy(g), 1e-5)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


def test_init_params_layout_and_counts():
    """The port's own init has `repro`'s tree, shapes and dtypes; count_params
    is the config's n_params; the initialisers have their spreads."""
    from repro.models.common import count_params as count_j

    cfg_j = CONFIGS["gqa"]
    cfg = port_config(cfg_j)
    p_t = tt.init_params(cfg, torch.Generator().manual_seed(0))
    p_j = tj.init_params(cfg_j, jax.random.PRNGKey(0))
    flat_t = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(p_t)[0]}
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(p_j)[0]}
    assert flat_t.keys() == flat_j.keys()
    for key, leaf in flat_t.items():
        assert tuple(leaf.shape) == flat_j[key].shape, key
        assert leaf.dtype == torch.float32
    assert common.count_params(p_t) == count_j(p_j) == cfg.n_params()
    assert common.param_bytes(p_t) == 4 * cfg.n_params()
    wq = p_t["layers"]["wq"]
    std = 1 / np.sqrt(cfg.d_model)
    assert float(wq.abs().max()) <= 2 * std
    assert abs(float(wq.std()) / std - 0.88) < 0.05   # truncated at ±2σ
    emb = p_t["embed"]
    assert abs(float(emb.std()) * np.sqrt(cfg.d_model) - 1) < 0.05
    cast = common.tree_cast(p_t, torch.bfloat16)
    assert cast["layers"]["ffn"]["wi"].dtype == torch.bfloat16


def test_unported_configs_raise(monkeypatch):
    """Every arch of `repro` is ported: ``impl="shardmap"`` builds and, on
    one process, is `moe_apply`; mistral-large-123b is registered, and
    building it on one process raises before drawing (its 245.2 GB of bf16
    against an 80 GB card); an unknown arch raises."""
    moe = dataclasses.replace(port_config(CONFIGS["tiny"]), moe=mt.MoEConfig(
        n_experts=4, top_k=2, d_ff_expert=16, impl="shardmap"))
    params = tt.init_params(moe, torch.Generator().manual_seed(0))
    toks = torch.randint(0, moe.vocab, (2, 8), generator=torch.Generator())
    pjit = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe,
                                                            impl="pjit"))
    assert torch.equal(tt.forward(moe, params, toks),
                       tt.forward(pjit, params, toks))
    cfg = get_arch("mistral-large-123b").make_config()
    assert cfg.n_params() * 2 > 245e9
    monkeypatch.setattr(tt, "_memory_bytes", lambda device: 80 * 10**9)
    with pytest.raises(MemoryError, match=r"245\.2 GB of torch.bfloat16 "
                       r"weights on one process do not fit the 80\.0 GB"):
        tt.build_model(cfg, torch.Generator())
    with pytest.raises(MemoryError, match="GB of torch.float32"):
        tt.init_params(cfg, torch.Generator())
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-9")


def test_registry_matches_repro():
    from repro.configs import get_arch as get_arch_j
    from repro.configs import REGISTRY as REGISTRY_J
    from repro_torch.configs import NOT_PORTED, REGISTRY

    assert set(REGISTRY) | set(NOT_PORTED) == set(REGISTRY_J)
    assert not set(REGISTRY) & set(NOT_PORTED)
    assert not NOT_PORTED
    for arch_id in ("tinyllama-1.1b", "deepseek-moe-16b", "qwen3-moe-30b-a3b",
                    "command-r-35b", "mistral-large-123b"):
        arch, arch_j = get_arch(arch_id), get_arch_j(arch_id)
        for make in ("make_config", "make_smoke_config"):
            want = getattr(arch_j, make)()
            got = getattr(arch, make)()
            assert got == port_config(want), (arch_id, make)
            assert got.n_params() == want.n_params(), (arch_id, make)
            assert got.n_active_params() == want.n_active_params(), (arch_id, make)
        assert set(arch.shapes) == set(arch_j.shapes)
        assert (arch.family, arch.source, arch.skips) == \
            (arch_j.family, arch_j.source, arch_j.skips)
