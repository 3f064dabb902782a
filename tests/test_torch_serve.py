"""The port's serve loop and front door vs repro's.

`generate` on the CPU runs prefill and greedy KV-cache decode of the
smoke config on parameters converted from `repro`'s `init_params`; `repro`
runs its own `prefill` + `decode_step` loop (`launch/serve.py`'s) on the
same parameters and prompts.  fp32, so the tokens must be identical.  The
launcher's CLI, the guard's `check_positive_int` and `percentiles` are held
to `repro`'s.
"""

import ast
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as get_arch_j
from repro.guard import GuardError as GuardError_j
from repro.guard import check_positive_int as check_positive_int_j
from repro.guard.errors import KNOWN_CODES as KNOWN_CODES_J
from repro.models import transformer as tj
from repro.obs import percentiles as percentiles_j
from repro_torch import obs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.guard import KNOWN_CODES, GuardError, check_positive_int
from repro_torch.launch import serve
from repro_torch.models import transformer as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _smoke():
    cfg_j = get_arch_j("tinyllama-1.1b").make_smoke_config()
    fields = {f.name: getattr(cfg_j, f.name)
              for f in dataclasses.fields(tj.LMConfig)}
    fields.update(dtype=torch.float32, param_dtype=torch.float32)
    return cfg_j, tt.LMConfig(**fields)


def _repro_generate(cfg, params, prompts, steps):
    """`repro/launch/serve.py`'s loop, greedy."""
    logits, cache = jax.jit(lambda p, t: tj.prefill(cfg, p, t))(params, prompts)
    cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0)))
             for k, v in cache.items()}
    step_fn = jax.jit(lambda p, c, t, pos: tj.decode_step(cfg, p, c, t, pos))
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    out = [tok]
    for i in range(steps - 1):
        logits, cache = step_fn(params, cache, tok,
                                jnp.int32(prompts.shape[1] + i))
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("batch,prompt_len,steps", [(4, 16, 12), (1, 5, 9)])
def test_generate_matches_repro_loop(batch, prompt_len, steps):
    cfg_j, cfg = _smoke()
    params = tj.init_params(cfg_j, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    prompts = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab, (batch, prompt_len))
    toks, t_prefill, step_secs = serve.generate(
        cfg, model, torch.from_numpy(prompts), steps)
    assert toks.shape == (batch, steps)
    assert t_prefill > 0 and len(step_secs) == steps - 1
    np.testing.assert_array_equal(
        toks.numpy(), _repro_generate(cfg_j, params, jnp.asarray(prompts), steps))


def test_generate_sampling_is_seeded():
    _, cfg = _smoke()
    model = tt.Transformer(cfg, tt.init_params(cfg, torch.Generator().manual_seed(1)))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 4)))
    runs = [serve.generate(cfg, model, prompts, 6, temperature=1.0,
                           generator=torch.Generator().manual_seed(7))[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab


def test_main_prints_the_three_serve_lines(capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                "--steps", "4", "--seed", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(ln.startswith("[serve] ") for ln in lines)
    assert "arch=tinyllama-smoke batch=2" in lines[0] and "tok/s" in lines[0]
    assert "over 3 steps" in lines[1]
    assert len(ast.literal_eval(lines[2].split(": ", 1)[1])) == 4


@pytest.mark.parametrize("flag,value", [("--batch", "0"), ("--prompt-len", "x"),
                                        ("--steps", "1"),
                                        ("--temperature", "-1")])
def test_main_rejects_bad_sizes_with_exit_2(flag, value, capsys):
    with pytest.raises(SystemExit) as exit_info:
        serve.main(["--device", "cpu", flag, value])
    assert exit_info.value.code == 2
    assert "bad-argument" in capsys.readouterr().err


@pytest.mark.parametrize("value,kw", [(3, {}), ("7", {}), (0, {}), ("x", {}),
                                      (2.5, {}), (1, {"minimum": 2}),
                                      (9, {"maximum": 8}), (None, {})])
def test_check_positive_int_matches_repro(value, kw):
    try:
        want = check_positive_int_j("n", value, **kw)
    except GuardError_j as err:
        with pytest.raises(GuardError) as got:
            check_positive_int("n", value, **kw)
        assert got.value.code == err.code and got.value.details == err.details
        assert got.value.diagnostic() == err.diagnostic()
    else:
        assert check_positive_int("n", value, **kw) == want
    assert KNOWN_CODES == KNOWN_CODES_J


def test_percentiles_matches_repro():
    rng = np.random.default_rng(0)
    for xs in ([], [0.5], list(rng.random(31)), list(rng.random(200))):
        assert obs.percentiles(xs) == percentiles_j(xs)
        assert obs.percentiles(xs, qs=(0.9,)) == percentiles_j(xs, qs=(0.9,))
