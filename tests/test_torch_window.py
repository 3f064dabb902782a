"""The sliding-window variant in repro_torch vs repro.

* K6's plain version with ``window`` against `repro`'s pure-JAX attention,
  which carries the mask (`chunked_attention` and `blocked_attention` with
  ``window=``, `repro/models/transformer.py:180-183,256-259`), within
  1e-6 in fp32 on inputs drawn by NumPy.
* The sliding-window LM (`make_sliding_window_config`'s variant at tiny
  widths): `forward`, `prefill` and `decode_step` against `repro`'s on the
  same converted weights (fp32: logits and caches 1e-4, decode 5e-4, as
  tests/test_torch_transformer.py), and the counterpart of
  tests/test_models_lm.py::test_sliding_window_masks_past.
* A NumPy emulation of the CUDA kernel's windowed tile ranges, line for
  line with `csrc/flash_attention.cu` (the fp32 prefill's key range, the
  bf16 prefill's ring start, skips and edge mask, the decode route's tiles
  and splits with the host's tiles per split): every visible (query, key)
  pair lies in a tile the block reads and masks, every tile it leaves
  unmasked is wholly visible, and the first tile read holds a key some
  row sees, so a window far into a long cache reads about ``window``
  keys.  The card runs the kernel itself (tests/test_torch_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as tj
from repro_torch.configs.tinyllama_1_1b import make_sliding_window_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import cuda, ops, ref
from repro_torch.models import transformer as tt

from _k6_tiles import (TILE, bf16_prefill_plan, decode_tiles_kernel,
                       fp32_prefill_tiles, host_tiles_per_split, visible)
from _lm_port import as_np, port_config

# (B, Sq, Skv, H, Hkv, D, window); queries end-aligned with the keys
ATTN_CASES = [(2, 40, 40, 4, 2, 16, 5), (1, 70, 70, 8, 2, 32, 64),
              (1, 33, 90, 4, 1, 16, 17), (2, 1, 150, 8, 2, 16, 40),
              (1, 12, 12, 2, 2, 16, 1), (1, 50, 50, 4, 4, 16, 200)]

TINY_W = tj.LMConfig(name="tw", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                     dtype=jnp.float32, attn="sliding_window", window=5)

FORWARD_J = jax.jit(tj.forward, static_argnums=0)
PREFILL_J = jax.jit(tj.prefill, static_argnums=0)
DECODE_J = jax.jit(tj.decode_step, static_argnums=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def qkv(B, Sq, Skv, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_plain_window_matches_repro_chunked(case):
    B, Sq, Skv, H, Hkv, D, w = case
    q, k, v = qkv(B, Sq, Skv, H, Hkv, D, sum(case))
    pos = np.broadcast_to(np.arange(Skv - Sq, Skv), (B, Sq))
    want = tj.chunked_attention(
        jnp.asarray(q.reshape(B, Sq, Hkv, H // Hkv, D)), jnp.asarray(k),
        jnp.asarray(v), q_pos=jnp.asarray(pos), block_kv=32, causal=True,
        window=w)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=w)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(B, Sq, H, D),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", [c for c in ATTN_CASES if c[1] == c[2]],
                         ids=str)
def test_plain_window_matches_repro_blocked(case):
    B, S, _, H, Hkv, D, w = case
    q, k, v = qkv(B, S, S, H, Hkv, D, sum(case) + 1)
    G = H // Hkv
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = tj.blocked_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, G, axis=2)),
        jnp.asarray(np.repeat(v, G, axis=2)), q_pos=jnp.asarray(pos),
        block_q=16, block_kv=32, causal=True, window=w)
    got = ref.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True,
                                    window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_window_past_every_key_is_no_window():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 30, 30, 4, 2, 16, 9))
    full = ref.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(ref.flash_attention_plain(q, k, v, causal=True,
                                                 window=30), full)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)


def both_models(cfg_j, seed=0):
    params = tj.init_params(cfg_j, jax.random.PRNGKey(seed))
    model = lm_params_from_numpy(port_config(cfg_j),
                                 jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")
    return params, model


def test_sliding_window_config_runs():
    cfg = make_sliding_window_config(4096)
    tt.check_supported(cfg)
    assert (cfg.attn, cfg.window, cfg.n_layers) == ("sliding_window", 4096, 22)


def test_sliding_window_forward_matches_repro():
    params, model = both_models(TINY_W)
    toks = np.random.default_rng(1).integers(0, TINY_W.vocab, (2, 24))
    want = FORWARD_J(TINY_W, params, jnp.asarray(toks))
    got = tt.forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-4, rtol=1e-4)


def test_sliding_window_prefill_and_decode_match_repro():
    params, model = both_models(TINY_W, seed=1)
    toks = np.random.default_rng(2).integers(0, TINY_W.vocab, (2, 16))
    P, steps = 9, 7
    lj, cj = PREFILL_J(TINY_W, params, jnp.asarray(toks[:, :P]))
    ct = tt.init_cache(model.cfg, 2, P + steps)
    lt, ct = tt.prefill(model, torch.from_numpy(toks[:, :P]), ct)
    np.testing.assert_allclose(as_np(lt), as_np(lj), atol=1e-4, rtol=1e-4)
    cj = {k: jnp.pad(v, ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0)))
          for k, v in cj.items()}
    for t in range(P, P + steps):
        dj, cj = DECODE_J(TINY_W, params, cj, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        dt, ct = tt.decode_step(model, ct, torch.from_numpy(toks[:, t:t + 1]),
                                t)
        np.testing.assert_allclose(as_np(dt), as_np(dj), atol=5e-4, rtol=5e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(as_np(ct[key]), as_np(cj[key]), atol=1e-4,
                                   rtol=1e-4)


def test_sliding_window_masks_past():
    """tests/test_models_lm.py::test_sliding_window_masks_past in the port:
    with window 4 the last of 12 positions sees tokens 8..11 only."""
    cfg_j = dataclasses.replace(TINY_W, window=4)
    _, model = both_models(cfg_j)
    t1 = np.random.default_rng(3).integers(0, 256, (1, 12))
    t2 = t1.copy()
    t2[:, 0:4] = (t1[:, 0:4] + 7) % 256
    l1 = tt.forward(model, torch.from_numpy(t1))
    l2 = tt.forward(model, torch.from_numpy(t2))
    np.testing.assert_allclose(l1[:, -1].numpy(), l2[:, -1].numpy(), atol=1e-4)
    assert not torch.allclose(l1[:, 0], l2[:, 0], atol=1e-4)


# ---------------------------------------------------------------------------
# The kernel's windowed tile ranges, emulated line for line with the .cu
# (tests/_k6_tiles.py)
# ---------------------------------------------------------------------------

def shapes(seed, n):
    """Random (Sq, G, q_offset, kv_len, window) with the window's lower
    edge on, before and after tile edges and cache lengths around it."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        G = int(rng.choice([1, 2, 4, 8]))
        Sq = int(rng.integers(1, 300))
        q_offset = int(rng.choice([0, rng.integers(0, 700), 64 * rng.integers(
            1, 12) + rng.integers(-2, 3)]))
        kv_len = q_offset + Sq - int(rng.integers(0, 3) if Sq > 3 else 0)
        window = int(rng.choice([1, 2, 63, 64, 65, 100, 128, 129,
                                 rng.integers(1, 400)]))
        yield Sq, G, max(q_offset, 0), max(kv_len, 1), window


def check_pairs(rows_pos, tiles_of, kv_len, causal, window):
    """Every visible (row, key) pair lies in a tile read for the row."""
    for r, pos in rows_pos:
        keys = set()
        for k0 in tiles_of(r):
            keys.update(range(k0, k0 + TILE))
        for key in range(kv_len):
            if visible(pos, key, kv_len, causal, window):
                assert key in keys, (r, pos, key)


@pytest.mark.parametrize("seed", range(4))
def test_emulated_fp32_prefill_tiles(seed):
    for Sq, G, q_offset, kv_len, window in shapes(seed, 25):
        rows, R = Sq * G, 64
        for rho0 in range(0, rows, R):
            tiles = fp32_prefill_tiles(rho0, R, rows, G, q_offset, kv_len,
                                       True, window)
            block = [(r, q_offset + r // G)
                     for r in range(rho0, min(rows, rho0 + R))]
            check_pairs(block, lambda r: tiles, kv_len, True, window)
            seen = any(visible(p, key, kv_len, True, window)
                       for _, p in block for key in range(kv_len))
            if seen:    # the first tile holds a key some row of the block sees
                assert any(visible(p, key, kv_len, True, window)
                           for _, p in block
                           for key in range(tiles[0], tiles[0] + TILE))


@pytest.mark.parametrize("wg", [False, True], ids=["mma", "wgmma"])
@pytest.mark.parametrize("seed", range(3))
def test_emulated_bf16_prefill_tiles(seed, wg):
    for Sq, G, q_offset, kv_len, window in shapes(10 + seed, 20):
        rows = Sq * G
        for rho0 in range(0, rows, 128):
            for wr0, tiles in bf16_prefill_plan(rho0, rows, G, q_offset,
                                                kv_len, True, window, wg):
                warp_rows = [(r, q_offset + r // G)
                             for r in range(rho0 + wr0,
                                            min(rows, rho0 + wr0 + 16))]
                read = [k0 for k0, _ in tiles]
                check_pairs(warp_rows, lambda r: read, kv_len, True, window)
                for k0, masked in tiles:      # an unmasked tile: all visible
                    if not masked:
                        assert all(visible(p, key, kv_len, True, window)
                                   for _, p in warp_rows
                                   for key in range(k0, k0 + TILE))


@pytest.mark.parametrize("seed", range(3))
def test_emulated_decode_tiles_and_splits(seed):
    rng = np.random.default_rng(20 + seed)
    for _ in range(60):
        G = int(rng.choice([1, 2, 4, 8, 16]))
        Sq = int(rng.integers(1, 16 // G + 1))
        q_offset = int(rng.integers(0, 3000))
        kv_len = q_offset + Sq
        window = int(rng.choice([1, 64, 65, 127, 4096, rng.integers(1, 2000),
                                 (q_offset - 62) % 64 + 64]))   # first key at 63 mod 64
        n_sm = int(rng.choice([1, 8, 132]))
        B, Hkv = int(rng.integers(1, 5)), int(rng.integers(1, 5))
        n_split = cuda.decode_splits(B, Hkv, Sq, causal=True,
                                     q_offset=q_offset, kv_len=kv_len,
                                     n_sm=n_sm, window=window)
        t_lo, t_hi = cuda.decode_tiles(Sq, causal=True, q_offset=q_offset,
                                       kv_len=kv_len, window=window)
        h_lo, h_n, tps = host_tiles_per_split(Sq, q_offset, kv_len, True,
                                              window, n_split)
        assert (h_lo, h_lo + h_n) == (t_lo, t_hi)     # host = wrapper
        runs = [decode_tiles_kernel(s, Sq, q_offset, kv_len, True, window, tps)
                for s in range(n_split)]
        assert all(runs), "an empty split"
        read = [t for run in runs for t in run]
        assert read == list(range(t_lo, t_hi))        # each tile once, in order
        check_pairs([(r, q_offset + r // G) for r in range(Sq * G)],
                    lambda r: [t * TILE for t in read], kv_len, True, window)
        first = [key for key in range(read[0] * TILE, read[0] * TILE + TILE)
                 if visible(q_offset, key, kv_len, True, window)]
        assert first, "the first tile holds no key the first query sees"


def test_long_decode_reads_the_window():
    """A decode at position 524,287 with window 4096 reads 64 tiles (its
    4,096 keys), not 8,192."""
    t_lo, t_hi = cuda.decode_tiles(1, causal=True, q_offset=524287,
                                   kv_len=524288, window=4096)
    assert (t_lo, t_hi) == (8128, 8192)
    assert cuda.decode_tiles(1, causal=True, q_offset=524287,
                             kv_len=524288) == (0, 8192)
