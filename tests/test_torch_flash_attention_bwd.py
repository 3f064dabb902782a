"""K6's backward kernel (`csrc/flash_attention_bwd.cu`) on the CPU: its
tile order written out in plain torch (`ref.flash_attention_grads_tiles`),
held to the plain recompute (`ref.flash_attention_grads`) and to JAX's
gradient of `repro`'s ``blocked_attention`` (fp32, 1e-5 of each
gradient's max, as tests/test_torch_train.py holds K6's autograd
function); its index maps, transcribed from the CUDA source in
tests/_k6_tiles.py, against the emulation's; mutations of those maps (a
tile off by one, a head of the wrong group) caught; the backward operator's
FLOP formula and shape rule.  The kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _k6_tiles import bwd_key_tiles, bwd_pairs, bwd_query_tiles, bwd_tile_pairs
from repro.models import transformer as tj
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# (B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal, window); every row sees
# a key (a row with none is not held to anything: the plain recompute
# averages every key there, the kernel gives it no gradient)
CASES = {
    "g1_d16": (2, 100, 100, 2, 2, 16, 0, 100, True, None),
    "g4_d32": (1, 130, 130, 8, 2, 32, 0, 130, True, None),
    "g8_d64": (1, 150, 150, 8, 1, 64, 0, 150, True, None),
    "g4_d128": (1, 70, 70, 4, 1, 128, 0, 70, True, None),
    "window": (2, 200, 200, 8, 2, 32, 0, 200, True, 37),
    "window_wide": (1, 190, 190, 4, 4, 16, 0, 190, True, 129),
    "offset_kv_len": (2, 150, 230, 8, 2, 32, 60, 210, True, None),
    "offset_window": (1, 120, 300, 4, 1, 64, 150, 270, True, 70),
    "noncausal": (2, 90, 140, 4, 2, 16, 0, 120, False, None),
    "noncausal_window": (1, 90, 200, 4, 1, 16, 40, 190, False, 50),
    "one_tile": (1, 40, 40, 8, 1, 32, 0, 40, True, None),
}


def _inputs(case, seed, dtype=torch.float32):
    B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal, window = CASES[case]
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
               (B, Sq, H, D))]
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    return arrays, [torch.from_numpy(a).to(dtype) for a in arrays], kw


def _rel(got, want):
    """max |got − want| / max |want| of each gradient."""
    return [float((a.double() - b.double()).abs().max()
                  / b.double().abs().max()) for a, b in zip(got, want)]


@pytest.mark.parametrize("case", list(CASES))
def test_tiles_match_the_plain_recompute(case):
    _, (q, k, v, do), kw = _inputs(case, seed=1)
    got = fa_ref.flash_attention_grads_tiles(q, k, v, do, **kw)
    want = fa_ref.flash_attention_grads(q, k, v, do, **kw)
    assert all(g.dtype == torch.float32 for g in got)
    assert max(_rel(got, want)) <= 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_tiles_match_jax_gradient(case):
    """The emulation's dq, dk, dv against `jax.grad` of `repro`'s
    ``blocked_attention`` (GQA as KV-head repetition, the queries at
    q_offset + i, the keys cut to kv_len); the keys past kv_len get no
    gradient."""
    arrays, (q, k, v, do), kw = _inputs(case, seed=2)
    got = fa_ref.flash_attention_grads_tiles(q, k, v, do, **kw)
    B, Sq, _, H, Hkv, _, q_offset, kv_len, causal, window = CASES[case]
    G = H // Hkv
    pos = jnp.broadcast_to(q_offset + jnp.arange(Sq), (B, Sq))

    def loss_j(qj, kj, vj):
        out = tj.blocked_attention(qj, jnp.repeat(kj, G, axis=2),
                                   jnp.repeat(vj, G, axis=2), q_pos=pos,
                                   block_q=32, block_kv=32, causal=causal,
                                   window=window)
        return jnp.sum(out * jnp.asarray(arrays[3]))

    want = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(arrays[0]), jnp.asarray(arrays[1][:, :kv_len]),
        jnp.asarray(arrays[2][:, :kv_len]))
    for g, w, cut in zip(got, want, (Sq, kv_len, kv_len)):
        w = np.asarray(w)
        assert np.abs(g[:, :cut].numpy() - w).max() <= 1e-5 * np.abs(w).max()
        assert not bool(g[:, cut:].any())


def test_tiles_in_bf16_match_the_plain_recompute():
    """bf16: p / l and ds rounded before their products, as the tensor
    cores take them; 2e-2 of each gradient's max."""
    _, (q, k, v, do), kw = _inputs("window", seed=3, dtype=torch.bfloat16)
    got = fa_ref.flash_attention_grads_tiles(q, k, v, do, **kw)
    want = fa_ref.flash_attention_grads(q, k, v, do, **kw)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert max(_rel(got, want)) <= 2e-2


def test_tiles_in_float64():
    """float64 inputs: the algorithm without its sums' rounding, within
    fp32's reach of the fp32 emulation."""
    _, (q, k, v, do), kw = _inputs("offset_window", seed=4)
    got = fa_ref.flash_attention_grads_tiles(q, k, v, do, **kw)
    exact = fa_ref.flash_attention_grads_tiles(
        q.double(), k.double(), v.double(), do.double(), **kw)
    assert all(g.dtype == torch.float64 for g in exact)
    assert max(_rel(got, exact)) <= 2e-6


# (Sq, Skv, q_offset, kv_len, causal, window): the walks' edge cases
WALKS = [(300, 300, 0, 300, True, None), (333, 333, 0, 333, True, 100),
         (150, 230, 60, 210, True, None), (150, 230, 60, 210, True, 37),
         (64, 700, 600, 664, True, 64), (200, 700, 480, 680, True, 150),
         (1, 4096, 4095, 4096, True, None), (90, 200, 40, 190, False, 50),
         (96, 500, 0, 500, False, None), (130, 130, -20, 130, True, 5),
         (100, 100, 0, 0, True, None)]


@pytest.mark.parametrize("walk", WALKS, ids=str)
def test_index_maps_match_the_kernel(walk):
    """`ref.key_tiles` and `ref.query_tiles` give the CUDA source's tiles
    (tests/_k6_tiles.py), the two launches visit the same (query tile, key
    tile) pairs, and each visited pair holds a visible (row, key) while
    every visible pair lies in a visited tile."""
    Sq, Skv, q_offset, kv_len, causal, window = walk
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    w = window or 0
    T = fa_ref.TILE
    for i0 in range(0, Sq, T):
        assert fa_ref.key_tiles(i0, Sq, **kw) == bwd_key_tiles(
            i0, Sq, q_offset, kv_len, causal, w)
    for j0 in range(0, Skv, T):
        assert fa_ref.query_tiles(j0, Sq, **kw) == bwd_query_tiles(
            j0, Sq, q_offset, kv_len, causal, w)
    rows = bwd_tile_pairs(Sq, Skv, q_offset, kv_len, causal, window, False)
    assert rows == bwd_tile_pairs(Sq, Skv, q_offset, kv_len, causal, window,
                                  True)
    vis = fa_ref._visible(Sq, Skv, q_offset, kv_len, causal, window,
                          "cpu").expand(Sq, Skv)
    seen = {(int(i) // T, int(j) // T) for i, j in vis.nonzero()}
    assert seen <= rows
    assert all(bool(vis[qt * T:qt * T + T, t * T:t * T + T].any())
               for qt, t in rows)


def _shift_key_tiles(monkeypatch):
    base = fa_ref.key_tiles
    monkeypatch.setattr(fa_ref, "key_tiles",
                        lambda *a, **k: (lambda lo, hi: (lo, hi - 1))(
                            *base(*a, **k)))


def _shift_query_tiles(monkeypatch):
    base = fa_ref.query_tiles
    monkeypatch.setattr(fa_ref, "query_tiles",
                        lambda *a, **k: (lambda lo, hi: (lo + 1, hi))(
                            *base(*a, **k)))


def _wrong_group(monkeypatch):
    base = fa_ref.kv_heads
    monkeypatch.setattr(fa_ref, "kv_heads",
                        lambda H, Hkv: torch.roll(base(H, Hkv), 1))


@pytest.mark.parametrize("mutate", [_shift_key_tiles, _shift_query_tiles,
                                    _wrong_group],
                         ids=["key_tile_off_by_one", "query_tile_off_by_one",
                              "head_of_wrong_group"])
def test_mutated_index_maps_fail(mutate, monkeypatch):
    """Each mutation of the emulation's index maps moves a gradient far
    past the 1e-5 the unmutated emulation meets."""
    _, (q, k, v, do), kw = _inputs("offset_kv_len", seed=5)
    want = fa_ref.flash_attention_grads(q, k, v, do, **kw)
    mutate(monkeypatch)
    got = fa_ref.flash_attention_grads_tiles(q, k, v, do, **kw)
    assert max(_rel(got, want)) > 1e-2


@pytest.mark.parametrize("case", ["g8_d64", "offset_window", "noncausal"])
def test_backward_operator_flops_and_shapes(case):
    """The backward operator on meta tensors: its shape rule, and under
    `FlopCounterMode` 18·D FLOPs a pair of the tiles its launches visit
    (tests/_k6_tiles.py) over the B·H (batch, head) pairs; on CPU tensors
    it is the plain recompute."""
    _, (q, k, v, do), kw = _inputs(case, seed=6)
    B, Sq, H, D = q.shape
    args = (kw["causal"], kw["q_offset"], kw["kv_len"], kw["window"])
    metas = [torch.empty(t.shape, device="meta") for t in (q, k, v, do)]
    with FlopCounterMode(display=False) as fc:
        out = torch.ops.repro_torch.flash_attention_backward(*metas, *args)
    want = 18 * D * B * H * bwd_pairs(Sq, kw["q_offset"], kw["kv_len"],
                                      kw["causal"], kw["window"])
    assert fc.get_total_flops() == want > 0
    assert [(t.shape, t.device.type) for t in out] == [
        (t.shape, "meta") for t in (q, k, v)]
    cpu = torch.ops.repro_torch.flash_attention_backward(q, k, v, do, *args)
    for a, b in zip(cpu, fa_ref.flash_attention_grads(q, k, v, do, **kw)):
        assert torch.equal(a, b)


def test_autograd_backward_on_meta_goes_through_the_operator():
    """`FlashAttention.backward` on meta tensors (the dry run) takes the
    backward operator: gradients of the inputs' shapes, and its FLOPs
    beside the forward's."""
    q = torch.empty((2, 128, 8, 64), device="meta", requires_grad=True)
    k = torch.empty((2, 128, 2, 64), device="meta", requires_grad=True)
    v = torch.empty((2, 128, 2, 64), device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        out = fa_ops.flash_attention(q, k, v)
        out.backward(torch.empty_like(out))
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    fwd = fa_ops.kernel_flops(q.shape, k.shape, q.dtype, True, 0, 128, None)
    bwd = fa_ops.backward_flops(q.shape, k.shape, True, 0, 128, None)
    assert fc.get_total_flops() == fwd + bwd
    assert bwd == 18 * 64 * 2 * 8 * bwd_pairs(128, 0, 128, True, None)
