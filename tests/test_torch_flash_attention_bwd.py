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

from _k6_tiles import (
    bwd_key_tiles,
    bwd_pairs,
    bwd_query_tiles,
    bwd_tile_pairs,
    bwd_wg_dq_pairs,
    bwd_wg_dq_plan,
    bwd_ws_plan,
)
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


# The route that reads the forward's output and logsumexp (bf16 at D >= 64
# on the card): (B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal, window)
SAVED_CASES = {
    "g1_d64": (2, 100, 100, 2, 2, 64, 0, 100, True, None),
    "g4_d128": (1, 130, 130, 8, 2, 128, 0, 130, True, None),
    "g8_d64": (1, 150, 150, 8, 1, 64, 0, 150, True, None),
    "g8_d128_window": (1, 170, 170, 8, 1, 128, 0, 170, True, 37),
    "g4_window_wide": (2, 200, 200, 8, 2, 64, 0, 200, True, 129),
    "offset_kv_len": (2, 150, 230, 8, 2, 64, 60, 210, True, None),
    "offset_window": (1, 120, 300, 4, 1, 64, 150, 270, True, 70),
    "noncausal": (2, 90, 140, 4, 2, 64, 0, 120, False, None),
    "noncausal_window": (1, 90, 200, 4, 1, 128, 40, 190, False, 50),
    "decode_shaped": (2, 2, 300, 8, 1, 64, 250, 252, True, None),
}


def _saved_inputs(case, seed, dtype=torch.float32):
    """`_inputs` of a SAVED_CASES case, with the forward's output and
    logsumexp (the plain versions, as the kernel's forward gives them)."""
    B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal, window = \
        SAVED_CASES[case]
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
               (B, Sq, H, D))]
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    out = fa_ref.flash_attention_plain(q, k, v, **kw)
    lse = fa_ref.flash_attention_lse2(q, k, v, **kw)
    return arrays, (q, k, v, do), (out, lse), kw


@pytest.mark.parametrize("case", list(SAVED_CASES))
def test_saved_tiles_match_the_plain_recompute(case):
    _, (q, k, v, do), stats, kw = _saved_inputs(case, seed=11)
    got = fa_ref.flash_attention_grads_tiles(q, k, v, do, stats=stats, **kw)
    want = fa_ref.flash_attention_grads(q, k, v, do, **kw)
    assert all(g.dtype == torch.float32 for g in got)
    assert max(_rel(got, want)) <= 1e-5


@pytest.mark.parametrize("case", list(SAVED_CASES))
def test_saved_tiles_match_jax_gradient(case):
    """The saved-statistics emulation (δ from the output, P from the
    logsumexp) against `jax.grad` of `repro`'s ``blocked_attention``, as
    `test_tiles_match_jax_gradient`."""
    arrays, (q, k, v, do), stats, kw = _saved_inputs(case, seed=12)
    got = fa_ref.flash_attention_grads_tiles(q, k, v, do, stats=stats, **kw)
    B, Sq, _, H, Hkv, _, q_offset, kv_len, causal, window = SAVED_CASES[case]
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


@pytest.mark.parametrize("case", ["g8_d64", "offset_window", "noncausal"])
def test_lse2_matches_jax_logsumexp(case):
    """`ref.flash_attention_lse2`, the logsumexp K6's forward saves: log2 e
    times JAX's logsumexp of the scaled, masked scores (fp32, 1e-6 of its
    largest magnitude)."""
    arrays, (q, k, v, _), (_, lse), kw = _saved_inputs(case, seed=13)
    B, Sq, Skv, H, Hkv, D = SAVED_CASES[case][:6]
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(arrays[0]),
                   jnp.repeat(jnp.asarray(arrays[1]), H // Hkv, axis=2))
    vis = fa_ref._visible(Sq, Skv, kw["q_offset"], kw["kv_len"],
                          kw["causal"], kw["window"], "cpu").numpy()
    s = jnp.where(vis, s / np.sqrt(D), -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)) * fa_ref.LOG2E
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert np.abs(lse.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_saved_tiles_in_bf16_match_the_plain_recompute():
    """bf16: P and dS rounded before their products, δ from the bf16
    output; 2e-2 of each gradient's max."""
    _, (q, k, v, do), stats, kw = _saved_inputs("g8_d128_window", seed=14,
                                                dtype=torch.bfloat16)
    got = fa_ref.flash_attention_grads_tiles(q, k, v, do, stats=stats, **kw)
    want = fa_ref.flash_attention_grads(q, k, v, do, **kw)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert max(_rel(got, want)) <= 2e-2


def test_saved_tiles_in_float64():
    """float64 inputs: the saved-statistics order without its sums'
    rounding, within fp32's reach of the fp32 emulation."""
    _, (q, k, v, do), (out, lse), kw = _saved_inputs("offset_window", seed=15)
    got = fa_ref.flash_attention_grads_tiles(q, k, v, do, stats=(out, lse),
                                             **kw)
    d = [t.double() for t in (q, k, v, do)]
    exact = fa_ref.flash_attention_grads_tiles(
        *d, stats=(fa_ref.flash_attention_plain(*d[:3], **kw),
                   fa_ref.flash_attention_lse2(*d[:3], **kw).double()), **kw)
    assert all(g.dtype == torch.float64 for g in exact)
    assert max(_rel(got, exact)) <= 2e-6


# (Sq, Skv, G, q_offset, kv_len, causal, window): the new walks' edges
SAVED_WALKS = [(300, 300, 8, 0, 300, True, None),
               (333, 333, 4, 0, 333, True, 100),
               (150, 230, 8, 60, 210, True, None),
               (150, 230, 1, 60, 210, True, 37),
               (64, 700, 8, 600, 664, True, 64),
               (200, 700, 3, 480, 680, True, 150),
               (1, 4096, 8, 4095, 4096, True, None),
               (2, 300, 8, 250, 252, True, None),
               (90, 200, 4, 40, 190, False, 50),
               (96, 500, 2, 0, 500, False, None),
               (130, 130, 8, -20, 130, True, 5),
               (100, 100, 4, 0, 0, True, None)]


@pytest.mark.parametrize("walk", SAVED_WALKS, ids=str)
def test_saved_index_maps_match_the_kernel(walk):
    """`ref.dq_tiles` gives `flash_bwd_dq_wg`'s tiles (tests/_k6_tiles.py),
    and every visible (row, key) lies in a tile the dQ launch multiplies;
    the dK/dV launch walks `bwd_query_tiles` a block of 64 keys (held by
    `test_index_maps_match_the_kernel`) and, with a producer warp, the
    same pairs in blocks of 128."""
    Sq, Skv, G, q_offset, kv_len, causal, window = walk
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    T, rows, w = fa_ref.TILE, Sq * G, window or 0
    vis = fa_ref._visible(Sq, Skv, q_offset, kv_len, causal, window,
                          "cpu").expand(Sq, Skv)
    for rho0 in range(0, rows, fa_ref.ROW_BLOCK):
        plan = bwd_wg_dq_plan(rho0, rows, G, q_offset, kv_len, causal, w)
        got = fa_ref.dq_tiles(rho0, rows, G, **kw)
        assert [(u0, list(range(lo, hi))) for u0, lo, hi in got] == \
            [(u0, tiles) for u0, tiles in plan if u0 < rows]
        for u0, lo, hi in got:
            for rho in range(u0, min(u0 + 64, rows)):
                keys = vis[rho // G].nonzero().flatten()
                assert all(lo <= int(j) // T < hi for j in keys)
    # the dK/dV launch with a producer warp: each warpgroup multiplies the
    # 64-key tiles' pairs, inside its block's span
    pairs = set()
    for j0 in range(0, Skv, 2 * T):
        lo, hi, own = bwd_ws_plan(j0, Sq, q_offset, kv_len, causal, w)
        for u, (my_lo, my_hi) in enumerate(own):
            assert my_hi <= my_lo or lo <= my_lo < my_hi <= hi
            if j0 + u * T < Skv:
                pairs |= {(qt, j0 // T + u) for qt in range(my_lo, my_hi)}
    assert pairs == bwd_tile_pairs(Sq, Skv, q_offset, kv_len, causal, window,
                                   True)


def _shift_dq_tiles(monkeypatch):
    base = fa_ref.dq_tiles
    monkeypatch.setattr(fa_ref, "dq_tiles", lambda *a, **k: [
        (u0, lo, hi - 1) for u0, lo, hi in base(*a, **k)])


def _delta_from_p(monkeypatch):
    """δ from P ∘ dP of the key tile at hand (what one pass over the keys
    has), not from the output."""
    monkeypatch.setattr(fa_ref, "_ds_saved", lambda p, dp, delta: p * (
        dp - (p * dp).sum(-1, keepdim=True)))


@pytest.mark.parametrize("mutate", [_shift_dq_tiles, _shift_query_tiles,
                                    _wrong_group, _delta_from_p],
                         ids=["dq_tile_off_by_one", "query_tile_off_by_one",
                              "head_of_wrong_group", "delta_from_p"])
def test_saved_mutations_fail(mutate, monkeypatch):
    """Each mutation of the saved-statistics emulation moves a gradient
    far past the 1e-5 the unmutated emulation meets."""
    _, (q, k, v, do), stats, kw = _saved_inputs("offset_kv_len", seed=16)
    want = fa_ref.flash_attention_grads(q, k, v, do, **kw)
    mutate(monkeypatch)
    got = fa_ref.flash_attention_grads_tiles(q, k, v, do, stats=stats, **kw)
    assert max(_rel(got, want)) > 1e-2


@pytest.mark.parametrize("case", ["g8_d64", "offset_window",
                                  "decode_shaped"])
def test_saved_backward_operator_flops(case):
    """The backward operator on bf16 meta tensors with the forward's output
    and logsumexp: 6·D FLOPs a pair the dQ launch multiplies
    (tests/_k6_tiles.py, over the B·Hkv (batch, KV head) pairs) and 8·D a
    pair the dK/dV launch does (over B·H)."""
    B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal, window = \
        SAVED_CASES[case]
    meta = dict(device="meta", dtype=torch.bfloat16)
    q, do, out = (torch.empty((B, Sq, H, D), **meta) for _ in range(3))
    k, v = (torch.empty((B, Skv, Hkv, D), **meta) for _ in range(2))
    lse = torch.empty((B, H, Sq), device="meta")
    with FlopCounterMode(display=False) as fc:
        got = torch.ops.repro_torch.flash_attention_backward(
            q, k, v, do, causal, q_offset, kv_len, window, out, lse)
    want = 6 * D * B * Hkv * bwd_wg_dq_pairs(Sq, H // Hkv, q_offset, kv_len,
                                             causal, window) \
        + 8 * D * B * H * bwd_pairs(Sq, q_offset, kv_len, causal, window)
    assert fc.get_total_flops() == want > 0
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]


def test_autograd_on_bf16_meta_saves_the_statistics():
    """bf16 at D = 64 on meta tensors (the dry run stands for the card):
    `FlashAttention` runs the forward with its logsumexp (the prefill
    route, a decode-shaped call too) and saves q, k, v, the output and the
    logsumexp; its backward takes the saved-statistics operator."""
    B, Sq, Skv, H, Hkv, D = 2, 2, 300, 8, 1, 64
    meta = dict(device="meta", dtype=torch.bfloat16, requires_grad=True)
    q = torch.empty((B, Sq, H, D), **meta)
    k, v = (torch.empty((B, Skv, Hkv, D), **meta) for _ in range(2))
    with FlopCounterMode(display=False) as fc:
        out = fa_ops.flash_attention(q, k, v, q_offset=250, kv_len=252)
        saved = out.grad_fn.saved_tensors
        out.backward(torch.empty_like(out))
    assert len(saved) == 5 and saved[4].shape == (B, H, Sq)
    assert saved[4].dtype == torch.float32 and saved[3].shape == q.shape
    fwd = fa_ops.kernel_flops(q.shape, k.shape, q.dtype, True, 250, 252, None,
                              prefill=True)
    assert fwd == 4 * D * B * Hkv * bwd_wg_dq_pairs(Sq, H // Hkv, 250, 252,
                                                    True, None)
    bwd = fa_ops.backward_flops(q.shape, k.shape, True, 250, 252, None,
                                saved=True)
    assert fc.get_total_flops() == fwd + bwd


def test_forward_with_lse_operator_on_the_cpu():
    """``flash_attention_lse`` on CPU tensors is the plain output and
    logsumexp; on meta tensors its shape rule."""
    _, (q, k, v, _), (out, lse), kw = _saved_inputs("offset_window", seed=17)
    args = (kw["causal"], kw["q_offset"], kw["kv_len"], kw["window"])
    got = torch.ops.repro_torch.flash_attention_lse(q, k, v, *args)
    assert torch.equal(got[0], out) and torch.equal(got[1], lse)
    meta = torch.ops.repro_torch.flash_attention_lse(
        *(torch.empty(t.shape, device="meta") for t in (q, k, v)), *args)
    assert [(t.shape, t.dtype) for t in meta] == [(out.shape, out.dtype),
                                                  (lse.shape, torch.float32)]
