"""K6's plain versions in repro_torch vs repro's flash attention.

On the CPU `ops.flash_attention` runs the plain PyTorch version
(`ref.flash_attention_plain`, what the kernel computes); the JAX side runs
the Pallas kernel itself in interpret mode (`flash_attention_pallas`,
directly with explicit ``q_offset``/``kv_len``, or through `repro`'s
padding `ops.flash_attention(prefer="pallas")`) and `repro`'s oracle
`attention_ref`, on the shapes of tests/test_kernels.py and the ragged and
continuation shapes of the card's bf16 prefill route, with inputs from
NumPy.  Tolerances are `_tol` of tests/test_kernels.py: fp32 2e-5, bf16
2e-2.  The CUDA kernel is held against the plain version on the card
(tests/test_torch_cuda.py, and chip_smoke.py at the serve path's shapes).

The card's decode route splits the keys into runs of 64-key tiles and
merges the runs' partials; `_split_kv` below does that arithmetic in torch
as the card kernel orders it (per-run online softmax with ``p`` rounded to
the input type, bf16's per-warp sub-runs, the fp32 merge in split order,
empty runs weighted zero) and is held to the Pallas kernel at decode
shapes for several split counts, which pins the numerics the card kernel
must reproduce.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ops_j
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as attention_ref_j
from repro_torch.kernels.flash_attention import cuda, ops, ref

SHAPES = [(2, 64, 64, 4, 2, 32), (1, 100, 100, 4, 4, 64),
          (2, 1, 200, 8, 2, 64), (1, 128, 256, 4, 1, 32),
          (1, 48, 48, 2, 2, 128)]     # tests/test_kernels.py:139-145
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# Explicit (q_offset, kv_len) cases on arrays padded to the Pallas blocks:
# (B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal, real query rows).
EXPLICIT = {
    "decode": (2, 8, 64, 8, 2, 64, 40, 41, True, 1),
    "prefill_into_cache": (1, 32, 96, 4, 2, 32, 0, 32, True, 32),
    "continuation": (1, 32, 96, 4, 1, 32, 40, 72, True, 32),
    "noncausal_kv_len": (2, 16, 64, 4, 2, 32, 0, 50, False, 16),
    # a prefill chunk continuing a cached prefix, 8 query heads per KV head
    "continuation_g8": (1, 32, 128, 16, 2, 64, 64, 96, True, 32),
}
# Shapes of the card's bf16 prefill edges (tests/test_torch_cuda.py): Sq·G
# not a multiple of 128, G ∈ {1, 2, 4, 8}, D ∈ {16, 128}, Skv not a
# multiple of 64 (B, Sq, Skv, H, Hkv, D; queries end-aligned).
RAGGED = [(1, 33, 45, 16, 4, 64), (1, 100, 100, 8, 1, 16),
          (2, 37, 37, 4, 2, 32), (1, 20, 70, 2, 2, 128)]
# The card's continuation case (tests/test_torch_cuda.py, chip_smoke.py):
# 128 queries at positions 512..639 over a 700-row cache with kv_len 640.
CONTINUATION = (1, 128, 700, 32, 4, 64, 512, 640)
# Decode-route shapes (Sq·G <= 16), causal: (B, Sq, Skv, H, Hkv, D,
# q_offset, kv_len).  G = 8 at one position with kv_len on, past and well
# past a 64-key tile edge (449 keys: 8 tiles, so 7 splits leave runs
# empty); G = 2 at 8 positions and G = 1 at 16 whose causal ends cross a
# tile edge, so a run holds valid keys for some rows and none for others.
SPLIT_CASES = {
    "g8_kv64": (2, 1, 128, 16, 2, 32, 63, 64),
    "g8_kv65": (1, 1, 192, 16, 2, 64, 64, 65),
    "g8_kv449": (1, 1, 480, 16, 2, 64, 448, 449),
    "g2_sq8": (1, 8, 128, 4, 2, 32, 60, 68),
    "g1_sq16": (2, 16, 160, 2, 2, 16, 120, 136),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker keeps the parallel workers from
    oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(
        atol=2e-5, rtol=2e-5)


def _inputs(B, Sq, Skv, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32))


def _both(arrays, name):
    tdt, jdt = DTYPES[name]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_attention_ref_matches_repro(shape, name):
    (q, k, v), (qj, kj, vj) = _both(_inputs(*shape, seed=sum(shape)), name)
    got = ref.attention_ref(q, k, v, causal=True)
    want = attention_ref_j(qj, kj, vj, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_end_aligned(shape, name):
    """The dispatch's CPU result (the plain version) against the Pallas
    kernel through `repro`'s padding ops, blocks of 32."""
    (q, k, v), (qj, kj, vj) = _both(_inputs(*shape, seed=sum(shape) + 1), name)
    got = ops.flash_attention(q, k, v, causal=True, block_q=32, block_k=32)
    want = ops_j.flash_attention(qj, kj, vj, causal=True, block_q=32,
                                 block_k=32, prefer="pallas")
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    oracle = attention_ref_j(qj, kj, vj, causal=True)
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("case", list(EXPLICIT))
def test_plain_matches_pallas_explicit(case, name):
    """Explicit q_offset and kv_len — decode over a cache with kv_len < Skv,
    a prefill into a longer cache, a continuation chunk and a non-causal
    call with masked tail keys — against `flash_attention_pallas` itself;
    only the real query rows are compared."""
    B, Sq, Skv, H, Hkv, D, q_offset, kv_len, causal, real = EXPLICIT[case]
    (q, k, v), (qj, kj, vj) = _both(_inputs(B, Sq, Skv, H, Hkv, D, seed=Sq),
                                    name)
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                              kv_len=kv_len)
    want = flash_attention_pallas(qj, kj, vj, causal=causal,
                                  q_offset=q_offset, kv_len=kv_len,
                                  block_q=8, block_k=32, interpret=True)
    np.testing.assert_allclose(_np(got)[:, :real], _np(want)[:, :real],
                               **_tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", RAGGED, ids=str)
def test_plain_matches_pallas_ragged(shape, name):
    """The bf16 prefill route's ragged edges, plain version against the
    Pallas kernel through `repro`'s padding ops and against the oracle."""
    (q, k, v), (qj, kj, vj) = _both(_inputs(*shape, seed=sum(shape) + 2), name)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops_j.flash_attention(qj, kj, vj, causal=True, block_q=32,
                                 block_k=32, prefer="pallas")
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    oracle = attention_ref_j(qj, kj, vj, causal=True)
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
def test_plain_matches_oracle_continuation(name):
    """The card's continuation case at its size: Skv = 700 is no multiple
    of a Pallas block (kernel.py:101), so the plain version with explicit
    q_offset and kv_len is held to `repro`'s oracle over the kv_len real
    keys, where the queries are end-aligned."""
    B, Sq, Skv, H, Hkv, D, q_offset, kv_len = CONTINUATION
    (q, k, v), (qj, kj, vj) = _both(_inputs(B, Sq, Skv, H, Hkv, D, seed=7),
                                    name)
    got = ops.flash_attention(q, k, v, causal=True, q_offset=q_offset,
                              kv_len=kv_len)
    want = attention_ref_j(qj, kj[:, :kv_len], vj[:, :kv_len], causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


def test_noncausal_matches_repro():
    """tests/test_kernels.py:159's non-causal case."""
    (q, k, v), (qj, kj, vj) = _both(_inputs(2, 64, 96, 4, 2, 32, seed=5),
                                    "float32")
    got = ops.flash_attention(q, k, v, causal=False)
    want = ops_j.flash_attention(qj, kj, vj, causal=False, block_q=32,
                                 block_k=32, prefer="pallas")
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    np.testing.assert_allclose(_np(ref.attention_ref(q, k, v, causal=False)),
                               _np(attention_ref_j(qj, kj, vj, causal=False)),
                               atol=2e-5)


def test_plain_matches_model_attention():
    """The plain version ≡ the transformer's own pure-JAX attention, the
    prefill (`blocked_attention`, repeated KV) and decode
    (`chunked_attention`, grouped) contractions, fp32."""
    from repro.models.transformer import blocked_attention, chunked_attention

    B, S, H, Hkv, D = 2, 40, 8, 2, 32
    G = H // Hkv
    (q, k, v), (qj, kj, vj) = _both(_inputs(B, S, S, H, Hkv, D, seed=9),
                                    "float32")
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    out_b = blocked_attention(qj, jnp.repeat(kj, G, 2), jnp.repeat(vj, G, 2),
                              q_pos=pos, block_q=16, block_kv=16)
    got = ops.flash_attention(q, k, v, causal=True, q_offset=0, kv_len=S)
    np.testing.assert_allclose(_np(got), _np(out_b), atol=2e-5)
    # decode at position 30 over a zero-padded cache of S rows
    pos1 = 30
    out_c = chunked_attention(qj[:, pos1:pos1 + 1].reshape(B, 1, Hkv, G, D),
                              kj, vj, q_pos=jnp.full((B, 1), pos1),
                              block_kv=16)
    got1 = ops.flash_attention(q[:, pos1:pos1 + 1], k, v, causal=True,
                               q_offset=pos1, kv_len=pos1 + 1)
    np.testing.assert_allclose(_np(got1), _np(out_c).reshape(B, 1, H, D),
                               atol=2e-5)


def test_auto_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 1, 50, 8, 2, 64, 3))
    got = ops.flash_attention(q, k, v, q_offset=20, kv_len=21)
    want = ref.flash_attention_plain(q, k, v, q_offset=20, kv_len=21)
    assert torch.equal(got, want)
    assert torch.equal(ops.flash_attention(q, k, v, prefer="ref"),
                       ref.flash_attention_plain(q, k, v))


def test_dispatch_rejects_what_it_cannot_run():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 4, 2, 1, 32, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(q, k, v, prefer="cuda")
    with pytest.raises(ValueError, match="unknown prefer"):
        ops.flash_attention(q, k, v, prefer="pallas")
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda.flash_attention_cuda(q, k, v, causal=True, q_offset=0, kv_len=4)


MERGE_BATCH = 16      # partials the card kernel's merge folds at a time
WARPS = 4             # bf16: sub-runs of 16 keys a tile, one per warp


def _online(qf, kf, vf, kv_len, qpos, spans, dtype):
    """One online softmax over the key ``spans`` in order: masked scores
    -inf, a span with no valid key for a row adds nothing, ``p`` rounded
    to ``dtype`` for P·V while ``l`` sums the unrounded ``p``.  Returns
    (m, l, acc) per (batch, KV head, group head, position)."""
    B, Sq, Hkv, G, D = qf.shape
    ninf = torch.tensor(float("-inf"))
    m = torch.full((B, Hkv, G, Sq), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, Sq, D))
    for k0, k1 in spans:
        if k1 <= k0:                  # past Skv: the kernel's zero-filled,
            continue                  # masked keys add nothing
        kpos = torch.arange(k0, k1)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, k0:k1]) / math.sqrt(D)
        valid = (kpos[None, :] < kv_len) & (kpos[None, :] <= qpos[:, None])
        sc = torch.where(valid, sc, ninf)
        mt = sc.amax(-1)
        has = mt > float("-inf")
        m_new = torch.where(has, torch.maximum(m, mt), m)
        corr = torch.where(has, torch.exp(m - m_new), torch.ones_like(m))
        p = torch.where(has[..., None], torch.exp(sc - m_new[..., None]),
                        torch.zeros_like(sc))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(dtype).float(), vf[:, k0:k1])
        m = m_new
    return m, l, acc


def _fold(states, batch):
    """Merge (m, l, acc) states in order, ``batch`` at a time, as the card
    kernel does: each batch's max M_b rescales the running sums by
    exp(M - M_b), and each state enters with weight exp(m_s - M_b), zero
    for a state with no valid key (m_s = -inf)."""
    M = torch.full_like(states[0][0], float("-inf"))
    L = torch.zeros_like(M)
    A = torch.zeros_like(states[0][2])
    for i in range(0, len(states), batch):
        grp = states[i:i + batch]
        Mb = torch.stack([M] + [st[0] for st in grp]).amax(0)
        ok = Mb > float("-inf")
        c = torch.where(ok, torch.exp(M - Mb), torch.ones_like(M))
        A, L = A * c[..., None], L * c
        for m_s, l_s, a_s in grp:
            w = torch.where(m_s > float("-inf"), torch.exp(m_s - Mb),
                            torch.zeros_like(m_s))
            A, L = A + w[..., None] * a_s, L + w * l_s
        M = torch.where(ok, Mb, M)
    return M, L, A


def _split_kv(q, k, v, *, q_offset, kv_len, n_split, tile=64):
    """Causal attention as the card's split-KV decode route computes it.

    The key tiles below kv_end (kv_len, and the last query's position + 1)
    are cut into ``n_split`` runs of ceil(tiles / n_split).  In fp32 a run
    is one online softmax over its tiles; in bf16 each of the kernel's
    WARPS warps keeps its own over its 16 keys of every tile, and the
    warps' states merge in warp order (`_fold`).  The runs' partials then
    merge in split order, MERGE_BATCH at a time (`_fold`); o = acc /
    max(l, 1e-30)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.reshape(B, Sq, Hkv, G, D).float()
    kf, vf = k.float(), v.float()
    kv_end = max(min(kv_len, q_offset + Sq), 0)
    n_tiles = -(-kv_end // tile)
    per = -(-n_tiles // n_split) if n_tiles else 1
    qpos = q_offset + torch.arange(Sq)
    sub = WARPS if q.dtype == torch.bfloat16 else 1
    width = tile // sub
    parts = []
    for s in range(n_split):
        tiles = range(s * per, min((s + 1) * per, n_tiles))
        runs = [_online(qf, kf, vf, kv_len, qpos,
                        [(t * tile + w * width,
                          min(t * tile + (w + 1) * width, Skv))
                         for t in tiles], v.dtype)
                for w in range(sub)]
        parts.append(_fold(runs, sub))
    _, L, A = _fold(parts, MERGE_BATCH)
    o = A / L.clamp_min(1e-30)[..., None]
    return o.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def _split_inputs(case):
    """The case's inputs with the queries padded to a Pallas block of 8."""
    B, Sq, Skv, H, Hkv, D, _, _ = SPLIT_CASES[case]
    return _inputs(B, -(-Sq // 8) * 8, Skv, H, Hkv, D, seed=Skv + Sq)


@functools.lru_cache(maxsize=None)
def _split_pallas(case, name):
    """`flash_attention_pallas` in interpret mode on the case (one run per
    case and type, shared by its split counts)."""
    _, _, _, _, _, _, q_offset, kv_len = SPLIT_CASES[case]
    _, (qj, kj, vj) = _both(_split_inputs(case), name)
    return _np(flash_attention_pallas(qj, kj, vj, causal=True,
                                      q_offset=q_offset, kv_len=kv_len,
                                      block_q=8, block_k=32, interpret=True))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_kv_merge_matches_pallas(case, n_split, name):
    """The decode route's split-and-merge arithmetic against the Pallas
    kernel (real query rows only), fp32 2e-5 and bf16 2e-2."""
    B, Sq, Skv, H, Hkv, D, q_offset, kv_len = SPLIT_CASES[case]
    (q, k, v), _ = _both(_split_inputs(case), name)
    got = _split_kv(q[:, :Sq], k, v, q_offset=q_offset, kv_len=kv_len,
                    n_split=n_split)
    np.testing.assert_allclose(_np(got), _split_pallas(case, name)[:, :Sq],
                               **_tol(name))


def test_decode_splits():
    """The decode route's split count: about BLOCKS_PER_SM (one) block per
    SM over the (batch, KV head) pairs, at least one 64-key tile a run, at
    most MAX_SPLITS runs, and no empty run."""
    def splits(B, Hkv, Sq, q_offset, kv_len, causal=True, n_sm=132):
        return cuda.decode_splits(B, Hkv, Sq, causal=causal,
                                  q_offset=q_offset, kv_len=kv_len, n_sm=n_sm)

    assert splits(1, 4, 1, 4095, 4096) == 32     # long decode: 2 tiles a run
    assert splits(4, 4, 1, 574, 575) == 9        # decode: 144 blocks
    assert splits(4, 4, 1, 62, 63) == 1          # one tile
    assert splits(2, 4, 1, 0, 0) == 1            # no key
    assert splits(1, 4, 1, -5, 64) == 1          # no query sees a key
    assert splits(1, 4, 1, 6399, 6400) == 25     # 100 tiles: 4 a run
    assert splits(1, 4, 16, 100, 900) == 2       # causal end 116
    assert splits(1, 4, 16, 100, 900, causal=False) == 15
    assert splits(1, 1, 1, 0, 64 * 1000, causal=False) == 125   # 8 a run
    assert splits(1, 1, 1, 0, 64 * 1000, causal=False, n_sm=600) == 250
    for kv in (1, 63, 64, 65, 577, 4096):
        n = splits(1, 1, 1, kv - 1, kv)
        per = -(-(-(-kv // 64)) // n)
        assert (n - 1) * per < -(-kv // 64) <= n * per
