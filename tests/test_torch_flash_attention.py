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
"""

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
