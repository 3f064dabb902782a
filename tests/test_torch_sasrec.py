"""SASRec serving in repro_torch vs repro, on the CPU.

The port's model is built from `repro.init_sasrec`'s parameters
(`convert.sasrec_params_from_numpy`), so both packages hold the same
weights; both table lookups of the port run K5's plain version here.
Item sequences come from `repro`'s ``recsys_batches`` (Zipf traffic, no
padding) and from left-padded copies of them (each row's first r items set
to the padding item 0, one row all padding), as tests/test_models_recsys.py
pads.  Two configurations: the registry's smoke config, and a narrow one
with two heads and a table that is not a power of two.

Tolerances: user states within 1e-5 (fp32; matmul and softmax round in
another order), candidate scores within 1e-4 (a dot product of 16–24 such
states and rows).  The streamed top-100 (`launch.cells.recsys_serve_topk`)
is held to ``jax.lax.top_k`` of `repro`'s full score matrix over every
table row: values within 1e-5, and ids equal at every rank whose score is
more than 1e-5 from its neighbours' (at a near-tie either order is right;
there the port's id must carry the score it reports).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as get_arch_j
from repro.data.synthetic import recsys_batches as recsys_batches_j
from repro.models.recsys import SASRecConfig as SASRecConfigJ
from repro.models.recsys import init_sasrec as init_sasrec_j
from repro.models.recsys import sasrec_score_candidates as score_j
from repro.models.recsys import sasrec_user_state as user_state_j
from repro_torch.configs import get_arch
from repro_torch.convert import sasrec_params_from_numpy
from repro_torch.data.synthetic import recsys_batches
from repro_torch.kernels.embedding_bag import cuda as eb_cuda
from repro_torch.launch.cells import recsys_retrieval, recsys_serve_topk
from repro_torch.models.recsys import (
    SASRec,
    SASRecConfig,
    init_sasrec,
    sasrec_score_candidates,
    sasrec_user_state,
)

CONFIGS = {
    "smoke": get_arch_j("sasrec").make_smoke_config(),
    "narrow": SASRecConfigJ(name="narrow", n_items=300, embed_dim=24,
                            n_blocks=2, n_heads=2, seq_len=12, d_ff=32,
                            pad_rows=64),
}
STATE_TOL = 1e-5
SCORE_TOL = 1e-4
TOPK_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker keeps the parallel workers from
    oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_config(cfg_j) -> SASRecConfig:
    fields = {f.name: getattr(cfg_j, f.name)
              for f in dataclasses.fields(SASRecConfigJ) if f.name != "dtype"}
    return SASRecConfig(**fields, dtype=torch.float32)


@pytest.fixture(scope="module", params=list(CONFIGS))
def setup(request):
    cfg_j = CONFIGS[request.param]
    params_j = init_sasrec_j(cfg_j, jax.random.PRNGKey(0))
    cfg = port_config(cfg_j)
    model = sasrec_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg, model


def _sequences(cfg_j, B=12, seed=3):
    """Zipf sequences and left-padded copies (row 0 all padding)."""
    seq = np.array(next(recsys_batches_j(B, cfg_j.seq_len, cfg_j.n_items,
                                         seed=seed))["item_seq"])
    padded = seq.copy()
    for r in range(B):
        padded[r, :(r * cfg_j.seq_len) // (B - 1)] = 0
    padded[0] = 0
    return {"zipf": seq, "left_padded": padded}


@pytest.mark.parametrize("kind", ["zipf", "left_padded"])
def test_user_state_matches_repro(setup, kind):
    cfg_j, params_j, cfg, model = setup
    seq = _sequences(cfg_j)[kind]
    got = sasrec_user_state(cfg, model, torch.from_numpy(seq))
    want = np.asarray(user_state_j(cfg_j, params_j, jnp.asarray(seq)))
    assert got.shape == (seq.shape[0], cfg.seq_len, cfg.embed_dim)
    assert bool(torch.isfinite(got).all())      # -1e30, not -inf: no NaN
    np.testing.assert_allclose(got.numpy(), want, atol=STATE_TOL, rtol=0)


def test_padding_positions_and_causality(setup):
    """Masked positions carry no information (all-padding rows agree), and
    a future item does not move past states."""
    cfg_j, _, cfg, model = setup
    seq = torch.from_numpy(_sequences(cfg_j)["zipf"][:2])
    h0 = model.user_state(torch.zeros_like(seq))
    torch.testing.assert_close(h0[0], h0[1], atol=1e-6, rtol=0)
    seq2 = seq.clone()
    seq2[:, -1] = seq2[:, -1] % (cfg.n_items - 1) + 1
    torch.testing.assert_close(model.user_state(seq)[:, :-1],
                               model.user_state(seq2)[:, :-1], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("kind", ["zipf", "left_padded"])
def test_score_candidates_matches_repro(setup, kind):
    cfg_j, params_j, cfg, model = setup
    seq = _sequences(cfg_j, B=4)[kind]
    cand = np.random.default_rng(1).permutation(
        np.arange(1, cfg.n_items + 1)).astype(np.int32)
    got = sasrec_score_candidates(cfg, model, torch.from_numpy(seq),
                                  torch.from_numpy(cand))
    want = np.asarray(score_j(cfg_j, params_j, jnp.asarray(seq),
                              jnp.asarray(cand)))
    assert got.shape == (4, cand.size)
    np.testing.assert_allclose(got.numpy(), want, atol=SCORE_TOL, rtol=0)
    torch.testing.assert_close(
        recsys_retrieval(cfg, model, torch.from_numpy(seq),
                         torch.from_numpy(cand)), got, atol=0, rtol=0)


@pytest.mark.parametrize("B,user_chunk", [(12, 8192), (12, 5)])
def test_serve_topk_matches_repro_top_k(setup, B, user_chunk):
    """The streamed top-100 (64 catalog slices; users in chunks) against
    ``jax.lax.top_k`` of repro's (B, table_rows) score matrix."""
    cfg_j, params_j, cfg, model = setup
    k = 100
    seq = _sequences(cfg_j, B=B)["left_padded"]
    vals, ids = recsys_serve_topk(cfg, model, torch.from_numpy(seq), k=k,
                                  user_chunk=user_chunk)
    full = score_j(cfg_j, params_j, jnp.asarray(seq),
                   jnp.arange(cfg.table_rows, dtype=jnp.int32))
    want_v, want_i = jax.lax.top_k(full, k + 1)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    full = np.asarray(full)
    vals, ids = vals.numpy(), ids.numpy()
    assert vals.shape == ids.shape == (B, k)
    assert (np.diff(vals, axis=1) <= 0).all()            # descending
    np.testing.assert_allclose(vals, want_v[:, :k], atol=TOPK_TOL, rtol=0)
    # every id carries the score reported beside it
    np.testing.assert_allclose(np.take_along_axis(full, ids, axis=1), vals,
                               atol=TOPK_TOL, rtol=0)
    gap = np.abs(np.diff(want_v, axis=1))                # (B, k)
    apart = np.ones((B, k), bool)
    apart[:, :] &= gap > TOPK_TOL                        # from the next rank
    apart[:, 1:] &= gap[:, :k - 1] > TOPK_TOL            # from the previous
    assert apart.mean() > 0.5
    np.testing.assert_array_equal(ids[apart], want_i[:, :k][apart])


def test_recsys_batches_identical_to_repro():
    for seed in (0, 7):
        mine = recsys_batches(6, 9, 1000, seed=seed)
        theirs = recsys_batches_j(6, 9, 1000, seed=seed)
        for _ in range(2):
            a, b = next(mine), next(theirs)
            assert set(a) == set(b)
            for key in a:
                assert a[key].dtype == torch.int32
                np.testing.assert_array_equal(a[key].numpy(),
                                              np.asarray(b[key]))


@pytest.mark.parametrize("make", ["make_config", "make_smoke_config"])
def test_registry_sasrec_matches_repro(make):
    want = getattr(get_arch_j("sasrec"), make)()
    got = getattr(get_arch("sasrec"), make)()
    assert got == port_config(want)
    assert got.table_rows == want.table_rows
    assert got.n_params() == want.n_params()
    arch, arch_j = get_arch("sasrec"), get_arch_j("sasrec")
    assert (arch.family, arch.source) == (arch_j.family, arch_j.source)
    assert {n: (c.kind, c.meta) for n, c in arch.shapes.items()} == \
        {n: (c.kind, c.meta) for n, c in arch_j.shapes.items()}


def test_full_config_widths():
    cfg = get_arch("sasrec").make_config()
    assert cfg.table_rows == 1_000_448
    assert cfg.table_rows * cfg.embed_dim * 4 == 200_089_600


def test_init_matches_repro_tree_shapes():
    cfg_j = CONFIGS["narrow"]
    cfg = port_config(cfg_j)
    params = init_sasrec(cfg, torch.Generator().manual_seed(0))
    params_j = init_sasrec_j(cfg_j, jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), params_j)
    assert {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                if isinstance(v, dict) else tuple(v.shape))
            for k, v in params.items()} == shapes
    model = SASRec(cfg, params)
    # repro's n_params leaves out the final LayerNorm's 2·d
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.n_params() + 2 * cfg.embed_dim
    torch.testing.assert_close(params["item_embed"].std().item(),
                               1 / np.sqrt(cfg.embed_dim), atol=2e-3, rtol=0)


def test_plain_lookup_on_the_cpu(setup):
    """Both lookups take K5's plain version on the CPU: no launch, and the
    ``"ref"`` dispatch gives the same states."""
    cfg_j, _, _, model = setup
    seq = torch.from_numpy(_sequences(cfg_j, B=3)["zipf"])
    before = eb_cuda.LAUNCHES
    auto = model.user_state(seq)
    model.bag_prefer = "ref"
    try:
        assert torch.equal(model.user_state(seq), auto)
    finally:
        model.bag_prefer = "auto"
    assert eb_cuda.LAUNCHES == before
