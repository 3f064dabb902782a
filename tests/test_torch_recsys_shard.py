"""SASRec across ranks on the CPU: the port's sharded SASRec
(`recsys_rules`: the users over ``data``, ``item_embed``'s rows over
``model``) held to `repro` and to the port's one-process run.

One spawn for the module (`_dist_ranks`): 4 gloo ranks on a (2, 2) mesh,
then 8 on (2, 4), one torch thread each.  The config is a smoke SASRec of
4,095 items padded to 4,096 rows (64-row padding, so every model rank's
rows split into the 8 catalog slices), d 16, 2 blocks, sequence 12, 8
users (left padding in some), top-10.  `repro`'s side runs its functions
with its identity rules on the same weights (`repro`'s `init_sasrec`,
converted), its top-k as ``jax.lax.top_k`` of its full score matrix and
its train step as ``jax.value_and_grad`` then `adamw_update` (lr 1e-4).

Against `repro` (fp32): user states within 1e-5, the loss within 1e-6
relative, each reduced gradient leaf within 1e-5 of its max, the streamed
top-k values within 1e-5 and ids equal where scores are more than 1e-5
apart, retrieval scores within 1e-5, the params after 2 AdamW steps
within 1e-5 of each leaf's max.

Against the port's one-process run, bit for bit: the states, the top-k
values and ids, the retrieval scores (a foreign row adds exact zeros, and
the one-process products run on the same shapes) and the table's
gradient; two runs of the first step give the same bits on every rank.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_ranks
from repro.models.recsys import SASRecConfig as SASRecConfigJ
from repro.models.recsys import init_sasrec as init_sasrec_j
from repro.models.recsys import sasrec as sj
from repro.train.optimizer import AdamWConfig as AdamWConfigJ
from repro.train.optimizer import adamw_init as adamw_init_j
from repro.train.optimizer import adamw_update as adamw_update_j
from repro_torch.convert import tree_from_numpy
from repro_torch.launch.cells import (recsys_retrieval, recsys_serve_topk,
                                      recsys_train_step)
from repro_torch.models.common import tree_leaves
from repro_torch.models.recsys.sasrec import (SASRec, SASRecConfig,
                                              sasrec_train_loss)
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import value_and_grad

CFG_J = SASRecConfigJ(name="shard-smoke", n_items=4095, embed_dim=16,
                      n_blocks=2, n_heads=1, seq_len=12, d_ff=16,
                      pad_rows=64)
MESHES = {"2x2": (2, 2), "2x4": (2, 4)}
B, K, N_CAT, USER_CHUNK, STEPS, N_CAND = 8, 10, 8, 2, 2, 96
TOL = 1e-5
LOSS_TOL = 1e-6


def port_config(cfg_j) -> SASRecConfig:
    fields = {f.name: getattr(cfg_j, f.name)
              for f in dataclasses.fields(SASRecConfigJ) if f.name != "dtype"}
    return SASRecConfig(**fields, dtype=torch.float32)


CFG = port_config(CFG_J)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    return np.asarray(t)


@pytest.fixture(scope="module")
def inputs():
    params = np_tree(init_sasrec_j(CFG_J, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    S, n = CFG.seq_len, CFG.n_items

    def items():
        return rng.integers(1, n + 1, (B, S)).astype(np.int32)

    seq = items()
    seq[:3, :4] = 0                                   # left padding
    seq[5, :11] = 0
    batch = {"item_seq": seq, "pos_items": items(), "neg_items": items()}
    batch["pos_items"][:2, :3] = 0
    cand = rng.permutation(CFG.table_rows)[:N_CAND].astype(np.int32)
    return dict(params=params, seq=seq, batch=batch, cand=cand)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every rank's results, by mesh name, from one spawn per mesh."""
    out = {}
    for name, shape in MESHES.items():
        case = ("case_recsys", dict(
            cfg=CFG, params=inputs["params"], batch=inputs["batch"],
            seq=inputs["seq"], cand=inputs["cand"], mesh_shape=shape, k=K,
            n_cat_chunks=N_CAT, user_chunk=USER_CHUNK, steps=STEPS))
        got = _dist_ranks.run_ranks(
            _dist_ranks.run_cases, {"r": case}, shape[0] * shape[1],
            tmp_path_factory.mktemp(f"ranks_recsys_{name}"), timeout=600)
        out[name] = [g["r"] for g in got]
    return out


@pytest.fixture(scope="module")
def repro_side(inputs):
    """`repro` on the same weights: states, full scores, retrieval scores,
    loss and gradients, and the params after STEPS AdamW steps."""
    pj = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    seq = jnp.asarray(inputs["seq"])
    bj = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    states = np.asarray(sj.sasrec_user_state(CFG_J, pj, seq))
    full = sj.sasrec_score_candidates(
        CFG_J, pj, seq, jnp.arange(CFG.table_rows, dtype=jnp.int32))
    top_v, top_i = jax.lax.top_k(full, K + 1)
    scores = np.asarray(sj.sasrec_score_candidates(
        CFG_J, pj, seq, jnp.asarray(inputs["cand"])))
    vg = jax.value_and_grad(lambda q: sj.sasrec_train_loss(CFG_J, q, bj))
    loss, grads = vg(pj)
    opt, p, trees = adamw_init_j(pj), pj, []
    for _ in range(STEPS):
        _, g = vg(p)
        p, opt, _ = adamw_update_j(AdamWConfigJ(lr=1e-4), g, opt, p)
        trees.append(np_tree(p))
    return dict(states=states, full=np.asarray(full),
                top=(np.asarray(top_v), np.asarray(top_i)), scores=scores,
                loss=float(loss), grads=np_tree(grads), params=trees)


@pytest.fixture(scope="module")
def one_process(inputs):
    """The port's one-process run on the same weights."""
    params = tree_from_numpy(inputs["params"], device="cpu")
    model = SASRec(CFG, params)
    seq = torch.from_numpy(inputs["seq"])
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    with torch.no_grad():
        states = model.user_state(seq).numpy()
        v, i = recsys_serve_topk(CFG, model, seq, K, N_CAT, USER_CHUNK)
        scores = recsys_retrieval(CFG, model, seq,
                                  torch.from_numpy(inputs["cand"])).numpy()
    loss, grads = value_and_grad(lambda q, b: sasrec_train_loss(
        CFG, q, b))(params, batch)
    return dict(states=states, top=(v.numpy(), i.numpy()), scores=scores,
                loss=float(loss), grads=np_tree(grads))


def users(rk, shape):
    """The rows of the global batch this rank holds."""
    d = rk["coords"]["data"]
    n = B // shape[0]
    return slice(d * n, (d + 1) * n)


def local(full, rk, shape, dim=0):
    """This rank's block of a leaf split over ``model`` along ``dim``."""
    m = rk["coords"]["model"]
    n = full.shape[dim] // shape[1]
    return np.take(full, np.arange(m * n, (m + 1) * n), axis=dim)


def leaf_local(key, full, rk, shape):
    return local(full, rk, shape) if key == "item_embed" else full


def leaf_items(tree, top=None):
    """(key of the top level, leaf) in JAX's order."""
    if isinstance(tree, dict):
        return [it for k in sorted(tree)
                for it in leaf_items(tree[k], top or k)]
    return [(top, tree)]


def gap(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("mesh", MESHES)
def test_states_match_repro_and_one_process(mesh, ranks, repro_side,
                                            one_process):
    for rk in ranks[mesh]:
        rows = users(rk, MESHES[mesh])
        np.testing.assert_allclose(rk["states"], repro_side["states"][rows],
                                   atol=TOL, rtol=0)
        np.testing.assert_array_equal(rk["states"],
                                      one_process["states"][rows])


@pytest.mark.parametrize("mesh", MESHES)
def test_streamed_topk_matches_repro_and_one_process(mesh, ranks,
                                                     repro_side, one_process):
    want_v, want_i = repro_side["top"]
    step = np.abs(np.diff(want_v, axis=1))                # (B, K)
    apart = step > TOL
    apart[:, 1:] &= step[:, :K - 1] > TOL
    assert apart.mean() > 0.5
    for rk in ranks[mesh]:
        rows = users(rk, MESHES[mesh])
        vals, ids = rk["topk"]
        assert vals.shape == ids.shape == (rows.stop - rows.start, K)
        assert (np.diff(vals, axis=1) <= 0).all()         # descending
        np.testing.assert_allclose(vals, want_v[rows, :K], atol=TOL, rtol=0)
        np.testing.assert_allclose(
            np.take_along_axis(repro_side["full"][rows], ids, axis=1), vals,
            atol=TOL, rtol=0)
        np.testing.assert_array_equal(ids[apart[rows]],
                                      want_i[rows, :K][apart[rows]])
        np.testing.assert_array_equal(vals, one_process["top"][0][rows])
        np.testing.assert_array_equal(ids, one_process["top"][1][rows])


@pytest.mark.parametrize("mesh", MESHES)
def test_retrieval_block_matches_repro_and_one_process(mesh, ranks,
                                                       repro_side,
                                                       one_process):
    for rk in ranks[mesh]:
        want = local(repro_side["scores"], rk, MESHES[mesh], dim=1)
        assert rk["scores"].shape == (B, N_CAND // MESHES[mesh][1])
        np.testing.assert_allclose(rk["scores"], want, atol=TOL, rtol=0)
        np.testing.assert_array_equal(
            rk["scores"], local(one_process["scores"], rk, MESHES[mesh],
                                dim=1))


@pytest.mark.parametrize("mesh", MESHES)
def test_loss_and_gradients_match_repro(mesh, ranks, repro_side,
                                        one_process):
    shape = MESHES[mesh]
    want_g = leaf_items(repro_side["grads"])
    for rk in ranks[mesh]:
        assert abs(rk["loss"] - repro_side["loss"]) \
            <= LOSS_TOL * abs(repro_side["loss"])
        got = tree_leaves(rk["grads"])
        assert len(got) == len(want_g)
        for g, (key, want) in zip(got, want_g):
            want = leaf_local(key, want, rk, shape)
            assert g.shape == want.shape, key
            assert gap(g, want) <= TOL, key
        # the table's gradient: the same K5 transposed bags, summed over
        # the data ranks, as the one process sums its users
        np.testing.assert_array_equal(
            rk["grads"]["item_embed"],
            local(one_process["grads"]["item_embed"], rk, shape))


@pytest.mark.parametrize("mesh", MESHES)
def test_train_steps_match_repro(mesh, ranks, repro_side):
    shape = MESHES[mesh]
    for rk in ranks[mesh]:
        assert len(rk["losses"]) == STEPS
        assert abs(rk["losses"][0] - repro_side["loss"]) \
            <= LOSS_TOL * abs(repro_side["loss"])
        for got_tree, want_tree in zip(rk["params"], repro_side["params"]):
            for g, (key, want) in zip(tree_leaves(got_tree),
                                      leaf_items(want_tree)):
                assert gap(g, leaf_local(key, want, rk, shape)) <= TOL, key


@pytest.mark.parametrize("mesh", MESHES)
def test_two_runs_are_bit_identical(mesh, ranks):
    assert all(rk["repeat_equal"] for rk in ranks[mesh])
    # every rank returns the global loss
    assert len({rk["loss"] for rk in ranks[mesh]}) == 1


def test_one_process_train_step_equals_the_unsharded_step(inputs):
    """`recsys_train_step` with the default rules is the one-process step:
    the rules thread changes nothing there."""
    params = tree_from_numpy(inputs["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    a = recsys_train_step(CFG, params, adamw_init(params), batch)
    loss, grads = value_and_grad(lambda q, b: sasrec_train_loss(
        CFG, q, b))(params, batch)
    assert float(a[2]) == float(loss)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(a[0]))
