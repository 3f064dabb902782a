"""Tensor and data parallelism of the port's LM across 4 gloo ranks on the
CPU, held to the port's one-process run (itself held to `repro` in
tests/test_torch_transformer.py and tests/test_torch_lm_train.py).

One 4-rank group is spawned once for the module (`_dist_ranks`); each
case lays its own (data, model) mesh over it.  fp32 throughout:

* mistral-large-123b's smoke config (6 heads, 2 KV heads, d_ff 224, vocab
  512) on (1, 4) — the 6 heads do not divide 4, so the attention stays
  whole on every rank while the FFN and the vocab split — on (2, 2) —
  3 query heads and 1 KV head a rank, the batch over 2 — and on (4, 1),
  data parallelism alone;
* two head layouts where the KV heads stay whole and the query heads
  split: 8 heads over 2 KV heads on 4 ranks (each rank's 2 query heads
  read one KV head) and 12 over 3 (3 query heads a rank straddle the KV
  heads: one KV head gathered per query head).

Each case: `loss_fn`'s value and every rank's reduced gradient slice
within 1e-5 of the one-process loss and gradient (of each leaf's max), two
`lm_train_step`s' losses likewise and their params within 1e-4 of each
leaf's max, one step repeated giving the same bits; on the meshes without
a data axis, a sharded `Transformer`'s prefill and 4 greedy decode steps,
logits within 1e-5 of max|logit|.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _dist_ranks
from repro_torch.configs import get_arch
from repro_torch.dist.sharding import local_slice, param_specs_lm
from repro_torch.launch.cells import lm_train_step
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import value_and_grad

WORLD = 4
TOL = 1e-5
# Params after AdamW steps: the first step moves each entry by ~lr·g/|g|,
# so an entry whose gradient is near 0 amplifies the gradients' 1e-6 gaps.
PARAM_TOL = 1e-4
SMOKE = get_arch("mistral-large-123b").make_smoke_config()
CASES = {
    "mistral_1x4": (SMOKE, (1, 4)),
    "mistral_2x2": (SMOKE, (2, 2)),
    "mistral_4x1": (SMOKE, (4, 1)),
    "kv_whole_8_2": (dataclasses.replace(SMOKE, name="h8kv2", n_heads=8,
                                         n_kv_heads=2), (1, 4)),
    "kv_gather_12_3": (dataclasses.replace(SMOKE, name="h12kv3", n_heads=12,
                                           n_kv_heads=3), (1, 4)),
}
PROMPT, STEPS = 8, 4


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    return t.detach().numpy()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def inputs():
    out = {}
    for i, (name, (cfg, mesh)) in enumerate(sorted(CASES.items())):
        params = T.init_params(cfg, torch.Generator().manual_seed(i))
        toks = np.random.default_rng(i).integers(0, cfg.vocab, (4, 16))
        out[name] = dict(cfg=cfg, mesh=mesh, params=params,
                         batch={"tokens": toks, "labels": toks})
    return out


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    cases = {name: ("case_lm_step", dict(
        cfg=c["cfg"], params=np_tree(c["params"]), batch=c["batch"],
        mesh_shape=c["mesh"], steps=2, grads=True,
        serve=(c["batch"]["tokens"][:, :PROMPT], STEPS)
        if c["mesh"][0] == 1 else None)) for name, c in inputs.items()}
    cases["meshes"] = ("case_meshes", {})
    return _dist_ranks.run_ranks(_dist_ranks.run_cases, cases, WORLD,
                                 tmp_path_factory.mktemp("ranks_tp"),
                                 timeout=600)


def one_process(c):
    """The one-process loss, gradients, two steps and serve logits."""
    cfg, params = c["cfg"], c["params"]
    batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    loss, grads = value_and_grad(lambda p, b: T.loss_fn(cfg, p, b))(params,
                                                                   batch)
    opt, p, steps = adamw_init(params), params, []
    for _ in range(2):
        p, opt, l = lm_train_step(cfg, p, opt, batch)
        steps.append((float(l), p))
    model = T.Transformer(cfg, params)
    tok = batch["tokens"][:, :PROMPT]
    with torch.no_grad():
        logits, cache = T.prefill(model, tok, T.init_cache(
            cfg, tok.shape[0], PROMPT + STEPS))
        seq = [logits]
        for i in range(STEPS):
            nxt = seq[-1][:, -1].argmax(-1, keepdim=True)
            logits, cache = T.decode_step(model, cache, nxt, PROMPT + i)
            seq.append(logits)
    return float(loss), grads, steps, torch.cat(seq, 1).numpy()


def tree_gap(full, loc, spec, coords, mesh):
    """The largest gap, of each leaf's max, between a rank's slices and the
    full tree's."""
    if isinstance(full, dict):
        return max(tree_gap(full[k], loc[k], spec[k], coords, mesh)
                   for k in full)
    want = local_slice(full.detach(), spec, coords, mesh).numpy()
    return float(np.abs(want - loc).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_matches_one_process(ranks, inputs, name):
    c = inputs[name]
    mesh = MeshShape(c["mesh"], ("data", "model"))
    specs = param_specs_lm(c["cfg"], c["params"], mesh)
    loss, grads, steps, serve = one_process(c)
    for out in ranks:
        o = out[name]
        assert abs(o["loss"] - loss) <= TOL * abs(loss)
        assert tree_gap(grads, o["grads"], specs, o["coords"], mesh) <= TOL
        assert o["repeat_equal"]
        for got_l, got_p, (want_l, want_p) in zip(o["losses"], o["params"],
                                                  steps):
            assert abs(got_l - want_l) <= TOL * abs(want_l)
            assert tree_gap(want_p, got_p, specs, o["coords"],
                            mesh) <= PARAM_TOL
        if "serve" in o:
            assert np.abs(o["serve"] - serve).max() <= \
                TOL * np.abs(serve).max()
            np.testing.assert_array_equal(o["serve"], ranks[0][name]["serve"])


def test_heads_split_as_the_spec_says(inputs):
    """The layouts the cases exercise, from the rules' specs."""
    layer = {name: param_specs_lm(c["cfg"], c["params"], MeshShape(
        c["mesh"], ("data", "model")))["layers"] for name, c in inputs.items()}
    assert layer["mistral_1x4"]["wq"] == (None, None, None, None)
    assert layer["mistral_1x4"]["ffn"]["wi"] == (None, None, "model")
    assert layer["mistral_2x2"]["wq"] == (None, None, "model", None)
    assert layer["mistral_2x2"]["wk"] == (None, None, "model", None)
    for name in ("kv_whole_8_2", "kv_gather_12_3"):
        assert layer[name]["wq"] == (None, None, "model", None)
        assert layer[name]["wk"] == (None, None, None, None)


def test_debug_mesh(ranks):
    for r, out in enumerate(ranks):
        m = out["meshes"]
        assert m["names"] == ("model",) and m["shape"] == (WORLD,)
        assert m["coord"] == [r] or tuple(m["coord"]) == (r,)
        assert "needs 6 ranks, the group has 4" in m["refused"]
