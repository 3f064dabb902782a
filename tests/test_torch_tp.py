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

Each case runs under `lm_rules`, sequence parallel (the residual stream
split over ``model`` between blocks, S = 16): `loss_fn`'s value and every
rank's reduced gradient slice within 1e-5 of the one-process loss and
gradient (of each leaf's max), and of ``seq_shard=False``'s and of
`repro`'s under ``lm_rules(seq_shard=True)`` on 4 forced host devices
(`repro` runs in a subprocess beside the ranks); two `lm_train_step`s'
losses likewise and their params within 1e-4 of each leaf's max, one step
repeated giving the same bits; on the meshes without a data axis, a
sharded `Transformer`'s prefill and 4 greedy decode steps, logits within
1e-5 of max|logit|.  Each rank's residual stream holds S / 4 rows between
blocks on (1, 4).

The pjit MoE layer (`repro`'s default dispatch, capacity from the global
token count) on (2, 2) at capacity factor 1.0, where entries drop: within
2e-4 of max|y| of `repro`'s ``moe_apply`` under ``lm_rules`` and of the
port's one process, in both token layouts; the per-rank capacity of
expert parallelism on the same blocks (the control) misses that gate.
With 5 experts, which do not split over ``model``, every rank runs all of
them while the shared experts split: within 2e-4 of the one process.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _dist_ranks
from repro_torch.configs import get_arch
from repro_torch.dist.sharding import Spec, local_slice, param_specs_lm
from repro_torch.launch.cells import lm_train_step
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import transformer as T
from repro_torch.models.moe import MoEConfig, init_moe, moe_apply
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import value_and_grad

REPO = Path(__file__).resolve().parents[1]
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
MOE = dict(n_experts=8, top_k=2, n_shared=1, d_ff_expert=16,
           capacity_factor=1.0)
MOE_MESH = (2, 2)
MOE_X = (4, 128, 32)
MOE_TOL = 2e-4            # of max|y|: repro's EP gate
X_SPECS = {"batch": ("data", None, None), "batch_seq": ("data", "model", None)}

_REPRO = r"""
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_arch
from repro.dist.sharding import lm_rules
from repro.models.common import NO_SHARD
from repro.models.moe import MoEConfig, moe_apply
from repro.models.transformer import loss_fn

z = np.load(IN)
def unflat(prefix):
    tree = {}
    for key in z.files:
        if key.startswith(prefix + "/"):
            node, parts = tree, key[len(prefix) + 1:].split("/")
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = jnp.asarray(z[key])
    return tree

def flat(tree, prefix):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}

def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

smoke = get_arch("mistral-large-123b").make_smoke_config()
out = {}
for name, (kw, shape) in CASES.items():
    cfg = dataclasses.replace(smoke, **kw)
    mesh = mesh_of(shape)
    toks = jnp.asarray(z[name + "/tokens"])
    with jax.set_mesh(mesh):
        loss, g = jax.jit(jax.value_and_grad(lambda q: loss_fn(
            cfg, q, {"tokens": toks, "labels": toks},
            lm_rules(mesh, seq_shard=True))))(unflat(name + "/params"))
    out[name + "/loss"] = np.asarray(loss)
    out.update(flat(g, name + "/grads"))
moe = MoEConfig(**MOE)
p, x = unflat("moe"), jnp.asarray(z["moe_x"])
mesh = mesh_of(MOE_MESH)
out["moe/oracle"] = np.asarray(moe_apply(moe, p, x, NO_SHARD, jnp.float32))
with jax.set_mesh(mesh):
    out["moe/pjit"] = np.asarray(jax.jit(lambda xx, pp: moe_apply(
        moe, pp, xx, lm_rules(mesh), jnp.float32))(x, p))
np.savez(OUT, **out)
print("OK")
"""


def flat(tree, prefix):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree.detach().numpy() if isinstance(tree, torch.Tensor)
            else tree}


def case_fields(cfg):
    """The config fields a case changes of mistral's smoke config."""
    return {f: getattr(cfg, f) for f in ("name", "n_heads", "n_kv_heads")}


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
def moe_inputs():
    """The pjit layer's config, weights and tokens (B, S, d), drawn by the
    port from seeds."""
    cfg = T.LMConfig(name="moe-layer", n_layers=1, d_model=MOE_X[2],
                     n_heads=4, n_kv_heads=4, d_head=8, d_ff=64, vocab=128,
                     dtype=torch.float32, moe=MoEConfig(**MOE))
    p = init_moe(cfg.moe, MOE_X[2], torch.Generator().manual_seed(5),
                 torch.float32)
    x = np.random.default_rng(6).normal(size=MOE_X).astype(np.float32)
    return dict(cfg=cfg, p=np_tree(p), x=x)


def whole_experts(moe_inputs):
    """The layer with 5 experts (whole on every rank of ``model`` = 2) and
    its shared experts split."""
    cfg = moe_inputs["cfg"]
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           n_experts=5))
    p = init_moe(cfg.moe, MOE_X[2], torch.Generator().manual_seed(7),
                 torch.float32)
    return dict(cfg=cfg, p=np_tree(p))


@pytest.fixture(scope="module")
def repro_run(inputs, moe_inputs, tmp_path_factory):
    """`repro`'s side, started in its own process (4 forced host devices)
    while the ranks run."""
    d = tmp_path_factory.mktemp("repro_tp")
    arrays = dict(moe_x=moe_inputs["x"], **flat(moe_inputs["p"], "moe"))
    for name, c in inputs.items():
        arrays.update(flat(c["params"], name + "/params"))
        arrays[name + "/tokens"] = c["batch"]["tokens"]
    np.savez(d / "in.npz", **arrays)
    cases = {name: (case_fields(cfg), mesh)
             for name, (cfg, mesh) in CASES.items()}
    code = (f"IN = {str(d / 'in.npz')!r}\nOUT = {str(d / 'out.npz')!r}\n"
            f"CASES = {cases!r}\nMOE = {MOE!r}\nMOE_MESH = {MOE_MESH!r}\n"
            + _REPRO)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, d / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def repro_out(repro_run, ranks):
    proc, path = repro_run
    out, err = proc.communicate(timeout=420)
    assert proc.returncode == 0 and "OK" in out, f"{out}\n{err}"
    return np.load(path)


@pytest.fixture(scope="module")
def ranks(inputs, moe_inputs, repro_run, tmp_path_factory):
    cases = {name: ("case_lm_step", dict(
        cfg=c["cfg"], params=np_tree(c["params"]), batch=c["batch"],
        mesh_shape=c["mesh"], steps=2, grads=True,
        serve=(c["batch"]["tokens"][:, :PROMPT], STEPS)
        if c["mesh"][0] == 1 else None)) for name, c in inputs.items()}
    cases["meshes"] = ("case_meshes", {})
    cases["moe_pjit"] = ("case_moe_pjit", dict(
        cfg=moe_inputs["cfg"], params=moe_inputs["p"], x=moe_inputs["x"],
        x_specs=X_SPECS, mesh_shape=MOE_MESH))
    whole = whole_experts(moe_inputs)
    cases["moe_pjit_whole"] = ("case_moe_pjit", dict(
        cfg=whole["cfg"], params=whole["p"], x=moe_inputs["x"],
        x_specs=X_SPECS, mesh_shape=MOE_MESH, control=False))
    c = inputs["mistral_1x4"]
    cases["stream"] = ("case_stream_rows", dict(
        cfg=c["cfg"], params=np_tree(c["params"]),
        tokens=c["batch"]["tokens"], mesh_shape=c["mesh"]))
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


def leaf_gaps(got, want, spec, coords, mesh):
    """Each leaf's gap, of its max, between a rank's slices and a full
    NumPy tree's (or another rank tree's, when ``spec`` is None)."""
    if isinstance(want, dict):
        return {f"{k}/{kk}": v for k in want for kk, v in leaf_gaps(
            got[k], want[k], None if spec is None else spec[k], coords,
            mesh).items()}
    if spec is not None:
        want = local_slice(torch.from_numpy(np.asarray(want)), spec, coords,
                           mesh).numpy()
    return {"": float(np.abs(got - want).max()
                      / max(np.abs(want).max(), 1e-30))}


def repro_tree(repro_out, prefix):
    tree = {}
    for key in repro_out.files:
        if key.startswith(prefix + "/"):
            node, parts = tree, key[len(prefix) + 1:].split("/")
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = repro_out[key]
    return tree


@pytest.mark.parametrize("name", sorted(CASES))
def test_sp_matches_nosp_and_repro(ranks, inputs, repro_out, name):
    """Sequence parallelism changes no result: the loss and every gradient
    leaf under ``seq_shard=True`` against ``seq_shard=False``'s and
    `repro`'s SP step on the same mesh."""
    c = inputs[name]
    mesh = MeshShape(c["mesh"], ("data", "model"))
    specs = param_specs_lm(c["cfg"], c["params"], mesh)
    want_loss = float(repro_out[name + "/loss"])
    want = repro_tree(repro_out, name + "/grads")
    for out in ranks:
        o = out[name]
        assert abs(o["loss"] - o["nosp_loss"]) <= TOL * abs(o["loss"])
        assert abs(o["loss"] - want_loss) <= TOL * abs(want_loss)
        gaps = leaf_gaps(o["grads"], o["nosp_grads"], None, None, None)
        assert max(gaps.values()) <= PARAM_TOL, gaps
        gaps = leaf_gaps(o["grads"], want, specs, o["coords"], mesh)
        assert max(gaps.values()) <= PARAM_TOL, gaps


def assemble(ranks, name, field, case="moe_pjit"):
    """The full (B, S, d) array from every rank's block under
    ``X_SPECS[name]``."""
    mesh = MeshShape(MOE_MESH, ("data", "model"))
    full = np.full(MOE_X, np.nan, np.float32)
    spec = Spec(*X_SPECS[name])
    for out in ranks:
        o = out[case]
        view = local_slice(torch.from_numpy(full), spec, o["coords"], mesh)
        view.copy_(torch.from_numpy(o[field][name]))
    assert not np.isnan(full).any()
    return full


def moe_one_process(moe_inputs):
    """The port's one-process layer on the global batch."""
    p = {k: torch.from_numpy(v) for k, v in moe_inputs["p"].items()}
    with torch.no_grad():
        return moe_apply(moe_inputs["cfg"].moe, p,
                         torch.from_numpy(moe_inputs["x"]),
                         torch.float32).numpy()


@pytest.mark.parametrize("name", sorted(X_SPECS))
def test_moe_pjit_matches_repro_and_one_process(ranks, repro_out,
                                                moe_inputs, name):
    y = assemble(ranks, name, "y")
    one = moe_one_process(moe_inputs)
    scale = np.abs(one).max()
    assert np.abs(y - one).max() <= MOE_TOL * scale
    assert np.abs(y - repro_out["moe/pjit"]).max() <= MOE_TOL * scale
    assert np.abs(one - repro_out["moe/oracle"]).max() <= MOE_TOL * scale
    # entries drop at this capacity: the no-drop layer is far from it
    cfg = dataclasses.replace(MoEConfig(**MOE), capacity_factor=8.0)
    p = {k: torch.from_numpy(v) for k, v in moe_inputs["p"].items()}
    with torch.no_grad():
        no_drop = moe_apply(cfg, p, torch.from_numpy(moe_inputs["x"]),
                            torch.float32).numpy()
    assert np.abs(no_drop - one).max() > 1e-2


@pytest.mark.parametrize("name", sorted(X_SPECS))
def test_moe_per_rank_capacity_misses(ranks, moe_inputs, name):
    """The control: expert parallelism's per-rank capacity on the same
    blocks keeps other tokens."""
    one = moe_one_process(moe_inputs)
    ctrl = assemble(ranks, name, "control")
    assert np.abs(ctrl - one).max() > MOE_TOL * np.abs(one).max()


@pytest.mark.parametrize("name", sorted(X_SPECS))
def test_moe_pjit_whole_experts_matches_one_process(ranks, moe_inputs, name):
    whole = dict(whole_experts(moe_inputs), x=moe_inputs["x"])
    y = assemble(ranks, name, "y", case="moe_pjit_whole")
    one = moe_one_process(whole)
    assert np.abs(y - one).max() <= MOE_TOL * np.abs(one).max()


def test_stream_holds_its_slice_between_blocks(ranks, inputs):
    c = inputs["mistral_1x4"]
    S, M, L = c["batch"]["tokens"].shape[1], c["mesh"][1], c["cfg"].n_layers
    for out in ranks:
        rows = out["stream"]
        assert rows["train"] == rows["prefill"] == [S // M] * 2 * L
        assert rows["train_nosp"] == [S] * 2 * L
        assert rows["decode"] == [1] * 2 * L
