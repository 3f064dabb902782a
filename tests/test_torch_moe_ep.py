"""Expert parallelism, the sharded train step and the elastic reshard of
the port across 8 gloo ranks on the CPU, held to `repro` on 8 forced host
devices.

One 8-rank group is spawned once for the module (`_dist_ranks`); `repro`
runs once in a subprocess on 8 forced host devices, started before the
ranks and running beside them.  Both take the same weights and tokens,
drawn by the port from seeds.

* EP: the port's `moe_apply_shardmap` on a (2, 4) mesh of ranks against
  `repro`'s under ``shard_map`` with both of `repro`'s token layouts
  (``P("data", None, None)``: every model rank routes the same tokens;
  ``P("data", "model", None)``: each its slice of the sequence), the same
  weights: at capacity factor 8 within 2e-4 of the one-device oracle
  (`repro`'s gate), at 1.0, where tokens drop, within 1e-5 of `repro`'s
  EP.
* The train step (``impl="shardmap"``, `repro`'s
  ``test_lm_train_step_shardmap_moe_runs`` config) on 2 × 4: the loss
  within 2e-3 of `repro`'s on that mesh and within 1e-5 of the port's one
  process, over two steps; every rank's params after each step equal to
  the one-process step's slices within 1e-5 of each leaf's max; one
  step run twice gives the same bits.
* The pjit MoE (``impl="pjit"``, `repro`'s default: GSPMD's sorted
  dispatch, the capacity from the global token count) on the same mesh,
  inputs and weights, with the expert weights placed by `lm_rules`
  (experts over ``model``, their ``d`` over ``data``), in both token
  layouts (the second is the residual stream under sequence
  parallelism): within 2e-4 of max|y| of `repro`'s ``moe_apply`` under
  ``lm_rules`` on 8 forced devices and of the port's one-process
  `moe_apply` on the global batch, at capacity factor 8 and at 1.0, where
  entries drop; at 1.0 the per-rank capacity of expert parallelism on the
  same blocks (the control) misses that gate.
* Sequence parallelism: the loss and every reduced gradient leaf of the
  shardmap and the pjit MoE LMs under ``lm_rules(seq_shard=True)`` within
  1e-5 relative / 1e-4 of the leaf's max of ``seq_shard=False``'s and of
  `repro`'s under ``lm_rules(seq_shard=True)``; the pjit step's params
  within 1e-5 of each leaf's max of the one-process step's; the residual
  stream holds S / model rows on each rank between blocks.
* Reshard: a tree placed on 4 data shards (a (4, 2) mesh), gathered and
  saved, restored onto 8 (an (8, 1) mesh) bit for bit.
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
from repro_torch.dist.sharding import Spec, local_slice, param_specs_lm
from repro_torch.launch.cells import lm_train_step
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import transformer as T
from repro_torch.models.moe import MoEConfig, init_moe, moe_apply
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import value_and_grad

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
MESH = (2, 4)
MOE = dict(n_experts=8, top_k=2, n_shared=1, d_ff_expert=16)
D = 32
SEQ = 512          # enough tokens a rank that capacity factor 1.0 drops
PSPEC = {"router": (), "wi": ("model", None, None),
         "wg": ("model", None, None), "wo": ("model", None, None),
         "shared_wi": (None, "model"), "shared_wg": (None, "model"),
         "shared_wo": ("model", None)}
X_SPECS = {"batch": ("data", None, None), "batch_seq": ("data", "model", None)}
CAPS = (8.0, 1.0)
MOE_TOL = 2e-4            # of max|y|: repro's EP gate
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4

_REPRO = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.models.moe import MoEConfig, moe_apply, moe_apply_shardmap
from repro.models.common import NO_SHARD
from repro.models.transformer import LMConfig, loss_fn
from repro.dist.sharding import lm_rules
import dataclasses

def flat(tree, prefix):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}

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

out = {}
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
pspec = {"router": P(), "wi": P("model", None, None), "wg": P("model", None, None),
         "wo": P("model", None, None), "shared_wi": P(None, "model"),
         "shared_wg": P(None, "model"), "shared_wo": P("model", None)}
p, x = unflat("p"), jnp.asarray(z["x"])
for cf in CAPS:
    moe = MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=16,
                    capacity_factor=cf)
    out[f"oracle/{cf}"] = np.asarray(moe_apply(moe, p, x, NO_SHARD, jnp.float32))
    def body(xl, pl):
        return moe_apply_shardmap(moe, pl, xl, data_axes="data",
                                  model_axis="model", dtype=jnp.float32)
    with jax.set_mesh(mesh):
        for name, spec in (("batch", P("data", None, None)),
                           ("batch_seq", P("data", "model", None))):
            f = jax.jit(jax.shard_map(body, mesh=mesh, check_vma=False,
                        in_specs=(spec, pspec), out_specs=spec))
            out[f"ep/{cf}/{name}"] = np.asarray(f(x, p))
        out[f"pjit/{cf}"] = np.asarray(jax.jit(lambda xx, pp: moe_apply(
            moe, pp, xx, lm_rules(mesh), jnp.float32))(x, p))

cfg = LMConfig(name="moe-sm", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
               d_head=8, d_ff=64, vocab=128, dtype=jnp.float32,
               moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=16,
                             capacity_factor=4.0, impl="shardmap"))
toks = jnp.asarray(z["tokens"])
for key, c in (("", cfg), ("pjit_", dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, impl="pjit")))):
    with jax.set_mesh(mesh):
        loss, g = jax.jit(jax.value_and_grad(lambda q: loss_fn(
            c, q, {"tokens": toks, "labels": toks},
            lm_rules(mesh, seq_shard=True))))(unflat("params"))
    out[key + "loss"] = np.asarray(loss)
    out.update(flat(g, key + "grads"))
np.savez(OUT, **out)
print("OK")
"""

SAVE, LOAD = (4, 2), (8, 1)
RESHARD_SPEC = {"w": ("data", None), "b": (None,), "e": (None, "data", None)}


def flat(tree, prefix):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree.detach().numpy() if isinstance(tree, torch.Tensor)
            else tree}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def inputs():
    """The weights and tokens, drawn by the port from seeds, that both
    packages take."""
    cfg = T.LMConfig(name="moe-sm", n_layers=2, d_model=32, n_heads=4,
                     n_kv_heads=4, d_head=8, d_ff=64, vocab=128,
                     dtype=torch.float32,
                     moe=MoEConfig(**MOE, capacity_factor=4.0,
                                   impl="shardmap"))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (4, 16))
    return dict(
        p=flat(init_moe(MoEConfig(**MOE), D, torch.Generator().manual_seed(0),
                        torch.float32), "p"),
        x=rng.normal(size=(4, SEQ, D)).astype(np.float32),
        cfg=cfg, params=T.init_params(cfg, torch.Generator().manual_seed(2)),
        batch={"tokens": toks, "labels": toks})


@pytest.fixture(scope="module")
def repro_run(inputs, tmp_path_factory):
    """`repro`'s side, started in its own process (8 forced host devices)
    while the ranks run."""
    d = tmp_path_factory.mktemp("repro_ep")
    np.savez(d / "in.npz", x=inputs["x"], tokens=inputs["batch"]["tokens"],
             **inputs["p"], **flat(inputs["params"], "params"))
    code = (f"IN = {str(d / 'in.npz')!r}\nOUT = {str(d / 'out.npz')!r}\n"
            f"CAPS = {CAPS!r}\n" + _REPRO)
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
def ranks(repro_run, inputs, reshard_tree, tmp_path_factory):
    params = {k[2:]: v for k, v in inputs["p"].items()}
    cases = {f"ep/{cf}": ("case_moe_ep", dict(
        moe_kw=dict(MOE, capacity_factor=cf), params=params,
        x=inputs["x"], pspec=PSPEC, x_specs=X_SPECS, mesh_shape=MESH))
        for cf in CAPS}
    cases.update({f"pjit/{cf}": ("case_moe_pjit", dict(
        cfg=moe_layer_config(cf), params=params, x=inputs["x"],
        x_specs=X_SPECS, mesh_shape=MESH)) for cf in CAPS})
    cases["step"] = ("case_lm_step", dict(
        cfg=inputs["cfg"], params=np_tree(inputs["params"]),
        batch=inputs["batch"], mesh_shape=MESH, steps=2, grads=True))
    cases["step_pjit"] = ("case_lm_step", dict(
        cfg=pjit_config(inputs["cfg"]), params=np_tree(inputs["params"]),
        batch=inputs["batch"], mesh_shape=MESH, steps=1, grads=True))
    cases["stream"] = ("case_stream_rows", dict(
        cfg=inputs["cfg"], params=np_tree(inputs["params"]),
        tokens=inputs["batch"]["tokens"], mesh_shape=MESH))
    ck = tmp_path_factory.mktemp("reshard_ckpt")
    cases["reshard"] = ("case_reshard", dict(
        tree=reshard_tree, save_shape=SAVE, load_shape=LOAD,
        spec=RESHARD_SPEC, workdir=str(ck)))
    return _dist_ranks.run_ranks(_dist_ranks.run_cases, cases, WORLD,
                                 tmp_path_factory.mktemp("ranks_ep"),
                                 timeout=600)


@pytest.fixture(scope="module")
def repro_out(repro_run, ranks):
    proc, path = repro_run
    out, err = proc.communicate(timeout=420)
    assert proc.returncode == 0 and "OK" in out, f"{out}\n{err}"
    return np.load(path)


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    return t.detach().numpy()


def moe_layer_config(cf):
    """A one-layer LM config around ``MOE`` at capacity factor ``cf``, fp32:
    what `_moe_pjit_block` reads of it."""
    return T.LMConfig(name="moe-layer", n_layers=1, d_model=D, n_heads=4,
                      n_kv_heads=4, d_head=8, d_ff=64, vocab=128,
                      dtype=torch.float32,
                      moe=MoEConfig(**MOE, capacity_factor=cf))


def pjit_config(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl="pjit"))


@pytest.fixture(scope="module")
def reshard_tree():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(16, 5)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "e": rng.normal(size=(3, 8, 2)).astype(np.float32)}


def assemble(ranks, key, name, shape, field="y"):
    """The full array from every rank's block under ``X_SPECS[name]``."""
    mesh = MeshShape(MESH, ("data", "model"))
    full = np.full(shape, np.nan, np.float32)
    spec = Spec(*X_SPECS[name])
    for out in ranks:
        o = out[key]
        view = local_slice(torch.from_numpy(full), spec, o["coords"], mesh)
        if not np.isnan(view.numpy()).all():
            np.testing.assert_array_equal(view.numpy(), o[field][name])
        view.copy_(torch.from_numpy(o[field][name]))
    return full


@pytest.mark.parametrize("name", sorted(X_SPECS))
@pytest.mark.parametrize("cf", CAPS)
def test_ep_matches_repro(ranks, repro_out, inputs, cf, name):
    x = inputs["x"]
    y = assemble(ranks, f"ep/{cf}", name, x.shape)
    assert not np.isnan(y).any()
    ep_j = repro_out[f"ep/{cf}/{name}"]
    oracle = repro_out[f"oracle/{cf}"]
    if cf >= 8.0:                    # nothing drops: the one-device oracle
        assert np.abs(y - oracle).max() < 2e-4
        assert np.abs(ep_j - oracle).max() < 2e-4
    else:                            # tokens drop where repro drops them
        assert np.abs(ep_j - repro_out["oracle/8.0"]).max() > 1e-2
    assert np.abs(y - ep_j).max() < 1e-5


def test_ep_matches_port_one_process(repro_out, inputs):
    """On one process the port's `moe_apply` is the oracle too."""
    moe = MoEConfig(**MOE, capacity_factor=8.0)
    p = {k[2:]: torch.from_numpy(v) for k, v in inputs["p"].items()}
    y = moe_apply(moe, p, torch.from_numpy(inputs["x"]), torch.float32)
    assert np.abs(y.numpy() - repro_out["oracle/8.0"]).max() < 1e-5


def test_train_step_shardmap(ranks, repro_out, inputs):
    cfg, params = inputs["cfg"], inputs["params"]
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    one = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl="pjit"))
    mesh = MeshShape(MESH, ("data", "model"))
    specs = param_specs_lm(cfg, params, mesh)
    opt = adamw_init(params)
    want_losses, want_params = [], []
    for _ in range(2):
        params, opt, loss = lm_train_step(one, params, opt, batch)
        want_losses.append(float(loss))
        want_params.append(params)
    assert abs(want_losses[0] - float(repro_out["loss"])) < 2e-3
    assert len({tuple(o["step"]["losses"]) for o in ranks}) == 1
    for o in ranks:
        s = o["step"]
        assert s["repeat_equal"]
        assert abs(s["losses"][0] - float(repro_out["loss"])) < 2e-3
        for got, want in zip(s["losses"], want_losses):
            assert abs(got - want) < 1e-5 * abs(want)
        for got, want in zip(s["params"], want_params):
            assert tree_gap(want, got, specs, s["coords"], mesh) < 1e-5


def tree_gap(full, loc, spec, coords, mesh):
    """The largest gap, of each leaf's max, between a rank's slices and the
    full tree's."""
    if isinstance(full, dict):
        return max(tree_gap(full[k], loc[k], spec[k], coords, mesh)
                   for k in full)
    want = local_slice(full, spec, coords, mesh).numpy()
    return float(np.abs(want - loc).max() / np.abs(want).max())


def test_reshard_4_to_8(ranks, reshard_tree):
    save = MeshShape(SAVE, ("data", "model"))
    load = MeshShape(LOAD, ("data", "model"))
    for r, o in enumerate(ranks):
        out = o["reshard"]
        assert out["step"] == 7
        for k, v in reshard_tree.items():
            want = local_slice(torch.from_numpy(v), Spec(*RESHARD_SPEC[k]),
                               out["coords"], load).numpy()
            assert out["back"][k].tobytes() == want.tobytes(), (r, k)
            placed = local_slice(torch.from_numpy(v),
                                 Spec(*RESHARD_SPEC[k]),
                                 dict(data=r // SAVE[1], model=r % SAVE[1]),
                                 save).numpy()
            assert out["placed"][k].tobytes() == placed.tobytes(), (r, k)
    assert ranks[0]["reshard"]["back"]["w"].shape == (2, 5)
    assert ranks[0]["reshard"]["placed"]["w"].shape == (4, 5)


def port_one_process(inputs, cf):
    moe = MoEConfig(**MOE, capacity_factor=cf)
    p = {k[2:]: torch.from_numpy(v) for k, v in inputs["p"].items()}
    with torch.no_grad():
        return moe_apply(moe, p, torch.from_numpy(inputs["x"]),
                         torch.float32).numpy()


@pytest.mark.parametrize("name", sorted(X_SPECS))
@pytest.mark.parametrize("cf", CAPS)
def test_pjit_matches_repro_and_one_process(ranks, repro_out, inputs, cf,
                                            name):
    """The pjit layer across 8 ranks is `repro`'s GSPMD layer and the
    port's one process on the global batch, drops included."""
    y = assemble(ranks, f"pjit/{cf}", name, inputs["x"].shape)
    one = port_one_process(inputs, cf)
    scale = np.abs(one).max()
    assert np.abs(y - one).max() <= MOE_TOL * scale
    assert np.abs(y - repro_out[f"pjit/{cf}"]).max() <= MOE_TOL * scale
    assert np.abs(repro_out[f"pjit/{cf}"]
                  - repro_out[f"oracle/{cf}"]).max() <= MOE_TOL * scale
    if cf < 8.0:                     # entries drop at this capacity
        assert np.abs(one - port_one_process(inputs, 8.0)).max() > 1e-2


@pytest.mark.parametrize("name", sorted(X_SPECS))
def test_pjit_per_rank_capacity_misses(ranks, inputs, name):
    """The control: expert parallelism's per-rank capacity keeps other
    tokens than the global capacity on the same blocks."""
    ctrl = assemble(ranks, "pjit/1.0", name, inputs["x"].shape,
                    field="control")
    one = port_one_process(inputs, 1.0)
    assert np.abs(ctrl - one).max() > MOE_TOL * np.abs(one).max()


def leaf_gaps(got, want, spec, coords, mesh):
    """Each leaf's gap, of its max, between a rank's slices and a full
    tree's (or another rank tree's, when ``spec`` is None)."""
    if isinstance(want, dict):
        return {f"{k}/{kk}": v for k in want for kk, v in leaf_gaps(
            got[k], want[k], None if spec is None else spec[k], coords,
            mesh).items()}
    want = np.asarray(want)
    if spec is not None:
        want = local_slice(torch.from_numpy(want), spec, coords,
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


@pytest.mark.parametrize("case", ["step", "step_pjit"])
def test_sp_grads_match_nosp_and_repro(ranks, repro_out, inputs, case):
    """Sequence parallelism changes no result: loss and gradients under
    ``seq_shard=True`` against ``seq_shard=False`` and `repro`'s SP
    step."""
    mesh = MeshShape(MESH, ("data", "model"))
    specs = param_specs_lm(inputs["cfg"], inputs["params"], mesh)
    key = "" if case == "step" else "pjit_"
    want_loss = float(repro_out[key + "loss"])
    want = repro_tree(repro_out, key + "grads")
    for o in ranks:
        s = o[case]
        assert abs(s["loss"] - s["nosp_loss"]) <= LOSS_TOL * abs(s["loss"])
        assert abs(s["loss"] - want_loss) <= LOSS_TOL * abs(want_loss)
        gaps = leaf_gaps(s["grads"], s["nosp_grads"], None, None, None)
        assert max(gaps.values()) <= GRAD_TOL, gaps
        gaps = leaf_gaps(s["grads"], want, specs, s["coords"], mesh)
        assert max(gaps.values()) <= GRAD_TOL, gaps


def test_pjit_train_step_matches_one_process(ranks, inputs):
    cfg = pjit_config(inputs["cfg"])
    params = inputs["params"]
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    loss, grads = value_and_grad(lambda p, b: T.loss_fn(cfg, p, b))(params,
                                                                   batch)
    new, _, step_loss = lm_train_step(cfg, params, adamw_init(params), batch)
    mesh = MeshShape(MESH, ("data", "model"))
    specs = param_specs_lm(cfg, params, mesh)
    for o in ranks:
        s = o["step_pjit"]
        assert abs(s["loss"] - float(loss)) <= LOSS_TOL * abs(float(loss))
        assert max(leaf_gaps(s["grads"], np_tree(grads), specs, s["coords"],
                             mesh).values()) <= GRAD_TOL
        assert abs(s["losses"][0] - float(step_loss)) <= \
            LOSS_TOL * abs(float(step_loss))
        assert tree_gap(new, s["params"][0], specs, s["coords"],
                        mesh) < 1e-5
        assert s["repeat_equal"]


def test_stream_holds_its_slice_between_blocks(ranks, inputs):
    """Under ``lm_rules(seq_shard=True)`` each rank's residual stream has S
    / model rows between blocks (the whole S without it, and in a decode
    step, where S = 1 does not split)."""
    S, M = inputs["batch"]["tokens"].shape[1], MESH[1]
    L = inputs["cfg"].n_layers
    for o in ranks:
        rows = o["stream"]
        assert rows["train"] == [S // M] * 2 * L
        assert rows["prefill"] == [S // M] * 2 * L
        assert rows["train_nosp"] == [S] * 2 * L
        assert rows["decode"] == [1] * 2 * L
