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

_REPRO = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.models.moe import MoEConfig, moe_apply, moe_apply_shardmap
from repro.models.common import NO_SHARD
from repro.models.transformer import LMConfig, loss_fn
from repro.dist.sharding import lm_rules

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

cfg = LMConfig(name="moe-sm", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
               d_head=8, d_ff=64, vocab=128, dtype=jnp.float32,
               moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=16,
                             capacity_factor=4.0, impl="shardmap"))
toks = jnp.asarray(z["tokens"])
with jax.set_mesh(mesh):
    out["loss"] = np.asarray(jax.jit(lambda q: loss_fn(
        cfg, q, {"tokens": toks, "labels": toks}, lm_rules(mesh)))(
        unflat("params")))
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
    cases["step"] = ("case_lm_step", dict(
        cfg=inputs["cfg"], params=np_tree(inputs["params"]),
        batch=inputs["batch"], mesh_shape=MESH, steps=2))
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


@pytest.fixture(scope="module")
def reshard_tree():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(16, 5)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "e": rng.normal(size=(3, 8, 2)).astype(np.float32)}


def assemble(ranks, key, name, shape):
    """The full array from every rank's block under ``X_SPECS[name]``."""
    mesh = MeshShape(MESH, ("data", "model"))
    full = np.full(shape, np.nan, np.float32)
    spec = Spec(*X_SPECS[name])
    for out in ranks:
        o = out[key]
        view = local_slice(torch.from_numpy(full), spec, o["coords"], mesh)
        if not np.isnan(view.numpy()).all():
            np.testing.assert_array_equal(view.numpy(), o["y"][name])
        view.copy_(torch.from_numpy(o["y"][name]))
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
