"""The port's sharding rules against `repro.dist.sharding`, on abstract
meshes (no process, no device).

`param_specs_lm`, `cache_specs_lm` and `batch_specs_lm` of every LM config
of `repro`'s registry (published and smoke widths, mistral-large-123b's
123B parameters included: both sides build only shapes) on the meshes
(16, 16), (2, 16, 16), (2, 4) and (8,), entry for entry; `lm_rules`,
`gnn_rules` and `recsys_rules` on every logical name of their tables,
over shapes that divide and that do not; `local_slice` and `placements`.
"""

import itertools

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.dist.sharding as sj
from _lm_port import port_config
from repro.configs import get_arch as get_arch_j
from repro.models.transformer import abstract_params as abstract_j
from repro_torch.dist import sharding as st
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models.transformer import abstract_params as abstract_t

LM_ARCHS = ("tinyllama-1.1b", "deepseek-moe-16b", "qwen3-moe-30b-a3b",
            "mistral-large-123b", "command-r-35b")
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
          "small": ((2, 4), ("data", "model")),
          "dp": ((8,), ("data",))}


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), MeshShape(shape, axes)


def flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in flat(tree[key],
                                                      path + (key,)).items()}
    return {path: tuple(tree)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_lm_specs_match_repro(arch, mesh, smoke):
    a = get_arch_j(arch)
    cfg_j = a.make_smoke_config() if smoke else a.make_config()
    cfg_t = port_config(cfg_j)
    mj, mt = meshes(mesh)
    want = flat(sj.param_specs_lm(cfg_j, abstract_j(cfg_j), mj))
    got = flat(st.param_specs_lm(cfg_t, abstract_t(cfg_t), mt))
    assert got == want
    assert {k: tuple(v) for k, v in st.cache_specs_lm(cfg_t, mt).items()} \
        == {k: tuple(v) for k, v in sj.cache_specs_lm(cfg_j, mj).items()}
    assert {k: tuple(v) for k, v in st.batch_specs_lm(mt).items()} \
        == {k: tuple(v) for k, v in sj.batch_specs_lm(mj).items()}


def test_guard_replicates():
    """Each replicated outcome of the divisibility guard, as `repro`."""
    mj, mt = meshes("pod")
    mistral = port_config(get_arch_j("mistral-large-123b").make_config())
    specs = st.param_specs_lm(mistral, abstract_t(mistral), mt)
    assert specs["layers"]["wq"] == (None, None, "model", None)
    assert specs["layers"]["wk"] == (None, None, None, None)  # 8 KV on 16
    assert st.cache_specs_lm(mistral, mt)["k"] == (None, "data", None, None,
                                                   None)
    smoke = port_config(get_arch_j("mistral-large-123b").make_smoke_config())
    small = st.param_specs_lm(smoke, abstract_t(smoke), meshes("small")[1])
    assert small["layers"]["wq"] == (None, None, None, None)  # 6 heads on 4
    deepseek = port_config(get_arch_j("deepseek-moe-16b").make_config())
    ds = st.param_specs_lm(deepseek, abstract_t(deepseek), mt)
    assert ds["layers"]["wk"] == (None, None, "model", None)   # 16 KV on 16
    assert ds["layers"]["moe"]["wi"] == (None, "model", "data", None)
    rules_t, rules_j = st.lm_rules(mt), sj.lm_rules(mj)
    for logical, shape in ((("vocab", None), (1001, 8)),       # no divide
                           (("heads", "kv_heads"), (32, 32)),  # axis used once
                           (("batch", "act_seq"), (48, 100))):
        assert tuple(rules_t.spec(logical, shape)) == \
            tuple(rules_j.spec(logical, shape))
    assert rules_t.spec(("vocab", None), (1001, 8)) == (None, None)
    assert rules_t.spec(("heads", "kv_heads"), (32, 32)) == ("model", None)
    assert rules_t.spec(("batch", "act_seq"), (48, 100)) == ("data", None)


SHAPES = (6, 8, 32, 48, 100, 2708)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("family", ["lm", "lm_noseq", "gnn", "recsys"])
def test_rules_match_repro(family, mesh):
    mj, mt = meshes(mesh)
    make = {"lm": (sj.lm_rules, st.lm_rules),
            "lm_noseq": (lambda m: sj.lm_rules(m, seq_shard=False),
                         lambda m: st.lm_rules(m, seq_shard=False)),
            "gnn": (sj.gnn_rules, st.gnn_rules),
            "recsys": (sj.recsys_rules, st.recsys_rules)}[family]
    rj, rt = make[0](mj), make[1](mt)
    assert rt.table.keys() == rj.table.keys()
    names = sorted(rj.table) + [None]
    seen = set()
    for a, b in itertools.product(names, repeat=2):
        for shape in itertools.product(SHAPES, repeat=2):
            want = tuple(rj.spec((a, b), shape))
            assert tuple(rt.spec((a, b), shape)) == want, (a, b, shape)
            seen.add(want)
        assert tuple(rt.spec((a, b))) == tuple(rj.spec((a, b)))
    assert (None, None) in seen


def test_local_slice_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape((2, 4), ("data", "model"))
    x = torch.arange(8 * 16 * 3).reshape(8, 16, 3)
    for spec in (st.Spec("data", "model", None), st.Spec(("data", "model")),
                 st.Spec(None, ("data", "model")), st.Spec("model", "data")):
        blocks = {}
        for d, m in itertools.product(range(2), range(4)):
            blocks[d, m] = st.local_slice(x, spec, {"data": d, "model": m},
                                          mesh)
        # every element of x appears in exactly the blocks of its replicas
        total = sum(int(b.sum()) for b in blocks.values())
        reps = 8 // int(np.prod([mesh.shape[a] for e in spec
                                 for a in st.entry_axes(e)]))
        assert total == reps * int(x.sum())
    assert st.local_slice(x, st.Spec("data", "model"), {"data": 1, "model": 2},
                          mesh).tolist() == x[4:8, 8:12].tolist()
    assert st.local_slice(x, st.Spec(("data", "model")), {"data": 1,
                                                          "model": 2},
                          mesh).tolist() == x[6:7].tolist()
    assert st.placements(st.Spec("data", "model", None), mesh) == \
        (Shard(0), Shard(1))
    assert st.placements(st.Spec(None, ("data", "model")), mesh) == \
        (Shard(1), Shard(1))
    assert st.placements(st.Spec(None, None), mesh) == (Replicate(),
                                                        Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        st.placements(st.Spec(("model", "data")), mesh)
    with pytest.raises(ValueError, match="does not split"):
        st.local_slice(torch.zeros(6), st.Spec("model"), {"model": 0}, mesh)
    assert st.Spec(("data",), ()) == ("data", None)
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (pod.shape, pod.axis_names) == ({"data": 16, "model": 16},
                                           ("data", "model"))
    assert (multi.shape, multi.axis_names) == (
        {"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model"))
    # nodes of 8 cards on NVSwitch: a model group of 16 spans two nodes,
    # data and pod groups cross InfiniBand; a model group of 4 or 8 stays
    # on NVLink
    topo = pod.topology
    assert topo.node_cards == 8 and (topo.nvlink_bw, topo.ib_bw) == (450e9,
                                                                     50e9)
    for m in (pod, multi):
        assert {a: topo.link_bw(m, a) for a in m.axis_names} == \
            dict.fromkeys(m.axis_names, 50e9)
    for shape, want in (((2, 4), 450e9), ((2, 8), 450e9), ((1, 16), 50e9)):
        small = MeshShape(shape, ("data", "model"))
        assert topo.link_bw(small, "model") == want
    assert topo.link_bw(MeshShape((2, 4), ("data", "model")), "data") == \
        450e9
