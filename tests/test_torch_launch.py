"""The launch slice (`repro_torch.launch.cells`, `.roofline`, `.dryrun`,
`.mesh`; `train.optimizer.abstract_opt_state`; `configs.all_cells`) held
to `repro.launch` on the CPU.

* `abstract_opt_state` and `all_cells` equal `repro`'s.
* `build_cell` for every (arch × shape) on `repro`'s (16, 16) and (2, 16,
  16) production meshes: each argument's global shape (its local block
  times the shard counts of its spec), dtype and spec equal `repro`'s
  `Cell.abstract_args` / ``in_specs`` entry for entry, and so do
  ``kind``, `donate()`, the skips and ``model_flops`` (rel 1e-12); every
  cell has the port's step, the MoE cells under their published
  ``impl="pjit"`` with no override.  `repro`'s cells are built in a
  subprocess on 512 forced host devices.
* The roofline: `roofline()` with `repro`'s constants passed in gives
  `repro`'s `Roofline` field for field (exact), and each ring formula
  gives `repro`'s ``collective_wire_bytes`` on a one-op HLO line of the
  same op, bytes and group (exact).
* The dry run on a smoke LM train step over a (2, 4) mesh (dense, expert
  parallel and pjit MoE, sequence parallel): for every rank, the census
  (each collective's op, bytes, group size and axis) and the FLOPs of the
  ``meta`` run equal those the same step records on 8 real gloo ranks on
  the CPU under `FlopCounterMode` (exact); so do the smoke SASRec's
  sharded train and top-100 serve steps.
* Layer differencing from depth 2 and 4 gives the depth-6 count of FLOPs,
  bytes, wire bytes and collective counts exactly.
* K6's FLOP formula equals the work of the tiles that
  tests/_k6_tiles.py's line-for-line emulation of the kernel's loops
  visits (exact); the dry-run CLI writes `repro`'s keys.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _dist_ranks
from repro.launch import roofline as rl_j
from repro_torch.configs import all_cells, get_arch
from repro_torch.dist import group as dist_group
from repro_torch.dist.sharding import entry_axes
from repro_torch.kernels.flash_attention import ops as k6_ops
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl_t
from repro_torch.launch.cells import (build_cell, global_shape, lm_train_cell,
                                      recsys_cell)
from repro_torch.launch.mesh import (MeshShape, RankView,
                                     make_production_mesh)
from repro_torch.models import transformer as T
from repro_torch.models.common import tree_leaves
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.train.optimizer import abstract_opt_state, adamw_init

from _k6_tiles import bwd_pairs, kernel_pairs
from _lm_port import port_config

MESHES = {"16x16": False, "2x16x16": True}
CELLS = [(a, s) for a, s, _, _ in all_cells()]
SMOKE_ARCH = "mistral-large-123b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# abstract_opt_state, all_cells
# ---------------------------------------------------------------------------

def test_abstract_opt_state_matches_repro_and_adamw_init():
    import jax

    from repro.configs import get_arch as get_arch_j
    from repro.models.transformer import abstract_params as params_j
    from repro.train.optimizer import abstract_opt_state as opt_j

    cfg_j = get_arch_j("deepseek-moe-16b").make_smoke_config()
    cfg = port_config(cfg_j)
    want = jax.tree_util.tree_leaves(opt_j(params_j(cfg_j)))
    got = tree_leaves(abstract_opt_state(T.abstract_params(cfg)))
    assert [(tuple(x.shape), str(x.dtype)) for x in want] == \
        [(tuple(x.shape), str(x.dtype).removeprefix("torch.")) for x in got]
    assert {x.device.type for x in got} == {"meta"}
    real = adamw_init(T.init_params(cfg, torch.Generator().manual_seed(0)))
    assert [(x.shape, x.dtype) for x in tree_leaves(real)] == \
        [(x.shape, x.dtype) for x in got]


def test_all_cells_matches_repro():
    from repro.configs import all_cells as all_cells_j

    want = [(a, s, c.kind, c.meta, skip) for a, s, c, skip in all_cells_j()]
    assert [(a, s, c.kind, c.meta, skip)
            for a, s, c, skip in all_cells()] == want


def test_make_halo_batch_abstract_matches_repro():
    from repro.models.gnn.halo import make_halo_batch_abstract as halo_j
    from repro_torch.models.gnn.halo import make_halo_batch_abstract

    plan = dataclasses.make_dataclass(
        "Plan", ["n_shards", "n_local", "halo", "max_edges"])(16, 153, 47,
                                                               612)
    want, got = halo_j(plan, 9, 3), make_halo_batch_abstract(plan, 9, 3)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        assert (tuple(w.shape), str(w.dtype)) == (
            tuple(g.shape), str(g.dtype).removeprefix("torch.")), f.name
        assert g.device.type == "meta"


# ---------------------------------------------------------------------------
# build_cell against repro's, every cell on both production meshes
# ---------------------------------------------------------------------------

_REPRO_CELLS = r"""
import json
import jax
from jax.sharding import PartitionSpec as P
from repro.configs import all_cells
from repro.launch.cells import build_cell
from repro.launch.mesh import make_production_mesh

def entry(e):
    if e is None:
        return []
    return [e] if isinstance(e, str) else list(e)

out = {}
for tag, mp in (("16x16", False), ("2x16x16", True)):
    mesh = make_production_mesh(multi_pod=mp)
    for a, s, _, skip in all_cells():
        if skip is not None:
            try:
                build_cell(a, s, mesh)
                raised = None
            except ValueError as e:
                raised = str(e)
            out[f"{a}|{s}|{tag}"] = {"skip": raised}
            continue
        cell = build_cell(a, s, mesh)
        args = jax.tree_util.tree_leaves(cell.abstract_args)
        specs = jax.tree_util.tree_leaves(
            cell.in_specs, is_leaf=lambda x: isinstance(x, P))
        out[f"{a}|{s}|{tag}"] = {
            "kind": cell.kind, "donate": list(cell.donate()),
            "model_flops": cell.model_flops, "notes": cell.notes,
            "args": [[list(x.shape), str(x.dtype), [entry(e) for e in sp]]
                     for x, sp in zip(args, specs)],
            "n_specs": len(specs)}
print("CELLS=" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def repro_cells(multi_device_run):
    stdout = multi_device_run(_REPRO_CELLS, devices=512, timeout=900)
    line = [x for x in stdout.splitlines() if x.startswith("CELLS=")][-1]
    return json.loads(line[len("CELLS="):])


def _flat(tree) -> list:
    """The leaves of an argument or spec tree in JAX's order: dicts by
    sorted key, a `GraphBatch` by field (`repro`'s dataclass pytree), None
    an empty subtree, a spec (a tuple) a leaf."""
    if isinstance(tree, GraphBatch):
        return [x for f in dataclasses.fields(tree)
                if f.name not in ("n_graphs", "plans")
                for x in _flat(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and not hasattr(tree, "_fields")
                                  and type(tree) is tuple):
        return [x for v in tree for x in _flat(v)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_build_cell_matches_repro(arch, shape, tag, repro_cells):
    want = repro_cells[f"{arch}|{shape}|{tag}"]
    mesh = make_production_mesh(multi_pod=MESHES[tag])
    if "skip" in want:
        with pytest.raises(ValueError, match="skipped") as e:
            build_cell(arch, shape, mesh)
        assert str(e.value) == want["skip"]
        return
    cell = build_cell(arch, shape, mesh)
    assert (cell.kind, list(cell.donate())) == (want["kind"], want["donate"])
    assert math.isclose(cell.model_flops, want["model_flops"], rel_tol=1e-12)
    args, specs = _flat(cell.abstract_args), _flat(cell.in_specs)
    assert len(args) == len(specs) == want["n_specs"]
    got = [[list(global_shape(x.shape, sp, mesh)),
            str(x.dtype).removeprefix("torch."),
            [list(entry_axes(e)) for e in sp]] for x, sp in zip(args, specs)]
    assert got == want["args"]
    assert {x.device.type for x in args} == {"meta"}
    family = get_arch(arch).family
    assert callable(cell.fn)
    if family == "gnn":   # the sharded GNN step under gnn_rules
        assert cell.notes.startswith(want["notes"])
    elif family == "lm" and get_arch(arch).make_config().moe is not None:
        # the published pjit dispatch and expert parallelism take the same
        # arguments
        ep = build_cell(arch, shape, mesh, moe_impl="shardmap")
        assert callable(ep.fn)
        assert [(x.shape, x.dtype) for x in _flat(ep.abstract_args)] == \
            [(x.shape, x.dtype) for x in args]


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------

HLO_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
           "collective-permute")


def _hlo_line(op: str, n_out: int, g: int) -> str:
    groups = "{{" + ",".join(str(i) for i in range(g)) + "}}"
    return (f"  %c = f32[{n_out}]{{0}} {op}(f32[{n_out}]{{0}} %x), "
            f"replica_groups={groups}")


@pytest.mark.parametrize("g", (2, 4, 16))
@pytest.mark.parametrize("op", HLO_OPS)
def test_ring_formula_matches_repro(op, g):
    n_out = 3 * 1024
    want = rl_j.collective_wire_bytes(_hlo_line(op, n_out, g), 256)
    assert rl_t.wire_bytes(op, 4 * n_out, g) == want.total_wire_bytes
    stats = rl_t.collective_stats([(op, 4 * n_out, g, "model")])
    assert stats.per_op == want.per_op and stats.counts == want.counts
    assert stats.row() == want.row()


def test_roofline_with_repro_constants_matches_repro():
    cost = {"flops": 3.7e15, "bytes accessed": 2.9e12}
    lines = [_hlo_line("all-reduce", 1 << 20, 16),
             _hlo_line("all-gather", 1 << 18, 16),
             _hlo_line("reduce-scatter", 1 << 16, 16),
             _hlo_line("all-to-all", 1 << 19, 16)]
    records = [("all-reduce", 4 << 20, 16, "model"),
               ("all-gather", 4 << 18, 16, "data"),
               ("reduce-scatter", 4 << 16, 16, "data"),
               ("all-to-all", 4 << 19, 16, "model")]
    want = rl_j.roofline(cost, "\n".join(lines), 256, 1.1e18)
    got = rl_t.roofline(cost, records, 256, 1.1e18,
                        peak_flops=rl_j.PEAK_FLOPS, hbm_bw=rl_j.HBM_BW,
                        link_bw=rl_j.LINK_BW)
    assert got.row() == want.row()


def test_roofline_against_the_eager_steps_bound():
    """With the ops' own rooflines summed (``op_s``), the step's bound is
    the larger of that sum and the collective term, and the fraction and
    the dominant term are taken against it; without, `repro`'s."""
    args = (989e12, 3.35e12 * 2, 0.0, 1.5, 8, 0.0)
    r = rl_t.from_counts(*args)
    assert (r.dominant, r.roofline_fraction) == ("memory", 0.5)
    r = rl_t.from_counts(*args, op_s=4.0)
    assert rl_t.step_bound(4.0, 1.5) == 4.0
    assert (r.dominant, r.roofline_fraction) == ("memory", 0.25)
    assert (r.compute_s, r.memory_s) == (1.0, 2.0)
    r = rl_t.from_counts(*args[:3], 5.0, *args[4:], op_s=4.0)
    assert (r.dominant, r.roofline_fraction) == ("collective", 0.2)


def test_roofline_times_each_axis_at_its_slowest_link():
    """On the H100 cluster a (2, 4) mesh lies in one node (NVLink); on the
    production mesh every axis crosses InfiniBand."""
    rec = [("all-reduce", 8e6, 4, "model"), ("all-gather", 4e6, 2, "data")]
    wire = 2 * 8e6 * 3 / 4 + 4e6 / 2
    small = make_production_mesh()
    inside = MeshShape((2, 4), ("data", "model"))
    inside.topology = small.topology
    assert rl_t.collective_seconds(rec, inside) == pytest.approx(
        wire / 450e9, rel=1e-12)
    assert rl_t.collective_seconds(rec, small) == pytest.approx(
        wire / 50e9, rel=1e-12)
    r = rl_t.roofline({"flops": 989e12, "bytes accessed": 0.0}, rec, 8, 0.0,
                      mesh=small)
    assert (r.compute_s, r.dominant) == (1.0, "compute")


# ---------------------------------------------------------------------------
# The dry run against 8 real ranks, and layer differencing
# ---------------------------------------------------------------------------

WORLD, MESH_SHAPE = 8, (2, 4)
B, S = 4, 32


def _smoke(n_layers=None):
    """mistral's smoke config with 8 query heads over 2 KV heads: on the
    (2, 4) mesh the query heads, the FFN and the vocab split over
    ``model``, the KV heads stay whole, the batch splits over ``data``."""
    cfg = dataclasses.replace(get_arch(SMOKE_ARCH).make_smoke_config(),
                              n_heads=8, n_kv_heads=2)
    return cfg if n_layers is None else dataclasses.replace(cfg,
                                                            n_layers=n_layers)


def _moe_smoke(n_layers=None):
    """deepseek-moe-16b's smoke config as expert parallelism: 8 experts over
    ``model``, their d over ``data`` (FSDP), the sequence over ``model``."""
    cfg = get_arch("deepseek-moe-16b").make_smoke_config()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl="shardmap"))
    return cfg if n_layers is None else dataclasses.replace(cfg,
                                                            n_layers=n_layers)


def _moe_pjit_smoke(n_layers=None):
    """deepseek-moe-16b's smoke config under its published ``impl="pjit"``:
    the global capacity, the expert ids gathered over ``data``."""
    cfg = get_arch("deepseek-moe-16b").make_smoke_config()
    assert cfg.moe.impl == "pjit"
    return cfg if n_layers is None else dataclasses.replace(cfg,
                                                            n_layers=n_layers)


CENSUS_CASES = {"dense": _smoke, "moe": _moe_smoke, "moe_pjit": _moe_pjit_smoke}


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One sharded train step of each smoke LM on 8 gloo ranks: each rank's
    FLOPs and census."""
    rng = np.random.default_rng(0)
    cases = {}
    for name, make in CENSUS_CASES.items():
        cfg = make()
        p = T.init_params(cfg, torch.Generator().manual_seed(0))
        tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        cases[name] = ("case_lm_census", dict(
            cfg=cfg, params=_np_tree(p), batch=batch, mesh_shape=MESH_SHAPE))
    return _dist_ranks.run_ranks(_dist_ranks.run_cases, cases, WORLD,
                                 tmp_path_factory.mktemp("ranks_census"))


@pytest.mark.parametrize("name", CENSUS_CASES)
def test_meta_census_and_flops_equal_the_ranks(name, ranks):
    mesh = MeshShape(MESH_SHAPE, ("data", "model"))
    cfg = CENSUS_CASES[name]()
    seen = set()
    for r in range(WORLD):
        got = ranks[r][name]
        view = RankView(mesh, r)
        assert got["coords"] == dict(zip(view.axis_names, view.coord))
        cell = lm_train_cell(cfg, B, S, view)
        with dist_group.census() as cen, FlopCounterMode(display=False) as fc:
            cell.fn(*cell.abstract_args)
        assert [tuple(x) for x in got["records"]] == cen.records, r
        assert got["flops"] == fc.get_total_flops() > 0, r
        seen.update((op, axis) for op, _, _, axis in cen.records)
    # the dense step's reductions run over both axes (heads, FFN and vocab
    # over model, the loss over data, the gradients over both); expert
    # parallelism adds its all-to-alls and the FSDP gathers
    # sequence parallelism reduce-scatters the blocks' outputs and gathers
    # their inputs over model
    assert {("all-reduce", "model"), ("all-reduce", "data"),
            ("reduce-scatter", "model"), ("all-gather", "model")} <= seen
    if name == "moe":
        assert {("all-to-all", "model"), ("all-gather", "data")} <= seen
    if name == "moe_pjit":   # the ids and the FSDP experts over data
        assert ("all-gather", "data") in seen
        assert ("all-to-all", "model") not in seen


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-30b-a3b"])
def test_moe_cell_runs_pjit_without_override(arch):
    """`build_cell` runs the MoE cells under the published config
    (``impl="pjit"``, no ``moe_impl``): rank 0's train step at full width,
    two layers deep, on ``meta`` tensors, gathering each layer's expert ids
    (int32) over the data axes."""
    mesh = make_production_mesh(multi_pod=False)
    cell = build_cell(arch, "train_4k", mesh, n_layers=2)
    assert get_arch(arch).make_config().moe.impl == "pjit"
    with dist_group.census() as cen:
        new, _, loss = cell.fn(*cell.abstract_args)
    assert loss.device.type == "meta" and loss.shape == ()
    cfg = get_arch(arch).make_config()
    B, S = 256 // 16, 4096               # rank 0's sequences, whole
    ids = [r for r in cen.records if r[0] == "all-gather"
           and r[1] == 16 * B * S * cfg.moe.top_k * 4]
    assert {r[3] for r in ids} == {"data"}
    assert len(ids) == 2 * 2             # a layer, forward and recompute


RECSYS_B = {"train": 8, "serve": 16}


@pytest.fixture(scope="module")
def recsys_ranks(tmp_path_factory):
    """One sharded train step and one top-100 serve of the smoke SASRec on
    8 gloo ranks: each rank's FLOPs and census, by step."""
    from repro_torch.models.recsys.sasrec import init_sasrec

    cfg = get_arch("sasrec").make_smoke_config()
    p = init_sasrec(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)

    def items(b):
        return rng.integers(1, cfg.n_items + 1, (b, cfg.seq_len)).astype(
            np.int32)

    B = RECSYS_B["train"]
    batch = {"item_seq": items(B), "pos_items": items(B),
             "neg_items": items(B)}
    case = ("case_recsys_census", dict(
        cfg=cfg, params=_np_tree(p), batch=batch,
        seq=items(RECSYS_B["serve"]), mesh_shape=MESH_SHAPE,
        local_chunk=RECSYS_B["serve"] // MESH_SHAPE[0]))
    return _dist_ranks.run_ranks(_dist_ranks.run_cases, {"r": case}, WORLD,
                                 tmp_path_factory.mktemp("ranks_recsys"))


@pytest.mark.parametrize("kind", RECSYS_B)
def test_recsys_meta_census_and_flops_equal_the_ranks(kind, recsys_ranks):
    """The dry run's recsys train and serve steps at the smoke size: for
    every rank, the `AbstractGroup` census (op, bytes, group size, axis)
    and the FLOPs of the ``meta`` run equal the real ranks' (exact)."""
    mesh = MeshShape(MESH_SHAPE, ("data", "model"))
    cfg = get_arch("sasrec").make_smoke_config()
    seen = set()
    for r in range(WORLD):
        got = recsys_ranks[r]["r"]
        view = RankView(mesh, r)
        assert got["coords"] == dict(zip(view.axis_names, view.coord))
        cell = recsys_cell(cfg, kind, RECSYS_B[kind], view)
        with dist_group.census() as cen, FlopCounterMode(display=False) as fc:
            cell.fn(*cell.abstract_args)
        assert [tuple(x) for x in got[kind]["records"]] == cen.records, r
        assert got[kind]["flops"] == fc.get_total_flops() > 0, r
        seen.update((op, axis) for op, _, _, axis in cen.records)
    # the lookups sum over model; the train step's loss and gradients over
    # both axes; the serve step gathers its winners over model
    assert ("all-reduce", "model") in seen
    if kind == "train":
        assert ("all-reduce", "data") in seen
    else:
        assert ("all-gather", "model") in seen


def test_layer_differencing_gives_the_unrolled_count():
    mesh = RankView(MeshShape(MESH_SHAPE, ("data", "model")), 0)
    qs = {n: dryrun.profile_census(lm_train_cell(_smoke(n), B, S, mesh), mesh)
          for n in (2, 4, 6)}
    diff = dryrun.layer_diff({2: qs[2], 4: qs[4]}, 6)
    for k in ("flops", "bytes", "wire", "per_op", "counts"):
        assert diff[k] == qs[6][k], k
    for k in ("collective_s", "op_s"):
        assert diff[k] == pytest.approx(qs[6][k], rel=1e-12), k
    assert qs[6]["flops"] > qs[4]["flops"] > qs[2]["flops"]


def test_step_bound_sums_each_ops_roofline():
    """The meter's op_s, each op's max(FLOPs / peak, bytes / HBM rate)
    summed, lies between the whole step's max(compute, memory) and their
    sum; its FLOPs are `FlopCounterMode`'s, op by op."""
    mesh = RankView(MeshShape(MESH_SHAPE, ("data", "model")), 0)
    q = dryrun.profile_census(lm_train_cell(_smoke(2), B, S, mesh), mesh)
    compute, memory = q["flops"] / rl_t.PEAK_FLOPS, q["bytes"] / rl_t.HBM_BW
    assert max(compute, memory) < q["op_s"] < compute + memory


def test_exec_pass_peak_holds_the_arguments_and_the_step():
    mesh = MeshShape(MESH_SHAPE, ("data", "model"))
    cell = lm_train_cell(_smoke(), B, S, mesh)
    mem = dryrun.exec_pass(cell)
    args = sum(x.numel() * x.element_size()
               for x in _flat(cell.abstract_args))
    assert mem["argument_bytes"] == args
    # AdamW makes new params and moments while the old ones live: the peak
    # holds at least the arguments, their gradients and their successors
    assert mem["peak_bytes"] >= 2 * args
    assert mem["alias_bytes"] == sum(
        x.numel() * x.element_size()
        for x in _flat(cell.abstract_args[:2]))
    assert mem["temp_bytes"] == mem["peak_bytes"] - args


# ---------------------------------------------------------------------------
# K6's FLOP formula against the emulated tile loops; the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # (Sq, H, Hkv, D, q_offset, kv_len, causal, window, dtype)
    (300, 8, 2, 64, 0, 300, True, None, torch.bfloat16),     # causal prefill
    (333, 16, 4, 64, 0, 333, True, 100, torch.bfloat16),     # windowed
    (70, 8, 1, 16, 0, 70, True, 37, torch.bfloat16),         # mma.sync warps
    (128, 32, 4, 64, 512, 640, True, 200, torch.bfloat16),   # continuation
    (257, 4, 4, 32, 40, 297, True, 100, torch.float32),      # fp32 window
    (1, 8, 1, 64, 4094, 4095, True, None, torch.bfloat16),   # split-KV decode
    (2, 8, 1, 128, 1000, 1002, True, 129, torch.float32),    # windowed decode
    (96, 2, 2, 32, 0, 500, False, None, torch.float32),      # not causal
])
def test_k6_formula_counts_the_kernel_tiles(case):
    Sq, H, Hkv, D, q_offset, kv_len, causal, window, dtype = case
    B = 3
    q = torch.empty((B, Sq, H, D), dtype=dtype, device="meta")
    k = torch.empty((B, kv_len, Hkv, D), dtype=dtype, device="meta")
    want = 4 * D * B * Hkv * kernel_pairs(Sq, H // Hkv, D, q_offset, kv_len,
                                          causal, window,
                                          dtype == torch.bfloat16)
    assert k6_ops.kernel_flops(q.shape, k.shape, dtype, causal, q_offset,
                               kv_len, window) == want
    with FlopCounterMode(display=False) as fc:
        out = torch.ops.repro_torch.flash_attention(q, k, k, causal,
                                                    q_offset, kv_len, window)
    assert fc.get_total_flops() == want and out.shape == q.shape
    if causal and Sq > 16:      # the causal tiles skipped: under the full S×S
        assert want < 4 * D * B * H * Sq * kv_len


@pytest.mark.parametrize("case", [
    # (Sq, H, Hkv, D, q_offset, kv_len, causal, window, dtype)
    (300, 8, 2, 64, 0, 300, True, None, torch.bfloat16),     # causal
    (333, 16, 4, 64, 0, 333, True, 100, torch.bfloat16),     # windowed
    (128, 32, 4, 64, 512, 640, True, 200, torch.bfloat16),   # continuation
    (257, 4, 4, 32, 40, 297, True, 100, torch.float32),      # fp32 window
    (96, 2, 2, 32, 0, 500, False, None, torch.float32),      # not causal
])
def test_k6_backward_formula_counts_the_kernel_tiles(case):
    """K6's backward operator under `FlopCounterMode` on meta tensors: 18·D
    FLOPs a pair of the tiles its two launches visit, as the CUDA source
    walks them (tests/_k6_tiles.py); its bytes: q, dout, dq and dk, dv
    whole, the keys it reads, the rows' statistics."""
    Sq, H, Hkv, D, q_offset, kv_len, causal, window, dtype = case
    B = 3
    q = torch.empty((B, Sq, H, D), dtype=dtype, device="meta")
    k = torch.empty((B, kv_len, Hkv, D), dtype=dtype, device="meta")
    want = 18 * D * B * H * bwd_pairs(Sq, q_offset, kv_len, causal, window)
    assert k6_ops.backward_flops(q.shape, k.shape, causal, q_offset, kv_len,
                                 window) == want
    with FlopCounterMode(display=False) as fc:
        out = torch.ops.repro_torch.flash_attention_backward(
            q, k, k, q, causal, q_offset, kv_len, window)
    assert fc.get_total_flops() == want
    assert [t.shape for t in out] == [q.shape, k.shape, k.shape]
    if causal and Sq > 64:      # the causal tiles skipped: under the full S×S
        assert want < 18 * D * B * H * Sq * kv_len
    el = q.element_size()
    least = 3 * q.numel() * el + 2 * k.numel() * el
    assert least < k6_ops.backward_bytes(q, k, k, q, causal, q_offset, kv_len,
                                         window) <= least + 2 * k.numel() * el \
        + 24 * B * H * Sq


REPRO_KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "notes",
              "exec_compile_s", "profile_compile_s", "memory_analysis",
              "live_bytes_per_device", "cost_analysis", "collectives",
              "roofline", "status", "profile_method"}
# the port's own: the H100's 80 GB, and the eager step's bound
PORT_KEYS = {"fits_80gb", "op_s", "bound_s"}


def test_dryrun_cli_writes_repro_keys(tmp_path, monkeypatch):
    monkeypatch.setattr("sys.argv", [
        "dryrun", "--arch", "tinyllama-1.1b", "--mesh", "pod",
        "--out", str(tmp_path)])
    dryrun.main()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["tinyllama-1.1b__decode_32k__16x16.json",
                     "tinyllama-1.1b__long_500k__skip.json",
                     "tinyllama-1.1b__prefill_32k__16x16.json",
                     "tinyllama-1.1b__train_4k__16x16.json"]
    for name in names[:1] + names[2:]:
        rec = json.loads((tmp_path / name).read_text())
        assert set(rec) == REPRO_KEYS | PORT_KEYS, name
        r = rec["roofline"]
        assert rec["bound_s"] == max(rec["op_s"], r["collective_s"]), name
        assert rec["op_s"] >= max(r["compute_s"], r["memory_s"]), name
        assert r["roofline_fraction"] == pytest.approx(
            r["compute_s"] / rec["bound_s"], rel=1e-12), name
        assert rec["status"] == "ok" and rec["n_devices"] == 256
        assert set(rec["memory_analysis"]) == {
            "argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
            "alias_bytes"}
        assert set(rec["roofline"]) == set(
            f.name for f in dataclasses.fields(rl_j.Roofline))
    train = json.loads((tmp_path / names[3]).read_text())
    assert train["profile_method"] == "layer-diff(2,4)->L=22"
    assert train["collectives"]["counts"]["all-reduce"] > 0
    for multi_pod, n_dev in ((False, 256), (True, 512)):
        gnn = dryrun.run_cell("meshgraphnet", "full_graph_sm",
                              multi_pod=multi_pod, verbose=False)
        assert gnn["status"] == "ok" and gnn["n_devices"] == n_dev
        assert gnn["profile_method"] == "layer-diff(2,4)->L=15"
        counts = gnn["collectives"]["counts"]
        assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    ok = dryrun.run_cell("sasrec", "serve_p99", multi_pod=True,
                         verbose=False)
    assert ok["status"] == "ok" and ok["n_devices"] == 512
    assert ok["collectives"]["counts"]["all-gather"] > 0
