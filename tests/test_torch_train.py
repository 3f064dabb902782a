"""repro_torch.train, repro_torch.data.pipeline and the two autograd
functions (K6, K5) vs repro.

Inputs are drawn by NumPy and handed to both packages.  Tolerances:
`adamw_update` 1e-6 (fp32; the same operations, the global norm summed in
the same leaf order); `compress` and `ef_compress_tree` bit for bit (both
round half to even); `quorum_grad_mean` 1e-7; `fit` on
tests/test_checkpoint.py's quadratic, preempted at step 7 of 20 and
resumed, within 1e-6 of `repro`'s uninterrupted run and bit for bit equal
to the port's uninterrupted run; checkpoints load across the two packages
in both directions, bit for bit; `compressed_psum` over 4 gloo ranks
(`_dist_ranks`) against `repro`'s under ``shard_map`` on 4 forced host
devices, bit for bit (an exact int32 sum, the same fp32 dequantization).
K6's gradient (its `FlashAttention` function, plain forward and backward
on the CPU) against autograd through the plain version (1e-6, the
backward's blocks sum dk and dv in another order) and against `jax.grad`
through `repro`'s `blocked_attention` (1e-5 of each gradient's max); K5's
(`EmbeddingBag`, the transposed bag) in fp32 bit-equal to autograd through
the plain version on the CPU and within 1e-6 of `jax.grad` through
``jnp.take``; in bf16 within 2e-2 of the plain one's max (K5 rounds a
row's fp32 sum once, the plain backward adds in bf16).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_ranks
from repro.data.pipeline import Prefetcher as PrefetcherJ
from repro.models import transformer as tj
from repro.train import checkpoint as ckpt_j
from repro.train import grad_compression as gc_j
from repro.train.optimizer import AdamWConfig as AdamWConfigJ
from repro.train.optimizer import adamw_init as adamw_init_j
from repro.train.optimizer import adamw_update as adamw_update_j
from repro.train.train_loop import fit as fit_j
from repro.train.train_loop import quorum_grad_mean as quorum_j
from repro_torch.data.pipeline import Prefetcher
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models.common import tree_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import grad_compression as gc
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.train_loop import fit, quorum_grad_mean

WORLD = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(4,)).astype(np.float32),
                  "a": rng.normal(size=(2, 2, 2)).astype(np.float32)}}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def assert_tree_close(got, want, atol, equal=False):
    lg = tree_leaves(got)
    lw = jax.tree_util.tree_leaves(want)
    assert len(lg) == len(lw)
    for g, w in zip(lg, lw):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape
        if equal:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=atol)


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_adamw_matches_repro(clip):
    p = np_tree(0)
    cfg_j = AdamWConfigJ(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    pj, pt = to_jax(p), to_torch(p)
    oj, ot = adamw_init_j(pj), adamw_init(pt)
    for step in range(4):
        g = np_tree(10 + step)
        pj, oj, nj = adamw_update_j(cfg_j, to_jax(g), oj, pj)
        pt, ot, nt = adamw_update(cfg, to_torch(g), ot, pt)
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
        assert_tree_close(pt, pj, 1e-6)
        assert_tree_close(ot["m"], oj["m"], 1e-6)
        assert_tree_close(ot["v"], oj["v"], 1e-6)
        assert int(ot["count"]) == int(oj["count"]) == step + 1
        assert ot["count"].dtype == torch.int32


def test_adamw_keeps_param_dtype():
    p = {"x": torch.ones(3, dtype=torch.bfloat16)}
    new, opt, _ = adamw_update(AdamWConfig(), {"x": torch.ones(3)},
                               adamw_init(p), p)
    assert new["x"].dtype == torch.bfloat16
    assert opt["m"]["x"].dtype == torch.float32


# ------------------------------------------------------- grad compression

def test_compress_matches_repro_bit_for_bit():
    rng = np.random.default_rng(1)
    # half-way cases: g / scale = k + 0.5 exactly (scale = 1 with max 127)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5],
                    np.float32)
    for g in (ties, rng.normal(size=1000).astype(np.float32),
              np.zeros(7, np.float32), (rng.normal(size=64) * 1e-20)
              .astype(np.float32)):
        qj, sj = gc_j.compress(jnp.asarray(g))
        qt, st = gc.compress(torch.from_numpy(g))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert float(st) == float(sj)
        np.testing.assert_array_equal(gc.decompress(qt, st).numpy(),
                                      np.asarray(gc_j.decompress(qj, sj)))


def test_ef_compress_tree_matches_repro_bit_for_bit():
    g, e = np_tree(2), np_tree(3)
    e = {"w": e["w"] * 1e-3, "b": {k: v * 1e-3 for k, v in e["b"].items()}}
    dj, ej = gc_j.ef_compress_tree(to_jax(g), to_jax(e))
    dt, et = gc.ef_compress_tree(to_torch(g), to_torch(e))
    assert_tree_close(dt, dj, 0, equal=True)
    assert_tree_close(et, ej, 0, equal=True)
    zero = gc.init_error_buf(to_torch(g))
    assert all(float(z.abs().max()) == 0 and z.dtype == torch.float32
               for z in tree_leaves(zero))


def test_quorum_grad_mean_matches_repro():
    rng = np.random.default_rng(4)
    g = {"w": rng.normal(size=(4, 3, 2)).astype(np.float32),
         "b": rng.normal(size=(4, 5)).astype(np.float32)}
    for alive in ([1.0, 1.0, 0.0, 1.0], [0.0] * 4, [1.0] * 4):
        a = np.asarray(alive, np.float32)
        want = quorum_j(to_jax(g), jnp.asarray(a))
        got = quorum_grad_mean(to_torch(g), torch.from_numpy(a))
        assert_tree_close(got, want, 1e-7)
    straggler = {"w": torch.stack([torch.ones(3), 2 * torch.ones(3),
                                   100 * torch.ones(3), 3 * torch.ones(3)])}
    out = quorum_grad_mean(straggler, torch.tensor([1.0, 1.0, 0.0, 1.0]))
    assert torch.equal(out["w"], 2 * torch.ones(3))


def test_prefetcher_matches_repro():
    items = [{"i": i} for i in range(7)]
    assert list(Prefetcher(iter(items), depth=2)) == \
        list(PrefetcherJ(iter(items), depth=2)) == items
    pf = Prefetcher(iter(range(100)), depth=3)
    assert [next(pf) for _ in range(5)] == list(range(5))
    pf.close()


# ------------------------------------------------------------ checkpoints

def _tree_t():
    return {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)},
            "d": torch.tensor(7, dtype=torch.int32)}


def _tree_j():
    return {"a": jnp.arange(6.0).reshape(2, 3), "b": {"c": jnp.ones(4)},
            "d": jnp.int32(7)}


def test_save_load_roundtrip(tmp_path):
    t = _tree_t()
    f = ckpt.save_checkpoint(str(tmp_path), 3, t, extra={"note": "x"})
    step, restored, manifest = ckpt.load_checkpoint(f, t)
    assert step == 3 and manifest["extra"] == {"note": "x"}
    assert os.path.basename(f) == "ckpt_00000003.npz"
    for x, y in zip(tree_leaves(t), tree_leaves(restored)):
        assert torch.equal(x, y) and x.dtype == y.dtype


def test_manager_keeps_last_k(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree_t())
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_file().endswith("ckpt_00000004.npz")


def test_torn_checkpoint_falls_back(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree_t())
    mgr.save(2, _tree_t())
    with open(os.path.join(str(tmp_path), "ckpt_00000003.npz"), "wb") as f:
        f.write(b"torn!")
    step, tree, _ = mgr.restore_latest(_tree_t())
    assert step == 2
    assert ckpt.CheckpointManager(str(tmp_path / "empty")).restore_latest(
        _tree_t()) is None


def test_structure_mismatch_raises(tmp_path):
    f = ckpt.save_checkpoint(str(tmp_path), 1, _tree_t())
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(f, {"only": torch.zeros(1)})


def test_checkpoints_load_across_packages(tmp_path):
    """A file written by either package loads in the other, leaf names and
    order included."""
    f_j = ckpt_j.save_checkpoint(str(tmp_path / "j"), 5, _tree_j())
    f_t = ckpt.save_checkpoint(str(tmp_path / "t"), 5, _tree_t())
    _, from_j, man_j = ckpt.load_checkpoint(f_j, _tree_t())
    _, from_t, man_t = ckpt_j.load_checkpoint(f_t, _tree_j())
    assert man_t["names"] == man_j["names"] == ["['a']", "['b']['c']", "['d']"]
    assert man_t["dtypes"] == man_j["dtypes"]
    assert man_t["shapes"] == man_j["shapes"]
    assert_tree_close(from_j, _tree_j(), 0, equal=True)
    assert_tree_close(_tree_t(), from_t, 0, equal=True)
    assert isinstance(from_j["a"], torch.Tensor)


# ------------------------------------------------------------------ fit

def quadratic(pkg):
    """tests/test_checkpoint.py's problem in either package."""
    target = [1.0, -2.0, 3.0, 0.5]
    if pkg == "jax":
        t = jnp.asarray(target)
        return ({"w": jnp.zeros((4,))},
                lambda p, b: jnp.sum((p["w"] - t) ** 2) * b["scale"],
                ({"scale": jnp.float32(1.0)} for _ in iter(int, 1)))
    t = torch.tensor(target)
    return ({"w": torch.zeros(4)},
            lambda p, b: torch.sum((p["w"] - t) ** 2) * b["scale"],
            ({"scale": torch.tensor(1.0)} for _ in iter(int, 1)))


def test_fit_resumes_after_preemption(tmp_path):
    class Boom(RuntimeError):
        pass

    def preempt(step):
        if step == 7:
            raise Boom()

    opt = AdamWConfig(lr=0.1, weight_decay=0.0)
    w, loss, data = quadratic("torch")
    d1 = str(tmp_path / "run")
    with pytest.raises(Boom):
        fit(loss, w, data, steps=20, opt_cfg=opt, ckpt_dir=d1, ckpt_every=2,
            log_every=100, preemption_hook=preempt, log=lambda s: None)
    logs = []
    w2, loss2, data2 = quadratic("torch")
    res = fit(loss2, w2, data2, steps=20, opt_cfg=opt, ckpt_dir=d1,
              ckpt_every=2, log_every=100, log=logs.append)
    assert logs[0] == "[fit] resumed from step 6"
    assert res.step == 20 and res.losses[-1][0] == 20

    w3, loss3, data3 = quadratic("torch")
    ref = fit(loss3, w3, data3, steps=20, opt_cfg=opt,
              ckpt_dir=str(tmp_path / "ref"), ckpt_every=100, log_every=100,
              log=lambda s: None)
    assert torch.equal(res.params["w"], ref.params["w"])

    wj, lossj, dataj = quadratic("jax")
    want = fit_j(lossj, wj, dataj, steps=20,
                 opt_cfg=AdamWConfigJ(lr=0.1, weight_decay=0.0),
                 ckpt_dir=str(tmp_path / "jax"), ckpt_every=100,
                 log_every=100, log=lambda s: None)
    np.testing.assert_allclose(res.params["w"].numpy(),
                               np.asarray(want.params["w"]), atol=1e-6)
    # repro's final checkpoint resumes in the port (a no-op run at step 20)
    w4, loss4, data4 = quadratic("torch")
    again = fit(loss4, w4, data4, steps=20, opt_cfg=opt,
                ckpt_dir=str(tmp_path / "jax"), log=lambda s: None)
    np.testing.assert_array_equal(again.params["w"].numpy(),
                                  np.asarray(want.params["w"]))
    assert int(again.opt_state["count"]) == 20


# ------------------------------------------------------- compressed psum

@pytest.fixture(scope="module")
def psum_case():
    rng = np.random.default_rng(5)
    return rng.normal(size=(WORLD, 33)).astype(np.float32) \
        * np.array([1.0, 3.0, 0.1, 10.0], np.float32)[:, None]


def test_compressed_psum_matches_repro(psum_case, multi_device_run,
                                       tmp_path_factory):
    ranks = _dist_ranks.run_ranks(
        _dist_ranks.run_cases,
        {"psum": ("case_compressed_psum", dict(xs=psum_case))}, WORLD,
        tmp_path_factory.mktemp("psum_ranks"))
    d = tmp_path_factory.mktemp("psum_repro")
    np.save(d / "in.npy", psum_case)
    multi_device_run(f"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.train.grad_compression import compressed_psum
xs = np.load({str(d / "in.npy")!r})
mesh = jax.make_mesh((4,), ("dp",), axis_types=(AxisType.Auto,))
with jax.set_mesh(mesh):
    out = jax.shard_map(lambda g: compressed_psum(g[0], "dp")[None],
                        mesh=mesh, in_specs=P("dp"), out_specs=P("dp"))(
        jnp.asarray(xs))
np.save({str(d / "out.npy")!r}, np.asarray(out))
""", devices=WORLD)
    want = np.load(d / "out.npy")
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["psum"], want[r])
    # close to the exact mean: one quantization step of the max scale
    step = np.abs(psum_case).max() / 127
    assert np.abs(want[0] - psum_case.mean(0)).max() <= step


def test_compressed_psum_one_process():
    g = torch.from_numpy(np.random.default_rng(6).normal(size=9)
                         .astype(np.float32))
    q, s = gc.compress(g)
    assert torch.equal(gc.compressed_psum(g), gc.decompress(q, s))


# ------------------------------------------------ K6 and K5 autograd

# (B, S, H, Hkv, D, window)
ATTN_GRAD = [(2, 24, 4, 2, 16, None), (1, 40, 8, 2, 16, 7),
             (1, 33, 4, 1, 32, 64)]


@pytest.mark.parametrize("blocks", [False, True], ids=["one_block", "blocks"])
@pytest.mark.parametrize("case", ATTN_GRAD, ids=str)
def test_flash_attention_grad(case, blocks, monkeypatch):
    B, S, H, Hkv, D, w = case
    if blocks:     # several query blocks in the backward
        monkeypatch.setattr(fa_ref, "BACKWARD_SCORES", B * H * 2 * S)
    rng = np.random.default_rng(sum(x or 0 for x in case))
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in
                   ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D),
                    (B, S, H, D)))

    def grads(prefer):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fa_ops.flash_attention(*leaves, causal=True, window=w,
                                     prefer=prefer)
        out.backward(torch.from_numpy(do))
        return out.detach(), [t.grad for t in leaves]

    out_fn, g_fn = grads("auto")          # FlashAttention (plain forward)
    out_ref, g_ref = grads("ref")         # autograd through the plain version
    assert torch.equal(out_fn, out_ref)
    for a, b in zip(g_fn, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)

    G = H // Hkv
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))

    def loss_j(qj, kj, vj):
        out = tj.blocked_attention(qj, jnp.repeat(kj, G, axis=2),
                                   jnp.repeat(vj, G, axis=2), q_pos=pos,
                                   block_q=16, block_kv=16, causal=True,
                                   window=w)
        return jnp.sum(out * jnp.asarray(do))

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    for a, b in zip(g_fn, g_j):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_flash_attention_grad_bf16():
    """In bf16 the written-out backward and autograd through the plain
    version differ by p's rounding (autograd also sends it through the row
    max): 2e-2 of each gradient's max, tests/test_kernels.py's bf16
    tolerance."""
    rng = np.random.default_rng(8)
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((2, 48, 8, 16), (2, 48, 2, 16), (2, 48, 2, 16), (2, 48, 8, 16))]

    def grads(prefer):
        leaves = [torch.from_numpy(a).bfloat16().requires_grad_()
                  for a in arrays[:3]]
        fa_ops.flash_attention(*leaves, causal=True, window=20,
                               prefer=prefer).backward(
            torch.from_numpy(arrays[3]).bfloat16())
        return [t.grad.float() for t in leaves]

    for a, b in zip(grads("auto"), grads("ref")):
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())


def test_flash_attention_grad_saves_only_inputs():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 1, 16, requires_grad=True)
    v = torch.randn(1, 8, 1, 16, requires_grad=True)
    out = fa_ops.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and all(s is t for s, t in zip(saved, (q, k, v)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_grad(dtype):
    rng = np.random.default_rng(7)
    V, d, nnz, n_bags = 50, 8, 200, 60
    table = rng.normal(size=(V, d)).astype(np.float32)
    idx = rng.integers(0, V - 5, nnz)                  # rows V-5.. unread
    seg = np.sort(rng.integers(0, n_bags, nnz))
    w = rng.normal(size=nnz).astype(np.float32)
    dout = rng.normal(size=(n_bags, d)).astype(np.float32)

    def grad(prefer):
        t = torch.from_numpy(table).to(dtype).requires_grad_()
        out = eb_ops.embedding_bag(t, torch.from_numpy(idx),
                                   torch.from_numpy(seg), n_bags,
                                   weights=torch.from_numpy(w), prefer=prefer)
        out.backward(torch.from_numpy(dout).to(dtype))
        return out.detach(), t.grad

    out_fn, g_fn = grad("auto")             # EmbeddingBag (transposed bag)
    out_ref, g_ref = grad("ref")            # autograd through the plain one
    assert torch.equal(out_fn, out_ref)
    assert g_fn.dtype == dtype
    if dtype == torch.float32:
        assert torch.equal(g_fn, g_ref)
    else:   # K5 sums a row's entries in fp32 and rounds once; the plain
        # backward adds them into the bf16 gradient one by one
        gap = (g_fn.float() - g_ref.float()).abs().max()
        assert float(gap) <= 2e-2 * float(g_ref.float().abs().max())
    assert float(g_fn[V - 5:].abs().max()) == 0.0      # unread rows: zero
    if dtype == torch.float32:
        def loss_j(tj_):
            rows = jnp.take(tj_, jnp.asarray(idx), axis=0) * jnp.asarray(w)[:, None]
            out = jax.ops.segment_sum(rows, jnp.asarray(seg), n_bags)
            return jnp.sum(out * jnp.asarray(dout))

        want = np.asarray(jax.grad(loss_j)(jnp.asarray(table)))
        np.testing.assert_allclose(g_fn.numpy(), want, atol=1e-6, rtol=1e-6)
