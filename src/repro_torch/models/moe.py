"""Mixture-of-Experts layer: shared + routed experts, top-k token choice.

Port of `repro.models.moe` (``MoEConfig``, ``init_moe``, ``capacity``,
``moe_apply``, ``load_balance_aux``) for serving.  The dispatch is
`repro`'s static-capacity one: token→expert assignments are sorted by
expert id (a stable sort) and scattered into a fixed ``(E, C, d)`` buffer,
``C = capacity(moe, T)``; an entry past its expert's ``C`` slots goes to
the overflow row ``E·C``, which is cut off, so tokens over capacity drop
exactly where `repro` drops them.  The three expert products are batched
matmuls over the ``(E, C, ·)`` buffer (`torch.bmm`, as `repro` leaves its
einsums to XLA): every expert's weights are multiplied each call, whether
or not a token reached it.

Routing is fp32: ``x.float() @ router``, softmax, top-k, renormalised by
``max(Σ, 1e-9)``.  The router is held in the layer's compute type (as
`repro`'s ``_cast_layers`` casts it) and used in fp32.

The combine is ordered and deterministic: each token's k contributions are
gathered and added one after another in ascending expert order, rounding
to the compute type at each add — the order of `repro`'s ``.at[st].add``
over the expert-sorted entries.  No atomics: two calls on the card give
the same bits, and the overflow row is the only place a scatter meets a
duplicate index.

`moe_apply_shardmap` is `repro`'s expert parallelism, run by each rank
of a (data, model) mesh on its own tokens: local routing and capacity, the
``(M, E_loc, C, d)`` buffer grouped by owner, one all-to-all over the
model axis and its reverse, the local experts, the same ordered combine
(the collectives of `repro_torch.dist.sharding.MeshRules`).

`moe_apply_pjit` is `repro`'s ``moe_apply`` as GSPMD partitions it under
``lm_rules`` (``impl="pjit"``, the MoE configs' default): the meaning of
the one-process layer on the global batch — the capacity from the global
token count, the kept entries chosen in global token order — with no
token feature moved between ranks: the (T, k) expert ids are all-gathered
(int32), every rank runs `dispatch` on them, and each rank fills and runs
the rows of its own experts with its own tokens; the partial sums add up
over the model axis.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models.common import dense_init
from repro_torch.obs.profiler import annotate


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001  # load-balance aux loss (GShard-style)
    impl: str = "pjit"                # "pjit" (sorted dispatch) | "shardmap" (EP a2a)


def init_moe(moe: MoEConfig, d_model: int, generator: torch.Generator,
             dtype) -> dict:
    """`repro`'s MoE tree: ``router`` (d, E) in fp32, ``wi``/``wg`` (E, d,
    f) and ``wo`` (E, f, d), and with shared experts ``shared_wi``/
    ``shared_wg`` (d, f·n_shared) and ``shared_wo`` (f·n_shared, d), in
    ``dtype``."""
    e, f = moe.n_experts, moe.d_ff_expert
    p = {
        "router": dense_init(generator, (d_model, e), dtype=torch.float32),
        "wi": dense_init(generator, (e, d_model, f), in_axis=1, dtype=dtype),
        "wg": dense_init(generator, (e, d_model, f), in_axis=1, dtype=dtype),
        "wo": dense_init(generator, (e, f, d_model), in_axis=1, dtype=dtype),
    }
    if moe.n_shared:
        fs = f * moe.n_shared
        p["shared_wi"] = dense_init(generator, (d_model, fs), dtype=dtype)
        p["shared_wg"] = dense_init(generator, (d_model, fs), dtype=dtype)
        p["shared_wo"] = dense_init(generator, (fs, d_model), dtype=dtype)
    return p


def capacity(moe: MoEConfig, n_tokens: int) -> int:
    c = int(n_tokens * moe.top_k * moe.capacity_factor / moe.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # a multiple of 8, as `repro`'s


def route(moe: MoEConfig, router: torch.Tensor, xt: torch.Tensor):
    """fp32 routing of tokens xt (T, d): the gates (T, E), the renormalised
    top-k weights (T, k) and expert ids (T, k), by descending gate."""
    gates = torch.softmax(xt.float() @ router.float(), dim=-1)
    top_w, top_e = torch.topk(gates, moe.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, top_w, top_e


def dispatch(moe: MoEConfig, top_e: torch.Tensor, n_tokens: int):
    """The static-capacity assignment of the (T, k) expert ids, in `repro`'s
    order: the entries sorted stably by expert, each entry's position in
    its expert's block, ``keep = position < C`` and its buffer row ``slot``
    (``E·C`` past capacity).  ``slot`` and ``keep`` are returned in the
    (T, k) layout of ``top_e``; with C."""
    E, k = moe.n_experts, moe.top_k
    C = capacity(moe, n_tokens)
    dev = top_e.device
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    seg_start = torch.searchsorted(se, torch.arange(E, device=dev),
                                   side="left")
    pos_in_e = torch.arange(n_tokens * k, device=dev) - seg_start[se]
    keep_s = pos_in_e < C
    slot_s = torch.where(keep_s, se * C + pos_in_e, E * C)
    slot = torch.empty_like(slot_s).index_put_((order,), slot_s)
    keep = torch.empty_like(keep_s).index_put_((order,), keep_s)
    return slot.view(n_tokens, k), keep.view(n_tokens, k), C


def expert_ffn(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLU over the (E, C, d) buffer: three batched
    matmuls, silu as ``g * sigmoid(g)``."""
    zg = torch.bmm(buf, p["wg"])
    z = zg * torch.sigmoid(zg) * torch.bmm(buf, p["wi"])
    return torch.bmm(z, p["wo"])


def combine(out_buf: torch.Tensor, top_e, top_w, slot, keep, dtype):
    """Each token's k expert outputs, weighted, added in ascending expert
    order (T, d); a dropped entry adds zero."""
    T, k = top_e.shape
    rank = torch.argsort(top_e, dim=-1)          # ascending expert id
    slot = torch.gather(slot, 1, rank).clamp_max(out_buf.shape[0] - 1)
    w = torch.gather(top_w * keep, 1, rank).to(dtype)
    contrib = out_buf[slot] * w[..., None]       # (T, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def fill(xt: torch.Tensor, slot: torch.Tensor, rows: int,
         dtype) -> torch.Tensor:
    """The (rows, d) capacity buffer: each kept (token, expert) entry's
    token at its ``slot`` (T, k) row, zeros elsewhere (`repro`'s
    ``.at[slot].set``; dropped entries land on the overflow row ``rows``,
    cut off)."""
    buf = torch.zeros((rows + 1, xt.shape[1]), dtype=dtype, device=xt.device)
    buf[slot.reshape(-1)] = xt.to(dtype).repeat_interleave(slot.shape[1], 0)
    return buf[:rows]


def shared_ffn(xt: torch.Tensor, wi, wg, wo, dtype) -> torch.Tensor:
    """The always-on shared experts' SwiGLU of tokens xt (T, d)."""
    xs = xt.to(dtype)
    g = xs @ wg
    return (g * torch.sigmoid(g) * (xs @ wi)) @ wo


def moe_apply(moe: MoEConfig, p: dict, x: torch.Tensor, dtype) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d), `repro`'s ``moe_apply``."""
    B, S, d = x.shape
    T, E = B * S, moe.n_experts
    xt = x.reshape(T, d)
    with annotate("moe:route"):
        _, top_w, top_e = route(moe, p["router"], xt)
    with annotate("moe:dispatch"):
        slot, keep, C = dispatch(moe, top_e, T)
        buf = fill(xt, slot, E * C, dtype).view(E, C, d)
    with annotate("moe:experts"):
        out_buf = expert_ffn(p, buf).reshape(E * C, d)
    with annotate("moe:combine"):
        y = combine(out_buf, top_e, top_w, slot, keep, dtype)
    if moe.n_shared:
        with annotate("moe:shared"):
            y = y + shared_ffn(xt, p["shared_wi"], p["shared_wg"],
                               p["shared_wo"], dtype)
    return y.reshape(B, S, d)


def moe_apply_shardmap(moe: MoEConfig, p: dict, x: torch.Tensor, *,
                       data_axes, model_axis: str, dtype, rules,
                       fsdp_gather: bool = False,
                       shared_gather: bool = True) -> torch.Tensor:
    """Expert-parallel MoE with local dispatch and all-to-all, `repro`'s
    ``moe_apply_shardmap`` on one rank of ``rules``' `DeviceMesh`.

    x (B_loc, S_loc, d) holds this rank's tokens: each rank routes only
    its own, with the capacity counted on them (``capacity(moe, T_loc)``),
    fills a local (E, C, d) buffer grouped by owner as (M, E_loc, C, d),
    and sends expert block ``m`` to the rank at ``model`` index ``m`` in
    one all-to-all over ``model_axis`` (the reverse all-to-all brings the
    outputs back).  ``p``'s ``wi``/``wg``/``wo`` are this rank's E_loc =
    E / M experts; with ``fsdp_gather`` their ``d`` dim arrives sharded
    over ``data_axes`` and is all-gathered first (its backward is the
    reduce-scatter).  The shared experts' f-slices are all-gathered over
    ``model_axis`` (``shared_gather=False``: they arrive whole), so each
    rank applies the whole shared FFN to its own tokens.  The combine is
    `combine`'s fixed order."""
    B, S, d = x.shape
    T = B * S
    M = rules.sizes[model_axis]
    xt = x.reshape(T, d)
    wi, wg, wo = p["wi"], p["wg"], p["wo"]            # (E_loc, d?, f)
    if fsdp_gather and data_axes:
        wi = rules.gather(wi, data_axes, 1)
        wg = rules.gather(wg, data_axes, 1)
        wo = rules.gather(wo, data_axes, 2)
    E = moe.n_experts
    E_loc = wi.shape[0]
    if E_loc * M != E:
        raise ValueError(f"{E_loc} local experts on {M} ranks of "
                         f"{model_axis!r}: the config has {E}")

    with annotate("moe:route"):
        _, top_w, top_e = route(moe, p["router"], xt)
    with annotate("moe:dispatch"):
        slot, keep, C = dispatch(moe, top_e, T)
        buf = fill(xt, slot, E * C, dtype).view(M, E_loc, C, d)
        recv = rules.all_to_all(buf, model_axis)     # (M, E_loc, C, d)
        tokens = recv.transpose(0, 1).reshape(E_loc, M * C, d)
    with annotate("moe:experts"):
        out = expert_ffn({"wi": wi, "wg": wg, "wo": wo}, tokens)
    with annotate("moe:dispatch"):
        back = out.reshape(E_loc, M, C, d).transpose(0, 1)
        out_buf = rules.all_to_all(back, model_axis).reshape(E * C, d)
    with annotate("moe:combine"):
        y = combine(out_buf, top_e, top_w, slot, keep, dtype)
    if moe.n_shared:
        with annotate("moe:shared"):
            swi, swg, swo = p["shared_wi"], p["shared_wg"], p["shared_wo"]
            if shared_gather:
                swi = rules.gather(swi, model_axis, 1)
                swg = rules.gather(swg, model_axis, 1)
                swo = rules.gather(swo, model_axis, 0)
            y = y + shared_ffn(xt, swi, swg, swo, dtype)
    return y.reshape(B, S, d)


def moe_apply_pjit(moe: MoEConfig, p: dict, x: torch.Tensor, *, dtype,
                   rules, data_axes=None, expert_axes=None,
                   fsdp_axes=None) -> torch.Tensor:
    """`repro`'s ``moe_apply`` (``impl="pjit"``) as GSPMD partitions it, on
    one rank of ``rules``' `DeviceMesh`: the partial sums of the routed
    experts this rank holds.

    x (B_loc, S, d) holds this rank's sequences, whole: its rows of the
    global batch, split over ``data_axes`` in rank order.  The meaning is
    the one-process `moe_apply`'s on the global batch — one stable sort of
    the global (T·k) assignments, ``C = capacity(moe, T)`` for the global
    token count T, each expert's first C entries kept in global token
    order — reached without moving token features between ranks: the rank
    routes its tokens with the replicated router, all-gathers the (T_loc,
    k) expert ids (int32) over ``data_axes`` in global token order, runs
    `dispatch` on them (the same ``slot`` and ``keep`` on every rank) and
    keeps its own tokens' entries.  ``p``'s ``wi``/``wg``/``wo`` are the
    E_loc experts of this rank's shard of ``expert_axes`` (all E when
    None); with ``fsdp_axes`` their ``d`` dim is all-gathered first (its
    backward is the reduce-scatter).  The rank fills its experts' (E_loc,
    C, d) rows with its own tokens — the rows of other ranks' tokens stay
    zero: the expert FFN works row by row and maps a zero row to zero —
    runs them, and combines in `combine`'s fixed order, every other
    expert's entry at weight 0.  The caller sums the partials over
    ``expert_axes`` (an all-reduce, or a reduce-scatter of the sequence)
    and adds the shared experts."""
    B, S, d = x.shape
    T, k = B * S, moe.top_k
    xt = x.reshape(T, d)
    wi, wg, wo = p["wi"], p["wg"], p["wo"]            # (E_loc, d?, f)
    if fsdp_axes:
        wi = rules.gather(wi, fsdp_axes, 1)
        wg = rules.gather(wg, fsdp_axes, 1)
        wo = rules.gather(wo, fsdp_axes, 2)
    E_loc = wi.shape[0]
    M = rules.count(expert_axes) if expert_axes else 1
    if E_loc * M != moe.n_experts:
        raise ValueError(f"{E_loc} local experts on {M} shards of "
                         f"{expert_axes!r}: the config has {moe.n_experts}")

    with annotate("moe:route"):
        _, top_w, top_e = route(moe, p["router"], xt)
    with annotate("moe:dispatch"):
        ids = top_e.to(torch.int32).view(B, S, k)
        first = 0
        if data_axes:
            ids = rules.gather(ids, data_axes, 0)
            first = rules.index(data_axes) * T
        n = ids.shape[0] * S
        slot, keep, C = dispatch(moe, ids.view(n, k).long(), n)
        slot, keep = slot[first:first + T], keep[first:first + T]
        rows = E_loc * C
        local = slot - (rules.index(expert_axes) * rows if expert_axes else 0)
        own = keep & (local >= 0) & (local < rows)
        local = torch.where(own, local, rows)
        buf = fill(xt, local, rows, dtype).view(E_loc, C, d)
    with annotate("moe:experts"):
        out = expert_ffn({"wi": wi, "wg": wg, "wo": wo}, buf).reshape(rows, d)
    with annotate("moe:combine"):
        y = combine(out, top_e, top_w, local, own, dtype)
    return y.reshape(B, S, d)


def load_balance_aux(gates: torch.Tensor, top_e: torch.Tensor,
                     n_experts: int) -> torch.Tensor:
    """GShard aux loss: E · Σ_e (fraction routed to e) · (mean gate of e)."""
    T = gates.shape[0]
    frac = torch.zeros(n_experts, device=gates.device).index_add_(
        0, top_e.reshape(-1), torch.ones(top_e.numel(), device=gates.device))
    frac = frac / (T * top_e.shape[-1])
    return n_experts * torch.sum(frac * gates.mean(0))


class MoE(nn.Module):
    """One layer's MoE weights in the compute type, under `repro`'s key
    names; ``forward(h, moe)`` is `moe_apply` with the config passed in
    (the model's, so a caller can change the capacity factor)."""

    def __init__(self, p: dict, dtype):
        super().__init__()
        self.dtype = dtype
        for name, t in p.items():
            setattr(self, name, nn.Parameter(t.to(dtype), requires_grad=False))

    def tree(self) -> dict:
        return dict(self.named_parameters(recurse=False))

    def forward(self, h: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
        return moe_apply(moe, self.tree(), h, self.dtype)
