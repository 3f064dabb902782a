"""Device-resident sharded boundary refinement over the HaloPlan.

The port of `repro.dist.refine_sharded`.  Each shard owns one part's node
block of the :class:`~repro_torch.dist.partition_aware.HaloPlan`, keeps
only its ELL-packed frontier adjacency, and every sweep makes exactly
**one gather of boundary labels** and **one connection-table launch**
(K4).

Protocol (per sweep)
--------------------
1. **Exchange** — every shard packs one row buffer:
   ``[frontier labels | pending gains | pending targets | local part
   weights | local part counts]``, and one gather replicates all P buffers
   (``P · (3·halo + 2·nparts)`` words).
2. **Gain table** — ONE batched connection-table launch
   (:func:`repro_torch.kernels.segment_sum.ops.connection_table_batched`,
   K4 on the card) computes every frontier node's (boundary × nparts)
   connection-weight table from the shard-local ELL adjacency, whose
   columns index the combined ``[local | gathered halo]`` label table.
3. **Conflict resolution** — *pending* proposals (computed last sweep and
   shipped in this sweep's gather) survive only if they beat every
   proposing neighbour on the ``(gain, node id)`` priority and their
   *fresh* gain, from this sweep's table, is still positive.  Survivors
   form an independent set, so the applied gains are exact and the cut is
   non-increasing.
4. **Corridor** — part weights and counts are reduced from the same
   gather, and one admission pass over all gathered proposals in
   ``(−gain, node id)`` order against the corridor's slack decides what
   may move; a shard applies ``admitted ∩ winners``.
5. **Propose** — fresh positive-gain proposals for the next sweep (first
   maximal target, cap-feasible only) ride the next gather.

One process drives one card, so all P shards form one group (G = P) and
the gather is the identity: `repro`'s one-device path.  :func:`_sweep_body`
takes the gather as a callable and the group's first shard as ``shard0``,
so a multi-process gather plugs in without a rewrite.

Where the port differs from `repro`'s device sweep, and why:

* **The admission pass runs on the host.**  `repro` replays it as a
  ``fori_loop`` over all M = P·halo proposal slots on the device; eager
  PyTorch would need ~10⁶ launches a sweep for that.  Invalid proposals
  change nothing in that loop, so it equals a loop over the valid ones in
  ``(−gain, gid)`` order, which is what `refine_sharded_host` runs.  The
  device sorts (a stable sort by gid, then a stable sort by −gain, as
  `jnp.argsort` sorts), the sorted proposals and the corridor's slack
  come to the host in ONE copy, the float32 loop runs in NumPy, and the
  admitted mask goes back in ONE copy.  With the per-sweep scalars
  (moves, gain, pending) that is two device-to-host copies and one
  host-to-device copy a sweep.
* **Part weights** are ``scatter_add_`` sums, atomic on the card, so their
  order is not fixed.  With integer node weights the float32 sums are
  exact in any order — the regime in which `repro` claims bit-parity
  between its device path and its host mirror (box and pebble meshes:
  node weights 1 or 2, edge weights 1, 2 or 4).  Non-integer weights may
  differ from `repro` in the last bit.
* **No fallback on the card.**  Like `repro`, the stages degrade to the
  host FM refiner (``"host-fallback"`` in the stage list) when the
  ``guard``'s deadline has expired, and, on the CPU, when the sweep path
  fails or returns invalid labels.  Unlike `repro`, any failure of the
  sweep path on the card raises, as does a kernel's or the card's fault
  anywhere (`~repro_torch.guard.policy.absorbable`).
  ``backend="host"`` runs the NumPy mirror only when asked.
* Observability as in `repro`: one ``sweep:<N>`` span per sweep with the
  ``halo_words``/``halo_bytes`` wire counters and ``sharded_gathers`` /
  ``sharded_sweeps`` (always equal: one gather and one K4 table a sweep)
  and ``sharded_moves``, taken from the host values the sweep's one
  scalar copy already brought back; ``sharded_sweeps_total`` around each
  stage's pass, ``refine_moves`` after it, and ``guard_fallbacks`` where
  the pass degrades to the host refiner.

Labels, proposals and the connection table stay on the device.
:func:`refine_sharded_host` is the NumPy mirror of the same arithmetic
(float32 where the device math is float32), copied from `repro`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.refine import (
    PostStats,
    SweepRecord,
    balance_corridor,
    close_with_repair,
    edge_cut,
    refine_boundary,
)
from repro_torch.device import resolve_device
from repro_torch.dist.partition_aware import (
    HaloPlan,
    plan_halo_sharding,
    scatter_features,
)
from repro_torch.guard.policy import absorbable
from repro_torch.kernels.segment_sum.ops import connection_table_batched

EPS = 1e-6   # strict-positive-gain threshold (f32-safe)


# ---------------------------------------------------------------------------
# Frontier plan: the static per-shard arrays of the sweep loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class FrontierPlan:
    """Host-side static arrays for the sharded refinement sweep: the
    HaloPlan's export rows re-packed as per-shard ELL frontier adjacency
    plus the index maps conflict resolution needs."""

    plan: HaloPlan
    w: int                      # padded max frontier degree
    exp_slot: np.ndarray        # (P, halo) int32 local slot of export row
    exp_slot_sc: np.ndarray     # (P, halo) int32 scatter slot (pad→n_local)
    exp_mask: np.ndarray        # (P, halo) float32
    exp_w: np.ndarray           # (P, halo) float32 node weight
    exp_gid: np.ndarray         # (P, halo) int32 global node id (−1 pad)
    ell_cols: np.ndarray        # (P, halo, w) int32 combined-space neighbor
    ell_wts: np.ndarray         # (P, halo, w) float32 edge weight (0 pad)
    nbr_prow: np.ndarray        # (P, halo, w) int32 neighbor's gathered
                                #   proposal row in [0, P·halo) or −1
    node_w: np.ndarray          # (P, n_local) float32 node weights (0 pad)
    node_mask: np.ndarray       # (P, n_local) float32 1.0 on real slots

    @property
    def gather_row_words(self) -> int:
        """Words one shard contributes to the per-sweep gather."""
        return 3 * self.plan.halo + 2 * self.plan.n_shards


def build_frontier_plan(graph, parts, nparts: int, *,
                        weights: np.ndarray | None = None,
                        plan: HaloPlan | None = None) -> FrontierPlan:
    """Re-pack a :class:`HaloPlan`'s export rows as frontier ELL adjacency.

    Host-side NumPy, O(nnz log nnz), bit-identical to `repro`'s.  Every
    edge whose destination is an export row lands in that row's ELL slots,
    sorted by (shard, row, combined source) so the accumulation order is
    canonical on both device and host paths.
    """
    if plan is None:
        plan = plan_halo_sharding(graph, parts, nparts)
    n, nsh, halo, n_local = graph.n, plan.n_shards, plan.halo, plan.n_local
    w_node = (np.ones(n, np.float32) if weights is None
              else np.asarray(weights, np.float32))

    node_of = np.full((nsh, n_local), -1, np.int64)
    node_of[plan.shard_of, plan.slot_of] = np.arange(n, dtype=np.int64)
    erow_of_slot = np.full((nsh, n_local), -1, np.int64)
    msh, mro = np.nonzero(plan.export_mask > 0)
    erow_of_slot[msh, plan.export_idx[msh, mro]] = mro

    exp_gid = np.full((nsh, halo), -1, np.int32)
    exp_w = np.zeros((nsh, halo), np.float32)
    if msh.size:
        gids = node_of[msh, plan.export_idx[msh, mro]]
        exp_gid[msh, mro] = gids.astype(np.int32)
        exp_w[msh, mro] = w_node[gids]

    es, ep = np.nonzero(plan.edge_mask > 0)
    dst = plan.edge_dst[es, ep]
    src = plan.edge_src[es, ep]
    ew = plan.edge_weight[es, ep]
    row = erow_of_slot[es, dst]
    sel = row >= 0
    es, src, ew, row = es[sel], src[sel], ew[sel], row[sel]
    order = np.lexsort((src, row, es))
    es, src, ew, row = es[order], src[order], ew[order], row[order]

    key = es * np.int64(halo) + row
    cnt = np.bincount(key, minlength=nsh * halo) if key.size else \
        np.zeros(nsh * halo, np.int64)
    wmax = max(1, int(cnt.max())) if cnt.size else 1
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    pos = np.arange(key.size, dtype=np.int64) - starts[key]

    ell_cols = np.zeros((nsh, halo, wmax), np.int32)
    ell_wts = np.zeros((nsh, halo, wmax), np.float32)
    nbr_prow = np.full((nsh, halo, wmax), -1, np.int32)
    if key.size:
        ell_cols[es, row, pos] = src.astype(np.int32)
        ell_wts[es, row, pos] = ew.astype(np.float32)
        local = src < n_local
        loc_row = erow_of_slot[es, np.clip(src, 0, n_local - 1)]
        prow = np.where(
            local,
            np.where(loc_row >= 0, es * np.int64(halo) + loc_row, -1),
            src - n_local,
        )
        nbr_prow[es, row, pos] = prow.astype(np.int32)

    return FrontierPlan(
        plan=plan, w=wmax,
        exp_slot=plan.export_idx.astype(np.int32),
        exp_slot_sc=np.where(plan.export_mask > 0, plan.export_idx,
                             n_local).astype(np.int32),
        exp_mask=plan.export_mask.astype(np.float32),
        exp_w=exp_w, exp_gid=exp_gid,
        ell_cols=ell_cols, ell_wts=ell_wts, nbr_prow=nbr_prow,
        node_w=scatter_features(plan, w_node).astype(np.float32),
        node_mask=scatter_features(plan, np.ones(n, np.float32)),
    )


# ---------------------------------------------------------------------------
# The device sweep (ONE gather + ONE connection-table launch per call)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Consts:
    """A frontier plan's arrays on the device, in the types the sweep
    indexes with (torch gathers and scatters take int64 indices)."""

    exp_slot: torch.Tensor      # (G, halo) int64
    exp_slot_sc: torch.Tensor   # (G, halo) int64, pad rows → n_local
    exp_mask: torch.Tensor      # (G, halo) bool
    exp_w: torch.Tensor         # (G, halo) float32
    exp_gid: torch.Tensor       # (G, halo) int32
    ell_cols: torch.Tensor      # (G, halo, w) int32 — K4's cols
    ell_wts: torch.Tensor       # (G, halo, w) float32 — K4's wts
    nbr_prow: torch.Tensor      # (G, halo, w) int64
    node_w: torch.Tensor        # (G, n_local) float32
    node_mask: torch.Tensor     # (G, n_local) float32
    prow_gid: torch.Tensor      # (P·halo,) int32, every shard's gids
    exp_w_flat: torch.Tensor    # (P·halo,) float32


def _device_consts(fp: FrontierPlan, device) -> _Consts:
    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    return _Consts(
        exp_slot=dev(fp.exp_slot, torch.int64),
        exp_slot_sc=dev(fp.exp_slot_sc, torch.int64),
        exp_mask=dev(fp.exp_mask > 0, torch.bool),
        exp_w=dev(fp.exp_w, torch.float32),
        exp_gid=dev(fp.exp_gid, torch.int32),
        ell_cols=dev(fp.ell_cols, torch.int32),
        ell_wts=dev(fp.ell_wts, torch.float32),
        nbr_prow=dev(fp.nbr_prow, torch.int64),
        node_w=dev(fp.node_w, torch.float32),
        node_mask=dev(fp.node_mask, torch.float32),
        prow_gid=dev(fp.exp_gid.reshape(-1), torch.int32),
        exp_w_flat=dev(fp.exp_w.reshape(-1), torch.float32),
    )


def _identity_gather(buf: torch.Tensor) -> torch.Tensor:
    """The gather of a group that holds every shard (G == P)."""
    return buf


class _HostAdmission:
    """The corridor-admission pass: the device sorts the gathered proposals
    by (−gain, gid), ONE copy brings the sorted proposals and the slack to
    the host, the float32 loop of :func:`refine_sharded_host` runs over the
    valid ones, and ONE copy takes the admitted mask back.  ``seconds``
    sums the host loop's time (after the copy in, to the copy out)."""

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, gain, tgt, src, w, valid, gid,
                 cap_room, floor_room, cnt_room) -> torch.Tensor:
        M, nparts = gain.shape[0], cap_room.shape[0]
        order = torch.sort(gid, stable=True).indices      # ascending gid
        order = order[torch.sort(-gain[order], stable=True).indices]
        packed = torch.cat([valid[order].to(torch.float32),
                            tgt[order].to(torch.float32),
                            src[order].to(torch.float32), w[order],
                            cap_room, floor_room, cnt_room])
        host = packed.cpu().numpy()                        # the copy in
        t0 = time.perf_counter()
        valid_h, tgt_h, src_h, w_h = host[:4 * M].reshape(4, M)
        cap_h, floor_h, cnt_h = host[4 * M:].reshape(3, nparts)
        add_u = np.zeros(nparts, np.float32)
        rem_u = np.zeros(nparts, np.float32)
        cnt_u = np.zeros(nparts, np.float32)
        adm_sorted = np.zeros(M, bool)
        for t in np.flatnonzero(valid_h > 0).tolist():
            ti, si = int(tgt_h[t]), int(src_h[t])
            wi = w_h[t]
            if (add_u[ti] + wi <= cap_h[ti]
                    and rem_u[si] + wi <= floor_h[si]
                    and cnt_u[si] + 1.0 <= cnt_h[si]):
                add_u[ti] += wi
                rem_u[si] += wi
                cnt_u[si] += 1.0
                adm_sorted[t] = True
        adm = torch.from_numpy(adm_sorted).to(gain.device)  # the copy out
        self.seconds += time.perf_counter() - t0
        out = torch.zeros(M, dtype=torch.bool, device=gain.device)
        out[order] = adm
        return out


def _set_drop(labels: torch.Tensor, slots: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """Row-wise ``labels[g, slots[g, i]] = values[g, i]``, dropping slots
    ``== n_local`` — `repro`'s ``.at[s].set(v, mode="drop")``, where torch's
    ``scatter_`` would raise: the pad rows scatter into one extra column,
    which is then cut off."""
    G, n_local = labels.shape
    padded = torch.cat([labels, labels.new_zeros((G, 1))], dim=1)
    padded.scatter_(1, slots, values)
    return padded[:, :n_local].contiguous()


def _sweep_body(gather, admit, shard0, nparts, floor, cap,
                labels, pgain, ptgt, c: _Consts):
    """One sweep on a group of G shards starting at shard ``shard0``:
    ``gather`` replicates the (G, L) buffers of all P shards (the identity
    when G == P), ``admit`` is the admission pass over all P·halo gathered
    proposals.  Returns the new labels, the next sweep's proposals and the
    per-shard (moves, gain, pending)."""
    G = labels.shape[0]
    halo = c.exp_slot.shape[1]
    dev = labels.device
    floor = float(np.float32(floor))
    cap = float(np.float32(cap))
    neg_inf = float("-inf")

    # 1. pack + ONE gather of boundary labels (+ piggybacked proposals and
    #    part weight/count partials — same buffer).
    exp_lab = torch.gather(labels, 1, c.exp_slot)                # (G, halo)
    lab64 = labels.long()
    pw_loc = torch.zeros((G, nparts), dtype=torch.float32, device=dev) \
        .scatter_add_(1, lab64, c.node_w)
    pn_loc = torch.zeros((G, nparts), dtype=torch.float32, device=dev) \
        .scatter_add_(1, lab64, c.node_mask)
    buf = torch.cat([exp_lab.to(torch.float32), pgain,
                     ptgt.to(torch.float32), pw_loc, pn_loc], dim=1)
    allbuf = gather(buf)                                         # (P, L)

    all_lab = allbuf[:, :halo].to(torch.int32).reshape(-1)       # (P·halo,)
    all_gain = allbuf[:, halo:2 * halo].reshape(-1)
    all_tgt = allbuf[:, 2 * halo:3 * halo].to(torch.int32).reshape(-1)
    pw = allbuf[:, 3 * halo:3 * halo + nparts].sum(dim=0)        # (nparts,)
    pn = allbuf[:, 3 * halo + nparts:].sum(dim=0)

    # 2. ONE batched connection-table launch: the (boundary × nparts) table.
    combined = torch.cat([labels, all_lab.expand(G, -1)], dim=1)
    conn = connection_table_batched(combined, c.ell_cols, c.ell_wts,
                                    nparts)                      # (G,halo,np)
    own = exp_lab.long()
    internal = torch.gather(conn, 2, own[..., None])[..., 0]

    # 3. resolve pending proposals: (gain, node id) priority against every
    #    proposing neighbour (all visible — they are all boundary rows).
    valid = c.exp_mask & (pgain > EPS) & (ptgt >= 0)
    has = c.nbr_prow >= 0
    safe = c.nbr_prow.clamp(min=0)
    nb_gain = torch.where(has, all_gain[safe], neg_inf)
    nb_tgt = torch.where(has, all_tgt[safe], -1)
    nb_gid = torch.where(has, c.prow_gid[safe], -1)
    nb_valid = has & (nb_gain > EPS) & (nb_tgt >= 0)
    my_gain = pgain[..., None]
    my_gid = c.exp_gid[..., None]
    beaten = nb_valid & ((nb_gain > my_gain)
                         | ((nb_gain == my_gain) & (nb_gid < my_gid)))
    fresh = torch.gather(conn, 2, ptgt.clamp(min=0).long()[..., None])[..., 0] \
        - internal
    winner = valid & ~beaten.any(dim=-1) & (fresh > EPS)

    # 4. corridor on the reduced part weights: the admission pass over all
    #    gathered proposals, then this group's rows of the result.
    cap_room = (cap - pw).clamp(min=0.0)
    floor_room = (pw - floor).clamp(min=0.0)
    cnt_room = torch.floor((pn - 1.0).clamp(min=0.0))
    prop_valid = (all_gain > EPS) & (all_tgt >= 0)
    adm_flat = admit(all_gain, all_tgt, all_lab, c.exp_w_flat, prop_valid,
                     c.prow_gid, cap_room, floor_room, cnt_room)
    my_adm = adm_flat.reshape(-1, halo)[shard0:shard0 + G]       # (G, halo)
    admitted = winner & my_adm
    labels = _set_drop(labels, c.exp_slot_sc,
                       torch.where(admitted, ptgt, exp_lab))

    # 5. fresh proposals for the next sweep (skip rows that just moved).
    iota = torch.arange(nparts, device=dev)
    conn2 = torch.where(iota == own[..., None], neg_inf, conn)
    conn2 = torch.where(pw + c.exp_w[..., None] <= cap, conn2, neg_inf)
    best = conn2.argmax(dim=-1)                                  # first max
    bgain = torch.gather(conn2, 2, best[..., None])[..., 0] - internal
    src_ok = (pw[own] - c.exp_w >= floor) & (pn[own] > 1.5)
    ok = c.exp_mask & ~admitted & src_ok & (bgain > EPS) & torch.isfinite(bgain)
    ngain = torch.where(ok, bgain, -1.0)
    ntgt = torch.where(ok, best.to(torch.int32), -1)

    moves = admitted.sum(dim=1).to(torch.float32)                # (G,)
    gained = torch.where(admitted, fresh, 0.0).sum(dim=1)
    pending = ok.sum(dim=1).to(torch.float32)
    return labels, ngain, ntgt, moves, gained, pending


# ---------------------------------------------------------------------------
# Sweep runners (device + NumPy mirror)
# ---------------------------------------------------------------------------

_BACKENDS = ("auto", "device", "host")


def run_sharded_sweeps(fp: FrontierPlan, parts: np.ndarray, nparts: int, *,
                       sweeps: int = 4, corridor: tuple,
                       backend: str = "auto", device=None):
    """Run the sharded sweep loop; returns ``(labels, records, info)``.

    ``sweeps`` counts gather rounds (the first round only seeds proposals,
    so moves land from round 2 on).  ``backend``: "auto"/"device" runs the
    sweep on ``device`` (None: the card) with one connection-table launch
    per sweep (K4 on the card, its plain version on the CPU); "host" runs
    the NumPy mirror.  ``info``: ``moves``, ``gathers`` (sweeps run — one
    gather and one table each), ``cut``, and on the device path
    ``sweep_seconds`` (its wall time, the plan's upload included) and
    ``admit_seconds`` (its host admission loops).
    """
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend: {backend!r} (have {_BACKENDS})")
    plan = fp.plan
    parts = np.asarray(parts, dtype=np.int64)
    cut0 = _plan_cut(fp, parts)
    if plan.halo == 0 or sweeps <= 0:       # no cross-shard frontier
        return parts.copy(), [], {"moves": 0, "gathers": 0, "cut": cut0}
    if backend == "host":
        return refine_sharded_host(fp, parts, nparts, sweeps=sweeps,
                                   corridor=corridor)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    consts = _device_consts(fp, dev)
    admit = _HostAdmission()
    nsh, halo = plan.n_shards, plan.halo
    labels = torch.from_numpy(
        scatter_features(plan, parts).astype(np.int32)).to(dev)
    pgain = torch.full((nsh, halo), -1.0, dtype=torch.float32, device=dev)
    ptgt = torch.full((nsh, halo), -1, dtype=torch.int32, device=dev)

    records, total_moves, gathers, cut = [], 0, 0, cut0
    words = nsh * fp.gather_row_words
    for s in range(sweeps):
        with obs.timed(f"sweep:{s}"):
            labels, pgain, ptgt, mv, gn, pend = _sweep_body(
                _identity_gather, admit, 0, nparts, corridor[0], corridor[1],
                labels, pgain, ptgt, consts)
            per_shard = torch.stack([mv, gn, pend]).cpu().numpy()  # (3, G)
            mv = int(per_shard[0].sum())
            gn = float(per_shard[1].sum())
            pend = int(per_shard[2].sum())
            gathers += 1
            obs.counter_add("halo_words", float(words))
            obs.counter_add("halo_bytes", 4.0 * words)
            obs.counter_add("sharded_gathers", 1)
            obs.counter_add("sharded_sweeps", 1)
            obs.counter_add("sharded_moves", mv)
        records.append(SweepRecord(sweep=s, moves=mv, cut_before=cut,
                                   cut_after=cut - gn))
        cut -= gn
        total_moves += mv
        if mv == 0 and pend == 0:
            break

    blocks = labels.cpu().numpy().astype(np.int64)
    out = blocks[plan.shard_of, plan.slot_of]
    return out, records, {"moves": total_moves, "gathers": gathers,
                          "cut": cut,
                          "sweep_seconds": time.perf_counter() - t0,
                          "admit_seconds": admit.seconds}


def _plan_cut(fp: FrontierPlan, parts: np.ndarray) -> float:
    """Edge cut from the plan's own edge lists (no global graph needed)."""
    plan = fp.plan
    sel = plan.edge_mask > 0
    es, ep = np.nonzero(sel)
    dst_g = np.full((plan.n_shards, plan.n_local), 0, np.int64)
    dst_g[plan.shard_of, plan.slot_of] = parts
    combined = _combined_labels_host(fp, parts)
    pd = dst_g[es, plan.edge_dst[es, ep]]
    ps = combined[es, plan.edge_src[es, ep]]
    return float(plan.edge_weight[es, ep][pd != ps].sum() / 2.0)


def _combined_labels_host(fp: FrontierPlan, parts: np.ndarray) -> np.ndarray:
    """(P, n_local + P·halo) combined label table, NumPy."""
    plan = fp.plan
    blocks = scatter_features(plan, parts).astype(np.int64)
    msh, mro = np.nonzero(fp.exp_mask > 0)
    halo_lab = np.zeros(plan.n_shards * plan.halo, np.int64)
    halo_lab[msh * plan.halo + mro] = blocks[msh, fp.exp_slot[msh, mro]]
    return np.concatenate(
        [blocks, np.broadcast_to(halo_lab, (plan.n_shards, halo_lab.size))],
        axis=1)


def refine_sharded_host(fp: FrontierPlan, parts: np.ndarray, nparts: int, *,
                        sweeps: int = 4, corridor: tuple):
    """NumPy mirror of the device sweep — same protocol, same float32
    arithmetic, same tie-breaks — for bit-parity tests and as the
    reference the device path is audited against."""
    plan = fp.plan
    nsh, halo = plan.n_shards, plan.halo
    floor = np.float32(corridor[0])
    cap = np.float32(corridor[1])

    labels = scatter_features(plan, np.asarray(parts, np.int64))
    pgain = np.full((nsh, halo), -1.0, np.float32)
    ptgt = np.full((nsh, halo), -1, np.int32)
    mask = fp.exp_mask > 0
    cut = _plan_cut(fp, np.asarray(parts, np.int64))

    records, total_moves, gathers = [], 0, 0
    for s in range(sweeps):
        # 1. "gather": labels + proposals + part weight/count partials.
        exp_lab = np.take_along_axis(labels, fp.exp_slot.astype(np.int64),
                                     axis=1)
        pw = np.zeros(nparts, np.float32)
        pn = np.zeros(nparts, np.float32)
        for g in range(nsh):   # f32 accumulation, shard-major like device
            np.add.at(pw, labels[g], fp.node_w[g])
            np.add.at(pn, labels[g], fp.node_mask[g])
        all_lab = np.where(mask, exp_lab, 0).reshape(-1)
        all_gain = pgain.reshape(-1)
        all_tgt = ptgt.reshape(-1)
        gathers += 1

        # 2. connection table (f32; canonical ELL slot order).
        combined = np.concatenate(
            [labels, np.broadcast_to(all_lab, (nsh, all_lab.size))], axis=1)
        conn = np.zeros((nsh, halo, nparts), np.float32)
        gi, ri, ki = np.nonzero(fp.ell_wts > 0)
        lab_n = combined[gi, fp.ell_cols[gi, ri, ki]]
        np.add.at(conn, (gi, ri, lab_n), fp.ell_wts[gi, ri, ki])
        own = exp_lab
        ar_g, ar_r = np.meshgrid(np.arange(nsh), np.arange(halo),
                                 indexing="ij")
        internal = conn[ar_g, ar_r, np.where(mask, own, 0)]

        # 3. resolve pending proposals.
        valid = mask & (pgain > EPS) & (ptgt >= 0)
        safe = np.clip(fp.nbr_prow, 0, None)
        has = fp.nbr_prow >= 0
        nb_gain = np.where(has, all_gain[safe], -np.inf)
        nb_tgt = np.where(has, all_tgt[safe], -1)
        nb_gid = np.where(has, fp.exp_gid.reshape(-1)[safe], -1)
        nb_valid = has & (nb_gain > EPS) & (nb_tgt >= 0)
        beaten = (nb_valid & ((nb_gain > pgain[..., None])
                              | ((nb_gain == pgain[..., None])
                                 & (nb_gid < fp.exp_gid[..., None]))))
        fresh = conn[ar_g, ar_r, np.clip(ptgt, 0, None)] - internal
        winner = valid & ~beaten.any(axis=-1) & (fresh > EPS)

        # 4. the replicated global corridor-admission pass (identical to
        #    every shard's device-side replay), then admitted ∩ winners.
        cap_room = np.maximum(cap - pw, 0.0).astype(np.float32)
        floor_room = np.maximum(pw - floor, 0.0).astype(np.float32)
        cnt_room = np.floor(np.maximum(pn - 1.0, 0.0)).astype(np.float32)
        prop_valid = (all_gain > EPS) & (all_tgt >= 0)
        all_w = fp.exp_w.reshape(-1)
        gid_flat = fp.exp_gid.reshape(-1)
        order = np.argsort(gid_flat, kind="stable")
        order = order[np.argsort(-all_gain[order], kind="stable")]
        add_u = np.zeros(nparts, np.float32)
        rem_u = np.zeros(nparts, np.float32)
        cnt_u = np.zeros(nparts, np.float32)
        adm_flat = np.zeros(nsh * halo, bool)
        for i in order:
            if not prop_valid[i]:
                continue
            ti, si = int(all_tgt[i]), int(all_lab[i])
            wi = all_w[i]
            if (add_u[ti] + wi <= cap_room[ti]
                    and rem_u[si] + wi <= floor_room[si]
                    and cnt_u[si] + 1.0 <= cnt_room[si]):
                add_u[ti] += wi
                rem_u[si] += wi
                cnt_u[si] += 1.0
                adm_flat[i] = True
        admitted = winner & adm_flat.reshape(nsh, halo)
        moves = int(admitted.sum())
        gained = np.float32(0.0)
        for g, i in zip(*np.nonzero(admitted)):
            labels[g, fp.exp_slot[g, i]] = ptgt[g, i]
            gained += fresh[g, i]

        # 5. fresh proposals for the next sweep.
        conn2 = conn.copy()
        conn2[ar_g, ar_r, np.where(mask, own, 0)] = -np.inf
        tgt_fits = pw[None, None, :] + fp.exp_w[..., None] <= cap
        conn2 = np.where(tgt_fits, conn2, -np.inf)
        best = conn2.argmax(axis=-1).astype(np.int32)
        bgain = conn2[ar_g, ar_r, best] - internal
        src_ok = (pw[np.where(mask, own, 0)] - fp.exp_w >= floor) \
            & (pn[np.where(mask, own, 0)] > 1.5)
        ok = mask & ~admitted & src_ok & (bgain > EPS) & np.isfinite(bgain)
        pgain = np.where(ok, bgain, -1.0).astype(np.float32)
        ptgt = np.where(ok, best, -1).astype(np.int32)

        records.append(SweepRecord(sweep=s, moves=moves, cut_before=cut,
                                   cut_after=cut - float(gained)))
        cut -= float(gained)
        total_moves += moves
        if moves == 0 and not ok.any():
            break

    out = labels[plan.shard_of, plan.slot_of]
    return out, records, {"moves": total_moves, "gathers": gathers,
                          "cut": cut}


# ---------------------------------------------------------------------------
# Pipeline post stages
# ---------------------------------------------------------------------------

def _sharded_pass(graph, parts, nparts, *, weights, sweeps, corridor,
                  backend, guard, device, stats: PostStats) -> np.ndarray:
    """Shared core of the two stages: guard envelope → frontier plan →
    sharded sweeps → validity checks, falling back to the host FM refiner
    where `repro` does, except on the card (module docstring).
    ``stats.sharded`` gets the run's ``info`` plus ``plan_seconds``."""
    parts = np.asarray(parts, dtype=np.int64)
    if guard is not None and getattr(guard, "expired", lambda: False)():
        stats.stages.append("host-fallback")
        return refine_boundary(graph, parts, nparts, weights=weights,
                               sweeps=sweeps, corridor=corridor)[0]
    # Resolved outside the envelope: a missing card is no sweep failure.
    dev = None if backend == "host" else resolve_device(device)
    try:
        t0 = time.perf_counter()
        fp = build_frontier_plan(graph, parts, nparts, weights=weights)
        plan_s = time.perf_counter() - t0
        out, records, info = run_sharded_sweeps(
            fp, parts, nparts, sweeps=sweeps, corridor=corridor,
            backend=backend, device=dev)
        out = np.asarray(out, dtype=np.int64)
        if out.shape != parts.shape or out.min() < 0 or out.max() >= nparts:
            raise ValueError("sharded refinement produced invalid labels")
        cut_now = edge_cut(graph, out)
        if cut_now > stats.cut_before + 1e-6:
            raise ValueError(f"sharded refinement increased the cut "
                             f"({stats.cut_before} -> {cut_now})")
    except Exception as exc:
        if not absorbable(exc, dev):
            raise
        # The exchange/sweep path failed off the card: degrade to the host
        # FM refiner rather than ship a corrupt partition.
        obs.counter_add("guard_fallbacks", 1)
        stats.stages.append("host-fallback")
        out, fstats = refine_boundary(graph, parts, nparts, weights=weights,
                                      sweeps=sweeps, corridor=corridor)
        stats.sweeps.extend(fstats.sweeps)
        stats.moves_applied += fstats.moves_applied
        return out
    stats.sweeps.extend(records)
    stats.moves_applied += info["moves"]
    stats.sharded = dict(info, plan_seconds=plan_s, halo=fp.plan.halo,
                         w=fp.w, m=fp.plan.n_local
                         + fp.plan.n_shards * fp.plan.halo)
    return out


def refine_sharded_stage(
    graph,
    parts: np.ndarray,
    nparts: int,
    *,
    weights: np.ndarray | None = None,
    sweeps: int = 4,
    balance_tol: float = 0.05,
    corridor: tuple | None = None,
    backend: str = "auto",
    guard=None,
    device=None,
) -> tuple[np.ndarray, PostStats]:
    """The pipeline's "refine-sharded" stage: device-resident frontier FM
    sweeps (one boundary-label gather and one K4 table per sweep) + a
    closing repair pass.  Cut-non-increasing under ONE corridor, like the
    host stage.  ``device``: where the sweeps run (None: the card)."""
    if corridor is None:
        corridor = balance_corridor(parts, nparts, weights, balance_tol)
    stats = PostStats(stages=["refine-sharded"], corridor=tuple(corridor),
                      cut_before=edge_cut(graph, parts))
    with obs.timed("sharded_sweeps_total") as t:
        parts = _sharded_pass(graph, parts, nparts, weights=weights,
                              sweeps=sweeps, corridor=corridor,
                              backend=backend, guard=guard, device=device,
                              stats=stats)
    stats.seconds = t.seconds
    obs.counter_add("refine_moves", stats.moves_applied)
    return close_with_repair(graph, parts, nparts, stats, weights=weights,
                             balance_tol=balance_tol, corridor=corridor)


def kway_sharded_stage(
    graph,
    parts: np.ndarray,
    nparts: int,
    *,
    weights: np.ndarray | None = None,
    sweeps: int = 4,
    passes: int = 2,
    balance_tol: float = 0.05,
    corridor: tuple | None = None,
    backend: str = "auto",
    guard=None,
    device=None,
) -> tuple[np.ndarray, PostStats]:
    """The "kway-sharded" stage: sharded frontier sweeps for the bulk of
    the gain, then a host boundary-restricted hill-climbing k-way polish
    (the part that needs global move ordering), then the closing repair."""
    from repro_torch.core.kway import kway_fm_boundary

    if corridor is None:
        corridor = balance_corridor(parts, nparts, weights, balance_tol)
    stats = PostStats(stages=["kway-sharded"], corridor=tuple(corridor),
                      cut_before=edge_cut(graph, parts))
    with obs.timed("sharded_sweeps_total") as t:
        parts = _sharded_pass(graph, parts, nparts, weights=weights,
                              sweeps=sweeps, corridor=corridor,
                              backend=backend, guard=guard, device=device,
                              stats=stats)
    stats.seconds = t.seconds
    parts, kstats = kway_fm_boundary(graph, parts, nparts, weights=weights,
                                     passes=passes, corridor=corridor)
    stats.kway = kstats.kway
    stats.moves_applied += kstats.moves_applied
    stats.seconds += kstats.seconds
    obs.counter_add("refine_moves", stats.moves_applied)
    return close_with_repair(graph, parts, nparts, stats, weights=weights,
                             balance_tol=balance_tol, corridor=corridor)
