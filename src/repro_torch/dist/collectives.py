"""Distributed gather-scatter collectives (paper §5 across processes).

The port of `repro.dist.collectives`.  The paper's matrix-free Laplacian
``L x = d ⊙ x − A_w x`` distributes verbatim: each rank broadcasts its
elements' values to their vertices (local ``P``), sums them into the
*global* vertex-id space (local ``Qᵀ``: the ordered segment sum of
`repro_torch.core.gather_scatter`, deterministic on the card), ONE
all-reduce over the group completes the ``Q Qᵀ`` exchange, and a local
take copies the global sums back.  The one-process reference is
`repro_torch.core.gather_scatter`.

:func:`ring_allreduce` is the hand-rolled reference collective: a
rotate-and-accumulate ring whose N−1 hops each move one rank-sized buffer,
accumulated as `repro`'s ``acc + buf``, so rank r adds the ranks' values
in the order r, r−1, …, r−N+1, as `repro`'s shard r does.

Each call runs on ``x_local``'s device, across ``group`` (a
`torch.distributed` group, one rank a shard; the backend decides how a
tensor crosses: `repro_torch.dist.group`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gather_scatter import _handle, segment_sum
from repro_torch.dist import group as dist_group


def dist_lap_apply_allreduce(gid, x_local: torch.Tensor, deg: torch.Tensor,
                             n_global: int, group) -> torch.Tensor:
    """One rank's slice of ``L x = d ⊙ x − A_w x``.

    Parameters
    ----------
    gid : (E_loc, K) int — compacted global vertex ids of this rank's
        elements (a row-slice of `repro_torch.core.gather_scatter.GSHandle`
        ``.gid``); host or device.
    x_local : (E_loc,) float32 — this rank's element values.
    deg : (E_loc,) — this rank's slice of ``L.degree_full`` (= A_w·1,
        self terms included; they cancel against ``d ⊙ x`` exactly as in
        the one-process path).
    n_global : total distinct global vertex ids.
    group : the process group to all-reduce over (None: the default group).
    """
    grp = dist_group.active(group)
    if grp is None:
        raise ValueError("dist_lap_apply_allreduce needs a process group: "
                         "torch.distributed is not initialized")
    gid_h = (gid.cpu().numpy() if isinstance(gid, torch.Tensor)
             else np.asarray(gid))
    h = _handle(gid_h, n_global, x_local.device)
    k = gid_h.shape[-1]
    # P: broadcast each element value to its K vertices (local).
    u = x_local[..., None].expand(x_local.shape + (k,)).reshape(-1)
    # Qᵀ (partial): this rank's vertex values in the global id space.
    partial = segment_sum(h, u)
    # Complete Q Qᵀ with one all-reduce over the ranks.
    full = dist_group.all_reduce_sum(partial, grp)
    # Q + Pᵀ (local): copy global sums back, accumulate per element.
    aw_x = full.index_select(0, h.gid.reshape(-1)).reshape(h.gid.shape) \
        .sum(dim=-1)
    return deg * x_local - aw_x


def ring_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """Σ of ``x`` over ``group``'s ranks (None: the default group) by an
    N−1-hop ring: each hop sends the running buffer to the next rank and
    adds the one received from the previous rank (`repro`'s ``ppermute``
    ring; each link carries one buffer a hop)."""
    grp = dist_group.active(group)
    if grp is None:
        raise ValueError("ring_allreduce needs a process group: "
                         "torch.distributed is not initialized")
    acc, buf = x, x
    for _ in range(1, dist_group.size(grp)):
        # The N−1 hops ARE the ring schedule: the documented exception to
        # one collective a sweep, as in `repro`.
        buf = dist_group.shift(buf, grp)  # repro: ignore[DIST101]
        acc = acc + buf
    return acc
