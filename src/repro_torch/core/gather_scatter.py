"""Gather-scatter (gslib-style) evaluation of the dual-graph Laplacian.

The port of `repro.core.gather_scatter` (paper §5).  The weighted
adjacency of the dual graph is never assembled — it is applied
matrix-free as

    A_w = Pᵀ Q Qᵀ P

where `P` copies one value per element to its K vertices and `Q Qᵀ` is
the gather-scatter over shared vertex ids (sum values with equal global
id, copy the sum back).  With `d = A_w·1` the weighted Laplacian action is
``L x = d ⊙ x − A_w x``: an element's self-contribution through its own
vertices appears in both terms and cancels.  The unweighted Laplacian
counts each neighbour once by inclusion-exclusion over vertex, edge and
face tables, ``A_unw = A_vtx − A_edge + A_face``.

Setup (:func:`gs_setup`) is host NumPy: ``np.unique`` compacts the ids to
a contiguous range, bit-identical to `repro`'s.  It also builds, once, the
table of where each id occurs (``occ``: row j holds every id's j-th flat
position, in increasing order, or a position that reads zero past its
last), so the apply (:func:`gs_apply`) is an ordered segment sum plus one
take on the handle's device: one ``index_select`` and one add per row of
``occ`` (the ids' largest multiplicity: 8 for a hex mesh's vertices),
then ``index_select`` back, with no host sync.  Each id's values are
added in the order of their flat positions, starting from zero — the
order of a sequential scatter-add — so the apply is deterministic: the
same bits from run to run and on the CPU and the card, where float32
atomics (``index_add_``) add in no fixed order.  No Pallas kernel lies on
this path: `repro` computes it in plain ``jnp`` as well.

Tables are flat ``(E, K)`` or batched ``(B, E, K)``, the batched form
holding B independent problems, each with its own id space; a flat
handle also applies to values with extra leading dims.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class GSHandle:
    """The `Q Qᵀ` operator of one id table, on one device.

    gid      : (E, K) or (B, E, K) int64 — compacted ids per element
               (a 3-D table: B independent id spaces, ids < n_global each).
    n_global : number of ids (a shared upper bound for a batched table).
    occ      : (M, n_used) int64 — row j holds, for each id that occurs
               (in id order; batched: ids offset by b·n_global), the flat
               position of its j-th occurrence, or numel (a zero) past its
               last.
    take     : (numel,) int64 — each flat position's column of ``occ``.
    """

    gid: torch.Tensor
    n_global: int
    occ: torch.Tensor
    take: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.gid.device


def _handle(gid: np.ndarray, n_global: int, device) -> GSHandle:
    """A handle from a host table of compacted ids (2-D or 3-D)."""
    gid = np.asarray(gid, dtype=np.int64)
    flat = gid.ravel()
    if gid.ndim == 3:            # one id space per problem
        flat = (gid + n_global * np.arange(gid.shape[0])[:, None, None]).ravel()
    _, take, counts = np.unique(flat, return_inverse=True, return_counts=True)
    perm = np.argsort(take, kind="stable")      # positions, id by id
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(flat.size) - starts[take[perm]]
    occ = np.full((int(counts.max(initial=1)), counts.size), flat.size,
                  dtype=np.int64)
    occ[rank, take[perm]] = perm
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    return GSHandle(gid=put(gid), n_global=int(n_global), occ=put(occ),
                    take=put(take.reshape(-1)))


def gs_setup(gid_table: np.ndarray, *, device=None) -> GSHandle:
    """Compact a global-id table to contiguous ids (host; O(E·K log)
    sort) and put the handle on ``device`` (None: the card).  Mirrors
    gslib's ``gs_setup(global_num, m_L)`` discovery phase."""
    gid_table = np.asarray(gid_table)
    uniq, inv = np.unique(gid_table, return_inverse=True)
    return _handle(inv.reshape(gid_table.shape), int(uniq.size), device)


def _id_sums(handle: GSHandle, values: torch.Tensor) -> torch.Tensor:
    """(n_used, ...) — each occurring id's (numel, ...) values summed in
    the order of their flat positions, from zero; ids ascending."""
    ext = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    summed = values.new_zeros((handle.occ.shape[1],) + values.shape[1:])
    for col in handle.occ:
        summed = summed + ext.index_select(0, col)
    return summed


def _gs_values(handle: GSHandle, values: torch.Tensor) -> torch.Tensor:
    """`Q Qᵀ` of (numel, ...) values: `_id_sums`, copied back."""
    return _id_sums(handle, values).index_select(0, handle.take)


def segment_sum(handle: GSHandle, values: torch.Tensor) -> torch.Tensor:
    """`Qᵀ` of a flat handle: (numel,) values summed into the whole
    ``(n_global,)`` id space (``jax.ops.segment_sum(values, gid.ravel(),
    n_global)``), each id in the order of its flat positions; ids that do
    not occur are 0.  Deterministic, as `gs_apply` is."""
    flat = handle.gid.reshape(-1)
    ids = flat.new_empty(handle.occ.shape[1]).scatter_(0, handle.take, flat)
    out = values.new_zeros((handle.n_global,) + values.shape[1:])
    return out.index_copy_(0, ids, _id_sums(handle, values))


def gs_apply(handle: GSHandle, u_local: torch.Tensor) -> torch.Tensor:
    """`Q Qᵀ` — sum equal-id entries, copy the sums back (gslib ``gs_op``).

    ``u_local``: (..., E, K) values on local vertices.  A (B, E, K) handle
    pairs problem b's ids with ``u_local[b]``; a flat handle takes any
    number of leading dims."""
    shape = u_local.shape
    if handle.gid.ndim == 3 or u_local.ndim == handle.gid.ndim:
        return _gs_values(handle, u_local.reshape(-1)).reshape(shape)
    cols = u_local.reshape((-1, handle.take.numel())).T   # (E·K, M)
    return _gs_values(handle, cols).T.reshape(shape)


def aw_apply(handle: GSHandle, x: torch.Tensor) -> torch.Tensor:
    """`Pᵀ Q Qᵀ P x` — weighted-adjacency action (self-terms included).

    ``x``: (..., E).  P broadcasts x_e to the element's K vertices; Pᵀ
    sums back."""
    k = handle.gid.shape[-1]
    u_local = x[..., None].expand(x.shape + (k,))
    return gs_apply(handle, u_local).sum(dim=-1)


@dataclasses.dataclass(frozen=True, eq=False)
class GSLaplacian:
    """Matrix-free dual-graph Laplacian, weighted or unweighted.

    ``terms`` is a tuple of (sign, GSHandle): weighted ``[(+1, vertex)]``,
    unweighted ``[(+1, vertex), (−1, edge), (+1, face)]``.  Handles with
    (B, E, K) tables give an operator mapping (B, E) → (B, E).
    """

    terms: tuple
    n: int
    degree_full: torch.Tensor   # (..., E) Σ_j A[e, j]  (row sums incl. self terms)
    diag: torch.Tensor          # true Laplacian diagonal Σ_{j≠e} ω_ej

    @property
    def device(self) -> torch.device:
        return self.degree_full.device

    def adj_apply(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.zeros_like(x)
        for sign, h in self.terms:
            y = y + sign * aw_apply(h, x)
        return y

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """L x = (A·1) ⊙ x − A x — self terms cancel exactly."""
        return self.degree_full * x - self.adj_apply(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)


def _build(terms, n) -> GSLaplacian:
    # leading dims of the id tables (e.g. a batch axis) carry through
    h0 = terms[0][1]
    shape = h0.gid.shape[:-1]
    ones = torch.ones(shape, dtype=torch.float32, device=h0.device)
    deg_full = torch.zeros(shape, dtype=torch.float32, device=h0.device)
    self_count = torch.zeros(shape, dtype=torch.float32, device=h0.device)
    for sign, h in terms:
        deg_full = deg_full + sign * aw_apply(h, ones)
        # self contribution of element e through table h = K (ids distinct
        # within an element for well-formed hexes)
        self_count = self_count + sign * h.gid.shape[-1]
    return GSLaplacian(terms=tuple(terms), n=n, degree_full=deg_full,
                       diag=deg_full - self_count)


def weighted_laplacian(vert_gid: np.ndarray, *, device=None) -> GSLaplacian:
    """Weighted Laplacian (ω = number of shared vertices) from (E, 8) ids."""
    h = gs_setup(vert_gid, device=device)
    return _build([(1.0, h)], vert_gid.shape[0])


def unweighted_laplacian(vert_gid: np.ndarray, edge_gid: np.ndarray,
                         face_gid: np.ndarray, *, device=None) -> GSLaplacian:
    """Unweighted Laplacian via vertex − edge + face inclusion-exclusion."""
    hv = gs_setup(vert_gid, device=device)
    he = gs_setup(edge_gid, device=device)
    hf = gs_setup(face_gid, device=device)
    return _build([(1.0, hv), (-1.0, he), (1.0, hf)], vert_gid.shape[0])
