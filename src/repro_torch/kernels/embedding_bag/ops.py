"""Public dispatch for K5, the embedding bag.

``prefer``:

* ``"auto"`` (default) — the CUDA kernel for CUDA tensors, the plain
  PyTorch version (`ref.embedding_bag_ref`) for CPU tensors;
* ``"cuda"`` — the CUDA kernel; raises for a CPU tensor;
* ``"ref"`` — the plain version on any device.

There is no fallback: on a CUDA tensor a build or launch failure raises.
`repro` pads the row width to 128 lanes for the Pallas kernel; nothing
binds the port to that, so nothing is padded here.

Gradients.  Where the table requires a gradient (and grad mode is on), a
call that takes the kernel (or, on the CPU, its plain version) goes
through :class:`EmbeddingBag`, a `torch.autograd.Function` whose backward
is K5 again on the transposed problem: the entries stable-sorted by table
row, the table's rows as the bags and the output's gradient as the table,
the weights as given, so ``dtable[r] = Σ_{idx_i = r} w_i · dout[seg_i]``
and a row no entry reads is zero.  That is a dense gradient, as JAX's
``take`` gradient is, summed in a fixed order with no atomics: two
identical steps give identical bits on the card.  A popular row is a long
bag (Zipf's row 1 holds 18% of a training lookup's entries, a
vocab-parallel rank's row 0 every foreign id), so the backward takes K5's
split launch: a long bag's runs summed by many warps at once, in the same
order.  With ``bags_of_one`` (segments are ``arange(nnz)``, the lookups')
the sort's order is the transposed bag's rows itself, not a gather of the
segments.  The weights are constants (not differentiated).
``prefer="ref"`` differentiates the plain version directly (its backward
adds with atomics on the card).

The dry run.  The kernel route and the CPU route are also one operator,
``torch.ops.repro_torch.embedding_bag`` (a `torch.library.custom_op`:
the kernel on a CUDA table, the plain version on a CPU one, the same
calls as before; taken only on ``meta`` tensors or under a dispatch
mode), with a shape rule for ``meta`` tensors and a FLOP
formula (:func:`kernel_flops`: a multiply and an add per element of each
entry's row) registered with `torch.utils.flop_counter`, so a ``meta``
step counts K5 as the kernel runs it, not as a dense gather.
:func:`kernel_bytes` is its traffic for the dry run's byte count (with
``split``, the workspace written and read once besides).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import is_in_torch_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.embedding_bag import cuda
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

_PREFER = ("auto", "cuda", "ref")


def _run(table: torch.Tensor, indices: torch.Tensor, segments: torch.Tensor,
         weights: torch.Tensor, n_bags: int,
         split: bool = False) -> torch.Tensor:
    """The kernel on a CUDA table (``split``: its split launch), the plain
    version on a CPU one; the segments sorted, the weights of the table's
    type."""
    if not table.is_cuda:
        return embedding_bag_ref(table, indices, segments, n_bags,
                                 weights=weights)
    return cuda.embedding_bag_cuda(
        table, indices.to(torch.int32).contiguous(),
        segments.to(torch.int32).contiguous(), weights.contiguous(), n_bags,
        split=split)


_k5 = torch.library.custom_op("repro_torch::embedding_bag",
                              mutates_args=())(_run)


@_k5.register_fake
def _k5_shape(table, indices, segments, weights, n_bags, split=False):
    """The kernel's output: (n_bags, d) of the table's type."""
    return table.new_empty((n_bags, table.shape[1]))


def _forward(table, indices, segments, weights, n_bags, split=False):
    """`_run` through the operator only where a ``meta`` tensor or a
    dispatch mode (the dry run's meter, `FlopCounterMode`) has to see K5;
    else called directly, with no operator dispatch."""
    if table.is_meta or is_in_torch_dispatch_mode():
        return torch.ops.repro_torch.embedding_bag(table, indices, segments,
                                                   weights, n_bags, split)
    return _run(table, indices, segments, weights, n_bags, split)


def kernel_flops(nnz: int, d: int) -> int:
    """K5's FLOPs: each entry's row scaled by its weight and added to its
    bag, two per element."""
    return 2 * nnz * d


def kernel_bytes(table, indices, segments, weights, n_bags,
                 split=False) -> int:
    """K5's traffic: the row of each entry, its index, segment and weight
    read once, the output written once (not the whole table); with
    ``split`` (and more entries than a run), its workspace too, written
    and read once: 2·ceil(nnz / R) fp32 rows and int64 records."""
    nnz, d = indices.shape[0], table.shape[1]
    per = d * table.element_size() + indices.element_size() \
        + segments.element_size() + weights.element_size()
    total = nnz * per + n_bags * d * table.element_size()
    run = cuda.run_shape()[0]
    if split and nnz > run:
        total += 2 * 2 * -(-nnz // run) * (d * 4 + 8)
    return total


@register_flop_formula(torch.ops.repro_torch.embedding_bag, get_raw=True)
def _k5_flops(table, indices, segments, weights, n_bags, *args, **kwargs):
    return kernel_flops(indices.shape[0], table.shape[1])


class EmbeddingBag(torch.autograd.Function):
    """K5 under autograd: the forward is K5 (the kernel on the card, the
    plain version on the CPU); the backward is K5's split launch on the
    transposed problem (see the module docstring)."""

    @staticmethod
    def forward(ctx, table, indices, segments, weights, n_bags,
                bags_of_one=False):
        ctx.save_for_backward(indices, None if bags_of_one else segments,
                              weights)
        ctx.rows = table.shape[0]
        return _forward(table, indices, segments, weights, n_bags)

    @staticmethod
    def backward(ctx, dout):
        indices, segments, weights = ctx.saved_tensors
        order = torch.argsort(indices, stable=True)
        dout_rows = order if segments is None else segments[order]
        dtable = _forward(dout.contiguous(), dout_rows, indices[order],
                          weights[order], ctx.rows, True)
        return dtable, None, None, None, None, None


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segments: torch.Tensor, n_bags: int, *,
                  weights: torch.Tensor | None = None,
                  assume_sorted: bool = True,
                  bags_of_one: bool = False,
                  prefer: str = "auto") -> torch.Tensor:
    """``out[b] = Σ_{segments[i] = b} weights[i] · table[indices[i]]``:
    table (V, d) → (n_bags, d) of its type; an empty bag is a zero row.

    ``weights=None`` means ones; given, they are cast to the table's type
    (the kernel's contract).  The kernel needs ``segments`` sorted: with
    ``assume_sorted=False`` they are sorted here by a stable argsort and
    the indices and weights reordered with them, as `repro`'s ``ops`` does.
    ``bags_of_one`` states that ``segments`` is ``arange(nnz)`` (a lookup),
    which spares the backward a gather.  Indices must lie in [0, V) and
    segments in [0, n_bags)."""
    if prefer not in _PREFER:
        raise ValueError(f"unknown prefer: {prefer!r} (have {_PREFER})")
    nnz = indices.shape[0]
    if weights is None:
        weights = torch.ones((nnz,), dtype=table.dtype, device=table.device)
    weights = weights.to(table.dtype)
    if not assume_sorted:
        order = torch.argsort(segments, stable=True)
        indices, segments, weights = indices[order], segments[order], \
            weights[order]
    if prefer == "ref":
        return embedding_bag_ref(table, indices, segments, n_bags,
                                 weights=weights)
    if prefer == "cuda" and not table.is_cuda:
        raise ValueError("prefer='cuda' needs CUDA tensors: the CUDA "
                         "embedding bag has no CPU mode")
    if torch.is_grad_enabled() and table.requires_grad:
        return EmbeddingBag.apply(table, indices, segments,
                                  weights.detach(), n_bags, bags_of_one)
    return _forward(table, indices, segments, weights, n_bags)
