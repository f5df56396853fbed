"""Embedding-bag kernel wrapper (EmbeddingBag(sum), padded form).

``embedding_bag`` computes out[s] = sum_l w[s, l] * table[idx[s, l]]: the
CUDA kernel ``csrc/embedding_bag.cu`` on a CUDA tensor, the plain version
``ref.embedding_bag_bags`` on a CPU tensor. Counterpart of
``repro/kernels/embedding_bag.py::embedding_bag_kernel_call``; as there, an
index outside [0, V) contributes exactly 0. One launch takes any S, L, V
and D: no padding to tiles. The table may be a view whose rows are any
number of floats apart (its columns contiguous), and it is never copied:
a table of millions of rows is read where it lies. The kernel loads no row
whose weight is 0.0 or -0.0: on a finite table that is the same sum bit
for bit, while a NaN or Inf row under weight 0 adds nothing (the plain
version, like ``jnp.take`` + sum, gives NaN there).

It is differentiable (a ``torch.autograd.Function``): the table takes a
dense float32 gradient, dtable[v] = sum over (s, l) with idx[s, l] = v of
w[s, l] * dout[s], as JAX's gradient of ``jnp.take`` + sum is dense; the
weights, where they require grad (DIN's attention weights), take dw[s, l]
= <table[idx[s, l]], dout[s]>, 0 for an index outside [0, V); the ids
take none. On CUDA tensors ``embedding_bag_backward_cuda`` computes each
with one C entry of ``csrc/embedding_bag.cu``, deterministically and with
no float atomics: for dtable a stable radix sort of the ids on the card,
each row's range of positions (``ref.bag_csr`` is its plain twin) and a
pass that writes every row, each summed in increasing flat position; for
dw a pass over the (bag, slot) pairs. Neither output is zero-filled first:
the kernels write every element. On CPU tensors
``ref.embedding_bag_bags_backward``.

``work``, ``grad_table_work`` and ``grad_weights_work`` give the least
work of the forward kernel and of each backward kernel, (flops, bytes),
which the step counter (``launch/cost.py``) and the kernels' bounds read.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import _build, ref
from repro_torch.launch import cost

__all__ = [
    "embedding_bag", "embedding_bag_cuda", "embedding_bag_backward",
    "embedding_bag_backward_cuda", "work", "grad_table_work", "grad_weights_work",
]

_INDEX_DTYPES = (torch.int32, torch.int64)
# The backward's sort keys and positions are 32-bit below this many ids and
# rows, 64-bit from it on.
SORT_32BIT_BELOW = 2**31


def work(*, s: int, l: int, d: int, needed: int, index_bytes: int) -> tuple[float, float]:
    """The forward over [s, l] bags of width d: the ``needed`` rows of
    nonzero weight read (a sum of the nonzero terms reads no other), the
    ids and weights read, the [s, d] sums written; one fma per (needed
    row, column)."""
    return (float(2 * needed * d),
            float(needed * d * 4 + s * l * (index_bytes + 4) + s * d * 4))


def grad_table_work(*, s: int, l: int, d: int, v: int, index_bytes: int):
    """The table's gradient: dense, written once whole ([v, d]); the
    output gradient, the ids and the weights read once; one fma per (bag,
    slot, column)."""
    return float(2 * s * l * d), float(v * d * 4 + s * d * 4 + s * l * (index_bytes + 4))


def grad_weights_work(*, s: int, l: int, d: int, index_bytes: int, after_table: bool):
    """The weights' gradient: every slot's table row read and dw written;
    the ids and the output gradient too, unless the table's gradient in
    the same call (``after_table``) already read them."""
    nbytes = s * l * d * 4 + s * l * 4
    if not after_table:
        nbytes += s * l * index_bytes + s * d * 4
    return float(2 * s * l * d), float(nbytes)


def embedding_bag(
    table: torch.Tensor, bag_indices: torch.Tensor, bag_weights: torch.Tensor
) -> torch.Tensor:
    """table f32[V, D], bag_indices int32/int64[S, L], bag_weights f32[S, L]
    -> f32[S, D], differentiable in the table and the weights."""
    return _EmbeddingBag.apply(table, bag_indices, bag_weights)


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, bag_indices, bag_weights):
        ctx.save_for_backward(table, bag_indices, bag_weights)
        if table.device.type == "cpu":
            return ref.embedding_bag_bags(table, bag_indices, bag_weights)
        return embedding_bag_cuda(table, bag_indices, bag_weights)

    @staticmethod
    def backward(ctx, grad):
        table, bag_indices, bag_weights = ctx.saved_tensors
        dtable, dw = embedding_bag_backward(
            table, bag_indices, bag_weights, grad,
            table_grad=ctx.needs_input_grad[0], weights_grad=ctx.needs_input_grad[2],
        )
        return dtable, None, dw


def embedding_bag_backward(
    table: torch.Tensor, bag_indices: torch.Tensor, bag_weights: torch.Tensor,
    grad: torch.Tensor, *, table_grad: bool = True, weights_grad: bool = False,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The bag's gradients given grad = dout f32[S, D] -> (dtable f32[V, D]
    or None, dw f32[S, L] or None): the kernels on a CUDA tensor, the plain
    version on a CPU one. Each kernel it launches (or would launch) reports
    its work to the step counter (``launch/cost.py``)."""
    with contextlib.ExitStack() as counted:
        s, l = bag_indices.shape
        d = table.shape[1]
        if s * l * d:
            shapes = dict(s=s, l=l, d=d, index_bytes=bag_indices.element_size())
            if table_grad:
                counted.enter_context(cost.kernel(
                    "embedding_bag_backward", grad_table_work, v=table.shape[0], **shapes))
            if weights_grad:
                counted.enter_context(cost.kernel(
                    "embedding_bag_backward", grad_weights_work, after_table=table_grad, **shapes))
        if grad.device.type == "cpu":
            return ref.embedding_bag_bags_backward(
                table, bag_indices, bag_weights, grad, table_grad=table_grad,
                weights_grad=weights_grad,
            )
        return embedding_bag_backward_cuda(
            table, bag_indices, bag_weights, grad, table_grad=table_grad, weights_grad=weights_grad
        )


def _check(table: torch.Tensor, bag_indices: torch.Tensor) -> torch.device:
    """What both directions check of the table and the ids."""
    dev = _build.cuda_device(table)
    if table.dtype != torch.float32:
        raise ValueError(
            f"table has dtype {table.dtype}; the kernel takes float32 (a table is "
            "not copied to cast it)"
        )
    if table.dim() != 2:
        raise ValueError(f"table has shape {tuple(table.shape)}; expected [V, D]")
    v, d = table.shape
    if d > 1 and table.stride(1) != 1:
        raise ValueError("table needs contiguous columns (stride 1 along D)")
    if bag_indices.dim() != 2 or bag_indices.dtype not in _INDEX_DTYPES:
        raise ValueError(
            f"bag_indices is {bag_indices.dtype} of shape {tuple(bag_indices.shape)}; "
            "expected int32 or int64 [S, L]"
        )
    _build.require(bag_indices, "bag_indices", bag_indices.dtype, dev)
    return dev


def embedding_bag_cuda(
    table: torch.Tensor, bag_indices: torch.Tensor, bag_weights: torch.Tensor
) -> torch.Tensor:
    """The CUDA kernel: D / VEC lanes a bag (VEC the widest aligned float
    vector; DIN's D 18 in float2 takes 9 lanes, xDeepFM's D 1 one thread),
    a warp wider; each warp compacts its bags' nonzero, in-range slots by
    ballot and fetches only their rows, 8 at a time."""
    dev = _check(table, bag_indices)
    v, d = table.shape
    s, l = bag_indices.shape
    _build.require(bag_weights, "bag_weights", torch.float32, dev, (s, l))
    if s == 0 or l == 0 or d == 0:
        return torch.zeros((s, d), dtype=torch.float32, device=dev)
    out = torch.empty((s, d), dtype=torch.float32, device=dev)
    lib = _build.library("embedding_bag")
    rc = lib.warp_embedding_bag(
        table.data_ptr(), bag_indices.data_ptr(), bag_weights.data_ptr(), out.data_ptr(),
        s, l, d, v, table.stride(0), int(bag_indices.dtype == torch.int64),
        _build.stream_ptr(dev),
    )
    _build.check("embedding_bag", rc)
    _build.LAUNCHES["embedding_bag"] += 1
    return out


def embedding_bag_backward_cuda(
    table: torch.Tensor, bag_indices: torch.Tensor, bag_weights: torch.Tensor,
    grad: torch.Tensor, *, table_grad: bool = True, weights_grad: bool = False,
    scratch: dict | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The backward's CUDA kernels, one C entry per gradient on the
    current stream. dtable: a stable radix sort of the ids' bit_length(V)-bit
    keys on the card, each row's range of positions, then every row
    written (one thread per row at D <= 32; wider, the rows no id names
    zeroed by a warp each and the named ones summed by the warp holding
    their first sorted position). dw: one thread per (bag, slot) at D <= 32,
    one warp per slot wider. The outputs and all scratch are allocated with
    ``torch.empty``: the kernels write every element. Each gradient's launch
    adds one to ``LAUNCHES["embedding_bag_backward"]``. ``scratch``, if
    given a dict, gets the table entry's ``keys`` and ``positions`` (the
    stably sorted keys, V for an id outside [0, V), and their flat
    positions, [S * L]: ``ref.bag_sort``'s) and ``offsets`` ([V + 1];
    ``ref.bag_csr``'s), int32 while S * L and V stay below
    ``SORT_32BIT_BELOW``, else int64."""
    dev = _check(table, bag_indices)
    v, d = table.shape
    s, l = bag_indices.shape
    _build.require(bag_weights, "bag_weights", torch.float32, dev, (s, l))
    grad = grad.contiguous()
    _build.require(grad, "grad", torch.float32, dev, (s, d))
    if s * l * d == 0:  # no term: both gradients are 0, nothing to launch
        return (torch.zeros((v, d), dtype=torch.float32, device=dev) if table_grad else None,
                torch.zeros((s, l), dtype=torch.float32, device=dev) if weights_grad else None)
    lib = _build.library("embedding_bag")
    stream = _build.stream_ptr(dev)
    idx64 = int(bag_indices.dtype == torch.int64)
    dtable = dw = None
    if table_grad:
        dtable = torch.empty((v, d), dtype=torch.float32, device=dev)
    if table_grad and v:
        n = s * l
        wide = max(n, v) >= SORT_32BIT_BELOW
        itype = torch.int64 if wide else torch.int32
        _, digit_bits, tiles = ref.bag_sort_plan(n, v)
        keys = torch.empty((2, n), dtype=itype, device=dev)
        pos = torch.empty((2, n), dtype=itype, device=dev)
        hist = torch.empty(((1 << digit_bits) * (tiles + 1),), dtype=itype, device=dev)
        offsets = torch.empty((v + 1,), dtype=itype, device=dev)
        rc = lib.warp_embedding_bag_grad_table(
            bag_indices.data_ptr(), bag_weights.data_ptr(), grad.data_ptr(), dtable.data_ptr(),
            keys.data_ptr(), pos.data_ptr(), hist.data_ptr(), hist.numel(), offsets.data_ptr(),
            s, l, d, v, idx64, int(wide), stream,
        )
        _build.check("embedding_bag", rc)
        _build.LAUNCHES["embedding_bag_backward"] += 1
        if scratch is not None:
            scratch.update(keys=keys[0], positions=pos[0], offsets=offsets)
    if weights_grad:
        dw = torch.empty((s, l), dtype=torch.float32, device=dev)
        rc = lib.warp_embedding_bag_grad_weights(
            table.data_ptr(), bag_indices.data_ptr(), grad.data_ptr(), dw.data_ptr(), s, l, d, v,
            table.stride(0), idx64, stream,
        )
        _build.check("embedding_bag", rc)
        _build.LAUNCHES["embedding_bag_backward"] += 1
    return dtable, dw
