"""Meshes of ranks: the port's copy of ``repro/launch/mesh.py``.

JAX lays a (data, model) mesh over the devices of one program; the port
lays it over the ranks of a world (``launch/ranks.py::run_world``), one
process per mesh position. A ``RankMesh`` holds the shape and axis names,
this rank's coordinates (row-major over the shape: rank r of a (2, 2)
mesh sits at (r // 2, r % 2)) and device, and one ``torch.distributed``
subgroup per axis, plus one for the flattened data axes (``data_axes``:
("pod", "data") when the pod axis exists). Its collectives report to the
step counter (``launch/cost.py``) with the group's own size, as
``RankGroup._count`` does; a collective over axes of size 1 moves nothing
and returns its input.

``make_production_mesh`` and ``make_mesh`` without a group give an
abstract mesh (shape and names only): what the spec rules of
``launch/sharding.py`` read, with no process behind it. There is no
ambient mesh (JAX's ``set_mesh``): every function that needs one takes it
as an argument.

Under gloo the collectives move host copies (``comm_device``): gathers
travel as bytes, whatever the dtype; sums travel in float32, so a bf16
partial sum is rounded once, after the reduction. Under NCCL they stay on
the card. gloo has no reduce-scatter: there it is a float32 all-reduce and
then the rank's slice (counted as the reduce-scatter it stands for).

The collectives are differentiable, each with the backward its consumers
need (Megatron's f and g, in the training of ``train/loop.py``):

  all_gather(..., backward="sum")    the gradient reduce-scattered over the
      axes: consumers that differ along them (an FSDP weight used on each
      rank's own rows, tokens every data rank routes);
  all_gather(..., backward="slice")  the rank's own block of the gradient:
      consumers replicated along the axes (vocab-split logits, a D-split
      embedding);
  all_reduce(..., backward="identity")  Megatron's g: a row-parallel sum
      whose consumers are replicated, or a loss's numerator summed over the
      data ranks (each rank's backward is then its own rows' share);
  all_reduce(..., backward="sum")    Megatron's f: the gradient summed too;
  copy_to(x, axes)                   the identity, its gradient summed over
      the axes: a tensor replicated over the model axis read by a block
      split over it;
  reduce_scatter(...)                the sum, of which the rank keeps its
      block; its gradient all-gathered over the axes (each rank's partial
      sum fed every block): GIN's messages summed into every node row;
  all_reduce_max                     the gradient compression (no gradient).

``gather_to_root`` (every rank's tensor on rank 0, no gradient) serves
the checkpoint writer; ``at_rank`` gives the mesh as another rank sees
it, so rank 0 can place each block where that rank cut it from.

A collective in a backward reports to the step counter like one in a
forward, so a counted train step shows every collective it ran.
"""

from __future__ import annotations

import copy
import itertools
import math

import torch

from repro_torch.launch import cost

__all__ = ["MODEL_AXIS", "RankMesh", "data_axes", "make_mesh", "make_production_mesh"]

MODEL_AXIS = "model"


def _axes(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class RankMesh:
    """A (pod, data, model)-style mesh over the ranks of a world (or, with
    no ``group``, an abstract one). ``shape`` maps each axis name to its
    size, in order, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...], group=None):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"a mesh needs one distinct name per axis: {shape} vs {axis_names}")
        if any(n < 1 for n in shape):
            raise ValueError(f"mesh axes have sizes >= 1, not {shape}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.devices_shape = shape
        self.size = math.prod(shape)
        self.group = group
        self._groups: dict = {}
        if group is None:
            self.rank = self.coords = self.device = self.comm_device = self.backend = None
            return
        if group.size != self.size:
            raise ValueError(
                f"a mesh of shape {dict(self.shape)} needs {self.size} ranks, the world has "
                f"{group.size}"
            )
        self.rank, self.backend = group.rank, group.backend
        self.device, self.comm_device = group.device, group.comm_device
        self.coords = dict(zip(axis_names, self._coords_of(self.rank)))
        self._make_groups()

    def __repr__(self) -> str:
        where = "abstract" if self.group is None else f"rank {self.rank} at {self.coords}"
        return f"RankMesh({dict(self.shape)}, {where})"

    @property
    def is_abstract(self) -> bool:
        return self.group is None

    def _coords_of(self, rank: int) -> tuple[int, ...]:
        out = []
        for n in reversed(self.devices_shape):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def _rank_of(self, coords) -> int:
        r = 0
        for c, n in zip(coords, self.devices_shape):
            r = r * n + c
        return r

    def at_rank(self, rank: int) -> "RankMesh":
        """This mesh with ``rank``'s coordinates (for its blocks' places;
        its collectives are this rank's)."""
        other = copy.copy(self)
        other.rank, other.coords = rank, dict(zip(self.axis_names, self._coords_of(rank)))
        return other

    def size_of(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple of names)."""
        return math.prod(self.shape[a] for a in _axes(axes))

    def index_of(self, axes) -> int:
        """This rank's position along ``axes``, row-major over them in the
        order given (JAX's block order for a dimension split over them)."""
        if self.coords is None:
            raise ValueError("an abstract mesh has no rank")
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    # ---- subgroups ----
    def _keys(self) -> list[tuple[str, ...]]:
        keys = [(a,) for a in self.axis_names]
        data = data_axes(self)
        if len(data) > 1:
            keys.append(data)
        return keys

    def _make_groups(self) -> None:
        """One subgroup per key (each axis, the flattened data axes) and
        per position on the other axes. ``new_group`` is collective: every
        rank makes every group, in one order; keys of one rank are left
        out alike on every rank."""
        import torch.distributed as tdist

        for key in self._keys():
            if self.size_of(key) == 1:
                continue
            others = [a for a in self.axis_names if a not in key]
            for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
                pos = dict(zip(others, fixed))
                members = []
                for along in itertools.product(*(range(self.shape[a]) for a in key)):
                    pos.update(zip(key, along))
                    members.append(self._rank_of([pos[a] for a in self.axis_names]))
                g = tdist.new_group(sorted(members))
                if self.rank in members:
                    self._groups[key] = g

    def _group(self, axes):
        key = _axes(axes)
        if set(key) == set(self.axis_names) and key not in self._groups:
            import torch.distributed as tdist

            return tdist.group.WORLD  # the mesh is the whole world
        if key not in self._groups:
            raise ValueError(f"{self} has no subgroup over {key} (its groups: {list(self._groups)})")
        return self._groups[key]

    # ---- collectives ----
    def _all_reduce(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        n = self.size_of(axes)
        if n == 1:
            return t
        import torch.distributed as tdist

        x = t.detach().to(self.comm_device, torch.float32).contiguous()
        red = tdist.ReduceOp.MAX if op == "max" else tdist.ReduceOp.SUM
        tdist.all_reduce(x, op=red, group=self._group(axes))
        cost.collective("all-reduce", x.numel() * x.element_size(), n)
        return x.to(t.device, t.dtype)

    def _all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        n = self.size_of(axes)
        if n == 1:
            return t
        import torch.distributed as tdist

        x = t.detach().to(self.comm_device).contiguous()
        if self.backend == "gloo":
            x = x.reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(x) for _ in range(n)]
        tdist.all_gather(parts, x, group=self._group(axes))
        cost.collective("all-gather", n * x.numel() * x.element_size(), n)
        parts = [p.to(t.device).view(t.dtype).reshape(t.shape) for p in parts]
        return torch.cat(parts, dim=dim)

    def _reduce_scatter(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        n = self.size_of(axes)
        if n == 1:
            return t
        import torch.distributed as tdist

        size = _block(t.shape[dim], n, dim)
        i = self.index_of(axes)
        x = t.detach().to(self.comm_device, torch.float32)
        nbytes = x.numel() * x.element_size()
        if self.backend == "gloo":  # no reduce-scatter: the sum, then this rank's slice
            x = x.contiguous()
            tdist.all_reduce(x, group=self._group(axes))
            out = x.narrow(dim, i * size, size)
        else:
            x = x.movedim(dim, 0).contiguous()
            out = torch.empty((size, *x.shape[1:]), dtype=x.dtype, device=x.device)
            tdist.reduce_scatter_tensor(out, x, group=self._group(axes))
            out = out.movedim(0, dim)
        cost.collective("reduce-scatter", nbytes, n)
        return out.to(t.device, t.dtype).contiguous()

    def gather_to_root(self, t: torch.Tensor) -> list[torch.Tensor] | None:
        """Every rank's ``t`` (one shape and dtype on all) on rank 0, in rank
        order, on its ``comm_device``; None on the other ranks (no gradient,
        not counted: no step runs it)."""
        if self.size == 1:
            return [t.detach()]
        import torch.distributed as tdist

        x = t.detach().to(self.comm_device).contiguous().reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(x) for _ in range(self.size)] if self.rank == 0 else None
        tdist.gather(x, parts, dst=0, group=self._group(self.axis_names))
        if parts is None:
            return None
        return [p.view(t.dtype).reshape(t.shape) for p in parts]

    def all_reduce(self, t: torch.Tensor, axes, *, backward: str = "identity") -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axes``, in float32 (cast
        back to ``t``'s dtype), the same bits on every rank. Its gradient:
        ``backward="identity"`` passes it on (g), ``"sum"`` sums it over
        the axes too (f)."""
        if backward not in ("identity", "sum"):
            raise ValueError(f"all_reduce backward={backward!r} is not 'identity' or 'sum'")
        if self.size_of(axes) == 1:
            return t
        return _AllReduce.apply(t, self, _axes(axes), backward)

    def all_reduce_max(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The element-wise max of ``t`` over the ranks along ``axes`` (no
        gradient)."""
        return self._all_reduce(t, axes, "max")

    def all_gather(self, t: torch.Tensor, axes, dim: int, *, backward: str = "sum") -> torch.Tensor:
        """The blocks of the ranks along ``axes`` joined on ``dim``, in
        their order along those axes. Its gradient: ``backward="sum"``
        reduce-scattered over the axes, ``"slice"`` the rank's own block."""
        if backward not in ("sum", "slice"):
            raise ValueError(f"all_gather backward={backward!r} is not 'sum' or 'slice'")
        if self.size_of(axes) == 1:
            return t
        return _AllGather.apply(t, self, _axes(axes), dim, backward)

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axes``, of which this
        rank keeps its block of ``dim``. Its gradient is the blocks'
        gradients all-gathered over the axes."""
        if self.size_of(axes) == 1:
            return t
        return _ReduceScatter.apply(t, self, _axes(axes), dim)

    def copy_to(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x`` itself; its gradient summed over the ranks along ``axes``
        (Megatron's f), for a tensor replicated over them read by a block
        split over them."""
        if self.size_of(axes) == 1 or not x.requires_grad:
            return x
        return _CopyTo.apply(x, self, _axes(axes))


def _block(size: int, n: int, dim: int) -> int:
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split over {n} ranks")
    return size // n


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, backward):
        ctx.mesh, ctx.axes, ctx.backward = mesh, axes, backward
        return mesh._all_reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "sum":
            g = ctx.mesh._all_reduce(g, ctx.axes)
        return g, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim, backward):
        ctx.mesh, ctx.axes, ctx.dim, ctx.backward = mesh, axes, dim, backward
        ctx.size = t.shape[dim]
        return mesh._all_gather(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        m, dim = ctx.mesh, ctx.dim
        if ctx.backward == "sum":
            g = m._reduce_scatter(g, ctx.axes, dim)
        else:
            g = g.narrow(dim, m.index_of(ctx.axes) * ctx.size, ctx.size)
        return g, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh._reduce_scatter(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._all_gather(g, ctx.axes, ctx.dim), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._all_reduce(g, ctx.axes), None, None


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], group=None) -> RankMesh:
    """A mesh of ``shape`` named ``axes`` over the ranks of ``group`` (a
    ``RankGroup`` whose size is the mesh's), or an abstract one."""
    return RankMesh(shape, axes, group)


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """JAX's production meshes, abstract: one pod 16x16 = 256 chips
    (data, model); two pods 2x16x16 = 512 chips (pod, data, model)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def data_axes(mesh) -> tuple[str, ...]:
    """All batch-parallel axes: ('pod', 'data') when the pod axis exists."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)
