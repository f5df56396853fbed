"""Partition-spec rules per model family: the port's copy of
``repro/launch/sharding.py``, stated over the port's own tensors.

Training (``TrainLayout``): a gradient is summed over the data axes its
parameter's spec does not name (``grad_sync_axes``); over the model axis
the layers' own collectives leave every rank its block's whole gradient,
except a kv head shared by several model ranks (Hkv < model), summed over
exactly those ranks. ZeRO-1 moments (``zero1_opt_pspec``) split a
replicated parameter's update over the data axes.

LM stack: FSDP + TP ("fsdp" = all batch axes, flattened ('pod', 'data')).
The port keeps one module per layer and Dense weights [d_out, d_in]
(``nn.Linear``'s layout), where JAX stacks [L, d_in, d_out]; so each
Dense weight's spec is JAX's with the leading L dropped and the two dims
swapped (``models/convert.py::jax_leaf`` maps each name to JAX's leaf):

  wq/wk/wv.weight [H*Dh, D]   -> (model, fsdp)   column-parallel
  wo.weight       [D, H*Dh]   -> (fsdp, model)   row-parallel
  ffn gate/up     [F, D]      -> (model, fsdp);  down [D, F] -> (fsdp, model)
  moe gate/up     [E, D, F]   -> (None, fsdp, model); down [E, F, D] -> (None, model, fsdp)
                                 (tp_only: no fsdp; the router replicated)
  embed           [V, D]      -> (None, model)   ("vocab": (model, None))
  lm_head.weight  [V, D]      -> (model, fsdp)
  norms / scalars             -> replicated

RecSys: tables row-sharded over model where their rows divide it, the
rest replicated; batches over the data axes. GNN: parameters (and their
moments) replicated; every node and edge array over the data axes, its
ids left global (``local_batch``).

A spec is a ``PartitionSpec``: one entry per dimension, None or a tuple
of axis names (a name alone is taken as a tuple of one). ``local_block``
cuts a rank's block of a full tensor, ``gather_block`` joins blocks back.
"""

from __future__ import annotations

import copy

import torch

from repro_torch.launch.mesh import MODEL_AXIS, data_axes

__all__ = [
    "PartitionSpec",
    "P",
    "lm_param_pspec",
    "recsys_param_pspec",
    "zero1_opt_pspec",
    "replicated",
    "batch_pspec",
    "kv_cache_pspec",
    "local_block",
    "local_batch",
    "local_shape",
    "gather_block",
    "kv_heads_of_rank",
    "lm_local_block",
    "lm_local_shape",
    "lm_join_block",
    "grad_sync_axes",
    "replicas",
    "TrainLayout",
]

_TABLES = ("user_table", "item_table", "table", "linear")


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec`` over the port's tensors: each entry None or
    a tuple of mesh axis names."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if p is None or p == ():
                norm.append(None)
            elif isinstance(p, str):
                norm.append((p,))
            else:
                norm.append(tuple(p))
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return "P(" + ", ".join("None" if p is None else repr(p) for p in self) + ")"


P = PartitionSpec


def _shape(leaf) -> tuple[int, ...]:
    """A leaf's shape: a tensor's, or a (shape, dtype) pair's."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if isinstance(leaf, tuple) and len(leaf) == 2 and isinstance(leaf[0], (tuple, list)):
        return tuple(leaf[0])
    raise TypeError(f"not a tensor or a (shape, dtype) pair: {leaf!r}")


def _map(rule, tree, prefix=()):
    """``rule(names, leaf)`` over a state dict (name -> leaf), nested
    dicts too; ``names`` are the dotted parts of the leaf's path."""
    out = {}
    for k, v in tree.items():
        names = [*prefix, *str(k).split(".")]
        out[k] = _map(rule, v, names) if isinstance(v, dict) else rule(names, v)
    return out


def lm_param_pspec(params: dict, mesh, *, embed_shard: str = "d",
                   moe_weight_mode: str = "fsdp") -> dict:
    """Spec per parameter of a ``TransformerLM`` / ``TokenEncoder`` state
    dict (name -> tensor or (shape, dtype))."""
    fsdp = data_axes(mesh)
    model = MODEL_AXIS

    def rule(names, leaf):
        nd = len(_shape(leaf))
        weight = names[-1] == "weight"

        def spec(*parts):
            assert len(parts) == nd, (names, parts, _shape(leaf))
            return P(*parts)

        if "embed" in names or "pos_table" in names:
            if embed_shard == "vocab":
                return P(model, None)
            if embed_shard == "replicated":
                return P(None, None)
            return P(None, model)
        if any(n in names for n in _TABLES):
            return P(model, None)
        if "lm_head" in names:
            return P(model, fsdp) if nd == 2 else P(model)
        if any(n in names for n in ("wq", "wk", "wv")):
            return spec(model, fsdp) if weight else spec(model)
        if "wo" in names:
            return spec(fsdp, model) if weight else spec(fsdp)
        if "moe" in names:
            if "router" in names:
                return P(*([None] * nd))
            if moe_weight_mode == "tp_only":
                if names[-1] in ("gate", "up"):
                    return spec(None, None, model)
                if names[-1] == "down":
                    return spec(None, model, None)
            if names[-1] in ("gate", "up"):
                return spec(None, fsdp, model)
            if names[-1] == "down":
                return spec(None, model, fsdp)
        if any(n in names for n in ("gate", "up", "ff1")):
            return spec(model, fsdp) if weight else spec(model)
        if any(n in names for n in ("down", "ff2")):
            return spec(fsdp, model) if weight else spec(fsdp)
        if "proj" in names and nd >= 2:
            return spec(None, fsdp)
        return P(*([None] * nd))

    return _map(rule, params)


def recsys_param_pspec(params: dict, mesh) -> dict:
    """Tables row-sharded over the model axis where their rows divide it,
    everything else replicated."""

    def rule(names, leaf):
        shape = _shape(leaf)
        if any(n in names for n in _TABLES) and shape[0] % mesh.shape[MODEL_AXIS] == 0:
            return P(MODEL_AXIS, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return _map(rule, params)


def zero1_opt_pspec(param_pspec: dict, params_abs: dict, mesh) -> dict:
    """ZeRO-1 layout for optimizer moments: where a parameter is replicated
    over the data axes (tp_only MoE experts, norms, the router), its m/v
    are sharded over the data axes on the last divisible unsharded dim, in
    JAX's order of the dims (a Dense weight's are swapped)."""
    from repro_torch.models.convert import jax_leaf

    fsdp = data_axes(mesh)
    n_fsdp = mesh.size_of(fsdp)
    out = {}
    for name, spec in param_pspec.items():
        parts = list(spec)
        used = {a for p in parts if p is not None for a in p}
        if used & set(fsdp):
            out[name] = spec
            continue
        shape = _shape(params_abs[name])
        order = list(range(len(parts)))
        if jax_leaf(name)[2]:  # transposed: JAX's last dim is the port's first
            order.reverse()
        for i in reversed(order):
            if parts[i] is None and shape[i] % n_fsdp == 0:
                parts[i] = fsdp
                break
        out[name] = P(*parts)
    return out


def replicated(tree: dict) -> dict:
    return _map(lambda names, leaf: P(*([None] * len(_shape(leaf)))), tree)


def batch_pspec(batch: dict, mesh) -> dict:
    """The leading (batch) axis of every input over the data axes."""
    fsdp = data_axes(mesh)

    def rule(names, leaf):
        nd = len(_shape(leaf))
        return P(fsdp, *([None] * (nd - 1))) if nd >= 1 else P()

    return _map(rule, batch)


def kv_cache_pspec(cache: dict, mesh, *, shard_seq: bool) -> dict:
    """A cache's {"k", "v"} [L, B, S, Hkv, Dh] and {"length"} [B]:
    batch-sharded; for batch-1 long-context decode, the sequence axis
    instead (its partial softmaxes merged by their LSE, and the lengths
    replicated)."""
    fsdp = data_axes(mesh)

    def rule(names, leaf):
        nd = len(_shape(leaf))
        if nd == 5:
            return P(None, None, fsdp, None, None) if shard_seq else P(None, fsdp, None, None, None)
        if nd == 1:
            return P() if shard_seq else P(fsdp)
        return P(*([None] * nd))

    return _map(rule, cache)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _split(size: int, n: int, what) -> int:
    if size % n:
        raise ValueError(f"{what}: {size} does not divide over {n} ranks")
    return size // n


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape``."""
    spec = P(*spec) + P(*([None] * (len(shape) - len(spec))))
    return tuple(n if p is None else _split(n, mesh.size_of(p), f"dim {d} over {p}")
                 for d, (n, p) in enumerate(zip(shape, spec)))


def local_block(t, spec, mesh):
    """This rank's block of the full tensor ``t`` (a view): each dim split
    over the axes its spec entry names, at this rank's position along
    them."""
    for d, p in enumerate(spec):
        if p is None:
            continue
        n = mesh.size_of(p)
        if n == 1:
            continue
        size = _split(t.shape[d], n, f"dim {d} of {tuple(t.shape)} over {p}")
        t = t.narrow(d, mesh.index_of(p) * size, size)
    return t


def local_batch(batch: dict, specs: dict, mesh) -> dict:
    """This rank's block of each input of ``batch`` by its spec in
    ``specs`` (an ``input_pspec``), each a copy, so the whole batch can be
    freed."""
    return {k: local_block(v, specs[k], mesh).clone() for k, v in batch.items()}


def gather_block(t, spec, mesh, axes=None):
    """The inverse of ``local_block``: the blocks joined over the axes the
    spec names (only the dims split over ``axes`` where that is given: the
    data axes of an FSDP weight). Each gather's gradient is reduce-scattered
    (a weight every rank uses on its own rows)."""
    for d, p in enumerate(spec):
        if p is None or (axes is not None and not set(p) <= set(axes)):
            continue
        t = mesh.all_gather(t, p, d)
    return t


# ---------------------------------------------------------------------------
# KV heads on the model axis
# ---------------------------------------------------------------------------


def kv_heads_of_rank(cfg, mesh) -> tuple[int, int]:
    """(first kv head, count) that this rank's query heads read. The
    query heads split over the model axis in blocks of H / model; where
    Hkv < model each block reads one kv head, replicated over the ranks
    that share it (JAX would split its rows across them). Raises where the
    heads do not divide the axis."""
    m = mesh.shape[MODEL_AXIS]
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    if h % m:
        raise ValueError(
            f"{h} query heads do not divide the model axis of {m} ranks (mesh "
            f"{dict(mesh.shape)}); use a model axis that divides them"
        )
    if hkv >= m:
        if hkv % m:
            raise ValueError(f"{hkv} kv heads do not divide the model axis of {m} ranks")
        per = hkv // m
        return (mesh.index_of(MODEL_AXIS) * per if mesh.coords else 0), per
    if m % hkv:
        raise ValueError(f"a model axis of {m} ranks is not a multiple of the {hkv} kv heads")
    return ((mesh.index_of(MODEL_AXIS) // (m // hkv)) if mesh.coords else 0), 1


def _is_kv(names) -> bool:
    return names[-2:-1] in (["wk"], ["wv"])


def lm_local_block(name: str, t, spec, mesh, cfg):
    """``local_block`` of one LM parameter, but where Hkv < model the rows
    of wk / wv (weight and bias) are the rank's own kv head
    (``kv_heads_of_rank``), and only the dims split over the data axes
    follow the spec."""
    names = name.split(".")
    if _is_kv(names) and cfg.n_kv_heads < mesh.shape[MODEL_AXIS]:
        first, count = kv_heads_of_rank(cfg, mesh)
        dh = cfg.resolved_head_dim
        t = t.narrow(0, first * dh, count * dh)
        spec = P(None, *spec[1:])
    return local_block(t, spec, mesh)


def lm_local_shape(name: str, shape, spec, mesh, cfg) -> tuple[int, ...]:
    names = name.split(".")
    if _is_kv(names) and cfg.n_kv_heads < mesh.shape[MODEL_AXIS]:
        shape = (cfg.resolved_head_dim,) + tuple(shape[1:])
        spec = P(None, *spec[1:])
    return local_shape(shape, spec, mesh)


def lm_join_block(name: str, t, spec, mesh, cfg):
    """The inverse of ``lm_local_block``: the whole tensor on every rank
    (no gradient). Where Hkv < model, each kv head is taken from the first
    of the model ranks that share it."""
    names = name.split(".")
    if _is_kv(names) and cfg.n_kv_heads < mesh.shape[MODEL_AXIS]:
        t = gather_block(t, P(None, *spec[1:]), mesh)
        share = mesh.shape[MODEL_AXIS] // cfg.n_kv_heads
        heads = mesh.all_gather(t, MODEL_AXIS, 0)
        return heads.reshape(cfg.n_kv_heads, share, *t.shape)[:, 0].reshape(-1, *t.shape[1:])
    return gather_block(t, spec, mesh)


# ---------------------------------------------------------------------------
# training over a mesh
# ---------------------------------------------------------------------------


def _named(spec) -> set:
    return {a for p in spec if p is not None for a in p}


def grad_sync_axes(spec, mesh) -> tuple[str, ...]:
    """The axes a parameter's gradient is summed over: the data axes its
    spec does not name (each data rank's gradient is its own rows' share).
    Over the data axes it names, the FSDP gather's backward already
    reduce-scattered it; over the model axis, the layers' collectives
    (``copy_to`` ahead of every block split over it, the identity backward
    of the row-parallel sums) leave every rank its block's whole gradient."""
    return tuple(a for a in data_axes(mesh) if a not in _named(spec) and mesh.shape[a] > 1)


def replicas(spec, mesh, shared: int = 1) -> int:
    """How many ranks hold each block of a tensor of ``spec``: the product
    of the axes it does not name (times ``shared``: a kv head held by that
    many model ranks)."""
    named = _named(spec)
    n = 1
    for a in mesh.axis_names:
        if a not in named:
            n *= mesh.shape[a]
    return n * shared


class TrainLayout:
    """How a ``TrainState`` lies on a mesh: each parameter's spec (by
    state-dict name), its moments' (ZeRO-1 where ``zero1``), and the LM
    config whose kv heads decide the rows of wk / wv (None for the other
    families). ``cut`` and ``join`` take a checkpoint leaf ("params.<n>",
    "opt.m.<n>", "opt.v.<n>", "opt.step", "error_fb.<n>") to this rank's
    block and back, ``gather_to_root`` to rank 0 alone; the error feedback
    has the moments' layout (the gradient block the rank updates)."""

    def __init__(self, mesh, param_specs: dict, opt_specs: dict | None = None, cfg=None):
        self.mesh, self.cfg = mesh, cfg
        self.param_specs = dict(param_specs)
        self.opt_specs = dict(opt_specs or param_specs)

    def kv_shared(self, name: str) -> int:
        """How many model ranks hold the kv head of ``name`` (1 unless it is
        wk / wv with Hkv < model)."""
        cfg, m = self.cfg, self.mesh.shape.get(MODEL_AXIS, 1)
        if cfg is None or not _is_kv(name.split(".")) or cfg.n_kv_heads >= m:
            return 1
        return m // cfg.n_kv_heads

    def zero1_dim(self, name: str) -> int | None:
        """The dim along which ``name``'s moments (and its gradient and
        update) are split over the data axes where its parameter is not."""
        for d, (p, o) in enumerate(zip(self.param_specs[name], self.opt_specs[name])):
            if p != o:
                return d
        return None

    def grad_replicas(self, name: str) -> int:
        """How many ranks hold each block of ``name``'s synced gradient (its
        moments' layout)."""
        return replicas(self.opt_specs[name], self.mesh, self.kv_shared(name))

    def _leaf(self, leaf: str):
        """(parameter name, the specs its leaf follows), or (None, None)
        for a leaf every rank holds whole (the step)."""
        parts = leaf.split(".")
        if parts[0] == "params":
            return ".".join(parts[1:]), self.param_specs
        if parts[0] == "opt" and parts[1] in ("m", "v"):
            return ".".join(parts[2:]), self.opt_specs
        if parts[0] == "error_fb":
            return ".".join(parts[1:]), self.opt_specs
        return None, None

    def cut(self, leaf: str, full):
        """This rank's block of the whole tensor ``full`` of ``leaf`` (a view)."""
        name, specs = self._leaf(leaf)
        if name is None:
            return full
        spec = specs[name]
        if self.cfg is not None:
            t = lm_local_block(name, full, self.param_specs[name], self.mesh, self.cfg)
            return _zero1_cut(t, self.param_specs[name], spec, self.mesh)
        return local_block(full, spec, self.mesh)

    def join(self, leaf: str, block):
        """The whole tensor of ``leaf`` from the ranks' blocks, on every rank
        (collective: every rank calls it, leaves in one order)."""
        name, specs = self._leaf(leaf)
        if name is None:
            return block
        spec = specs[name]
        if self.cfg is not None:
            block = _zero1_join(block, self.param_specs[name], spec, self.mesh)
            return lm_join_block(name, block, self.param_specs[name], self.mesh, self.cfg)
        return gather_block(block, spec, self.mesh)


    def whole_shape(self, leaf: str, shape) -> tuple[int, ...]:
        """The shape of ``leaf``'s whole tensor, of which a rank holds a
        block of ``shape``."""
        name, specs = self._leaf(leaf)
        if name is None:
            return tuple(shape)
        spec = tuple(specs[name]) + (None,) * (len(shape) - len(specs[name]))
        out = [n * self.mesh.size_of(p) if p is not None else n for n, p in zip(shape, spec)]
        if self.cfg is not None and self.kv_shared(name) > 1:  # the rank's one kv head
            out[0] = self.cfg.n_kv_heads * self.cfg.resolved_head_dim
        return tuple(out)

    def gather_to_root(self, leaf: str, block):
        """The whole tensor of ``leaf`` on rank 0, on the host; None on the
        other ranks (collective: every rank calls it, leaves in one order).
        Each rank's block is sent to rank 0 alone, which writes it where
        ``cut`` takes that rank's block from (a replicated block lands
        where its replicas do, with the same bits)."""
        name, _ = self._leaf(leaf)
        if name is None:
            return block.detach().cpu() if self.mesh.rank == 0 else None
        parts = self.mesh.gather_to_root(block)
        if parts is None:
            return None
        full = torch.empty(self.whole_shape(leaf, block.shape), dtype=block.dtype)
        there = copy.copy(self)
        for r, part in enumerate(parts):
            there.mesh = self.mesh.at_rank(r)
            there.cut(leaf, full).copy_(part)
        return full


def _zero1_cut(t, param_spec, opt_spec, mesh):
    """A parameter block's ZeRO-1 slice: the dim its spec leaves None and
    the moments' split over the data axes (``zero1_opt_pspec``)."""
    for d, (p, o) in enumerate(zip(param_spec, opt_spec)):
        if p != o:
            return local_block(t, P(*([None] * d), o), mesh)
    return t


def _zero1_join(t, param_spec, opt_spec, mesh):
    for d, (p, o) in enumerate(zip(param_spec, opt_spec)):
        if p != o:
            return mesh.all_gather(t, o, d)
    return t
