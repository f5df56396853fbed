"""Shared neural layers of the port: RMSNorm, RoPE, dense, GQA attention
(chunked, decode), SwiGLU. Counterpart of ``repro/models/layers.py``.

The functions take tensors and keep the JAX layers' layouts and dtype
rules: statistics and rotations in float32, weights cast to the input's
dtype, attention q [..., S, H, Dh] against k/v [..., S, Hkv, Dh] with
query head h reading kv head h // (H / Hkv). ``RMSNorm``, ``Dense`` and
``SwiGLU`` are the modules that hold parameters; ``Dense`` keeps its
weight in ``nn.Linear``'s [d_out, d_in] layout.

Over a mesh of ranks (``launch/mesh.py``), the pieces that
``launch/sharding.py``'s rules imply: a column-parallel dense is ``dense``
on the rank's rows of the weight (its output features are the rank's); a
row-parallel dense (``row_dense``) sums the ranks' partial products over
the model axis (its gradient passed on to every rank: Megatron's g);
``gather_fsdp`` joins a weight's blocks over the data axes just before
its layer runs (the caller drops it after), its gradient reduce-scattered
back over them (``gather_fsdp_many``: a layer's weights in one
collective); a column-parallel dense reads its input through
``RankMesh.copy_to``, which sums the input's gradient over the model axis
(Megatron's f); and
``decode_attention_partial`` with ``merge_attention`` decode over a cache
whose sequence axis is split over the data axes, merging each rank's
partial softmax by its log-sum-exp. Each collective reports to the step
counter through the mesh.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "rms_norm",
    "rope_frequencies",
    "apply_rope",
    "rope_tables",
    "rotate",
    "dense",
    "chunked_attention",
    "gqa_attention",
    "decode_attention",
    "decode_attention_partial",
    "merge_attention",
    "row_dense",
    "gather_fsdp",
    "gather_fsdp_many",
    "assign_blocks",
    "swiglu",
    "RMSNorm",
    "Dense",
    "SwiGLU",
    "EXECUTORS",
    "resolve_executor",
]

_MASKED = -1e30
EXECUTORS = ("auto", "kernel", "reference")


def resolve_executor(executor: str, device: torch.device, kernel: str) -> str:
    """Concretize a model's ``executor`` for the device its weights are on:
    "auto" is "kernel" on CUDA and "reference" elsewhere; "kernel" off
    CUDA raises (``kernel`` names what it would run)."""
    if executor not in EXECUTORS:
        raise ValueError(f"executor={executor!r} not in {EXECUTORS}")
    on_cuda = device.type == "cuda"
    if executor == "auto":
        return "kernel" if on_cuda else "reference"
    if executor == "kernel" and not on_cuda:
        raise ValueError(
            f"executor='kernel' runs {kernel} and needs the model on a CUDA device "
            f"(it is on {device}); use executor='reference' or 'auto' on the CPU"
        )
    return executor


# ---------------------------------------------------------------- RMSNorm
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """float32 statistics and float32 scale, cast back to ``x.dtype``."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def rope_tables(positions: torch.Tensor, freqs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] -> (cos, sin) [..., S, 1, Dh/2] in float32: what
    ``apply_rope`` rotates by, computed once for every layer's q and k."""
    angles = positions.unsqueeze(-1).float() * freqs  # [..., S, Dh/2]
    return torch.cos(angles).unsqueeze(-2), torch.sin(angles).unsqueeze(-2)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, Dh] rotated split-half by ``rope_tables``, in float32,
    cast back to ``x.dtype``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, Dh], positions [..., S] -> x rotated split-half, in
    float32, cast back to ``x.dtype``."""
    return rotate(x, *rope_tables(positions, freqs))


# ------------------------------------------------------------------ Dense
def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """weight [d_out, d_in] and bias cast to ``x.dtype``."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


# -------------------------------------------------------------- Attention
def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """[..., Sq, H, Dh] -> [..., Hkv, rep * Sq, Dh]: the query heads that
    share a kv head stacked, so one product per kv head serves them all
    (the JAX layers repeat kv heads instead)."""
    *batch, sq, h, dh = q.shape
    g = q.reshape(*batch, sq, hkv, h // hkv, dh).movedim(-4, -2)  # [..., Hkv, rep, Sq, Dh]
    return g.reshape(*batch, hkv, -1, dh)


def _ungrouped(o: torch.Tensor, sq: int) -> torch.Tensor:
    """[..., Hkv, rep * Sq, Dh] -> [..., Sq, H, Dh]."""
    *batch, hkv, _, dh = o.shape
    o = o.reshape(*batch, hkv, -1, sq, dh).movedim(-2, -4)  # [..., Sq, Hkv, rep, Dh]
    return o.reshape(*batch, sq, -1, dh)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    chunk_size: int = 1024,
) -> torch.Tensor:
    """Attention over KV chunks with a running (max, sum, acc).

    q [..., Sq, H, Dh]; k/v [..., Sk, Hkv, Dh] with Hkv | H. Masks come
    from absolute positions (causal, window) and hide kv positions < 0,
    filled with -1e30. As in JAX, the probabilities are cast to
    ``v.dtype`` before the product with v, and the accumulator is kept in
    ``q.dtype``."""
    *batch, sq, h, dh = q.shape
    sk, hkv = k.shape[-3], k.shape[-2]
    dev = q.device
    scale = 1.0 / math.sqrt(dh)
    if q_positions is None:
        q_positions = torch.arange(sq, device=dev).expand(*batch, sq)
    if kv_positions is None:
        kv_positions = torch.arange(sk, device=dev).expand(*batch, sk)
    pad = -sk % chunk_size
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-(10**9))
    ct = torch.promote_types(q.dtype, k.dtype)  # JAX's einsum promotes
    qg = _grouped(q.to(ct), hkv)  # [..., Hkv, rep * Sq, Dh]
    shape = (*batch, hkv, h // hkv, sq)
    m_run = torch.full(shape, -math.inf, dtype=torch.float32, device=dev)
    l_run = torch.zeros(shape, dtype=torch.float32, device=dev)
    acc = torch.zeros((*shape, dh), dtype=q.dtype, device=dev)
    for c0 in range(0, sk + pad, chunk_size):
        kc = k[..., c0 : c0 + chunk_size, :, :].to(ct).movedim(-2, -3)  # [..., Hkv, C, Dh]
        vc = v[..., c0 : c0 + chunk_size, :, :].movedim(-2, -3)
        kp = kv_positions[..., c0 : c0 + chunk_size]
        rel = q_positions.unsqueeze(-1) - kp.unsqueeze(-2)  # [..., Sq, C]
        mask = (kp >= 0).unsqueeze(-2).expand_as(rel)
        if causal:
            mask = mask & (rel >= 0)
        if window is not None:
            mask = mask & (rel < window)
        mask = mask.unsqueeze(-3).unsqueeze(-3)  # over (Hkv, rep)
        logits = (qg @ kc.transpose(-1, -2)).float().reshape(*shape, -1) * scale
        logits = torch.where(mask, logits, _MASKED)
        m_c = logits.amax(-1)
        p = torch.exp(logits - m_c.unsqueeze(-1))
        l_c = p.sum(-1)
        acc_c = (p.to(v.dtype).flatten(-3, -2) @ vc).reshape(*shape, dh)
        m_new = torch.maximum(m_run, m_c)
        a1 = torch.exp(m_run - m_new)
        a2 = torch.exp(m_c - m_new)
        l_run = l_run * a1 + l_c * a2
        acc = acc * a1.unsqueeze(-1).to(acc.dtype) + acc_c * a2.unsqueeze(-1).to(acc.dtype)
        m_run = m_new
    out = acc / l_run.clamp_min(1e-30).unsqueeze(-1).to(acc.dtype)
    return _ungrouped(out.flatten(-3, -2), sq).to(q.dtype)


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    chunk_size: int = 1024,
) -> torch.Tensor:
    """Self-attention through ``chunked_attention`` with the chunk capped
    at the key length, as the JAX layers' entry point does."""
    return chunked_attention(
        q, k, v, causal=causal, window=window, chunk_size=min(chunk_size, k.shape[-3])
    )


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    window: int | None = None,
) -> torch.Tensor:
    """One position per row: q [B, 1, H, Dh] against the cache
    [B, S, Hkv, Dh]. Hides positions >= kv_len (and those outside the
    sliding window); float32 softmax; probabilities cast to the cache's
    dtype for the product with v, so the output is in that dtype."""
    b, _, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(dh)
    ct = torch.promote_types(q.dtype, k_cache.dtype)
    qg = _grouped(q.to(ct), hkv)  # [B, Hkv, rep, Dh]
    kc = k_cache.to(ct).transpose(1, 2)  # [B, Hkv, S, Dh]
    logits = (qg @ kc.transpose(-1, -2)).float() * scale  # [B, Hkv, rep, S]
    pos = torch.arange(s, device=q.device)
    valid = pos < kv_len.unsqueeze(-1)  # [B, S]
    if window is not None:
        valid = valid & (pos >= kv_len.unsqueeze(-1) - window)
    logits = torch.where(valid[:, None, None, :], logits, _MASKED)
    p = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    return _ungrouped(p @ v_cache.transpose(1, 2), 1)  # [B, 1, H, Dh]


def decode_attention_partial(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``decode_attention`` over one block of the cache's positions
    (``positions`` [S], their absolute positions): (out f32[B, 1, H, Dh],
    normalized over the block, with probabilities cast to the cache's dtype
    as ``decode_attention`` casts them; lse f32[B, H], the log-sum-exp of
    the block's scaled logits). A block with no visible position gives
    ~-1e30, which ``merge_attention`` weighs as 0."""
    b, _, h, dh = q.shape
    hkv = k_cache.shape[2]
    scale = 1.0 / math.sqrt(dh)
    ct = torch.promote_types(q.dtype, k_cache.dtype)
    qg = _grouped(q.to(ct), hkv)  # [B, Hkv, rep, Dh]
    kc = k_cache.to(ct).transpose(1, 2)  # [B, Hkv, S, Dh]
    logits = (qg @ kc.transpose(-1, -2)).float() * scale  # [B, Hkv, rep, S]
    valid = positions < kv_len.unsqueeze(-1)  # [B, S]
    if window is not None:
        valid = valid & (positions >= kv_len.unsqueeze(-1) - window)
    logits = torch.where(valid[:, None, None, :], logits, _MASKED)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(-1, keepdim=True)
    out = ((p / denom).to(v_cache.dtype) @ v_cache.transpose(1, 2)).float()
    lse = (m + torch.log(denom)).reshape(b, h)
    return _ungrouped(out, 1), lse


def merge_attention(out: torch.Tensor, lse: torch.Tensor, mesh, axes, dtype) -> torch.Tensor:
    """The ranks' ``decode_attention_partial`` results along ``axes``
    merged by their log-sum-exp: one all-gather of (out, lse), then
    sum_r exp(lse_r - lse) * out_r, the same bits on every rank -> [B, 1,
    H, Dh] in ``dtype``."""
    n = mesh.size_of(axes)
    if n == 1:
        return out.to(dtype)
    b, _, h, dh = out.shape
    packed = torch.cat([out.reshape(-1), lse.reshape(-1)])
    got = mesh.all_gather(packed, axes, 0).reshape(n, -1)
    outs = got[:, : out.numel()].reshape(n, b, 1, h, dh)
    lses = got[:, out.numel():].reshape(n, b, 1, h, 1)
    w = torch.exp(lses - lses.amax(0, keepdim=True))
    return ((w * outs).sum(0) / w.sum(0)).to(dtype)


def row_dense(x: torch.Tensor, weight: torch.Tensor, mesh, bias=None) -> torch.Tensor:
    """A row-parallel dense: x's features and the weight's d_in are the
    rank's block; the partial products are summed over the model axis
    (in float32), then the bias is added once. The sum's gradient goes to
    every rank's partial product as it is."""
    from repro_torch.launch.mesh import MODEL_AXIS

    y = dense(x, weight)
    if mesh is not None:
        y = mesh.all_reduce(y, MODEL_AXIS)
    return y if bias is None else y + bias.to(y.dtype)


def gather_fsdp(weight: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A weight whose spec splits some dims over the data axes (FSDP),
    joined over them; its model-axis split stays. Its gradient is the sum
    of the ranks' gradients, reduce-scattered back to the blocks (under
    remat the recomputed forward gathers it again)."""
    from repro_torch.launch.mesh import data_axes
    from repro_torch.launch.sharding import gather_block

    return gather_block(weight, spec, mesh, axes=data_axes(mesh))


def gather_fsdp_many(weights: list, specs: list, mesh) -> list:
    """Several FSDP weights (a layer's) joined over the data axes in one
    all-gather of their flattened blocks, each then rebuilt along the dim
    its spec splits over the data axes; the gradient comes back in one
    reduce-scatter. The weights share a dtype."""
    from repro_torch.launch.mesh import data_axes

    data = data_axes(mesh)
    n = mesh.size_of(data)
    if n == 1:
        return list(weights)
    flat = torch.cat([w.reshape(-1) for w in weights])
    got = mesh.all_gather(flat, data, 0, backward="sum").reshape(n, -1)
    out, at = [], 0
    for w, spec in zip(weights, specs):
        (dim,) = [d for d, p in enumerate(spec) if p is not None and set(p) <= set(data)]
        piece = got[:, at:at + w.numel()].reshape(n, *w.shape)
        out.append(torch.cat(piece.unbind(0), dim=dim))
        at += w.numel()
    return out


def assign_blocks(module: nn.Module, params: dict, local_shape, trainable: bool = False) -> None:
    """Make ``params`` (a rank's blocks, by state-dict name) the parameters
    of ``module``, a model built on the ``meta`` device at full size: the
    names must be the module's, and each block's shape ``local_shape(name,
    full_shape)``. A block that is an ``nn.Parameter`` (``TrainState``'s)
    becomes the parameter itself; another is wrapped, trainable only with
    ``trainable``."""
    full = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    if set(params) != set(full):
        raise ValueError(f"the blocks' names differ from the model's: missing "
                         f"{sorted(set(full) - set(params))}, unexpected "
                         f"{sorted(set(params) - set(full))}")
    for name, t in params.items():
        want = local_shape(name, full[name])
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: this rank's block is {tuple(t.shape)}; its spec gives {want}")
        parent, _, leaf = name.rpartition(".")
        if not isinstance(t, nn.Parameter):
            t = nn.Parameter(t, requires_grad=trainable)
        setattr(module.get_submodule(parent) if parent else module, leaf, t)


# ----------------------------------------------------------------- SwiGLU
def swiglu(x: torch.Tensor, gate, up, down) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)); each of gate/up/down is (weight, bias)."""
    return dense(F.silu(dense(x, *gate)) * dense(x, *up), *down)


# ---------------------------------------------------------------- modules
class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale)


class Dense(nn.Module):
    """y = x @ weight.T (+ bias), weight [d_out, d_in] in ``nn.Linear``'s
    layout, weight and bias cast to the input's dtype."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    @property
    def params(self):
        return self.weight, self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.gate = Dense(d_model, d_ff)
        self.up = Dense(d_model, d_ff)
        self.down = Dense(d_ff, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.gate.params, self.up.params, self.down.params)
