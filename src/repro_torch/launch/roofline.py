"""Roofline terms and analytic ("useful") FLOPs per (arch x shape) cell.
The port's copy of ``repro/launch/roofline.py``: ``model_flops`` is its
formulas, read from the port's own configs; ``roofline_terms`` takes the
same inputs and gives the same keys, at the card's peaks.

Peaks: the published NVIDIA H100 SXM figures at the 700 W limit (dense
bf16 989 TFLOP/s, float32 67 TFLOP/s without TF32, 3.35 TB/s of HBM,
450 GB/s of NVLink per direction). Terms:

  compute_s    = per-device FLOPs / peak_flops
  memory_s     = per-device bytes / hbm_bw
  collective_s = per-device collective traffic / link_bw

``model_flops`` is the analytic useful work (6·N·D for dense training
etc.); divided by a measured step time, the device count and the peak of
the step's dtype (``peak_for``) it gives the cell's MFU.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchDef

__all__ = [
    "BF16_FLOPS", "F32_FLOPS", "HBM_BW", "LINK_BW", "PEAK_FLOPS",
    "model_flops", "peak_for", "roofline_terms",
]

BF16_FLOPS = 989e12  # dense tensor cores
F32_FLOPS = 67e12  # FMA units; the parity runs keep TF32 off
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s of NVLink, per direction
PEAK_FLOPS = BF16_FLOPS


def peak_for(dtype) -> float:
    """The compute peak of products run in ``dtype``: bf16 and fp16 on the
    tensor cores, everything else (float32 without TF32) on FMA units."""
    return BF16_FLOPS if dtype in (torch.bfloat16, torch.float16) else F32_FLOPS


def _lm_flops(arch: ArchDef, shape: str, s=None) -> float:
    from repro_torch.configs.families import LM_SHAPES

    cfg = arch.config
    s = s or LM_SHAPES[shape]
    n_act = cfg.active_param_count()
    l, h, dh = cfg.n_layers, cfg.n_heads, cfg.resolved_head_dim
    b, sl = s.global_batch, s.seq_len
    w = cfg.sliding_window or sl

    if s.kind == "train":
        tokens = b * sl
        attn = 6 * l * b * sl * min(sl, w) * h * dh  # fwd+bwd, causal ~1/2 * 4
        return 6.0 * n_act * tokens + attn
    if s.kind == "prefill":
        tokens = b * sl
        attn = 2 * l * b * sl * min(sl, w) * h * dh
        return 2.0 * n_act * tokens + attn
    # decode: one token, attention over the cached window
    attn = 4 * l * b * min(sl, w) * h * dh
    return 2.0 * n_act * b + attn


def _gnn_flops(arch: ArchDef, shape: str, s=None) -> float:
    from repro_torch.configs.families import GNN_SHAPES

    cfg, s = arch.config, s or GNN_SHAPES[shape]
    d_h = cfg.d_hidden
    total = 0.0
    d_in = s.d_feat
    for _ in range(cfg.n_layers):
        total += 2.0 * s.n_edges * d_in  # gather+scatter adds
        total += 2.0 * s.n_nodes * (d_in * d_h + d_h * d_h)  # MLP
        d_in = d_h
    total += 2.0 * s.n_nodes * d_h * s.n_classes
    return 3.0 * total  # fwd + bwd


def _mlp_cost(dims: tuple[int, ...]) -> float:
    return sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))


def _recsys_flops(arch: ArchDef, shape: str, s=None) -> float:
    from repro_torch.configs.families import RECSYS_SHAPES
    from repro_torch.models.recsys import DINConfig, SASRecConfig, TwoTowerConfig, XDeepFMConfig

    cfg, s = arch.config, s or RECSYS_SHAPES[shape]
    b = s.batch
    mult = 3.0 if s.kind == "train" else 1.0
    if isinstance(cfg, TwoTowerConfig):
        tower = _mlp_cost((cfg.embed_dim,) + cfg.tower_mlp)
        per_row = 2 * tower + (cfg.user_fields + cfg.item_fields) * cfg.embed_dim * 2
        total = b * per_row
        if s.kind == "train":
            total += 2.0 * b * b * cfg.tower_mlp[-1]  # in-batch logits
        if s.kind == "retrieval":
            total = b * (tower + cfg.user_fields * cfg.embed_dim * 2)
            total += 2.0 * b * s.n_candidates * cfg.tower_mlp[-1]
        return mult * total
    if isinstance(cfg, SASRecConfig):
        d, sl = cfg.embed_dim, cfg.seq_len
        blk = 4.0 * sl * sl * d + 8.0 * sl * d * d
        total = b * cfg.n_blocks * blk
        if s.kind == "retrieval":
            total += 2.0 * s.n_candidates * d
        return mult * total
    if isinstance(cfg, XDeepFMConfig):
        f, d = cfg.n_fields, cfg.embed_dim
        rows = s.n_candidates if s.kind == "retrieval" else b
        cin = 0.0
        h_prev = f
        for h in cfg.cin_layers:
            cin += 2.0 * h_prev * f * d + 2.0 * h * h_prev * f * d
            h_prev = h
        dnn = _mlp_cost((f * d,) + cfg.mlp + (1,))
        return mult * rows * (cin + dnn)
    if isinstance(cfg, DINConfig):
        d, sl = cfg.embed_dim, cfg.seq_len
        rows = s.n_candidates if s.kind == "retrieval" else b
        attn = sl * _mlp_cost((4 * d,) + cfg.attn_mlp + (1,))
        head = _mlp_cost((3 * d,) + cfg.mlp + (1,))
        return mult * rows * (attn + head)
    raise TypeError(type(cfg))


def _warp_flops(arch: ArchDef, shape: str, s=None) -> float:
    from repro_torch.configs.warp_family import WARP_SHAPES

    cfg, s = arch.config, s or WARP_SHAPES[shape]
    q = cfg.query_maxlen
    centroid = 2.0 * q * s.n_centroids * cfg.dim  # S_cq = C q^T
    # Selective sum: one add per candidate-token dim (useful work).
    decompress = float(q * cfg.nprobe * s.cap * cfg.dim)
    reduce = 2.0 * q * cfg.nprobe * s.cap * 32  # sort ~ n log n
    return s.batch * (centroid + decompress + reduce)


def model_flops(arch: ArchDef, shape: str, *, shape_obj=None) -> float:
    """The cell's analytic FLOPs at ``arch.config``; ``shape_obj`` replaces
    the family's shape named ``shape`` (a cut batch, a reduced shape)."""
    fn = {"lm": _lm_flops, "gnn": _gnn_flops, "recsys": _recsys_flops, "warp": _warp_flops}
    if arch.family.name not in fn:
        raise ValueError(arch.family.name)
    return fn[arch.family.name](arch, shape, shape_obj)


def roofline_terms(
    *,
    per_device_flops: float,
    per_device_bytes: float,
    per_device_collective_bytes: float,
    n_devices: int,
    peak_flops: float = PEAK_FLOPS,
    hbm_bw: float = HBM_BW,
    link_bw: float = LINK_BW,
) -> dict:
    compute_s = per_device_flops / peak_flops
    memory_s = per_device_bytes / hbm_bw
    collective_s = per_device_collective_bytes / link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        **terms,
        "bottleneck": bottleneck,
        "step_lower_bound_s": bound,
        # The share of the bound spent on compute: 1.0 is compute-bound,
        # lower means memory or collective time dominates.
        "hlo_compute_fraction": (compute_s / bound) if bound else 0.0,
        "hlo_flops_global": per_device_flops * n_devices,
        "hlo_bytes_global": per_device_bytes * n_devices,
    }
