"""Flash-attention forward kernel wrapper.

``flash_attention`` computes causal and/or sliding-window attention over
[B, H, S, Dh] with GQA by head index: the CUDA kernel
``csrc/flash_attention.cu`` on a CUDA tensor, the plain version
``ref.flash_attention`` on a CPU tensor. Counterpart of
``repro/kernels/flash_attention.py::flash_attention_kernel_call``. Like
the TPU kernel it is forward only: inputs that require grad (with grad
enabled) are refused on either branch, since the kernel's output would
carry no gradient back to them. The kernel reads strided inputs (the last axis contiguous), so a [B, S, H, Dh]
tensor passes as its ``transpose(1, 2)`` view without a copy, and the
output keeps q's strides. bf16 runs on Hopper's tensor cores (wgmma) fed
by TMA, which reads from 16-byte aligned rows at strides of whole 16-byte
units: a bf16 input whose rows do not start on 16 bytes is copied first.
Its schedule (which kv tiles each 128-row q-block visits, which of them
need the mask, and the block order) has a plain twin in
``ref.flash_schedule``. ``work`` is the least work of one call, which
the step counter (``launch/cost.py``) and the kernel's bound read.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref

__all__ = ["flash_attention", "flash_attention_cuda", "pairs", "work"]

HEAD_DIMS = (64, 128)  # the head sizes the kernel is compiled for
# The bf16 kernel's tiles, as csrc/flash_attention.cu sets them: query rows
# per block, and keys per kv tile and stages of the k/v ring by head size.
BLOCK_Q = 128
TILE_K = {64: 128, 128: 64}
STAGES = {64: 2, 128: 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pairs(sq: int, skv: int, *, causal: bool = True, window: int | None = None) -> int:
    """(query, key) pairs the mask keeps, positions absolute indices into
    the arrays: row i sees keys j <= i (causal) with i - j < window."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window is not None else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def work(*, b: int, h: int, hkv: int, sq: int, skv: int, dh: int, itemsize: int,
         causal: bool = True, window: int | None = None) -> tuple[float, float]:
    """(flops, bytes) of one call: the multiply-adds x 2 of q.k and p.v
    over the kept pairs; q, k, v read once and the output written once."""
    flops = 4.0 * b * h * pairs(sq, skv, causal=causal, window=window) * dh
    return flops, float(itemsize * (2 * b * h * sq * dh + 2 * b * hkv * skv * dh))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """q [B, H, Sq, Dh], k/v [B, Hkv, Skv, Dh] -> [B, H, Sq, Dh] in
    ``q.dtype`` (see ``ref.flash_attention`` for the function)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(
            "flash_attention is forward only (the kernel has no backward): call it under "
            "torch.no_grad, or differentiate layers.gqa_attention, JAX's training route"
        )
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def _rows_on_16_bytes(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 and s > 0 for s in t.stride()[:3])


def bf16_smem_bytes(dh: int) -> int:
    """Dynamic shared memory of one block of the bf16 kernel: 1024 bytes of
    alignment slack, the q tile, the k/v ring and its barriers."""
    bk, st = TILE_K[dh], STAGES[dh]
    return 1024 + 2 * dh * (BLOCK_Q + 2 * st * bk) + 8 * (1 + 3 * st)


def flash_attention_cuda(q, k, v, *, causal=True, window=None):
    """The CUDA kernel: float32 in 64-row by 64-key tiles on FMA units,
    bf16 in 128-row blocks over a ring of ``TILE_K[Dh]``-key tiles on the
    tensor cores."""
    dev = _build.cuda_device(q)
    b, h, sq, dh = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if dh not in HEAD_DIMS:
        raise ValueError(
            f"head_dim={dh} is not one the flash kernel is compiled for {HEAD_DIMS}"
        )
    hkv, skv = k.shape[1], k.shape[2]
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != dh or h % hkv:
        raise ValueError(f"k has shape {tuple(k.shape)}; expected [{b}, Hkv | {h}, Skv, {dh}]")
    for t, what in ((k, "k"), (v, "v")):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{what} is {t.dtype} on {t.device}; expected {q.dtype} on {dev}")
    if v.shape != k.shape or v.stride() != k.stride():
        raise ValueError("v must have the shape and strides of k")
    if q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError("q, k and v need a contiguous last (head_dim) axis")
    if q.dtype == torch.bfloat16:
        dense = dict(memory_format=torch.contiguous_format)
        if not _rows_on_16_bytes(q):
            q = q.clone(**dense)
        if not (_rows_on_16_bytes(k) and _rows_on_16_bytes(v)):  # k and v share strides
            k, v = k.clone(**dense), v.clone(**dense)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    w = -1 if window is None else max(int(window), 0)
    lib = _build.library("flash_attention")
    rc = lib.warp_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, hkv, sq, skv, dh, *q.stride()[:3], *k.stride()[:3], *out.stride()[:3],
        int(causal), w, _DTYPES[q.dtype], _build.stream_ptr(dev),
    )
    _build.check("flash_attention", rc)
    _build.LAUNCHES["flash_attention"] += 1
    return out
