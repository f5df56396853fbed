"""Family entry points of the port and their shapes: the port's copy of
``repro/configs/families.py`` for the LM and recsys families.

``LMFamily`` runs the LM family's cells: ``shape_cell``, ``input_specs``
(each input as a (shape, dtype) pair), ``step_fn`` (train through
``train.make_train_step`` with the arch's ``train_microbatches``; prefill
and decode through the model) and ``smoke`` (the reduced config for real).
``RecsysFamily`` holds the recsys shapes (its serve and retrieval steps
are ``models/recsys.py::serve_step``); recsys training, like the GNN
family, waits for a later slice of the port. JAX's ``abstract_state``,
``state_pspec`` and ``input_pspec`` shape and place arrays on a TPU mesh
for the dry run and are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchDef, ShapeCell
from repro_torch.core.types import resolve_device
from repro_torch.models.convert import init_params
from repro_torch.models.transformer import KVCache, TransformerConfig, TransformerLM
from repro_torch.train.loop import TrainState, make_train_step
from repro_torch.train.optimizer import AdamWConfig

__all__ = [
    "LMShape", "LM_SHAPES", "LM_SHAPES_REDUCED", "LMFamily", "lm_loss_fn",
    "RecsysShape", "RECSYS_SHAPES", "RECSYS_SHAPES_REDUCED", "RecsysFamily",
]

_OPT = AdamWConfig()


# ======================================================================= LM
@dataclasses.dataclass(frozen=True)
class LMShape:
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES = {
    "train_4k": LMShape(4096, 256, "train"),
    "prefill_32k": LMShape(32768, 32, "prefill"),
    "decode_32k": LMShape(32768, 128, "decode"),
    "long_500k": LMShape(524288, 1, "decode"),
}

# Reduced geometry used by smoke tests (same kind, tiny sizes).
LM_SHAPES_REDUCED = {
    "train_4k": LMShape(64, 4, "train"),
    "prefill_32k": LMShape(128, 2, "prefill"),
    "decode_32k": LMShape(128, 4, "decode"),
    "long_500k": LMShape(256, 1, "decode"),
}


class _LMLoss:
    """``loss_fn(params, batch) -> (loss, metrics)`` of ``TransformerLM.loss``
    over a state dict of ``nn.Parameter``s (``TrainState``'s): the model is
    a view onto those very tensors, built once per params dict."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg
        self._params = self._model = None

    def __call__(self, params: dict, batch: dict):
        if params is not self._params:
            self._model = TransformerLM.from_params(self.cfg, params, trainable=True)
            self._params = params
        return self._model.loss(batch["tokens"], batch["labels"])


def lm_loss_fn(cfg: TransformerConfig) -> _LMLoss:
    return _LMLoss(cfg)


class LMFamily:
    name = "lm"

    @staticmethod
    def shape_cell(arch: ArchDef, shape: str) -> ShapeCell:
        s = LM_SHAPES[shape]
        return ShapeCell(shape, s.kind, dataclasses.asdict(s))

    @staticmethod
    def input_specs(arch: ArchDef, shape: str, *, reduced: bool = False) -> dict:
        """name -> (shape, dtype); a cache is a dict of its k, v and length
        (bf16 k/v, as JAX's ``KVCache.empty`` default)."""
        cfg: TransformerConfig = arch.reduced if reduced else arch.config
        s = (LM_SHAPES_REDUCED if reduced else LM_SHAPES)[shape]
        b, sl = s.global_batch, s.seq_len
        if s.kind == "train":
            return {"tokens": ((b, sl), torch.int32), "labels": ((b, sl), torch.int32)}
        kv = ((cfg.n_layers, b, sl, cfg.n_kv_heads, cfg.resolved_head_dim), torch.bfloat16)
        cache = {"k": kv, "v": kv, "length": ((b,), torch.int32)}
        tokens = (b, sl) if s.kind == "prefill" else (b,)
        return {"tokens": (tokens, torch.int32), "cache": cache}

    @staticmethod
    def step_fn(arch: ArchDef, shape: str, *, reduced: bool = False):
        """train: ``step(TrainState, batch) -> (TrainState, metrics)``;
        prefill and decode: ``step(model, batch) -> (logits, cache)``."""
        cfg: TransformerConfig = arch.reduced if reduced else arch.config
        s = (LM_SHAPES_REDUCED if reduced else LM_SHAPES)[shape]
        if s.kind == "train":
            return make_train_step(lm_loss_fn(cfg), _OPT, microbatches=arch.train_microbatches)
        if s.kind == "prefill":
            def prefill_step(model: TransformerLM, batch):
                return model.prefill(batch["tokens"], batch["cache"])
            return prefill_step

        def decode_step(model: TransformerLM, batch):
            return model.decode_step(batch["tokens"], batch["cache"])
        return decode_step

    @staticmethod
    def smoke(arch: ArchDef, shape: str, seed: int = 0, *, device=None) -> dict:
        """The reduced config for real on ``device`` (None: the card), weights
        and tokens from ``seed``: {"loss"} for train, {"logits"} else."""
        dev = resolve_device(device)
        cfg: TransformerConfig = arch.reduced
        s = LM_SHAPES_REDUCED[shape]
        g = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, g, device=dev)
        b, sl = s.global_batch, s.seq_len
        tokens = torch.randint(0, cfg.vocab, (b, sl), generator=g, device=dev)
        step = LMFamily.step_fn(arch, shape, reduced=True)
        if s.kind == "train":
            _, metrics = step(TrainState.create(params), {"tokens": tokens, "labels": tokens})
            return {"loss": metrics["loss"]}
        model = TransformerLM.from_params(cfg, params)
        cache = KVCache.empty(cfg, b, sl, torch.float32, device=dev)
        if s.kind == "prefill":
            return {"logits": step(model, {"tokens": tokens, "cache": cache})[0]}
        # decode: prefill a short prompt then decode one token
        _, cache = model.prefill(tokens[:, : sl // 2], cache)
        return {"logits": step(model, {"tokens": tokens[:, 0], "cache": cache})[0]}


# =================================================================== RecSys
@dataclasses.dataclass(frozen=True)
class RecsysShape:
    kind: str
    batch: int
    n_candidates: int | None = None


RECSYS_SHAPES = {
    "train_batch": RecsysShape("train", 65536),
    "serve_p99": RecsysShape("serve", 512),
    "serve_bulk": RecsysShape("serve", 262144),
    "retrieval_cand": RecsysShape("retrieval", 1, n_candidates=1_000_000),
}

RECSYS_SHAPES_REDUCED = {
    "train_batch": RecsysShape("train", 64),
    "serve_p99": RecsysShape("serve", 16),
    "serve_bulk": RecsysShape("serve", 128),
    "retrieval_cand": RecsysShape("retrieval", 1, n_candidates=512),
}


class RecsysFamily:
    """``batch`` is users (or rows) per step; ``retrieval`` scores one user
    against ``n_candidates``. The serve and retrieval steps are
    ``models.recsys.serve_step(model, shape)``."""

    name = "recsys"

    @staticmethod
    def shape_cell(arch: ArchDef, shape: str) -> ShapeCell:
        s = RECSYS_SHAPES[shape]
        return ShapeCell(shape, s.kind, dataclasses.asdict(s))
