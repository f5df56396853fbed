"""Generic training loop of the port: microbatch gradient accumulation,
optional int8 gradient compression with error feedback, atomic
checkpoints with auto-resume, and failure injection for fault-tolerance
tests. Counterpart of ``repro/train/loop.py``.

``make_train_step`` builds one step from any ``loss_fn(params, batch) ->
(loss, metrics)``, where ``params`` is the state's dict of
``nn.Parameter``s and the loss is built from those very tensors
(``configs.families.lm_loss_fn`` does so for the LM); gradients are taken
with ``torch.autograd.grad``, which refuses a parameter the loss does not
reach. The step updates the state in place (see ``train/optimizer.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compression import compress_grads, init_error_state
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainState", "make_train_step", "train_loop", "FailureInjector"]


@dataclasses.dataclass
class TrainState:
    params: dict  # name -> nn.Parameter, float32
    opt: dict  # {"m": {...}, "v": {...}, "step": int32}
    error_fb: dict | None = None  # gradient-compression error feedback

    @staticmethod
    def create(params: dict, *, compression: bool = False) -> "TrainState":
        """A fresh state over ``params`` (each tensor made an ``nn.Parameter``
        sharing its storage)."""
        params = {k: p if isinstance(p, nn.Parameter) else nn.Parameter(p) for k, p in params.items()}
        return TrainState(
            params=params,
            opt=adamw_init(params),
            error_fb=init_error_state(params) if compression else None,
        )


def make_train_step(
    loss_fn: Callable[[dict, Any], tuple[torch.Tensor, dict]],
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    compression: bool = False,
):
    """Returns step(state, batch) -> (state, metrics).

    microbatches > 1: the leading axis of every tensor in ``batch`` is
    split into ``microbatches`` chunks; the gradients are summed in float32
    and divided, the loss is the mean of the chunks' losses, and the other
    metrics are those of the last chunk, as JAX's ``lax.scan`` gives them.
    """

    def grad_one(params, mb):
        loss, metrics = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, list(params.values()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(zip(params, grads)), loss.detach(), metrics

    def split(x):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        return x.reshape(microbatches, b // microbatches, *x.shape[1:])

    def step(state: TrainState, batch: dict):
        if microbatches == 1:
            grads, loss, metrics = grad_one(state.params, batch)
        else:
            mbs = {k: split(v) for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in state.params.items()}
            loss = torch.zeros((), device=next(iter(grads.values())).device)
            for i in range(microbatches):
                g, l_i, metrics = grad_one(state.params, {k: v[i] for k, v in mbs.items()})
                for k in grads:
                    grads[k] += g[k]
                loss = loss + l_i
                del g
            grads = {k: g / microbatches for k, g in grads.items()}
            loss = loss / microbatches

        error_fb = state.error_fb
        if compression:
            grads, error_fb = compress_grads(grads, error_fb, enabled=True)

        params, opt, opt_metrics = adamw_update(opt_cfg, state.params, grads, state.opt)
        del grads
        return TrainState(params=params, opt=opt, error_fb=error_fb), {
            "loss": loss, **metrics, **opt_metrics,
        }

    return step


class FailureInjector:
    """Deterministic failure schedule for fault-tolerance tests: raises at
    the configured global steps (simulating node loss / preemption)."""

    def __init__(self, fail_at: tuple[int, ...] = ()):  # steps at which to die
        self.fail_at = set(fail_at)
        self.tripped: set[int] = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.tripped:
            self.tripped.add(step)
            raise RuntimeError(f"injected failure at step {step}")


def train_loop(
    *,
    init_params_fn: Callable[[], dict],
    loss_fn: Callable[[dict, Any], tuple[torch.Tensor, dict]],
    batch_iter: Callable[[int], dict],
    opt_cfg: AdamWConfig,
    n_steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    keep: int = 3,
    microbatches: int = 1,
    compression: bool = False,
    failure: FailureInjector | None = None,
    log_every: int = 10,
    log_fn: Callable[[str], None] = print,
    device=None,
) -> tuple[TrainState, list[dict]]:
    """Run (or resume) training on ``device`` (None: the card): the
    parameters from ``init_params_fn`` and each ``batch_iter(step)``
    (tensors or anything ``torch.as_tensor`` takes) are placed there. On
    restart with the same ckpt_dir the loop continues from the newest
    committed checkpoint."""
    dev = resolve_device(device)
    step_fn = make_train_step(loss_fn, opt_cfg, microbatches=microbatches, compression=compression)

    params = {k: torch.as_tensor(v).to(dev) for k, v in init_params_fn().items()}
    state = TrainState.create(params, compression=compression)
    start = 0
    if ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            state, start = ckpt.restore_checkpoint(ckpt_dir, state, latest)
            log_fn(f"[resume] restored step {start} from {ckpt_dir}")

    history = []
    t0 = time.perf_counter()
    for step in range(start, n_steps):
        if failure is not None:
            failure.maybe_fail(step)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_iter(step).items()}
        state, metrics = step_fn(state, batch)
        if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
            ckpt.save_checkpoint(ckpt_dir, step + 1, state)
            ckpt.retain_last(ckpt_dir, keep)
        if (step + 1) % log_every == 0 or step == n_steps - 1:
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            log_fn(f"step {step + 1}/{n_steps} loss={loss:.4f} ({dt:.1f}s)")
            history.append({"step": step + 1, "loss": loss})
    if ckpt_dir is not None:
        ckpt.save_checkpoint(ckpt_dir, n_steps, state)
        ckpt.retain_last(ckpt_dir, keep)
    return state, history
