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

Over a mesh (``make_train_step(..., layout=)``, ``layout`` a
``launch/sharding.py::TrainLayout`` and its mesh) every rank runs the step on its
blocks and its rows, and computes what JAX's ``jit(make_train_step)``
computes under the same shardings: the loss is the global batch's (the
model's collectives make each rank's gradient its own rows' share), each
gradient is summed over the data axes its parameter is replicated over
(one float32 all-reduce of all of them; a ZeRO-1 parameter's is
reduce-scattered to the slice the rank updates), a kv head held by several
model ranks has its gradient summed over them, and the optimizer runs on
the blocks. Microbatches follow JAX's global order: microbatch i is the
global rows [i·B/mb, (i+1)·B/mb), each cut over the data axes; a rank's
batch (``shard_batch``) holds its block of each microbatch in turn. The
metrics are the global ones, the same bits on every rank.
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

__all__ = ["TrainState", "make_train_step", "train_loop", "FailureInjector", "shard_batch",
           "sync_grads"]


@dataclasses.dataclass
class TrainState:
    params: dict  # name -> nn.Parameter, float32
    opt: dict  # {"m": {...}, "v": {...}, "step": int32}
    error_fb: dict | None = None  # gradient-compression error feedback

    @staticmethod
    def create(params: dict, *, compression: bool = False, layout=None) -> "TrainState":
        """A fresh state over ``params`` (each tensor made an ``nn.Parameter``
        sharing its storage); with ``layout``, a rank's blocks, its moments
        and error feedback in the moments' layout (ZeRO-1 slices)."""
        params = {k: p if isinstance(p, nn.Parameter) else nn.Parameter(p) for k, p in params.items()}
        return TrainState(
            params=params,
            opt=adamw_init(params, layout),
            error_fb=init_error_state(params, layout) if compression else None,
        )


def shard_batch(batch: dict, mesh, microbatches: int = 1) -> dict:
    """This rank's rows of a global batch (each tensor's leading axis):
    for each microbatch in turn (the global rows [i·B/mb, (i+1)·B/mb)),
    the rank's block of it over the data axes. With one microbatch, the
    block ``input_pspec`` names."""
    from repro_torch.launch.mesh import data_axes

    data = data_axes(mesh)
    n, i = mesh.size_of(data), mesh.index_of(data)

    def cut(x):
        b = x.shape[0]
        if b % (microbatches * n):
            raise ValueError(f"a batch of {b} rows does not split into {microbatches} "
                             f"microbatches over {n} data ranks")
        per = b // (microbatches * n)
        return x.reshape(microbatches, n, per, *x.shape[1:])[:, i].reshape(-1, *x.shape[1:])

    return {k: cut(v) for k, v in batch.items()}


def make_train_step(
    loss_fn: Callable[[dict, Any], tuple[torch.Tensor, dict]],
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    compression: bool = False,
    layout=None,
):
    """Returns step(state, batch) -> (state, metrics).

    microbatches > 1: the leading axis of every tensor in ``batch`` is
    split into ``microbatches`` chunks; the gradients are summed in float32
    and divided, the loss is the mean of the chunks' losses, and the other
    metrics are those of the last chunk, as JAX's ``lax.scan`` gives them.
    With ``layout`` (a ``TrainLayout``), the rank's step on its mesh, over
    its blocks and its ``shard_batch`` rows (see the module).
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

        if layout is not None:
            grads = sync_grads(grads, layout)
        error_fb = state.error_fb
        if compression:
            grads, error_fb = compress_grads(grads, error_fb, enabled=True, layout=layout)

        params, opt, opt_metrics = adamw_update(opt_cfg, state.params, grads, state.opt, layout)
        del grads
        return TrainState(params=params, opt=opt, error_fb=error_fb), {
            "loss": loss, **metrics, **opt_metrics,
        }

    return step


@torch.no_grad()
def sync_grads(grads: dict, layout) -> dict:
    """Each rank's gradients (its rows' share of each block) -> the global
    gradient's blocks it keeps: a kv head's summed over the model ranks
    that share it, a ZeRO-1 parameter's reduce-scattered over the data axes
    to the rank's slice, and the others replicated over data axes summed
    there, all of those in one float32 all-reduce per set of axes."""
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import MODEL_AXIS

    mesh = layout.mesh
    out = dict(grads)
    shared = [k for k in grads if layout.kv_shared(k) > 1]
    if shared:  # each rank's kv head at its place among the heads, summed over the model axis
        m = mesh.shape[MODEL_AXIS]
        slot = mesh.index_of(MODEL_AXIS) * layout.cfg.n_kv_heads // m
        parts = []
        for k in shared:
            g = grads[k].float()
            z = torch.zeros((layout.cfg.n_kv_heads, *g.shape), dtype=g.dtype, device=g.device)
            z[slot] = g
            parts.append(z)
        summed = _flat_all_reduce(parts, mesh, MODEL_AXIS)
        for k, z in zip(shared, summed):
            out[k] = z[slot].to(grads[k].dtype)
    buckets: dict = {}
    for k, g in out.items():
        axes = sharding.grad_sync_axes(layout.param_specs[k], mesh)
        if not axes:
            continue
        dim = layout.zero1_dim(k)
        if dim is not None:
            out[k] = mesh.reduce_scatter(g, axes, dim)
        else:
            buckets.setdefault(axes, []).append(k)
    for axes, names in buckets.items():
        for k, g in zip(names, _flat_all_reduce([out[k] for k in names], mesh, axes)):
            out[k] = g
    return out


def _flat_all_reduce(tensors: list, mesh, axes) -> list:
    """The sums of ``tensors`` over ``axes`` through one all-reduce of their
    concatenation, each cast back to its dtype."""
    flat = torch.cat([t.float().reshape(-1) for t in tensors])
    flat = mesh.all_reduce(flat, axes)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


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
