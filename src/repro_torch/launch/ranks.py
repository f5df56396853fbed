"""Worlds of document-shard ranks: one process per shard, joined in one
``torch.distributed`` process group. The counterpart of
``repro/launch/mesh.py`` for processes: where JAX lays a mesh over the
devices of one process, the port spawns S processes, rank r on its own
device holding shard r.

    run_world(fn, 4, backend="nccl")                  # rank r on cuda:r
    run_world(fn, 4, backend="gloo")                  # rank r on cuda:(r % cards)
    run_world(fn, 4, backend="gloo", device="cuda:0") # every rank on cuda:0
    run_world(fn, 3, backend="gloo", device="cpu")    # the CPU, when asked for

``fn(group, *args)`` runs in every rank with its ``RankGroup``. Rank 0
leads: it loads ``Retriever.from_store(path, group=group)`` and drives it
(or a ``RetrievalServer`` over it), then calls ``group.stop()``; ranks
1..S-1 run ``repro_torch.serving.follow(group)``, which runs every
operation rank 0 leads, the load included. ``fn`` and ``args`` are
pickled, so ``fn`` is a module-level function.

SPMD worlds (``run_mesh``) carry a mesh instead: ``fn(mesh, *args)``
runs in every rank with its ``RankMesh`` (``launch/mesh.py``) over the
world, and every rank runs the step (the LM and recsys families placed by
``launch/sharding.py``'s rules). One world may lay several meshes over its
ranks in turn (``group.mesh(shape, axes)``).

- Processes come from ``torch.multiprocessing.get_context("spawn")``; the
  caller's start method is left alone.
- The ranks meet through a ``FileStore`` in a temporary directory: no
  port is opened for the rendezvous, and the parent never joins the group
  and sets no environment variable of its own.
- Devices are explicit. ``backend="nccl"`` puts rank r on ``cuda:r`` and
  needs S <= ``torch.cuda.device_count()``; ``backend="gloo"`` puts rank r
  on ``cuda:(r % count)``, every rank on one card named with its index
  (``device="cuda:0"``), or on the CPU with ``device="cpu"`` (gloo only).
  Nothing picks another backend or device: what cannot run raises.
- The group has a finite ``timeout`` (``PG_TIMEOUT_S``). Each child destroys it before it
  exits, and dies with its parent. If a child exits nonzero or the world
  outlives ``join_timeout_s``, the parent kills the rest and raises
  ``WorldFailed`` with the failed ranks' tracebacks.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import datetime
import multiprocessing.connection
import os
import shutil
import signal
import tempfile
import time
import traceback

import torch

from repro_torch.core.distributed import RankGroup

__all__ = ["BACKENDS", "WorldFailed", "run_mesh", "run_world", "world_devices"]

BACKENDS = ("nccl", "gloo")
# A collective that waits longer than this raises in the ranks that wait.
PG_TIMEOUT_S = 300.0
_PR_SET_PDEATHSIG = 1


class WorldFailed(RuntimeError):
    """A rank of a world exited nonzero, or the world outlived its join
    timeout; the other ranks were killed."""


def world_devices(n_ranks: int, backend: str, device=None) -> list[torch.device]:
    """Each rank's device: ``cuda:r`` under NCCL (one card per rank),
    ``cuda:(r % count)`` under gloo, or under gloo the one card ``device``
    names with its index, or the CPU when ``device`` is "cpu". Raises where
    the world cannot run as asked."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r} is not one of {BACKENDS}")
    if n_ranks < 1:
        raise ValueError(f"a world needs at least one rank, got {n_ranks}")
    dev = torch.device("cuda" if device is None else device)
    kind = dev.type
    if kind == "cpu":
        if backend == "nccl":
            raise ValueError("backend='nccl' runs on cards; ranks on the CPU take backend='gloo'")
        return [torch.device("cpu")] * n_ranks
    if kind != "cuda":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"backend={backend!r} on the card, but no CUDA device is available; "
            "pass device='cpu' with backend='gloo' to run the ranks on the CPU"
        )
    count = torch.cuda.device_count()
    if dev.index is not None:
        if backend == "nccl":
            raise ValueError(f"backend='nccl' puts each rank on its own card, not all on {dev}")
        if dev.index >= count:
            raise ValueError(f"{dev} is not one of the {count} visible card(s)")
        return [dev] * n_ranks
    if backend == "nccl":
        if n_ranks > count:
            raise ValueError(
                f"backend='nccl' puts each of {n_ranks} ranks on its own card, but "
                f"{count} card(s) are visible; use fewer ranks, or backend='gloo' to "
                "share cards"
            )
        return [torch.device("cuda", r) for r in range(n_ranks)]
    return [torch.device("cuda", r % count) for r in range(n_ranks)]


@dataclasses.dataclass(frozen=True)
class _Spec:
    rank: int
    size: int
    backend: str
    device: str
    init_file: str
    threads: int | None
    parent: int
    err_dir: str


def _die_with_parent(parent: int) -> None:
    """Linux: the kernel kills this process when its parent dies."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    except (OSError, AttributeError):
        return
    if os.getppid() != parent:  # the parent died before prctl
        os._exit(1)


def _child(spec: _Spec, fn, args) -> None:
    """One rank. Its traceback, if it fails, is written before it leaves
    the group, so it is on disk by the time another rank fails for want
    of it."""
    _die_with_parent(spec.parent)
    try:
        import torch.distributed as tdist

        if spec.threads:
            torch.set_num_threads(spec.threads)
        device = torch.device(spec.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        tdist.init_process_group(
            spec.backend, init_method="file://" + spec.init_file, rank=spec.rank,
            world_size=spec.size, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S),
            **({"device_id": device} if spec.backend == "nccl" else {}),
        )
        try:
            fn(RankGroup(spec.rank, spec.size, spec.backend, device), *args)
        except BaseException:
            _record(spec)
            raise
        finally:
            tdist.destroy_process_group()
    except BaseException:
        _record(spec)
        raise


def _record(spec: _Spec) -> None:
    path = _err_path(spec.err_dir, spec.rank)
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write(traceback.format_exc())


@contextlib.contextmanager
def _child_env(env: dict):
    """``env`` set while the children are spawned (they copy the parent's
    environment then), the parent's own values restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _err_path(err_dir: str, rank: int) -> str:
    return os.path.join(err_dir, f"rank{rank}.err")


def _error_of(err_dir: str, rank: int) -> str:
    try:
        with open(_err_path(err_dir, rank)) as f:
            return f.read().strip()
    except OSError:
        return "(no traceback recorded)"


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def run_world(
    fn,
    n_ranks: int,
    *,
    backend: str,
    device=None,
    args: tuple = (),
    join_timeout_s: float = 600.0,
    threads: int | None = None,
    workdir: str | None = None,
) -> None:
    """Spawn ``n_ranks`` processes, join them in a ``backend`` process
    group on ``world_devices(n_ranks, backend, device)``, run ``fn(group,
    *args)`` in each, and wait for all to exit 0. ``threads`` sets each
    child's ``torch.set_num_threads`` and ``OMP_NUM_THREADS``; the
    rendezvous file lives in a fresh directory under ``workdir`` (None:
    the system's temporary directory), removed at the end. Raises
    ``WorldFailed`` (the other ranks killed) when a rank fails or the world
    outlives ``join_timeout_s``."""
    devices = world_devices(n_ranks, backend, device)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_", dir=workdir)
    procs = []
    env = {"OMP_NUM_THREADS": str(threads)} if threads else {}
    try:
        with _child_env(env):
            for r, dev in enumerate(devices):
                spec = _Spec(r, n_ranks, backend, str(dev), os.path.join(tmp, "rendezvous"),
                             threads, os.getpid(), tmp)
                p = ctx.Process(target=_child, args=(spec, fn, args), name=f"rank{r}", daemon=True)
                p.start()
                procs.append(p)
        deadline = time.monotonic() + join_timeout_s
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                # Every rank that raised, in rank order: one that failed for
                # want of another may exit first.
                raised = [r for r in range(n_ranks) if os.path.exists(_err_path(tmp, r))]
                _kill(procs)
                raise WorldFailed(
                    f"a rank of {n_ranks} ({backend}) exited nonzero (exit codes {codes}); "
                    f"ranks that raised: {raised or 'none'}\n"
                    + "\n".join(f"--- rank {r} ---\n{_error_of(tmp, r)}" for r in raised)
                )
            if all(c == 0 for c in codes):
                return
            left = deadline - time.monotonic()
            if left <= 0:
                _kill(procs)
                raise WorldFailed(
                    f"the world of {n_ranks} ranks ({backend}) outlived its join timeout "
                    f"of {join_timeout_s:g} s; exit codes {codes}"
                )
            multiprocessing.connection.wait(
                [p.sentinel for p in procs if p.exitcode is None], timeout=min(left, 1.0)
            )
    finally:
        _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def _spmd(group, fn, shape, axes, args) -> None:
    fn(group.mesh(shape, axes), *args)


def run_mesh(fn, shape: tuple[int, ...], axes: tuple[str, ...] = ("data", "model"), *,
             backend: str, device=None, args: tuple = (), join_timeout_s: float = 600.0,
             threads: int | None = None, workdir: str | None = None) -> None:
    """``run_world`` over a mesh of ``shape`` (named ``axes``): one rank
    per position, each running ``fn(mesh, *args)`` with its ``RankMesh``.
    ``fn`` is a module-level function (it is pickled)."""
    n = 1
    for d in shape:
        n *= int(d)
    run_world(_spmd, n, backend=backend, device=device, args=(fn, tuple(shape), tuple(axes), args),
              join_timeout_s=join_timeout_s, threads=threads, workdir=workdir)
