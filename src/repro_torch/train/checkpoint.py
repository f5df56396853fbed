"""Atomic checkpoints of the port, in the JAX package's layout
(``repro/train/checkpoint.py``):

    <dir>/step_<N:08d>/
        manifest.json   - step, the tree's description, and per leaf its
                          file, name, shape and dtype
        leaf_<i:05d>.npy - one array per leaf
        _COMMITTED      - written last; restore ignores dirs without it

A step is written to ``step_<N>.tmp`` and renamed into place, so a
process killed mid-save leaves the newest committed step intact.
``latest_step`` finds that step and ``retain_last`` keeps the last K.

A tree is nested dicts (in their insertion order), dataclasses (in field
order, such as ``TrainState``), tensors and ``None`` (no leaf). The leaf
order is this flattening's, and each leaf's dotted name is written in the
manifest; restoring checks names (where the manifest has them), shapes
and count against the template.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "retain_last", "flatten"]

_COMMIT = "_COMMITTED"


def flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """[(dotted name, tensor)] of ``tree``'s leaves in order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:
        raise TypeError(f"checkpoint leaf {prefix!r} is a {type(tree).__name__}, not a tensor")
    return [leaf for k, v in items for leaf in flatten(v, f"{prefix}.{k}" if prefix else str(k))]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{f.name: _rebuild(getattr(tree, f.name), leaves) for f in dataclasses.fields(tree)}
        )
    return {k: _rebuild(v, leaves) for k, v in tree.items()}


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, tree) -> str:
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = flatten(tree)
    manifest = {"step": step, "treedef": type(tree).__name__, "leaves": []}
    for i, (name, leaf) in enumerate(leaves):
        arr = leaf.detach().cpu().numpy()
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"file": fname, "name": name, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(n.split("_")[1])
        for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(directory, n, _COMMIT))
    )


def latest_step(directory: str) -> int | None:
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, tree_like, step: int | None = None, device=None):
    """Restore into the structure of ``tree_like`` (the template: its
    leaves give names, shapes, dtypes and, unless ``device`` is given, the
    device) -> (tree, step). A template ``nn.Parameter`` comes back as a
    new ``nn.Parameter``. ``step=None`` is the newest committed one."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = flatten(tree_like)
    if len(like) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, template has {len(like)}"
        )
    out = []
    for (name, t), meta in zip(like, manifest["leaves"]):
        if meta.get("name", name) != name:  # JAX's manifests name no leaf
            raise ValueError(f"checkpoint leaf {meta['name']!r} where the template has {name!r}")
        arr = np.load(os.path.join(path, meta["file"]))
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch at {name}: {arr.shape} vs {tuple(t.shape)}")
        x = torch.from_numpy(arr).to(device=device or t.device, dtype=t.dtype)
        out.append(nn.Parameter(x, requires_grad=t.requires_grad) if isinstance(t, nn.Parameter) else x)
    return _rebuild(tree_like, iter(out)), step


def retain_last(directory: str, keep: int = 3) -> None:
    for s in _committed_steps(directory)[:-keep]:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
