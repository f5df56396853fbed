"""Hill-climb runner of the port: one cell of the dry run with config
overrides, recorded beside its change from the baseline record of the
same cell. Counterpart of ``repro/launch/hillclimb.py``.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch qwen2-0.5b \\
      --shape train_4k --variant fused_ce --set fused_ce=True
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch warp-xtr \\
      --shape search_lifestyle --variant ragged --search-set layout=\\'ragged\\' gather=\\'fused\\'

``--set k=v`` replaces fields of the arch's config (a dict value replaces
fields of a nested dataclass, e.g. ``moe={'capacity_factor': 2.0}``);
``--search-set`` replaces fields of a warp cell's search config. The
modified ``ArchDef`` goes to ``dryrun.run_cell``, which runs the baseline
too unless ``--baseline`` names its record: no registry entry or family
method is patched. The record lands in ``<out>/<mesh>/<arch>__<shape>__
<variant>.json`` with ``variant``, ``overrides`` and ``delta``: each
term's change from the baseline (variant minus baseline).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os

from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun

__all__ = ["delta", "main", "parse_overrides", "run_variant"]

# The terms whose change from the baseline a variant's record carries.
TERMS = {
    "model_flops": ("model_flops",),
    "per_device_flops": ("per_device_flops",),
    "per_device_bytes": ("per_device_bytes",),
    "collective_bytes": ("collectives", "total_bytes"),
    "compute_s": ("roofline", "compute_s"),
    "memory_s": ("roofline", "memory_s"),
    "collective_s": ("roofline", "collective_s"),
    "step_lower_bound_s": ("roofline", "step_lower_bound_s"),
    "model_mfu_at_bound": ("roofline", "model_mfu_at_bound"),
    "p50_ms": ("measured", "p50_ms"),
    "peak_bytes": ("measured", "peak_bytes"),
    "mfu": ("measured", "mfu"),
}


def parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs:
        k, v = p.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def _get(rec: dict, path):
    for k in path:
        if rec is None:
            return None
        rec = rec.get(k)
    return rec


def delta(rec: dict, base: dict) -> dict:
    """Each of ``TERMS`` in ``rec`` minus in ``base`` (None where either
    lacks it)."""
    out = {}
    for name, path in TERMS.items():
        a, b = _get(rec, path), _get(base, path)
        out[name] = None if a is None or b is None else a - b
    return out


def _apply(cfg, overrides: dict):
    """``cfg`` with ``overrides``: a dict value on a dataclass field
    replaces fields of that nested dataclass."""
    ov = dict(overrides)
    for key, val in list(ov.items()):
        cur = getattr(cfg, key, None)
        if isinstance(val, dict) and dataclasses.is_dataclass(cur):
            ov[key] = dataclasses.replace(cur, **val)
    return dataclasses.replace(cfg, **ov) if ov else cfg


def run_variant(
    arch_name: str,
    shape: str,
    variant: str,
    overrides: dict,
    *,
    search_overrides: dict | None = None,
    device="cuda",
    reduced: bool = False,
    ranks: int | None = None,
    seed: int = 0,
    iters: int = 5,
    baseline: dict | None = None,
    out_dir: str | None = "build/perf",
) -> dict:
    """Run ``arch_name``/``shape`` with ``overrides`` applied to the config
    it runs (the reduced one with ``reduced``) and ``search_overrides`` to
    a warp cell's search config; ``baseline`` is the unmodified cell's
    record (None: run it here). Writes the record under ``out_dir`` (None:
    nowhere) and returns it."""
    arch = get_arch(arch_name)
    field = "reduced" if reduced else "config"
    new_arch = dataclasses.replace(arch, **{field: _apply(getattr(arch, field), overrides)})
    kw = dict(device=device, reduced=reduced, ranks=ranks, seed=seed, iters=iters)
    if baseline is None:
        baseline = dryrun.run_cell(arch_name, shape, **kw)
    rec = dryrun.run_cell(arch_name, shape, arch=new_arch, search_overrides=search_overrides,
                          **kw)
    rec["variant"] = variant
    rec["overrides"] = {k: repr(v) for k, v in {**overrides, **(search_overrides or {})}.items()}
    rec["delta"] = delta(rec, baseline)
    if out_dir is not None:
        d = os.path.join(out_dir, rec["mesh"])
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{arch_name}__{shape}__{variant}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--set", nargs="*", default=[], help="config overrides k=v")
    ap.add_argument("--search-set", nargs="*", default=[], help="WarpSearchConfig overrides")
    ap.add_argument("--baseline", default=None, help="the cell's dry-run record (else run here)")
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default="build/perf")
    args = ap.parse_args(argv)
    baseline = None
    if args.baseline:
        with open(args.baseline) as f:
            baseline = json.load(f)
    rec = run_variant(
        args.arch, args.shape, args.variant, parse_overrides(args.set),
        search_overrides=parse_overrides(args.search_set) or None, device=args.device,
        reduced=args.reduced, ranks=args.ranks, iters=args.iters, baseline=baseline,
        out_dir=args.out,
    )
    t = rec["roofline"]
    print(json.dumps({
        "variant": args.variant,
        "bound_ms": t["step_lower_bound_s"] * 1e3,
        "compute_ms": t["compute_s"] * 1e3,
        "memory_ms": t["memory_s"] * 1e3,
        "collective_ms": t["collective_s"] * 1e3,
        "mfu_at_bound": t.get("model_mfu_at_bound"),
        "mfu": rec["measured"]["mfu"],
        "p50_ms": rec["measured"]["p50_ms"],
        "delta": rec["delta"],
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
