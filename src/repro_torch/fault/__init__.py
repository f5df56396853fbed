"""repro_torch.fault — deterministic fault injection. Counterpart of
``repro/fault/__init__.py``.

A ``FaultPlan`` (scripted rules and/or a seeded random schedule) is
installed process-wide, and the store / engine / serving layers consult
named **injection points** where those faults would strike. Disabled (the
default) a hook costs one attribute check (``FAULTS.plan is None``), so
the hooks stay in the code that serves real traffic.

Named injection points (``SITES``):

  ``store.array_read``      raw binary open / head-checksum read
                            (``store/format.py::_load_entry``)
  ``store.manifest_parse``  MANIFEST.json read + decode
                            (``store/format.py::read_manifest``)
  ``store.segment_load``    per-delta-segment array load
                            (``store/format.py::load_segment_arrays``)
  ``store.compact_step``    each checkpoint of the compact protocol, in
                            order (``store/segments.py::_compact_locked``)
  ``engine.kernel_call``    entry of every scoring-stage dispatch
                            (``kernels/ops.py``), on the card and on the
                            CPU, at every call. The JAX package fires it
                            at trace time, once per compilation; the port
                            compiles nothing, so firing counts differ
                            between the packages.
  ``server.reload``         hot index swap (``serving/batcher.py``)

A firing point raises an ``InjectedFault`` by default, or the exception
the rule supplies. The store converts it into ``StoreCorruption``; a
failing ``engine.kernel_call`` is not converted: the port has no executor
fallback, so it propagates to the caller (every member of a served batch
gets it from its ``poll``).
"""

from __future__ import annotations

from repro_torch.fault.plan import (
    FAULTS,
    SITES,
    FaultPlan,
    FaultRule,
    InjectedFault,
    active,
    check,
    install,
    uninstall,
)

__all__ = [
    "FAULTS",
    "SITES",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "active",
    "check",
    "install",
    "uninstall",
]
