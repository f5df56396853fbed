"""Every module of ``repro_torch`` imports when it is imported first: no
import cycle leaves a module partly initialized (``kernels/ref.py`` once
imported ``core``, whose package imports ``kernels`` back). One fresh
interpreter imports each module in turn, after dropping the package's
modules from ``sys.modules`` (torch stays loaded), and reports each
outcome."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _modules() -> list[str]:
    out = []
    for d, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        for n in sorted(names):
            if n.endswith(".py"):
                mod = os.path.relpath(os.path.join(d, n), SRC)[:-3].replace(os.sep, ".")
                out.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(out)


MODULES = _modules()

SCRIPT = r"""
import importlib, json, sys, traceback
import torch
out = {}
for mod in sys.argv[1:]:
    for k in [k for k in sys.modules if k == "repro_torch" or k.startswith("repro_torch.")]:
        del sys.modules[k]
    try:
        importlib.import_module(mod)
        out[mod] = None
    except BaseException:
        out[mod] = traceback.format_exc()[-2000:]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def outcomes():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, *MODULES], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_package_has_its_modules():
    assert len(MODULES) >= 80
    assert {"repro_torch.kernels.ref", "repro_torch.launch.mesh",
            "repro_torch.launch.sharding"} <= set(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_first(outcomes, module):
    assert outcomes[module] is None, outcomes[module]


def test_kernels_ref_alone_in_a_fresh_interpreter():
    """The fault as it was met: ``import repro_torch.kernels.ref`` first."""
    proc = subprocess.run([sys.executable, "-c", "import repro_torch.kernels.ref as r; "
                           "print(r.RAGGED_MAX_TILES)"], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=SRC), cwd=ROOT, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "128", proc.stderr[-2000:]
