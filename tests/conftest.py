import importlib.util
import os

import numpy as np
import pytest

# NOTE: no XLA_FLAGS device-count override here — smoke tests and benches
# must see the real single CPU device. Only launch/dryrun.py forces 512.

# Hermetic tile resolution: a committed BENCH_autotune.json at the repo
# root must not steer plan resolution during tests (assertions compare
# against the analytic heuristic). Tests that exercise the autotune table
# install one explicitly via kernels.autotune.set_default_table or point
# this env var at their own file.
os.environ.setdefault("REPRO_AUTOTUNE_TABLE", os.devnull)

# The container may lack hypothesis; fall back to the deterministic stub so
# the suite still collects and the property tests run (smoke-level sampling).
try:
    import hypothesis  # noqa: F401
except ImportError:
    _spec = importlib.util.spec_from_file_location(
        "_hypothesis_stub",
        os.path.join(os.path.dirname(__file__), "_hypothesis_stub.py"),
    )
    _stub = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_stub)
    _stub.install()


def _on_tpu() -> bool:
    import jax

    return jax.default_backend() == "tpu"


def pytest_addoption(parser):
    parser.addoption(
        "--slow-build",
        action="store_true",
        default=False,
        help="run tests marked slow_build (large out-of-core index builds)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "tpu_kernel(requires_tpu=False): Pallas kernel test. Runs everywhere "
        "via interpret mode by default; requires_tpu=True skips off-TPU "
        "(e.g. Mosaic-lowering or timing assertions).",
    )
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers",
        "chaos: seeded randomized fault-injection test (bounded op count, "
        "deterministic per seed). On by default in tier-1; deselect with "
        "-m 'not chaos' when bisecting unrelated failures.",
    )
    config.addinivalue_line(
        "markers",
        "slow_build: large out-of-core index build; deselected from the "
        "tier-1 run unless --slow-build is passed",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (a repro_torch kernel on the card); the "
        "test skips itself where torch.cuda.is_available() is False",
    )


def pytest_collection_modifyitems(config, items):
    tpu = None
    run_slow_build = config.getoption("--slow-build")
    for item in items:
        if not run_slow_build and item.get_closest_marker("slow_build"):
            item.add_marker(
                pytest.mark.skip(reason="slow_build: pass --slow-build to run")
            )
        marker = item.get_closest_marker("tpu_kernel")
        if marker is None or not marker.kwargs.get("requires_tpu", False):
            continue
        if tpu is None:
            tpu = _on_tpu()
        if not tpu:
            item.add_marker(
                pytest.mark.skip(reason="requires a real TPU backend")
            )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
