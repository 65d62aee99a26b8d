"""Shared fixtures + suite plumbing.

* 8 host-platform devices — set before the first jax import so the
  multi-device suite (sharded qdot/qconv parity, ring/pipeline
  collectives, engine wave sharding) exercises a real 8-"core" cluster
  mesh on CPU. An externally-set ``XLA_FLAGS`` wins (the CI parity job
  pins its own device count).
* ``rng`` — the deterministic numpy Generator every test uses.
* ``slow`` marker — long-running tests (CLI subprocess smokes, many-arch
  sweeps) are deselected by default so tier-1 stays fast; run them with
  ``pytest --runslow``.
* ``hypothesis_api()`` — guarded import of hypothesis so collection never
  hard-fails when it is not installed: property tests degrade to
  individually-skipped tests instead of breaking the whole module
  (a stricter variant of ``pytest.importorskip("hypothesis")``, which
  would skip the non-property tests in the same file too).
"""
import os
import sys

if "jax" not in sys.modules:  # too late to matter otherwise
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked @pytest.mark.slow")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test, deselected unless --runslow")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's Hopper kernels); "
        "skips where torch sees none")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow test: pass --runslow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - exercised when hypothesis missing
    HAVE_HYPOTHESIS = False

    def given(*_args, **_kwargs):
        return lambda fn: pytest.mark.skip(
            reason="hypothesis not installed")(fn)

    def settings(*_args, **_kwargs):
        return lambda fn: fn

    class _StrategyStub:
        """Accepts any strategies.* call at collection time."""

        def __getattr__(self, name):
            return lambda *a, **k: None

    st = _StrategyStub()


def hypothesis_api():
    """(given, settings, st) — real hypothesis, or collection-safe stubs
    that skip each property test when hypothesis is not installed."""
    return given, settings, st
