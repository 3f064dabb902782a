"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests see 1 device
(multi-device behaviour is exercised via subprocesses: test_distributed's
``run_sub`` and the ``multi_device_run`` fixture below).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; the test skips without one")


@pytest.fixture(scope="session")
def multi_device_run():
    """Run a code snippet in a subprocess with N forced host devices
    (``XLA_FLAGS=--xla_force_host_platform_device_count=N``) and return
    its stdout; asserts a zero exit."""

    def run(code: str, devices: int = 8, timeout: int = 420) -> str:
        env = dict(os.environ)
        env["XLA_FLAGS"] = \
            f"--xla_force_host_platform_device_count={devices}"
        env["PYTHONPATH"] = os.path.join(_REPO, "src")
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=timeout, env=env,
        )
        assert out.returncode == 0, \
            f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
        return out.stdout

    return run


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def box443():
    from repro.mesh import box_mesh

    return box_mesh(4, 4, 3)


@pytest.fixture(scope="session")
def grid16():
    from repro.mesh import grid_graph_2d

    return grid_graph_2d(16, 16)
