"""Shared fixtures. The main suite runs on the default single CPU device;
multi-device tests spawn subprocesses with XLA_FLAGS so smoke tests and
benches keep seeing 1 device (see launch/dryrun.py for the 512-device path).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    # A deprecation surfacing from our own package is a contract violation,
    # not noise: fail the suite the moment a warning is attributed to a
    # repro.* module.  Third-party deprecations stay warnings — the scoped
    # module pattern keeps jax/numpy churn from breaking the tier-1 gate.
    config.addinivalue_line(
        "filterwarnings", "error::DeprecationWarning:repro")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason elsewhere")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def run_with_devices(script: str, n_devices: int, timeout: int = 600):
    """Run `script` in a fresh python with n host devices; assert success."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    return proc.stdout
