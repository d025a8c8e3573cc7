"""Test configuration: run everything on an 8-device virtual CPU mesh.

Sharding/collective tests exercise the multi-chip code paths without GPU
hardware; numerical tests get deterministic CPU float behavior.

``jax.config.update("jax_platforms", ...)`` works at any point before backend
initialization, so it holds even when jax was imported before this file.
"""

import os

# Read at CPU-client creation (no backend is initialized yet during conftest
# import, so this still takes effect).
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def _gpu_run(config) -> bool:
    """``-m gpu`` selects the tests that run on the card (see pyproject)."""
    return config.getoption("markexpr") == "gpu"


def pytest_configure(config):
    if not _gpu_run(config):
        jax.config.update("jax_platforms", "cpu")


def pytest_sessionstart(session):
    if _gpu_run(session.config):
        return
    assert jax.default_backend() == "cpu", (
        "tests must run on CPU; backend selection failed")
    assert len(jax.devices()) >= 8, (
        "xla_force_host_platform_device_count did not take effect")


@pytest.fixture
def gpu_device():
    """The first device if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest tests -m gpu` on the "
                    "card")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def blocking_scenarios(tot_time, S, n_obs=2):
    """Tie-free obstacle scenarios (see scenarios.blocking_scenarios):
    every candidate incurs a distinct non-zero obstacle cost, so argsort has
    no exact ties — enabling tight (rtol<=1e-3) sharded-vs-single
    equivalence checks instead of the 0.3 bands tie-flipping used to force."""
    from mpc_mmd_tpu.scenarios import blocking_scenarios as scenarios
    return scenarios(tot_time, S, n_obs)
