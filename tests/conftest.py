"""Test configuration.

The tests run on the CPU: 8 virtual XLA devices stand in for a device
mesh, so sharding and halo-exchange logic runs without a cluster, and
x64 is on so the JAX paths can be diffed against the float64 NumPy
oracle at tight tolerances.  Pallas kernels run through the Pallas
interpreter where a test asks for it (`interpret=True`).

Tests that need a GPU carry the `gpu` marker and take the `gpu`
fixture, which skips them when JAX has no GPU; `python chip_smoke.py`
runs the same checks on the card.

Must run before any jax import, hence module-level env mutation here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# `pytest -m quick`: the fast core subset (oracle/XLA-path numerics,
# solver semantics, config validation) for tight iteration.
QUICK_FILES = {
    "test_oracle.py", "test_kernels.py", "test_cycle.py",
    "test_solver.py", "test_krylov.py", "test_native.py",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if os.path.basename(str(item.fspath)) in QUICK_FILES:
            item.add_marker(pytest.mark.quick)


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided at run time, never at
    collection, so every xdist worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX has {dev.platform!r}")
    return dev
