"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Mirrors the reference's deterministic test setup (it pins
``YAW_NUM_THREADS=1``, /root/reference/tests/conftest.py); here we force
the CPU backend with 8 virtual devices so sharding/mesh code paths are
exercised without a GPU. Pallas kernels run in interpreter mode on the
CPU (``interpret=True``); tests that need the card carry the ``gpu``
marker and skip here through the ``gpu`` fixture.
"""

import os

# must be set before jax initialises a backend. The suite runs on the
# CPU; where the environment offers CUDA, the GPU stays reachable (as a
# second, non-default platform) for the tests marked ``gpu``
os.environ["JAX_PLATFORMS"] = (
    "cpu,cuda" if "cuda" in os.environ.get("JAX_PLATFORMS", "") else "cpu"
)
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from yet_another_wizz_tpu.utils.compile_cache import (  # noqa: E402
    enable_persistent_compile_cache,
)

enable_persistent_compile_cache()
assert jax.default_backend() == "cpu", "tests require the CPU backend"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gpu():
    """The GPU device for tests marked ``gpu``; skips where there is none.

    Decided here, at run time, and never at import or collection: every
    xdist worker must collect the same tests."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU; run on the card (see README)")
    return devices[0]
