"""Test config: JAX on a virtual 8-device CPU mesh unless told otherwise.

Sharding correctness is validated on virtual CPU devices (the multi-device
path also runs on cards through chip_smoke.py --four). Tests that need a
GPU take the `gpu` fixture; run them on a card with
`JAX_PLATFORMS=cuda python -m pytest tests -m gpu`.
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

# Only compiles slower than this are worth a persistent-cache entry (the
# cache directory itself is runtime/backend.py's rule).
jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _repo)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
    return jax.devices()[0]
