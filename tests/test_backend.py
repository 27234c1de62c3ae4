"""runtime/backend.py: the one backend decision, the compile-cache rule,
and the device status they feed (start_device)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from qat_zstd_plugin_tpu.runtime import backend, device
from qat_zstd_plugin_tpu.utils import config

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def platform_is(monkeypatch):
    def set_platform(name):
        monkeypatch.setattr(backend, "_device_platform", lambda: name)
    return set_platform


def test_cpu_takes_the_reference(platform_is):
    platform_is("cpu")
    assert backend.platform() == "cpu"
    assert backend.compiled() is False


def test_gpu_takes_the_compiled_route(platform_is):
    platform_is("gpu")
    assert backend.platform() == "gpu"
    assert backend.compiled() is True


def test_other_platform_is_an_error(platform_is):
    platform_is("tpu")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.compiled()


@pytest.fixture
def fresh_device_state(monkeypatch):
    monkeypatch.setattr(device, "_state", device._ProcessState())
    yield
    device.stop_device()


@pytest.mark.parametrize("name,status", [
    ("gpu", device.Status.OK), ("cpu", device.Status.STARTED),
    ("tpu", device.Status.FAIL)])
def test_start_device_status(platform_is, fresh_device_state, name,
                             status):
    platform_is(name)
    assert device.start_device() == status


def test_force_backend_accepts_only_device_or_cpu(monkeypatch):
    from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
    monkeypatch.setenv("QZ_FORCE_BACKEND", "tpu")
    config.set(None)
    try:
        with pytest.raises(ValueError, match="QZ_FORCE_BACKEND"):
            TpuCodec(level=1)
    finally:
        config.set(None)


def _cache_dir_after_first_use(env_value):
    """Fresh interpreter: first device use, then report the cache dir."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax\n"
            "from qat_zstd_plugin_tpu.runtime import backend\n"
            "assert jax.config.jax_compilation_cache_dir in (None, '', "
            "backend.os.environ.get('JAX_COMPILATION_CACHE_DIR'))\n"
            "backend.platform()\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_checkout():
    assert _cache_dir_after_first_use(None) == str(REPO / ".jax_cache")


def test_compile_cache_env_wins(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir_after_first_use(want) == want
