"""The one place that decides how the device path runs on this backend.

Every caller asks this module instead of reading ``jax.default_backend()``:

* ``platform()`` — the JAX platform the device path runs on: the platform
  of ``jax_default_device`` when that is set (so a caller can run the
  plain reference on the CPU beside a GPU), else of ``jax.devices()[0]``.
* ``compiled()`` — which formulation each stage uses. ``gpu`` takes the
  compiled route: the plain-XLA stages plus the hand-written Pallas
  kernels compiled for the card (today only the greedy parse,
  ``ops/parse_kernel.py``). ``cpu`` takes the plain-XLA reference for
  every stage: the tests, and ``use_device=True`` on a box without a
  card. Any other platform is an error.
* ``ensure_compile_cache()`` — where the persistent compile cache lives.
  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing here
  touches the setting; otherwise the cache goes to the fixed directory
  ``<checkout>/.jax_cache``. ``platform()`` calls it, so the first device
  use sets it up whichever entry point got there first.
"""

from __future__ import annotations

import os
import threading

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

SUPPORTED = ("gpu", "cpu")

_cache_lock = threading.Lock()
_cache_done = False


def ensure_compile_cache() -> None:
    """Point JAX's persistent compile cache at ``<checkout>/.jax_cache``
    unless ``JAX_COMPILATION_CACHE_DIR`` already names one (idempotent)."""
    global _cache_done
    with _cache_lock:
        if _cache_done:
            return
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        _cache_done = True


def _device_platform() -> str:
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.devices()[0].platform
    return dev if isinstance(dev, str) else dev.platform


def platform() -> str:
    """The platform the device path runs on; raises on an unsupported one."""
    ensure_compile_cache()
    p = _device_platform()
    if p not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: the device path runs on "
            f"{' or '.join(SUPPORTED)}")
    return p


def compiled() -> bool:
    """True on the GPU (hand-written kernels compiled for the card),
    False on the CPU (the plain-XLA reference for every stage)."""
    return platform() == "gpu"
