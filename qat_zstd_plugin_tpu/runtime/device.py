"""Process-level device state — parity with the reference's lifecycle API.

Mirrors QZSTD_startQatDevice / QZSTD_stopQatDevice semantics
(src/qatseqprod.c:948-964, 428-449): idempotent tri-state init under a
process lock, a degraded STARTED state when no accelerator is usable (CPU
fallback still works, like the reference's libzstd soft-fallback), and
re-entrant restart. The instance pool + spinlocks (src/qatseqprod.c:905-933)
have no analog: XLA serializes per-device streams, so "grabbing an
instance" is just dispatching to a device.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field


class Status(enum.Enum):
    """Tri-state init result (QZSTD_Status_e, src/qatseqprod.h:57-66)."""
    OK = 0        # accelerator up and usable
    STARTED = 1   # runtime up but no GPU: CPU path only (degraded)
    FAIL = 2      # not started


@dataclass
class _ProcessState:
    status: Status = Status.FAIL
    devices: list = field(default_factory=list)
    platform: str = ""
    lock: threading.Lock = field(default_factory=threading.Lock)
    fail_offload_count: int = 0


_state = _ProcessState()

# Restart attempt cadence after repeated failures, mirroring
# NUM_BLOCK_OF_RETRY_INTERVAL (src/qatseqprod.c:88, 1140-1152).
RETRY_INTERVAL_BLOCKS = 1000


def start_device() -> Status:
    """Initialize the JAX runtime and discover devices (idempotent):
    OK on a GPU, STARTED (CPU-only, degraded) on the CPU, FAIL when JAX
    cannot start or its platform is not one the codec runs on."""
    with _state.lock:
        if _state.status == Status.OK:
            return Status.OK
        import jax

        from . import backend
        try:
            devs = jax.devices()
            platform = backend.platform()
        except RuntimeError:
            _state.status = Status.FAIL
            return _state.status
        _state.devices = devs
        _state.platform = platform
        # CPU only: the runtime is up and the plain-XLA path works, so
        # this is STARTED (degraded), not FAIL.
        _state.status = Status.OK if platform == "gpu" else Status.STARTED
        _state.fail_offload_count = 0
        return _state.status


def stop_device() -> Status:
    """Tear down process state (device buffers are owned by JAX; nothing to
    drain — the poll-drain teardown of src/qatseqprod.c:350-352 has no
    analog under XLA's ownership model)."""
    with _state.lock:
        _state.status = Status.FAIL
        _state.devices = []
        _state.fail_offload_count = 0
        return Status.OK


def status() -> Status:
    return _state.status


def devices() -> list:
    return list(_state.devices)


def note_offload_failure() -> bool:
    """Count a failed block offload; True if a restart should be attempted
    (every RETRY_INTERVAL_BLOCKS failures, like failOffloadCnt)."""
    with _state.lock:
        _state.fail_offload_count += 1
        return _state.fail_offload_count % RETRY_INTERVAL_BLOCKS == 0
