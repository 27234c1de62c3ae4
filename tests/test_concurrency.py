"""In-process concurrent-use stress (VERDICT r2 item 5).

The reference's benchmark drives the shared instance pool from up to 2048
threads with phase barriers (test/benchmark.c:439-441, 514-520) — a
thread-safety proof for its concurrency layer. These tests exercise the
analogous shared state here from many threads in one process, with
barriers lining every thread up on the same phase:

* distinct TpuCodec instances compressing concurrently (per-CCtx analog);
* ONE shared TpuCodec hammered from all threads (shared session state:
  jit caches, BlockStats, the native runtime's thread pool);
* concurrent first-jit on a fresh shape (jit-cache population race);
* the device lifecycle singleton under concurrent start/stop;
* the libzstd producer registration path from multiple threads.

Every frame is decoded bit-exactly through stock libzstd; stats totals
must balance to the work submitted. The suite was validated against a
deliberately-introduced race (BlockStats.record without its lock loses
updates and fails the accounting assertion below).
"""

import threading
from pathlib import Path

import numpy as np
import pytest

import qat_zstd_plugin_tpu as qz
from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.runtime import device
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="stock libzstd oracle unavailable")

NTHREADS = 8


def _mkdata(seed: int, n: int = 300_000) -> bytes:
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 256, 128, np.uint8).tobytes()
    return (open(REPO / "SURVEY.md", "rb").read()
            + rec * 800 + rng.integers(0, 64, n, np.uint8)
            .astype(np.uint8).tobytes())[:n]


def _run_threads(fn, nthreads=NTHREADS):
    """Barrier-start nthreads running fn(tid); re-raise the first error."""
    barrier = threading.Barrier(nthreads)
    errors: list[BaseException] = []

    def wrap(tid):
        try:
            barrier.wait(timeout=60)
            fn(tid)
        except BaseException as e:  # noqa: BLE001 — reported to the test
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(t,))
               for t in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "thread deadlocked"
    if errors:
        raise errors[0]


def test_distinct_codecs_concurrent():
    datas = [_mkdata(s) for s in range(NTHREADS)]
    frames: list[bytes | None] = [None] * NTHREADS

    def work(tid):
        codec = TpuCodec(level=1 + (tid % 3), use_device=False)
        frames[tid] = codec.compress(datas[tid])

    _run_threads(work)
    for d, f in zip(datas, frames):
        assert oracle.decompress(f, len(d)) == d


def test_shared_codec_concurrent():
    """One codec, all threads: shared BlockStats, shared jit/native
    state. Results must stay per-call correct and stats must balance."""
    codec = TpuCodec(level=1, use_device=False)
    datas = [_mkdata(100 + s) for s in range(NTHREADS)]
    frames: list[bytes | None] = [None] * NTHREADS
    ROUNDS = 3

    def work(tid):
        for _ in range(ROUNDS):
            frames[tid] = codec.compress(datas[tid])

    _run_threads(work)
    for d, f in zip(datas, frames):
        assert oracle.decompress(f, len(d)) == d
    total_in = sum(len(d) for d in datas) * ROUNDS
    assert codec.stats.input_bytes == total_in, \
        "BlockStats lost concurrent updates"


def test_concurrent_first_jit():
    """All threads hit an unseen (level, shape) jit key simultaneously;
    the compile must happen exactly-once-or-idempotently, never corrupt."""
    datas = [_mkdata(200 + s, 150_000) for s in range(NTHREADS)]
    frames: list[bytes | None] = [None] * NTHREADS

    def work(tid):
        codec = TpuCodec(level=1, batch=2, block_size=65536,
                         max_seq=8192)
        frames[tid] = codec.compress(datas[tid])

    _run_threads(work)
    for d, f in zip(datas, frames):
        assert oracle.decompress(f, len(d)) == d


def test_device_lifecycle_concurrent():
    """start/stop singleton hammering: the tri-state must never wedge and
    a start-after-stop must still work (C2 invariants under threads)."""
    stop_barrier = threading.Barrier(NTHREADS)

    def work(tid):
        for _ in range(5):
            device.start_device()
        stop_barrier.wait(timeout=60)
        if tid == 0:
            device.stop_device()
        device.start_device()

    _run_threads(work)
    assert device.start_device() in (device.Status.OK,
                                     device.Status.STARTED)
    data = _mkdata(999)
    f = TpuCodec(level=1, use_device=False).compress(data)
    assert oracle.decompress(f, len(data)) == data


def test_producer_via_libzstd_concurrent():
    """The deployment shape (ZSTD_registerSequenceProducer via ctypes)
    from many threads at once — each thread owns its CCtx/state, but the
    native runtime and ctypes callback trampoline are shared."""
    datas = [_mkdata(300 + s, 200_000) for s in range(4)]
    frames: list[bytes | None] = [None] * 4

    def work(tid):
        frames[tid] = qz.compress_via_libzstd(datas[tid], level=1)

    _run_threads(work, nthreads=4)
    for d, f in zip(datas, frames):
        assert oracle.decompress(f, len(d)) == d
