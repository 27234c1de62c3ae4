"""Auxiliary subsystem tests: logging, config, recovery, profiling,
distributed gather, packaging surface."""

from pathlib import Path

import numpy as np
import pytest

import qat_zstd_plugin_tpu as qz
from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.runtime import device
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
from qat_zstd_plugin_tpu.utils import config as qzconfig
from qat_zstd_plugin_tpu.utils import logging as qzlog
from qat_zstd_plugin_tpu.utils.profiling import BlockStats, Timer

REPO = Path(__file__).resolve().parents[1]


def test_logging_levels(capsys):
    qzlog.set_level(qzlog.LEVEL_EVENT)
    qzlog.error("boom %d", 7)
    qzlog.event("up")
    qzlog.debug("hidden")
    err = capsys.readouterr().err
    assert "boom 7" in err and "up" in err and "hidden" not in err
    qzlog.set_level(0)


def test_config_env(monkeypatch):
    monkeypatch.setenv("QZ_BATCH", "4")
    monkeypatch.setenv("QZ_CHECKSUM", "0")
    cfg = qzconfig.Config.from_env()
    assert cfg.batch == 4 and cfg.checksum is False


def test_config_drives_codec_defaults(monkeypatch):
    """QZ_* env knobs must actually change codec behavior (the config
    surface is live, not decorative)."""
    monkeypatch.setenv("QZ_BATCH", "3")
    monkeypatch.setenv("QZ_BLOCK_SIZE", "16384")
    monkeypatch.setenv("QZ_MAX_SEQ", "2048")
    monkeypatch.setenv("QZ_CHECKSUM", "0")
    monkeypatch.setenv("QZ_FORCE_BACKEND", "cpu")
    qzconfig.set(qzconfig.Config.from_env())
    try:
        c = TpuCodec(level=1)
        assert c.batch == 3
        assert c.block_size == 16384
        assert c.max_seq == 2048
        assert c.use_device is False
        data = open(REPO / "SURVEY.md", "rb").read()[:40000]
        f = c.compress(data)
        # QZ_CHECKSUM=0: frame header must not carry a content checksum.
        assert not (f[4] & 0x04)
        assert oracle.roundtrip_ok(f, data)
        # Explicit constructor args still win over config.
        c2 = TpuCodec(level=1, batch=9, block_size=32768)
        assert c2.batch == 9 and c2.block_size == 32768
    finally:
        qzconfig.set(None)


def test_codec_feeds_block_stats():
    data = open(REPO / "SURVEY.md", "rb").read()
    c = TpuCodec(level=1, batch=2, block_size=16384, use_device=False)
    c.compress(data)
    s = c.stats.summary()
    assert s["blocks"] == -(-len(data) // 16384)
    assert 0 < s["ratio"] < 1.0
    assert s["throughput_mbs"] > 0


def test_device_lifecycle_parity():
    st = qz.start_device()
    assert st in (qz.Status.OK, qz.Status.STARTED)
    assert qz.start_device() == st  # idempotent (src/qatseqprod.c:948-964)
    assert device.status() == st
    assert qz.stop_device() == qz.Status.OK
    assert device.status() == qz.Status.FAIL
    qz.start_device()


def test_failure_counter_retry_interval():
    device.start_device()
    hits = sum(device.note_offload_failure()
               for _ in range(2 * device.RETRY_INTERVAL_BLOCKS))
    assert hits == 2  # every RETRY_INTERVAL_BLOCKS failures


def test_device_error_falls_back_to_cpu(monkeypatch):
    """A broken device pipeline must still produce a valid frame
    (producer-error -> fallback semantics)."""
    data = open(REPO / "SURVEY.md", "rb").read()
    c = TpuCodec(level=1, batch=2, block_size=16384, use_device=True)

    def boom(*a, **k):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(c, "submit_batch", boom)
    f = c.compress(data)
    assert oracle.roundtrip_ok(f, data)

    c2 = TpuCodec(level=1, batch=2, block_size=16384, use_device=True)
    monkeypatch.setattr(c2, "collect_batch", boom)
    f2 = c2.compress(data)
    assert oracle.roundtrip_ok(f2, data)


def test_block_stats():
    s = BlockStats()
    with Timer() as t:
        pass
    s.record(1000, 400, max(t.elapsed, 1e-6))
    s.record(1000, None, 1e-3, fallback=True)
    out = s.summary()
    assert out["blocks"] == 2
    assert out["fallback_blocks"] == 1
    assert out["raw_blocks"] == 1
    assert 0 < out["ratio"] <= 1.4


def test_distributed_gather_ordered():
    import jax
    from qat_zstd_plugin_tpu.parallel import distributed, mesh as pmesh
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("need 8 virtual devices")
    mesh = pmesh.make_mesh(devs[:8])
    rng = np.random.default_rng(0)
    bodies = [rng.integers(0, 256, int(rng.integers(1, 200)),
                           np.uint8).tobytes() for _ in range(16)]
    padded, sizes = distributed.pad_blocks(bodies, 256)
    got = distributed.gather_compressed(mesh, padded, sizes)
    assert got == bodies  # exact bytes, frame order


def test_sequence_producer_window_guard():
    # Window floor parity: reject windows below min(srcSize, 32K)
    # (src/qatseqprod.c:1123-1129).
    st = qz.create_seqprod_state(level=1)
    big = b"x" * 65536
    assert qz.sequence_producer(st, big, window_size=16 * 1024) \
        is qz.SEQUENCE_PRODUCER_ERROR
    ok = qz.sequence_producer(st, big, window_size=64 * 1024)
    assert ok is not qz.SEQUENCE_PRODUCER_ERROR
    qz.free_seqprod_state(st)
