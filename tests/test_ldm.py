"""Long-distance matching + dense claims (round 3).

Covers the three coupled features of the device ratio work:
  - slot contract v2 (subslot << 30 | raw byte offset, sentinel words)
  - sliding-span LDM candidates competing in the claim set
  - dense claims (host extension walk as the parse) and the extension
    repcode probe that makes them pay.

Reference bars: stock zstd's streaming window (the matcher the QAT
plugin inherits from libzstd, src/qatseqprod.c:1123) and zstd's own
--long mode semantics.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from qat_zstd_plugin_tpu import native, oracle
from qat_zstd_plugin_tpu.ops import glue_kernels as gk
from qat_zstd_plugin_tpu.ops import match_pipeline as mp
from qat_zstd_plugin_tpu.runtime.tpu_codec import (TPU_LEVEL_TABLE,
                                                   TpuCodec)

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="hash path needs native runtime")


def _textish(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, n, np.uint8) % 96 + 32).astype(np.uint8)


def _slots(blocks, lengths, **kw):
    import jax.numpy as jnp
    slots = mp.find_matches_positions(jnp.asarray(blocks),
                                      jnp.asarray(lengths), **kw)
    return mp.unpack_segments(np.asarray(slots), blocks.shape[0],
                              kw.get("window", 32768))


def test_ldm_finds_cross_block_offset():
    """Misaligned cross-block repeat (distance not a multiple of the
    sample stride): minimizer sampling must discover it slot-quantized,
    and the extension slide probe must resolve the exact distance."""
    from qat_zstd_plugin_tpu.runtime.tpu_codec import \
        device_positions_to_claims
    N = 1 << 17
    B = 4
    blocks = _textish((B, N))
    # block 2 repeats a 40K slice of block 0: true distance 252144,
    # which is 16 mod 32 — invisible to pure grid sampling.
    D = 2 * N + 10000 - 20000
    assert D % 32 != 0
    blocks[2, 10000:50000] = blocks[0, 20000:60000]
    per = _slots(blocks, np.full(B, N, np.int32), widths=(6,), ldm=4)
    pos2, off2 = per[2]
    near = np.abs(off2 - D) <= 32
    assert near.sum() > 50, (near.sum(), np.unique(off2[off2 > 32768]))
    assert ((pos2[near] >= 10000) & (pos2[near] < 50064)).all()
    # host extension (with block 0+1 as window context) resolves exact D
    ctx = 2 * N
    cblk = np.concatenate([blocks[0], blocks[1], blocks[2]])
    seqs = device_positions_to_claims(pos2, off2, N)
    ll, of, ml, lastlit = native.extend_sequences(
        cblk, seqs.lit_lengths, seqs.offsets, seqs.match_lengths,
        seqs.last_literals, ctx_len=ctx)
    exact = of == D
    assert ml[exact].sum() > 35000, (ml[exact].sum(), np.unique(of[of > 32768]))


def test_ldm_offsets_respect_window_cap():
    N = 1 << 17
    B = 8
    blocks = _textish((B, N))
    blocks[7] = blocks[0]  # distance 7 blocks = 917504 > 512K cap
    per = _slots(blocks, np.full(B, N, np.int32), widths=(6,), ldm=8,
                 ldm_max_off=1 << 19)
    for pos, off in per:
        assert (off <= (1 << 19)).all()


def test_contract_v2_positions_and_offsets_roundtrip():
    """Slot words decode to exact (pos, off) pairs: feed a handcrafted
    chosen/moff pair through compact_slots + unpack_segments."""
    import jax.numpy as jnp
    B, N, w = 2, 8192, 8192
    chosen = np.zeros((B, N), np.int32)
    moff = np.zeros((B, N), np.int32)
    claims = [(0, 5, 3), (0, 100, 99), (0, 8191, 70000),
              (1, 4, 1), (1, 4000, (1 << 30) - 2)]
    for b, p, o in claims:
        chosen[b, p] = 1
        moff[b, p] = o
    slots = gk.compact_slots(jnp.asarray(chosen), jnp.asarray(moff), w)
    per = mp.unpack_segments(np.asarray(slots), B, w)
    got = [(b, int(p), int(o)) for b in range(B)
           for p, o in zip(*per[b])]
    assert got == claims


def _mixed_corpus(n, seed=0):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_mod", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench.make_corpus(n, seed=seed)


def test_content_ldm_gated_off_without_native_verifier(monkeypatch):
    """LDM claims are minimizer estimates; only the native extension
    walk verifies them against real bytes. Without the native runtime
    the content path must not emit them (review finding: they would be
    encoded verbatim — silent corruption on dup-heavy input)."""
    from qat_zstd_plugin_tpu import native as nat
    import numpy as np
    monkeypatch.setattr(nat, "available", lambda: False)
    rng = np.random.default_rng(0)
    buf = rng.integers(0, 256, 400000).astype(np.uint8)
    buf[250000:251024] = buf[150000:151024]  # offset 100000, not %32
    data = buf.tobytes()
    c = TpuCodec(level=5, batch=8, use_device=True)
    f = c.compress(data)
    assert oracle.roundtrip_ok(f, data)


def test_dense_claims_beat_parse_claims_on_ratio():
    data = _mixed_corpus(2 << 20, seed=3)
    base = TPU_LEVEL_TABLE[1]
    ratios = {}
    for dense in (False, True):
        # sync=False: this test compares the device parse against dense
        # claims at full anchor resolution (sync implies dense).
        p = dataclasses.replace(base, dense=dense, sync=False,
                                psegs=1 if dense else 4)
        TPU_LEVEL_TABLE[1] = p
        try:
            c = TpuCodec(level=1, batch=8, use_device=True)
            f = c.compress(data)
            assert oracle.roundtrip_ok(f, data)
            assert c.fallback_batches == 0
            ratios[dense] = len(f) / len(data)
        finally:
            TPU_LEVEL_TABLE[1] = base
    assert ratios[True] < ratios[False], ratios


def test_ldm_dup_corpus_beats_stock_l1():
    """Cross-block duplication: the device path must now beat stock L1
    outright (stock's 512K window sees the dup; ours + LDM sees it with
    a stronger matcher)."""
    base = _textish(512 << 10, seed=4)
    rng = np.random.default_rng(5)
    parts = [base.copy() for _ in range(4)]
    for part in parts[1:]:
        for _ in range(40):
            q = int(rng.integers(0, len(part) - 8))
            part[q:q + 4] = rng.integers(0, 256, 4, np.uint8)
    dup = b"".join(p.tobytes() for p in parts)
    c = TpuCodec(level=1, batch=16, use_device=True)
    f = c.compress(dup)
    assert oracle.roundtrip_ok(f, dup)
    ours = len(f) / len(dup)
    stock = len(oracle.compress(dup, 1)) / len(dup)
    assert ours < 0.6 * stock, (ours, stock)


def test_extension_rep_probe_rescues_and_prefers_reps():
    """A claim whose own offset is invalid must be rescued by the rep
    probe when the previous offset still matches."""
    rng = np.random.default_rng(6)
    blk = (rng.integers(0, 256, 4096, np.uint8) % 96 + 32).astype(np.uint8)
    blk[1000:1400] = blk[0:400]       # true match at offset 1000
    blk[1200] ^= 0xFF                  # edit breaks it at 1200
    # claims: [1000, len 200 @1000], [1201, len 199 @ bogus 3_000_000]
    lit = np.array([1000, 1], np.int64)
    off = np.array([1000, 3_000_000], np.int64)
    ml = np.array([200, 199], np.int64)
    ll, of, m2, lastlit = native.extend_sequences(
        blk, lit, off, ml, int(4096 - 1400), ctx_len=0)
    assert 1000 in of[1:], of  # resumed via rep, not the bogus offset
    # spans must still tile the block
    assert ll.sum() + m2.sum() + lastlit == 4096


def test_dense_device_path_all_fast_levels_bitexact():
    data = bytes(_textish(1 << 20, seed=7))
    for lvl in (1, 2, 3, 4):
        c = TpuCodec(level=lvl, batch=8, use_device=True)
        f = c.compress(data)
        assert oracle.roundtrip_ok(f, data), lvl
        assert c.fallback_batches == 0
