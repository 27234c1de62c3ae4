"""Syncmer speed-point tests (glue_kernels.hash_keys_winmin_sync +
compact_slots_sync — the L1 pipeline).

The property that justifies pair sampling: anchor selection is
CONTENT-determined (the pair member with the smaller 8-byte-gram hash),
so two copies of the same bytes select the same anchors regardless of
where the pair grid falls — repeats at ODD offsets stay discoverable.
Fixed-grid stride-2 sampling fails exactly that (even anchors can only
see even offsets; measured 1.25x stock ratio, rejected in round 3).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.ops import match_pipeline as mp
from qat_zstd_plugin_tpu.runtime.tpu_codec import TPU_LEVEL_TABLE, TpuCodec

REPO = Path(__file__).resolve().parents[1]


def _claims(blocks_np, sync=True, ldm=0, window=32768):
    import jax.numpy as jnp
    B, N = blocks_np.shape
    out = mp.find_matches_positions(
        jnp.asarray(blocks_np), jnp.full((B,), N, np.int32),
        widths=(6,), window=window, ldm=ldm, dense=True, sync=sync)
    per_block = mp.unpack_segments(np.asarray(out), B, window)
    pos = np.concatenate([p for p, _ in per_block])
    off = np.concatenate([o for _, o in per_block])
    return pos, off


def test_sync_finds_odd_offset_repeat():
    rng = np.random.default_rng(0)
    N = 32768
    block = rng.integers(0, 256, N, np.uint8)
    d = 4097  # odd distance: invisible to fixed-grid parity sampling
    block[8000 + d:8000 + d + 512] = block[8000:8000 + 512]
    pos, off = _claims(block[None, :])
    hits = off[np.abs(off - d) <= 1]  # pair jitter: anchor may sit +-1
    assert len(hits) >= 8, (len(hits), sorted(set(off.tolist()))[:20])


def test_sync_finds_even_offset_repeat():
    rng = np.random.default_rng(1)
    N = 32768
    block = rng.integers(0, 256, N, np.uint8)
    d = 4096
    block[9000 + d:9000 + d + 512] = block[9000:9000 + 512]
    pos, off = _claims(block[None, :])
    assert (np.abs(off - d) <= 1).sum() >= 8


def test_sync_selection_survives_odd_shift():
    """The same content shifted by ONE byte (pair grids maximally
    misaligned) must still co-select a healthy fraction of anchors.

    Selection is content-determined GIVEN the grid; under an odd shift
    the two grids pair each content hash with different neighbors.
    Rules analyzed (iid hashes, odd-shift co-selection per position):
    fixed-grid positional sampling co-selects NOTHING (offsets of odd
    parity were invisible — the round-3 stride-2 failure); pair-argmin
    (pick the smaller h8 of the pair) co-selects positions beating BOTH
    neighbors = exactly 1/3, and 1/3 is the ceiling for every window-2
    rule (any one-per-pair rule reduces to a lane indicator g, and
    co-selection = P(g(j-1)=1, g(j)=0), maximized by near-alternating
    g); ARGMIN PARITY over a forward w-lane window (the shipped rule,
    w=4) rides a sliding argmin whose relative parity alternates while
    the argmin persists: 0.40 at w=4, 0.444 at w=8, -> 1/2 as w grows.
    Even offsets co-select at the 1/2 density ceiling under any of
    these. The w choice is EMPIRICAL, not the co-selection maximum:
    measured L1 frames on the gate corpus are 1.0175x stock at w=2
    (= pair-argmin exactly), 1.0160x at w=4 (and smaller on every probe
    corpus, text -2.1%), 1.0209x at w=8 — past w=4 boundary desync
    outweighs co-selection. On this planted-repeat probe the kernel's
    odd-shift claim overlap rose 0.194 -> ~0.3 with the shipped rule."""
    rng = np.random.default_rng(2)
    N = 32768
    content = rng.integers(0, 256, 2048, np.uint8)
    a = np.zeros((1, N), np.uint8)
    b = np.zeros((1, N), np.uint8)
    a[0, 1024:1024 + 2048] = content
    b[0, 1025:1025 + 2048] = content
    # Plant an identical self-repeat inside the content so both runs
    # produce claims at the same content positions.
    content2 = content.copy()
    content2[1024:1536] = content2[0:512]
    a[0, 1024:1024 + 2048] = content2
    b[0, 1025:1025 + 2048] = content2
    pa, oa = _claims(a)
    pb, ob = _claims(b)
    ca = {(int(p) - 1024, int(o)) for p, o in zip(pa, oa)
          if 1024 <= p < 1024 + 2048}
    cb = {(int(p) - 1025, int(o)) for p, o in zip(pb, ob)
          if 1025 <= p < 1025 + 2048}
    # Expected overlap ~1/3 of the union's smaller side (see docstring);
    # grid-positional sampling would overlap ~0 here. Observed ~0.19 of
    # the union on this corpus.
    inter = len(ca & cb)
    union = len(ca | cb)
    assert union > 50 and inter / union > 0.10, (inter, union)


def test_sync_claim_contract_sane():
    rng = np.random.default_rng(3)
    N = 65536  # two window segments
    block = (rng.integers(0, 12, N, np.uint8) * 17).astype(np.uint8)
    pos, off = _claims(block[None, :], window=32768)
    assert (off > 0).all()
    assert (pos + 6 <= N).all()
    assert (np.diff(pos) > 0).all()  # slot order == position order
    # Local claims are segment-local by construction: the match source
    # pos - off stays inside the claim's own 32K window segment.
    seg = pos // 32768
    assert (off <= pos - seg * 32768).all()
    assert (off <= 32768).all()


def test_sync_with_ldm_bitexact_roundtrip():
    if not oracle.available():
        pytest.skip("oracle missing")
    rng = np.random.default_rng(4)
    text = open(REPO / "SURVEY.md", "rb").read()
    data = (text * 12)[: 1 << 20] + rng.integers(0, 256, 4096,
                                                 np.uint8).tobytes()
    base = TPU_LEVEL_TABLE[1]
    assert base.sync  # L1 IS the sync point
    c = TpuCodec(level=1, batch=4, use_device=True)
    f = c.compress(data)
    assert c.fallback_batches == 0
    assert oracle.roundtrip_ok(f, data)


def test_sync_ratio_within_envelope_of_dense():
    """The speed point gives up a bounded amount of ratio vs the
    full-resolution dense config (measured ~+2.7% on the mixed corpus)."""
    if not oracle.available():
        pytest.skip("oracle missing")
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_mod", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    data = bench.make_corpus(1 << 20, seed=9)
    base = TPU_LEVEL_TABLE[1]
    ratios = {}
    for sync in (False, True):
        TPU_LEVEL_TABLE[1] = dataclasses.replace(base, sync=sync)
        try:
            c = TpuCodec(level=1, batch=4, use_device=True)
            f = c.compress(data)
            assert oracle.roundtrip_ok(f, data)
            ratios[sync] = len(f) / len(data)
        finally:
            TPU_LEVEL_TABLE[1] = base
    assert ratios[True] < ratios[False] * 1.05, ratios
