"""Device match-pipeline tests (run on the CPU backend: the plain-XLA
reference of the program the GPU runs).

The contract under test mirrors the reference's producer contract
(src/qatseqprod.h:85-95): any sequence set is acceptable iff it is
frame-legal and byte-faithful; quality is measured separately as ratio.
"""

from pathlib import Path

import numpy as np
import pytest

from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.format.frame import BlockSequences
from qat_zstd_plugin_tpu.golden import matcher
from qat_zstd_plugin_tpu.runtime import tpu_codec
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec, \
    coalesce_sequences

REPO = Path(__file__).resolve().parents[1]

N = 4096


def _blocks(seed=0):
    rng = np.random.default_rng(seed)
    words = [b"the ", b"data ", b"zstd gpu ", b"frame ", b"block entropy "]
    text = b""
    while len(text) < N:
        text += words[int(rng.integers(0, 5))]
    b0 = np.frombuffer(text[:N], np.uint8)
    b1 = np.concatenate([np.full(1000, 65, np.uint8),
                         rng.integers(0, 4, 2000, np.uint8).astype(np.uint8),
                         np.full(N - 3000, 66, np.uint8)])
    b2 = rng.integers(0, 256, N).astype(np.uint8)
    short = np.concatenate([b0[:3000], np.zeros(N - 3000, np.uint8)])
    return [b0, b1, b2, short], [N, N, N, 3000]


def _run_pipeline(blocks, lengths, **kw):
    import jax.numpy as jnp
    from qat_zstd_plugin_tpu.ops import match_pipeline as mp
    out = mp.find_matches_batch(
        jnp.asarray(np.stack(blocks)),
        jnp.asarray(np.array(lengths, np.int32)), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def test_pipeline_sequences_are_valid():
    blocks, lengths = _blocks()
    out = _run_pipeline(blocks, lengths, neighbors=4, max_seq=1024)
    for i, (blk, ln) in enumerate(zip(blocks, lengths)):
        seqs = tpu_codec.device_outputs_to_sequences(out, i)
        assert seqs is not None
        matcher.validate_sequences(blk[:ln], seqs)


def test_pipeline_random_data_produces_no_matches():
    rng = np.random.default_rng(1)
    blk = rng.integers(0, 256, N).astype(np.uint8)
    out = _run_pipeline([blk], [N], neighbors=2, max_seq=512)
    assert out["nseq"][0] == 0
    assert out["last_literals"][0] == N


def test_pipeline_overflow_flags():
    # Alternating 4-byte pattern generates a match at nearly every parse
    # step -> tiny max_seq must overflow, not truncate silently.
    blk = np.tile(np.frombuffer(b"abcdefgh", np.uint8), N // 8)
    out = _run_pipeline([blk], [N], neighbors=2, max_seq=8)
    assert bool(out["overflow"][0])
    assert tpu_codec.device_outputs_to_sequences(out, 0) is None


def test_coalesce_merges_capped_chains():
    lit = np.array([5, 0, 0, 2, 0])
    off = np.array([7, 7, 7, 9, 7])
    ml = np.array([16, 16, 16, 16, 4])
    l2, o2, m2 = coalesce_sequences(lit, off, ml)
    assert l2.tolist() == [5, 2, 0]
    assert o2.tolist() == [7, 9, 7]
    assert m2.tolist() == [48, 16, 4]


def test_long_repeat_recovers_via_coalesce():
    # 64-byte period repeated: capped 16-byte matches must chain at the
    # same offset and coalesce into long matches.
    rng = np.random.default_rng(3)
    period = rng.integers(0, 256, 64, np.uint8).tobytes()
    blk = np.frombuffer((period * (N // 64 + 1))[:N], np.uint8)
    out = _run_pipeline([blk], [N], neighbors=4, max_seq=2048)
    seqs = tpu_codec.device_outputs_to_sequences(out, 0)
    matcher.validate_sequences(blk, seqs)
    assert seqs.nseq <= 4  # one long match after coalescing (+ slack)
    assert int(seqs.match_lengths.max()) > 3000


@pytest.mark.skipif(not oracle.available(), reason="oracle missing")
@pytest.mark.parametrize("level", [1, 9])
def test_tpu_codec_end_to_end(level):
    data = open(REPO / "SURVEY.md", "rb").read()
    c = TpuCodec(level=level, batch=2, block_size=16384, max_seq=4096)
    f = c.compress(data, validate=True)
    assert oracle.roundtrip_ok(f, data)
    assert len(f) < len(data) * 0.55


@pytest.mark.skipif(not oracle.available(), reason="oracle missing")
def test_tpu_codec_tail_block_fallback():
    # Non-multiple length: tail block takes the CPU fallback path.
    rng = np.random.default_rng(7)
    base = rng.integers(0, 8, 40000, np.uint8).astype(np.uint8)
    data = base.tobytes()
    c = TpuCodec(level=3, batch=2, block_size=16384, max_seq=4096)
    f = c.compress(data)
    assert oracle.roundtrip_ok(f, data)


def test_deep_selector_routing(monkeypatch):
    """The r5 deep-level parse selector routes by literal share and
    window position (runtime/tpu_codec.py finish_block_host): share
    below the level bar (0.05 at L5-6 / 0.13 at L7+) or a context-
    starved first/second block below share 0.40 -> hinted chain parse;
    everything else -> extend + fill_gaps walk."""
    from qat_zstd_plugin_tpu import native
    if not native.available():
        pytest.skip("native runtime required")
    calls = []
    real_hinted = native.find_sequences_hinted
    real_extend = native.extend_sequences

    def spy_hinted(*a, **k):
        calls.append("hint")
        return real_hinted(*a, **k)

    def spy_extend(*a, **k):
        calls.append("walk")
        return real_extend(*a, **k)

    monkeypatch.setattr(native, "find_sequences_hinted", spy_hinted)
    monkeypatch.setattr(native, "extend_sequences", spy_extend)

    bs = tpu_codec.TpuCodec(level=9, batch=4, use_device=False).block_size
    rng = np.random.default_rng(5)
    # Structured block: long stride-8 records -> matchy claims with a
    # moderate literal share once extended.
    rec = rng.integers(0, 256, 8, np.uint8)
    structured = np.tile(rec, bs // 8)

    def claims(lit_run, match_len, off, nblk):
        nseq = nblk // (lit_run + match_len)
        ll = np.full(nseq, lit_run, np.int64)
        ml = np.full(nseq, match_len, np.int64)
        of = np.full(nseq, off, np.int64)
        last = nblk - int(ll.sum() + ml.sum())
        return BlockSequences(ll, of, ml, last)

    codec = TpuCodec(level=9, batch=4, use_device=False)
    buf = np.tile(structured, 40)[: bs * 33]

    # Block 32 (full window behind it), share ~0.006 < 0.13 -> hinted.
    calls.clear()
    codec.finish_block_host(buf, 32, claims(1, 159, 8, bs))
    assert calls and calls[0] == "hint", calls

    # Block 32, share ~0.5 -> walk.
    calls.clear()
    codec.finish_block_host(buf, 32, claims(80, 80, 8, bs))
    assert calls and calls[0] == "walk", calls

    # Block 0 (context-starved), share ~0.31 < 0.40 -> hinted.
    calls.clear()
    codec.finish_block_host(buf, 0, claims(50, 110, 8, bs))
    assert calls and calls[0] == "hint", calls

    # Block 0, share ~0.5 (>= 0.40) -> walk even when context-starved.
    calls.clear()
    codec.finish_block_host(buf, 0, claims(80, 80, 8, bs))
    assert calls and calls[0] == "walk", calls

    # L5: bar is 0.05, so a 0.31-share mid-frame block walks.
    codec5 = TpuCodec(level=5, batch=4, use_device=False)
    calls.clear()
    codec5.finish_block_host(buf, 32, claims(50, 110, 8, bs))
    assert calls and calls[0] == "walk", calls
