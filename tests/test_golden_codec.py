"""Golden CPU codec tests: matcher validity + oracle round-trips + ratio."""

from pathlib import Path

import numpy as np
import pytest

from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.golden import codec, matcher

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="stock libzstd oracle missing")


def _mixed_corpus(n, seed=0):
    """Synthetic mixed data: text-ish, runs, binary, random."""
    rng = np.random.default_rng(seed)
    parts = []
    words = [b"the ", b"compression ", b"of ", b"data ", b"zstd ", b"gpu ",
             b"block ", b"sequence ", b"frame ", b"entropy "]
    while sum(map(len, parts)) < n:
        kind = rng.integers(0, 4)
        if kind == 0:
            parts.append(b"".join(words[i] for i in
                                  rng.integers(0, len(words), 40)))
        elif kind == 1:
            parts.append(bytes([int(rng.integers(0, 256))]) *
                         int(rng.integers(10, 500)))
        elif kind == 2:
            parts.append(rng.integers(0, 16, 300, np.uint8).tobytes())
        else:
            parts.append(rng.integers(0, 256, 200, np.uint8).tobytes())
    return b"".join(parts)[:n]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matcher_produces_valid_sequences(seed):
    data = np.frombuffer(_mixed_corpus(5000, seed), np.uint8)
    seqs = matcher.find_sequences(data, chain_depth=8, lazy=True)
    matcher.validate_sequences(data, seqs)
    assert seqs.nseq > 0


def test_matcher_degenerate_inputs():
    for data in [b"", b"a", b"ab", b"abc", b"\x00" * 100]:
        buf = np.frombuffer(data, np.uint8)
        seqs = matcher.find_sequences(buf)
        matcher.validate_sequences(buf, seqs)


@pytest.mark.parametrize("level", [1, 2, 5, 9, 12])
def test_roundtrip_levels(level):
    data = _mixed_corpus(20_000, seed=level)
    f = codec.compress(data, level=level, validate=True)
    assert oracle.roundtrip_ok(f, data)


def test_roundtrip_multiblock():
    data = _mixed_corpus(300_000, seed=9)
    f = codec.compress(data, level=1)
    assert oracle.roundtrip_ok(f, data)
    assert len(f) < len(data)


def test_roundtrip_incompressible():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, 150_000, np.uint8).tobytes()
    f = codec.compress(data, level=1)
    assert oracle.roundtrip_ok(f, data)
    # Raw-block overhead only: 3 bytes per 128K block + headers.
    assert len(f) <= len(data) + 64


def test_level_guard_matches_reference_envelope():
    # Reference rejects levels outside 1..12 (src/qatseqprod.c:1132-1137).
    with pytest.raises(ValueError):
        codec.compress(b"x" * 100, level=0)
    with pytest.raises(ValueError):
        codec.compress(b"x" * 100, level=13)


def test_ratio_parity_with_stock_zstd():
    """North-star ratio check on a real text file (BASELINE.md: compressed
    size <= plugin's; the plugin's ratio == libzstd's at same level since
    libzstd does the entropy coding)."""
    data = open(REPO / "SURVEY.md", "rb").read()
    for level in (1, 9):
        ours = len(codec.compress(data, level=level))
        theirs = len(oracle.compress(data, level=level))
        assert ours <= theirs * 1.03, (level, ours, theirs)


def test_execute_sequences_golden_decoder():
    data = np.frombuffer(_mixed_corpus(4000, 5), np.uint8)
    seqs = matcher.find_sequences(data, chain_depth=16, lazy=True)
    lit_parts, pos = [], 0
    for i in range(seqs.nseq):
        ll = int(seqs.lit_lengths[i])
        lit_parts.append(data[pos:pos + ll])
        pos += ll + int(seqs.match_lengths[i])
    lit_parts.append(data[pos:pos + seqs.last_literals])
    literals = np.concatenate(lit_parts)
    regen = matcher.execute_sequences(len(data), literals, seqs)
    assert (regen == data).all()
