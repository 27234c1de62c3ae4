"""compressAndVerify parity (VERDICT #8; reference src/qatseqprod.c:1245).

The reference submits every block with opData.compressAndVerify so
hardware output is checked before use. Our equivalent is structural: the
host verify-extend pass (qz_extend_sequences) recomputes every claimed
match against real bytes before the entropy stage, so device claims —
including the hash matcher's probabilistic ones — can never corrupt a
frame. These tests inject deliberately WRONG device claims and require
bit-exact output anyway.
"""

from pathlib import Path

import numpy as np
import pytest

from qat_zstd_plugin_tpu import native, oracle
from qat_zstd_plugin_tpu.format.frame import BlockSequences
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="verifier is the native runtime")


@pytest.fixture()
def corpus():
    rng = np.random.default_rng(3)
    text = open(REPO / "SURVEY.md", "rb").read()
    return (text + rng.integers(0, 256, 30000, np.uint8).tobytes()) * 2


def test_false_device_claims_are_repaired(corpus, monkeypatch):
    """Corrupt every device batch's sequences (wrong offsets/lengths);
    the verify pass must shrink/drop them and still produce a frame
    stock zstd decodes bit-exactly."""
    c = TpuCodec(level=1, batch=2, use_device=True)
    real_collect = c.collect_batch

    def corrupting_collect(handle):
        out = real_collect(handle)
        rng = np.random.default_rng(0)
        bad = []
        for seqs, sec in out:
            if seqs is None or seqs.nseq == 0:
                bad.append((seqs, sec))
                continue
            off = seqs.offsets.copy()
            ml = seqs.match_lengths.copy()
            # wrong offsets for a third of sequences, inflated lengths
            # for another third
            k = len(off)
            idx = rng.permutation(k)
            off[idx[: k // 3]] = rng.integers(
                1, 30000, k // 3).astype(off.dtype)
            ml[idx[k // 3: 2 * k // 3]] += 7
            bad.append((BlockSequences(seqs.lit_lengths, off, ml,
                                       seqs.last_literals), sec))
        return bad

    monkeypatch.setattr(c, "collect_batch", corrupting_collect)
    f = c.compress(corpus)
    assert oracle.decompress(f, len(corpus)) == corpus


def test_verify_pass_drops_false_and_extends_true():
    data = np.frombuffer(b"abcdefgh" * 64 + b"XYZW" * 16, np.uint8)
    # Claim 1: true match (offset 8 run) but understated length.
    # Claim 2: false match (offset 3 never matches here).
    lit = np.array([8, 0], np.uint32)
    off = np.array([8, 3], np.uint32)
    ml = np.array([16, 40], np.uint32)
    span = int(lit.sum() + ml.sum())
    last = len(data) - span
    ll, of, mm, lastlit = native.extend_sequences(data, lit, off, ml, last)
    assert len(ll) == 1              # false claim dropped
    assert of[0] == 8
    assert mm[0] >= 8 * 64 - 8       # true claim extended to the run end
    # Span invariant preserved.
    assert ll.sum() + mm.sum() + lastlit == len(data)


def test_validate_flag_still_available(corpus):
    """validate=True layers the golden byte-checker on top (belt and
    braces); must round-trip."""
    c = TpuCodec(level=1, batch=2, use_device=True)
    f = c.compress(corpus[:300000], validate=True)
    assert oracle.decompress(f, 300000) == corpus[:300000]
