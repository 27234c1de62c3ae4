"""Differential tests: the positions pipeline's staged candidates
(glue_kernels.candidates_hash_split) vs the one-function XLA reference
(match_pipeline.candidates_hash), and the parallel-sort compaction
(compact_fast) vs a golden per-block loop — identical results required."""

from pathlib import Path

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from qat_zstd_plugin_tpu.ops import glue_kernels as gk  # noqa: E402
from qat_zstd_plugin_tpu.ops import match_pipeline as mp  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("B,N,widths", [
    (4, 65536, (5, 8)), (1, 131072, (6,)), (2, 32768, (4, 5, 8)),
    (3, 65536, (5, 8))])
def test_glue_matches_xla(B, N, widths):
    rng = np.random.default_rng(B)
    text = (open(REPO / "SURVEY.md", "rb").read() * 12)
    buf = np.frombuffer(text[:B * N], np.uint8).reshape(B, N).copy()
    if B > 1:
        buf[1, : N // 4] = rng.integers(0, 4, N // 4, np.uint8)
        buf[1, 1000:2000] = 9  # run
    lengths = np.full(B, N, np.int32)
    lengths[-1] = N - 57
    W = min(32768, N)
    m1, o1 = mp.candidates_hash(jnp.asarray(buf), jnp.asarray(lengths),
                                widths=widths, neighbors=1, window=W)
    m2, o2 = gk.candidates_hash_split(jnp.asarray(buf),
                                      jnp.asarray(lengths), widths=widths,
                                      neighbors=1, window=W)
    assert (np.asarray(m1) == np.asarray(m2)).all()
    assert (np.asarray(o1) == np.asarray(o2)).all()


def _golden_compact(chosen, mlen, moff, lengths):
    """Per-block loop: chosen positions in order -> (lit, off, ml, last)."""
    out = []
    for b in range(chosen.shape[0]):
        pos = np.flatnonzero(chosen[b])
        ml = mlen[b, pos].astype(np.int64)
        ends = pos + ml
        lit = pos - np.concatenate([[0], ends[:-1]])
        last = int(lengths[b]) - (int(ends[-1]) if len(pos) else 0)
        out.append((lit, moff[b, pos].astype(np.int64), ml, last))
    return out


@pytest.mark.parametrize("B,N", [(4, 65536), (2, 131072)])
def test_compact_glue_matches_xla(B, N):
    text = (open(REPO / "SURVEY.md", "rb").read() * 12)
    buf = np.frombuffer(text[:B * N], np.uint8).reshape(B, N)
    lengths = np.full(B, N, np.int32)
    W = 32768
    m, o = mp.candidates_hash(jnp.asarray(buf), jnp.asarray(lengths),
                              widths=(5, 8), neighbors=1, window=W)
    chosen = mp.parse_greedy_scan(m)
    a = {k: np.asarray(v) for k, v in mp.compact_fast(
        chosen, m, o, jnp.asarray(lengths), 16384, W).items()}
    gold = _golden_compact(np.asarray(chosen), np.asarray(m),
                           np.asarray(o), lengths)
    assert not a["overflow"].any()
    for b, (lit, off, ml, last) in enumerate(gold):
        ns = int(a["nseq"][b])
        assert ns == len(lit) > 0
        assert (a["lit_len"][b, :ns] == lit).all()
        assert (a["offset"][b, :ns] == off).all()
        assert (a["match_len"][b, :ns] == ml).all()
        assert int(a["last_literals"][b]) == last
        assert not a["lit_len"][b, ns:].any()
