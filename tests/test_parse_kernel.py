"""The greedy-parse kernel (ops/parse_kernel.py) against the plain scan
(match_pipeline.parse_greedy_scan): identical chosen masks required.

Here the kernel runs in Pallas interpret mode; the compiled kernel on a
card is the `gpu` case below (and chip_smoke.py's kernel phase)."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from qat_zstd_plugin_tpu.ops import match_pipeline as mp  # noqa: E402
from qat_zstd_plugin_tpu.ops import parse_kernel as pk  # noqa: E402


def _mlen(B=3, N=4096, seed=0):
    """Candidate lengths with the shapes the matchers emit: sparse short
    claims, long offset-1 runs, and matches crossing segment ends."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((B, N)) < 0.3,
                 rng.integers(4, 40, (B, N)), 0).astype(np.int32)
    m[0, 100] = 3000                     # long run
    m[-1, N // 4 - 6] = 50               # crosses a psegs=4 segment end
    m[-1, N - 5] = 16                    # runs past the block end
    return m


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("psegs", [1, 4])
def test_kernel_matches_scan(lazy, psegs):
    m = jnp.asarray(_mlen(seed=psegs))
    ref = np.asarray(mp.parse_greedy_scan(m, lazy=lazy, psegs=psegs))
    got = np.asarray(pk.parse_greedy_kernel(m, lazy=lazy, psegs=psegs,
                                            interpret=True))
    assert ref.sum() > 100
    assert (ref == got).all()


def test_psegs_truncates_at_segment_ends():
    """Candidates are truncated at parse-segment ends: a chosen position
    keeps >= MIN_MATCH bytes inside its own segment, and every segment's
    parse restarts at its first position."""
    m = _mlen(B=2, N=2048, seed=5)
    n = 2048 // 4
    m[:, ::n] = 0                        # segment starts: no candidate
    ch = np.asarray(mp.parse_greedy_scan(jnp.asarray(m), psegs=4))
    one = np.asarray(mp.parse_greedy_scan(jnp.asarray(m), psegs=1))
    pos = np.flatnonzero(ch.reshape(-1)) % 2048
    assert ((pos % n) + mp.MIN_MATCH <= n).all()
    assert (ch != one).any()  # the segmented parse really differs


def test_parse_greedy_uses_scan_on_cpu(monkeypatch):
    """On the CPU the backend picks the plain scan: the kernel is never
    traced (it would fail to compile without a card)."""
    def boom(*a, **k):
        raise AssertionError("kernel traced on the CPU backend")

    monkeypatch.setattr(pk, "parse_greedy_kernel", boom)
    m = jnp.asarray(_mlen(B=2, N=1024))
    out = pk.parse_greedy(m, lazy=True)
    assert out.shape == (2, 1024) and out.dtype == bool


@pytest.mark.gpu
def test_compiled_kernel_matches_scan(gpu):
    m = jnp.asarray(_mlen(B=8, N=131072, seed=9))
    ref = np.asarray(mp.parse_greedy_scan(m, lazy=True))
    got = np.asarray(pk.parse_greedy_kernel(m, lazy=True))
    assert (ref == got).all()
