"""Ratio regression guard: fixed corpora, fixed configs, bounded ratios.

Bounds have headroom (~1.01-1.02x of measured) so legitimate refactors
pass but real regressions (lost matches, broken cost model, table
selection bugs) fail loudly.

Multi-corpus (VERDICT r3 #3): every per-level claim is gated on four
compositions — the bench mix, text-heavy, structured binary, and
high-redundancy (utils/corpora.py) — and every published claim quotes
the WORST corpus. Measured reference points (late round 5, 2 MB
corpora, after the unified finishing walk with claim competition and
the r5 priced chains + fast-matcher mini-lazy):

  device vs stock   mixed0   text    binary  redundant
    L1              0.972    0.962   0.941   0.723
    L2              0.962    0.899   0.941   0.674
    L3              0.958    0.981   0.959   0.873
    L4              0.940    0.917   0.947   0.894     (r4 capture)
  software vs stock
    L1              0.958    0.903   0.952   0.649
    L2              0.917    0.759   0.954   0.688
    L3              0.962    0.955   0.963   0.869

Deep levels (L5+) run ONE parse per block, selected by the device
claims' literal share (r5, replacing the r4 best-of-two double parse at
half its host cost; QZ_SECOND_PARSE=1 opts the double parse back in):
share < 0.05 (L5-6) / < 0.13 (L7+) takes the lazy chain parse with the
device claims as scored hints, as do the first two context-starved
blocks of a window below share 0.40; everything else takes the
device-finish walk. With the late-r5 offset-priced chain scoring
(candidates pay ~highbit(offset)/8 bytes, reps pay nothing — the same
pricing the walk and fast matcher already used), measured on 2 MB
probes vs stock:

  rule vs stock    mixed0   mixed3  text    binary  redundant
    L5             0.941    0.946   0.968   0.961   0.996
    L7             0.945    0.952   0.916   0.963   0.998
    L9             0.936    0.943   0.887   0.961   0.998
    L12            0.950    0.955   0.933   0.978   0.998

— every device level L1-L12 beats stock on every probe corpus; the
selector's per-block forfeit vs an oracle picking the better parse is
< 0.4% per composition (scripts/deep_select_diag.py).

The fast levels' old text residual (sw L1 1.008-1.02 over stock) was
diagnosed as parse fragmentation — 952k sequences vs stock's 832k on
8 MB text, skewed to 6-8-byte matches where stock finds 9-16; table
size, acceleration, rep floor, window, and insert density were all
measured as non-causes (insert density regressed high-redundancy 2.4x
at 1 MB and was reverted). The fix was a mini-lazy probe in the fast
matcher (a short non-rep find checks the next position once,
QZ_FAST_LAZY=64): text L1 1.0079 -> 0.9033, mixed -2.8%, binary
-1.3%, redundant unchanged, speed flat. The greedy chain levels
(L3-L4) got the same conditional one-step lazy on finds < 32 bytes
(QZ_CHAIN_LAZY_BAR, golden matcher mirrored): text L3 1.0085 ->
0.9550, text8 L3/L4 -4.4%, redundant unchanged. The L2 long (8-gram)
table joining the mini-lazy probe bought another 6% on 8 MB text
(text L2 0.811 -> 0.759 at 2 MB, mixed 0.930 -> 0.917). Every
software cell now beats stock on every probe corpus; the device path
does too.
"""

from pathlib import Path

import numpy as np
import pytest

from qat_zstd_plugin_tpu import native, oracle
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
from qat_zstd_plugin_tpu.utils import corpora

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def corpus():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_mod", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench.make_corpus(2 << 20)


pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="oracle missing")


def _ratio(codec, data):
    f = codec.compress(data)
    assert oracle.roundtrip_ok(f, data)
    return len(f) / len(data)


def test_device_path_l1_ratio(corpus):
    # L1 is the syncmer speed point (pair-sampled anchors, half the sort
    # volume) plus minimizer LDM plus the unified host finishing walk;
    # measured 0.2638 (r4) after claim competition landed.
    r = _ratio(TpuCodec(level=1, batch=4, use_device=True), corpus)
    assert r < 0.270, r


def test_device_path_l3_ratio(corpus):
    r = _ratio(TpuCodec(level=3, batch=4, use_device=True), corpus)
    assert r < 0.263, r


def test_device_vs_stock_per_level(corpus):
    """Per-level parity gate vs stock zstd (BASELINE.md) for the device
    pipeline — the round-4 unified walk (gap matches extend past claim
    boundaries; every claim faces a chain-probe competition for a
    longer/nearer source) took L1 from 1.016x stock to 0.973x and L2
    from 1.0007x to 0.962x on this corpus; all of L1-L5 and L9 now sit
    BELOW stock (VERDICT r3 #1 done criterion: bounds at 1.0 for L1/L2)."""
    for lvl, bound in ((1, 0.99), (2, 0.98), (3, 0.97), (4, 0.96),
                       (5, 0.97), (9, 0.96)):
        ours = _ratio(TpuCodec(level=lvl, batch=4, use_device=True), corpus)
        stock = len(oracle.compress(corpus, lvl)) / len(corpus)
        assert ours <= stock * bound, (lvl, ours, stock)


def test_device_vs_stock_multi_corpus_fast_levels():
    """Device L1/L2 vs stock on three non-bench compositions (1 MB each
    to bound suite time; measured ratios in the module docstring). The
    device fast path must beat stock on EVERY corpus — this was the
    round-3 verdict's open axis (gate corpus +1.6%, text +10.8% before
    the walk)."""
    # Measured at 1 MB (r4): text 0.934/0.882, binary 0.939/0.939,
    # redundant 0.657/0.867 — bounds carry ~1.5-2% headroom.
    bounds = {
        ("text", 1): 0.95, ("text", 2): 0.90,
        ("binary", 1): 0.955, ("binary", 2): 0.955,
        ("redundant", 1): 0.68, ("redundant", 2): 0.89,
    }
    for (name, lvl), bound in bounds.items():
        data = corpora.CORPORA[name](1 << 20)
        ours = _ratio(TpuCodec(level=lvl, batch=4, use_device=True), data)
        stock = len(oracle.compress(data, lvl)) / len(data)
        assert ours <= stock * bound, (name, lvl, ours, stock, bound)


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_cpu_native_vs_stock_per_level(corpus):
    """The software path (cross-block context, native matcher, repcodes,
    finishing walk at L2-L4, package-merge Huffman) must beat stock zstd
    outright at every level on the bench corpus (r4 measured: L1 0.986x,
    L2 0.937x, L3 0.968x, L5/L9/L12 below 0.99x)."""
    for lvl, bound in ((1, 1.0), (2, 1.0), (3, 1.0), (5, 1.0), (9, 1.0),
                       (12, 1.0)):
        ours = _ratio(TpuCodec(level=lvl, use_device=False), corpus)
        stock = len(oracle.compress(corpus, lvl)) / len(corpus)
        assert ours <= stock * bound, (lvl, ours, stock)


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_cpu_native_vs_stock_multi_corpus():
    """Software path per-corpus gates (VERDICT r3 #3 — the seed-3
    counterexample class). Binary's offset-churn detector must keep L1
    below stock (was 1.060x before the conditional finishing walk),
    and the r5 fast-matcher mini-lazy must keep text L1 below stock at
    every size (the old single-probe fragmentation residual). The
    redundant L1 bound also guards the insert-density failure mode
    (2.4x at 1 MB, caught and reverted in r5)."""
    bounds = {
        ("mixed3", 1): 1.0, ("text", 1): 0.96, ("binary", 1): 0.97,
        ("redundant", 1): 0.69,
        ("text", 2): 0.85, ("binary", 2): 0.97, ("redundant", 2): 0.90,
    }
    for (name, lvl), bound in bounds.items():
        if name == "mixed3":
            data = corpora.corpus_mixed(1 << 20, seed=3)
        else:
            data = corpora.CORPORA[name](1 << 20)
        ours = _ratio(TpuCodec(level=lvl, use_device=False), data)
        stock = len(oracle.compress(data, lvl)) / len(data)
        assert ours <= stock * bound, (name, lvl, ours, stock, bound)


def test_device_path_l9_ratio(corpus):
    r = _ratio(TpuCodec(level=9, batch=4, use_device=True), corpus)
    assert r < 0.270, r


def test_device_entropy_ratio(corpus):
    # Custom per-block FSE tables on device (fse_tables.py) — must stay
    # within a point of the host-entropy path (VERDICT #4 gate; was 35%
    # with predefined-only tables).
    c = TpuCodec(level=1, batch=4, use_device=True, device_entropy=True)
    r = _ratio(c, corpus)
    assert c.fallback_batches == 0
    assert r < 0.30, r


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_cpu_native_l1_ratio(corpus):
    r = _ratio(TpuCodec(level=1, use_device=False), corpus)
    assert r < 0.30, r


def test_ratio_not_absurdly_behind_stock(corpus):
    ours = _ratio(TpuCodec(level=1, batch=4, use_device=True), corpus)
    stock = len(oracle.compress(corpus, 1)) / len(corpus)
    # North-star is parity with the QAT plugin (whose entropy == stock
    # zstd's but whose matcher is a 16-bit-offset hardware LZ4s); keep us
    # within 10% of stock zstd software as a strong proxy bound.
    assert ours < stock * 1.10, (ours, stock)


def test_device_vs_stock_deep_levels_multi_corpus():
    """Deep levels under the r5 single-parse selection rule must beat
    stock on every composition (bounds from the module-docstring matrix,
    ~1-2% headroom)."""
    bounds = {"text": 0.91, "binary": 0.985, "redundant": 1.0}
    for name, bound in bounds.items():
        data = corpora.CORPORA[name](1 << 20)
        ours = _ratio(TpuCodec(level=9, batch=4, use_device=True), data)
        stock = len(oracle.compress(data, 9)) / len(data)
        assert ours <= stock * bound, (name, ours, stock, bound)


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_second_parse_opt_in(corpus, monkeypatch):
    """QZ_SECOND_PARSE=1 re-enables the r4 best-of-two double parse; it
    must round-trip and never produce a larger frame than the default
    single-parse rule."""
    from qat_zstd_plugin_tpu.utils import config
    data = corpus[: 512 << 10]
    f_rule = TpuCodec(level=9, batch=4, use_device=True).compress(data)
    monkeypatch.setenv("QZ_SECOND_PARSE", "1")
    config.set(None)
    try:
        c2 = TpuCodec(level=9, batch=4, use_device=True)
        f_b2 = c2.compress(data)
        assert oracle.roundtrip_ok(f_b2, data)
        assert len(f_b2) <= len(f_rule) * 1.001, (len(f_b2), len(f_rule))
    finally:
        config.set(None)
