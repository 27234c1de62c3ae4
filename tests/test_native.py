"""Native C++ runtime tests: differential against the Python golden model.

The native encoder is required to be *byte-identical* to format/ — same
normalization, same heap tie-breaks, same mode selection — so either
backend can finish any block interchangeably."""

from pathlib import Path

import numpy as np
import pytest

from qat_zstd_plugin_tpu import native, oracle
from qat_zstd_plugin_tpu.format import frame
from qat_zstd_plugin_tpu.format.frame import BlockSequences
from qat_zstd_plugin_tpu.format.xxhash import xxh64 as py_xxh64
from qat_zstd_plugin_tpu.golden import matcher

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain missing")


def test_xxh64_differential():
    rng = np.random.default_rng(0)
    for n in [0, 1, 3, 4, 7, 8, 31, 32, 33, 1000, 100_000]:
        data = rng.integers(0, 256, n, np.uint8).tobytes()
        assert native.xxh64(data) == py_xxh64(data), n
    arr = rng.integers(0, 256, 5000, np.uint8).astype(np.uint8)
    assert native.xxh64(arr) == py_xxh64(arr.tobytes())


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    parts = []
    words = [b"the ", b"data ", b"zstd ", b"entropy block ", b"offset "]
    while sum(map(len, parts)) < n:
        k = int(rng.integers(0, 4))
        if k == 0:
            parts.append(b"".join(words[i] for i in
                                  rng.integers(0, 5, 50)))
        elif k == 1:
            parts.append(bytes([int(rng.integers(0, 256))]) * 200)
        elif k == 2:
            parts.append(rng.integers(0, 8, 500, np.uint8).tobytes())
        else:
            parts.append(rng.integers(0, 256, 300, np.uint8).tobytes())
    return np.frombuffer(b"".join(parts)[:n], np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_block_body_byte_identical_to_golden(seed):
    data = _corpus(30_000, seed)
    seqs = matcher.find_sequences(data, chain_depth=8, lazy=(seed % 2 == 0))
    py_body = frame.encode_block_body(data, seqs)
    nat_body = native.block_body(data, seqs.lit_lengths, seqs.offsets,
                                 seqs.match_lengths, seqs.last_literals)
    assert nat_body == py_body


def test_block_body_no_custom_no_huffman():
    data = _corpus(20_000, 9)
    seqs = matcher.find_sequences(data, chain_depth=4)
    for custom in (False, True):
        for huff in (False, True):
            py_body = frame.encode_block_body(
                data, seqs, allow_custom_tables=custom, try_huffman=huff)
            nat_body = native.block_body(
                data, seqs.lit_lengths, seqs.offsets, seqs.match_lengths,
                seqs.last_literals, custom, huff)
            assert nat_body == py_body, (custom, huff)


@pytest.mark.parametrize("depth,lazy", [(2, False), (8, False), (16, True)])
def test_native_matcher_valid_and_oracle(depth, lazy):
    data = _corpus(50_000, depth)
    ll, of, ml, lastlit = native.find_sequences(data, depth, lazy)
    seqs = BlockSequences(ll, of, ml, lastlit)
    matcher.validate_sequences(data, seqs)
    body = native.block_body(data, ll, of, ml, lastlit)
    f = frame.assemble_frame(data.tobytes(), [body], block_size=131072)
    assert oracle.roundtrip_ok(f, data.tobytes())


def test_native_matcher_identical_to_golden():
    # Same algorithm, same parameters -> same sequences.
    data = _corpus(25_000, 5)
    ll, of, ml, lastlit = native.find_sequences(data, 16, True)
    g = matcher.find_sequences(data, chain_depth=16, lazy=True)
    assert lastlit == g.last_literals
    assert ll.tolist() == g.lit_lengths.tolist()
    assert of.tolist() == g.offsets.tolist()
    assert ml.tolist() == g.match_lengths.tolist()


def test_native_matcher_degenerate():
    for raw in [b"", b"a", b"abcd", b"\x00" * 100, b"ab" * 3]:
        data = np.frombuffer(raw, np.uint8)
        ll, of, ml, lastlit = native.find_sequences(data, 8, False)
        seqs = BlockSequences(ll, of, ml, lastlit)
        matcher.validate_sequences(data, seqs)


def test_threaded_encode_deterministic():
    from concurrent.futures import ThreadPoolExecutor
    data = _corpus(131072, 7)

    def body(_):
        ll, of, ml, lastlit = native.find_sequences(data, 4, False)
        return native.block_body(data, ll, of, ml, lastlit)

    with ThreadPoolExecutor(8) as p:
        outs = list(p.map(body, range(16)))
    assert all(o == outs[0] for o in outs)


def test_fill_gaps_finds_far_matches():
    """Literal runs the block-local device window missed must be
    re-matched against the window context (cross-block) and the rest of
    the block by the gap-fill pass."""
    rng = np.random.default_rng(11)
    ctx = rng.integers(0, 256, 40000, np.uint8).astype(np.uint8)
    secret = rng.integers(0, 256, 3000, np.uint8).astype(np.uint8)
    ctx[5000:8000] = secret
    junk = rng.integers(0, 256, 2000, np.uint8).astype(np.uint8)
    block = np.concatenate([junk, secret, junk[::-1]])
    buf = np.concatenate([ctx, block])
    # Device-ish parse that found nothing: one all-literal block.
    ll, of, ml, last = native.fill_gaps(
        buf, np.zeros(0, np.int64), np.zeros(0, np.int64),
        np.zeros(0, np.int64), len(block), ctx_len=len(ctx),
        chain_depth=8, mml=6)
    assert len(ll) >= 1
    far = of > 30000
    assert far.any(), "cross-block match not found"
    assert ml[far].max() >= 2500
    # Span invariant + byte-faithfulness (context-aware validator).
    assert ll.sum() + ml.sum() + last == len(block)
    matcher.validate_sequences(buf, BlockSequences(ll, of, ml, last),
                               ctx_len=len(ctx))


def test_fill_gaps_preserves_good_parse():
    """Blocks with no big literal runs come back unchanged."""
    data = np.frombuffer(b"abcdefgh" * 2000, np.uint8)
    ll, of, ml, last = native.find_sequences(data, 8, False, mml=4)
    ll2, of2, ml2, last2 = native.fill_gaps(data, ll, of, ml, last,
                                            ctx_len=0, mml=4)
    assert ll2.sum() + ml2.sum() + last2 == len(data)
    assert len(ll2) == len(ll) and (of2 == of).all()


def test_compress_blocks_mt_streaming_ranges():
    """The streaming MT compressor partitions blocks into contiguous
    per-thread ranges with a persistent hash table; every partitioning
    must produce valid frames-worth of bodies and identical bytes for
    the single-range case (determinism within a range)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_mod", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    buf = np.frombuffer(bench.make_corpus(7 * 131072 + 12345, seed=11),
                        np.uint8)
    from qat_zstd_plugin_tpu.golden import decoder as gdec  # noqa: F401
    from qat_zstd_plugin_tpu.format import frame as fr

    ref = None
    for nthreads in (1, 2, 3, 8):
        bodies = native.compress_blocks_mt(
            buf, 131072, 2, False, True, True, window_log=19, mml=6,
            nthreads=nthreads)
        f = fr.assemble_frame(buf, bodies, 131072, True)
        assert oracle.roundtrip_ok(f, buf.tobytes()), nthreads
        if nthreads == 1:
            ref = bodies
    # nthreads=1 is a single range: deterministic across calls
    again = native.compress_blocks_mt(
        buf, 131072, 2, False, True, True, window_log=19, mml=6,
        nthreads=1)
    assert [bytes(b) if b else b for b in again] \
        == [bytes(b) if b else b for b in ref]


def test_compress_blocks_mt_window_smaller_than_block():
    buf = np.frombuffer(b"abcdef" * 40000, np.uint8)  # 240000 bytes
    from qat_zstd_plugin_tpu.format import frame as fr
    bodies = native.compress_blocks_mt(
        buf, 131072, 2, False, True, True, window_log=17, mml=6,
        nthreads=2)
    f = fr.assemble_frame(buf, bodies, 131072, True)
    assert oracle.roundtrip_ok(f, buf.tobytes())


def test_fast_matcher_edges():
    """The single-probe fast matcher (chain_depth <= 2, greedy) must
    roundtrip bit-exactly on its structural edge cases: incompressible
    data (acceleration stepping skips most probes), long rep runs (the
    rep probe carries the parse), short runt tails below the 16-byte
    floor, and mixed content straddling block boundaries."""
    from qat_zstd_plugin_tpu.format import frame as fr
    rng = np.random.default_rng(7)
    cases = [
        rng.integers(0, 256, 300000, np.uint8).tobytes(),    # incompressible
        b"\x00" * 200000,                                    # one rep run
        (b"abcdefgh" * 20000)[:150001],                      # period-8 reps
        rng.integers(0, 4, 140000, np.uint8).tobytes(),      # low entropy
        b"x" * 15,                                           # runt block
        (bytes(range(256)) * 1024)[: 131072 + 17],           # boundary tail
    ]
    for i, data in enumerate(cases):
        buf = np.frombuffer(data, np.uint8)
        bodies = native.compress_blocks_mt(
            buf, 131072, 2, False, True, True, window_log=19, mml=6)
        f = fr.assemble_frame(buf, bodies, 131072, True)
        assert oracle.roundtrip_ok(f, data), i


def test_fast_matcher_ratio_sane_vs_chain():
    """The fast matcher trades chain walks for a 2-way table; on a mixed
    corpus it must stay within a few percent of the chain matcher's
    compressed size (it currently beats it: the per-scan rep probe plus
    persistent streaming context outweigh the lost chain depth)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_mod", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    buf = np.frombuffer(bench.make_corpus(1 << 20, seed=3), np.uint8)

    def csize(depth):
        bodies = native.compress_blocks_mt(
            buf, 131072, depth, False, True, True, window_log=19, mml=6,
            nthreads=1)
        return sum(len(b) if b else 131072 for b in bodies)

    fast, chain = csize(2), csize(8)  # depth 8 routes to the chain matcher
    assert fast <= chain * 1.06, (fast, chain)  # measured 1.042 vs chain-8


def test_fill_gaps_claim_competition():
    """A claim pointing at a WORSE occurrence (farther source that
    diverges sooner) must be replaced by the chain's better candidate —
    the r4 competition that closed the device text gap. Construct: the
    pattern appears at A (long context match) and B (short match); the
    claim names B."""
    rng = np.random.default_rng(23)
    pat = rng.integers(0, 256, 64, np.uint8).astype(np.uint8)
    junk1 = rng.integers(0, 256, 3000, np.uint8).astype(np.uint8)
    junk2 = rng.integers(0, 256, 500, np.uint8).astype(np.uint8)
    # Layout: [A: pat(64)] junk1 [B: pat[:8] then junk] junk2 [P: pat(64)]
    b_occ = np.concatenate([pat[:8], rng.integers(0, 256, 56, np.uint8)
                            .astype(np.uint8)])
    block = np.concatenate([pat, junk1, b_occ, junk2, pat,
                            rng.integers(0, 256, 2000, np.uint8)
                            .astype(np.uint8)])
    p_pos = 64 + len(junk1) + 64 + len(junk2)
    b_pos = 64 + len(junk1)
    # Claim at P names the B occurrence (verifies only 8 bytes).
    ll = np.array([p_pos], np.int64)
    of = np.array([p_pos - b_pos], np.int64)
    ml = np.array([8], np.int64)
    last = len(block) - p_pos - 8
    ll, of, ml, last = native.extend_sequences(block, ll, of, ml, last)
    ll, of, ml, last = native.fill_gaps(
        block, ll, of, ml, last, ctx_len=0, chain_depth=8, mml=4,
        min_gap=4, relaxed=True)
    hit = (of == p_pos) & (ml >= 60)  # switched to the A occurrence
    assert hit.any(), list(zip(ll.tolist(), of.tolist(), ml.tolist()))
    assert ll.sum() + ml.sum() + last == len(block)
    matcher.validate_sequences(block, BlockSequences(ll, of, ml, last),
                               ctx_len=0)


def test_fill_gaps_overrun_trims_claim():
    """A gap match may extend PAST the gap into a downstream claim,
    front-trimming it (coverage never decreases) — the r4 fix for the
    fragmentation signature. Construct: a long repeat whose claim only
    covers its tail; the gap probe finds the full repeat."""
    rng = np.random.default_rng(29)
    seg = rng.integers(0, 256, 400, np.uint8).astype(np.uint8)
    junk = rng.integers(0, 256, 2000, np.uint8).astype(np.uint8)
    tail = rng.integers(0, 256, 1500, np.uint8).astype(np.uint8)
    # [seg][junk][seg again]; claim covers only the LAST 100 bytes of
    # the second seg (the first 300 bytes sit in a "gap").
    block = np.concatenate([seg, junk, seg, tail])
    rep_start = 400 + len(junk)
    ll = np.array([rep_start + 300], np.int64)
    of = np.array([400 + len(junk)], np.int64)  # == len(seg)+len(junk)
    ml = np.array([100], np.int64)
    last = len(block) - rep_start - 400
    ll, of, ml, last = native.extend_sequences(block, ll, of, ml, last)
    ll, of, ml, last = native.fill_gaps(
        block, ll, of, ml, last, ctx_len=0, chain_depth=8, mml=4,
        min_gap=4, relaxed=True)
    # The full 400-byte repeat must be (mostly) matched: total matched
    # bytes at the repeat's offset >= 390.
    cover = ml[(of == 400 + len(junk))].sum()
    assert cover >= 390, list(zip(ll.tolist(), of.tolist(), ml.tolist()))
    assert ll.sum() + ml.sum() + last == len(block)
    matcher.validate_sequences(block, BlockSequences(ll, of, ml, last),
                               ctx_len=0)


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_block_body_rejects_out_of_alphabet_sequences():
    """Invalid sequences through the raw ABI (match_len < 3 underflows
    the ML code; huge lengths index past the code tables) must yield a
    clean refusal (raw block), not out-of-bounds table reads."""
    blk = np.frombuffer(b"abcdefgh" * 4096, np.uint8)
    n = len(blk)
    assert native.block_body(blk, np.array([4]), np.array([2]),
                             np.array([2]), n - 6, True, True) is None
    assert native.block_body(blk, np.array([4]), np.array([2]),
                             np.array([1]), n - 5, True, True) is None
    ok = native.block_body(blk, np.array([4]), np.array([8]),
                           np.array([28]), n - 32, True, True)
    assert ok is not None and len(ok) < n
