#!/usr/bin/env python3
"""Deep-level parse-selector diagnostic: per-block hinted vs walk sizes.

The r5 selector (runtime/tpu_codec.py finish_block_host) picks ONE
parse per block by the device claims' literal share: < 0.05 -> lazy
chain parse with claims as scored hints, else the device-finish walk.
This workbench replays captured device claims through BOTH variants per
block and prints literal share, both body sizes, the rule's pick, and
the forfeited bytes — the data that sizes an ambiguous re-check band
(ROADMAP priority #3, the ~1.5% mixed-corpus gap vs r4 best-of-two).

  python scripts/deep_select_diag.py [--corpus mixed0] [--level 9] [--mb 2]
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import numpy as np


def capture_claims(codec, buf):
    """Run the device path once, recording (i, seqs) at the host
    finisher boundary.  Returns {block_index: BlockSequences}."""
    captured = {}
    orig = type(codec).finish_block_host

    def spy(self, fbuf, i, seqs, dev_section=None, *, frame_start=True,
            validate=False):
        if seqs is not None and dev_section is None:
            captured[i] = seqs
        return orig(self, fbuf, i, seqs, dev_section,
                    frame_start=frame_start, validate=validate)

    type(codec).finish_block_host = spy
    try:
        codec.compress(buf)
    finally:
        type(codec).finish_block_host = orig
    return captured


def both_bodies(buf, i, seqs, level, block_size):
    """Replay finish_block_host's two deep-level branches for one block.
    Mirrors runtime/tpu_codec.py finish_block_host ctx slicing."""
    from qat_zstd_plugin_tpu import native
    from qat_zstd_plugin_tpu.golden import codec as golden_codec
    from qat_zstd_plugin_tpu.runtime.tpu_codec import BlockSequences

    n = len(buf)
    bs = block_size
    gp = golden_codec.level_params(level)
    win = 1 << gp.window_log
    max_ctx = max(0, win - bs)
    blk = buf[i * bs:min((i + 1) * bs, n)]
    ctx = min(i * bs, win)
    ctx_find = min(i * bs, max_ctx)
    cblk = buf[i * bs - ctx:min((i + 1) * bs, n)]
    custom = gp.custom_tables
    first = i == 0

    # Variant A: hinted lazy chain parse.
    hpos = (np.cumsum(seqs.lit_lengths + seqs.match_lengths)
            - seqs.match_lengths)
    ll, of, ml, lastlit = native.find_sequences_hinted(
        cblk[ctx - ctx_find:], gp.chain_depth, gp.lazy,
        hpos, seqs.match_lengths, seqs.offsets,
        ctx_len=ctx_find, mml=gp.mml)
    body_h = native.block_body(blk, ll, of, ml, lastlit, custom, True,
                               first_block=first)

    # Variant B: the device-finish walk (extend + fill_gaps).
    ll, of, ml, lastlit = native.extend_sequences(
        cblk, seqs.lit_lengths, seqs.offsets, seqs.match_lengths,
        seqs.last_literals, ctx_len=ctx, max_off=win)
    ll, of, ml, lastlit = native.fill_gaps(
        cblk[ctx - ctx_find:], ll, of, ml, lastlit, ctx_len=ctx_find,
        chain_depth=max(gp.chain_depth, 16), mml=gp.mml, min_gap=4,
        relaxed=False)
    body_w = native.block_body(blk, ll, of, ml, lastlit, custom, True,
                               first_block=first)
    return body_h, body_w


def main() -> None:
    from ratio_probe import CORPORA
    from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec

    args = sys.argv[1:]
    corpus, level, mb = "mixed0", 9, 2
    it = iter(args)
    for a in it:
        if a == "--corpus":
            corpus = next(it)
        elif a == "--level":
            level = int(next(it))
        elif a == "--mb":
            mb = int(next(it))
    data = CORPORA[corpus](mb)
    bs = 131072
    data = data[:(len(data) // bs) * bs]
    buf = np.frombuffer(data, np.uint8)

    codec = TpuCodec(level=level, batch=4, use_device=True)
    claims = capture_claims(codec, buf)
    print(f"{corpus} L{level}: {len(claims)} device blocks captured")
    print(f"{'blk':>4} {'litshare':>9} {'hinted':>8} {'walk':>8} "
          f"{'rule':>6} {'best':>6} {'forfeit':>8}")
    tot_rule = tot_best = 0
    forfeits = []
    for i in sorted(claims):
        seqs = claims[i]
        blk_len = min(len(buf) - i * bs, bs)
        share = float(seqs.lit_lengths.sum() + seqs.last_literals) / blk_len
        body_h, body_w = both_bodies(buf, i, seqs, level, bs)
        lh = len(body_h) if body_h else blk_len
        lw = len(body_w) if body_w else blk_len
        # The codec's actual selector — shared function, cannot drift.
        from qat_zstd_plugin_tpu.golden import codec as _gc
        from qat_zstd_plugin_tpu.runtime.tpu_codec import deep_parse_pick
        win = 1 << _gc.level_params(level).window_log
        ctx_find = min(i * bs, max(0, win - bs))
        pick = "hint" if deep_parse_pick(level, share, ctx_find, bs) \
            else "walk"
        rule_sz = lh if pick == "hint" else lw
        best_sz = min(lh, lw)
        tot_rule += rule_sz
        tot_best += best_sz
        forfeit = rule_sz - best_sz
        if forfeit:
            forfeits.append((i, share, forfeit))
        print(f"{i:>4} {share:>9.4f} {lh:>8} {lw:>8} {pick:>6} "
              f"{'hint' if lh <= lw else 'walk':>6} {forfeit:>8}")
    print(f"\nrule total {tot_rule}  oracle-best total {tot_best}  "
          f"forfeit {tot_rule - tot_best} "
          f"({100.0 * (tot_rule - tot_best) / max(1, tot_best):.2f}%)")
    if forfeits:
        print("forfeiting blocks (share, bytes):",
              [(i, round(s, 3), f) for i, s, f in forfeits])


if __name__ == "__main__":
    main()
