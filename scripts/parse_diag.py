#!/usr/bin/env python3
"""Parse diagnostics: our device-path parse vs stock zstd's, per corpus.

Round-4 workbench (VERDICT r3 #1): decodes stock L1/L2 frames with the
golden decoder to recover stock's sequence stream, runs our device path
on the same blocks (cached claims replayed through the host finisher),
and prints side-by-side parse statistics — where the ratio gap lives:
literal bytes left unmatched, short-match counts, offset/rep economics.

  python scripts/parse_diag.py [--corpus text] [--level 1] [--mb 2]
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


def stock_block_sequences(data: bytes, level: int):
    """Stock zstd's parse: [(ll, offset, ml)] per block + literal stats.
    Decodes the stock frame's sequence streams with the golden decoder's
    internals (offset_value -> offset via the spec rep rules)."""
    from qat_zstd_plugin_tpu import oracle
    from qat_zstd_plugin_tpu.golden import decoder as gd

    frame = oracle.compress(data, level)
    # Walk the frame like golden decompress() but record sequences.
    buf = frame
    if int.from_bytes(buf[:4], "little") != 0xFD2FB528:
        raise RuntimeError("bad magic")
    pos = 4
    fhd = buf[pos]; pos += 1
    fcs_flag = fhd >> 6
    single_seg = (fhd >> 5) & 1
    cs_flag = (fhd >> 2) & 1
    did_flag = fhd & 3
    if not single_seg:
        pos += 1  # window descriptor
    pos += [0, 1, 2, 4][did_flag]
    pos += [0 if not single_seg else 1, 2, 4, 8][fcs_flag]
    state = gd._SeqTables()
    reps = [1, 4, 8]
    blocks = []
    while True:
        hdr = int.from_bytes(buf[pos:pos + 3], "little")
        pos += 3
        last = hdr & 1
        btype = (hdr >> 1) & 3
        bsize = hdr >> 3
        if btype == 2:  # compressed
            bdata = buf[pos:pos + bsize]
            lits, used = gd._decode_literals(bdata, state)
            sdata = bdata[used:]
            b0 = sdata[0]
            if b0 < 128:
                nseq, shdr = b0, 1
            elif b0 < 255:
                nseq = ((b0 - 128) << 8) | sdata[1]
                shdr = 2
            else:
                nseq = int.from_bytes(sdata[1:3], "little") + 0x7F00
                shdr = 3
            raw = gd._decode_sequences(sdata[shdr:], nseq, state) \
                if nseq else []
            seqs = []
            lit_used = 0
            for ll, of_val, ml in raw:
                if of_val > 3:
                    off = of_val - 3
                    reps = [off, reps[0], reps[1]]
                else:
                    idx = of_val - 1 if ll != 0 else of_val
                    if idx == 3 or (ll == 0 and of_val == 3):
                        off = reps[0] - 1
                    else:
                        off = reps[idx]
                    if idx != 0:
                        if idx == 1:
                            reps = [reps[1], reps[0], reps[2]]
                        elif idx >= 2:
                            reps = [off, reps[0], reps[1]]
                seqs.append((ll, off, ml))
                lit_used += ll
            blocks.append(("c", seqs, int(len(lits)) - lit_used, bsize))
        else:
            blocks.append(("raw" if btype == 0 else "rle", [], bsize, bsize))
            if btype == 0:
                pass
        pos += bsize if btype != 1 else 1
        if last:
            break
    return blocks


def our_block_sequences(data: bytes, level: int):
    """Our device-path final parse per block: replay cached device claims
    through the host finisher's extension + gap-fill (no entropy)."""
    from qat_zstd_plugin_tpu import native
    from qat_zstd_plugin_tpu.golden import codec as golden_codec
    from qat_zstd_plugin_tpu.ops import match_pipeline
    from qat_zstd_plugin_tpu.runtime import tpu_codec as tc

    buf = np.frombuffer(data, np.uint8)
    bs = 131072
    nblocks = len(buf) // bs
    params = tc.TPU_LEVEL_TABLE[level]
    gp = golden_codec.level_params(level)
    win = 1 << gp.window_log
    max_ctx = max(0, win - bs)
    c = tc.TpuCodec(level=level, batch=4, use_device=True)
    out = []
    for s in range(0, nblocks, c.batch):
        ids = list(range(s, min(s + c.batch, nblocks)))
        blocks_np = np.stack([buf[i * bs:(i + 1) * bs] for i in ids])
        lengths_np = np.full(len(ids), bs, np.int32)
        res = c.collect_batch(c.submit_batch(blocks_np, lengths_np))
        for j, i in enumerate(ids):
            seqs, _ = res[j]
            ctx = min(i * bs, win)
            ctx_find = min(i * bs, max_ctx)
            cblk = buf[i * bs - ctx:(i + 1) * bs]
            ll, of, ml, lastlit = native.extend_sequences(
                cblk, seqs.lit_lengths, seqs.offsets,
                seqs.match_lengths, seqs.last_literals, ctx_len=ctx,
                max_off=win)
            ll, of, ml, lastlit = native.fill_gaps(
                cblk[ctx - ctx_find:], ll, of, ml, lastlit,
                ctx_len=ctx_find, chain_depth=gp.chain_depth, mml=gp.mml,
                min_gap=4 if params.sync else 32, relaxed=params.sync)
            out.append(list(zip(ll.tolist(), of.tolist(), ml.tolist()))
                       + [(int(lastlit), 0, 0)])
    return out


def stats(name: str, blocks):
    nseq = sum(len(s) for _, s, *_ in blocks) if blocks and isinstance(
        blocks[0], tuple) else sum(len(b) - 1 for b in blocks)
    print(name)


def seq_stats(seqs, reps_aware=True):
    """Aggregate parse stats over [(ll, off, ml)] with trailing
    (lastlit, 0, 0) rows allowed."""
    lit = 0
    n = 0
    mlh = {"3-5": 0, "6-8": 0, "9-16": 0, "17-64": 0, "65+": 0}
    offh = {"<=256": 0, "<=4K": 0, "<=32K": 0, ">32K": 0}
    rep_hits = 0
    match_bytes = 0
    prev_off = [1, 4, 8]
    for ll, off, ml in seqs:
        lit += ll
        if ml == 0:
            continue
        n += 1
        match_bytes += ml
        if ml <= 5:
            mlh["3-5"] += 1
        elif ml <= 8:
            mlh["6-8"] += 1
        elif ml <= 16:
            mlh["9-16"] += 1
        elif ml <= 64:
            mlh["17-64"] += 1
        else:
            mlh["65+"] += 1
        if off <= 256:
            offh["<=256"] += 1
        elif off <= 4096:
            offh["<=4K"] += 1
        elif off <= 32768:
            offh["<=32K"] += 1
        else:
            offh[">32K"] += 1
        if off in prev_off:
            rep_hits += 1
        if off != prev_off[0]:
            prev_off = [off, prev_off[0], prev_off[1]]
    return dict(nseq=n, lit=lit, match_bytes=match_bytes, mlh=mlh,
                offh=offh, rep=rep_hits)


def main() -> None:
    from ratio_probe import CORPORA
    args = sys.argv[1:]
    corpus, level, mb = "text", 1, 2
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

    sblocks = stock_block_sequences(data, level)
    ours = our_block_sequences(data, level)

    stot = {"nseq": 0, "lit": 0, "match_bytes": 0, "rep": 0}
    smlh = {}
    soffh = {}
    for kind, seqs, lastlit, _ in sblocks:
        if kind != "c":
            continue
        st = seq_stats(seqs)
        st["lit"] += lastlit
        for k in stot:
            stot[k] += st[k]
        for k, v in st["mlh"].items():
            smlh[k] = smlh.get(k, 0) + v
        for k, v in st["offh"].items():
            soffh[k] = soffh.get(k, 0) + v

    otot = {"nseq": 0, "lit": 0, "match_bytes": 0, "rep": 0}
    omlh = {}
    ooffh = {}
    for seqs in ours:
        st = seq_stats(seqs)
        for k in otot:
            otot[k] += st[k]
        for k, v in st["mlh"].items():
            omlh[k] = omlh.get(k, 0) + v
        for k, v in st["offh"].items():
            ooffh[k] = ooffh.get(k, 0) + v

    print(f"corpus={corpus} L{level} n={len(data)} "
          f"({len(data) // bs} blocks)")
    print(f"{'':12s} {'stock':>12s} {'ours':>12s}")
    for k in ("nseq", "lit", "match_bytes", "rep"):
        print(f"{k:12s} {stot[k]:>12d} {otot[k]:>12d}")
    print("match-length histogram:")
    for k in ("3-5", "6-8", "9-16", "17-64", "65+"):
        print(f"  {k:8s} {smlh.get(k, 0):>12d} {omlh.get(k, 0):>12d}")
    print("offset histogram:")
    for k in ("<=256", "<=4K", "<=32K", ">32K"):
        print(f"  {k:8s} {soffh.get(k, 0):>12d} {ooffh.get(k, 0):>12d}")


if __name__ == "__main__":
    main()
