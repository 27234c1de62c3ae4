"""On-device Huffman literals encoding (SURVEY §7.4, the last entropy
stage off the host).

Flow per batch, all shape-static:

1. literal mask from the parse: a position is a literal iff no chosen
   match covers it — running-max-of-match-ends by shift doubling, fused
   with key building: key = (pos << 8 | byte) for literals, sentinel
   otherwise.
2. one single-word sort compacts the literal bytes in position order.
3. byte histogram + per-block canonical Huffman tables
   (ops/huffman_tables.py).
4. per-literal (code, nbits) items; destination index maps each literal
   to its 4-stream slot in *reversed* order (streams are written
   last-symbol-first); one more single-word sort is the scatter.
5. ops/bitconcat.py packs each stream row (log-depth reduction); the
   host wraps the section (tree description via format/huffman.py
   serialize_tree + jump table).

The host keeps raw/RLE/small-block literals (device path opts out via
the ok flag and the host encodes from block bytes as before).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import bitconcat, bitpack, huffman_tables
from .glue_kernels import _shr

SENT = 0xFFFFFFFF  # sentinel key (python int: folds as immediate)


@jax.jit
def literal_keys(blocks: jnp.ndarray, lengths: jnp.ndarray,
                 chosen: jnp.ndarray, mlen: jnp.ndarray) -> jnp.ndarray:
    """(B, N) u32: (pos << 8 | byte) at literal positions, sentinel
    elsewhere. Literal = not covered by any chosen match (match lengths
    <= 16383, so 14 doubling steps bound the running end-max)."""
    B, N = blocks.shape
    gp = jax.lax.broadcasted_iota(jnp.int32, (B, N), 1)
    blen = lengths.astype(jnp.int32)[:, None]
    ends = jnp.where(chosen != 0, gp + mlen, 0)
    step = 1
    for _ in range(14):
        ends = jnp.maximum(ends, _shr(ends, step, 0))
        step *= 2
    is_lit = (ends <= gp) & (gp < blen)
    key = (gp.astype(jnp.uint32) << 8) | blocks.astype(jnp.uint32)
    return jnp.where(is_lit, key, jnp.uint32(SENT))


@jax.jit
def byte_hist(sk: jnp.ndarray) -> jnp.ndarray:
    """(B, N) u32 literal keys (byte in bits 0-7, 0xFFFFFFFF = empty)
    -> (B, 256) int32 byte histogram (a per-row scatter-add; empty keys
    land in a discarded 257th bin)."""
    byte = jnp.where(sk != jnp.uint32(SENT),
                     (sk & jnp.uint32(0xFF)).astype(jnp.int32), 256)
    hist = jax.vmap(lambda b: jnp.bincount(b, length=257))(byte)
    return hist[:, :256].astype(jnp.int32)


def encode_literals_device(blocks: jnp.ndarray, lengths: jnp.ndarray,
                           chosen: jnp.ndarray, mlen: jnp.ndarray,
                           max_words: int | None = None) -> dict:
    """Per-block 4-stream Huffman-coded literals.

    Returns dict of device arrays:
      words (B*4, W) i32, bits (B*4,) i32 — per-stream backward payloads
      nb_bits/codes (B, 256), n_lit (B,), ok (B,) — ok=False blocks keep
      the host literals path (small/degenerate/overflow cases).
    """
    B, N = blocks.shape
    cap = N // 4
    if max_words is None:
        max_words = (cap * 12) // 32 + 8  # 11-bit codes + slack
    keys = literal_keys(blocks, lengths, chosen, mlen)
    valid = keys != jnp.uint32(SENT)
    byte = (keys & jnp.uint32(0xFF)).astype(jnp.int32)
    n_lit = valid.sum(axis=1).astype(jnp.int32)
    # Literal rank in position order needs no compaction sort: the keys
    # come out of the kernel in position order, so rank = prefix count.
    rank = jnp.cumsum(valid.astype(jnp.int32), axis=1) - 1

    # Histogram + tables on device; the per-literal (code | nbits << 11)
    # lookup is a SORTED JOIN: one single-word sort interleaves each
    # block's 256 table rows (carrying their entry in the low bits)
    # ahead of that byte's literals, and a hold-last scan propagates the
    # entry to them (a (N x 256) one-hot compare-reduce lookup would
    # materialize 256x the batch).
    hist = byte_hist(keys)
    t = huffman_tables.build_tables(hist)
    entry = t["codes"] | (t["nb_bits"] << 11)           # (B, 256), <= 15b
    elem_key = jnp.where(
        valid,
        (byte.astype(jnp.uint32) << 24) | jnp.uint32(1 << 22)
        | rank.astype(jnp.uint32),
        jnp.uint32(SENT))
    tbl_key = ((jnp.arange(256, dtype=jnp.uint32)[None, :] << 24)
               | entry.astype(jnp.uint32))
    kb = jnp.concatenate([elem_key,
                          jnp.broadcast_to(tbl_key, (B, 256))], axis=1)
    sb = jax.lax.sort((kb,), dimension=1, is_stable=False, num_keys=1)[0]
    is_tbl = (sb >> 22) & 1 == 0
    payload = (sb & jnp.uint32(0x3FFFFF)).astype(jnp.int32)
    ent, _ = bitpack._hold_last(jnp.where(is_tbl, payload, 0), is_tbl)
    is_elem = ~is_tbl & (sb != jnp.uint32(SENT))

    # 4-stream destination with in-stream reversal (write order = last
    # literal first). seg = ceil(n/4); stream s holds literal ranks
    # [s*seg, min((s+1)*seg, n)) at slots [s*cap, s*cap+len_s). The
    # scatter is a sort by destination, and a sort compacts ranks — so
    # every slot must be OCCUPIED: the N - n_lit sentinel rows (they
    # sort to the tail, after all table rows) are mapped onto the
    # per-stream gap slots [s*cap+len_s, (s+1)*cap) in order, with
    # zero-bit items (the packer skips them); the 256 table rows park at
    # 0xFFFFFFFF, strictly above every slot key (dest << 15 | entry
    # tops out at 0xFFFFDFFF since entry <= 0x5FFF), and fall off the
    # [:N] slice.
    seg = jnp.maximum((n_lit + 3) // 4, 1)[:, None]
    rk = payload                                    # element rank
    stream = jnp.minimum(rk // seg, 3)
    within = rk - stream * seg
    len_s = jnp.clip(n_lit[:, None] - stream * seg, 0, seg)
    rev = len_s - 1 - within
    dest_valid = stream * cap + rev
    # Gap assignment for the (N - n_lit) sentinel rows at the tail.
    lens4 = jnp.clip(n_lit[:, None] - jnp.arange(4)[None, :] * seg,
                     0, seg)                        # (B, 4)
    gaps = cap - lens4
    Gc = jnp.cumsum(gaps, axis=1) - gaps            # exclusive (B, 4)
    idxb = jnp.broadcast_to(
        jnp.arange(N + 256, dtype=jnp.int32)[None, :], (B, N + 256))
    fr = idxb - n_lit[:, None] - 256                # tail fill rank >= 0
    fs = ((fr >= Gc[:, 1:2]).astype(jnp.int32)
          + (fr >= Gc[:, 2:3]).astype(jnp.int32)
          + (fr >= Gc[:, 3:4]).astype(jnp.int32))
    G_sel = jnp.where(fs == 0, 0,
                      jnp.where(fs == 1, Gc[:, 1:2],
                                jnp.where(fs == 2, Gc[:, 2:3],
                                          Gc[:, 3:4])))
    len_sel = jnp.clip(n_lit[:, None] - fs * seg, 0, seg)
    dest_gap = fs * cap + len_sel + (fr - G_sel)
    key2 = jnp.where(
        is_elem,
        (dest_valid.astype(jnp.uint32) << 15) | ent.astype(jnp.uint32),
        jnp.where(is_tbl, jnp.uint32(0xFFFFFFFF),
                  dest_gap.astype(jnp.uint32) << 15))
    s2 = jax.lax.sort((key2,), dimension=1, is_stable=False,
                      num_keys=1)[0][:, :N]
    packed = (s2 & jnp.uint32(0x7FFF)).astype(jnp.int32)
    lo = (packed & 0x7FF).reshape(B * 4, cap)
    nb = (packed >> 11).reshape(B * 4, cap)
    # Log-depth reduction packer (ops/bitconcat.py).
    words, bits, over = bitconcat.bitconcat(lo, jnp.zeros_like(lo), nb,
                                            max_words, max_item_bits=11)
    over_b = over.reshape(B, 4).any(axis=1)
    # Streams must fit the 16-bit jump table and the 4-stream layout
    # needs n >= 1024 (host handles small blocks anyway).
    stream_bytes = (bits.reshape(B, 4) + 7 + 1) // 8  # + sentinel bit
    ok = (t["ok"] & (n_lit >= 1024) & ~over_b
          & (stream_bytes[:, :3] <= 0xFFFF).all(axis=1)
          & (n_lit - 3 * seg[:, 0] >= 1))
    return {"words": words, "bits": bits, "nb_bits": t["nb_bits"],
            "codes": t["codes"], "max_bits": t["max_bits"],
            "last_symbol": t["last_symbol"], "n_lit": n_lit, "ok": ok}


def device_literals_section(nb_bits: np.ndarray, codes: np.ndarray,
                            max_bits: int, last_symbol: int, n_lit: int,
                            words: np.ndarray, bits: np.ndarray
                            ) -> bytes | None:
    """Host wrapper: assemble one block's Compressed_Literals section from
    device streams. words/bits: (4, W)/(4,). Returns None if the section
    would not be format-legal (caller keeps the host literals path)."""
    from ..format import huffman
    from ..format.frame import LIT_COMPRESSED, _literals_header

    table = huffman.HuffmanTable(
        nb_bits.astype(np.int32), codes.astype(np.int32), int(max_bits),
        int(last_symbol))
    tree = huffman.serialize_tree(table)
    streams = [bitpack.backward_stream_bytes(words[s], int(bits[s]))
               for s in range(4)]
    if any(len(s) > 0xFFFF for s in streams[:3]):
        return None
    jump = b"".join(len(s).to_bytes(2, "little") for s in streams[:3])
    comp = len(tree) + len(jump) + sum(map(len, streams))
    if n_lit < 1024 and comp < 1024:
        sf = 1
    elif n_lit < (1 << 14) and comp < (1 << 14):
        sf = 2
    elif n_lit < (1 << 18) and comp < (1 << 18):
        sf = 3
    else:
        return None
    hdr = _literals_header(LIT_COMPRESSED, sf, n_lit, comp)
    return hdr + tree + jump + b"".join(streams)
