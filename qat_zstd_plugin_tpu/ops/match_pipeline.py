"""Batched LZ77 match finding — the accelerator half of the codec.

This replaces the reference's QAT DC engine offload (the hardware LZ4s
match finder behind cpaDcCompressData2, src/qatseqprod.c:1203-1306) with a
design built from whole-array programs instead of a DMA ring:

Hash-chain walks (pointer chasing per position) do not batch, so
everything is recast as *uniform-index* array ops over a block batch:

1. **Candidate generation via stable sort.** For every position t, take the
   big-endian 4-byte gram. A stable sort by gram groups equal grams while
   preserving position order inside a group, so the k-th sorted predecessor
   of an entry (when grams are equal) is exactly the k-th most recent
   previous occurrence — a depth-k "hash chain" with *no collisions and no
   gathers*. Content words at t+4/t+8/t+12 are carried through the sort, so
   match verification is an adjacent-row compare: every claimed byte
   equality is a real byte equality (exactness the reference gets from the
   accelerator's real LZ77, here by construction).
2. **Exact LCP up to 16 bytes** from the carried words; ties prefer the
   nearest source (largest prev position), which keeps offsets small AND
   makes capped long matches chain with a constant offset, so a host-side
   coalesce pass recovers full-length matches.
3. **Offset-1 run augmentation**: run-length scan (cummin of change
   indices) yields *uncapped* exact lengths for byte runs, the dominant
   long-match class.
4. **Greedy parse**: the sequential LZ parse. `parse_greedy_scan` here
   is the plain reference (a batched scan over positions with per-block
   cursors); the GPU runs the per-row cursor kernel in parse_kernel.py.
5. **Compaction via a third sort** (a sort is this codec's scatter):
   chosen positions first, in order, sliced to a static cap. Per-block
   overflow falls back to the CPU path (the analog of the reference's
   producer-error -> libzstd fallback, README.md:197-198).

Blocks are independent 128 KiB units (reference envelope:
src/qatseqprod.c:97), batched on the leading axis; everything is
shape-static and jit/pjit/shard_map friendly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MIN_MATCH = 4
LCP_CAP = 16
BIG = np.int32(2 ** 30)


def _lcp_word(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Leading equal bytes (0..4) of two big-endian-packed int32 words."""
    xor = x ^ y
    n0 = (xor & jnp.int32(0xFF000000 - (1 << 32))) == 0  # byte 0 (MSB)
    n1 = (xor & 0x00FF0000) == 0
    n2 = (xor & 0x0000FF00) == 0
    n3 = (xor & 0x000000FF) == 0
    c0 = n0.astype(jnp.int32)
    c1 = (n0 & n1).astype(jnp.int32)
    c2 = (n0 & n1 & n2).astype(jnp.int32)
    c3 = (n0 & n1 & n2 & n3).astype(jnp.int32)
    return c0 + c1 + c2 + c3


def _grams(x: jnp.ndarray, n: int) -> tuple[jnp.ndarray, ...]:
    """Big-endian 4-byte grams at t, t+4, t+8, t+12 (zero-padded tail)."""
    xi = x.astype(jnp.int32)
    pad = jnp.zeros(x.shape[:-1] + (LCP_CAP,), jnp.int32)
    xp = jnp.concatenate([xi, pad], axis=-1)

    def word(shift: int) -> jnp.ndarray:
        return ((xp[..., shift:shift + n] << 24)
                | (xp[..., shift + 1:shift + 1 + n] << 16)
                | (xp[..., shift + 2:shift + 2 + n] << 8)
                | (xp[..., shift + 3:shift + 3 + n]))

    return word(0), word(4), word(8), word(12)


def candidates(blocks: jnp.ndarray, lengths: jnp.ndarray,
               neighbors: int = 4, stride: int = 1,
               window: int = 1 << 30) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Best (match_len, offset) candidate per position.

    blocks: (B, N) uint8, zero-padded beyond lengths.
    lengths: (B,) int32 valid byte counts.
    stride > 1 samples anchor positions (fast mode: matches start only at
    multiples of stride, halving the dominant sort cost at stride 2 — the
    zstd fast-strategy acceleration analog). Offset-1 runs stay exact at
    every position.
    Returns (mlen, moff): (B, N) int32 each; mlen == 0 where no candidate.
    Capped at LCP_CAP except offset-1 runs (exact lengths).
    """
    B, N = blocks.shape
    g0, g1, g2, g3 = _grams(blocks, N)
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (B, N))
    if stride > 1:
        g0 = g0[:, ::stride]
        g1 = g1[:, ::stride]
        g2 = g2[:, ::stride]
        g3 = g3[:, ::stride]
        pos = pos[:, ::stride]

    # Window segmentation: short rows sort faster than 128K rows, so
    # restricting the match window to `window` bytes and sorting per
    # segment trades a little ratio (matches cannot cross segment
    # boundaries) for a sort speedup. Positions stay
    # segment-local through the sort and are rebased afterwards.
    nseg = 1
    if window < N:
        assert N % window == 0 and window % stride == 0, (N, window)
        nseg = N // window
        wl = window // stride

        def seg(a):
            return a.reshape(B * nseg, wl)

        g0, g1, g2, g3 = seg(g0), seg(g1), seg(g2), seg(g3)
        pos = pos.reshape(B * nseg, wl)
        seg_start = (jnp.arange(B * nseg, dtype=jnp.int32) % nseg) * window
        pos = pos - seg_start[:, None]  # segment-local positions

    # Stable sort by gram; ties keep position order -> per-group "chains".
    sk, sp, s1, s2, s3 = jax.lax.sort(
        (g0, pos, g1, g2, g3), dimension=1, is_stable=True, num_keys=1)

    if nseg > 1:
        seg_len = jnp.clip(
            jnp.repeat(lengths.astype(jnp.int32), nseg) - seg_start, 0,
            window)
        blen = seg_len[:, None]
    else:
        blen = lengths[:, None].astype(jnp.int32)
    R = sp.shape[0]  # row count: B, or B*nseg when segmented
    best_score = jnp.zeros(sp.shape, jnp.int32)
    sentinel = jnp.full((R, 1), BIG, jnp.int32)
    for k in range(1, neighbors + 1):
        pk = jnp.concatenate(
            [jnp.broadcast_to(sentinel, (R, k)), sp[:, :-k]], axis=1)
        kk = jnp.concatenate([jnp.zeros((R, k), jnp.int32), sk[:, :-k]], 1)
        p1 = jnp.concatenate([jnp.zeros((R, k), jnp.int32), s1[:, :-k]], 1)
        p2 = jnp.concatenate([jnp.zeros((R, k), jnp.int32), s2[:, :-k]], 1)
        p3 = jnp.concatenate([jnp.zeros((R, k), jnp.int32), s3[:, :-k]], 1)
        key_eq = sk == kk
        f1 = s1 == p1
        f2 = s2 == p2
        lcp = (4 + _lcp_word(s1, p1)
               + jnp.where(f1, _lcp_word(s2, p2), 0)
               + jnp.where(f1 & f2, _lcp_word(s3, p3), 0))
        lcp = jnp.minimum(lcp, blen - sp)       # stay inside the block
        valid = key_eq & (pk < sp) & (lcp >= MIN_MATCH)
        # Score: longer match first, then nearest source (so capped long
        # matches chain at constant offset for host-side coalescing).
        score = jnp.where(valid, (lcp << 18) | pk, 0)
        best_score = jnp.maximum(best_score, score)

    cand_len = best_score >> 18
    cand_src = best_score & ((1 << 18) - 1)
    cand_off = jnp.where(cand_len > 0, sp - cand_src, 0)

    # Cost model: a sequence costs ~(9 + log2(offset)) bits while literals
    # cost ~4-8 bits/byte, so short matches at far offsets are net losses
    # (stock zstd's fast strategy embeds the same economics). Static rule
    # tuned on the mixed corpus: 4-byte matches only near, 5/6-byte at
    # moderate range, 7+ anywhere.
    worth = ((cand_len >= 7)
             | ((cand_len >= 6) & (cand_off <= 32768))
             | ((cand_len >= 5) & (cand_off <= 4096))
             | ((cand_len >= 4) & (cand_off <= 256)))
    cand_len = jnp.where(worth, cand_len, 0)
    cand_off = jnp.where(worth, cand_off, 0)

    # Un-sort: scatter back to position order via a second sort keyed on
    # pos; (len, off) ride as one packed word (len <= 16 after the cost
    # filter, off < 2^17) to shrink the sort payload.
    packed_cand = (cand_len << 17) | cand_off
    _, pc = jax.lax.sort((sp, packed_cand), dimension=1,
                         is_stable=False, num_keys=1)
    mlen = pc >> 17
    moff = pc & ((1 << 17) - 1)
    if nseg > 1:
        mlen = mlen.reshape(B, N // stride)
        moff = moff.reshape(B, N // stride)
    if stride > 1:
        # Expand anchors back to the full grid (zeros between anchors).
        zero = jnp.zeros_like(mlen)
        mlen = jnp.stack([mlen] + [zero] * (stride - 1),
                         axis=2).reshape(B, N)
        moff = jnp.stack([moff] + [zero] * (stride - 1),
                         axis=2).reshape(B, N)

    # Offset-1 run augmentation (exact, uncapped lengths; always
    # full-block — runs cross candidate-window segments freely).
    xi = blocks.astype(jnp.int32)
    idx = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (B, N))
    chg = jnp.concatenate(
        [xi[:, :-1] != xi[:, 1:], jnp.ones((B, 1), bool)], axis=1)
    run_end = jax.lax.cummin(
        jnp.where(chg, idx, BIG)[:, ::-1], axis=1)[:, ::-1]
    len1 = run_end - idx + 1
    blen_full = lengths[:, None].astype(jnp.int32)
    len1 = jnp.minimum(len1, blen_full - idx)
    # Cap at 65535 so packed results fit u16; longer runs continue as
    # chained same-offset matches that the host coalesce re-merges.
    len1 = jnp.minimum(len1, 65535)
    prev_eq = jnp.concatenate(
        [jnp.zeros((B, 1), bool), xi[:, 1:] == xi[:, :-1]], axis=1)
    valid1 = prev_eq & (len1 >= MIN_MATCH)
    use1 = valid1 & (len1 > mlen)
    mlen = jnp.where(use1, len1, mlen)
    moff = jnp.where(use1, 1, moff)
    return mlen, moff


def _hash_width(blocks_i32: jnp.ndarray, width: int, n: int,
                hbits: int) -> jnp.ndarray:
    """hbits-bit multiplicative hash of the width-byte gram at each
    position (uint32 lanes; zero-padded tail)."""
    xu = blocks_i32.astype(jnp.uint32)
    pad = jnp.zeros(xu.shape[:-1] + (16,), jnp.uint32)
    xp = jnp.concatenate([xu, pad], axis=-1)

    def word(shift: int) -> jnp.ndarray:
        return ((xp[..., shift:shift + n] << 24)
                | (xp[..., shift + 1:shift + 1 + n] << 16)
                | (xp[..., shift + 2:shift + 2 + n] << 8)
                | (xp[..., shift + 3:shift + 3 + n]))

    C1 = jnp.uint32(2654435761)
    C2 = jnp.uint32(2246822519)
    C3 = jnp.uint32(3266489917)
    w0 = word(0)
    if width == 4:
        h = w0 * C1
    elif width == 5:
        h = (w0 * C1) ^ ((xp[..., 4:4 + n] * C2) << 11)
    elif width == 6:
        w1 = (xp[..., 4:4 + n] << 8) | xp[..., 5:5 + n]
        h = (w0 * C1) ^ (w1 * C2)
    elif width == 8:
        h = (w0 * C1) ^ (word(4) * C2) * C3
    else:
        raise ValueError(f"unsupported hash width {width}")
    return h >> (32 - hbits)


def candidates_hash(blocks: jnp.ndarray, lengths: jnp.ndarray,
                    widths: tuple[int, ...] = (4, 8), neighbors: int = 2,
                    window: int = 32768, chain_steps: int = 2,
                    est_in_len: bool = True
                    ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Single-word-sort candidate generation — the fast-path matcher.

    A sort of a SINGLE 32-bit operand moves a fraction of the bytes of a
    multi-operand lexicographic sort, so instead of carrying content
    words through the sort for exact LCP (candidates() above), this packs
    (hash<<pbits | pos) into one word per gram width. Equal-hash sorted
    neighbors claim "a width-byte match at offset pos-prev" with length =
    width; matches are *probabilistic* (hbits-bit hash, ~2^-17 false rate)
    and the host extension pass verifies real bytes and drops the rare
    false candidate — the sequences the host emits are always exact, the
    posture the reference takes with its accelerator's claimed sequences
    (compressAndVerify, src/qatseqprod.c:1245).

    The un-sort back to position order packs (pos<<obits | off) into one
    word as well. Window <= 64K keeps pos+off within 32 bits (the
    reference's LZ4s offsets are LE16-capped at 64K too,
    src/qatseqprod.c:1048).

    Returns (mlen, moff): mlen in {0, widths...} plus exact offset-1 runs.
    """
    B, N = blocks.shape
    assert window & (window - 1) == 0 and window <= 32768
    xi = blocks.astype(jnp.int32)
    nseg = 1
    if window < N:
        assert N % window == 0
        nseg = N // window
    R = B * nseg
    w = min(window, N)
    pbits = (w - 1).bit_length()   # pos (and off) bit width
    hbits = 32 - pbits
    pos = jnp.broadcast_to(
        jnp.arange(w, dtype=jnp.uint32)[None, :], (R, w))

    mlen = jnp.zeros((B, N), jnp.int32)
    moff = jnp.zeros((B, N), jnp.int32)
    for width in widths:
        h = _hash_width(xi, width, N, hbits)
        if nseg > 1:
            h = h.reshape(R, w)
        key = (h << pbits) | pos
        sk = jax.lax.sort((key,), dimension=1, is_stable=False,
                          num_keys=1)[0]
        sh = sk >> pbits
        sp = (sk & jnp.uint32(w - 1)).astype(jnp.int32)
        off_k = jnp.zeros((R, w), jnp.int32)
        for k in range(1, neighbors + 1):
            ph = jnp.concatenate(
                [jnp.full((R, k), 0xFFFFFFFF, jnp.uint32), sh[:, :-k]],
                axis=1)
            pp = jnp.concatenate(
                [jnp.zeros((R, k), jnp.int32), sp[:, :-k]], axis=1)
            eq = (sh == ph) & (pp < sp)
            # Nearest previous occurrence wins (k=1 is nearest by sort
            # order; k>1 only fills where closer neighbors missed).
            off_k = jnp.where((off_k == 0) & eq, sp - pp, off_k)
        # Un-sort via a second single-word sort keyed on position: pos
        # moves to the MSBs, the found offset rides the low bits
        # (off < 2^pbits <= 2^hbits free low bits since window <= 32K
        # keeps pbits <= 15 <= hbits).
        un = (sk << hbits) | off_k.astype(jnp.uint32)
        su = jax.lax.sort((un,), dimension=1, is_stable=False,
                          num_keys=1)[0]
        offs = (su & jnp.uint32((1 << pbits) - 1)).astype(jnp.int32)
        offs = offs.reshape(B, N) if nseg > 1 else offs
        # Claimed width must stay inside the block's valid bytes.
        gp = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :],
                              (B, N))
        offs = jnp.where(gp + width <= lengths[:, None].astype(jnp.int32),
                         offs, 0)
        # True-length estimation by same-offset chain doubling: if t and
        # t+width both claim offset d, bytes [t, t+2*width) match at d,
        # so LCP >= 2*width. Two doubling steps bound the estimate at
        # 4*width — enough for honest cross-width comparisons and the
        # cost filter (host extension recovers exact lengths).
        reach = (offs > 0).astype(jnp.int32)  # chain length in units of w
        span_units = 1
        for _ in range(chain_steps):
            shift = span_units * width
            nxt_off = jnp.concatenate(
                [offs[:, shift:], jnp.zeros((B, shift), jnp.int32)], axis=1)
            nxt_reach = jnp.concatenate(
                [reach[:, shift:], jnp.zeros((B, shift), jnp.int32)],
                axis=1)
            # Extend only fully-chained spans: t..t+shift must already be
            # covered before t+shift's own chain can be appended.
            cont = (offs > 0) & (reach == span_units) & (nxt_off == offs)
            reach = jnp.where(cont, reach + nxt_reach, reach)
            span_units *= 2
        est = reach * width
        # Merge across widths: longer estimated match first, then nearer
        # source — the same economics as the content matcher's score.
        better = (est > mlen) | ((est == mlen) & (offs > 0)
                                 & ((offs < moff) | (moff == 0)))
        take = (offs > 0) & better
        mlen = jnp.where(take, est if est_in_len else width, mlen)
        moff = jnp.where(take, offs, moff)

    # Cost filter: longer matches first, shorter ones only near (the
    # content matcher's tuned rule on estimated lengths).
    worth = ((mlen >= 7)
             | ((mlen >= 6) & (moff <= 32768))
             | ((mlen >= 5) & (moff <= 4096))
             | ((mlen >= 4) & (moff <= 256)))
    mlen = jnp.where(worth, mlen, 0)
    moff = jnp.where(worth, moff, 0)
    # Compact packings carry ml in 14 bits.
    mlen = jnp.minimum(mlen, 16383)

    # Offset-1 run augmentation (exact, crosses segments freely).
    idx = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (B, N))
    chg = jnp.concatenate(
        [xi[:, :-1] != xi[:, 1:], jnp.ones((B, 1), bool)], axis=1)
    run_end = jax.lax.cummin(
        jnp.where(chg, idx, BIG)[:, ::-1], axis=1)[:, ::-1]
    len1 = run_end - idx + 1
    blen_full = lengths[:, None].astype(jnp.int32)
    len1 = jnp.minimum(len1, blen_full - idx)
    # Cap so (ml, off) pairs survive the 14/16-bit compact packings;
    # longer runs chain at offset 1 and re-merge in the host coalesce.
    len1 = jnp.minimum(len1, 16383)
    prev_eq = jnp.concatenate(
        [jnp.zeros((B, 1), bool), xi[:, 1:] == xi[:, :-1]], axis=1)
    valid1 = prev_eq & (len1 >= MIN_MATCH)
    use1 = valid1 & (len1 > mlen)
    mlen = jnp.where(use1, len1, mlen)
    moff = jnp.where(use1, 1, moff)
    return mlen, moff


def compact_fast(chosen: jnp.ndarray, mlen: jnp.ndarray, moff: jnp.ndarray,
                 lengths: jnp.ndarray, max_seq: int, window: int):
    """Compaction via parallel single-word sorts.

    Two sorts share identical unique position keys in their high bits, so
    (is_stable=False) both produce the same order and each carries one
    payload field in its low bits — k payload words cost k fast sorts
    instead of one slow lexicographic sort. Requires ml <= 16383 (capped
    upstream) and off < window <= 64K.
    """
    B, N = chosen.shape
    req_seq = max_seq
    max_seq = min(max_seq, N)
    w = min(window, N)
    nseg = N // w
    R = B * nseg
    pbits = (w - 1).bit_length() + 1   # +1 for the not-chosen sentinel
    shift = 32 - pbits
    # Payload fields must fit below the position key: ml is capped at
    # 16383 upstream and off < window <= 32K, both < 2^shift (>= 2^16).
    assert shift >= 16, (w, shift)
    lw = jnp.broadcast_to(jnp.arange(w, dtype=jnp.uint32)[None, :], (R, w))
    ch = chosen.reshape(R, w)
    poskey = jnp.where(ch, lw, jnp.uint32(w))     # sentinel = w
    mls = mlen.reshape(R, w).astype(jnp.uint32)
    offs = moff.reshape(R, w).astype(jnp.uint32)
    sA = jax.lax.sort(((poskey << shift) | mls,), dimension=1,
                      is_stable=False, num_keys=1)[0]
    sB = jax.lax.sort(((poskey << shift) | offs,), dimension=1,
                      is_stable=False, num_keys=1)[0]
    capseg = min(w // MIN_MATCH, max_seq)
    segpos = (sA[:, :capseg] >> shift).astype(jnp.int32)
    segml = (sA[:, :capseg] & jnp.uint32((1 << shift) - 1)) \
        .astype(jnp.int32)
    segoff = (sB[:, :capseg] & jnp.uint32((1 << shift) - 1)) \
        .astype(jnp.int32)
    nseq = chosen.sum(axis=1).astype(jnp.int32)
    if nseg > 1:
        # Merge per-segment prefixes with small global parallel sorts.
        # Sentinel = N-1: a chosen position needs >= MIN_MATCH bytes of
        # match after it, so position N-1 can never start a sequence and
        # the sentinel needs no extra key bit (gshift stays >= 15, room
        # for ml <= 16383 and off < 32K).
        seg_start = ((jnp.arange(R, dtype=jnp.int32) % nseg) * w)[:, None]
        seg_cnt = ch.sum(axis=1).astype(jnp.int32)[:, None]
        valid = jnp.arange(capseg, dtype=jnp.int32)[None, :] < seg_cnt
        gpos = jnp.where(valid, segpos + seg_start, N - 1) \
            .astype(jnp.uint32)
        gbits = (N - 1).bit_length()
        gshift = 32 - gbits
        assert gshift >= 15, (N, gshift)
        M = nseg * capseg
        gpos = gpos.reshape(B, M)
        gml = jnp.where(valid, segml, 0).reshape(B, M).astype(jnp.uint32)
        goff = jnp.where(valid, segoff, 0).reshape(B, M) \
            .astype(jnp.uint32)
        gA = jax.lax.sort(((gpos << gshift) | gml,), dimension=1,
                          is_stable=False, num_keys=1)[0]
        gB = jax.lax.sort(((gpos << gshift) | goff,), dimension=1,
                          is_stable=False, num_keys=1)[0]
        take = min(max_seq, M)
        t2 = (gA[:, :take] >> gshift).astype(jnp.int32)
        l2 = (gA[:, :take] & jnp.uint32((1 << gshift) - 1)) \
            .astype(jnp.int32)
        o2 = (gB[:, :take] & jnp.uint32((1 << gshift) - 1)) \
            .astype(jnp.int32)
    else:
        take = min(max_seq, capseg)
        t2 = segpos[:, :take]
        l2 = segml[:, :take]
        o2 = segoff[:, :take]
    if take < max_seq:
        t2 = jnp.pad(t2, ((0, 0), (0, max_seq - take)))
        l2 = jnp.pad(l2, ((0, 0), (0, max_seq - take)))
        o2 = jnp.pad(o2, ((0, 0), (0, max_seq - take)))
    srow = jnp.broadcast_to(jnp.arange(max_seq, dtype=jnp.int32)[None, :],
                            (B, max_seq))
    valid = srow < nseq[:, None]
    prev_end = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), (t2 + l2)[:, :-1]], axis=1)
    lit = jnp.where(valid, t2 - prev_end, 0)
    ml = jnp.where(valid, l2, 0)
    off = jnp.where(valid, o2, 0)
    ends = jnp.where(valid, t2 + l2, 0)
    last_end = ends.max(axis=1)
    last_literals = lengths.astype(jnp.int32) - last_end
    overflow = nseq > max_seq
    if req_seq > max_seq:
        pad = req_seq - max_seq
        lit = jnp.pad(lit, ((0, 0), (0, pad)))
        off = jnp.pad(off, ((0, 0), (0, pad)))
        ml = jnp.pad(ml, ((0, 0), (0, pad)))
    return {
        "lit_len": lit, "offset": off, "match_len": ml,
        "nseq": jnp.minimum(nseq, max_seq), "last_literals": last_literals,
        "overflow": overflow,
    }


def parse_greedy_scan(mlen: jnp.ndarray, lazy: bool = False,
                      psegs: int = 1) -> jnp.ndarray:
    """Greedy parse via lax.scan over positions (the plain reference).

    mlen: (B, N) candidate lengths. Returns chosen: (B, N) bool.
    lazy=True applies the one-step lazy heuristic (defer when the next
    position has a strictly longer candidate), the vectorized analog of
    the golden matcher's lazy step. psegs > 1 parses each block as psegs
    independent segments and truncates candidates at segment ends (no
    match crosses into the next segment's cover).
    """
    B, N = mlen.shape
    assert N % psegs == 0, (N, psegs)
    R, n = B * psegs, N // psegs
    mlen = mlen.reshape(R, n)
    ts = jnp.arange(n, dtype=jnp.int32)
    mnext = jnp.concatenate(
        [mlen[:, 1:], jnp.zeros((R, 1), mlen.dtype)], axis=1)

    def body(cursor, xs):
        t, col, coln = xs
        if psegs > 1:
            col = jnp.minimum(col, n - t)
        active = cursor == t
        take = active & (col >= MIN_MATCH)
        if lazy:
            take = take & ~(coln > col)
        nxt = jnp.where(take, t + col, jnp.where(active, t + 1, cursor))
        return nxt, take

    _, taken = jax.lax.scan(body, jnp.zeros((R,), jnp.int32),
                            (ts, mlen.T, mnext.T))
    return taken.T.reshape(B, N)


def _segmented_sum(vals: jnp.ndarray, starts: jnp.ndarray) -> jnp.ndarray:
    """Inclusive sum along axis 1 resetting at segment starts."""
    def combine(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av + bv), af | bf

    out, _ = jax.lax.associative_scan(
        combine, (vals, starts.astype(bool)), axis=1)
    return out


def compact(chosen: jnp.ndarray, mlen: jnp.ndarray, moff: jnp.ndarray,
            lengths: jnp.ndarray, max_seq: int, coalesce: bool = False,
            window: int = 1 << 30, off_bits: int = 15):
    """Pack chosen matches into per-block sequence arrays (sort = scatter).

    coalesce=True merges chains of capped matches (zero-literal successors
    at the same offset) on device via segmented scans + one small sort —
    the device-side version of coalesce_sequences in the runtime, needed
    when the sequence section is also encoded on device.

    off_bits sizes the (ml, off) payload packing in the segmented path:
    15 fits window-local offsets (< 32768, ml <= 65535); the content+LDM
    path passes 18 (offsets < 256 KiB, ml <= 16383 — callers clamp).

    Returns dict with lit_len/offset/match_len (B, max_seq) int32,
    nseq (B,), last_literals (B,), overflow (B,) bool.
    """
    B, N = chosen.shape
    # A block of N bytes yields < N sequences, so cap the working width and
    # zero-pad the outputs back up to the caller's static max_seq.
    req_seq = max_seq
    max_seq = min(max_seq, N)
    idx = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (B, N))
    if window < N:
        # Segmented compaction: the greedy parse spaces chosen positions
        # >= MIN_MATCH apart, so a w-byte segment holds at most w/4
        # sequences — compact per segment (small fast sorts), then merge
        # the per-segment prefixes with one much smaller global sort.
        # Position order is preserved because segments tile the block.
        assert N % window == 0 and window <= 32768, window
        nseg = N // window
        capseg = window // MIN_MATCH
        lw = jnp.arange(window, dtype=jnp.int32)[None, :]
        ch = chosen.reshape(B * nseg, window)
        keyl = jnp.where(ch, jnp.broadcast_to(lw, ch.shape), BIG)
        # (ml, off) packed into one payload word (sizes per off_bits; the
        # top bit may land in the sign — payload order is irrelevant to
        # the sort and the unpack shifts logically). Global index
        # reconstructs as keyl + seg_start.
        pml = ((mlen.reshape(B * nseg, window) << off_bits)
               | moff.reshape(B * nseg, window))
        sk2, sp2 = jax.lax.sort((keyl, pml), dimension=1,
                                is_stable=False, num_keys=1)
        seg_start = ((jnp.arange(B * nseg, dtype=jnp.int32) % nseg)
                     * window)[:, None]
        sg2 = (sk2 + seg_start)[:, :capseg].reshape(B, nseg * capseg)
        sp2 = sp2[:, :capseg].reshape(B, nseg * capseg)
        seg_valid = (jnp.arange(capseg, dtype=jnp.int32)[None, :]
                     < ch.sum(axis=1).astype(jnp.int32)[:, None])
        seg_valid = seg_valid.reshape(B, nseg * capseg)
        gkey = jnp.where(seg_valid, sg2, BIG)
        t2, p2 = jax.lax.sort((gkey, sp2), dimension=1,
                              is_stable=False, num_keys=1)
        t2 = t2[:, :max_seq]
        # Arithmetic shift + mask == logical shift (the packed top bit
        # can sit in the sign).
        l2 = (p2[:, :max_seq] >> off_bits) & ((1 << (32 - off_bits)) - 1)
        o2 = p2[:, :max_seq] & ((1 << off_bits) - 1)
    else:
        key = jnp.where(chosen, idx, BIG)
        t2, l2, o2 = jax.lax.sort((key, mlen, moff), dimension=1,
                                  is_stable=False, num_keys=1)
        t2 = t2[:, :max_seq]
        l2 = l2[:, :max_seq]
        o2 = o2[:, :max_seq]
    nseq = chosen.sum(axis=1).astype(jnp.int32)
    srow = jnp.broadcast_to(jnp.arange(max_seq, dtype=jnp.int32)[None, :],
                            (B, max_seq))
    valid = srow < nseq[:, None]
    prev_end = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), (t2 + l2)[:, :-1]], axis=1)
    lit = jnp.where(valid, t2 - prev_end, 0)
    ml = jnp.where(valid, l2, 0)
    off = jnp.where(valid, o2, 0)
    ends = jnp.where(valid, t2 + l2, 0)
    last_end = ends.max(axis=1)
    last_literals = lengths.astype(jnp.int32) - last_end
    overflow = nseq > max_seq

    if coalesce:
        prev_off = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), off[:, :-1]], axis=1)
        same = valid & (lit == 0) & (off == prev_off) & (srow > 0)
        start = valid & ~same
        seg_lit = _segmented_sum(lit, start)   # == lit at the group start
        seg_ml = _segmented_sum(ml, start)
        nxt_start = jnp.concatenate(
            [start[:, 1:], jnp.ones((B, 1), bool)], axis=1)
        # The row after the last valid one is not a "start", so the final
        # group must be closed explicitly.
        is_end = valid & (nxt_start | (srow == nseq[:, None] - 1))
        # Compact group ends to the front, ordered by position.
        ckey = jnp.where(is_end, srow, BIG)
        _, lit, off, ml = jax.lax.sort(
            (ckey, seg_lit, off, seg_ml), dimension=1, is_stable=False,
            num_keys=1)
        nseq_m = start.sum(axis=1).astype(jnp.int32)
        valid_m = srow < nseq_m[:, None]
        lit = jnp.where(valid_m, lit, 0)
        off = jnp.where(valid_m, off, 0)
        ml = jnp.where(valid_m, ml, 0)
        nseq = nseq_m

    if req_seq > max_seq:
        pad = req_seq - max_seq
        lit = jnp.pad(lit, ((0, 0), (0, pad)))
        off = jnp.pad(off, ((0, 0), (0, pad)))
        ml = jnp.pad(ml, ((0, 0), (0, pad)))
    return {
        "lit_len": lit, "offset": off, "match_len": ml,
        "nseq": jnp.minimum(nseq, max_seq), "last_literals": last_literals,
        "overflow": overflow,
    }


def _parse(mlen: jnp.ndarray, lazy: bool = False) -> jnp.ndarray:
    from . import parse_kernel
    return parse_kernel.parse_greedy(mlen, lazy=lazy)


@functools.partial(jax.jit, static_argnames=("neighbors", "max_seq",
                                             "lazy", "window"))
def find_matches_batch(blocks: jnp.ndarray, lengths: jnp.ndarray,
                       neighbors: int = 4, max_seq: int = 16384,
                       lazy: bool = False, window: int = 1 << 30):
    """Full device pipeline in one jit: candidates -> parse -> compaction.

    Single-program form used by the sharded/pjit path. For large N prefer
    find_matches_staged: XLA's cross-stage fusion of the three stages blows
    compile time up by an order of magnitude with zero steady-state gain
    (each stage is HBM-bound through a sort anyway).
    """
    mlen, moff = candidates(blocks, lengths, neighbors, window=window)
    chosen = _parse(mlen, lazy)
    return compact(chosen, mlen, moff, lengths, max_seq, window=window)


@functools.partial(jax.jit, static_argnames=("neighbors", "stride",
                                             "window"))
def _candidates_jit(blocks, lengths, neighbors, stride=1, window=1 << 30):
    return candidates(blocks, lengths, neighbors, stride, window)


@functools.partial(jax.jit, static_argnames=("lazy",))
def _parse_jit(mlen, lazy=False):
    return _parse(mlen, lazy)


@functools.partial(jax.jit, static_argnames=("max_seq", "window"))
def _compact_jit(chosen, mlen, moff, lengths, max_seq, window=1 << 30):
    return compact(chosen, mlen, moff, lengths, max_seq, window=window)


def find_matches_staged(blocks, lengths, neighbors: int = 4,
                        max_seq: int = 16384, lazy: bool = False,
                        stride: int = 1, window: int = 1 << 30):
    """Stage-wise jit variant: same results as find_matches_batch with
    ~10x faster compilation at N=128K (each stage compiles independently;
    intermediates stay on device between stages)."""
    mlen, moff = _candidates_jit(blocks, lengths, neighbors, stride, window)
    chosen = _parse_jit(mlen, lazy)
    return _compact_jit(chosen, mlen, moff, lengths, max_seq, window)


def pack_outputs(out: dict, max_seq: int) -> jnp.ndarray:
    """Pack the compaction outputs into ONE (B, max_seq+1, 2) int32 array.

    All result fields ride a single device->host fetch (the analog of the
    reference's one CpaBufferList per request):
      row 0:   [nseq, last_literals << 1 | overflow]
      row s+1: [lit_len << 16 | match_len, offset]
    Match lengths are capped at 65535 on device (longer matches continue as
    chained same-offset sequences and re-merge in the host coalesce);
    blocks with a literal run > 65535 raise the overflow flag and take the
    CPU fallback path.
    """
    lit = out["lit_len"]
    ml = jnp.minimum(out["match_len"], 65535)
    lit_over = (lit > 65535).any(axis=1)
    overflow = out["overflow"] | lit_over
    word0 = (jnp.minimum(lit, 65535) << 16) | ml
    word1 = out["offset"]
    body = jnp.stack([word0, word1], axis=-1)          # (B, max_seq, 2)
    hdr0 = out["nseq"]
    hdr1 = (out["last_literals"] << 1) | overflow.astype(jnp.int32)
    hdr = jnp.stack([hdr0, hdr1], axis=-1)[:, None, :]  # (B, 1, 2)
    return jnp.concatenate([hdr, body], axis=1)


@functools.partial(jax.jit, static_argnames=("max_seq",))
def _pack_jit(out, max_seq):
    return pack_outputs(out, max_seq)


@functools.partial(jax.jit, static_argnames=("neighbors", "max_seq",
                                             "lazy", "stride",
                                             "window", "matcher", "widths",
                                             "ldm", "ldm_max_off"))
def find_matches_fused(blocks, lengths, neighbors: int = 4,
                       max_seq: int = 16384, lazy: bool = False,
                       stride: int = 1, window: int = 1 << 30,
                       matcher: str = "content", widths: tuple = (4, 8),
                       ldm: int = 0, ldm_max_off: int = 1 << 18):
    """Whole pipeline + packing as ONE jit dispatch (the staged variant
    compiles faster; this one pays one dispatch per batch).

    matcher="hash" takes the single-word-sort fast path (candidates_hash +
    compact_fast: quantized claim lengths, host-verified); "content"
    carries content words through the sorts for exact LCP. ldm > 0 folds
    minimizer long-distance candidates (offsets < min(ldm_max_off, 256K))
    into the content candidate plane before the parse — the deep levels'
    answer to stock zstd's multi-megabyte windows (their local window is
    segment-bound at 32K)."""
    if matcher == "hash":
        mlen, moff = candidates_hash(blocks, lengths, widths=widths,
                                     neighbors=neighbors, window=window)
        chosen = _parse(mlen, lazy)
        out = compact_fast(chosen, mlen, moff, lengths, max_seq, window)
    else:
        mlen, moff = candidates(blocks, lengths, neighbors, stride, window)
        off_bits = 15
        if ldm:
            from . import glue_kernels
            # (1 << 18) - 1, not 1 << 18: _ldm_est's window test is
            # inclusive, and an offset of exactly 2^18 would set bit 18
            # — the packed payload's ml LSB (off-by-one found in review).
            max_off = min(ldm_max_off, (1 << 18) - 1)
            su_l = glue_kernels.ldm_unsorted(blocks, ldm, neighbors=1)
            mlen, moff = glue_kernels.merge_ldm(
                mlen, moff, su_l, lengths, ldm, local_cap=LCP_CAP,
                max_off=max_off)
            if window < blocks.shape[1]:
                # Only the segmented compact packs (ml << 18 | off);
                # the unsegmented path keeps int32 operands, where the
                # clamp would just fragment long matches.
                mlen = jnp.minimum(mlen, 16383)
                off_bits = 18
        chosen = _parse(mlen, lazy)
        out = compact(chosen, mlen, moff, lengths, max_seq, window=window,
                      off_bits=off_bits)
    return pack_outputs(out, max_seq)


def find_matches_packed(blocks, lengths, neighbors: int = 4,
                        max_seq: int = 16384, fused: bool = False,
                        lazy: bool = False, stride: int = 1,
                        window: int = 1 << 30, matcher: str = "content",
                        widths: tuple = (4, 8), ldm: int = 0,
                        ldm_max_off: int = 1 << 18):
    """Packed-result pipeline: one fused dispatch for the hash matcher,
    LDM, or fused=True; the staged (faster-compiling) chain otherwise."""
    if ldm and blocks.shape[0] % ldm:
        ldm = 0  # spans need whole block groups; partial batches skip LDM
    if fused or matcher == "hash" or ldm:
        return find_matches_fused(blocks, lengths, neighbors=neighbors,
                                  max_seq=max_seq, lazy=lazy,
                                  stride=stride, window=window,
                                  matcher=matcher, widths=tuple(widths),
                                  ldm=ldm, ldm_max_off=ldm_max_off)
    out = find_matches_staged(blocks, lengths, neighbors, max_seq, lazy,
                              stride, window)
    return _pack_jit(out, max_seq)


@functools.partial(jax.jit, static_argnames=("max_seq", "window"))
def _compact_coalesce_jit(chosen, mlen, moff, lengths, max_seq,
                          window=1 << 30):
    return compact(chosen, mlen, moff, lengths, max_seq, coalesce=True,
                   window=window)


@functools.partial(jax.jit, static_argnames=("max_seq",))
def _pack_wide_jit(out, max_seq):
    """Full-width (lit, ml) packing for the device-entropy path: offsets
    stay on device (the section owns them), so both words are free for
    uncapped lengths — no u16 overflow cases."""
    hdr0 = out["nseq"]
    hdr1 = (out["last_literals"] << 1) | out["overflow"].astype(jnp.int32)
    hdr = jnp.stack([hdr0, hdr1], axis=-1)[:, None, :]
    body = jnp.stack([out["lit_len"], out["match_len"]], axis=-1)
    return jnp.concatenate([hdr, body], axis=1)


def unpack_outputs_wide(packed: np.ndarray) -> dict:
    packed = np.asarray(packed)
    hdr = packed[:, 0, :]
    return {
        "nseq": hdr[:, 0],
        "last_literals": (hdr[:, 1] >> 1).astype(np.int64),
        "overflow": (hdr[:, 1] & 1).astype(bool),
        "lit_len": packed[:, 1:, 0].astype(np.int64),
        "match_len": packed[:, 1:, 1].astype(np.int64),
    }


def find_matches_with_seqsec(blocks, lengths, neighbors: int = 4,
                             max_seq: int = 16384,
                             lazy: bool = False, seq_words: int = 8192,
                             stride: int = 1, window: int = 1 << 30,
                             custom_tables: bool = True,
                             device_literals: bool = True):
    """Pipeline + on-device FSE sequence-section encoding (hybrid entropy:
    the accelerator emits finished Sequences_Section bitstreams, the host
    adds literals sections — shrinking the device->host return path to the
    compressed stream plus per-block (lit, ml) metadata).

    Sequences are coalesced on device (segmented scans) before encoding;
    host extension does not apply (the section is final) — the static-path
    trade the QAT hardware makes. Returns (packed, words, bits, overflow).
    """
    from . import fse_kernel
    mlen, moff = _candidates_jit(blocks, lengths, neighbors, stride, window)
    chosen = _parse_jit(mlen, lazy)
    out = _compact_coalesce_jit(chosen, mlen, moff, lengths, max_seq, window)
    words, bits, sec_over, plan = fse_kernel.encode_sequence_sections(
        out["lit_len"], out["offset"], out["match_len"], out["nseq"],
        max_words=seq_words, custom=custom_tables)
    packed = _pack_wide_jit(out, max_seq)
    lits = None
    if device_literals:
        from . import literals_kernel
        lits = literals_kernel.encode_literals_device(
            blocks, lengths, chosen, mlen)
    return packed, words, bits, sec_over, plan, lits


def find_matches_with_seqsec_hash(blocks, lengths, neighbors: int = 2,
                                  max_seq: int = 16384,
                                  lazy: bool = False, seq_words: int = 8192,
                                  window: int = 32768,
                                  custom_tables: bool = True,
                                  device_literals: bool = True):
    """Device-entropy pipeline on the BYTE-VERIFIED hash path: the gram
    rides the first sort (glue_kernels.candidates_hash_verified), so
    every (mlen, moff) is a true match — exact enough to encode FSE
    sections on device with no host pass — at hash-path speeds (one
    2-key sort + one fast single-word sort vs the content matcher's
    5-operand stable sort). Lengths quantize to 4-byte units (offset-1
    runs stay exact): the throughput/ratio trade the QAT hardware's
    static-Huffman config makes (src/qatseqprod.c:935-946)."""
    from . import fse_kernel
    from . import glue_kernels
    mlen, moff = glue_kernels.candidates_hash_verified(
        blocks, lengths, neighbors=neighbors, window=window)
    chosen = _parse_jit(mlen, lazy)
    out = _compact_coalesce_jit(chosen, mlen, moff, lengths, max_seq,
                                window)
    words, bits, sec_over, plan = fse_kernel.encode_sequence_sections(
        out["lit_len"], out["offset"], out["match_len"], out["nseq"],
        max_words=seq_words, custom=custom_tables)
    packed = _pack_wide_jit(out, max_seq)
    lits = None
    if device_literals:
        from . import literals_kernel
        lits = literals_kernel.encode_literals_device(
            blocks, lengths, chosen, mlen)
    return packed, words, bits, sec_over, plan, lits


def find_matches_positions(blocks, lengths, widths=(6,), neighbors: int = 1,
                           window: int = 32768, lazy: bool = False,
                           psegs: int = 1, ldm: int = 0,
                           ldm_max_off: int = 1 << 19,
                           dense: bool = False, sync: bool = False):
    """Hash-matcher pipeline, segment-slots device->host contract (see
    glue_kernels.find_matches_positions); the production fast-level
    path. ldm > 0 adds long-distance candidates over ldm-block spans;
    dense=True claims every candidate slot and lets the host extension
    walk parse; sync=True pair-samples anchors content-determined (half
    the sort volume, the fastest speed point)."""
    from . import glue_kernels
    if ldm and blocks.shape[0] % ldm:
        ldm = 0  # spans need whole block groups; partial batches skip LDM
    return glue_kernels.find_matches_positions(
        blocks, lengths, widths=tuple(widths), neighbors=neighbors,
        window=window, lazy=lazy, psegs=psegs, ldm=ldm,
        ldm_max_off=ldm_max_off, dense=dense, sync=sync)


def unpack_segments(slot_keys: np.ndarray, nblocks: int, window: int
                    ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Host-side unpack of the segment-slots contract.

    slot_keys: (nblocks*nseg, w/4) u32; slot i of a row holds either that
    4-byte slot's claim as (subslot_k << 30 | byte_offset) — the claim
    position is 4*i + k — or the empty sentinel 0xFFFFFFFF. Slot index ==
    position order, so a row-major mask-select yields claims in
    block-position order directly (segments tile the block); no
    device-side sort is required. Offsets are raw bytes (local OR
    long-distance, up to 30 bits). Returns per block (positions,
    offsets).
    """
    sk = np.asarray(slot_keys)
    R, ws = sk.shape
    nseg = R // nblocks
    w = ws * 4
    rows, cols = np.nonzero(sk != np.uint32(0xFFFFFFFF))
    vals = sk[rows, cols]
    pos = (cols.astype(np.int64) * 4 + (vals >> 30)
           + (rows.astype(np.int64) % nseg) * w)
    off = (vals & 0x3FFFFFFF).astype(np.int64)
    counts = np.bincount(rows // nseg, minlength=nblocks)
    splits = np.cumsum(counts)[:-1]
    return list(zip(np.split(pos, splits), np.split(off, splits)))


def unpack_outputs(packed: np.ndarray) -> dict:
    """Host-side unpack of pack_outputs (vectorized numpy)."""
    packed = np.asarray(packed)
    hdr = packed[:, 0, :]
    word0 = packed[:, 1:, 0].astype(np.int64) & 0xFFFFFFFF
    return {
        "nseq": hdr[:, 0],
        "last_literals": (hdr[:, 1] >> 1).astype(np.int64),
        "overflow": (hdr[:, 1] & 1).astype(bool),
        "lit_len": (word0 >> 16).astype(np.int64),
        "match_len": (word0 & 0xFFFF).astype(np.int64),
        "offset": packed[:, 1:, 1].astype(np.int64),
    }
