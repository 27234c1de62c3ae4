"""Stages of the hash-matcher positions pipeline, as whole-array XLA code.

The fast levels run key build -> sort -> neighbor/un-sort -> sort ->
finalize/compaction over (B, N) block batches:

  keys:     block bytes -> packed (hash << pbits | pos) sort keys, per width
  neighbor: sorted keys -> nearest-equal-hash offsets -> un-sort keys
  finalize: un-sorted offsets (all widths) + block bytes -> chain-doubled
            length estimates, cross-width merge, offset-1 run scan, cost
            filter -> (mlen, moff)
  compact:  (mlen, moff) (+ LDM claims) -> segment slot words

Each stage is a per-row elementwise, shift and min-doubling pass; shifts
are slice + pad. Semantics are identical to
match_pipeline.candidates_hash (differential tests); the whole pipeline
is one jitted program (find_matches_positions).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .match_pipeline import MIN_MATCH, _hash_width

EMPTY = 0xFFFFFFFF  # empty slot word / min-reduction identity (u32)


def _shl(a: jnp.ndarray, s: int, fill) -> jnp.ndarray:
    """Element i <- a[:, i+s] along axis 1 (tail = fill)."""
    n = a.shape[1]
    if s >= n:
        return jnp.full_like(a, fill)
    return jnp.pad(a[:, s:], ((0, 0), (0, s)), constant_values=fill)


def _shr(a: jnp.ndarray, s: int, fill) -> jnp.ndarray:
    """Element i <- a[:, i-s] along axis 1 (head = fill)."""
    n = a.shape[1]
    if s >= n:
        return jnp.full_like(a, fill)
    return jnp.pad(a[:, :n - s], ((0, 0), (s, 0)), constant_values=fill)


def _winmin(h8: jnp.ndarray, stride: int) -> jnp.ndarray:
    """Windowed-minimum doubling over an 8-byte-gram hash plane: entry i
    becomes min over [i, i+stride). Shared by the minimizer heads
    (ldm_winmin, hash_keys_winmin_sync)."""
    m = h8
    s = 1
    while s < stride:
        m = jnp.minimum(m, _shl(m, s, jnp.uint32(EMPTY)))
        s *= 2
    return m


def _h8(blocks: jnp.ndarray) -> jnp.ndarray:
    """Full 32-bit hash of the 8-byte gram at each position."""
    n = blocks.shape[1]
    return _hash_width(blocks.astype(jnp.int32), 8, n, 32)


def _packed_keys(blocks: jnp.ndarray, width: int, window: int):
    """(hash << pbits | segment pos) keys in (B, N) layout, plus the
    fields the callers need."""
    B, N = blocks.shape
    w = min(window, N)
    pbits = (w - 1).bit_length()
    h = _hash_width(blocks.astype(jnp.int32), width, N, 32 - pbits)
    pos = jax.lax.broadcasted_iota(jnp.uint32, (B, N), 1) \
        & jnp.uint32(w - 1)
    return h, pos, w, pbits


@functools.partial(jax.jit, static_argnames=("width", "window"))
def hash_keys(blocks: jnp.ndarray, width: int, window: int) -> jnp.ndarray:
    """(B, N) uint8 -> (B*nseg, w) uint32 packed (hash << pbits | segment
    pos) sort keys, one row per window segment."""
    B, N = blocks.shape
    h, pos, w, pbits = _packed_keys(blocks, width, window)
    return ((h << pbits) | pos).reshape(B * (N // w), w)


@functools.partial(jax.jit, static_argnames=("width", "window", "stride"))
def hash_keys_winmin_sync(blocks: jnp.ndarray, width: int, window: int,
                          stride: int):
    """Pair-syncmer anchor selection + the LDM minimizer plane, sharing
    the 8-byte-gram hash.

    Full-resolution anchoring sorts one key per byte; this selects one
    anchor per byte PAIR by ARGMIN PARITY: the member whose lane parity
    matches the parity of the windowed (SEL_W=4) h8 argmin — a
    content-determined winnowing rule, like the LDM sampler's minimizer
    at stride 32+. Selection depends on content AND the pair grid, so
    co-selection across two copies is probabilistic, not guaranteed:
    ~1/2 per content position at even offsets (aligned grids), ~0.40 at
    odd (the sliding argmin's relative parity nearly alternates; SEL_W=2
    degenerates to picking the smaller h8 of the pair, which co-selects
    only positions beating BOTH neighbors — the provable 1/3 ceiling for
    window-2 rules). Never zero, where fixed-grid stride-2 sampling is
    structurally blind to odd offsets entirely (measured 1.25x stock
    ratio, rejected). SEL_W choice is empirical: iid-hash co-selection
    keeps rising with the window (0.444 at 8, -> 1/2), but end-to-end
    ratio optimizes at 4 (measured L1 frames: SEL_W=2 1.0175x stock,
    4 = 1.0160x and consistently smaller on every probe corpus, 8 =
    1.0209x — longer windows desync selection near content boundaries
    faster than co-selection pays). tests/test_sync.py pins the
    properties. Both dominant sort volumes halve.

    Returns ((B*nseg, w/2) pair-selection keys, (B, N) windowed-minimizer
    plane for the LDM head, or None when stride == 0). Entry p holds
    (hash(sel) << pbits | sel) with sel in {2p, 2p+1} (segment-local)."""
    assert stride & (stride - 1) == 0  # stride 0: skip the LDM plane
    B, N = blocks.shape
    h, pos, w, pbits = _packed_keys(blocks, width, window)
    h8 = _h8(blocks)
    # Pair selection by ARGMIN PARITY: parity rides the low bit of the
    # minimized value (hash low bit cleared), so a log-depth doubling min
    # extracts the window-argmin parity without materializing the argmin.
    par = jax.lax.broadcasted_iota(jnp.uint32, (B, N), 1) & jnp.uint32(1)
    v = (h8 & jnp.uint32(0xFFFFFFFE)) | par
    for s in (1, 2):  # SEL_W = 4
        v = jnp.minimum(v, _shl(v, s, jnp.uint32(EMPTY)))
    pick_next = (v & 1) == 1
    selh = jnp.where(pick_next, _shl(h, 1, jnp.uint32(0)), h)
    selp = jnp.where(pick_next, pos + 1, pos)
    key = ((selh << pbits) | selp).reshape(B * (N // w), w)[:, ::2]
    minz = _winmin(h8, stride) if stride else None
    return key, minz


@functools.partial(jax.jit, static_argnames=("window",))
def gram_pos_planes(blocks: jnp.ndarray, window: int):
    """(B, N) uint8 -> ((B*nseg, w) 4-byte grams, (B*nseg, w) positions).

    The verified-matcher head (device-entropy hash path): sorting by the
    RAW GRAM (lexicographic (gram, pos), no hash) groups equal grams
    exactly, so the neighbor pass's equality is TRUE byte equality —
    every emitted candidate is a real >= 4-byte match, like the content
    matcher but with one carried word instead of four."""
    B, N = blocks.shape
    w = min(window, N)
    x = blocks.astype(jnp.uint32)
    g = ((x << 24) | (_shl(x, 1, jnp.uint32(0)) << 16)
         | (_shl(x, 2, jnp.uint32(0)) << 8) | _shl(x, 3, jnp.uint32(0)))
    pos = jax.lax.broadcasted_iota(jnp.uint32, (B, N), 1) \
        & jnp.uint32(w - 1)
    R = B * (N // w)
    return g.reshape(R, w), pos.reshape(R, w)


def _sort_rows2(g, pos):
    """Lexicographic (gram, pos) row sort. Keys are unique per row (pos
    is), so the unstable sort's order is fully determined."""
    return jax.lax.sort((g, pos), dimension=1, is_stable=False,
                        num_keys=2)


def _sort_rows(x):
    """Single-word row sort (keys carry a unique position field)."""
    return jax.lax.sort((x,), dimension=1, is_stable=False, num_keys=1)[0]


@functools.partial(jax.jit, static_argnames=("pbits", "neighbors"))
def neighbor_verify_keys(sg: jnp.ndarray, sp: jnp.ndarray, pbits: int,
                         neighbors: int = 1) -> jnp.ndarray:
    """Sorted (grams, positions) -> un-sort keys (pos << hbits | offset)
    where the claimed offset is BYTE-VERIFIED: the k-th previous entry
    must carry an EQUAL 4-byte gram (sorted by gram, so equal grams are
    adjacent and position-ordered). Downstream chain-doubling over these
    claims composes true equalities, so every emitted length is exact in
    4-byte units — the property the on-device entropy encoder needs (no
    host verification pass exists in that mode)."""
    hbits = 32 - pbits
    off = jnp.zeros_like(sp)
    for k in range(1, neighbors + 1):
        pg = _shr(sg, k, jnp.uint32(EMPTY))
        pp = _shr(sp, k, jnp.uint32(0))
        # Tail-gram guard: equal grams that are both zero-extended past
        # the block end would "verify" padding; finalize's gp + 4 <= blen
        # mask drops those probes.
        eq = (sg == pg) & (pp < sp)
        off = jnp.where((off == 0) & eq, sp - pp, off)
    return (sp << hbits) | off


def _run_len1(x: jnp.ndarray, blen: jnp.ndarray, gp: jnp.ndarray):
    """Offset-1 runs: exact run lengths from the byte-compare scan.
    run_end = suffix-min of change indices by doubling (cap 16383 keeps
    14 steps enough; fewer on short rows). Returns (len1, prev_eq)."""
    N = x.shape[1]
    big = jnp.int32(2 ** 30)
    chg = x != _shl(x, 1, -1)        # next byte (-1 sentinel: change)
    r = jnp.where(chg, gp, big)
    step = 1
    for _ in range(min(14, max(1, (N - 1).bit_length()))):
        r = jnp.minimum(r, _shl(r, step, big))
        step *= 2
    len1 = jnp.minimum(jnp.minimum(r - gp + 1, blen - gp), 16383)
    prev_eq = x == _shr(x, 1, -1)    # previous byte (-1: no match)
    return len1, prev_eq


def _chain_reach(offs: jnp.ndarray, unit: int, chain_steps: int):
    """Same-offset chain doubling: reach counts consecutive unit-spaced
    claims sharing the offset (estimate = reach * unit)."""
    reach = (offs > 0).astype(jnp.int32)
    span_units = 1
    for _ in range(chain_steps):
        shift = span_units * unit
        nxt_off = _shl(offs, shift, 0)
        nxt_reach = _shl(reach, shift, 0)
        cont = (offs > 0) & (reach == span_units) & (nxt_off == offs)
        reach = jnp.where(cont, reach + nxt_reach, reach)
        span_units *= 2
    return reach


@functools.partial(jax.jit, static_argnames=("window", "chain_steps",
                                             "far_min", "near_off"))
def finalize_verified(su: jnp.ndarray, blocks: jnp.ndarray,
                      lengths: jnp.ndarray, window: int,
                      chain_steps: int = 3, far_min: int = 4,
                      near_off: int = 32768):
    """Position-ordered verified claims -> exact (mlen, moff).

    Claims arrive byte-verified for 4 bytes (neighbor_verify_keys);
    chain-doubling over SAME-OFFSET claims at +4-byte steps composes
    them into exact lengths in 4-byte units (claim at t and t+4 with
    offset o means bytes [t, t+8) truly equal). Offset-1 runs keep
    exact arbitrary lengths from the byte-compare scan. Unlike
    finalize_candidates' estimates, every output here is a true match —
    safe to encode on device with no host pass."""
    B, N = blocks.shape
    w = min(window, N)
    omask = (1 << (w - 1).bit_length()) - 1
    blen = lengths.astype(jnp.int32)[:, None]
    gp = jax.lax.broadcasted_iota(jnp.int32, (B, N), 1)
    offs = (su & omask).astype(jnp.int32).reshape(B, N)
    offs = jnp.where(gp + 4 <= blen, offs, 0)
    mlen = _chain_reach(offs, 4, chain_steps) * 4
    moff = offs
    # Default = take every verified match (far_min=4, near_off=w):
    # swept on the mixed corpus — filters LOSE ratio here because every
    # claim is already a true match and the FSE tables absorb short-match
    # codes well (0.2886 unfiltered vs 0.3012 filtered).
    worth = (mlen >= far_min) | ((mlen >= 4) & (moff <= near_off))
    mlen = jnp.minimum(jnp.where(worth, mlen, 0), 16383)
    moff = jnp.where(worth, moff, 0)
    len1, prev_eq = _run_len1(blocks.astype(jnp.int32), blen, gp)
    use1 = prev_eq & (len1 >= 4) & (len1 > mlen)
    return jnp.where(use1, len1, mlen), jnp.where(use1, 1, moff)


@functools.partial(jax.jit, static_argnames=("neighbors", "window",
                                             "chain_steps", "far_min",
                                             "near_off"))
def candidates_hash_verified(blocks: jnp.ndarray, lengths: jnp.ndarray,
                             neighbors: int = 2, window: int = 32768,
                             chain_steps: int = 3, far_min: int = 4,
                             near_off: int = 32768):
    """Byte-verified hash-path candidates: every (mlen, moff) is a true
    match (2-key sort -> verify -> un-sort -> exact finalize). The
    device-entropy matcher for fast levels."""
    B, N = blocks.shape
    pbits = (min(window, N) - 1).bit_length()
    sg, sp = _sort_rows2(*gram_pos_planes(blocks, window))
    su = _sort_rows(neighbor_verify_keys(sg, sp, pbits, neighbors))
    return finalize_verified(su, blocks, lengths, window,
                             chain_steps=chain_steps, far_min=far_min,
                             near_off=near_off)


@functools.partial(jax.jit, static_argnames=("pbits", "neighbors",
                                             "pos_mask"))
def neighbor_unsort_keys(sk: jnp.ndarray, pbits: int, neighbors: int = 1,
                         pos_mask: int | None = None) -> jnp.ndarray:
    """Sorted keys (R, w) -> un-sort keys (pos << hbits | offset): the
    nearest previous equal-hash entry claims offset pos - prev.

    pos_mask overrides the position-field mask when the row holds fewer
    entries than position values (the syncmer rows carry one entry per
    byte PAIR, so w/2 entries span w positions)."""
    hbits = 32 - pbits
    pmask = pos_mask if pos_mask is not None else sk.shape[1] - 1
    sh = sk >> pbits
    sp = sk & pmask
    off = jnp.zeros_like(sk)
    for k in range(1, neighbors + 1):
        ph = _shr(sh, k, jnp.uint32(EMPTY))
        pp = _shr(sp, k, jnp.uint32(0))
        eq = (sh == ph) & (pp < sp)
        off = jnp.where((off == 0) & eq, sp - pp, off)
    return (sk << hbits) | off


@functools.partial(jax.jit, static_argnames=("widths", "window",
                                             "chain_steps"))
def finalize_candidates(sus: tuple, blocks: jnp.ndarray,
                        lengths: jnp.ndarray, widths: tuple, window: int,
                        chain_steps: int = 2):
    """Per-width un-sorted key arrays + block bytes -> (mlen, moff).

    Chain-doubled true-length estimation, cross-width merge (longer est
    first, then nearer), offset-1 run scan (exact, 14-step doubling),
    and the cost filter — candidates_hash semantics."""
    B, N = blocks.shape
    w = min(window, N)
    omask = (1 << (w - 1).bit_length()) - 1
    blen = lengths.astype(jnp.int32)[:, None]
    gp = jax.lax.broadcasted_iota(jnp.int32, (B, N), 1)
    mlen = jnp.zeros((B, N), jnp.int32)
    moff = jnp.zeros((B, N), jnp.int32)
    for su, width in zip(sus, widths):
        offs = (su & omask).astype(jnp.int32).reshape(B, N)
        offs = jnp.where(gp + width <= blen, offs, 0)
        est = _chain_reach(offs, width, chain_steps) * width
        better = (est > mlen) | ((est == mlen) & (offs > 0)
                                 & ((offs < moff) | (moff == 0)))
        take = (offs > 0) & better
        mlen = jnp.where(take, est, mlen)
        moff = jnp.where(take, offs, moff)
    worth = ((mlen >= 7)
             | ((mlen >= 6) & (moff <= 32768))
             | ((mlen >= 5) & (moff <= 4096))
             | ((mlen >= 4) & (moff <= 256)))
    mlen = jnp.minimum(jnp.where(worth, mlen, 0), 16383)
    moff = jnp.where(worth, moff, 0)
    len1, prev_eq = _run_len1(blocks.astype(jnp.int32), blen, gp)
    use1 = prev_eq & (len1 >= 4) & (len1 > mlen)
    return jnp.where(use1, len1, mlen), jnp.where(use1, 1, moff)


def _unsorted(key: jnp.ndarray, pbits: int, neighbors: int,
              pos_mask: int | None = None) -> jnp.ndarray:
    """sort -> nearest-equal-hash neighbor -> un-sort."""
    return _sort_rows(neighbor_unsort_keys(_sort_rows(key), pbits,
                                           neighbors, pos_mask=pos_mask))


@functools.partial(jax.jit, static_argnames=("widths", "neighbors",
                                             "window", "chain_steps"))
def candidates_hash_split(blocks: jnp.ndarray, lengths: jnp.ndarray,
                          widths: tuple = (5, 8), neighbors: int = 1,
                          window: int = 32768, chain_steps: int = 2):
    """candidates_hash composed from this module's stages (key build ->
    sort -> neighbor/un-sort -> sort per width, then finalize). Same
    results as match_pipeline.candidates_hash."""
    B, N = blocks.shape
    pbits = (min(window, N) - 1).bit_length()
    sus = tuple(_unsorted(hash_keys(blocks, width, window), pbits,
                          neighbors) for width in widths)
    return finalize_candidates(sus, blocks, lengths, tuple(widths),
                               window, chain_steps)


# ---------------------------------------------------------------------------
# Positions contract (the hash fast path's lean device->host protocol).
#
# The host extension pass (native qz_extend_sequences) recomputes every
# match's TRUE length by byte comparison regardless of the claimed length,
# so carrying lengths off the device is pure waste for the hash matcher:
# the device sends only (position, offset) per chosen claim and the host
# reconstructs (lit_len, offset, MIN_MATCH) claims, which extension turns
# into exact sequences. This removes one of the two full-size compaction
# sorts and halves the merge sorts.
#
# Second win: the greedy parse spaces chosen positions >= MIN_MATCH (=4)
# apart, so each aligned 4-byte slot holds at most one claim — the
# compaction runs on an N/4 slot grid (4x fewer elements) built by a
# windowed min over the four subslots.
# ---------------------------------------------------------------------------


def _slot_min(claims, offs) -> jnp.ndarray:
    """Per 4-byte slot, the smallest (k << 30 | offset) word over the
    claimed subslots k (EMPTY when none). claims/offs: 4 x (B, N/4)."""
    best = jnp.uint32(EMPTY)
    for k in range(4):
        key = (jnp.uint32(k) << 30) | offs[k].astype(jnp.uint32)
        best = jnp.minimum(best, jnp.where(claims[k], key,
                                           jnp.uint32(EMPTY)))
    return best


@functools.partial(jax.jit, static_argnames=("window",))
def compact_slots(chosen: jnp.ndarray, moff: jnp.ndarray, window: int):
    """(B, N) parse outputs -> (B*nseg, w/4) u32 slot words.

    Slot word: real claim -> (k << 30) | byte_offset   (pos = 4*slot + k)
               empty slot -> 0xFFFFFFFF
    The slot index IS the position (the parse spaces claims >= MIN_MATCH
    = 4 apart, so each aligned 4-byte slot holds at most one claim); only
    the 2-bit subslot k and the offset ride in the word, leaving 30 bits
    of RAW byte offset — enough for segment windows up to 64K+ and
    unquantized long-distance offsets (merge_ldm) alike. No device-side
    sort: the host mask-selects non-sentinel words row-major
    (unpack_segments).
    """
    B, N = chosen.shape
    w = min(window, N)
    best = _slot_min([chosen[:, k::4] != 0 for k in range(4)],
                     [moff[:, k::4] for k in range(4)])
    return best.reshape(B * (N // w), w // 4)


# ---------------------------------------------------------------------------
# Long-distance matching (LDM): the device window above is segment-local
# (32K), so the hash matcher is structurally blind to redundancy at longer
# range — cross-segment inside a block and cross-block inside a batch.
# Stock zstd sees both through its streaming window; this is the device
# answer (the role zstd's own --long/LDM mode plays, generalized to the
# batch buffer).
#
# Design: blocks are CONSECUTIVE stream bytes within a batch (tpu_codec
# feeds sorted full-block runs). Rows of `sb` adjacent blocks (sb=4 -> a
# 512 KiB "span") are each paired with the PREVIOUS span as sliding
# context, so every position effectively sees up to 512 KiB back — the
# same back-reach stock zstd's L1 window (window_log 19) gives its
# streaming matcher. Sample 8-byte grams every 32 bytes over [prev span |
# span] and reuse the exact single-word-sort machinery of the short-range
# path on the combined rows: key = (hash17 << 15 | sample_idx), sort,
# nearest-previous-equal-hash, un-sort. A candidate is accepted only when
# >= 2 CONSECUTIVE samples agree on the same sample offset (a 64-byte
# chained check that makes hash-collision false positives ~2^-34), then
# competes in the parse against the local candidates with its chained
# length estimate. Offsets ride the slot contract's free bit 15 as
# (0x8000 | byte_off >> 4) — sampled positions are 32-aligned so the
# quantized offset is EXACT, up to 512 KiB (always inside the frame
# window: window_log >= 19 at every level). The host extension pass
# byte-verifies and extends each claim against the cross-block window
# context it already receives, so LDM adds zero new trust surface; a
# first-span claim that reaches bytes the device never saw (the zero
# context pad) simply fails verification and degrades to literals.
# ---------------------------------------------------------------------------

def ldm_stride(span_blocks: int, n: int) -> int:
    """Sample spacing that keeps the combined row at <= 65536 samples so
    the packed keys keep >= 16 hash bits (the two-consecutive-sample
    chain requirement keeps false candidates rare even at 16 bits)."""
    s = 32
    while 2 * span_blocks * (n // s) > 65536:
        s *= 2
    return s


@functools.partial(jax.jit, static_argnames=("stride",))
def ldm_winmin(blocks: jnp.ndarray, stride: int) -> jnp.ndarray:
    """(B, N) uint8 -> (B, N) uint32: windowed MINIMIZER hash — entry i
    holds min over [i, i+stride) of the 8-byte-gram hash.

    Grid sampling alone only discovers repeats whose distance is a
    multiple of the stride (the grams at two grid points of a shifted
    copy differ). Minimizers are the standard alignment-robust sampler
    (winnowing): matching content picks the same minimum regardless of
    where the grid falls, so two copies at ANY distance produce equal
    sampled hashes. The slot-quantized offset is then exact to +-1 slot,
    which the host extension's slide probe resolves."""
    assert stride & (stride - 1) == 0
    return _winmin(_h8(blocks), stride)


@functools.partial(jax.jit, static_argnames=("span_blocks", "stride"))
def ldm_keys(minz: jnp.ndarray, span_blocks: int = 4,
             stride: int = 32) -> jnp.ndarray:
    """(B, N) minimizer hashes -> (B/span_blocks, 2*span_samples) uint32
    packed (hash << pbits | combined sample index) LDM sort keys. Each
    output row is [previous span's samples | this span's samples] — the
    sliding context window."""
    B, N = minz.shape
    sb = span_blocks
    assert B % sb == 0 and N % stride == 0, (B, sb, N)
    half = sb * (N // stride)        # samples per span (= half a row)
    sps = 2 * half
    pbits = (sps - 1).bit_length()
    hbits = 32 - pbits
    dest = minz[:, ::stride]
    ctx = jnp.concatenate(
        [jnp.full((sb, dest.shape[1]), EMPTY, minz.dtype), dest[:-sb]],
        axis=0)
    # Remix before truncating: a windowed MIN of k hashes is biased small
    # (~log2(k) top bits near zero), so taking its top bits directly would
    # waste hash entropy; an odd-constant multiply re-uniformizes while
    # preserving equality.
    C1 = jnp.uint32(2654435761)
    hd = ((dest * C1) >> (32 - hbits)).reshape(B // sb, half)
    hc = ((ctx * C1) >> (32 - hbits)).reshape(B // sb, half)
    cat = jnp.concatenate([hc, hd], axis=1)  # [context | span]
    pos = jax.lax.broadcasted_iota(jnp.uint32, (B // sb, sps), 1)
    return (cat << pbits) | pos


def ldm_unsorted(blocks: jnp.ndarray, span_blocks: int = 4,
                 neighbors: int = 1,
                 minz: jnp.ndarray | None = None) -> jnp.ndarray:
    """LDM candidate chain: minimizers -> keys -> sort -> neighbor/
    un-sort keys -> sort. Returns (B/span_blocks, sps) u32, entry j =
    (j << hbits | sample offset) — position-ordered like the short-range
    su arrays. Pass a precomputed minimizer plane (hash_keys_winmin_sync)
    to skip the standalone winmin pass."""
    stride = ldm_stride(span_blocks, blocks.shape[1])
    if minz is None:
        minz = ldm_winmin(blocks, stride)
    key = ldm_keys(minz, span_blocks, stride)
    return _unsorted(key, (key.shape[1] - 1).bit_length(), neighbors)


def _ldm_est(su: jnp.ndarray, lengths: jnp.ndarray, n: int,
             span_blocks: int, max_off: int):
    """Sample-grid LDM claims from position-ordered LDM keys.

    su: (B/span_blocks, sps) position-ordered LDM keys; the second half
    of each row holds this span's samples (the first half is sliding
    context — candidates only). A sample's candidate survives when >= 2
    consecutive samples chain on the same offset (collision kill + 64 B
    length evidence); its estimate is the chained span (32 bytes per
    unit, up to 2 KiB). Returns (est_b, off_b): (B, spb) int32 chained
    estimates (0 = no claim) and raw byte offsets on the sample grid.
    Traced inside both merge_ldm (full-resolution path) and the dense
    and sync slot compactions."""
    sb = span_blocks
    stride = ldm_stride(sb, n)
    nspans, sps = su.shape
    half = sps // 2
    spb = half // sb
    B = nspans * sb
    pbits = (sps - 1).bit_length()
    dest = jax.lax.slice(su, (0, half), (nspans, sps))
    offs = (dest & jnp.uint32((1 << (32 - pbits)) - 1)).astype(jnp.int32)

    # Chained reach over consecutive samples agreeing on the offset.
    # Minimizer offsets are slot-quantized with +-1 slot jitter (the two
    # copies' minimizers round to floor/ceil slots independently), so
    # agreement is |delta| <= 1, which rules out the doubling trick —
    # use a linear prefix-AND chain instead (reach caps at 6 units).
    reach = (offs > 0).astype(jnp.int32)
    agree = offs > 0
    for k in range(1, 6):
        nxt = _shl(offs, k, 0)
        agree = agree & (jnp.abs(nxt - offs) <= 1) & (nxt > 0)
        reach = reach + agree.astype(jnp.int32)
    est = reach * stride
    # >= 2-sample chain evidence; byte offset in [2*stride, max_off] —
    # max_off is the level's frame window (window_log >= 19), so every
    # claim is format-legal (the host slide probe enforces its own
    # window cap); the span geometry bounds reach at
    # 2 * span_blocks * block_size.
    valid = (reach >= 2) & (offs >= 2) \
        & (offs * stride <= max_off)

    est_b = jnp.where(valid, est, 0).reshape(B, spb)
    off_b = (offs * stride).reshape(B, spb)
    posb = jnp.arange(spb, dtype=jnp.int32)[None, :] * stride
    est_b = jnp.where(posb + 40 <= lengths.astype(jnp.int32)[:, None],
                      est_b, 0)
    return est_b, off_b


@functools.partial(jax.jit, static_argnames=("span_blocks", "local_cap",
                                             "max_off"))
def merge_ldm(mlen: jnp.ndarray, moff: jnp.ndarray, su: jnp.ndarray,
              lengths: jnp.ndarray, span_blocks: int, local_cap: int,
              max_off: int = 1 << 19):
    """Fold LDM candidates into the local (mlen, moff) candidate arrays.

    An LDM claim takes a position only where the local estimate is
    shorter AND unsaturated (a saturated local estimate means a long
    nearby match — preferring it keeps offsets small for the entropy
    coder). Offsets are raw byte offsets (exact — the slot contract
    carries 30 offset bits). Full-resolution variant for the parsed
    (non-dense) pipeline; the dense path uses compact_slots_dense."""
    B, N = mlen.shape
    stride = ldm_stride(span_blocks, N)
    est_b, off_b = _ldm_est(su, lengths, N, span_blocks, max_off)
    spb = est_b.shape[1]

    def up(x):  # sample grid -> position grid (zeros off-grid)
        z = jnp.zeros((B, spb, stride - 1), x.dtype)
        return jnp.concatenate([x[:, :, None], z], axis=2).reshape(B, N)

    up_est = up(est_b)
    # Local candidates keep their position when their estimate is
    # saturated (est == local_cap means "at least this long" — usually a
    # long nearby match whose small offset is cheaper), UNLESS the LDM
    # chain shows >= 128 B of evidence: a long-distance match that long
    # beats any short local match regardless of offset cost (RLE runs
    # stay protected by the up_est > mlen test — their exact len1
    # estimate exceeds any LDM chain when genuinely longer).
    take = (up_est > mlen) & ((mlen < local_cap) | (up_est >= 128))
    return (jnp.where(take, up_est, mlen),
            jnp.where(take, up(off_b), moff))


def _ldm_slots(su, lengths, n: int, span_blocks: int, max_off: int):
    """LDM sample-grid claims expanded to the (B, N/4) slot grid (zeros
    off-grid): sample positions are stride-aligned, so subslot k == 0."""
    est_b, off_b = _ldm_est(su, lengths, n, span_blocks, max_off)
    B, spb = est_b.shape
    sls = (n // 4) // spb  # slots per sample (= stride // 4)

    def up_slot(x):
        z = jnp.zeros((B, spb, sls - 1), x.dtype)
        return jnp.concatenate([x[:, :, None], z], axis=2) \
            .reshape(B, n // 4)

    return up_slot(est_b), up_slot(off_b)


@functools.partial(jax.jit, static_argnames=("window", "span_blocks",
                                             "local_cap", "max_off"))
def compact_slots_dense(mlen: jnp.ndarray, moff: jnp.ndarray, window: int,
                        su: jnp.ndarray | None = None,
                        lengths: jnp.ndarray | None = None,
                        span_blocks: int = 0, local_cap: int = 24,
                        max_off: int = 1 << 19):
    """Dense-parse + LDM-merge + slot compaction: candidate arrays -> the
    (B*nseg, w/4) slot words.

    The dense path has no device parse — every >= MIN_MATCH candidate is
    claimed — so `chosen` is derived from mlen directly. LDM candidates
    live only on the sample grid (stride >= 32, 32-aligned => subslot
    k == 0), so the merge that merge_ldm performs at full (B, N)
    resolution collapses to a slot-plane override: expand the (B, spb)
    sample-grid estimates to the (B, N/4) slot grid and let an LDM claim
    take its slot when it beats the local k=0 lane under merge_ldm's
    exact take rule (k == 0 wins the subslot min anyway, so overriding
    after the reduction is exact)."""
    B, N = mlen.shape
    w = min(window, N)
    ml4 = [mlen[:, k::4] for k in range(4)]
    best = _slot_min([m >= MIN_MATCH for m in ml4],
                     [moff[:, k::4] for k in range(4)])
    if su is not None:
        est, ldo = _ldm_slots(su, lengths, N, span_blocks, max_off)
        take = (est > ml4[0]) & ((ml4[0] < local_cap) | (est >= 128))
        best = jnp.where(take, ldo.astype(jnp.uint32), best)
    return best.reshape(B * (N // w), w // 4)


@functools.partial(jax.jit, static_argnames=("window", "width",
                                             "span_blocks", "max_off"))
def compact_slots_sync(su: jnp.ndarray, window: int, lengths: jnp.ndarray,
                       width: int = 6, su_ldm: jnp.ndarray | None = None,
                       span_blocks: int = 0, max_off: int = 1 << 19):
    """Pair-claim slot compaction for the syncmer pipeline: position-
    ordered pair keys -> the (B*nseg, w/4) slot words (the same contract
    compact_slots_dense emits, so the host unpack and extension walk are
    untouched).

    su: (B*nseg, w/2) u32, entry j = (pos << 17 | off) for pair j
    (positions strictly increase pairwise, so sorted order IS pair
    order). Out slot i covers pairs 2i and 2i+1; the smaller-k claim
    wins the subslot, matching the dense compaction's priority. The
    finalize-stage tail guard (pos + width <= block_len) moves here; at
    L1's single width-6 / 32K window the dense cost filter is vacuous
    (mlen>=6 & off<=32768 holds for every hash hit), so no filter
    semantics are lost — the host economics walk is the filter."""
    B = lengths.shape[0]
    R, w2 = su.shape
    nseg = R // B
    w = w2 * 2
    N = nseg * w
    pbits = (w - 1).bit_length()
    offbits = 32 - pbits
    blen = lengths.astype(jnp.int32)[:, None]
    su_blk = su.reshape(B, N // 2)  # contiguous: segments tile the block
    gp4 = jax.lax.broadcasted_iota(jnp.int32, (B, N // 4), 1)
    segbase = (gp4 >> (pbits - 2)) << pbits  # (slot // ws) * w
    best = jnp.uint32(EMPTY)
    for s in (su_blk[:, 0::2], su_blk[:, 1::2]):  # pairs 2i, 2i+1
        posf = (s >> offbits).astype(jnp.int32)
        off = s & jnp.uint32((1 << offbits) - 1)
        valid = (off > 0) & (segbase + posf + width <= blen)
        key = ((posf & 3).astype(jnp.uint32) << 30) | off
        best = jnp.minimum(best, jnp.where(valid, key, jnp.uint32(EMPTY)))
    if su_ldm is not None:
        est, ldo = _ldm_slots(su_ldm, lengths, N, span_blocks, max_off)
        # merge_ldm's take rule degenerates here: the sync path has no
        # local length estimate, so the local claim is width (6) or 0 —
        # never saturated — and any valid LDM claim (est >= 2*stride >=
        # 64 > width) wins its slot. The host extension still
        # byte-verifies and may fall back to rep/local offsets.
        ml0 = jnp.where(best != jnp.uint32(EMPTY), jnp.int32(width), 0)
        best = jnp.where(est > ml0, ldo.astype(jnp.uint32), best)
    return best.reshape(R, w // 4)


@functools.partial(jax.jit, static_argnames=(
    "widths", "neighbors", "window", "lazy", "psegs", "ldm", "ldm_max_off",
    "dense", "sync"))
def find_matches_positions(blocks, lengths, widths=(6,),
                           neighbors: int = 1, window: int = 32768,
                           lazy: bool = False, psegs: int = 1,
                           ldm: int = 0, ldm_max_off: int = 1 << 19,
                           dense: bool = False, sync: bool = False):
    """Hash-matcher pipeline with the segment-slots device->host contract,
    as one program.

    Returns the slot-word array (B*nseg, w/4) u32: each row is one window
    segment; slot i holds either that 4-byte slot's chosen claim as
    (subslot_k << 30 | byte_offset) — position = 4*i + k — or the empty
    sentinel 0xFFFFFFFF. Slot index == position order, so NO device-side
    sort or merge is needed at all: the host mask-selects claims row-major
    (unpack_segments) and per-segment runs concatenate in block order
    because segments tile the block. There is no per-segment capacity
    limit and no overflow case (a w-byte segment physically holds <= w/4
    claims).

    The host reconstructs tiled MIN_MATCH claims from the positions and
    the native extension pass derives exact lengths (see compact_slots).
    This is the production fast-level path.

    ldm > 0 enables long-distance matching with ldm-block spans (see
    merge_ldm).

    dense=True skips the device parse entirely: EVERY candidate slot is
    claimed (the slot array's size is fixed, so claim density is free on
    the return path) and the host extension walk — which sees true bytes
    — becomes the parse. Measured ~4% better ratio than the est-greedy
    device parse (the estimate-driven parse takes false claims that mask
    real candidates in the following few bytes).

    sync=True pair-samples anchors (one key per byte pair, content-
    selected), halving both dominant sorts; single-width dense only (the
    host extension walk is the parse and the economics filter).
    """
    from . import parse_kernel

    B, N = blocks.shape
    w = min(window, N)
    pbits = (w - 1).bit_length()
    local_cap = 4 * max(widths)
    if sync:
        if not dense or len(widths) != 1:
            raise ValueError("sync implies single-width dense "
                             f"(got dense={dense}, widths={widths})")
        stride = ldm_stride(ldm, N) if ldm else 0  # 0: no minimizer plane
        key, minz = hash_keys_winmin_sync(blocks, widths[0], window, stride)
        su = _unsorted(key, pbits, neighbors, pos_mask=w - 1)
        su_l = ldm_unsorted(blocks, ldm, minz=minz) if ldm else None
        return compact_slots_sync(
            su, window, lengths, width=widths[0], su_ldm=su_l,
            span_blocks=ldm, max_off=ldm_max_off)

    mlen, moff = candidates_hash_split(blocks, lengths, tuple(widths),
                                       neighbors, window)
    su_l = ldm_unsorted(blocks, ldm) if ldm else None
    if dense:
        return compact_slots_dense(
            mlen, moff, window, su=su_l, lengths=lengths,
            span_blocks=ldm, local_cap=local_cap, max_off=ldm_max_off)
    if ldm:
        mlen, moff = merge_ldm(mlen, moff, su_l, lengths, ldm,
                               local_cap=local_cap, max_off=ldm_max_off)
    chosen = parse_kernel.parse_greedy(mlen, lazy=lazy, psegs=psegs)
    return compact_slots(chosen, moff, window)
