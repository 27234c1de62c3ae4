"""Per-block FSE table construction on device (custom-table entropy).

Builds, fully vectorized over the block batch, the per-lane encode tables
the state kernel consumes (fse_kernel.py): the device histograms each
block's LL/ML/OF code streams, normalizes to a power-of-two total, and
materializes spread/state tables — so the accelerator emits sequence
sections with *content-adapted* tables instead of the predefined ones
(~5-7 ratio points on typical data; SURVEY §7.4 / VERDICT #4).

Design choices that keep this batch-friendly (static shapes):

* Accuracy logs are fixed to the predefined values (LL 6, OF 5, ML 6):
  table sizes and flush widths match the predefined path exactly, so the
  state kernel's shapes and the one-hot lookup cost are unchanged —
  custom tables change CONTENT, not geometry.
* Normalization avoids zstd's "less than 1" (-1) probability: every
  present symbol gets >= 1 slot (valid per RFC 8878 §4.1.1, marginally
  larger tables for rare symbols). Without -1 entries the canonical
  spread never skips high slots, so the spread position of the k-th
  entry is the closed form (k * step) mod size and its inverse is a
  multiplication by step^-1 — no scatter anywhere.
* Streams with a single present symbol (or tiny blocks) fall back to the
  predefined table content per-lane: modes can mix per stream per block
  (Symbol_Compression_Modes has 2 bits per stream).
* The host writes the byte-level table descriptions (format/fse.py
  write_ncount) from the normalized counts this module returns — a few
  dozen bytes per block of serial varint work that would waste a kernel.

Reference role: the QAT device uses static Huffman tables in hardware
(CpaDcSessionSetupData, SURVEY C6); owning table construction on the
accelerator is where this design goes beyond it.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..format import fse, tables

ALS = {"ll": tables.LL_DEFAULT_ACCURACY, "of": tables.OF_DEFAULT_ACCURACY,
       "ml": tables.ML_DEFAULT_ACCURACY}
NSYM = {"ll": 36, "of": 32, "ml": 53}
# Multiplicative inverse of the spread step modulo the table size (both
# odd/pow2 so the inverse exists): size 64 -> step 43, inv 3; size 32 ->
# step 23, inv 7.
_STEP_INV = {64: ((64 >> 1) + (64 >> 3) + 3, 3),
             32: ((32 >> 1) + (32 >> 3) + 3, 7)}
for _sz, (_st, _iv) in _STEP_INV.items():
    assert (_st * _iv) % _sz == 1


def _predef_norm(kind: str) -> np.ndarray:
    dist = {"ll": tables.LL_DEFAULT_DIST, "of": tables.OF_DEFAULT_DIST,
            "ml": tables.ML_DEFAULT_DIST}[kind]
    return np.asarray(dist, np.int32)


def histogram(codes: jnp.ndarray, valid: jnp.ndarray, nsym: int
              ) -> jnp.ndarray:
    """(B, S) codes -> (B, nsym) counts over valid rows."""
    oh = (codes[:, :, None] == jnp.arange(nsym, dtype=jnp.int32)) \
        & valid[:, :, None]
    return oh.sum(axis=1).astype(jnp.int32)


def normalize(hist: jnp.ndarray, al: int) -> jnp.ndarray:
    """Largest-remainder normalization to sum 2^al, min 1 per present
    symbol, no -1 entries. (B, K) -> (B, K)."""
    B, K = hist.shape
    target = jnp.int32(1 << al)
    total = jnp.maximum(hist.sum(axis=1, keepdims=True), 1)
    present = hist > 0
    scaled64 = hist.astype(jnp.int64) * (1 << al)
    base = (scaled64 // total).astype(jnp.int32)
    rem = (scaled64 % total).astype(jnp.int32)
    norm = jnp.where(present, jnp.maximum(base, 1), 0)
    # Distribute the residual units: +1 (or -1) to the symbols ranked by
    # largest remainder (for deficits) / largest norm (for excess). Rank
    # via argsort-free comparison counting (K <= 64: O(K^2) compares).
    def rank_desc(key):
        # rank[i] = number of j with (key[j], j) > (key[i], i)
        kj = key[:, None, :]
        ki = key[:, :, None]
        j_idx = jnp.arange(K, dtype=jnp.int32)
        gt = (kj > ki) | ((kj == ki) & (j_idx[None, None, :]
                                       < j_idx[None, :, None]))
        return gt.sum(axis=2).astype(jnp.int32)

    deficit = target - norm.sum(axis=1, keepdims=True)  # may be negative
    # Add phase: top-`deficit` remainders among present symbols gain 1.
    add_rank = rank_desc(jnp.where(present, rem, -1))
    norm = norm + ((add_rank < deficit) & present).astype(jnp.int32)
    # Subtract phase (deficit < 0): repeatedly shave the largest norms.
    def shave(state):
        norm, = state
        over = norm.sum(axis=1, keepdims=True) - target
        r = rank_desc(jnp.where(norm > 1, norm, -1))
        take = ((r < over) & (norm > 1)).astype(jnp.int32)
        return (norm - take,)

    def has_over(state):
        norm, = state
        return (norm.sum(axis=1) > target).any()

    norm, = jax.lax.while_loop(has_over, shave, (norm,))
    return norm


def build_tables(norm: jnp.ndarray, al: int):
    """Per-block FSE encode tables from normalized counts (no -1s).

    norm: (B, K) with sum 2^al per block. Returns dict with
      state_table: (B, size) int32   (values in [size, 2*size))
      dnb:         (B, K) int32      (delta_nb_bits per symbol)
      dfs:         (B, K) int32      (delta_find_state per symbol)
    Matches fse.build_encode_table for the same norm (differentially
    tested).
    """
    B, K = norm.shape
    size = 1 << al
    step, inv = _STEP_INV[size]
    cum = jnp.cumsum(norm, axis=1) - norm          # exclusive cumsum (B,K)
    # Walk entry k holds symbol s with cum[s] <= k < cum[s]+norm[s]:
    # sym_walk[b, k] = sum_s (k >= cum[s] + norm[s]).
    ks = jnp.arange(size, dtype=jnp.int32)
    ends = (cum + norm)[:, None, :]                # (B, 1, K)
    sym_walk = (ks[None, :, None] >= ends).sum(axis=2).astype(jnp.int32)
    # Spread slot of walk entry k is (k * step) mod size; inversely, slot
    # u holds walk entry (u * inv) mod size.
    slot_sym = sym_walk[:, (ks * inv) % size]       # (B, size)
    # Encode state table: for each symbol, its slots ascending:
    # state_table[cum[s] + rank(u)] = size + u where rank = prefix count
    # of s among slots < u.
    eq = slot_sym[:, None, :] == slot_sym[:, :, None]   # (B, u, u')
    lower = ks[None, None, :] < ks[None, :, None]
    rank = (eq & lower).sum(axis=2).astype(jnp.int32)   # (B, size)
    dest = jnp.take_along_axis(cum, slot_sym, axis=1) + rank
    # scatter: state_table[b, dest[u]] = size + u (dest is a permutation)
    onehot = dest[:, :, None] == ks[None, None, :]      # (B, u, i)
    state_table = (jnp.where(onehot, (size + ks)[None, :, None], 0)
                   .sum(axis=1).astype(jnp.int32))
    # Per-symbol deltas (c >= 1 everywhere present).
    c = norm
    safe_c = jnp.maximum(c, 1)
    # highbit(c-1) for c >= 2; max_bits_out = al - highbit(c-1)
    # (fse.build_encode_table parity; c <= 1 takes the dnb_1 branch).
    hb = jnp.int32(31) - jax.lax.clz(jnp.maximum(safe_c - 1, 1))
    maxbits = al - hb
    dnb_ge2 = (maxbits << 16) - (safe_c << jnp.clip(maxbits, 0, 31))
    dnb_1 = (al << 16) - (1 << al)
    dnb = jnp.where(c == 1, dnb_1, dnb_ge2)
    dnb = jnp.where(c == 0, ((al + 1) << 16) - (1 << al), dnb)
    total = cum  # exclusive cumsum = running total
    dfs = jnp.where(c == 0, 0, total - jnp.where(c == 1, 1, safe_c))
    return {"state_table": state_table, "dnb": dnb.astype(jnp.int32),
            "dfs": dfs.astype(jnp.int32)}


def plan_streams(codes: jnp.ndarray, valid: jnp.ndarray, kind: str):
    """Per-block plan for one code stream: histogram, normalized counts,
    custom-vs-predefined decision, and the per-lane tables.

    Returns (use_custom (B,), norm (B, K), tables dict with per-lane
    content — custom where chosen, predefined elsewhere).
    """
    al = ALS[kind]
    K = NSYM[kind]
    hist = histogram(codes, valid, K)
    norm = normalize(hist, al)
    n = hist.sum(axis=1)
    npresent = (hist > 0).sum(axis=1)

    # Cost estimate (bits): sum hist[s] * (al - log2(table_count[s])) +
    # header bytes for the description. log2 over counts 1..2^al via a
    # tiny constant lookup.
    counts = jnp.arange(0, (1 << al) + 1, dtype=jnp.int32)
    log2c = jnp.log2(jnp.maximum(counts, 1).astype(jnp.float32))

    def stream_bits(nrm):
        p = jnp.take(log2c, jnp.clip(nrm, 0, 1 << al))
        bits = jnp.where(hist > 0, hist * (al - p), 0.0)
        return bits.sum(axis=1)

    pre_np = _predef_norm(kind)
    pre_nsym = len(pre_np)  # predefined alphabet size (OF: 29 < K=32)
    if len(pre_np) < K:  # predefined OF alphabet is shorter than ours
        pre_np = np.concatenate([pre_np, np.zeros(K - len(pre_np),
                                                  np.int32)])
    pre = jnp.asarray(pre_np[:K])
    pre_norm = jnp.broadcast_to(jnp.where(pre < 0, 1, pre)[None, :],
                                hist.shape).astype(jnp.int32)
    predef_al = {"ll": tables.LL_DEFAULT_ACCURACY,
                 "of": tables.OF_DEFAULT_ACCURACY,
                 "ml": tables.ML_DEFAULT_ACCURACY}[kind]
    p_pre = jnp.take(log2c, jnp.clip(pre_norm, 0, 1 << al))
    pre_bits = jnp.where(hist > 0,
                         hist * (predef_al - p_pre), 0.0).sum(axis=1)
    # Rough description cost: ~al+1 bits per present symbol + zero runs.
    desc_bits = (npresent + 2) * (al + 1) + 16
    custom_bits = stream_bits(norm) + desc_bits
    # Predefined is only legal when every present code fits the predefined
    # alphabet (OF predefined has 29 symbols vs K=32; codes >= 29 MUST use
    # a custom table or the stream would be illegal). Unreachable today
    # (block-local offsets <= 128K => OF codes <= ~18) but guarded.
    over_predef = (hist[:, pre_nsym:] > 0).any(axis=1) if pre_nsym < K \
        else jnp.zeros(hist.shape[0], bool)
    use_custom = ((custom_bits < pre_bits) & (npresent >= 2) & (n >= 16)) \
        | over_predef

    custom_t = build_tables(norm, al)
    pre_table = fse.build_encode_table(
        {"ll": tables.LL_DEFAULT_DIST, "of": tables.OF_DEFAULT_DIST,
         "ml": tables.ML_DEFAULT_DIST}[kind], al)
    pre_state = jnp.asarray(np.asarray(pre_table.state_table, np.int32))
    pre_dnb_np = np.full(K, ((al + 1) << 16) - (1 << al), np.int32)
    pre_dfs_np = np.zeros(K, np.int32)
    kp = len(pre_table.delta_nb_bits)
    pre_dnb_np[:kp] = np.asarray(pre_table.delta_nb_bits,
                                 np.int64).astype(np.int32)[:K]
    pre_dfs_np[:kp] = np.asarray(pre_table.delta_find_state,
                                 np.int64).astype(np.int32)[:K]
    sel = use_custom[:, None]
    mixed = {
        "state_table": jnp.where(sel, custom_t["state_table"],
                                 pre_state[None, :]),
        "dnb": jnp.where(sel, custom_t["dnb"],
                         jnp.asarray(pre_dnb_np)[None, :]),
        "dfs": jnp.where(sel, custom_t["dfs"],
                         jnp.asarray(pre_dfs_np)[None, :]),
    }
    return use_custom, norm, mixed
