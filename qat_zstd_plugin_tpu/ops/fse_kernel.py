"""On-device FSE sequence-section encoding.

This moves the reference's libzstd-owned sequence entropy stage onto the
accelerator. Design constraints and answers:

* FSE is a sequential state machine -> a ``lax.scan`` over steps with the
  block batch as the vector axis: each step encodes one sequence for
  every block at once.
* Symbol-dependent extra-bit fields are pure functions of the codes ->
  precomputed as (S, B) arrays; the per-step lookups are into the small
  per-lane state tables (<=64 entries, one-hot compare-reduce).
* Encoding runs over sequences in reverse; per-block reversal of the code
  arrays is one small sort (sorting is this codec's scatter).
* Bit emission: each step produces one state-bits item and one extras
  item; ops/bitconcat.py turns the item streams into the backward
  bitstream with a log-depth reduction (ops/bitpack.py remains the
  sort-based differential oracle).
* Always Predefined_Mode (mode byte 0): every code in range is encodable
  and no table descriptions are emitted — the same static-tables trade
  the QAT hardware makes (the reference configures static Huffman,
  SURVEY C6); the host path keeps custom tables for best ratio.

Differentially tested against format/sequences.py with custom tables
disabled (byte-identical sections).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..format import fse, tables
from . import bitconcat, bitpack

# ---------------------------------------------------------------- tables


def _enc_tables():
    """Predefined encode tables as numpy arrays (built once)."""
    out = {}
    for kind, dist, al in (
            ("ll", tables.LL_DEFAULT_DIST, tables.LL_DEFAULT_ACCURACY),
            ("of", tables.OF_DEFAULT_DIST, tables.OF_DEFAULT_ACCURACY),
            ("ml", tables.ML_DEFAULT_DIST, tables.ML_DEFAULT_ACCURACY)):
        t = fse.build_encode_table(dist, al)
        out[kind] = t
    return out


_T = _enc_tables()

_LL_BASE = np.asarray(tables.LL_BASELINES, np.int32)
_LL_BITS = np.asarray(tables.LL_BITS, np.int32)
_ML_BASE = np.asarray(tables.ML_BASELINES, np.int32)
_ML_BITS = np.asarray(tables.ML_BITS, np.int32)


def _const_lookup(table_np: np.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """XLA-side lookup into a small constant table via one-hot reduce."""
    k = len(table_np)
    tbl = jnp.asarray(table_np.astype(np.int32))
    oh = idx[..., None] == jnp.arange(k, dtype=jnp.int32)
    return jnp.sum(jnp.where(oh, tbl, 0), axis=-1).astype(jnp.int32)


def _codes(ll, ml, ofv):
    """Vectorized code + extra-bit computation (XLA)."""
    ll_code = jnp.where(
        ll < 16, ll,
        15 + jnp.sum(ll[..., None] >= jnp.asarray(
            _LL_BASE[16:], np.int32), axis=-1))
    ml_code = jnp.where(
        ml <= 34, ml - 3,
        31 + jnp.sum(ml[..., None] >= jnp.asarray(
            _ML_BASE[32:], np.int32), axis=-1))
    # floor(log2(offset_value)) via 5-step bit reduction (portable).
    v = ofv
    of_code = jnp.zeros_like(ofv)
    for shift in (16, 8, 4, 2, 1):
        m = v >= (1 << shift)
        of_code = of_code + jnp.where(m, shift, 0)
        v = jnp.where(m, jax.lax.shift_right_logical(v, shift), v)
    ll_bits = _const_lookup(_LL_BITS, ll_code)
    ml_bits = _const_lookup(_ML_BITS, ml_code)
    ll_extra = ll - _const_lookup(_LL_BASE, ll_code)
    ml_extra = ml - _const_lookup(_ML_BASE, ml_code)
    of_extra = ofv - (jnp.int32(1) << of_code)
    return (ll_code, ml_code, of_code, ll_bits, ml_bits, of_code,
            ll_extra, ml_extra, of_extra)


# ------------------------------------------------------- state machine


def _lookup(tbl: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Per-lane table lookup: tbl (K, B), idx (B,) -> (B,); an index
    outside [0, K) reads 0 (one-hot compare-reduce)."""
    k = tbl.shape[0]
    oh = jnp.arange(k, dtype=jnp.int32)[:, None] == idx[None, :]
    return jnp.sum(jnp.where(oh, tbl, 0), axis=0).astype(jnp.int32)


@jax.jit
def _run_state_machine(code_rows, lane_tables, inits, nseq):
    """Sequential FSE state machine over reversed sequences, blocks as
    the vector axis: one ``lax.scan`` step encodes one sequence for every
    block at once.

    code_rows: 3 x (S+1, B) reversed symbol codes (row j = the sequence
      encoded at step j; row 0 feeds only the init path).
    lane_tables: per stream (dnb (K, B), dfs (K, B), st (size, B)) —
      per-block CONTENT (custom-table mode builds these per block;
      predefined mode broadcasts the static ones).
    inits: 3 x (B,) initial states; nseq: (B,) per-block sequence counts.
    Returns (lo, nb): (S+1, B) state-item bits and bit counts per step,
    with the flush item at j == nseq.
    """
    (dl, fl, tl), (do, fo, to), (dm, fm, tm) = lane_tables

    def step(states, xs):
        j, c_ll, c_of, c_ml = xs
        s_ll, s_of, s_ml = states
        active = (j >= 1) & (j < nseq)
        flush = j == nseq
        # Encode order per step: OF state bits, ML, LL.
        nb_of = jnp.where(active, (s_of + _lookup(do, c_of)) >> 16, 0)
        b_of = s_of & ((1 << nb_of) - 1)
        n_of = _lookup(to, (s_of >> nb_of) + _lookup(fo, c_of))
        nb_ml = jnp.where(active, (s_ml + _lookup(dm, c_ml)) >> 16, 0)
        b_ml = s_ml & ((1 << nb_ml) - 1)
        n_ml = _lookup(tm, (s_ml >> nb_ml) + _lookup(fm, c_ml))
        nb_ll = jnp.where(active, (s_ll + _lookup(dl, c_ll)) >> 16, 0)
        b_ll = s_ll & ((1 << nb_ll) - 1)
        n_ll = _lookup(tl, (s_ll >> nb_ll) + _lookup(fl, c_ll))
        new = (jnp.where(active, n_ll, s_ll), jnp.where(active, n_of, s_of),
               jnp.where(active, n_ml, s_ml))
        # Item value: of | ml << nb_of | ll << (nb_of + nb_ml); the flush
        # item instead writes ml(6) | of(5)<<6 | ll(6)<<11.
        enc_lo = b_of | (b_ml << nb_of) | (b_ll << (nb_of + nb_ml))
        fl_lo = (s_ml & 63) | ((s_of & 31) << 6) | ((s_ll & 63) << 11)
        lo = jnp.where(active, enc_lo, jnp.where(flush, fl_lo, 0))
        nb = jnp.where(active, nb_of + nb_ml + nb_ll,
                       jnp.where(flush, 6 + 5 + 6, 0))
        return new, (lo, nb)

    S1 = code_rows[0].shape[0]
    _, (lo, nb) = jax.lax.scan(
        step, tuple(inits),
        (jnp.arange(S1, dtype=jnp.int32), *code_rows))
    return lo, nb


def _init_state_lane(dnb_tbl: jnp.ndarray, dfs_tbl: jnp.ndarray,
                     st_tbl: jnp.ndarray, sym: jnp.ndarray) -> jnp.ndarray:
    """Vectorized FSE_initCState2 with per-block tables.
    dnb/dfs: (B, K); st: (B, size); sym: (B,) -> (B,) initial states."""
    dnb = jnp.take_along_axis(dnb_tbl, sym[:, None], axis=1)[:, 0]
    dfs = jnp.take_along_axis(dfs_tbl, sym[:, None], axis=1)[:, 0]
    nb_out = (dnb + (1 << 15)) >> 16
    value = (nb_out << 16) - dnb
    idx = jnp.clip((value >> nb_out) + dfs, 0, st_tbl.shape[1] - 1)
    return jnp.take_along_axis(st_tbl, idx[:, None], axis=1)[:, 0]


def _predef_lane_tables(kind: str, B: int, krows: int):
    """Predefined table content broadcast to per-lane shape."""
    t = _T[kind]
    dnb = np.zeros(krows, np.int32)
    dfs = np.zeros(krows, np.int32)
    k = len(t.delta_nb_bits)
    dnb[:k] = np.asarray(t.delta_nb_bits, np.int64).astype(np.int32)
    dfs[:k] = np.asarray(t.delta_find_state, np.int64).astype(np.int32)
    st = np.asarray(t.state_table, np.int32)
    return (jnp.broadcast_to(jnp.asarray(dnb)[None, :], (B, krows)),
            jnp.broadcast_to(jnp.asarray(dfs)[None, :], (B, krows)),
            jnp.broadcast_to(jnp.asarray(st)[None, :], (B, len(st))))


def encode_sequence_sections(lit_len: jnp.ndarray, offset: jnp.ndarray,
                             match_len: jnp.ndarray, nseq: jnp.ndarray,
                             max_words: int = 8192, custom: bool = False):
    """Device FSE sequence sections for a batch of blocks.

    lit_len/offset/match_len: (B, S) int32 (rows < nseq valid).
    Returns (words (B, max_words), total_bits (B,), overflow (B,), plan);
    the host wraps each stream with the nbSeq varint, the mode byte, and
    (custom mode) the NCount table descriptions built from plan["norm_*"].
    custom=True builds per-block FSE tables on device (fse_tables.py) and
    per-stream chooses custom vs predefined by estimated cost; plan
    carries "use_*" (B,) bools and "norm_*" (B, K) counts.
    """
    from . import fse_tables

    B, S = lit_len.shape
    srow = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None, :], (B, S))
    valid = srow < nseq[:, None]
    ofv = jnp.where(valid, offset + 3, 4)
    ll = jnp.where(valid, lit_len, 0)
    ml = jnp.where(valid, match_len, 3)

    (ll_c, ml_c, of_c, ll_b, ml_b, of_b, ll_x, ml_x, of_x) = _codes(
        ll, ml, ofv)

    # Reverse valid rows per block: row j <- seq nseq-1-j (one small sort).
    rkey = jnp.where(valid, nseq[:, None] - 1 - srow, jnp.int32(2 ** 30))
    packed1 = (ll_c << 16) | ml_c
    # of_code == of extra-bit count, so one 5-bit field serves both.
    packed2 = (ll_b << 10) | (ml_b << 5) | of_b
    _, r1, r2, rllx, rmlx, rofx = jax.lax.sort(
        (rkey, packed1, packed2, ll_x, ml_x, of_x), dimension=1,
        is_stable=True, num_keys=1)
    rll_c = r1 >> 16
    rml_c = r1 & 0xFFFF
    rll_b = (r2 >> 10) & 31
    rml_b = (r2 >> 5) & 31
    rof_b = r2 & 31
    rof_c = rof_b

    # Per-lane tables: custom content where the device plan picks it.
    plan = {}

    def lane_tables(kind, codes):
        krows = 32 if kind == "of" else 64
        if custom:
            use, norm, mixed = fse_tables.plan_streams(codes, valid, kind)
            plan[f"use_{kind}"] = use
            plan[f"norm_{kind}"] = norm
            pad = krows - mixed["dnb"].shape[1]
            return (jnp.pad(mixed["dnb"], ((0, 0), (0, pad))),
                    jnp.pad(mixed["dfs"], ((0, 0), (0, pad))),
                    mixed["state_table"])
        return _predef_lane_tables(kind, B, krows)

    tb_ll = lane_tables("ll", ll_c)
    tb_of = lane_tables("of", of_c)
    tb_ml = lane_tables("ml", ml_c)
    init_ll = _init_state_lane(*tb_ll, rll_c[:, 0])
    init_of = _init_state_lane(*tb_of, rof_c[:, 0])
    init_ml = _init_state_lane(*tb_ml, rml_c[:, 0])

    # Kernel wants (S+1, B) row-major with steps on rows.
    def to_rows(a):
        a = jnp.concatenate([a, jnp.zeros((B, 1), jnp.int32)], axis=1)
        return a.T

    out_lo, out_nb = _run_state_machine(
        [to_rows(rll_c), to_rows(rof_c), to_rows(rml_c)],
        [tuple(a.T for a in tb_ll), tuple(a.T for a in tb_of),
         tuple(a.T for a in tb_ml)],
        [init_ll, init_of, init_ml], nseq.astype(jnp.int32))
    S1 = S + 1
    state_lo = out_lo.T   # (B, S+1)
    state_nb = out_nb.T

    # Extras items: step j extras come from reversed row j (j < nseq).
    # 64-bit value emulated in two int32 words (x64 is disabled):
    # layout ll_x | ml_x << a | of_x << c with a = ll bits, c = a + ml
    # bits <= 32; ll_x/ml_x never spill (a + 16 <= 32), of_x may.
    ex_valid = srow < nseq[:, None]
    a = rll_b
    c = rll_b + rml_b
    ex_lo = rllx | (rmlx << a)
    of_lo = jnp.where(c < 32, rofx << jnp.minimum(c, 31), 0)
    of_hi = jnp.where(
        c >= 32, rofx,
        jnp.where(c > 0,
                  jax.lax.shift_right_logical(rofx, (32 - c) & 31), 0))
    # c in (0,15]: of fits entirely in lo; the shr above would leak for
    # (32-c) >= 18 only if rofx had high bits — it is < 2^17, so shr by
    # >= 17 yields 0 and of_hi is already correct.
    ex_lo = ex_lo | of_lo
    ex_hi = of_hi
    ex_nb = jnp.where(ex_valid, rll_b + rml_b + rof_b, 0)
    ex_lo = jnp.where(ex_valid, ex_lo, 0)
    ex_hi = jnp.where(ex_valid, ex_hi, 0)
    ex_lo = jnp.concatenate([ex_lo, jnp.zeros((B, 1), jnp.int32)], axis=1)
    ex_hi = jnp.concatenate([ex_hi, jnp.zeros((B, 1), jnp.int32)], axis=1)
    ex_nb = jnp.concatenate([ex_nb, jnp.zeros((B, 1), jnp.int32)], axis=1)

    # Interleave: [state_0, extras_0, state_1, extras_1, ...].
    items_lo = jnp.stack([state_lo, ex_lo], axis=2).reshape(B, 2 * S1)
    items_hi = jnp.stack([jnp.zeros_like(state_lo), ex_hi],
                         axis=2).reshape(B, 2 * S1)
    items_nb = jnp.stack([state_nb, ex_nb], axis=2).reshape(B, 2 * S1)
    # Log-depth reduction packer (see ops/bitconcat.py) — replaces the
    # sort-based bitpack on the device-entropy path.
    words, bits, over = bitconcat.bitconcat(items_lo, items_hi, items_nb,
                                            max_words, max_item_bits=64)
    return words, bits, over, plan
