"""Sequences section encoding (RFC 8878 §3.1.1.3.2).

Our sequence IR matches the reference's producer contract
(`ZSTD_Sequence{offset, litLength, matchLength}`, src/qatseqprod.h:85-95):
raw offsets >= 1, match length >= 3 (3-byte minimum match, the LZ4s
`+LZ4MINMATCH` bias, src/qatseqprod.c:1060-1062), and a final literals-only
sequence is represented implicitly by `last_literals` at the block layer.

We always emit explicit offset_value = offset + 3 (no repcodes), mirroring
libzstd's handling of external sequences with searchForExternalRepcodes
disabled (the reference benchmark's -E0 mode, test/benchmark.c:269-277).

Mode selection per table: Predefined_Mode, RLE_Mode, or FSE_Compressed_Mode,
picked by serialized cost.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import fse, tables
from .bitstream import BackwardBitWriter

MODE_PREDEFINED = 0
MODE_RLE = 1
MODE_FSE = 2
# MODE_REPEAT = 3 (cross-block table reuse; not emitted yet)


def nbseq_header(n: int) -> bytes:
    """Number_of_Sequences varint (RFC 8878 §3.1.1.3.2) — the single
    definition used by both the host encoder and the device-entropy
    section wrapper (the C++ runtime mirrors it)."""
    if n < 128:
        return bytes([n])
    if n < 0x7F00:
        return bytes([(n >> 8) + 128, n & 0xFF])
    return bytes([0xFF]) + (n - 0x7F00).to_bytes(2, "little")


class _RleState:
    """Degenerate FSE state machine (accuracy log 0): emits no bits."""

    def __init__(self, symbol: int) -> None:
        self.symbol = symbol

    def encode(self, symbol: int, writer: BackwardBitWriter) -> None:
        assert symbol == self.symbol

    def flush(self, writer: BackwardBitWriter) -> None:
        pass


@dataclass
class _TablePlan:
    mode: int
    desc: bytes                  # serialized table description bytes
    enc: object                  # EncodeTable or symbol int for RLE
    bit_cost: float              # estimated bits for the symbol stream


_PREDEF_CACHE: dict[str, fse.EncodeTable] = {}


def _predefined(kind: str) -> fse.EncodeTable:
    if kind not in _PREDEF_CACHE:
        dist, al = {
            "ll": (tables.LL_DEFAULT_DIST, tables.LL_DEFAULT_ACCURACY),
            "of": (tables.OF_DEFAULT_DIST, tables.OF_DEFAULT_ACCURACY),
            "ml": (tables.ML_DEFAULT_DIST, tables.ML_DEFAULT_ACCURACY),
        }[kind]
        _PREDEF_CACHE[kind] = fse.build_encode_table(dist, al)
    return _PREDEF_CACHE[kind]


def _plan_table(codes: np.ndarray, kind: str, max_symbol: int,
                max_accuracy: int, allow_custom: bool) -> _TablePlan:
    """Choose Predefined vs RLE vs FSE-compressed for one code stream."""
    hist = np.bincount(codes, minlength=max_symbol + 1).astype(np.int64)
    n = len(codes)
    present = np.nonzero(hist)[0]

    if len(present) == 1:
        return _TablePlan(MODE_RLE, bytes([int(present[0])]),
                          int(present[0]), 0.0)

    dist, al = {
        "ll": (tables.LL_DEFAULT_DIST, tables.LL_DEFAULT_ACCURACY),
        "of": (tables.OF_DEFAULT_DIST, tables.OF_DEFAULT_ACCURACY),
        "ml": (tables.ML_DEFAULT_DIST, tables.ML_DEFAULT_ACCURACY),
    }[kind]

    # Predefined only legal if every present code is within the predefined
    # alphabet (offset codes > 28 overflow the default OF table).
    predef_ok = int(present[-1]) < len(dist)
    predef_cost = np.inf
    if predef_ok:
        size = 1 << al
        p = np.array([1 if c == -1 else c for c in dist], dtype=np.float64)
        bits = al - np.log2(p)
        predef_cost = float((hist[: len(dist)] * bits).sum())

    plan = None
    if allow_custom and n >= 2:
        accuracy = min(max_accuracy, max(5, (n - 1).bit_length()))
        try:
            norm = fse.normalize_counts(hist, accuracy, total=n)
            desc = fse.write_ncount(norm, accuracy)
            pn = np.array([1 if c == -1 else max(c, 0) for c in norm],
                          dtype=np.float64)
            h = hist[: len(norm)].astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                bits = accuracy - np.log2(pn)
                cost = float(np.where(h > 0, h * bits, 0.0).sum()) \
                    + 8 * len(desc)
            if cost < predef_cost:
                plan = _TablePlan(MODE_FSE, desc,
                                  fse.build_encode_table(norm, accuracy), cost)
        except ValueError:
            plan = None
    if plan is None:
        if not predef_ok:
            raise ValueError(f"{kind} codes exceed predefined alphabet and "
                             "custom tables disabled")
        plan = _TablePlan(MODE_PREDEFINED, b"", _predefined(kind), predef_cost)
    return plan


def _mk_state(plan: _TablePlan, first_symbol: int):
    if plan.mode == MODE_RLE:
        return _RleState(plan.enc)
    return fse.FseEncoder(plan.enc, first_symbol)


def offset_values(offsets: np.ndarray, lit_lengths: np.ndarray,
                  first_block: bool = False) -> np.ndarray:
    """offset_value stream with repcode compression (RFC 8878
    §3.1.1.3.2.1.1): values 1-3 name recent-offset history slots, > 3 is
    explicit (raw + 3).

    Blocks are encoded in parallel, so the incoming rep state (which the
    decoder carries across blocks) is unknown here; a history slot is
    only used once enough explicit offsets have locally determined it.
    After three explicit pushes the whole history is local. This is the
    ratio the reference recovers via libzstd's repcode post-pass
    (ZSTD_c_searchForExternalRepcodes, test/benchmark.c:269-277), done
    natively."""
    n = len(offsets)
    ofv = np.empty(n, dtype=np.int64)
    reps = [1, 4, 8]
    # The FIRST block of a frame has the spec-guaranteed initial history
    # [1, 4, 8] (RFC 8878 section 3.1.1.5; golden/decoder.py:350), so all
    # three slots are usable immediately there (ADVICE r2).
    known = 3 if first_block else 0
    for i in range(n):
        off = int(offsets[i])
        ll = int(lit_lengths[i])
        if ll != 0:
            if known >= 1 and off == reps[0]:
                ofv[i] = 1
                continue
            if known >= 2 and off == reps[1]:
                ofv[i] = 2
                reps[:] = [reps[1], reps[0], reps[2]]
                continue
            if known >= 3 and off == reps[2]:
                ofv[i] = 3
                reps[:] = [reps[2], reps[0], reps[1]]
                continue
        else:
            if known >= 2 and off == reps[1]:
                ofv[i] = 1
                reps[:] = [reps[1], reps[0], reps[2]]
                continue
            if known >= 3 and off == reps[2]:
                ofv[i] = 2
                reps[:] = [reps[2], reps[0], reps[1]]
                continue
            if known >= 1 and off == reps[0] - 1 and off > 0:
                ofv[i] = 3
                reps[:] = [off, reps[0], reps[1]]
                known = min(3, known + 1)  # rep0-1 pushes a new value
                continue
        ofv[i] = off + 3
        reps[:] = [off, reps[0], reps[1]]
        known = min(3, known + 1)
    return ofv


def encode_sequences(lit_lengths: np.ndarray, offsets: np.ndarray,
                     match_lengths: np.ndarray,
                     allow_custom_tables: bool = True,
                     force_predefined: bool = False,
                     use_repcodes: bool | None = None,
                     first_block: bool = False) -> bytes:
    """Full Sequences_Section bytes for one block.

    lit_lengths[i]: literals preceding match i; offsets[i]: raw match offset
    (>=1); match_lengths[i]: match length (>=3).

    use_repcodes defaults to on, except in force_predefined (device-parity)
    mode where the on-device encoder's explicit-offset stream is mirrored.
    """
    n = len(lit_lengths)
    out = bytearray(nbseq_header(n))
    if n == 0:
        return bytes(out)

    if use_repcodes is None:
        use_repcodes = not force_predefined
    ll = np.asarray(lit_lengths, dtype=np.int64)
    ml = np.asarray(match_lengths, dtype=np.int64)
    if use_repcodes:
        ofv = offset_values(np.asarray(offsets, dtype=np.int64), ll,
                            first_block=first_block)
    else:
        ofv = np.asarray(offsets, dtype=np.int64) + 3  # explicit

    ll_codes = tables.ll_code_np(ll)
    ml_codes = tables.ml_code_np(ml)
    of_codes = tables.of_code_np(ofv)

    if force_predefined:
        # Device-parity mode: Predefined_Mode for all three streams (the
        # on-device encoder's static-table trade; used by differential tests).
        ll_plan = _TablePlan(MODE_PREDEFINED, b"", _predefined("ll"), 0.0)
        of_plan = _TablePlan(MODE_PREDEFINED, b"", _predefined("of"), 0.0)
        ml_plan = _TablePlan(MODE_PREDEFINED, b"", _predefined("ml"), 0.0)
    else:
        ll_plan = _plan_table(ll_codes, "ll", tables.MAX_LL_CODE,
                              tables.LL_MAX_ACCURACY, allow_custom_tables)
        of_plan = _plan_table(of_codes, "of", tables.MAX_OFFSET_CODE,
                              tables.OF_MAX_ACCURACY, allow_custom_tables)
        ml_plan = _plan_table(ml_codes, "ml", tables.MAX_ML_CODE,
                              tables.ML_MAX_ACCURACY, allow_custom_tables)

    out.append((ll_plan.mode << 6) | (of_plan.mode << 4) | (ml_plan.mode << 2))
    out += ll_plan.desc + of_plan.desc + ml_plan.desc

    ll_extra = (ll - tables.LL_BASELINES_NP[ll_codes]).astype(np.int64)
    ml_extra = (ml - tables.ML_BASELINES_NP[ml_codes]).astype(np.int64)
    of_extra = (ofv - (np.int64(1) << of_codes.astype(np.int64)))
    ll_bits = tables.LL_BITS_NP[ll_codes]
    ml_bits = tables.ML_BITS_NP[ml_codes]
    of_bits = of_codes  # nb extra bits for offsets == the code itself

    w = BackwardBitWriter()
    ml_state = _mk_state(ml_plan, int(ml_codes[n - 1]))
    of_state = _mk_state(of_plan, int(of_codes[n - 1]))
    ll_state = _mk_state(ll_plan, int(ll_codes[n - 1]))
    w.add(int(ll_extra[n - 1]), int(ll_bits[n - 1]))
    w.add(int(ml_extra[n - 1]), int(ml_bits[n - 1]))
    w.add(int(of_extra[n - 1]), int(of_bits[n - 1]))
    for i in range(n - 2, -1, -1):
        of_state.encode(int(of_codes[i]), w)
        ml_state.encode(int(ml_codes[i]), w)
        ll_state.encode(int(ll_codes[i]), w)
        w.add(int(ll_extra[i]), int(ll_bits[i]))
        w.add(int(ml_extra[i]), int(ml_bits[i]))
        w.add(int(of_extra[i]), int(of_bits[i]))
    ml_state.flush(w)
    of_state.flush(w)
    ll_state.flush(w)
    out += w.close()
    return bytes(out)
