"""zstd sequence code tables and predefined FSE distributions (RFC 8878).

These constants define the contract between our sequence IR and the frame
bytes. The reference plugin emits `ZSTD_Sequence{offset, litLength,
matchLength}` triples and lets libzstd map them to codes (reference:
src/qatseqprod.h:85-95 producer contract); we own that mapping.

All tables are mirrored as NumPy arrays for the vectorized/device paths.
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# Literals-length codes: code -> (baseline, nb_extra_bits)
# lit lengths 0..15 map to codes 0..15 with 0 extra bits.
LL_BASELINES = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
    2048, 4096, 8192, 16384, 32768, 65536,
]
LL_BITS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
]
MAX_LL_CODE = 35

# Match-length codes: match lengths 3..34 map to codes 0..31 (baseline ml,
# 0 extra bits); longer matches use the extension codes below.
ML_BASELINES = [
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
    2051, 4099, 8195, 16387, 32771, 65539,
]
ML_BITS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
]
MAX_ML_CODE = 52

MAX_OFFSET_CODE = 31  # offset codes are log2(offset_value); frame cap


# Reverse-lookup arrays: length -> code via baseline binary search.
_LL_BASE_NP = np.asarray(LL_BASELINES, dtype=np.int64)
_ML_BASE_NP = np.asarray(ML_BASELINES, dtype=np.int64)
LL_BITS_NP = np.asarray(LL_BITS, dtype=np.int32)
ML_BITS_NP = np.asarray(ML_BITS, dtype=np.int32)
LL_BASELINES_NP = _LL_BASE_NP.astype(np.int32)
ML_BASELINES_NP = _ML_BASE_NP.astype(np.int32)


def ll_code_np(lit_lengths: np.ndarray) -> np.ndarray:
    """Vectorized literals-length -> code."""
    ll = np.asarray(lit_lengths, dtype=np.int64)
    return (np.searchsorted(_LL_BASE_NP, ll, side="right") - 1).astype(np.int32)


def ml_code_np(match_lengths: np.ndarray) -> np.ndarray:
    """Vectorized match-length -> code (match length must be >= 3)."""
    ml = np.asarray(match_lengths, dtype=np.int64)
    return (np.searchsorted(_ML_BASE_NP, ml, side="right") - 1).astype(np.int32)


def of_code_np(offset_values: np.ndarray) -> np.ndarray:
    """Vectorized offset_value -> code = floor(log2(offset_value)), exact.

    offset_value = raw_offset + 3 for ordinary offsets (we never emit
    repcodes 1..3; always-explicit offsets are valid per RFC 8878 and match
    what libzstd does with searchForExternalRepcodes disabled, the mode the
    reference benchmark toggles via -E, test/benchmark.c:269-277).
    """
    ov = np.asarray(offset_values, dtype=np.uint32)
    code = np.zeros_like(ov, dtype=np.int32)
    v = ov.copy()
    for shift in (16, 8, 4, 2, 1):
        m = v >= (1 << shift)
        code[m] += shift
        v[m] >>= shift
    return code


# --------------------------------------------------------------------------
# Predefined FSE distributions (RFC 8878 §3.1.1.3.2.2).
# "Probability" -1 denotes a less-than-one probability (one state slot).
LL_DEFAULT_DIST = [
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
    -1, -1, -1, -1,
]
LL_DEFAULT_ACCURACY = 6

ML_DEFAULT_DIST = [
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
    -1, -1, -1, -1, -1,
]
ML_DEFAULT_ACCURACY = 6

OF_DEFAULT_DIST = [
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1,
]
OF_DEFAULT_ACCURACY = 5

# Maximum accuracy logs allowed by the format for each table kind.
LL_MAX_ACCURACY = 9
ML_MAX_ACCURACY = 9
OF_MAX_ACCURACY = 8

# Frame/block geometry (mirrors the reference's capability envelope,
# src/qatseqprod.c:97 ZSTD_BLOCKSIZE_MAX and :1123 window floor).
BLOCK_SIZE_MAX = 128 * 1024
MIN_WINDOW_LOG = 10
MAX_WINDOW_LOG = 31
