"""Finite State Entropy (tANS) encode path — golden model.

The zstd format defines FSE by its *decoding* table construction
(RFC 8878 §4.1): given normalized counts summing to 2^accuracy_log, symbols
are spread over the state table with step (size/2 + size/8 + 3), low-prob
(-1) symbols pinned at the table end. The encoder here builds the matching
compression table and emits bits such that stock libzstd's decoder walks the
same state machine in reverse.

The reference plugin never implements FSE (libzstd did); this module exists
because our framework owns entropy coding. It is the golden model that the
C++ native runtime (native/qz_entropy.cc) and the device packers are
differential-tested against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bitstream import BackwardBitWriter, ForwardBitReader, ForwardBitWriter


def spread_symbols(norm: list[int], accuracy_log: int) -> np.ndarray:
    """The canonical symbol-spread over the state table (RFC 8878 §4.1.1)."""
    size = 1 << accuracy_log
    mask = size - 1
    table = np.full(size, -1, dtype=np.int32)
    high = size - 1
    for s, c in enumerate(norm):
        if c == -1:
            table[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            table[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ValueError("corrupted normalized counts (spread did not close)")
    return table


@dataclass
class DecodeTable:
    """FSE decode table — used by golden decode tests and the device verifier."""
    accuracy_log: int
    symbol: np.ndarray      # (size,) int32
    nb_bits: np.ndarray     # (size,) int32
    next_state: np.ndarray  # (size,) int32 (baseline; add read bits)


def build_decode_table(norm: list[int], accuracy_log: int) -> DecodeTable:
    size = 1 << accuracy_log
    table = spread_symbols(norm, accuracy_log)
    symbol_next = np.array([1 if c == -1 else c for c in norm], dtype=np.int64)
    nb_bits = np.zeros(size, dtype=np.int32)
    next_state = np.zeros(size, dtype=np.int32)
    for u in range(size):
        s = table[u]
        x = int(symbol_next[s])
        symbol_next[s] += 1
        nb = accuracy_log - (x.bit_length() - 1)
        nb_bits[u] = nb
        next_state[u] = (x << nb) - size
    return DecodeTable(accuracy_log, table.astype(np.int32), nb_bits, next_state)


@dataclass
class EncodeTable:
    """FSE compression table (the mirror of the decode construction)."""
    accuracy_log: int
    # next-state lookup: index (state >> nbBits) + delta_find_state
    state_table: np.ndarray      # (size,) int32, values in [size, 2*size)
    delta_nb_bits: np.ndarray    # (nsymbols,) int64
    delta_find_state: np.ndarray  # (nsymbols,) int64


def build_encode_table(norm: list[int], accuracy_log: int) -> EncodeTable:
    size = 1 << accuracy_log
    nsym = len(norm)
    spread = spread_symbols(norm, accuracy_log)

    cumul = np.zeros(nsym + 1, dtype=np.int64)
    for s, c in enumerate(norm):
        cumul[s + 1] = cumul[s] + (1 if c == -1 else c)
    assert cumul[nsym] == size

    state_table = np.zeros(size, dtype=np.int32)
    fill = cumul[:nsym].copy()
    for u in range(size):
        s = spread[u]
        state_table[fill[s]] = size + u
        fill[s] += 1

    delta_nb = np.zeros(nsym, dtype=np.int64)
    delta_fs = np.zeros(nsym, dtype=np.int64)
    total = 0
    for s, c in enumerate(norm):
        if c == 0:
            # Symbol never emitted; poison so misuse fails loudly.
            delta_nb[s] = ((accuracy_log + 1) << 16) - (1 << accuracy_log)
            delta_fs[s] = 0
        elif c == -1 or c == 1:
            delta_nb[s] = (accuracy_log << 16) - (1 << accuracy_log)
            delta_fs[s] = total - 1
            total += 1
        else:
            max_bits_out = accuracy_log - ((c - 1).bit_length() - 1)
            min_state_plus = c << max_bits_out
            delta_nb[s] = (max_bits_out << 16) - min_state_plus
            delta_fs[s] = total - c
            total += c
    return EncodeTable(accuracy_log, state_table, delta_nb, delta_fs)


class FseEncoder:
    """Single FSE state machine writing into a shared BackwardBitWriter."""

    __slots__ = ("table", "state")

    def __init__(self, table: EncodeTable, first_symbol: int) -> None:
        # Initial state chosen so the decoder's final state read (the first
        # accuracy_log bits it consumes) yields `first_symbol` with no
        # preceding bits (FSE_initCState2 semantics).
        self.table = table
        tt_nb = int(table.delta_nb_bits[first_symbol])
        nb_out = (tt_nb + (1 << 15)) >> 16
        value = (nb_out << 16) - tt_nb
        idx = (value >> nb_out) + int(table.delta_find_state[first_symbol])
        self.state = int(table.state_table[idx])

    def encode(self, symbol: int, writer: BackwardBitWriter) -> None:
        t = self.table
        nb = (self.state + int(t.delta_nb_bits[symbol])) >> 16
        writer.add_masked(self.state, nb)
        idx = (self.state >> nb) + int(t.delta_find_state[symbol])
        self.state = int(t.state_table[idx])

    def flush(self, writer: BackwardBitWriter) -> None:
        writer.add_masked(self.state, self.table.accuracy_log)


# --------------------------------------------------------------------------
# Normalized-count (table description) serialization — RFC 8878 §4.1.1.


def write_ncount(norm: list[int], accuracy_log: int) -> bytes:
    """Serialize a normalized count table (forward bitstream)."""
    assert 5 <= accuracy_log <= 12
    size = 1 << accuracy_log
    w = ForwardBitWriter()
    w.add(accuracy_log - 5, 4)

    remaining = size + 1
    threshold = size
    nb_bits = accuracy_log + 1
    symbol = 0
    previous_is_0 = False
    nsym = len(norm)
    while remaining > 1 and symbol < nsym:
        if previous_is_0:
            start = symbol
            while symbol < nsym and norm[symbol] == 0:
                symbol += 1
            if symbol == nsym:
                raise ValueError("trailing zero counts beyond last symbol")
            run = symbol
            while run >= start + 24:
                start += 24
                w.add(0xFFFF, 16)
            while run >= start + 3:
                start += 3
                w.add(3, 2)
            w.add(run - start, 2)
        count = norm[symbol]
        symbol += 1
        vmax = (2 * threshold - 1) - remaining
        remaining -= -count if count < 0 else count
        count += 1  # +1 so that stored 0 means "-1" (less-than-one)
        if count >= threshold:
            count += vmax
        if count < vmax:
            w.add(count, nb_bits - 1)
        else:
            w.add(count, nb_bits)
        previous_is_0 = count == 1
        if remaining < 1:
            raise ValueError("normalized counts exceed table size")
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ValueError("normalized counts do not sum to table size")
    return w.close()


def read_ncount(data: bytes, max_symbol: int
                ) -> tuple[list[int], int, int]:
    """Golden-model NCount reader (self-check; oracle remains libzstd).

    Returns (norm_counts, accuracy_log, bytes_consumed).
    """
    r = ForwardBitReader(data)
    accuracy_log = r.read(4) + 5
    size = 1 << accuracy_log
    remaining = size + 1
    threshold = size
    nb_bits = accuracy_log + 1
    norm: list[int] = []
    previous_is_0 = False
    while remaining > 1:
        if previous_is_0:
            while True:
                rep = r.read(2)
                norm.extend([0] * rep)
                if rep != 3:
                    break
        vmax = (2 * threshold - 1) - remaining
        small = r.peek(nb_bits - 1)
        if small < vmax:
            r.read(nb_bits - 1)
            count = small
        else:
            full = r.read(nb_bits)
            count = full - vmax if full >= threshold else full
        count -= 1
        remaining -= -count if count < 0 else count
        norm.append(count)
        previous_is_0 = count == 0
        while remaining < threshold and remaining > 1:
            nb_bits -= 1
            threshold >>= 1
        if len(norm) > max_symbol + 1:
            raise ValueError("too many symbols in NCount")
    return norm, accuracy_log, r.byte_pos


# --------------------------------------------------------------------------
# Histogram normalization. Any normalization summing to 2^accuracy_log with
# all present symbols >= -1 is format-legal; we use largest-remainder with a
# low-probability cutoff, then repair the sum against the largest bucket.


def normalize_counts(hist: np.ndarray, accuracy_log: int,
                     total: int | None = None) -> list[int]:
    hist = np.asarray(hist, dtype=np.int64)
    if total is None:
        total = int(hist.sum())
    size = 1 << accuracy_log
    assert total > 0
    last = int(np.nonzero(hist)[0][-1])
    hist = hist[: last + 1]
    npresent = int((hist > 0).sum())
    if npresent == 1:
        raise ValueError("single-symbol histogram: use RLE mode instead")
    if npresent > size:
        raise ValueError("accuracy log too small for alphabet")

    scaled = hist.astype(np.float64) * size / total
    norm = np.floor(scaled).astype(np.int64)
    # Symbols present but with proportion < 1 state slot -> -1 (low prob).
    lowprob = (hist > 0) & (scaled < 1.0)
    norm[lowprob] = -1
    norm[(hist > 0) & (norm == 0) & ~lowprob] = 1

    def current_sum() -> int:
        return int(np.where(norm == -1, 1, norm).sum())

    delta = size - current_sum()
    if delta != 0:
        # Distribute by largest remainder (positive delta) or take from the
        # largest buckets (negative delta), never dropping a symbol below 1.
        # Stable sorts so tie-breaks match the native C++ encoder exactly.
        order = np.argsort(-(scaled - np.maximum(norm, 0)), kind="stable")
        i = 0
        while delta > 0:
            s = int(order[i % len(order)])
            if norm[s] >= 1:
                norm[s] += 1
                delta -= 1
            i += 1
            if i > 10 * len(order):  # degenerate: dump on the max bucket
                s = int(np.argmax(norm))
                norm[s] += delta
                delta = 0
        big = np.argsort(-norm, kind="stable")
        i = 0
        while delta < 0:
            s = int(big[i % len(big)])
            if norm[s] > 1:
                take = min(norm[s] - 1, -delta)
                norm[s] -= take
                delta += take
            i += 1
            if i > 10 * len(big):
                raise ValueError("cannot normalize histogram")
    if int(norm.max()) >= size:
        raise ValueError("single-symbol dominance: use RLE mode instead")
    assert current_sum() == size
    return [int(v) for v in norm]
