"""Huffman literals encoding — golden model (RFC 8878 §4.2).

zstd Huffman specifics owned here:
* length-limited canonical codes (max 11 bits), complete (Kraft sum == 1,
  required because the decoder derives the last symbol's weight to complete a
  power of two);
* weight serialization: direct 4-bit nibbles, or FSE-compressed weights using
  the two-state interleaved FSE scheme;
* backward bitstreams, literals encoded last-symbol-first so the decoder
  regenerates forward; 1-stream and 4-stream (jump table) layouts.

The reference plugin left all of this to libzstd; this golden model is the
spec for the C++ native encoder and the device packers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import fse
from .bitstream import BackwardBitWriter

MAX_CODE_BITS = 11
MAX_FSE_WEIGHT_ACCURACY = 6


@dataclass
class HuffmanTable:
    nb_bits: np.ndarray   # (256,) int32, 0 = symbol absent
    codes: np.ndarray     # (256,) int32
    max_bits: int
    last_symbol: int      # largest present symbol


def _package_merge_lengths(hist: np.ndarray, present: np.ndarray,
                           limit: int) -> np.ndarray:
    """OPTIMAL length-limited code lengths via package-merge.

    The previous builder (plain Huffman, clamp to the limit, greedy Kraft
    repair) measured ~3.5 KB/2 MB worse than optimal on the mixed corpus
    — the greedy repair shortens by frequency without weighing budget
    efficiency. Package-merge (Larmore–Hirschberg) is exact: build coin
    lists level by level (denomination 2^-limit first), package pairs,
    merge with the leaf list; the first 2n-2 items of the final list are
    selected and each leaf's selection count is its code length.

    Tie-breaking is deterministic (leaves sorted by (freq, symbol);
    stable merge puts leaves before equal-frequency packages) and is
    mirrored EXACTLY by the C++ builder (native/qz_entropy.cc
    build_huffman) so host outputs stay byte-identical across paths.
    """
    leaves = sorted((int(hist[s]), int(s)) for s in present)
    n = len(leaves)
    # Items: (freq, payload); payload = ('L', sym) | ('P', a, b). The
    # level-limit list is the bare leaves; each of the limit-1 rounds
    # packages consecutive pairs and merges with the leaves, ending on
    # the level-1 list, from which the first 2n-2 items are selected.
    prev: list[tuple[int, tuple]] = []
    for _ in range(limit - 1):
        cur = [(f, ("L", s)) for f, s in leaves] + prev
        cur.sort(key=lambda t: t[0])  # stable: leaves precede packages
        prev = [(cur[i][0] + cur[i + 1][0], ("P", cur[i][1], cur[i + 1][1]))
                for i in range(0, len(cur) - 1, 2)]
    top = [(f, ("L", s)) for f, s in leaves] + prev
    top.sort(key=lambda t: t[0])
    lengths = np.zeros(256, dtype=np.int64)
    stack = [payload for _, payload in top[: 2 * n - 2]]
    while stack:
        it = stack.pop()
        if it[0] == "L":
            lengths[it[1]] += 1
        else:
            stack.append(it[1])
            stack.append(it[2])
    return lengths


def build_table(hist: np.ndarray) -> HuffmanTable:
    """Length-limited canonical Huffman table from a byte histogram."""
    hist = np.asarray(hist, dtype=np.int64)
    present = np.nonzero(hist)[0]
    if len(present) < 2:
        raise ValueError("degenerate alphabet: use RLE/raw literals instead")

    lengths = _package_merge_lengths(hist, present, MAX_CODE_BITS)
    unit = 1 << MAX_CODE_BITS
    kraft = int(sum(unit >> int(lengths[s]) for s in present))
    assert kraft == unit, kraft  # package-merge codes are complete

    max_bits = int(lengths[present].max())
    # 3. Canonical code values (mirrors libzstd's valPerRank assignment so
    # codes index the decoder's rank-ordered table layout).
    nb_per_rank = np.zeros(MAX_CODE_BITS + 2, dtype=np.int64)
    for s in present:
        nb_per_rank[int(lengths[s])] += 1
    val_per_rank = np.zeros(MAX_CODE_BITS + 2, dtype=np.int64)
    mn = 0
    for n in range(max_bits, 0, -1):
        val_per_rank[n] = mn
        mn += int(nb_per_rank[n])
        mn >>= 1
    codes = np.zeros(256, dtype=np.int64)
    for s in range(256):
        l = int(lengths[s])
        if l > 0:
            codes[s] = val_per_rank[l]
            val_per_rank[l] += 1
    return HuffmanTable(lengths.astype(np.int32), codes.astype(np.int32),
                        max_bits, int(present[-1]))


def weights(table: HuffmanTable) -> list[int]:
    """Weights for symbols 0..last_symbol-1 (last symbol's weight derived)."""
    out = []
    for s in range(table.last_symbol):
        nb = int(table.nb_bits[s])
        out.append(0 if nb == 0 else table.max_bits + 1 - nb)
    return out


def _fse_compress_weights(ws: list[int]) -> bytes | None:
    """Two-state interleaved FSE compression of the weight list."""
    if len(ws) < 2:
        return None
    hist = np.bincount(np.asarray(ws, dtype=np.int64), minlength=13)
    if int((hist > 0).sum()) < 2:
        return None  # single-valued: FSE can't help (RLE not allowed here)
    # Format floor: FSE accuracy logs are >= 5 (RFC 8878 4-bit AL field
    # counts from 5), even for tiny weight alphabets.
    max_al = min(MAX_FSE_WEIGHT_ACCURACY,
                 max(5, (len(ws) - 1).bit_length()))
    try:
        norm = fse.normalize_counts(hist, max_al, total=len(ws))
    except ValueError:
        return None
    desc = fse.write_ncount(norm, max_al)
    enc_table = fse.build_encode_table(norm, max_al)
    w = BackwardBitWriter()
    n = len(ws)
    # C1 handles even indices, C2 odd; inits consume the top index of each
    # parity, then strictly alternating descending encodes, flush C2 then C1.
    if n % 2 == 1:
        c1 = fse.FseEncoder(enc_table, ws[n - 1])
        c2 = fse.FseEncoder(enc_table, ws[n - 2])
        start = n - 3
    else:
        c2 = fse.FseEncoder(enc_table, ws[n - 1])
        c1 = fse.FseEncoder(enc_table, ws[n - 2])
        start = n - 3
    i = start
    while i >= 0:
        (c2 if i % 2 == 1 else c1).encode(ws[i], w)
        i -= 1
    c2.flush(w)
    c1.flush(w)
    stream = w.close()
    out = desc + stream
    if len(out) >= 128 or len(out) >= len(ws):
        return None
    return out


def serialize_tree(table: HuffmanTable) -> bytes:
    """Huffman_Tree_Description: header byte + weights."""
    ws = weights(table)
    fse_ws = _fse_compress_weights(ws)
    n = len(ws)
    direct: bytes | None = None
    if n <= 128:
        body = bytearray()
        for i in range(0, n, 2):
            hi = ws[i] << 4
            lo = ws[i + 1] if i + 1 < n else 0
            body.append(hi | lo)
        direct = bytes([127 + n]) + bytes(body)
    if fse_ws is not None and (direct is None or len(fse_ws) + 1 < len(direct)):
        return bytes([len(fse_ws)]) + fse_ws
    if direct is None:
        raise ValueError("cannot serialize huffman tree (too many weights)")
    return direct


def _encode_stream(data: np.ndarray, table: HuffmanTable) -> bytes:
    """One backward Huffman stream: symbols encoded last-first."""
    w = BackwardBitWriter()
    nb = table.nb_bits
    codes = table.codes
    for b in data[::-1]:
        w.add(int(codes[b]), int(nb[b]))
    return w.close()


def encode_literals(data: np.ndarray, table: HuffmanTable,
                    four_streams: bool) -> bytes:
    """Huffman-coded literal payload (streams only, no headers/tree)."""
    if not four_streams:
        return _encode_stream(data, table)
    n = len(data)
    seg = (n + 3) // 4
    if n - 3 * seg < 1:
        # 4th stream would be empty/negative (n in {0..3, 5, 6, 9}):
        # format-invalid; callers must use the single-stream layout.
        raise ValueError(f"input too small for 4-stream layout: {n}")
    parts = [data[0:seg], data[seg:2 * seg], data[2 * seg:3 * seg],
             data[3 * seg:n]]
    streams = [_encode_stream(p, table) for p in parts]
    jump = b"".join(len(s).to_bytes(2, "little") for s in streams[:3])
    if any(len(s) > 0xFFFF for s in streams[:3]):
        raise ValueError("stream too large for jump table")
    return jump + b"".join(streams)
