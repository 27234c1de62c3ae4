"""Golden-model LZ77 match finder (CPU, exact, slow).

This is the correctness spec the device pipeline is tested against — the role
stock zstd's internal match finder plays for the reference plugin (its
software fallback, README.md:197-198). Classic greedy hash-chain search:

* 4-byte hashes, chain depth bounded by `chain_depth`;
* greedy parse with optional 1-position lazy step (levels >= 5);
* minimum match 3 bytes like the reference's LZ4s contract
  (src/qatseqprod.c:1060-1062, +LZ4MINMATCH bias), though we only take
  3-byte matches at short offsets where they pay for themselves;
* offsets bounded by the block-local window (blocks independent, mirroring
  the reference's stateless sessions, src/qatseqprod.c:941).

Pure Python per-position loop: O(n * depth), meant for tests and small
inputs. The fast CPU path lives in the native C++ runtime; the fast device
path is the Pallas/XLA pipeline in ops/.
"""

from __future__ import annotations

import numpy as np

from ..format.frame import BlockSequences

HASH_LOG = 15
MIN_MATCH = 3
# Conditional-lazy bar for greedy levels — MUST match the native
# QZ_CHAIN_LAZY_BAR default (qz_entropy.cc); the native/golden
# byte-identical differential (test_native.py) enforces the pairing,
# so a native rebuild with a -D override will fail that test loudly
# rather than silently diverge.
CHAIN_LAZY_BAR = 32


def _hash4(v: int) -> int:
    return ((v * 2654435761) & 0xFFFFFFFF) >> (32 - HASH_LOG)


def find_sequences(block: np.ndarray, chain_depth: int = 8,
                   lazy: bool = False, max_offset: int | None = None,
                   mml: int = 4) -> BlockSequences:
    """Greedy/lazy hash-chain match search over one block. mml is the
    general minimum match length (short matches only pay near; native
    parity)."""
    data = np.asarray(block, dtype=np.uint8)
    n = len(data)
    if max_offset is None:
        max_offset = n
    if n < MIN_MATCH + 1:
        z = np.zeros(0, np.int64)
        return BlockSequences(z, z, z, n)

    buf = data.tobytes()
    # 4-byte little-endian words at each position (vectorized precompute).
    pad = np.concatenate([data, np.zeros(4, np.uint8)])
    words = (pad[:n].astype(np.uint32)
             | (pad[1:n + 1].astype(np.uint32) << 8)
             | (pad[2:n + 2].astype(np.uint32) << 16)
             | (pad[3:n + 3].astype(np.uint32) << 24))
    hashes = ((words * np.uint32(2654435761)) >> np.uint32(32 - HASH_LOG))

    head = np.full(1 << HASH_LOG, -1, dtype=np.int64)   # hash -> latest pos
    prev = np.full(n, -1, dtype=np.int64)               # chain links

    def insert(pos: int) -> None:
        h = hashes[pos]
        prev[pos] = head[h]
        head[h] = pos

    def best_match(pos: int) -> tuple[int, int, int]:
        """(length, offset, score) of the best match at pos; score is
        offset-priced (native parity, r5): a candidate pays ~1 byte per
        8 offset bits plus a flat explicit-offset penalty, and the cost
        floor applies per candidate so a far long candidate cannot
        shadow a near one that passes the floor."""
        limit = n - pos
        if limit < MIN_MATCH:
            return 0, 0, -(1 << 31)
        best_len, best_off, best_score = 0, 0, -(1 << 31)
        cand = head[hashes[pos]]
        depth = chain_depth
        lo = pos - max_offset
        while cand >= 0 and depth > 0 and cand >= lo:
            l = 0
            while l < limit and buf[cand + l] == buf[pos + l]:
                l += 1
            o = int(pos - cand)
            ok = l >= mml or (l >= 4 and o <= 1024) or (l == 3 and o <= 64)
            if l < 6 and o > 65536:
                ok = False
            if ok:
                sc = l * 8 - o.bit_length() + 1 - 8
                if sc > best_score:
                    best_len, best_off, best_score = l, o, sc
            cand = prev[cand]
            depth -= 1
        if not best_len:
            return 0, 0, -(1 << 31)
        return best_len, best_off, best_score

    def rep_probe(pos: int, rep: int) -> int:
        """LCP at the previous sequence's offset (cheap rep continuation;
        native-matcher parity)."""
        if rep == 0 or pos < rep:
            return 0
        limit = n - pos
        l = 0
        while l < limit and buf[pos - rep + l] == buf[pos + l]:
            l += 1
        return l

    lls, offs, mls = [], [], []
    lit_start = 0
    insert(0)
    inserted_up_to = 1  # positions [0, inserted_up_to) are in the chains
    pos = 1
    rep = 0
    while pos < n:
        length, off, score = best_match(pos)
        lr = rep_probe(pos, rep)
        took_rep = False
        # Rep continuation pays no offset bits: it competes at its full
        # length against the priced candidate score (native parity).
        if lr >= 3 and lr * 8 >= score:
            length, off, score = lr, rep, lr * 8
            took_rep = True
        if length == 0:
            if pos >= inserted_up_to:
                insert(pos)
                inserted_up_to = pos + 1
            pos += 1
            continue
        # Conditional one-step lazy on short finds at greedy levels
        # (native parity, r5: QZ_CHAIN_LAZY_BAR — de-fragments the
        # parse the same way the fast matcher's mini-lazy does).
        if (lazy or length < CHAIN_LAZY_BAR) and pos + 1 < n \
                and not took_rep:
            if pos >= inserted_up_to:
                insert(pos)
                inserted_up_to = pos + 1
            nlen, noff, nscore = best_match(pos + 1)
            if nlen and nscore > score + 8:
                # Take the literal; the better match starts one later.
                if pos + 1 >= inserted_up_to:
                    insert(pos + 1)
                    inserted_up_to = pos + 2
                pos += 1
                length, off = nlen, noff
        # Backward extension into the pending literal run (native parity).
        while pos > lit_start and pos >= off + 1 \
                and data[pos - 1] == data[pos - 1 - off]:
            pos -= 1
            length += 1
        lls.append(pos - lit_start)
        offs.append(off)
        mls.append(length)
        rep = off
        end = pos + length
        # Insert match-covered positions (sampled on very long matches).
        step = 1 if length <= 64 else max(1, length // 32)
        p = inserted_up_to if inserted_up_to > pos else pos
        while p < min(end, n):
            insert(p)
            p += step
        inserted_up_to = min(end, n)
        pos = end
        lit_start = end
    last_literals = n - lit_start
    return BlockSequences(
        np.asarray(lls, dtype=np.int64), np.asarray(offs, dtype=np.int64),
        np.asarray(mls, dtype=np.int64), last_literals)


def validate_sequences(block: np.ndarray, seqs: BlockSequences,
                       ctx_len: int = 0) -> None:
    """Assert a sequence set is frame-legal AND byte-faithful for `block`.

    This is the guard the format layer deliberately omits (it trusts its
    producer, like libzstd trusts the reference's callback); every matcher
    path runs through here in tests. `block` may carry ctx_len bytes of
    window context at the front (cross-block offsets resolve into it);
    the sequences cover only the trailing block.
    """
    data = np.asarray(block, dtype=np.uint8)
    n = len(data) - ctx_len
    pos = ctx_len
    for i in range(seqs.nseq):
        ll = int(seqs.lit_lengths[i])
        off = int(seqs.offsets[i])
        ml = int(seqs.match_lengths[i])
        assert ll >= 0 and ml >= MIN_MATCH, (i, ll, ml)
        pos += ll
        assert 1 <= off <= pos, f"seq {i}: offset {off} at pos {pos}"
        # Byte-faithfulness: overlap-aware compare.
        for k in range(ml):
            assert data[pos + k] == data[pos + k - off], \
                f"seq {i}: mismatch at +{k}"
        pos += ml
    assert pos + seqs.last_literals == ctx_len + n, "span mismatch"


def execute_sequences(block_len: int, literals: np.ndarray,
                      seqs: BlockSequences) -> np.ndarray:
    """Regenerate block bytes from (literals, sequences) — golden decoder
    for kernel unit tests (sequence-execution half only)."""
    out = np.zeros(block_len, dtype=np.uint8)
    lpos = 0
    pos = 0
    for i in range(seqs.nseq):
        ll = int(seqs.lit_lengths[i])
        out[pos:pos + ll] = literals[lpos:lpos + ll]
        pos += ll
        lpos += ll
        off = int(seqs.offsets[i])
        for k in range(int(seqs.match_lengths[i])):
            out[pos + k] = out[pos + k - off]
        pos += int(seqs.match_lengths[i])
    out[pos:pos + seqs.last_literals] = literals[lpos:lpos + seqs.last_literals]
    return out
