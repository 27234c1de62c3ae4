"""Device-side variable-length bit packing — sorts and scans only.

The missing primitive for on-device entropy coding is emitting a
*continuous LSB-first bitstream* from per-item (value, nbits) pairs when
nbits varies per item: every item lands at an arbitrary bit offset, which
looks like a scatter with colliding targets.

This module reformulates packing as pure vector algebra:

1. bit offsets = exclusive scan of nbits; each (<=64-bit) item spans at
   most 3 output words, with per-item variable shifts (elementwise ops);
2. contributions of items to a word have *disjoint bit ranges* (they are
   consecutive bitstream spans), so OR == ADD and per-word accumulation
   becomes modular prefix-sum differences;
3. "evaluate the prefix sum at each word boundary" is a rank query into a
   sorted sequence — solved with ONE merged sort (items keyed by their
   first word, word-queries keyed just after) followed by a hold-last
   associative scan and an extraction sort. No gathers anywhere.

Differentially tested against the golden BackwardBitWriter; the same
packer serves FSE sequence streams and Huffman literal streams.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _hold_last(carry_vals, carry_flags):
    """Associative 'last set value wins' scan along axis 1."""
    def combine(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    return jax.lax.associative_scan(combine, (carry_vals, carry_flags),
                                    axis=1)


def _u32_shr(x: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Logical right shift of int32-as-u32 by per-element s in [0,32)."""
    return jax.lax.shift_right_logical(x, s)


@functools.partial(jax.jit, static_argnames=("max_words",))
def bitpack(lo: jnp.ndarray, hi: jnp.ndarray, nbits: jnp.ndarray,
            max_words: int):
    """Pack per-item bitfields into LSB-first u32 word streams.

    lo/hi: (B, S) int32 — the low/high words of each item's value (value
      must already be masked to nbits; item order == write order).
    nbits: (B, S) int32 in [0, 64]; 0 = skip (value must be 0).
    max_words: static output capacity per block.

    Returns (words (B, max_words) int32, total_bits (B,) int32,
             overflow (B,) bool).
    """
    B, S = lo.shape
    W = max_words
    nb = nbits.astype(jnp.int32)
    boff = jnp.cumsum(nb, axis=1) - nb          # exclusive scan
    total_bits = boff[:, -1] + nb[:, -1]
    overflow = total_bits > W * 32

    w0 = boff >> 5
    sh = boff & 31
    inv = (32 - sh) & 31
    nz = sh > 0
    # 96-bit spread of the shifted 64-bit value (c0 -> w0, c1 -> w0+1, ...)
    c0 = lo << sh
    c1 = jnp.where(nz, _u32_shr(lo, inv), 0) | (hi << sh)
    c2 = jnp.where(nz, _u32_shr(hi, inv), 0)
    skip = nb == 0
    c0 = jnp.where(skip, 0, c0)
    c1 = jnp.where(skip, 0, c1)
    c2 = jnp.where(skip, 0, c2)
    # Items with nbits==0 must not perturb rank queries: park them at the
    # word their offset points to (they contribute zeros anyway).

    p0 = jnp.cumsum(c0, axis=1)
    p1 = jnp.cumsum(c1, axis=1)
    p2 = jnp.cumsum(c2, axis=1)

    # Merged rank query: items at key 2*w0, queries at 2*w+1 so every item
    # with first-word w sorts before query w.
    qw = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (B, W))
    keys = jnp.concatenate([w0 * 2, qw * 2 + 1], axis=1)
    flag = jnp.concatenate([jnp.ones((B, S), jnp.int32),
                            jnp.zeros((B, W), jnp.int32)], axis=1)
    v0 = jnp.concatenate([p0, jnp.zeros((B, W), jnp.int32)], axis=1)
    v1 = jnp.concatenate([p1, jnp.zeros((B, W), jnp.int32)], axis=1)
    v2 = jnp.concatenate([p2, jnp.zeros((B, W), jnp.int32)], axis=1)
    sk, sf, s0, s1, s2 = jax.lax.sort((keys, flag, v0, v1, v2),
                                      dimension=1, is_stable=True,
                                      num_keys=1)
    is_item = sf == 1
    (h0, _), (h1, _), (h2, _) = (
        _hold_last(s0, is_item), _hold_last(s1, is_item),
        _hold_last(s2, is_item))
    # Extract query rows in word order: queries keep relative order under
    # the stable sort, so a second stable sort on is_item brings the W
    # queries to the front in word order.
    qkey = jnp.where(is_item, jnp.int32(1), jnp.int32(0))
    _, e0, e1, e2 = jax.lax.sort((qkey, h0, h1, h2), dimension=1,
                                 is_stable=True, num_keys=1)
    t0 = e0[:, :W]   # T_r(w) = sum of c_r over items with w0 <= w
    t1 = e1[:, :W]
    t2 = e2[:, :W]

    def delta(t, r):
        tm = jnp.concatenate(
            [jnp.zeros((B, r + 1), jnp.int32), t[:, :W - r - 1]], axis=1) \
            if r + 1 > 0 else t
        tr = jnp.concatenate(
            [jnp.zeros((B, r), jnp.int32), t[:, :W - r]], axis=1) \
            if r > 0 else t
        return tr - tm

    words = delta(t0, 0) + delta(t1, 1) + delta(t2, 2)
    return words, total_bits, overflow


def backward_stream_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host-side: convert one block's packed words to the closed backward
    stream bytes (sentinel '1' + zero pad), given items already include
    everything up to (not including) the sentinel."""
    nbytes_full = (total_bits + 7) // 8
    raw = np.ascontiguousarray(words).view(np.uint8)[:nbytes_full + 1]
    out = bytearray(raw[:nbytes_full])
    used = total_bits & 7
    if used == 0:
        out.append(1)
    else:
        out[-1] |= 1 << used
    return bytes(out)
