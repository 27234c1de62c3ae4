"""Differential tests for the fused dense pipeline stages.

The dense production path merges dense-claim derivation + the LDM
slot-plane merge + slot compaction into one stage (compact_slots_dense),
and the sync head shares one 8-byte-gram hash between the pair selector
and the LDM minimizer plane. Each must be bit-identical to the separate
composition it replaced (merge_ldm + chosen-mask + compact_slots; the
standalone minimizer), on content that actually exercises LDM.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from qat_zstd_plugin_tpu.ops import glue_kernels as gk
from qat_zstd_plugin_tpu.ops.match_pipeline import MIN_MATCH


@pytest.fixture(scope="module")
def ldm_blocks():
    rng = np.random.default_rng(0)
    B, N = 8, 8192
    base = rng.integers(0, 12, N // 2, np.uint8).tobytes()
    data = (base + base) * B  # long-range dups at span distance
    blocks = jnp.asarray(np.frombuffer(data[:B * N], np.uint8)
                         .reshape(B, N))
    lengths = jnp.full((B,), N, jnp.int32)
    return blocks, lengths


def _unfused(blocks, lengths, widths, window, ldm):
    mlen, moff = gk.candidates_hash_split(blocks, lengths, widths=widths,
                                          neighbors=1, window=window)
    if ldm:
        su = gk.ldm_unsorted(blocks, ldm, neighbors=1)
        mlen, moff = gk.merge_ldm(mlen, moff, su, lengths, ldm,
                                  local_cap=4 * max(widths),
                                  max_off=1 << 19)
    chosen = (mlen >= MIN_MATCH).astype(jnp.int32)
    return gk.compact_slots(chosen, moff, window)


@pytest.mark.parametrize("widths,ldm", [((6,), 4), ((5, 8), 4),
                                        ((6,), 0)])
def test_fused_dense_matches_unfused(ldm_blocks, widths, ldm):
    blocks, lengths = ldm_blocks
    window = 4096
    ref = _unfused(blocks, lengths, widths, window, ldm)
    new = gk.find_matches_positions(blocks, lengths, widths=widths,
                                    window=window, ldm=ldm, dense=True)
    assert (np.asarray(ref) == np.asarray(new)).all()


def test_hash_keys_winmin_matches_separate(ldm_blocks):
    """The sync head's LDM minimizer plane (sharing its 8-byte-gram
    hash with the pair selector) equals the standalone minimizer pass."""
    blocks, _ = ldm_blocks
    window, width = 4096, 6
    stride = gk.ldm_stride(4, blocks.shape[1])
    key_f, minz_f = gk.hash_keys_winmin_sync(blocks, width, window, stride)
    minz_s = gk.ldm_winmin(blocks, stride)
    B, N = blocks.shape
    assert key_f.shape == (B * N // window, window // 2)
    assert (np.asarray(minz_f) == np.asarray(minz_s)).all()


def test_partial_batch_skips_ldm_cleanly():
    """Batches not divisible by the LDM span (tail batches) must route
    through the no-LDM dense path and still produce valid slot words
    (match_pipeline.find_matches_positions guard)."""
    from qat_zstd_plugin_tpu.ops import match_pipeline as mp
    rng = np.random.default_rng(3)
    B, N = 6, 4096  # 6 % 4 != 0
    blocks = jnp.asarray(rng.integers(0, 8, (B, N), np.uint8)
                         .astype(np.uint8))
    lengths = jnp.full((B,), N, jnp.int32)
    out = np.asarray(mp.find_matches_positions(
        blocks, lengths, widths=(6,), window=4096, ldm=4, dense=True))
    assert out.shape == (B, N // 4)
    assert (out != 0xFFFFFFFF).sum() > 0
