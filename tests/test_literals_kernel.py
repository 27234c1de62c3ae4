"""Device Huffman literals: section round-trips through stock zstd when
combined with a host sequences section from the same parse."""

from pathlib import Path

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from qat_zstd_plugin_tpu import oracle  # noqa: E402
from qat_zstd_plugin_tpu.format import frame, sequences as seqmod  # noqa: E402
from qat_zstd_plugin_tpu.ops import literals_kernel as lk  # noqa: E402
from qat_zstd_plugin_tpu.ops import match_pipeline as mp  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _pipeline(buf, N):
    """Content matcher (exact LCP): device-entropy paths must not encode
    unverified hash-matcher claims (tpu_codec._pipeline's constraint)."""
    blocks = jnp.asarray(buf[None, :])
    lengths = jnp.asarray(np.array([N], np.int32))
    w = min(32768, len(buf))
    mlen, moff = mp.candidates(blocks, lengths, neighbors=2, window=w)
    chosen = mp.parse_greedy_scan(mlen)
    out = mp.compact(chosen, mlen, moff, lengths, 16384, window=w)
    return blocks, lengths, mlen, chosen, out


def test_device_literals_section_bit_exact():
    rng = np.random.default_rng(5)
    text = (open(REPO / "SURVEY.md", "rb").read() * 5)[:131072]
    buf = np.frombuffer(text, np.uint8).copy()
    buf[60000:62000] = rng.integers(0, 256, 2000, np.uint8)
    N = len(buf)
    blocks, lengths, mlen, chosen, out = _pipeline(buf, N)
    dev = lk.encode_literals_device(blocks, lengths, chosen, mlen)
    dev = {k: np.asarray(v) for k, v in dev.items()}
    assert bool(dev["ok"][0]), dev["n_lit"]

    # Expected literal count from the compact output.
    o = {k: np.asarray(v) for k, v in out.items()}
    ns = int(o["nseq"][0])
    exp_nlit = int(o["lit_len"][0, :ns].sum() + o["last_literals"][0])
    assert int(dev["n_lit"][0]) == exp_nlit

    lit_sec = lk.device_literals_section(
        dev["nb_bits"][0], dev["codes"][0], dev["max_bits"][0],
        dev["last_symbol"][0], int(dev["n_lit"][0]),
        dev["words"].reshape(1, 4, -1)[0], dev["bits"].reshape(1, 4)[0])
    assert lit_sec is not None

    seq_sec = seqmod.encode_sequences(
        o["lit_len"][0, :ns].astype(np.int64),
        o["offset"][0, :ns].astype(np.int64),
        o["match_len"][0, :ns].astype(np.int64))
    body = lit_sec + seq_sec
    f = frame.assemble_frame(buf, [body], N, checksum=True)
    assert oracle.decompress(f, N) == buf.tobytes()


def test_device_literals_small_block_opts_out():
    buf = np.frombuffer(b"ab" * 300, np.uint8)
    N = len(buf)
    # pad to pow2 block for the pipeline
    pad = np.zeros(1024, np.uint8)
    pad[:N] = buf
    blocks, lengths, mlen, chosen, out = _pipeline(pad, N)
    dev = lk.encode_literals_device(blocks, lengths, chosen, mlen)
    assert not bool(np.asarray(dev["ok"])[0])  # host path handles it
