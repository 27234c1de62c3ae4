"""qat_zstd_plugin_tpu — an accelerator-native zstd-format codec.

A from-scratch re-imagining of intel/QAT-ZSTD-Plugin: where the reference
offloads LZ77 match finding of 128 KiB blocks to Intel QAT accelerators
and leaves entropy coding to libzstd, this framework runs match finding
as batched XLA/Pallas programs on a GPU and owns the complete zstd frame
(FSE/Huffman entropy coding included). Stock zstd >= 1.5.4 decodes every
frame bit-exactly.

Public API parity with the reference's five functions
(src/qatseqprod.h:72-151):

    QZSTD_version           -> version()
    QZSTD_startQatDevice    -> start_device() -> Status
    QZSTD_stopQatDevice     -> stop_device()
    QZSTD_createSeqProdState-> create_seqprod_state(level=...)
    QZSTD_freeSeqProdState  -> free_seqprod_state(state)
    qatSequenceProducer     -> sequence_producer(state, block) -> sequences

plus the frame-level surface the reference delegates to libzstd:

    compress(data, level=1)    -> complete zstd frame (bytes)
    decompress(frame)          -> bytes (via stock libzstd oracle)
"""

from __future__ import annotations

import numpy as np

from .format import tables
from .format.frame import BlockSequences
from .runtime.device import Status, start_device, stop_device, status
from .runtime.tpu_codec import TpuCodec

__version__ = "0.5.0"

# Sentinel mirroring ZSTD_SEQUENCE_PRODUCER_ERROR (src/qatseqprod.h:94-95).
SEQUENCE_PRODUCER_ERROR = object()

BLOCK_SIZE_MAX = tables.BLOCK_SIZE_MAX


def version() -> str:
    return __version__


class SeqProdState:
    """Per-stream producer state (QZSTD_createSeqProdState analog).

    Holds the codec instance (compiled-pipeline cache keyed on level/shape,
    the analog of the reference's per-session QAT session + intermediate
    buffer reuse, src/qatseqprod.c:1211-1220) and the failure counter."""

    def __init__(self, level: int = 1, batch: int = 8,
                 block_size: int = BLOCK_SIZE_MAX,
                 use_device: bool = False):
        self.level = level
        # use_device=True routes producer blocks through the device match
        # pipeline (batch=1 per call — the producer ABI is per-block);
        # False uses the native CPU matcher (the soft path).
        self.use_device = use_device
        self.codec = TpuCodec(level=level, batch=1 if use_device else batch,
                              block_size=block_size, use_device=use_device)
        self.freed = False


def create_seqprod_state(level: int = 1, **kw) -> SeqProdState:
    return SeqProdState(level=level, **kw)


def free_seqprod_state(state: SeqProdState) -> None:
    state.freed = True
    state.codec = None


def sequence_producer(state: SeqProdState, block: bytes | np.ndarray,
                      window_size: int | None = None):
    """Block-level producer: returns a list of (offset, lit_length,
    match_length) triples plus a final literals-only entry — the exact
    ZSTD_Sequence contract (src/qatseqprod.h:85-95, and the final
    literal-only sequence convention of QZSTD_decLz4s,
    src/qatseqprod.c:1037-1045). Returns SEQUENCE_PRODUCER_ERROR on any
    failure so callers can fall back, mirroring the producer ABI."""
    if state is None or state.freed:
        return SEQUENCE_PRODUCER_ERROR
    buf = np.frombuffer(block, np.uint8) if not isinstance(
        block, np.ndarray) else block
    n = len(buf)
    if n > BLOCK_SIZE_MAX:
        return SEQUENCE_PRODUCER_ERROR  # srcSize cap, src/qatseqprod.c:1204
    if window_size is not None and window_size < min(n, 32 * 1024):
        return SEQUENCE_PRODUCER_ERROR  # window floor, src/qatseqprod.c:1123
    try:
        from . import native
        from .golden import codec as golden_codec
        seqs = None
        if state.use_device and n >= 64:
            # Device route: one-block batch through the device match pipeline
            # (pad to the codec block shape; the pipeline masks by length),
            # then native extension recovers full match lengths from the
            # device's LCP-capped candidates.
            pad = np.zeros(state.codec.block_size, np.uint8)
            pad[:n] = buf
            got = state.codec.produce_sequences(
                pad[None, :], np.array([n], np.int32))[0]
            if got is not None:
                if native.available() and got.nseq:
                    ll, of, ml, lastlit = native.extend_sequences(
                        buf, got.lit_lengths, got.offsets,
                        got.match_lengths, got.last_literals)
                    seqs = BlockSequences(ll, of, ml, lastlit)
                else:
                    seqs = got
        if seqs is None:
            if native.available():
                gp = golden_codec.level_params(state.level)
                ll, of, ml, lastlit = native.find_sequences(
                    buf, gp.chain_depth, gp.lazy, mml=gp.mml)
                seqs = BlockSequences(ll, of, ml, lastlit)
            else:
                seqs = golden_codec.compress_block_sequences(
                    buf, state.level)
    except Exception:
        return SEQUENCE_PRODUCER_ERROR
    out = [(int(o), int(l), int(m)) for l, o, m in
           zip(seqs.lit_lengths, seqs.offsets, seqs.match_lengths)]
    out.append((0, int(seqs.last_literals), 0))
    return out


def compress_via_libzstd(data: bytes, level: int = 1,
                         use_device: bool = False,
                         search_repcodes: bool = False) -> bytes:
    """The reference's exact deployment shape: stock libzstd compresses,
    calling our registered sequence producer per block (fallback enabled),
    as in test/test.c:103-116. use_device=True sends blocks through the
    device match pipeline."""
    from . import oracle
    st = create_seqprod_state(level=level, use_device=use_device)
    try:
        def produce(block, lvl, wsize):
            out = sequence_producer(st, block, window_size=wsize)
            return None if out is SEQUENCE_PRODUCER_ERROR else out
        return oracle.compress_with_producer(
            data, produce, level=level, fallback=True,
            search_repcodes=search_repcodes)
    finally:
        free_seqprod_state(st)


def compress_stream_via_libzstd(data: bytes, level: int = 1,
                                use_device: bool = False,
                                chunk_size: int = 64 * 1024,
                                flush_every: int = 0,
                                search_repcodes: bool = False) -> bytes:
    """The reference's CLI deployment shape: stock libzstd's STREAMING
    compressor (ZSTD_compressStream2, the API the patched zstd CLI pumps
    — reference README.md:180-217) with our producer registered. Chunked
    pumps and explicit flush points exercise the partial-window and
    forced-block-boundary producer interactions ZSTD_compress2 never
    reaches (zstd's stream_round_trip fuzz family,
    reference test/fuzzing/README.md:17-28)."""
    from . import oracle
    st = create_seqprod_state(level=level, use_device=use_device)
    try:
        def produce(block, lvl, wsize):
            out = sequence_producer(st, block, window_size=wsize)
            return None if out is SEQUENCE_PRODUCER_ERROR else out
        return oracle.compress_stream_with_producer(
            data, produce, level=level, fallback=True,
            chunk_size=chunk_size, flush_every=flush_every,
            search_repcodes=search_repcodes)
    finally:
        free_seqprod_state(st)


def compress(data: bytes | np.ndarray, level: int = 1,
             block_size: int = BLOCK_SIZE_MAX, checksum: bool = True,
             use_device: bool | None = None, batch: int = 8) -> bytes:
    """Compress to a complete zstd frame.

    use_device=None auto-selects: device pipeline when a GPU is available,
    the software path otherwise (the soft-fallback posture of the
    reference, README.md:197-198)."""
    if use_device is None:
        st = start_device()
        use_device = st == Status.OK
    codec = TpuCodec(level=level, batch=batch, block_size=block_size,
                     use_device=use_device)
    return codec.compress(data, checksum=checksum)


def decompress(frame_bytes: bytes, expected_size: int | None = None
               ) -> bytes:
    """Decode a zstd frame. Prefers stock libzstd (decompression stays
    software in the reference too — test/benchmark.c uses a plain DCtx);
    falls back to the in-repo golden decoder when libzstd is absent, so
    the framework is self-contained."""
    from . import oracle
    if oracle.available():
        return oracle.decompress(frame_bytes, expected_size)
    from .golden import decoder as golden_decoder
    return golden_decoder.decompress(frame_bytes, max_output=expected_size)
