"""Golden CPU codec: full compress pipeline without any accelerator.

This is the framework's software-fallback path — the role libzstd's internal
compressor plays when the reference plugin's producer errors out
(`ZSTD_c_enableSeqProducerFallback`, README.md:197-198, test/test.c:109) —
and the correctness spec for the device pipeline.

Levels 1-12 mirror the reference's supported range
(src/qatseqprod.c:86-87, 1132-1137): higher level = deeper chain search +
lazy parse; entropy choices are identical across levels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..format import frame, tables
from ..format.frame import BlockSequences
from . import matcher

MIN_LEVEL = 1
MAX_LEVEL = 12


@dataclass(frozen=True)
class LevelParams:
    chain_depth: int
    lazy: bool
    custom_tables: bool = True
    huffman: bool = True
    # Stream window (cross-block match context), zstd-informed ladder:
    # offsets may reach this far back into earlier blocks' raw bytes.
    # The reference's stateless blocks have no such history, but stock
    # zstd does — parity on multi-block streams requires it.
    window_log: int = 19
    # General minimum match length: sequences cost ~10 bits + offset
    # bits while literals cost ~5-6 bits post-Huffman, so short matches
    # lose except very near (the matcher keeps 4-byte matches <= 1K and
    # 3-byte <= 64 offsets, and rep continuations at any length; 0 =
    # adaptive post-parse pruning by measured literal entropy). Stock
    # zstd's fast levels pick 6-7 for the same economics. Measured: 6
    # wins at fast levels (-1 ratio point on mixed data), 4 at deep
    # levels where the lazy search finds quality short matches.
    mml: int = 6


LEVEL_TABLE: dict[int, LevelParams] = {
    1: LevelParams(2, False, window_log=19, mml=6),
    2: LevelParams(4, False, window_log=20, mml=6),
    3: LevelParams(8, False, window_log=21, mml=6),
    4: LevelParams(16, False, window_log=21, mml=6),
    5: LevelParams(8, True, window_log=21, mml=4),
    6: LevelParams(16, True, window_log=21, mml=4),
    7: LevelParams(32, True, window_log=22, mml=4),
    8: LevelParams(48, True, window_log=22, mml=4),
    9: LevelParams(64, True, window_log=22, mml=4),
    10: LevelParams(96, True, window_log=22, mml=4),
    11: LevelParams(128, True, window_log=22, mml=4),
    12: LevelParams(256, True, window_log=22, mml=4),
}


def level_params(level: int) -> LevelParams:
    if not MIN_LEVEL <= level <= MAX_LEVEL:
        raise ValueError(
            f"unsupported level {level}: supported range "
            f"{MIN_LEVEL}..{MAX_LEVEL}")  # same guard as qatseqprod.c:1132
    return LEVEL_TABLE[level]


def compress_block_sequences(block: np.ndarray, level: int
                             ) -> BlockSequences:
    """The block-level sequence producer (golden): the direct analog of
    `qatSequenceProducer` (src/qatseqprod.c:1106) minus the hardware."""
    p = level_params(level)
    return matcher.find_sequences(block, chain_depth=p.chain_depth,
                                  lazy=p.lazy, mml=p.mml)


def compress(data: bytes | np.ndarray, level: int = 1,
             block_size: int = tables.BLOCK_SIZE_MAX,
             checksum: bool = True, validate: bool = False) -> bytes:
    """Compress to a complete zstd frame, CPU-only golden path."""
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data, dtype=np.uint8)
    p = level_params(level)
    n = len(buf)
    nblocks = max(1, -(-n // block_size))
    bodies: list[bytes | None] = []
    for i in range(nblocks):
        blk = buf[i * block_size:(i + 1) * block_size]
        if len(blk) < 64:
            bodies.append(None)  # tiny blocks: raw wins after overhead
            continue
        seqs = compress_block_sequences(blk, level)
        if validate:
            matcher.validate_sequences(blk, seqs)
        try:
            bodies.append(frame.encode_block_body(
                blk, seqs, allow_custom_tables=p.custom_tables,
                try_huffman=p.huffman, first_block=(i == 0)))
        except ValueError:
            bodies.append(None)  # per-block fallback to raw
    return frame.assemble_frame(buf, bodies, block_size, checksum)
