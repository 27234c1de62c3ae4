"""Device-accelerated codec: host orchestration around the device pipeline.

The shape of this module mirrors the reference's offload hot path
(qatSequenceProducer, src/qatseqprod.c:1106-1336) translated to the XLA
execution model:

* the reference's submit -> busy-poll loop (:1243-1272) becomes async XLA
  dispatch — device futures instead of icp_sal_DcPollInstance polling;
* the LZ4s token decode on CPU (:1013-1091) becomes the device-side
  compaction plus this module's vectorized coalesce (capped matches chained
  at constant offset are merged back into full-length matches);
* any per-block failure (sequence-capacity overflow, short block) falls
  back to the golden CPU matcher, the analog of
  ZSTD_c_enableSeqProducerFallback (README.md:197-198);
* entropy coding + frame assembly stay on host by default (the C++
  native runtime is the fast path; format/ golden is the fallback); the
  device_entropy modes move them onto the device.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native
from ..format import frame, tables
from ..format.frame import BlockSequences
from ..golden import codec as golden_codec
from ..golden import matcher as golden_matcher
from ..utils import config, logging
from ..utils.profiling import BlockStats, Timer
from . import backend, device

BLOCK = tables.BLOCK_SIZE_MAX


@dataclasses.dataclass(frozen=True)
class TpuLevelParams:
    """Device-path level knobs (golden levels map depth; here sort-neighbor
    depth plays the chain-depth role, and lazy engages at L5 like the
    golden/reference-style ladder)."""
    neighbors: int
    lazy: bool = False
    stride: int = 1
    window: int = 1 << 30  # match window (segmented candidate sorts)
    custom_tables: bool = True
    huffman: bool = True
    # matcher="hash": single-word-sort fast path (quantized claim widths,
    # host-verified — requires the native runtime); "content": exact-LCP
    # sorts carrying content words.
    matcher: str = "content"
    widths: tuple = (4, 8)
    # Hash-path tuning: psegs parse-segments each block (more parallel
    # rows, fewer sequential steps; claims stay host-verified so
    # segment-end truncation is ratio-free).
    psegs: int = 1
    # Long-distance matching: span size in blocks (0 = off). Samples
    # 8-byte grams over sliding ldm-block spans so candidates at up to
    # 512 KiB compete in the parse — the device-side answer to stock
    # zstd's streaming window (glue_kernels.merge_ldm).
    ldm: int = 0
    # Dense claims: skip the device parse, claim every candidate slot,
    # and let the host extension walk (true bytes) parse. Better ratio
    # than the est-greedy device parse and one fewer pipeline stage.
    dense: bool = False
    # Syncmer anchors: sample one anchor per byte pair, selected by the
    # smaller 8-byte-gram hash (content-determined, so any-parity offsets
    # stay discoverable). Halves the dominant sort volume — the fastest
    # speed point (glue_kernels.hash_keys_winmin_sync).
    sync: bool = False


# Fast levels ride the hash matcher (single-operand sorts, a fraction of
# the bytes of a multi-operand sort); higher levels keep exact-LCP content
# sorts with progressively wider windows. L1 is the syncmer speed point (pair-
# sampled anchors, half the sort volume — the throughput analog of the
# QAT DC engine's L1 rating); L2 keeps full-resolution anchors at the
# same width for ~1% better ratio at ~55% of the speed.
TPU_LEVEL_TABLE = {
    1: TpuLevelParams(1, window=32768, matcher="hash", widths=(6,),
                      ldm=4, dense=True, sync=True),
    2: TpuLevelParams(1, window=32768, matcher="hash", widths=(6,),
                      ldm=4, dense=True),
    3: TpuLevelParams(1, window=32768, matcher="hash", widths=(5, 8),
                      ldm=8, dense=True),
    4: TpuLevelParams(2, window=32768, matcher="hash",
                      widths=(4, 5, 6, 8), ldm=16, dense=True),
    # Content levels carry minimizer LDM too (offsets to 256K compete in
    # the parse). L5-L6 sort whole blocks (nseg=1): the 32K-segmented
    # sorts were the deep levels' text weakness (r4 measured: L5 text
    # 1.015x stock segmented -> 0.996x full-block, mixed 0.961 -> 0.948;
    # deep levels trade sort speed for ratio by design).
    5: TpuLevelParams(4, lazy=True, window=131072, ldm=4),
    6: TpuLevelParams(6, lazy=True, window=131072, ldm=4),
    7: TpuLevelParams(6, lazy=True, ldm=4),
    8: TpuLevelParams(8, lazy=True, ldm=4),
    9: TpuLevelParams(8, lazy=True, ldm=4),
    10: TpuLevelParams(10, lazy=True, ldm=4),
    11: TpuLevelParams(12, lazy=True, ldm=4),
    12: TpuLevelParams(16, lazy=True, ldm=4),
}


def coalesce_sequences(lit: np.ndarray, off: np.ndarray, ml: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge chains of capped matches: zero-literal successors with the
    same offset extend the previous match (vectorized)."""
    n = len(lit)
    if n == 0:
        return lit, off, ml
    same = (lit == 0) & (off == np.roll(off, 1))
    same[0] = False
    starts = np.flatnonzero(~same)
    ml_m = np.add.reduceat(ml, starts)
    return lit[starts], off[starts], ml_m


def device_positions_to_claims(pos: np.ndarray, off: np.ndarray,
                               block_len: int) -> BlockSequences:
    """Segment-slots unpack: rebuild claims from claim positions. The
    claims are intentionally length-less — the native extension pass
    recomputes true lengths by byte comparison (and the parse guarantees
    >= 4-byte spacing, so positions tile cleanly)."""
    ns = len(pos)
    lit = np.zeros(ns, np.int64)
    ml = np.empty(ns, np.int64)
    last_lit = block_len
    if ns:
        # Tiled spans: claim [pos_i, pos_{i+1}) as match body. The
        # extension pass recomputes true literal runs and match lengths
        # from byte comparison (claimed ml is only an upper span), and
        # generous spans keep claims alive through front-trimming when an
        # earlier match's true extension overruns them (a 4-byte claim
        # would be discarded untested).
        lit[0] = pos[0]
        ml[:-1] = pos[1:] - pos[:-1]
        ml[-1] = 4
        last_lit = block_len - int(pos[-1]) - 4
    return BlockSequences(lit, off, ml, last_lit)


def deep_parse_pick(level: int, share: float, ctx_find: int,
                    block_size: int) -> bool:
    """Deep-level (L5+) parse selector: True -> hinted chain parse,
    False -> device-finish walk (VERDICT r4 #3; r5 retune). Shared by
    finish_block_host, scripts/deep_select_diag.py (which measures this
    exact rule against a per-block oracle), and the routing unit test —
    one definition so the diagnostic can never drift from the codec.

    Measured per block on five probe corpora at L5/L7/L9/L12 (after the
    r5 offset-priced chain scoring): dense text-like parses (literal
    share ~0.01-0.03) always want the lazy chain parse with the device
    claims as scored hints; at L7+ the priced chains win up to share
    ~0.13 (semi-structured blocks); mixed/structured content above that
    wants the device-finish walk, whose rep competition prices
    structured offsets best of all. The first two blocks of a window
    are the exception at ANY share below 0.40: their device claims are
    context-starved (little or no cross-block window behind them), so a
    fresh chain parse dominates by 2-5% regardless of composition."""
    bar = 0.13 if level >= 7 else 0.05
    return share < bar or (ctx_find < 2 * block_size and share < 0.40)


def device_outputs_to_sequences(out: dict, block_index: int
                                ) -> BlockSequences | None:
    """Convert one block's device arrays to a coalesced BlockSequences.
    Returns None if the device flagged overflow (caller falls back)."""
    if bool(out["overflow"][block_index]):
        return None
    ns = int(out["nseq"][block_index])
    lit = out["lit_len"][block_index, :ns].astype(np.int64)
    off = out["offset"][block_index, :ns].astype(np.int64)
    ml = out["match_len"][block_index, :ns].astype(np.int64)
    lit, off, ml = coalesce_sequences(lit, off, ml)
    return BlockSequences(lit, off, ml,
                          int(out["last_literals"][block_index]))


class TpuCodec:
    """Batched block compressor over a single device (mesh path lives in
    parallel/)."""

    def __init__(self, level: int = 1, batch: int | None = None,
                 block_size: int | None = None, max_seq: int | None = None,
                 use_device: bool | None = None,
                 device_entropy: bool | str | None = None):
        if level not in TPU_LEVEL_TABLE:
            raise ValueError(
                f"unsupported level {level}: supported range 1..12")
        cfg = config.get()  # process defaults (QZ_* env); kwargs win
        self.level = level
        self.params = TPU_LEVEL_TABLE[level]
        self.batch = cfg.batch if batch is None else batch
        self.block_size = cfg.block_size if block_size is None else block_size
        if cfg.force_backend not in ("", "cpu"):
            raise ValueError(
                f"QZ_FORCE_BACKEND={cfg.force_backend!r}: expected '' "
                f"(device path) or 'cpu' (software only)")
        if use_device is None:
            # QZ_FORCE_BACKEND: "" = the device path (the plain-XLA
            # reference when JAX has only the CPU), "cpu" = software
            # only — the config-section/driver-flavor knob
            # (src/qatseqprod.c:481-496).
            use_device = cfg.force_backend != "cpu"
        self.use_device = use_device
        self.checksum_default = cfg.checksum
        self.stats = BlockStats()
        # device_entropy: False/None = host entropy (default); "hybrid" =
        # the accelerator emits final FSE sequence sections and the host
        # encodes only the literals; True/"full" = device emits complete
        # block bodies (sequence sections + Huffman literals — the
        # smallest return link, bounded by the format-sequential FSE
        # state chain). The static-config trade the QAT session makes
        # once per session (src/qatseqprod.c:935-946). Env default:
        # QZ_DEVICE_ENTROPY.
        if device_entropy is None:
            env_map = {"": False, "0": False, "off": False,
                       "1": True, "full": True, "hybrid": "hybrid"}
            if cfg.device_entropy not in env_map:
                # A typo'd env value silently measuring the wrong mode
                # is worse than failing fast (same validation as the
                # kwarg surface below).
                raise ValueError(
                    f"QZ_DEVICE_ENTROPY={cfg.device_entropy!r}: expected "
                    f"one of {sorted(env_map)}")
            device_entropy = env_map[cfg.device_entropy]
        if device_entropy == "full":
            device_entropy = True
        if device_entropy not in (False, True, "hybrid"):
            raise ValueError(
                f"device_entropy must be False, True/'full' or 'hybrid', "
                f"got {device_entropy!r}")
        if device_entropy != "hybrid":
            device_entropy = bool(device_entropy)  # 1 -> True, 0 -> False
        self.device_entropy = device_entropy
        self.max_seq = cfg.max_seq if max_seq is None else max_seq
        # Device-entropy section capacity: 16 bits per sequence on
        # average (measured sections run ~17 bits/sequence at 16K+
        # sequences per block); blocks past either capacity fall back.
        self.seq_words = self.max_seq // 2
        self.fallback_batches = 0  # device failures absorbed by CPU path
        self._fn = None

    def _matcher(self) -> str:
        # The hash matcher's claims are only probabilistic until the host
        # extension pass verifies real bytes — without the native runtime
        # there is no verifier, so fall back to exact content sorts.
        if self.params.matcher == "hash" and not native.available():
            return "content"
        return self.params.matcher

    def _pipeline(self):
        if self._fn is None:
            from ..ops import match_pipeline
            backend.platform()  # rejects an unsupported platform early

            if self.device_entropy:
                # Device entropy encodes final FSE sections from the raw
                # device sequences — no host verification pass — so its
                # matcher must emit TRUE matches. Fast (hash) levels ride
                # the byte-verified hash path (the gram rides the first
                # sort; 4-byte-quantized exact lengths at hash-path
                # speed — needs no native host verifier, so no
                # _matcher() downgrade); deep levels keep the exact-LCP
                # content matcher.
                # Hybrid keeps literals on host: device_literals off.
                dev_lits = (self.params.huffman
                            and self.device_entropy is True)
                if self.params.matcher == "hash":
                    def run(blocks, lengths):
                        return match_pipeline.find_matches_with_seqsec_hash(
                            blocks, lengths, neighbors=2,
                            max_seq=self.max_seq, seq_words=self.seq_words,
                            lazy=self.params.lazy,
                            window=self.params.window,
                            custom_tables=self.params.custom_tables,
                            device_literals=dev_lits)
                else:
                    def run(blocks, lengths):
                        return match_pipeline.find_matches_with_seqsec(
                            blocks, lengths,
                            neighbors=self.params.neighbors,
                            max_seq=self.max_seq, seq_words=self.seq_words,
                            lazy=self.params.lazy,
                            stride=self.params.stride,
                            window=self.params.window,
                            custom_tables=self.params.custom_tables,
                            device_literals=dev_lits)
            elif self._matcher() == "hash":
                # Positions contract: device sends (pos, off) claims only;
                # the host extension derives exact lengths (the lean
                # return-path protocol, see glue_kernels.compact_slots).
                wlog = golden_codec.level_params(self.level).window_log
                ldm_max_off = 1 << wlog

                def run(blocks, lengths):
                    return match_pipeline.find_matches_positions(
                        blocks, lengths, widths=self.params.widths,
                        neighbors=self.params.neighbors,
                        window=self.params.window, lazy=self.params.lazy,
                        psegs=self.params.psegs, ldm=self.params.ldm,
                        ldm_max_off=ldm_max_off,
                        dense=self.params.dense, sync=self.params.sync)
            else:
                wlog = golden_codec.level_params(self.level).window_log
                # LDM claims are minimizer estimates (slot-quantized
                # offsets, chained-span lengths): only the native
                # extension walk verifies them against real bytes. With
                # no native runtime the Python entropy path would encode
                # them verbatim — silent corruption (review finding) —
                # so the content path runs LDM only when the verifier
                # exists. Exact-LCP local matches need no verification.
                ldm = self.params.ldm if native.available() else 0

                def run(blocks, lengths):
                    return match_pipeline.find_matches_packed(
                        blocks, lengths, neighbors=self.params.neighbors,
                        max_seq=self.max_seq,
                        lazy=self.params.lazy, stride=self.params.stride,
                        window=self.params.window,
                        matcher=self._matcher(), widths=self.params.widths,
                        ldm=ldm, ldm_max_off=1 << wlog)

            self._fn = run
        return self._fn

    def submit_batch(self, blocks_np: np.ndarray, lengths_np: np.ndarray):
        """Asynchronously dispatch one device batch (b <= self.batch).

        Returns an opaque handle of device arrays — the XLA analog of the
        reference's cpaDcCompressData2 submit (src/qatseqprod.c:1245); no
        polling loop is needed because JAX dispatch is async and
        np.asarray() at collect time plays the completion-callback role."""
        import jax.numpy as jnp
        b = blocks_np.shape[0]
        if b < self.batch:  # pad batch to the jit shape
            pad = np.zeros((self.batch - b,) + blocks_np.shape[1:], np.uint8)
            blocks_np = np.concatenate([blocks_np, pad])
            lengths_np = np.concatenate(
                [lengths_np, np.zeros(self.batch - b, np.int32)])
        packed = self._pipeline()(jnp.asarray(blocks_np),
                                  jnp.asarray(lengths_np))
        return b, lengths_np, packed


    def collect_batch(self, handle):
        """Block on a submitted batch. Returns a list of
        (BlockSequences|None, seq_section_bytes|None) per block; the
        sequences are raw (uncoalesced) when a device section is present,
        since the section already encodes them."""
        from ..ops import bitpack, match_pipeline
        b, lengths, result = handle
        if self.device_entropy:
            packed, words, bits, sec_over, plan, lits = result
            out = match_pipeline.unpack_outputs_wide(np.asarray(packed))
            words = np.asarray(words)
            bits = np.asarray(bits)
            sec_over = np.asarray(sec_over)
            plan = {k: np.asarray(v) for k, v in plan.items()}
            if lits is not None:
                lits = {k: np.asarray(v) for k, v in lits.items()}
                nblk = len(words)
                lits["words"] = lits["words"].reshape(nblk, 4, -1)
                lits["bits"] = lits["bits"].reshape(nblk, 4)
            res = []
            for i in range(b):
                if bool(out["overflow"][i]) or bool(sec_over[i]):
                    res.append((None, None))
                    continue
                ns = int(out["nseq"][i])
                # Offsets live inside the device section; zeros here are
                # placeholders (the literals-only host side never reads
                # them).
                seqs = BlockSequences(
                    out["lit_len"][i, :ns].astype(np.int64),
                    np.zeros(ns, np.int64),
                    out["match_len"][i, :ns].astype(np.int64),
                    int(out["last_literals"][i]))
                if ns == 0:
                    res.append((seqs, None))  # host encodes the 0-seq case
                    continue
                from ..format import fse as fse_fmt
                from ..format import tables as fmt_tables
                from ..format.sequences import nbseq_header
                # Symbol_Compression_Modes byte + table descriptions for
                # streams the device encoded with custom tables (the
                # norm counts ride back with the batch; NCount is a few
                # bytes of serial varint work, host-side by design).
                mode = 0
                desc = b""
                if plan:
                    for shift, kind, al in ((6, "ll",
                                             fmt_tables.LL_DEFAULT_ACCURACY),
                                            (4, "of",
                                             fmt_tables.OF_DEFAULT_ACCURACY),
                                            (2, "ml",
                                             fmt_tables.ML_DEFAULT_ACCURACY)):
                        if bool(plan[f"use_{kind}"][i]):
                            mode |= 2 << shift
                            desc += fse_fmt.write_ncount(
                                [int(x) for x in plan[f"norm_{kind}"][i]],
                                al)
                sec = (nbseq_header(ns) + bytes([mode]) + desc
                       + bitpack.backward_stream_bytes(words[i],
                                                       int(bits[i])))
                lit_sec = None
                if lits is not None and bool(lits["ok"][i]):
                    from ..ops import literals_kernel
                    lit_sec = literals_kernel.device_literals_section(
                        lits["nb_bits"][i], lits["codes"][i],
                        lits["max_bits"][i], lits["last_symbol"][i],
                        int(lits["n_lit"][i]), lits["words"][i],
                        lits["bits"][i])
                res.append((seqs, (lit_sec, sec)))
            return res
        packed = result
        if self._matcher() == "hash":
            per_block = match_pipeline.unpack_segments(
                np.asarray(packed), self.batch, self.params.window)
            return [(device_positions_to_claims(p, o, lengths[i]), None)
                    for i, (p, o) in enumerate(per_block[:b])]
        out = match_pipeline.unpack_outputs(np.asarray(packed))
        return [(device_outputs_to_sequences(out, i), None)
                for i in range(b)]

    def produce_sequences(self, blocks_np: np.ndarray, lengths_np: np.ndarray
                          ) -> list[BlockSequences | None]:
        return [s for s, _ in
                self.collect_batch(self.submit_batch(blocks_np, lengths_np))]

    def compress(self, data: bytes | np.ndarray, checksum: bool | None = None,
                 validate: bool = False) -> bytes:
        if checksum is None:
            checksum = self.checksum_default
        buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
            data, np.ndarray) else np.ascontiguousarray(data, np.uint8)
        bodies = self.compress_bodies(buf, validate=validate)
        wlog = golden_codec.level_params(self.level).window_log
        return frame.assemble_frame(buf, bodies, self.block_size, checksum,
                                    window_log=wlog)

    def finish_block_host(self, buf: np.ndarray, i: int,
                          seqs: BlockSequences | None,
                          dev_section: bytes | None = None, *,
                          frame_start: bool = True,
                          validate: bool = False) -> bytes | None:
        """Per-block host side of the device path: extension + gap-fill +
        entropy (or full CPU fallback when seqs is None). `buf` is the
        WHOLE frame buffer — cross-block window context is sliced here.
        Shared by the single-chip batch loop and the mesh frame path
        (parallel/pipeline.py), so both produce bodies with identical
        treatment (VERDICT r3 #2: one code path regardless of instance
        count, the reference's model at src/qatseqprod.c:601-630)."""
        n = len(buf)
        bs = self.block_size
        gp = golden_codec.level_params(self.level)
        use_native = native.available()
        # Cross-block window context. Two caps: matchers that DISCOVER
        # offsets (fill_gaps/find_sequences can emit off up to ctx + pos)
        # get ctx <= window - block so every find stays inside the frame
        # window; the extension pass only VERIFIES offsets the device
        # already produced (local < 32K, LDM <= window by construction),
        # so it may see the full window of context — required for LDM
        # claims in the (window - block, window] offset range.
        win = 1 << gp.window_log
        max_ctx = max(0, win - bs)
        blk = buf[i * bs:min((i + 1) * bs, n)]
        if len(blk) < 64:
            return None
        ctx = min(i * bs, win)
        ctx_find = min(i * bs, max_ctx)
        cblk = buf[i * bs - ctx:min((i + 1) * bs, n)]
        if dev_section is not None:
            lit_sec, seq_sec = dev_section
            if lit_sec is not None and seqs is not None:
                # Fully-device entropy: both sections came off the
                # accelerator; the host only concatenates (span
                # sanity first — a mismatch falls through to the
                # host literals path below).
                span = int(seqs.lit_lengths.sum()
                           + seqs.match_lengths.sum()
                           + seqs.last_literals)
                if span == len(blk):
                    return bytes(lit_sec) + seq_sec
            if seqs is not None and use_native:
                # Hybrid entropy: the device encoded the sequence
                # section; host adds the literals section only. No
                # extension — the section is final.
                return native.block_body_external_seqsec(
                    blk, seqs.lit_lengths, seqs.match_lengths,
                    seqs.last_literals, seq_sec,
                    self.params.huffman)
            # No native runtime: the sequences carry placeholder
            # offsets (they live in the device section), so the
            # Python entropy path must NOT encode them — re-match
            # on CPU instead.
            seqs = None
        deep_hinted = False
        if seqs is not None and use_native and seqs.nseq \
                and self.level >= 5 and not config.get().second_parse:
            # Deep levels: ONE parse per block, selected by the shared
            # rule (deep_parse_pick above — rationale and measurements
            # in its docstring). QZ_SECOND_PARSE=1 opts back into the
            # r4 double parse.
            share = float(seqs.lit_lengths.sum()
                          + seqs.last_literals) / len(blk)
            deep_hinted = deep_parse_pick(self.level, share, ctx_find, bs)
        if deep_hinted:
            hpos = (np.cumsum(seqs.lit_lengths + seqs.match_lengths)
                    - seqs.match_lengths)
            ll, of, ml, lastlit = native.find_sequences_hinted(
                cblk[ctx - ctx_find:], gp.chain_depth, gp.lazy,
                hpos, seqs.match_lengths, seqs.offsets,
                ctx_len=ctx_find, mml=gp.mml)
            seqs = BlockSequences(ll, of, ml, lastlit)
        elif seqs is not None and use_native and seqs.nseq:
            # Re-extend the device's capped matches to true lengths.
            ll, of, ml, lastlit = native.extend_sequences(
                cblk, seqs.lit_lengths, seqs.offsets,
                seqs.match_lengths, seqs.last_literals, ctx_len=ctx,
                max_off=win)
            # The device match window is segment-local (32K); this
            # re-matches the long literal runs it left behind against
            # the full block AND the cross-block window context
            # (stock zstd's streaming-matcher advantage, recovered
            # host-side at gap-bytes-only cost). It discovers offsets
            # (up to ctx + pos), so it gets the find-safe context.
            # Fast (hash-path) levels scan every gap (min_gap=4) under
            # relaxed economics with a deepened chain: their claims are
            # width-quantized single-candidate picks, so the gaps hold
            # genuinely undiscovered short matches AND the claim-
            # competition probe inside the walk regularly finds longer
            # or nearer sources than the sampled anchors could see
            # (the r4 parse-economics work: measured 1.016x -> 0.96x
            # stock on the gate corpus, 1.11x -> 0.96x on text at L1).
            fast = self.params.matcher == "hash"
            ll, of, ml, lastlit = native.fill_gaps(
                cblk[ctx - ctx_find:], ll, of, ml, lastlit,
                ctx_len=ctx_find,
                chain_depth=max(gp.chain_depth, 8) if fast
                else max(gp.chain_depth, 16),
                mml=gp.mml,
                min_gap=4,
                relaxed=fast)
            seqs = BlockSequences(ll, of, ml, lastlit)
        from_fallback = seqs is None
        if seqs is None:
            if use_native:
                try:
                    ll, of, ml, lastlit = native.find_sequences(
                        cblk[ctx - ctx_find:], gp.chain_depth,
                        gp.lazy, ctx_len=ctx_find, mml=gp.mml)
                    seqs = BlockSequences(ll, of, ml, lastlit)
                except OverflowError:
                    return None
            else:
                seqs = golden_codec.compress_block_sequences(
                    blk, self.level)
        if validate:
            golden_matcher.validate_sequences(cblk, seqs, ctx_len=ctx)
        custom = self.params.custom_tables and gp.custom_tables
        first = frame_start and i == 0  # frame rep-history init
        if use_native:
            body = native.block_body(
                blk, seqs.lit_lengths, seqs.offsets, seqs.match_lengths,
                seqs.last_literals, custom, self.params.huffman,
                first_block=first)
            if (self.level >= 5 and not from_fallback and not deep_hinted
                    and config.get().second_parse):
                # Opt-in (QZ_SECOND_PARSE=1) best-of-two: the r4 posture
                # — device content parse finished on host AND a host
                # chain re-parse (depth 8-256, lazy), keep the smaller
                # body per block. Superseded by the hinted single parse
                # above as the default.
                try:
                    ll, of, ml, lastlit = native.find_sequences(
                        cblk[ctx - ctx_find:], gp.chain_depth,
                        gp.lazy, ctx_len=ctx_find, mml=gp.mml)
                    alt = native.block_body(
                        blk, ll, of, ml, lastlit, custom,
                        self.params.huffman, first_block=first)
                    if alt is not None and (
                            body is None or len(alt) < len(body)):
                        body = alt
                except OverflowError:
                    pass
            return body
        try:
            return frame.encode_block_body(
                blk, seqs, allow_custom_tables=custom,
                try_huffman=self.params.huffman, first_block=first)
        except ValueError:
            return None

    def compress_bodies(self, buf: np.ndarray, validate: bool = False,
                        frame_start: bool = True) -> list[bytes | None]:
        """Produce per-block Compressed_Block bodies (None => raw block)."""
        buf = np.ascontiguousarray(buf, np.uint8)
        n = len(buf)
        bs = self.block_size
        nblocks = max(1, -(-n // bs))

        if not self.use_device and native.available() and not validate:
            # Pure-software mode: one native call does match + entropy for
            # every block with an internal thread pool (the reference's
            # thread-per-CCtx concurrency moved inside the runtime).
            gp = golden_codec.level_params(self.level)
            with Timer() as tm:
                bodies = native.compress_blocks_mt(
                    buf, bs, gp.chain_depth, gp.lazy,
                    self.params.custom_tables and gp.custom_tables,
                    self.params.huffman, window_log=gp.window_log,
                    mml=gp.mml, frame_start=frame_start)
            per = tm.elapsed / max(1, len(bodies))
            for i, body in enumerate(bodies):
                self.stats.record(min(n - i * bs, bs),
                                  len(body) if body else None, per)
            return bodies

        # Full blocks ride the device in batches; the short tail block (and
        # overflow blocks) take the CPU fallback, mirroring per-block
        # producer fallback semantics. Dispatch is pipelined: up to
        # QUEUE_DEPTH batches in flight while earlier results are collected
        # (the double-buffered feed that replaces the reference's
        # synchronous submit -> busy-poll per block, src/qatseqprod.c:1243).
        QUEUE_DEPTH = 3
        full_ids = set(i for i in range(nblocks)
                       if min(n - i * bs, bs) == bs and n >= bs) \
            if self.use_device else set()

        def finish_block(i: int, seqs: BlockSequences | None,
                         dev_section: bytes | None = None) -> bytes | None:
            """Fallback matching (if needed) + extension + entropy for one
            block. Runs in a worker thread; native C calls drop the GIL."""
            with Timer() as tm:
                body = self.finish_block_host(buf, i, seqs, dev_section,
                                              frame_start=frame_start,
                                              validate=validate)
            blk_len = min(n - i * bs, bs)
            self.stats.record(blk_len, len(body) if body else None,
                              tm.elapsed,
                              fallback=seqs is None and i in full_ids)
            return body

        futures: dict[int, object] = {}
        inflight: list[tuple[list[int], object]] = []
        with ThreadPoolExecutor() as pool:

            def collect_one() -> None:
                """Device error => all blocks of the batch take the CPU
                fallback (the producer-error path, README.md:197-198), a
                failure is counted, and every RETRY_INTERVAL failures a
                device restart is attempted (failOffloadCnt semantics,
                src/qatseqprod.c:88, 1140-1152)."""
                ids, handle = inflight.pop(0)
                try:
                    seqs = self.collect_batch(handle)
                except Exception as e:
                    self.fallback_batches += 1
                    logging.error("device batch failed (%s: %s); CPU "
                                  "fallback for %d blocks",
                                  type(e).__name__, e, len(ids))
                    if device.note_offload_failure():
                        logging.event("attempting device restart")
                        device.stop_device()
                        device.start_device()
                    seqs = [(None, None)] * len(ids)
                for i, (sq, sec) in zip(ids, seqs):
                    futures[i] = pool.submit(finish_block, i, sq, sec)

            sorted_full = sorted(full_ids)
            for s in range(0, len(sorted_full), self.batch):
                ids = sorted_full[s:s + self.batch]
                blocks_np = np.stack([buf[i * bs:(i + 1) * bs] for i in ids])
                lengths_np = np.full(len(ids), bs, np.int32)
                try:
                    inflight.append(
                        (ids, self.submit_batch(blocks_np, lengths_np)))
                except Exception as e:
                    self.fallback_batches += 1
                    logging.error("device submit failed (%s: %s); CPU "
                                  "fallback for %d blocks",
                                  type(e).__name__, e, len(ids))
                    device.note_offload_failure()
                    for i in ids:
                        futures[i] = pool.submit(finish_block, i, None)
                if len(inflight) >= QUEUE_DEPTH:
                    collect_one()
            for i in range(nblocks):  # CPU-only blocks (tail / no device)
                if i not in full_ids:
                    futures[i] = pool.submit(finish_block, i, None)
            while inflight:
                collect_one()
            bodies = [futures[i].result() if i in futures else None
                      for i in range(nblocks)]
        return bodies
