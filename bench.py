#!/usr/bin/env python3
"""Benchmark: device zstd-codec throughput on one GPU. Prints ONE JSON line.

Measured rows (mirroring the reference benchmark's -m modes, which put the
software baseline and the accelerator number in the same run —
test/benchmark.c:79,261-266):

* value (primary): device match-pipeline throughput with inputs resident in
  device memory — the analog of the QAT DC engine's rated throughput.
  Median of K dependent-chain samples with spread reported.
* device_entropy_mbs / device_entropy_ratio: the full on-device entropy
  mode (device emits complete FSE sequence sections + Huffman literals).
* cpu_native_mbs / cpu_native_ratio: the software path (mode-0 analog),
  same corpus and level.
* stock_ratio: stock libzstd 1.5.4 at the same level on the same corpus.
* e2e_mbs: end-to-end frame production through TpuCodec.compress.

It needs a GPU: without one, or when a device stage fails, it exits
non-zero and prints no result.

Correctness gate: the e2e frame must round-trip bit-exactly through stock
libzstd 1.5.4 or the result is reported as invalid.

Baseline: 2000 MB/s/chip L1 encode (BASELINE.md north star).
"""

from __future__ import annotations

import json
import sys
import time
import os

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_MBS = 2000.0  # north-star target, BASELINE.md
CORPUS_MB = 64
LEVEL = 1
# Batch sizing: the L1 syncmer point carries half-size intermediates, so
# it runs B=128; the full-resolution dense ladder rows keep B=64.
BATCH = 128
LADDER_BATCH = 64
REPO = os.path.dirname(os.path.abspath(__file__))
BLOCK = 131072
K_SAMPLES = 5  # median-of-K with spread (VERDICT r2: report variance)


def make_corpus(nbytes: int, seed: int = 0) -> bytes:
    """Deterministic Silesia-like mix: text, structured binary, runs,
    high-entropy — plus real system files for realism."""
    rng = np.random.default_rng(seed)
    parts = []
    words = [b"the ", b"of ", b"and ", b"compression ", b"data ", b"block ",
             b"sequence ", b"entropy ", b"offset ", b"window ", b"frame ",
             b"match ", b"literal ", b"stream ", b"device ", b"kernel "]
    for path in (os.path.join(REPO, "SURVEY.md"), "/bin/ls",
                 "/etc/services"):
        try:
            parts.append(open(path, "rb").read())
        except OSError:
            pass
    total = sum(map(len, parts))  # running sum: linear in the part count
    while total < nbytes:
        kind = int(rng.integers(0, 10))
        if kind < 4:  # markov-ish text
            parts.append(b"".join(
                words[i] for i in rng.integers(0, len(words), 2000)))
        elif kind < 6:  # structured records
            rec = rng.integers(0, 256, 64, np.uint8).tobytes()
            parts.append(rec * int(rng.integers(20, 200)))
        elif kind < 8:  # low-entropy binary
            parts.append(rng.integers(0, 16, 8000, np.uint8)
                         .astype(np.uint8).tobytes())
        elif kind < 9:  # runs
            parts.append(bytes([int(rng.integers(0, 256))])
                         * int(rng.integers(100, 4000)))
        else:  # incompressible
            parts.append(rng.integers(0, 256, 4000, np.uint8)
                         .astype(np.uint8).tobytes())
        total += len(parts[-1])
    return b"".join(parts)[:nbytes]


def _chain_timer(run, fetch_scalar):
    """Time K-rep dependent chains closed by a real scalar fetch;
    differencing chain lengths removes dispatch/fetch latency from the
    per-rep figure."""
    def chain(k: int) -> float:
        t0 = time.perf_counter()
        acc = None
        for _ in range(k):
            out = run()
            v = fetch_scalar(out)
            acc = v if acc is None else acc + v
        _ = int(acc)
        return time.perf_counter() - t0
    return chain


def _sample_mbs(chain, nbytes: int, k_samples: int,
                span: int = 16) -> list[float]:
    """Per-rep throughput samples, one Theil-Sen slope per round.

    Each round times chains of k in {1, span/3, 2span/3, span} reps and
    takes the MEDIAN of all pairwise slopes (Theil-Sen): a single
    jittered endpoint corrupts only the pairs it touches. Non-positive
    slopes retry. The first round after warmup is discarded."""
    ks = sorted({1, max(2, 1 + span // 3), max(3, 1 + 2 * span // 3),
                 1 + span})
    # Physical sanity ceiling: the pipeline makes >= ~10 device-memory
    # passes over the batch, so >20 GB/s is a measurement artifact.
    CEILING_MBS = 20000.0
    samples: list[float] = []
    retries = 0
    while len(samples) < k_samples + 1 and retries < 3 * k_samples:
        pts = [(k, chain(k)) for k in ks]
        slopes = [(t2 - t1) / (k2 - k1)
                  for i, (k1, t1) in enumerate(pts)
                  for (k2, t2) in pts[i + 1:]]
        slope = float(np.median(slopes))
        if slope <= 0 or nbytes / slope / 1e6 > CEILING_MBS:
            retries += 1
            continue
        samples.append(nbytes / slope / 1e6)
    if not samples:
        raise RuntimeError("no positive-slope timing sample")
    samples = samples[1:] or samples
    # MAD outlier strip: drop samples beyond 4 MADs of the median when
    # enough remain.
    if len(samples) >= 4:
        med = float(np.median(samples))
        mad = float(np.median([abs(s - med) for s in samples]))
        if mad > 0:
            kept = [s for s in samples if abs(s - med) <= 4 * mad]
            if len(kept) >= 3:
                samples = kept
    return samples


def _median_spread(samples: list[float]) -> tuple[float, float]:
    med = float(np.median(samples))
    spread = (max(samples) - min(samples)) / med if med else 0.0
    return med, spread


def main() -> None:
    import jax
    import jax.numpy as jnp
    from qat_zstd_plugin_tpu.ops import match_pipeline as mp
    from qat_zstd_plugin_tpu.runtime import backend
    from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec, \
        TPU_LEVEL_TABLE
    from qat_zstd_plugin_tpu import oracle

    if backend.platform() != "gpu":
        sys.exit(f"bench.py measures the device path on a GPU; JAX found "
                 f"{jax.devices()[0].platform!r}")

    data = make_corpus(CORPUS_MB << 20)
    buf = np.frombuffer(data, np.uint8)
    params = TPU_LEVEL_TABLE[LEVEL]

    # --- device-resident pipeline throughput (primary): the positions
    # (segment-slots) contract, the production fast-level path.
    B = BATCH
    blocks_np = np.ascontiguousarray(buf[: B * BLOCK].reshape(B, BLOCK))
    blocks = jax.device_put(jnp.asarray(blocks_np))
    lengths = jax.device_put(jnp.full((B,), BLOCK, jnp.int32))

    def run_dev():
        return mp.find_matches_positions(
            blocks, lengths, widths=params.widths,
            neighbors=params.neighbors, window=params.window,
            lazy=params.lazy, psegs=params.psegs, ldm=params.ldm, ldm_max_off=1 << 19,
            dense=params.dense, sync=params.sync)

    chain = _chain_timer(run_dev, lambda out: out[0, 0])
    chain(1)  # compile + warm
    samples = _sample_mbs(chain, B * BLOCK, K_SAMPLES)
    dev_mbs, dev_spread = _median_spread(samples)

    # --- device level ladder (L2/L4 at B=64: full-resolution anchors +
    # wider hash widths + larger LDM spans trade speed for ratio).
    ladder = {}
    lb = LADDER_BATCH
    lblocks = jax.device_put(jnp.asarray(
        np.ascontiguousarray(buf[: lb * BLOCK].reshape(lb, BLOCK))))
    llengths = jax.device_put(jnp.full((lb,), BLOCK, jnp.int32))
    for lvl in (2, 4):
        p = TPU_LEVEL_TABLE[lvl]

        def run_lvl():
            return mp.find_matches_positions(
                lblocks, llengths, widths=p.widths,
                neighbors=p.neighbors, window=p.window,
                lazy=p.lazy, psegs=p.psegs, ldm=p.ldm, ldm_max_off=1 << 19,
                dense=p.dense, sync=p.sync)

        ch = _chain_timer(run_lvl, lambda out: out[0, 0])
        ch(1)
        ss = _sample_mbs(ch, lb * BLOCK, 4, span=8)
        ladder[f"L{lvl}"] = round(_median_spread(ss)[0], 1)

    # --- end-to-end frame + device-path ratio over a 16 MB slice
    # (labeled in `e2e_corpus_mb`).
    e2e_data = data[: min(len(data), 16 << 20)]
    codec = TpuCodec(level=LEVEL, batch=B, block_size=BLOCK, max_seq=16384)
    codec.compress(e2e_data[: B * BLOCK])  # warm the full-batch shape
    t0 = time.perf_counter()
    frame = codec.compress(e2e_data)
    e2e_mbs = len(e2e_data) / (time.perf_counter() - t0) / 1e6
    if codec.fallback_batches:
        raise RuntimeError(f"{codec.fallback_batches} device batches fell "
                           "back to the CPU")
    ok = oracle.roundtrip_ok(frame, e2e_data) if oracle.available() else None

    # --- on-device entropy modes: "full" (device emits complete block
    # bodies) and "hybrid" (device FSE sequence sections + host literals).
    def entropy_row(mode):
        ecodec = TpuCodec(level=LEVEL, batch=lb, block_size=BLOCK,
                          max_seq=BLOCK // 4, device_entropy=mode)
        sub = data[: lb * BLOCK]
        eframe = ecodec.compress(sub)
        if ecodec.fallback_batches:
            raise RuntimeError(f"device_entropy={mode!r}: "
                               f"{ecodec.fallback_batches} batches fell "
                               "back to the CPU")
        eok = oracle.roundtrip_ok(eframe, sub) if oracle.available() \
            else None
        echain = _chain_timer(lambda: ecodec._pipeline()(lblocks, llengths),
                              lambda out: out[0][0, 0, 0])
        echain(1)
        esamples = _sample_mbs(echain, lb * BLOCK, 3, span=6)
        return (round(_median_spread(esamples)[0], 1),
                round(len(eframe) / len(sub), 4), eok)

    de_mbs, de_ratio, de_ok = entropy_row(True)
    hy_mbs, hy_ratio, hy_ok = entropy_row("hybrid")

    # --- software A/B on the same corpus/level (reference -m0 analog).
    # Median-of-5 after two full-size warm passes (fresh processes ramp
    # over the first passes: cold caches, thread pools).
    cpu_mbs = cpu_ratio = cpu_spread = None
    cpu_frame = None
    try:
        cpu_codec = TpuCodec(level=LEVEL, use_device=False)
        cpu_codec.compress(e2e_data[: 4 << 20])  # warm: shape + pools
        cpu_codec.compress(e2e_data)             # warm: full-size ramp
        cpu_samples = []
        for _ in range(5):
            t0 = time.perf_counter()
            cpu_frame = cpu_codec.compress(e2e_data)
            cpu_samples.append(
                len(e2e_data) / (time.perf_counter() - t0) / 1e6)
        med, spr = _median_spread(cpu_samples)
        cpu_mbs = round(med, 1)
        cpu_spread = round(spr, 3)
        cpu_ratio = round(len(cpu_frame) / len(e2e_data), 4)
    except Exception as exc:
        print(f"cpu_native row failed: {exc!r}", file=sys.stderr)

    # --- decompression throughput (the reference benchmark times a
    # decompress phase, test/benchmark.c:350-369; decompression is always
    # software there too). Oracle row: stock libzstd decoding our frame.
    # Golden row: the in-repo golden decoder (pure NumPy) on a 2 MB
    # slice — it is the no-libzstd fallback path, so decode-side
    # regressions in either consumer show up across rounds.
    decomp_mbs = decomp_golden_mbs = None
    try:
        dec_frame = cpu_frame if cpu_frame is not None else frame
        if oracle.available():
            oracle.decompress(dec_frame, len(e2e_data))  # warm
            ds = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = oracle.decompress(dec_frame, len(e2e_data))
                ds.append(len(out) / (time.perf_counter() - t0) / 1e6)
            decomp_mbs = round(_median_spread(ds)[0], 1)
    except Exception as exc:
        print(f"decompress row failed: {exc!r}", file=sys.stderr)
    try:
        from qat_zstd_plugin_tpu.golden import decoder as golden_decoder
        gslice = e2e_data[: 2 << 20]
        gframe = (cpu_codec.compress(gslice) if cpu_mbs is not None
                  else codec.compress(gslice))
        t0 = time.perf_counter()
        gout = golden_decoder.decompress(gframe)
        dt = time.perf_counter() - t0
        if bytes(gout) == bytes(gslice):
            decomp_golden_mbs = round(len(gslice) / dt / 1e6, 2)
        else:
            print("golden decoder mismatch on bench frame", file=sys.stderr)
    except Exception as exc:
        print(f"golden decompress row failed: {exc!r}", file=sys.stderr)

    stock_ratio = None
    if oracle.available():
        stock_ratio = round(
            len(oracle.compress(e2e_data, LEVEL)) / len(e2e_data), 4)

    print(json.dumps({
        "metric": f"L{LEVEL} match-pipeline throughput (1 GPU, "
                  "device-resident)",
        "value": round(dev_mbs, 1),
        "unit": "MB/s",
        "vs_baseline": round(dev_mbs / BASELINE_MBS, 4),
        "spread": round(dev_spread, 4),
        "samples": [round(s, 1) for s in samples],
        "e2e_mbs": round(e2e_mbs, 1),
        "e2e_corpus_mb": len(e2e_data) >> 20,
        "ratio": round(len(frame) / len(e2e_data), 4),
        "roundtrip_bitexact": ok,
        "device_ladder_mbs": ladder,
        "device_entropy_mbs": de_mbs,
        "device_entropy_ratio": de_ratio,
        "device_entropy_bitexact": de_ok,
        "hybrid_entropy_mbs": hy_mbs,
        "hybrid_entropy_ratio": hy_ratio,
        "hybrid_entropy_bitexact": hy_ok,
        "cpu_native_mbs": cpu_mbs,
        "cpu_native_spread": cpu_spread,
        "cpu_native_ratio": cpu_ratio,
        "decompress_mbs": decomp_mbs,
        "decompress_golden_mbs": decomp_golden_mbs,
        "stock_ratio": stock_ratio,
        "corpus_mb": CORPUS_MB,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
