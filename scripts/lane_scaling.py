#!/usr/bin/env python3
"""Measure device-entropy FSE lane scaling on the device.

The FSE sequence section is format-sequential (three interleaved states,
one data-dependent transition per sequence), so the encoder kernel runs
S dependent steps regardless of batch; lanes amortize across blocks.
This script measures the curve: encode_sequence_sections throughput at
B in {64, 256, 512, 1024} with realistic per-block sequence counts.

Throughput is reported as input MB/s (B * 128 KiB of block bytes per
call) using the dependent-chain + Theil-Sen methodology from bench.py.

Usage: python scripts/lane_scaling.py [B ...]   (default 64 256 512 1024)
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import importlib.util

import numpy as np

spec = importlib.util.spec_from_file_location(
    "bench_mod", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py"))
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)

BLOCK = 131072
S = 16384


def synth_sequences(B: int, seed: int = 0):
    """Realistic sequence arrays: ~9k seqs/block, text-like lengths."""
    rng = np.random.default_rng(seed)
    lit = np.zeros((B, S), np.int32)
    off = np.zeros((B, S), np.int32)
    ml = np.zeros((B, S), np.int32)
    nseq = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(8000, 11000))
        lits = rng.integers(0, 6, n)
        mls = rng.integers(4, 18, n)
        # scale so the block span stays under BLOCK
        span = lits.sum() + mls.sum()
        if span >= BLOCK:
            mls = np.maximum(3, (mls * (BLOCK - 1 - lits.sum())
                                 // mls.sum())).astype(np.int64)
        lit[b, :n] = lits
        ml[b, :n] = mls
        off[b, :n] = rng.integers(1, 32768, n)
        nseq[b] = n
    return lit, off, ml, nseq


def main() -> None:
    import jax
    import jax.numpy as jnp
    from qat_zstd_plugin_tpu.ops import fse_kernel

    sizes = [int(a) for a in sys.argv[1:]] or [64, 256, 512, 1024]
    curve = {}
    for B in sizes:
        lit, off, ml, nseq = synth_sequences(B)
        lit_d = jax.device_put(jnp.asarray(lit))
        off_d = jax.device_put(jnp.asarray(off))
        ml_d = jax.device_put(jnp.asarray(ml))
        nseq_d = jax.device_put(jnp.asarray(nseq))

        fn = jax.jit(lambda a, b, c, d: fse_kernel.encode_sequence_sections(
            a, b, c, d, custom=True))

        def run():
            return fn(lit_d, off_d, ml_d, nseq_d)

        chain = bench._chain_timer(run, lambda out: out[1][0])
        chain(1)  # compile + warm
        try:
            samples = bench._sample_mbs(chain, B * BLOCK, 3, span=6)
        except RuntimeError as exc:
            print(f"B={B}: {exc}", file=sys.stderr)
            continue
        med, spread = bench._median_spread(samples)
        curve[str(B)] = round(med, 1)
        print(json.dumps({"B": B, "mbs": round(med, 1),
                          "spread": round(spread, 3),
                          "samples": [round(s, 1) for s in samples]}),
              flush=True)
    print(json.dumps({"device_entropy_lane_curve": curve}))


if __name__ == "__main__":
    main()
