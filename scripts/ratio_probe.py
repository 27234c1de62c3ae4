#!/usr/bin/env python3
"""Ratio probe: device/software path vs stock zstd on multiple corpora.

Round-4 workbench for the parse-economics work (VERDICT r3 #1, #3):
measures the device L1/L2 ratio gap per corpus so economics changes are
judged on >1 corpus composition. Runs on the CPU JAX backend (ratio is
backend-independent; only speed differs).

Usage: python scripts/ratio_probe.py [levels...] [--corpus name] [--mb N]
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")

import jax  # noqa: E402

jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import importlib.util

import numpy as np

spec = importlib.util.spec_from_file_location(
    "bench_mod", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py"))
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)

from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec


from qat_zstd_plugin_tpu.utils import corpora as _corp  # noqa: E402

CORPORA = {
    "mixed0": lambda mb: bench.make_corpus(mb << 20, seed=0),
    "mixed3": lambda mb: bench.make_corpus(mb << 20, seed=3),
    "text": lambda mb: _corp.corpus_text(mb << 20),
    "binary": lambda mb: _corp.corpus_binary(mb << 20),
    "redundant": lambda mb: _corp.corpus_redundant(mb << 20),
}


def main() -> None:
    args = sys.argv[1:]
    mb = 2
    names = list(CORPORA)
    levels = [1, 2]
    modes = ["device"]
    rest = []
    it = iter(args)
    for a in it:
        if a == "--mb":
            mb = int(next(it))
        elif a == "--corpus":
            names = next(it).split(",")
        elif a == "--sw":
            modes = ["sw"]
        elif a == "--both":
            modes = ["device", "sw"]
        else:
            rest.append(a)
    if rest:
        levels = [int(x) for x in rest]
    for name in names:
        data = CORPORA[name](mb)
        for lvl in levels:
            stock = len(oracle.compress(data, lvl))
            row = [f"{name:10s} L{lvl}  stock={stock}"]
            for mode in modes:
                c = TpuCodec(level=lvl, batch=4,
                             use_device=(mode == "device"))
                f = c.compress(data)
                ok = oracle.roundtrip_ok(f, data)
                # Flag silent CPU fallback: a transient device error
                # makes the codec absorb blocks on the CPU chain parse
                # (correct output, different ratio), which poisons the
                # device-row reading without any visible signal.
                fb = (f" FB={c.stats.fallback_blocks}"
                      if mode == "device" and c.stats.fallback_blocks
                      else "")
                row.append(f"{mode}={len(f)} ({len(f) / stock:.4f}x"
                           f"{'' if ok else ' BAD'}{fb})")
            print("  ".join(row), flush=True)


if __name__ == "__main__":
    main()
