#!/usr/bin/env python3
"""Cross-check: encode stock zstd's parse with OUR entropy coder.

If stock-parse + our-entropy lands at ~stock size, the device-path ratio
gap is parse economics (not entropy coding) and the parse work has a
concrete target. Also prints our software-native parse for the same
blocks (the third corner).

  python scripts/parse_xcheck.py [--corpus text] [--level 1] [--mb 2]
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import numpy as np

from parse_diag import stock_block_sequences


def main() -> None:
    from ratio_probe import CORPORA
    from qat_zstd_plugin_tpu import native, oracle
    from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec

    args = sys.argv[1:]
    corpus, level, mb = "text", 1, 2
    it = iter(args)
    for a in it:
        if a == "--corpus":
            corpus = next(it)
        elif a == "--level":
            level = int(next(it))
        elif a == "--mb":
            mb = int(next(it))
    data = CORPORA[corpus](mb)
    bs = 131072
    data = data[:(len(data) // bs) * bs]
    buf = np.frombuffer(data, np.uint8)

    stock_frame_len = len(oracle.compress(data, level))
    sblocks = stock_block_sequences(data, level)

    total = 0
    for i, (kind, seqs, lastlit, bsize) in enumerate(sblocks):
        if kind != "c":
            total += bsize + 3
            continue
        ll = np.array([s[0] for s in seqs], np.int64)
        of = np.array([s[1] for s in seqs], np.int64)
        ml = np.array([s[2] for s in seqs], np.int64)
        blk = buf[i * bs:(i + 1) * bs]
        body = native.block_body(blk, ll, of, ml, int(lastlit),
                                 True, True, first_block=(i == 0))
        total += (len(body) + 3) if body else len(blk) + 3

    sw = TpuCodec(level=level, use_device=False)
    sw_len = len(sw.compress(data))

    dev = TpuCodec(level=level, batch=4, use_device=True)
    dev_len = len(dev.compress(data))

    print(f"corpus={corpus} L{level} n={len(data)}")
    print(f"stock frame:              {stock_frame_len}")
    print(f"stock parse + our entropy:{total + 6 + 3} (approx, "
          f"{(total + 9) / stock_frame_len:.4f}x)")
    print(f"our software native:      {sw_len} "
          f"({sw_len / stock_frame_len:.4f}x)")
    print(f"our device path:          {dev_len} "
          f"({dev_len / stock_frame_len:.4f}x)")


if __name__ == "__main__":
    main()
