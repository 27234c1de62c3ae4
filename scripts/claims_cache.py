#!/usr/bin/env python3
"""Cache device claims per corpus, then replay host-side passes fast.

Round-4 workbench for the device-path parse economics (VERDICT r3 #1):
the device pipeline output (claim positions/offsets per block) is
deterministic for a given corpus+level, so cache it once and iterate on
the host-side extend/fill/entropy C++ without re-running JAX.

  python scripts/claims_cache.py build   # run device matcher, cache claims
  python scripts/claims_cache.py eval    # replay host side, print totals
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

CACHE = "/tmp/qz_claims_cache"


def build(names=("mixed0", "text"), levels=(1, 2), mb=2) -> None:
    from ratio_probe import CORPORA
    from qat_zstd_plugin_tpu.ops import match_pipeline
    from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
    os.makedirs(CACHE, exist_ok=True)
    for name in names:
        data = CORPORA[name](mb)
        open(os.path.join(CACHE, f"{name}.bin"), "wb").write(data)
        buf = np.frombuffer(data, np.uint8)
        n = len(buf)
        bs = 131072
        nblocks = n // bs
        for lvl in levels:
            c = TpuCodec(level=lvl, batch=4, use_device=True)
            rows = {}
            for s in range(0, nblocks, c.batch):
                ids = list(range(s, min(s + c.batch, nblocks)))
                blocks_np = np.stack(
                    [buf[i * bs:(i + 1) * bs] for i in ids])
                lengths_np = np.full(len(ids), bs, np.int32)
                handle = c.submit_batch(blocks_np, lengths_np)
                b, lengths, packed = handle
                per_block = match_pipeline.unpack_segments(
                    np.asarray(packed), c.batch, c.params.window)
                for j, i in enumerate(ids):
                    p, o = per_block[j]
                    rows[i] = (p, o)
            np.savez(os.path.join(CACHE, f"{name}_L{lvl}.npz"),
                     **{f"p{i}": rows[i][0] for i in rows},
                     **{f"o{i}": rows[i][1] for i in rows},
                     nblocks=nblocks)
            print(f"cached {name} L{lvl}: {nblocks} blocks", flush=True)


def eval_host(names=("mixed0", "text"), levels=(1, 2)) -> None:
    from qat_zstd_plugin_tpu import native, oracle
    from qat_zstd_plugin_tpu.golden import codec as golden_codec
    from qat_zstd_plugin_tpu.runtime import tpu_codec as tc
    bs = 131072
    for name in names:
        data = open(os.path.join(CACHE, f"{name}.bin"), "rb").read()
        buf = np.frombuffer(data, np.uint8)
        for lvl in levels:
            z = np.load(os.path.join(CACHE, f"{name}_L{lvl}.npz"))
            nblocks = int(z["nblocks"])
            params = tc.TPU_LEVEL_TABLE[lvl]
            gp = golden_codec.level_params(lvl)
            win = 1 << gp.window_log
            max_ctx = max(0, win - bs)
            total = 0
            for i in range(nblocks):
                pos, off = z[f"p{i}"], z[f"o{i}"]
                seqs = tc.device_positions_to_claims(pos, off, bs)
                blk = buf[i * bs:(i + 1) * bs]
                ctx = min(i * bs, win)
                ctx_find = min(i * bs, max_ctx)
                cblk = buf[i * bs - ctx:(i + 1) * bs]
                ll, of, ml, lastlit = native.extend_sequences(
                    cblk, seqs.lit_lengths, seqs.offsets,
                    seqs.match_lengths, seqs.last_literals, ctx_len=ctx,
                    max_off=win)
                fast = params.matcher == "hash"
                mg = int(os.environ.get(
                    "QZ_EVAL_MIN_GAP", "4" if fast else "32"))
                rx = int(os.environ.get(
                    "QZ_EVAL_RELAXED", "1" if fast else "0"))
                cd = int(os.environ.get(
                    "QZ_EVAL_CHAIN",
                    str(max(gp.chain_depth, 8) if fast
                        else gp.chain_depth)))
                ll, of, ml, lastlit = native.fill_gaps(
                    cblk[ctx - ctx_find:], ll, of, ml, lastlit,
                    ctx_len=ctx_find, chain_depth=cd,
                    mml=gp.mml, min_gap=mg, relaxed=rx)
                body = native.block_body(blk, ll, of, ml, lastlit,
                                         params.custom_tables, True,
                                         first_block=(i == 0))
                total += len(body) if body else bs + 3
            stock = len(oracle.compress(data[:nblocks * bs], lvl))
            print(f"{name:8s} L{lvl}: host={total} stock={stock} "
                  f"({total / stock:.4f}x)", flush=True)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "eval"
    names = sys.argv[2].split(",") if len(sys.argv) > 2 else (
        "mixed0", "text")
    if mode == "build":
        build(names)
    else:
        eval_host(names)
