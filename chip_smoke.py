#!/usr/bin/env python3
"""Smoke run of the codec's device path on a GPU, through the user entry
points, at production sizes. Every frame is decoded by stock libzstd
(ctypes, independent of the package) and must match bit for bit.

    python chip_smoke.py          # one card: phases 1-6
    python chip_smoke.py --four   # four cards: the mesh path only

Phases (one card):
  1. qz.compress(level=1) on 256 MiB of bench.make_corpus(seed)
  2. one batch (16 x 128 KiB) at L1, L4 and L9 on the GPU and on the CPU
     backend in the same process: device output arrays and finished
     frames must be identical (the pipeline is integer-only: tolerance 0)
  3. qz.compress at L4 and L9, 32 MiB each
  4. the producer route, qz.compress_via_libzstd(level=1, use_device=True)
  5. device entropy, TpuCodec(device_entropy=True / "hybrid"), 2 MiB
  6. each hand-written kernel against its plain reference at (64, 131072)
Every phase requires start_device() == OK on the gpu platform, the native
runtime, and zero fallback batches and blocks.

With --four: parallel.pipeline.compress_mesh on 4 cards at L1 and L9 over
4 x 64 MiB, bit-exact, within 0.5% of the single-card TpuCodec frame, and
each shard's output on its own card.

Prints the card's name and power limit, and as its last line one JSON
object {"ok": true, "device": {...}}. Without a GPU, or when any phase
fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BLOCK = 131072
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


class Zstd:
    """Stock libzstd through ctypes: the independent decoder."""

    def __init__(self):
        self.lib = ctypes.CDLL(ctypes.util.find_library("zstd")
                               or "libzstd.so.1")
        self.lib.ZSTD_versionNumber.restype = ctypes.c_uint
        self.lib.ZSTD_isError.restype = ctypes.c_uint
        self.lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        self.lib.ZSTD_decompress.restype = ctypes.c_size_t
        self.lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t]

    def version(self) -> int:
        return self.lib.ZSTD_versionNumber()

    def bitexact(self, frame: bytes, data: bytes) -> bool:
        dst = ctypes.create_string_buffer(len(data) + 16)
        r = self.lib.ZSTD_decompress(dst, len(data) + 16, frame, len(frame))
        return not self.lib.ZSTD_isError(r) and dst.raw[:r] == data


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


class Smoke:
    def __init__(self, jax, qz, zstd):
        self.jax, self.qz, self.zstd = jax, qz, zstd
        from qat_zstd_plugin_tpu import native, oracle
        from qat_zstd_plugin_tpu.runtime import backend
        self.native, self.oracle, self.backend = native, oracle, backend
        # Every TpuCodec a phase builds (qz.compress and the producer
        # build their own), so the fallback counters can be checked.
        self.codecs = []
        orig = qz.TpuCodec.__init__
        codecs = self.codecs

        def recording_init(codec, *a, **k):
            orig(codec, *a, **k)
            codecs.append(codec)

        qz.TpuCodec.__init__ = recording_init

    def preconditions(self, phase: str) -> None:
        check(self.qz.start_device() == self.qz.Status.OK,
              f"{phase}: start_device() is not OK")
        check(self.backend.platform() == "gpu",
              f"{phase}: platform is {self.backend.platform()!r}")
        check(self.native.available(),
              f"{phase}: native runtime unavailable (the hash matcher "
              "would silently become the content matcher)")
        self.codecs.clear()

    def fallbacks(self, phase: str) -> tuple[int, int]:
        batches = sum(c.fallback_batches for c in self.codecs)
        blocks = sum(c.stats.summary().get("fallback_blocks", 0)
                     for c in self.codecs)
        check(batches == 0 and blocks == 0,
              f"{phase}: {batches} fallback batches, {blocks} fallback "
              "blocks")
        return batches, blocks

    def report(self, phase, data, level, secs, frame, extra=""):
        check(self.zstd.bitexact(frame, data),
              f"{phase}: frame does not decode bit-exactly")
        batches, blocks = self.fallbacks(phase)
        stock = len(self.oracle.compress(data, level)) / len(data)
        print(f"{phase}: bytes={len(data)} level={level} "
              f"seconds={secs:.3f} MB/s={len(data) / secs / 1e6:.1f} "
              f"ratio={len(frame) / len(data):.4f} stock_ratio={stock:.4f} "
              f"fallback_batches={batches} fallback_blocks={blocks} "
              f"bitexact=True{extra}", flush=True)

    def timed_compress(self, phase, data, level):
        self.preconditions(phase)
        t0 = time.perf_counter()
        frame = self.qz.compress(data, level=level)
        self.report(phase, data, level, time.perf_counter() - t0, frame)

    # ---------------------------------------------------------- phases

    def phase1(self, corpus):
        data = corpus[:256 << 20]
        self.timed_compress("phase1 L1 compress", data[:16 << 20], 1)
        self.timed_compress("phase1 L1 compress 256MiB", data, 1)

    def phase2(self, corpus):
        import numpy as np
        jax = self.jax
        cpu = jax.devices("cpu")[0]
        B = 16
        data = corpus[:B * BLOCK]
        blocks_np = np.frombuffer(data, np.uint8).reshape(B, BLOCK)
        lengths_np = np.full(B, BLOCK, np.int32)
        for level in (1, 4, 9):
            phase = f"phase2 L{level} gpu==cpu"
            self.preconditions(phase)
            codec = self.qz.TpuCodec(level=level, batch=B)
            run = codec._pipeline()
            gpu_out = np.asarray(run(jax.device_put(blocks_np),
                                     jax.device_put(lengths_np)))
            t0 = time.perf_counter()
            gpu_frame = codec.compress(data)
            secs = time.perf_counter() - t0
            with jax.default_device(cpu):
                check(self.backend.platform() == "cpu",
                      f"{phase}: CPU placement not seen by the backend")
                cpu_codec = self.qz.TpuCodec(level=level, batch=B)
                cpu_out = np.asarray(cpu_codec._pipeline()(
                    jax.device_put(blocks_np, cpu),
                    jax.device_put(lengths_np, cpu)))
                cpu_frame = cpu_codec.compress(data)
            check(gpu_out.shape == cpu_out.shape
                  and gpu_out.dtype == cpu_out.dtype,
                  f"{phase}: output shapes differ")
            ndiff = int((gpu_out != cpu_out).sum())
            check(ndiff == 0, f"{phase}: {ndiff} device output words "
                              "differ between GPU and CPU")
            check(gpu_frame == cpu_frame, f"{phase}: frames differ")
            self.report(phase, data, level, secs, gpu_frame,
                        f" arrays_identical=True frames_identical=True "
                        f"words={gpu_out.size}")

    def phase3(self, corpus):
        data = corpus[:32 << 20]
        for level in (4, 9):
            self.timed_compress(f"phase3 L{level} compress", data, level)

    def phase4(self, corpus):
        phase = "phase4 producer L1"
        check(self.zstd.version() >= 10504,
              f"{phase}: libzstd {self.zstd.version()} < 1.5.4 has no "
              "sequence-producer API")
        self.preconditions(phase)
        data = corpus[:4 << 20]
        t0 = time.perf_counter()
        frame = self.qz.compress_via_libzstd(data, level=1, use_device=True)
        secs = time.perf_counter() - t0
        stats = self.oracle.last_producer_stats()
        check(stats["errors"] == 0 and stats["blocks"] > 0,
              f"{phase}: producer stats {stats}")
        check(any(c.use_device and c._fn is not None for c in self.codecs),
              f"{phase}: the device pipeline never ran")
        self.report(phase, data, 1, secs, frame,
                    f" producer_blocks={stats['blocks']} "
                    f"producer_errors={stats['errors']}")

    def phase5(self, corpus):
        data = corpus[:2 << 20]
        for mode in (True, "hybrid"):
            phase = f"phase5 device_entropy={mode}"
            self.preconditions(phase)
            # Capacity for every sequence a block can hold (the parse
            # spaces them >= 4 bytes apart): at the default QZ_MAX_SEQ
            # (16384) most blocks of this corpus overflow to the CPU.
            codec = self.qz.TpuCodec(level=1, device_entropy=mode,
                                     max_seq=BLOCK // 4)
            codec.compress(data)  # compile
            t0 = time.perf_counter()
            frame = codec.compress(data)
            self.report(phase, data, 1, time.perf_counter() - t0, frame)

    def phase6(self, corpus):
        import numpy as np
        import jax.numpy as jnp
        from qat_zstd_plugin_tpu.ops import match_pipeline as mp
        from qat_zstd_plugin_tpu.ops import parse_kernel as pk
        jax = self.jax
        self.preconditions("phase6 kernels")
        scan = jax.jit(mp.parse_greedy_scan, static_argnames=("lazy",))
        for B in (8, 64):
            blocks = jnp.asarray(np.frombuffer(
                corpus[:B * BLOCK], np.uint8).reshape(B, BLOCK))
            lengths = jnp.full((B,), BLOCK, jnp.int32)
            # Real candidate lengths: the L9 content matcher's.
            mlen, _ = mp._candidates_jit(blocks, lengths, 8)
            times = {}
            outs = {}
            for name, fn in (("kernel", lambda m: pk.parse_greedy_kernel(
                    m, lazy=True)), ("xla_scan", lambda m: scan(
                        m, lazy=True))):
                outs[name] = np.asarray(fn(mlen))  # compile + warm
                ts = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    fn(mlen).block_until_ready()
                    ts.append(time.perf_counter() - t0)
                times[name] = float(np.median(ts))
            check((outs["kernel"] == outs["xla_scan"]).all(),
                  f"phase6 parse B={B}: kernel differs from the scan")
            print(f"phase6 parse_greedy lazy B={B} N={BLOCK}: "
                  f"kernel_ms={times['kernel'] * 1e3:.3f} "
                  f"xla_scan_ms={times['xla_scan'] * 1e3:.3f} "
                  f"chosen={int(outs['kernel'].sum())} identical=True",
                  flush=True)

    def four(self, corpus):
        import numpy as np
        jax = self.jax
        from qat_zstd_plugin_tpu.parallel import mesh as pmesh
        from qat_zstd_plugin_tpu.parallel import pipeline as ppipe
        devs = jax.devices()
        check(len(devs) == 4, f"--four needs 4 GPUs, JAX found {len(devs)}")
        mesh = pmesh.make_mesh(devs)
        data = corpus[:4 * (64 << 20)]
        for level in (1, 9):
            phase = f"four L{level} compress_mesh"
            self.preconditions(phase)
            ppipe.compress_mesh(data[:4 * 8 * BLOCK], mesh, level=level)
            t0 = time.perf_counter()
            frame = ppipe.compress_mesh(data, mesh, level=level)
            secs = time.perf_counter() - t0
            single = self.qz.TpuCodec(level=level).compress(data)
            rel = len(frame) / len(single)
            check(rel <= 1.005, f"{phase}: mesh frame {len(frame)} vs "
                                f"single-card {len(single)} ({rel:.4f}x)")
            self.report(phase, data, level, secs, frame,
                        f" single_card_bytes={len(single)} "
                        f"mesh_vs_single={rel:.4f}")
        # Each shard's output on its own card.
        B = 4 * 4
        blocks = np.frombuffer(data[:B * BLOCK], np.uint8).reshape(B, BLOCK)
        out = pmesh.sharded_positions_step(mesh)(
            blocks, np.full(B, BLOCK, np.int32))
        shard_devs = [s.device for s in out.addressable_shards]
        check(sorted(d.id for d in shard_devs) == sorted(d.id for d in devs),
              f"four: shards on {shard_devs}, mesh {devs}")
        starts = sorted(s.index[0].start or 0 for s in out.addressable_shards)
        check(len(set(starts)) == 4, f"four: shard rows overlap {starts}")
        print(f"four shards: {[str(d) for d in shard_devs]} row starts "
              f"{starts}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args()

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"JAX found no GPU (platform {devs[0].platform!r})")
    sys.path.insert(0, HERE)
    try:
        import bench
        import qat_zstd_plugin_tpu as qz
    except ImportError as e:
        fail(f"the codec is not next to this script: {e}")

    zstd = Zstd()
    print(f"jax {jax.__version__}; libzstd {zstd.version()}; "
          f"{len(devs)} x {devs[0].device_kind}", flush=True)
    smoke = Smoke(jax, qz, zstd)
    t0 = time.perf_counter()
    corpus = bench.make_corpus((256 << 20) if not args.four
                               else 4 * (64 << 20), seed=SEED)
    print(f"corpus: {len(corpus)} bytes in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if args.four:
        smoke.four(corpus)
    else:
        for phase in (smoke.phase1, smoke.phase2, smoke.phase3,
                      smoke.phase4, smoke.phase5, smoke.phase6):
            t0 = time.perf_counter()
            phase(corpus)
            print(f"{phase.__name__} done in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
