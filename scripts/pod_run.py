#!/usr/bin/env python3
"""Multi-host readiness kit: one command -> scaling table + parity artifact.

The dryrun (__graft_entry__.dryrun_multichip) proves the sharded step
COMPILES and produces parity frames on virtual devices; this script is
the recipe for a multi-host run. Run it AS-IS on every host:

  # single host (1 process, all local chips — also the CPU simulation):
  python scripts/pod_run.py --mb 64

  # N hosts (same command per host, standard jax.distributed env):
  QZ_COORD=host0:9876 QZ_NPROC=4 QZ_PID=<0..3> \
      python scripts/pod_run.py --mb 1024 --levels 1,9

Artifacts (written by process 0):
  POD_SCALING.json — per-level rows: sharded-step throughput on the
  full mesh vs a 1-device submesh (weak scaling, fixed 4 blocks per
  device), scaling efficiency, e2e frame ratio, stock-zstd bit-exact
  verdict, and single-chip parity (mesh frame vs TpuCodec frame bytes).

North star (BASELINE.md): >= 80% linear scaling at N >= 2 hosts. On
virtual CPU devices the efficiency column is methodology only (all
"devices" share host cores).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=16,
                    help="corpus size for the e2e frame rows")
    ap.add_argument("--levels", default="1,9")
    ap.add_argument("--out", default="POD_SCALING.json")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    coord = os.environ.get("QZ_COORD")
    nproc = int(os.environ.get("QZ_NPROC", "1"))
    pid = int(os.environ.get("QZ_PID", "0"))

    import jax
    if coord:
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=nproc, process_id=pid)
    import numpy as np
    from qat_zstd_plugin_tpu import oracle
    from qat_zstd_plugin_tpu.parallel import mesh as pmesh
    from qat_zstd_plugin_tpu.parallel import pipeline as ppipe
    from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec

    devs = jax.devices()
    n = len(devs)
    if pid == 0:
        print(f"mesh: {n} devices across {nproc} process(es), "
              f"backend={jax.default_backend()}")

    BLOCK = 131072
    rng = np.random.default_rng(0)
    words = [b"pod ", b"scaling ", b"frame ", b"mesh ", b"entropy ",
             b"block ", b"zstd "]

    def corpus(nbytes: int) -> bytes:
        parts = []
        total = 0  # running sum: re-summing the list per iteration is
        while total < nbytes:  # quadratic at the pod-scale --mb sizes
            for p in (b"".join(words[int(k)] for k in
                               rng.integers(0, len(words), 4000)),
                      rng.integers(0, 48, 8000, np.uint8).tobytes()):
                parts.append(p)
                total += len(p)
        return b"".join(parts)[:nbytes]

    # --- sharded-step weak scaling: fixed 4 x 128 KiB blocks/device.
    step_rows = {}
    sdata = corpus(4 * n * BLOCK)
    sblocks = np.frombuffer(sdata, np.uint8).reshape(4 * n, BLOCK)
    slengths = np.full(4 * n, BLOCK, np.int32)

    def timed(nmesh: int) -> float:
        m = pmesh.make_mesh(devs[:nmesh])
        s = pmesh.sharded_positions_step(m, widths=(6,), window=32768,
                                         ldm=4)
        bl, ln = sblocks[: 4 * nmesh], slengths[: 4 * nmesh]
        np.asarray(s(bl, ln))  # compile + warm
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            r = s(bl, ln)
            np.asarray(r)
            best = min(best, time.perf_counter() - t0)
        return best

    t_full = timed(n)
    t_one = timed(1) if pid == 0 or nproc == 1 else None
    if t_one is not None:
        eff = t_one / t_full
        step_rows = {
            "devices": n,
            "one_device_ms": round(t_one * 1e3, 2),
            "full_mesh_ms": round(t_full * 1e3, 2),
            "one_device_mbs": round(4 * BLOCK / t_one / 1e6, 1),
            "full_mesh_mbs": round(4 * n * BLOCK / t_full / 1e6, 1),
            "weak_scaling_efficiency": round(eff, 3),
        }
        print(f"step scaling: 1 dev {step_rows['one_device_mbs']} MB/s, "
              f"{n} dev {step_rows['full_mesh_mbs']} MB/s, "
              f"efficiency {eff:.2f}")

    # --- e2e frames + parity per level.
    mesh = pmesh.make_mesh(devs)
    fdata = corpus(args.mb << 20)
    levels = {}
    for lvl in (int(x) for x in args.levels.split(",")):
        t0 = time.perf_counter()
        f = ppipe.compress_mesh(fdata, mesh, level=lvl, block_size=BLOCK)
        dt = time.perf_counter() - t0
        ok = oracle.roundtrip_ok(f, fdata) if oracle.available() else None
        parity = None
        if pid == 0:
            f1 = TpuCodec(level=lvl, block_size=BLOCK,
                          batch=min(16, 4 * n)).compress(fdata)
            parity = round(len(f) / len(f1), 4)
        levels[f"L{lvl}"] = {
            "e2e_mbs": round(len(fdata) / dt / 1e6, 1),
            "ratio": round(len(f) / len(fdata), 4),
            "bitexact_stock": ok,
            "parity_vs_single_chip": parity,
        }
        print(f"L{lvl}: {levels[f'L{lvl}']}")

    if pid == 0:
        artifact = {
            "devices": n, "processes": nproc,
            "backend": jax.default_backend(),
            "corpus_mb": args.mb,
            "step_scaling": step_rows,
            "levels": levels,
            "north_star": ">=0.80 weak-scaling efficiency at N>=2 hosts "
                          "(BASELINE.md)",
        }
        with open(args.out, "w") as fh:
            json.dump(artifact, fh, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
