"""Multi-host scale-out: jax.distributed init + ordered compressed gather.

The reference is single-host (its "interconnect" is PCIe DMA rings,
SURVEY §5); the codec's cross-host story is:

* `init()` — jax.distributed.initialize wrapper (DCN rendezvous);
* block data-parallelism over the global mesh (parallel/mesh.py);
* `gather_compressed()` — the ordered variable-size collect: compressed
  blocks are size-prefixed and padded to a static bound, all-gathered over
  the mesh (NVLink within a host, the network across hosts), then trimmed host-side
  in frame order. This is the collective that replaces per-instance DMA
  completion ordering in the reference's model.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import AXIS


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> None:
    """Initialize multi-host JAX (no-op for single-process runs)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def pad_blocks(bodies: list[bytes], bound: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Size-prefix representation: (n, bound) uint8 padded + (n,) sizes."""
    n = len(bodies)
    out = np.zeros((n, bound), np.uint8)
    sizes = np.zeros((n,), np.int32)
    for i, b in enumerate(bodies):
        assert len(b) <= bound, (len(b), bound)
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
        sizes[i] = len(b)
    return out, sizes


def gather_compressed(mesh, padded: np.ndarray, sizes: np.ndarray
                      ) -> list[bytes]:
    """Ordered all-gather of per-chip compressed blocks.

    `padded`/`sizes` are globally ordered (block i of the stream is row i);
    rows shard over the mesh block axis. Returns every block's exact bytes
    in stream order (identical on every process).
    """
    in_sh = (NamedSharding(mesh, P(AXIS, None)),
             NamedSharding(mesh, P(AXIS)))
    out_sh = (NamedSharding(mesh, P(None, None)),
              NamedSharding(mesh, P(None)))

    @functools.partial(jax.jit, in_shardings=in_sh, out_shardings=out_sh)
    def gather(p, s):
        # with_sharding_constraint to replicated = all-gather over the mesh.
        return (jax.lax.with_sharding_constraint(
                    p, NamedSharding(mesh, P(None, None))),
                jax.lax.with_sharding_constraint(
                    s, NamedSharding(mesh, P(None))))

    gp, gs = gather(jnp.asarray(padded), jnp.asarray(sizes))
    gp = np.asarray(gp)
    gs = np.asarray(gs)
    return [gp[i, :gs[i]].tobytes() for i in range(len(gs))]


def gather_rows(mesh, padded: np.ndarray, sizes: np.ndarray,
                ids: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All-gather per-process (padded, sizes, ids) row sets.

    Multi-process: each process contributes its local rows (counts may
    differ; rows are padded to the max count with id -1) and every
    process returns the union. Single-process: the rows ride a device
    all-gather over the mesh (shard -> replicate constraint), exercising
    the same collective the multi-host path uses across devices and hosts.
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        counts = multihost_utils.process_allgather(
            np.asarray([len(ids)], np.int32))
        m = int(counts.max())
        pad_r = m - len(ids)
        if pad_r:
            padded = np.vstack([padded,
                                np.zeros((pad_r, padded.shape[1]),
                                         np.uint8)])
            sizes = np.concatenate([sizes, np.full(pad_r, -1, np.int32)])
            ids = np.concatenate([ids, np.full(pad_r, -1, np.int32)])
        gp = multihost_utils.process_allgather(padded, tiled=True)
        gs = multihost_utils.process_allgather(sizes, tiled=True)
        gi = multihost_utils.process_allgather(ids, tiled=True)
        keep = gi >= 0
        return gp[keep], gs[keep], gi[keep]

    # Single process: pad the row count to a mesh multiple and run the
    # shard->replicate collective.
    nm = int(mesh.devices.size)
    rows = len(ids)
    pad_r = (-rows) % nm
    if pad_r:
        padded = np.vstack([padded, np.zeros((pad_r, padded.shape[1]),
                                             np.uint8)])
        sizes = np.concatenate([sizes, np.full(pad_r, -1, np.int32)])
        ids = np.concatenate([ids, np.full(pad_r, -1, np.int32)])
    in_sh = (NamedSharding(mesh, P(AXIS, None)),
             NamedSharding(mesh, P(AXIS)), NamedSharding(mesh, P(AXIS)))
    rep2 = NamedSharding(mesh, P(None, None))
    rep1 = NamedSharding(mesh, P(None))

    @functools.partial(jax.jit, in_shardings=in_sh,
                       out_shardings=(rep2, rep1, rep1))
    def gather(p, s, i):
        return (jax.lax.with_sharding_constraint(p, rep2),
                jax.lax.with_sharding_constraint(s, rep1),
                jax.lax.with_sharding_constraint(i, rep1))

    gp, gs, gi = gather(jnp.asarray(padded), jnp.asarray(sizes),
                        jnp.asarray(ids))
    gp, gs, gi = np.asarray(gp), np.asarray(gs), np.asarray(gi)
    keep = gi >= 0
    return gp[keep], gs[keep], gi[keep]
