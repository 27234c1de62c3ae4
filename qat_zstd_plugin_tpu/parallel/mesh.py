"""Device-mesh block parallelism — the scale-out axis of the codec.

The reference's only parallelism is data parallelism over independent
128 KiB blocks: app threads round-robin over up to 64 QAT DC instances
(src/qatseqprod.c:601-630, README.md:138-178), coordinated by an instance
pool spinlock (src/qatseqprod.c:905-933). Here there is no lock to take:
blocks shard over a 1-D "blocks" mesh axis with shard_map (every card
reaches every other over NVLink at the same rate, so the mesh is flat);
per-device streams are serialized by XLA, and the "instance shuffle"
becomes the block->device round-robin implied by the sharding.
Cross-host runs initialize through jax.distributed; compressed sizes ride
an ordered all-gather (collectives replace the reference's PCIe DMA
rings).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import match_pipeline

AXIS = "blocks"


def make_mesh(devices=None) -> Mesh:
    """1-D data-parallel mesh over all (or given) devices."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs.reshape(-1), (AXIS,))


def shard_blocks(fn, mesh: Mesh, out_specs):
    """Run a per-shard (blocks, lengths) -> out function over the mesh's
    block axis with shard_map: every device runs the identical program on
    its own rows. Under shard_map a Pallas kernel inside `fn` runs per
    device (the SPMD partitioner cannot split a kernel call)."""
    in_specs = (P(AXIS, None), P(AXIS))
    return jax.jit(
        jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                      out_specs=out_specs, check_vma=False),
        in_shardings=tuple(NamedSharding(mesh, s) for s in in_specs))


def sharded_pipeline(mesh: Mesh, neighbors: int = 4, max_seq: int = 16384,
                     lazy: bool = False, window: int = 1 << 30):
    """Batched match pipeline sharded over the mesh's block axis.

    Input batch dimension must be divisible by mesh size; each device runs
    the identical per-block program on its shard (SPMD), no cross-device
    traffic in the hot loop — matching the reference's share-nothing
    instances.
    """
    def local(blocks, lengths):
        return match_pipeline.find_matches_batch(
            blocks, lengths, neighbors=neighbors, max_seq=max_seq,
            lazy=lazy, window=window)

    rows, per_block = P(AXIS, None), P(AXIS)
    return shard_blocks(local, mesh, {
        "lit_len": rows, "offset": rows, "match_len": rows,
        "nseq": per_block, "last_literals": per_block,
        "overflow": per_block})


def sharded_positions_step(mesh: Mesh, widths: tuple = (6,),
                           window: int = 32768, ldm: int = 4,
                           sync: bool = True):
    """The production fast-level pipeline (hash matcher + minimizer LDM +
    dense slot contract, glue_kernels.find_matches_positions) sharded
    over the block axis.

    LDM span context slides within a shard only: the first span of every
    shard sees empty context, exactly like the first span of a
    single-device batch, so shard boundaries degrade gracefully to local
    matching. Returns a jitted (blocks, lengths) -> slot-words function.
    """
    from ..ops import glue_kernels

    def local(blocks, lengths):
        return glue_kernels.find_matches_positions(
            blocks, lengths, widths=widths, window=window,
            ldm=ldm, dense=True, sync=sync)

    return shard_blocks(local, mesh, P(AXIS, None))


def compression_step(mesh: Mesh, neighbors: int = 4, max_seq: int = 16384):
    """Full sharded 'training-step' analog used by the multi-chip dryrun:
    per-chip match pipeline + ordered all-gather of per-block stats.

    The all-gather demonstrates the ordered variable-size collect pattern
    (size-prefixed, max-bound padded) that multi-host frame assembly uses:
    every chip learns every block's nseq/last_literals in frame order.
    """
    pipeline = sharded_pipeline(mesh, neighbors, max_seq)

    @jax.jit
    def gather_stats(out):
        # Replicate per-block scalars to all chips in block order.
        nseq = jax.lax.with_sharding_constraint(
            out["nseq"], NamedSharding(mesh, P(None)))
        lastlit = jax.lax.with_sharding_constraint(
            out["last_literals"], NamedSharding(mesh, P(None)))
        return {"nseq_all": nseq, "last_literals_all": lastlit,
                "total_sequences": nseq.sum()}

    def step(blocks, lengths):
        out = pipeline(blocks, lengths)
        stats = gather_stats({"nseq": out["nseq"],
                              "last_literals": out["last_literals"]})
        return out, stats

    return step
