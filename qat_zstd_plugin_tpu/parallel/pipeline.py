"""End-to-end mesh compression: sharded match -> host entropy -> ordered
gather -> one frame.

This is the multi-device/multi-host production shape (SURVEY §7.6): blocks
shard over the mesh's data-parallel axis (the reference's independent-
instance model, src/qatseqprod.c:601-630), each process finishes entropy
for its addressable shard only, and the ordered variable-size gather
(size-prefixed, max-bound padded — parallel/distributed.py) reassembles
every block's bytes in frame order on every process.

Parity contract: the mesh path runs the SAME pipeline as the
single-device flagship — the sync/dense/LDM positions matcher on fast
levels, content sorts on deep levels — and every block's host side goes
through TpuCodec.finish_block_host (extension + cross-block window
context + gap-fill + first-block rep init), so a mesh frame matches the
single-device frame's treatment block for block. The reference has
one code path regardless of instance count; so do we.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..format import frame
from ..format import tables
from ..golden import codec as golden_codec
from ..runtime import tpu_codec
from ..utils.profiling import Timer
from . import distributed
from .mesh import AXIS, make_mesh, shard_blocks

BLOCK = tables.BLOCK_SIZE_MAX


def compress_mesh(data: bytes | np.ndarray, mesh=None, level: int = 1,
                  checksum: bool = True, max_seq: int = 16384,
                  block_size: int = BLOCK) -> bytes:
    """Compress `data` to one zstd frame with blocks sharded over `mesh`.

    Every participating process must call this with the same data (the
    input is replicated, like a data-parallel step's batch); each process
    computes entropy only for its own device shard, and the gather makes
    the full body list identical everywhere, so every process returns the
    same frame bytes.
    """
    import functools
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops import match_pipeline

    if mesh is None:
        mesh = make_mesh()
    codec = tpu_codec.TpuCodec(level=level, block_size=block_size,
                               max_seq=max_seq, use_device=True)
    params = codec.params
    gp = golden_codec.level_params(level)
    matcher = codec._matcher()  # hash downgrades to content w/o native

    buf = np.frombuffer(data, np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data, np.uint8)
    n = len(buf)
    bs = block_size
    nblocks = max(1, -(-n // bs))
    nmesh = mesh.devices.size
    # Device batch: full blocks only, padded up to a mesh multiple AND an
    # LDM-span multiple (find_matches_positions silently drops LDM when
    # the batch doesn't tile into whole spans — losing long-distance
    # matches the single-chip path finds); the tail block (and any
    # padding rows) take the host path.
    full = [i for i in range(nblocks) if min(n - i * bs, bs) == bs]
    import math
    unit = nmesh * (params.ldm or 1) // math.gcd(nmesh, params.ldm or 1)
    B = max(unit, -(-len(full) // unit) * unit)
    blocks_np = np.zeros((B, bs), np.uint8)
    lengths_np = np.zeros((B,), np.int32)
    for row, i in enumerate(full):
        blocks_np[row] = buf[i * bs:(i + 1) * bs]
        lengths_np[row] = bs

    window = min(params.window, bs)
    work: dict[int, object] = {}  # frame block index -> device claims
    if matcher == "hash":
        # The flagship fast-level pipeline (positions contract: the
        # device sends one packed slot word per claim; the host
        # extension derives exact lengths) with the level's sync/dense/
        # LDM knobs — identical to TpuCodec._pipeline's configuration.
        run = shard_blocks(
            functools.partial(
                match_pipeline.find_matches_positions,
                widths=params.widths, neighbors=params.neighbors,
                window=window, lazy=params.lazy,
                psegs=params.psegs, ldm=params.ldm,
                ldm_max_off=1 << gp.window_log,
                dense=params.dense, sync=params.sync),
            mesh, P(AXIS, None))
        slot_keys = run(jnp.asarray(blocks_np), jnp.asarray(lengths_np))
        nseg = slot_keys.shape[0] // B  # segment rows per block
        for shard in slot_keys.addressable_shards:
            rows = shard.index[0]
            arr = np.asarray(shard.data)
            per_block = match_pipeline.unpack_segments(
                arr, arr.shape[0] // nseg, window)
            block0 = (rows.start or 0) // nseg  # 1-device shard: slice(None)
            for j, (pos, off) in enumerate(per_block):
                row = block0 + j
                if row >= len(full):
                    continue
                work[full[row]] = tpu_codec.device_positions_to_claims(
                    pos, off, bs)
    else:
        # Content levels: exact-LCP sorts; LDM claims only when the
        # native verifier exists (same guard as TpuCodec._pipeline).
        ldm = params.ldm if native.available() else 0
        run = shard_blocks(
            functools.partial(
                match_pipeline.find_matches_packed,
                neighbors=params.neighbors, max_seq=max_seq,
                lazy=params.lazy, stride=params.stride,
                window=window, matcher=matcher, widths=params.widths,
                ldm=ldm, ldm_max_off=1 << gp.window_log, fused=True),
            mesh, P(AXIS, None, None))
        packed = run(jnp.asarray(blocks_np), jnp.asarray(lengths_np))
        for shard in packed.addressable_shards:
            rows = shard.index[0]
            arr = np.asarray(shard.data)
            out = match_pipeline.unpack_outputs(arr)
            for j in range(arr.shape[0]):
                row = (rows.start or 0) + j  # 1-device shard: slice(None)
                if row >= len(full):
                    continue
                work[full[row]] = tpu_codec.device_outputs_to_sequences(
                    {k: v[j:j + 1] for k, v in out.items()}, 0)

    def finish(i: int) -> bytes | None:
        # Native calls release the GIL; a block the device could not
        # represent (work[i] None) is a counted CPU fallback.
        with Timer() as tm:
            body = codec.finish_block_host(buf, i, work[i])
        codec.stats.record(bs, len(body) if body else None, tm.elapsed,
                           fallback=work[i] is None)
        return body

    with ThreadPoolExecutor() as pool:
        bodies = dict(zip(work, pool.map(finish, work)))

    # Ordered gather of the compressed bodies (size -1 = raw fallback).
    bound = bs
    local_rows = sorted(bodies)
    padded = np.zeros((len(local_rows), bound), np.uint8)
    sizes = np.full((len(local_rows),), -1, np.int32)
    for k, i in enumerate(local_rows):
        b = bodies[i]
        if b is not None and len(b) <= bound:
            padded[k, :len(b)] = np.frombuffer(b, np.uint8)
            sizes[k] = len(b)
    ids = np.asarray(local_rows, np.int32)
    all_p, all_s, all_i = distributed.gather_rows(mesh, padded, sizes, ids)
    body_list: list[bytes | None] = [None] * nblocks
    for k in range(len(all_i)):
        i = int(all_i[k])
        if all_s[k] >= 0:
            body_list[i] = all_p[k, :all_s[k]].tobytes()
    # Host-only blocks (tail / device-overflow fallback) finish here,
    # identically on every process: the input is replicated and the
    # fallback is deterministic, so frames agree. The shared finisher
    # gives them the same cross-block-context + rep-init treatment.
    for i in range(nblocks):
        if body_list[i] is None:
            body_list[i] = codec.finish_block_host(buf, i, None)
    return frame.assemble_frame(buf, body_list, bs, checksum,
                                window_log=gp.window_log)
