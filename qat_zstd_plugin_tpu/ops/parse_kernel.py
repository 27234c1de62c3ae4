"""Greedy LZ parse as a Pallas kernel for the GPU (Triton route).

The greedy parse is the one irreducibly sequential step of LZ77 (the
analog of the byte-serial LZ4s token walk in the reference, QZSTD_decLz4s
src/qatseqprod.c:1013-1091). The plain formulation,
``match_pipeline.parse_greedy_scan``, sweeps every position of every row
in lockstep: a ``lax.scan`` of N dependent steps, each a device launch.

Here each row (a block, or one parse segment of a block) is one program
that walks its own cursor in a ``lax.while_loop``: it visits only the
positions the cursor lands on, reads ``mlen[cur]`` (and ``mlen[cur + 1]``
when lazy) and marks the taken ones. Rows are independent, so the
programs run in any order. The output starts as zeros (aliased input), so
unvisited positions cost nothing.

``parse_greedy`` is the entry every pipeline calls; the backend module
decides whether the kernel or the scan runs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..runtime import backend
from .match_pipeline import MIN_MATCH, parse_greedy_scan


def _make_kernel(n: int, lazy: bool, trunc: bool):
    def kernel(mlen_ref, _zeros_ref, chosen_ref):
        def body(cur):
            col = mlen_ref[cur]
            if trunc:
                # Parse-segmented rows: a match may not cross the segment
                # end (it would overlap the next segment's cover).
                col = jnp.minimum(col, n - cur)
            take = col >= MIN_MATCH
            if lazy:
                nxt = mlen_ref[jnp.minimum(cur + 1, n - 1)]
                nxt = jnp.where(cur + 1 < n, nxt, 0)
                take = take & ~(nxt > col)
            chosen_ref[cur] = take.astype(jnp.int32)
            return jnp.where(take, cur + col, cur + 1)

        jax.lax.while_loop(lambda cur: cur < n, body, jnp.int32(0))

    return kernel


@functools.partial(jax.jit, static_argnames=("lazy", "psegs", "interpret"))
def parse_greedy_kernel(mlen: jnp.ndarray, lazy: bool = False,
                        psegs: int = 1, interpret: bool = False
                        ) -> jnp.ndarray:
    """Greedy parse of candidate lengths. mlen: (B, N) -> chosen (B, N) bool.

    Same result as ``parse_greedy_scan(mlen, lazy, psegs)``. psegs > 1
    splits each block into psegs independent parse segments (one program
    each) and truncates candidates at segment ends; use it only where the
    claims are host-verified (the host extension re-extends across the
    boundary and gap-fill re-matches dropped tails).
    """
    B, N = mlen.shape
    assert N % psegs == 0, (N, psegs)
    R, n = B * psegs, N // psegs
    rows = mlen.astype(jnp.int32).reshape(R, n)
    spec = pl.BlockSpec((None, n), lambda r: (r, 0))
    chosen = pl.pallas_call(
        _make_kernel(n, lazy, psegs > 1),
        grid=(R,),
        in_specs=[spec, spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((R, n), jnp.int32),
        input_output_aliases={1: 0},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="parse_greedy",
    )(rows, jnp.zeros((R, n), jnp.int32))
    return chosen.reshape(B, N).astype(bool)


def parse_greedy(mlen: jnp.ndarray, lazy: bool = False,
                 psegs: int = 1) -> jnp.ndarray:
    """The parse every pipeline runs: the kernel on the GPU, the plain
    scan (the reference) on the CPU."""
    if backend.compiled():
        return parse_greedy_kernel(mlen, lazy=lazy, psegs=psegs)
    return parse_greedy_scan(mlen, lazy=lazy, psegs=psegs)
