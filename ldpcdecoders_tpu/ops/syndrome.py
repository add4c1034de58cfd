"""Batched GF(2) syndrome computation.

The reference computes ``(H * err) .% 2`` with a sparse mat-vec per decode
iteration (/root/reference/src/decoders/belief_propagation.jl:180-184).
Two forms:

  * :func:`make_syndrome_fn` — O(edges) gather + degree-axis sum over the
    padded adjacency (slot-major).  This is the production path: it never
    materializes H densely, so it scales to million-variable codes.
  * :func:`syndrome_of` — dense ``[B, n] @ [n, m]`` MXU matmul, used where
    a dense H is already around (tests, small-code tools).

Both are exact: LDPC row weights are tiny integers, far inside float32's
exact range.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["syndrome_of", "syndrome_matches", "make_syndrome_fn"]


# Dense-H cutoff for the matmul syndrome path (raised 4M -> 40M in round
# 4 so the bb144 circuit-level DEM, 864 x 31,648 = 27M elements, takes
# it; row sums stay far inside f32's exact-integer range, and 0/1
# operands are exact in TF32 too).  H is baked into the program as a
# constant, 108 MB f32 at bb144 width, which the compile carries; past
# ~40M move H to a traced argument instead.  The cutoff has not been
# re-derived for the GPU.
_DENSE_SYNDROME_MAX_ELEMS = 40_000_000


def make_syndrome_fn(graph):
    """Build ``err [B, n] float 0/1 -> syndrome [B, m] float 0/1``.

    Hybrid dispatch: small codes with a dense H use the MXU matmul (the
    systolic array makes it essentially free and ~9% faster end-to-end
    than the gather on the (1000,10,9) benchmark); large or dense-free
    graphs use the O(edges) padded-adjacency gather.
    """
    max_dc, m = graph.max_dc, graph.m
    if graph.H is not None and graph.m * graph.n <= _DENSE_SYNDROME_MAX_ELEMS:
        Ht = jnp.asarray(graph.H.T.astype(np.float32))
        return lambda err: syndrome_of(err, Ht)

    chk_vars = jnp.asarray(np.ascontiguousarray(graph.chk_vars.T).reshape(-1))
    chk_mask = jnp.asarray(np.ascontiguousarray(graph.chk_mask.T))  # [dc, m]

    def syndrome_from(err):
        B = err.shape[0]
        g = jnp.take(err, chk_vars, axis=1).reshape(B, max_dc, m)
        g = jnp.where(chk_mask, g, 0.0)
        return jnp.mod(jnp.sum(g, axis=1), 2.0)

    return syndrome_from


def syndrome_of(err, Ht):
    """``(err @ H^T) mod 2`` for a 0/1 error batch.

    Args:
      err: ``[B, n]`` float 0/1 error estimates.
      Ht: ``[n, m]`` float 0/1 transpose of the parity-check matrix.

    Returns:
      ``[B, m]`` float 0/1 syndromes.
    """
    s = jnp.dot(err, Ht, preferred_element_type=jnp.float32)
    return jnp.mod(s, 2.0)


def syndrome_matches(err, Ht, syndrome):
    """Per-lane ``all((err @ H^T) % 2 == syndrome)`` -> ``[B]`` bool."""
    return jnp.all(syndrome_of(err, Ht) == syndrome, axis=-1)
