"""Batched hard-decision iterative bit-flip decoder.

Batched re-design of the reference's Gallager-B-style decoder
(/root/reference/src/decoders/iterative_bitflip.jl:116-157):

  * the per-check vote scatter loops become one MXU matmul per iteration:
    ``votes += (2*mismatch - 1) @ H``;
  * votes accumulate across iterations (the reference zeroes them only in
    ``reset!``, iterative_bitflip.jl:84-88 — a quirk we reproduce);
  * the reference's ``rand(max_idxs)`` uniform tie-break
    (iterative_bitflip.jl:145-149) becomes counted-PRNG tie-breaking: a
    per-(lane, iteration) uniform draw ranks the argmax set;
  * "all votes negative" counts as convergence even when the syndrome is
    unmatched (iterative_bitflip.jl:150-153) — also reproduced.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.graph import TannerGraph
from ..ops.syndrome import make_syndrome_fn
from .base import Decoder

__all__ = ["BitFlipDecoder", "make_bitflip_decode_fn"]


def make_bitflip_decode_fn(graph: TannerGraph, max_iters: int):
    """Build a jittable ``(syndromes [B,m], key) -> (err, converged, iters)``."""
    n = graph.n
    max_dv = graph.max_dv
    syndrome_from = make_syndrome_fn(graph)
    # vote accumulation: votes[b, j] = sum over j's neighbor checks of
    # +/-1 — an O(edges) gather over the var-side adjacency (no dense H)
    var_chks = jnp.asarray(np.ascontiguousarray(graph.var_chks.T).reshape(-1))
    var_mask = jnp.asarray(np.ascontiguousarray(graph.var_mask.T))  # [dv, n]

    def votes_from(signed_mismatch):  # [B, m] of +/-1
        B = signed_mismatch.shape[0]
        g = jnp.take(signed_mismatch, var_chks, axis=1).reshape(B, max_dv, n)
        g = jnp.where(var_mask, g, 0.0)
        return jnp.sum(g, axis=1)

    def decode(syndromes, key):
        syndromes = jnp.asarray(syndromes)
        B = syndromes.shape[0]
        syn_f = syndromes.astype(jnp.float32)

        state0 = (
            jnp.zeros((B, n), jnp.float32),  # err
            jnp.zeros((B, n), jnp.float32),  # accumulated votes
            jnp.zeros((B,), bool),  # done (matched OR stuck)
            jnp.int32(0),
            jnp.zeros((B,), jnp.int32),  # iters
        )

        def cond(state):
            _, _, done, it, _ = state
            return (it < max_iters) & ~jnp.all(done)

        def body(state):
            err, votes, done, it, iters = state
            active = ~done
            syn_hat = syndrome_from(err)
            match = jnp.all(syn_hat == syn_f, axis=-1)
            mismatch = (syn_hat != syn_f).astype(jnp.float32)
            dv = votes_from(2.0 * mismatch - 1.0)
            update = active & ~match
            votes = jnp.where(update[:, None], votes + dv, votes)
            maxv = jnp.max(votes, axis=-1)
            stuck = maxv < 0

            r = jax.random.uniform(jax.random.fold_in(key, it), (B, n))
            score = jnp.where(votes == maxv[:, None], r, -1.0)
            flip_idx = jnp.argmax(score, axis=-1)
            flip = jax.nn.one_hot(flip_idx, n, dtype=jnp.float32)
            do_flip = update & ~stuck
            err = jnp.where(do_flip[:, None], jnp.abs(err - flip), err)

            newly_done = active & (match | stuck)
            iters = jnp.where(newly_done, it + 1, iters)
            return err, votes, done | newly_done, it + 1, iters

        err, _, done, it, iters = jax.lax.while_loop(cond, body, state0)
        iters = jnp.where(done, iters, it)
        return err.astype(jnp.int8), done, iters

    return decode


class BitFlipDecoder(Decoder):
    """Iterative bit-flip decoder with stochastic argmax tie-breaking.

    Args:
      H: ``[m, n]`` parity-check matrix.
      per: physical error rate (kept for API parity with the reference
        constructor, iterative_bitflip.jl:61 — the algorithm never reads it).
      max_iters: maximum flip iterations.

    The ``converged`` flag follows the reference semantics: True when the
    syndrome matched *or* when no bit had a non-negative vote ("nothing
    worth flipping"); decoding is stochastic, so exact outputs depend on
    ``seed``.

    Example:

    >>> import numpy as np
    >>> from ldpcdecoders_tpu import BitFlipDecoder, repetition_code
    >>> dec = BitFlipDecoder(repetition_code(3), 0.05, 10)
    >>> err, converged = dec.decode(np.array([1, 0]), seed=0)
    >>> err.astype(int).tolist(), converged
    ([1, 0, 0], True)
    """

    converged_implies_syndrome_match = False
    supports_per_override = False
    supports_vector_prior = False

    def __init__(self, H, per: float = 0.0, max_iters: int = 100):
        self.graph = H if isinstance(H, TannerGraph) else TannerGraph.from_pcm(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = float(per)
        self.max_iters = int(max_iters)
        self._decode_fn = jax.jit(make_bitflip_decode_fn(self.graph, self.max_iters))

    def _decode_batch(self, syndromes, seed: int = 0):
        key = jax.random.PRNGKey(seed)
        err, converged, iters = self._decode_fn(jnp.asarray(syndromes), key)
        return err, converged, iters, {}
