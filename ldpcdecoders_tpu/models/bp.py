"""Batched sum-product belief-propagation decoder (flagship model).

Batched re-design of the reference's probability-ratio-domain BP
(/root/reference/src/decoders/belief_propagation.jl:121-188):

  * the reference's serial per-node prefix/suffix products become
    vectorized exclusive cumulative products over a padded degree axis
    (check side) and a guarded unrolled scan (variable side, preserving the
    reference's NaN-reset semantics);
  * messages live in flat fixed-shape edge arrays connected by static
    gather permutations (see codes/graph.py), not dense s x n matrices;
  * the batch is a leading axis decoded in lock-step by one
    ``lax.while_loop``; converged lanes are frozen (masked no-ops), which
    reproduces the reference's per-syndrome early-stop results exactly;
  * the per-iteration syndrome check ``(H @ err) % 2`` is exact small-
    integer arithmetic — an MXU matmul for small dense codes, an O(edges)
    adjacency gather at scale (ops/syndrome.py hybrid dispatch).

Numerics match SURVEY.md §2.2: delta = (p0 - p1) products with the syndrome
sign folded into the check-node prefix, ``x -> (1-x)/(1+x)`` ratio maps,
``log(1/total)`` soft output, and hard decision ``total >= 1``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.graph import TannerGraph
from ..ops.exclusive import exclusive_prods, guarded_exclusive_prod_scan
from ..ops.syndrome import make_syndrome_fn
from .base import Decoder

__all__ = ["BeliefPropagationDecoder", "make_bp_decode_fn"]


def _as_ratio(per, n, dtype):
    """Validate a scalar-or-[n] prior and convert to probability ratio."""
    from .priors import per_to_ratio

    return jnp.asarray(per_to_ratio(per, n), dtype)


def make_bp_decode_fn(graph: TannerGraph, per: float, max_iters: int, dtype=jnp.float32):
    """Build a jittable ``syndromes [B, m] -> (err, converged, iters, logp)``.

    The returned function is pure and shape-polymorphic only in B; all graph
    structure is baked in as static constants.
    """
    m, n = graph.m, graph.n
    max_dc, max_dv = graph.max_dc, graph.max_dv
    # slot-major layout [B, slot, node]: the large node axis is minor
    c2v_t, v2c_t, chk_mask_t, var_mask_t = graph.slot_major()
    c2v = jnp.asarray(c2v_t)
    v2c = jnp.asarray(v2c_t)
    chk_mask = jnp.asarray(chk_mask_t)  # [max_dc, m]
    var_mask = jnp.asarray(var_mask_t)  # [max_dv, n]
    syndrome_from = make_syndrome_fn(graph)  # O(edges), no dense H
    one = dtype(1.0)
    # scalar or per-bit [n] channel prior (the reference's channel_probs
    # vector, belief_propagation.jl:8-9, always filled with a scalar there)
    default_ratio = _as_ratio(per, n, dtype)

    def check_update(Q, syn_sign):
        """Var-side messages Q [B, dv, n] -> check-side R [B, dc, m]."""
        B = Q.shape[0]
        Qg = jnp.take(Q.reshape(B, max_dv * n), c2v, axis=1).reshape(B, max_dc, m)
        delta = dtype(2.0) / (one + Qg) - one
        delta = jnp.where(chk_mask, delta, one)
        fwd, bwd = exclusive_prods(delta, axis=1)
        r = syn_sign[:, None, :] * fwd * bwd
        return (one - r) / (one + r)

    def var_update(R, channel_ratio):
        """Check-side R [B, dc, m] -> (Q [B, dv, n], err [B, n], logp)."""
        B = R.shape[0]
        Rg = jnp.take(R.reshape(B, max_dc * m), v2c, axis=1).reshape(B, max_dv, n)
        Rg = jnp.where(var_mask, Rg, one)
        init = jnp.broadcast_to(channel_ratio, (B, n)).astype(dtype)
        Q, total = guarded_exclusive_prod_scan(Rg, init, axis=1)
        logp = jnp.log(one / total)
        err = (total >= one).astype(jnp.float32)
        return Q, err, logp

    def decode(syndromes, channel_ratio=None):
        # channel_ratio is a *traced* argument so one compiled program
        # serves every noise point of an FER sweep
        if channel_ratio is None:
            channel_ratio = default_ratio
        channel_ratio = jnp.asarray(channel_ratio, dtype)
        syndromes = jnp.asarray(syndromes)
        B = syndromes.shape[0]
        syn_f = syndromes.astype(jnp.float32)
        syn_sign = (1.0 - 2.0 * syn_f).astype(dtype)

        Q0 = jnp.where(
            var_mask,
            # scalar, [n], or per-lane [B, n] -> broadcast over [.., dv, n]
            channel_ratio[..., None, :] if channel_ratio.ndim else channel_ratio,
            one,
        ) * jnp.ones((B, 1, 1), dtype)  # [B, dv, n]
        state0 = (
            Q0,
            jnp.zeros((B, n), jnp.float32),  # err
            jnp.zeros((B, n), dtype),  # log_probabs
            jnp.zeros((B,), bool),  # done
            jnp.int32(0),  # it
            jnp.zeros((B,), jnp.int32),  # iters to converge
        )

        def cond(state):
            _, _, _, done, it, _ = state
            return (it < max_iters) & ~jnp.all(done)

        def body(state):
            Q, err, logp, done, it, iters = state
            R = check_update(Q, syn_sign)
            Qn, errn, logpn = var_update(R, channel_ratio)
            active = ~done
            # Only the [B, n] outputs are frozen on convergence; the [B, E]
            # message state may keep evolving on done lanes — it no longer
            # influences any output, and skipping its freeze saves a full
            # memory pass over the edge arrays per iteration.
            err = jnp.where(active[:, None], errn, err)
            logp = jnp.where(active[:, None], logpn, logp)
            ok = jnp.all(syndrome_from(err) == syn_f, axis=-1)
            iters = jnp.where(ok & active, it + 1, iters)
            return Qn, err, logp, done | ok, it + 1, iters

        _, err, logp, done, it, iters = jax.lax.while_loop(cond, body, state0)
        iters = jnp.where(done, iters, it)
        return err.astype(jnp.int8), done, iters, logp

    return decode


class BeliefPropagationDecoder(Decoder):
    """Sum-product BP decoder with reference-parity numerics.

    Args:
      H: ``[m, n]`` parity-check matrix (dense/sparse 0-1 array-like).
      per: physical error rate (channel crossover probability).
      max_iters: maximum BP iterations.
      dtype: message dtype (float32 default; the reference uses float64 on
        CPU, but FER behavior is dtype-robust and f32 is native on accelerators).

    Example — correct a single bit error on the length-3 repetition code:

    >>> import numpy as np
    >>> from ldpcdecoders_tpu import BeliefPropagationDecoder, repetition_code
    >>> dec = BeliefPropagationDecoder(repetition_code(3), 0.05, 10)
    >>> err, converged = dec.decode(np.array([1, 0]))
    >>> err.astype(int).tolist(), converged
    ([1, 0, 0], True)
    """

    def __init__(self, H, per: float, max_iters: int, *, dtype=jnp.float32):
        self.graph = H if isinstance(H, TannerGraph) else TannerGraph.from_pcm(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = per if np.ndim(per) else float(per)
        self.max_iters = int(max_iters)
        self.dtype = dtype
        self._decode_fn = jax.jit(
            make_bp_decode_fn(self.graph, self.per, self.max_iters, dtype)
        )

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        ratio = None
        if per is not None:
            ratio = _as_ratio(per, self.n, self.dtype)
        err, converged, iters, logp = self._decode_fn(jnp.asarray(syndromes), ratio)
        return err, converged, iters, {"log_probabs": logp}
