"""Int8-quantized min-sum decoder — the bandwidth-optimal throughput path.

BP decoding is memory-bandwidth-bound: per iteration the edge-message
arrays are read and written a small constant number of times, so bytes
per message set the throughput ceiling.  Hardware LDPC decoders have used 6-8
bit min-sum messages for two decades with negligible FER loss; this
decoder stores messages as int8 fixed-point LLRs (configurable
``scale`` = LSBs per LLR unit), quartering HBM traffic vs f32.

Arithmetic: min/sign/compare run natively on int8/int32 VPU lanes; the
per-variable totals accumulate in int32 (degree * 127 never overflows).
The syndrome check uses the hybrid exact-integer dispatch of
ops/syndrome.py (MXU matmul for small dense codes, O(edges) gather at
scale).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.graph import TannerGraph
from ..ops.syndrome import make_syndrome_fn
from .base import Decoder
from .priors import per_to_quantized_llr

__all__ = ["QuantizedMinSumDecoder", "make_minsum_q_decode_fn"]


def make_minsum_q_decode_fn(
    graph: TannerGraph,
    per: float,
    max_iters: int,
    *,
    scale: float = 4.0,
    beta_q: int = 1,
):
    """Build a jittable int8 min-sum ``syndromes [B,m] -> (err, conv, iters, llr_q)``.

    Args:
      scale: fixed-point LSBs per LLR unit (scale=4 -> step 0.25, range
        +/-31.75 — ample: messages saturate near the channel LLR times
        the degree).
      beta_q: integer offset (offset-min-sum) in quantized units.  The
        default 1 LSB both corrects min-sum's magnitude overestimate and
        damps the saturation limit-cycles that plain quantized min-sum
        exhibits near threshold (observed: 12% LER at per=0.02 with
        beta_q=0 vs 0% with beta_q=1).
    """
    m, n = graph.m, graph.n
    max_dc, max_dv = graph.max_dc, graph.max_dv
    # slot-major layout [B, slot, node]: the large node axis is minor
    c2v_t, v2c_t, chk_mask_t, var_mask_t = graph.slot_major()
    c2v = jnp.asarray(c2v_t)
    v2c = jnp.asarray(v2c_t)
    chk_mask = jnp.asarray(chk_mask_t)  # [max_dc, m]
    var_mask = jnp.asarray(var_mask_t)  # [max_dv, n]
    syndrome_from = make_syndrome_fn(graph)

    default_L0q = per_to_quantized_llr(per, scale)

    def check_update(nu_flat_i8, syn_flip):
        # dtype hygiene: every array materialized at fusion boundaries stays
        # int8/bool (1 byte); widening happens only inside fused reductions
        B = nu_flat_i8.shape[0]
        Ng = jnp.take(nu_flat_i8, c2v, axis=1).reshape(B, max_dc, m)
        # |x| is safe in int8: messages are clipped to [-127, 127] on write.
        # padded slots read garbage -> force max magnitude (inert in mins)
        mag = jnp.where(chk_mask, jnp.abs(Ng), jnp.int8(127))
        neg = jnp.where(chk_mask, Ng < 0, False)

        # single unrolled two-min + parity sweep (see minsum.py check_update)
        min1 = mag[:, 0:1, :]
        idx1 = jnp.zeros((B, 1, m), jnp.int32)
        min2 = jnp.full_like(min1, jnp.int8(127))
        parity = neg[:, 0:1, :]
        for k in range(1, max_dc):
            v = mag[:, k : k + 1, :]
            smaller = v < min1
            min2 = jnp.where(smaller, min1, jnp.minimum(min2, v))
            idx1 = jnp.where(smaller, k, idx1)
            min1 = jnp.where(smaller, v, min1)
            parity = jnp.logical_xor(parity, neg[:, k : k + 1, :])

        syn = syn_flip[:, None, :]
        outs = []
        for k in range(max_dc):
            excl = jnp.where(idx1 == k, min2, min1)
            flip = jnp.logical_xor(
                jnp.logical_xor(parity, neg[:, k : k + 1, :]), syn
            )
            mag_out = jnp.maximum(excl - jnp.int8(beta_q), jnp.int8(0))
            outs.append(jnp.where(flip, -mag_out, mag_out))
        return jnp.concatenate(outs, axis=1)

    def var_update(mu_i8, L0q):
        B = mu_i8.shape[0]
        Mg = jnp.take(mu_i8.reshape(B, max_dc * m), v2c, axis=1).reshape(B, max_dv, n)
        Mg = jnp.where(var_mask, Mg, jnp.int8(0))
        total = L0q + jnp.sum(Mg, axis=1, dtype=jnp.int32)
        nu = jnp.clip(total[:, None, :] - Mg.astype(jnp.int32), -127, 127).astype(jnp.int8)
        return nu, total

    def decode(syndromes, L0q=None):
        if L0q is None:
            L0q = jnp.int32(default_L0q)
        L0q = jnp.asarray(L0q, jnp.int32)
        syndromes = jnp.asarray(syndromes)
        B = syndromes.shape[0]
        syn_f = syndromes.astype(jnp.float32)
        syn_flip = syndromes.astype(bool)

        state0 = (
            jnp.broadcast_to(L0q.astype(jnp.int8), (B, max_dv, n)),
            jnp.zeros((B, n), jnp.float32),  # err
            jnp.broadcast_to(L0q, (B, n)),  # total llr (quantized)
            jnp.zeros((B,), bool),
            jnp.int32(0),
            jnp.zeros((B,), jnp.int32),
        )

        def cond(st):
            _, _, _, done, it, _ = st
            return (it < max_iters) & ~jnp.all(done)

        def body(st):
            nu, err, llr, done, it, iters = st
            mu = check_update(nu.reshape(B, max_dv * n), syn_flip)
            nu_n, total = var_update(mu, L0q)
            errn = (total < 0).astype(jnp.float32)
            active = ~done
            # freeze only the [B, n] outputs (see minsum.py)
            err = jnp.where(active[:, None], errn, err)
            llr = jnp.where(active[:, None], total, llr)
            ok = jnp.all(syndrome_from(err) == syn_f, axis=-1)
            iters = jnp.where(ok & active, it + 1, iters)
            return nu_n, err, llr, done | ok, it + 1, iters

        _, err, llr, done, it, iters = jax.lax.while_loop(cond, body, state0)
        iters = jnp.where(done, iters, it)
        return err.astype(jnp.int8), done, iters, llr

    return decode


class QuantizedMinSumDecoder(Decoder):
    """Int8 fixed-point min-sum decoder (maximum-throughput path).

    Args:
      H: ``[m, n]`` parity-check matrix.
      per: physical error rate (sets the quantized channel LLR).
      max_iters: maximum iterations.
      scale: fixed-point LSBs per LLR unit (default 4.0 -> 0.25 LLR step).
      beta_q: integer offset-min-sum correction in quantized units (default 1).
    """

    supports_vector_prior = False

    def __init__(self, H, per: float, max_iters: int, *, scale: float = 4.0, beta_q: int = 1):
        self.graph = H if isinstance(H, TannerGraph) else TannerGraph.from_pcm(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = float(per)
        self.max_iters = int(max_iters)
        self.scale = float(scale)
        self.beta_q = int(beta_q)
        self._decode_fn = jax.jit(
            make_minsum_q_decode_fn(
                self.graph, self.per, self.max_iters, scale=self.scale, beta_q=self.beta_q
            )
        )

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        L0q = None
        if per is not None:
            L0q = jnp.int32(per_to_quantized_llr(per, self.scale))
        err, converged, iters, llr = self._decode_fn(jnp.asarray(syndromes), L0q)
        return err, converged, iters, {"llr_q": llr}
