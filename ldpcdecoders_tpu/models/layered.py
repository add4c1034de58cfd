"""Layered (serial-C schedule) min-sum decoder.

Flooding BP updates every message from the *previous* iteration's state;
layered decoding processes checks in groups, each group immediately
seeing the LLR totals updated by the groups before it.  This classic
schedule converges in roughly half the iterations at the same FER —
every serious production LDPC decoder ships it.

Device mapping: checks are partitioned host-side into conflict-free layers
(no variable touched twice within a layer — Gallager block structure
gives exactly ``wc`` natural layers; general graphs use a greedy
partition, padded to equal size).  Per layer the update is:

    nu    = total[vars] - mu_old          (gather from the [B, n] totals)
    mu    = minsum(nu)                     (two-min + sign parity)
    total += scatter(mu - mu_old)          (unique indices within a layer)

The scatter has statically-unique indices per layer (the conflict-free
property), so XLA lowers it efficiently.  Convergence is checked once
per full sweep, like the reference's per-iteration check.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.graph import TannerGraph
from ..ops.syndrome import make_syndrome_fn
from .base import Decoder
from .priors import per_to_llr

__all__ = ["LayeredMinSumDecoder", "make_layered_minsum_fn", "build_layers"]


def build_layers(graph: TannerGraph):
    """Greedy conflict-free partition of checks into layers.

    Returns ``(layer_of_check [m], n_layers)`` such that no two checks in
    a layer share a variable.
    """
    m = graph.m
    layers_vars: list[set] = []
    layer_of = np.zeros(m, dtype=np.int64)
    for i in range(m):
        nbrs = set(graph.chk_vars[i, graph.chk_mask[i]].tolist())
        for li, used in enumerate(layers_vars):
            if not (used & nbrs):
                used |= nbrs
                layer_of[i] = li
                break
        else:
            layers_vars.append(set(nbrs))
            layer_of[i] = len(layers_vars) - 1
    return layer_of, len(layers_vars)


def make_layered_minsum_fn(
    graph: TannerGraph,
    per: float,
    max_iters: int,
    *,
    alpha: float = 1.0,
    beta: float = 0.0,
    dtype=jnp.float32,
    damping: float = 0.0,
):
    """Build a jittable layered min-sum ``syndromes [B,m] -> (err, conv, sweeps, llr)``.

    ``max_iters`` counts full sweeps (all layers), comparable to flooding
    iterations.  ``damping`` in [0, 1) mixes each layer's new check
    messages with the previous sweep's (``mu <- damping*mu_old +
    (1-damping)*mu_new``) — the loopy-graph stabilizer, as in
    :func:`~.minsum.make_minsum_decode_fn`.
    """
    if not 0.0 <= float(damping) < 1.0:
        raise ValueError(f"damping must be in [0, 1), got {damping}")
    m, n = graph.m, graph.n
    max_dc = graph.max_dc
    layer_of, L = build_layers(graph)
    mL = int(np.max(np.bincount(layer_of, minlength=L)))

    # per-layer padded constants: [L, mL, dc]
    chk_vars_l = np.zeros((L, mL, max_dc), np.int32)
    chk_mask_l = np.zeros((L, mL, max_dc), bool)
    syn_gather_l = np.zeros((L, mL), np.int32)  # check id feeding each slot
    slot_valid = np.zeros((L, mL), bool)
    fill = np.zeros(L, np.int64)
    for i in range(m):
        li = layer_of[i]
        k = fill[li]
        chk_vars_l[li, k] = graph.chk_vars[i]
        chk_mask_l[li, k] = graph.chk_mask[i]
        syn_gather_l[li, k] = i
        slot_valid[li, k] = True
        fill[li] += 1

    cv = jnp.asarray(chk_vars_l)
    cm = jnp.asarray(chk_mask_l)
    sg = jnp.asarray(syn_gather_l)
    sv = jnp.asarray(slot_valid)
    syndrome_from = make_syndrome_fn(graph)
    default_L0 = jnp.asarray(per_to_llr(per, n), dtype)
    alpha = dtype(alpha)
    beta = dtype(beta)
    gam = dtype(damping)
    big = dtype(1e30)

    def layer_update(total, mu_l, syn_flip_l, cv_l, cm_l):
        """One layer: returns (new total [B, n], new mu_l [B, mL, dc])."""
        B = total.shape[0]
        Tg = jnp.take(total, cv_l.reshape(-1), axis=1).reshape(B, *cv_l.shape)
        nu = Tg - mu_l
        # single unrolled two-min + parity sweep (see models/minsum.py)
        dc = nu.shape[-1]
        masked = jnp.where(cm_l, nu, big)
        mag = jnp.abs(masked)
        neg = masked < dtype(0.0)
        min1 = mag[..., 0:1]
        idx1 = jnp.zeros(min1.shape, jnp.int32)
        min2 = jnp.full_like(min1, big)
        parity = neg[..., 0:1]
        for k in range(1, dc):
            v = mag[..., k : k + 1]
            smaller = v < min1
            min2 = jnp.where(smaller, min1, jnp.minimum(min2, v))
            idx1 = jnp.where(smaller, k, idx1)
            min1 = jnp.where(smaller, v, min1)
            parity = jnp.logical_xor(parity, neg[..., k : k + 1])
        outs = []
        for k in range(dc):
            excl = jnp.where(idx1 == k, min2, min1)
            flip = jnp.logical_xor(
                jnp.logical_xor(parity, neg[..., k : k + 1]),
                syn_flip_l[:, :, None],
            )
            mag_out = jnp.maximum(alpha * excl - beta, dtype(0.0))
            outs.append(jnp.where(flip, -mag_out, mag_out))
        mu_new = jnp.where(cm_l, jnp.concatenate(outs, axis=-1), dtype(0.0))
        if damping:
            mu_new = gam * mu_l + (dtype(1.0) - gam) * mu_new
        # conflict-free layer -> unique var indices within the layer
        delta = (mu_new - mu_l).reshape(B, -1)
        # padded slots all point at variable 0 with delta exactly 0, so
        # the index list can contain duplicates; unique_indices=True would
        # be undefined behavior in that case — let XLA handle duplicates
        total = total.at[:, cv_l.reshape(-1)].add(delta)
        return total, mu_new

    def decode(syndromes, L0=None):
        if L0 is None:
            L0 = default_L0
        L0 = jnp.asarray(L0, dtype)
        syndromes = jnp.asarray(syndromes)
        B = syndromes.shape[0]
        syn_f = syndromes.astype(jnp.float32)
        syn_flip_all = syndromes.astype(bool)
        # per-layer syndrome slices [L, B, mL]
        syn_l = jnp.take(syn_flip_all, sg.reshape(-1), axis=1).reshape(B, L, mL)
        syn_l = jnp.where(sv[None], syn_l, False).transpose(1, 0, 2)

        state0 = (
            jnp.zeros((L, B, mL, max_dc), dtype),  # mu per layer
            jnp.broadcast_to(L0, (B, n)).astype(dtype),  # total llrs
            jnp.zeros((B, n), jnp.float32),  # err
            jnp.zeros((B,), bool),
            jnp.int32(0),
            jnp.zeros((B,), jnp.int32),
        )

        def cond(st):
            _, _, _, done, it, _ = st
            return (it < max_iters) & ~jnp.all(done)

        def body(st):
            mu, total, err, done, it, iters = st

            def sweep_layer(l, carry):
                total, mu = carry
                t_new, mu_l = layer_update(total, mu[l], syn_l[l], cv[l], cm[l])
                return t_new, mu.at[l].set(mu_l)

            total_n, mu_n = jax.lax.fori_loop(0, L, sweep_layer, (total, mu))
            errn = (total_n < 0).astype(jnp.float32)
            active = ~done
            err = jnp.where(active[:, None], errn, err)
            ok = jnp.all(syndrome_from(err) == syn_f, axis=-1)
            iters = jnp.where(ok & active, it + 1, iters)
            return mu_n, total_n, err, done | ok, it + 1, iters

        _, total, err, done, it, iters = jax.lax.while_loop(cond, body, state0)
        iters = jnp.where(done, iters, it)
        return err.astype(jnp.int8), done, iters, total

    return decode


class LayeredMinSumDecoder(Decoder):
    """Layered-schedule min-sum (≈2x fewer sweeps than flooding).

    Args:
      H: ``[m, n]`` parity-check matrix.
      per: physical error rate (scalar or per-bit [n] vector).
      max_iters: maximum full sweeps.
      alpha, beta: normalized/offset min-sum parameters.  alpha defaults
        to 0.8 here (not 1.0): the faster information propagation of the
        layered schedule amplifies plain min-sum's magnitude
        overestimate — measured on the (1000,10,9) code at per=0.04,
        alpha=1.0 layered converges on only 37% of lanes vs flooding's
        88%, while alpha=0.8 layered reaches 100% in 1.9 sweeps vs
        flooding's 3.5.
    """

    def __init__(self, H, per, max_iters: int, *, alpha: float = 0.8,
                 beta: float = 0.0, damping: float = 0.0):
        self.graph = H if isinstance(H, TannerGraph) else TannerGraph.from_pcm(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = per if np.ndim(per) else float(per)
        self.max_iters = int(max_iters)
        self.damping = float(damping)
        self.n_layers = build_layers(self.graph)[1]
        self._decode_fn = jax.jit(
            make_layered_minsum_fn(
                self.graph, self.per, self.max_iters, alpha=alpha, beta=beta,
                damping=self.damping,
            )
        )

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        L0 = None
        if per is not None:
            L0 = jnp.asarray(per_to_llr(per, self.n), jnp.float32)
        err, converged, iters, llr = self._decode_fn(jnp.asarray(syndromes), L0)
        return err, converged, iters, {"llrs": llr}
