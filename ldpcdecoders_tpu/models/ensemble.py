"""Ensemble decoding: K member decoders, one max-likelihood pick.

BP-family decoders on degenerate graphs (circuit-level detector models
especially) fail on *different* shots depending on schedule knobs — a
measured fact: three damping values decode disjoint-enough failure sets
that picking per shot cuts bb144 circuit-level failures 2.4x over the
best single member (45 vs 106 on identical shots, LER 0.052 -> 0.022
at p=0.003; benchmarks/results/circuit_level_bb144_r3.json, ROADMAP).

:class:`EnsembleDecoder` productizes that experiment under the uniform
:class:`~.base.Decoder` contract: every member decodes the batch, and
each shot takes the **maximum-likelihood syndrome-consistent**
candidate — ranked by the soft prior weight ``sum(log((1-p)/p))`` over
asserted error positions (true ML under independent priors; plain
Hamming weight when no prior is given), NOT first-come.  Shots where
no member is consistent keep the first member's output (flagged
non-converged).

Cost: homogeneous ``MinSumDecoder`` members differing only in damping
fuse into ONE compiled lane-damped program (members are batch lanes,
selection on device — VERDICT r4 item 9); any other mix of decoders on
the same code (different alpha/schedules/inners — even different
families) runs K sequential member decodes plus a host selection pass.

No reference analog: the reference runs one decoder per call
(/root/reference/src/decoders/abstract_decoder.jl:31-48); this is an
accuracy tier built on top of that same contract.
"""

from __future__ import annotations

import numpy as np

from .base import Decoder

__all__ = ["EnsembleDecoder"]


class EnsembleDecoder(Decoder):
    """Decode with every member; per shot keep the most likely
    syndrome-consistent candidate.

    This is the GENERIC ensemble: members may be arbitrary decoder
    kinds, each dispatched in turn, with the consistency check and ML
    pick on host.  For the measured production use case — damping /
    disordered-memory variants of one min-sum on a detector model —
    use :class:`~.staged.StagedDemDecoder` instead: its members run as
    batch lanes of ONE compiled program with the pick on device, and
    only straggler lanes ever pay the ensemble cost (round-4 redesign
    of the round-3 bench-level ensemble; VERDICT r3 item 3).

    Args:
      members: decoders on the same ``[m, n]`` code (at least one).
      priors: optional ``[n]`` per-bit error probabilities used for the
        ML ranking (e.g. a DEM's mechanism priors).  ``None`` ranks by
        Hamming weight (uniform-prior ML).
      H: optional explicit ``[m, n]`` parity-check / detector matrix
        for the consistency check; defaults to the first member's
        attached dense matrix.
    """

    def __init__(self, members, *, priors=None, H=None):
        members = list(members)
        if not members:
            raise ValueError("need at least one member decoder")
        m, n = members[0].m, members[0].n
        for d in members:
            if (d.m, d.n) != (m, n):
                raise ValueError(
                    f"member {type(d).__name__} is [{d.m}, {d.n}]; "
                    f"ensemble is [{m}, {n}]")
        self.members = members
        self.m, self.n = m, n
        if H is None:
            graph = getattr(members[0], "graph", None)
            if graph is None or getattr(graph, "H", None) is None:
                raise ValueError(
                    "pass H= explicitly (the first member carries no "
                    "dense matrix for the consistency check)")
            H = graph.H
        self._H = (np.asarray(H.todense() if hasattr(H, "todense") else H)
                   != 0).astype(np.uint8)
        if self._H.shape != (m, n):
            raise ValueError(f"H must be [{m}, {n}], got {self._H.shape}")
        if priors is None:
            self._w = np.ones(n, np.float64)  # Hamming weight
        else:
            priors = np.asarray(priors, np.float64)
            if priors.shape != (n,) or np.any(priors <= 0) or np.any(
                    priors >= 1):
                raise ValueError(
                    f"priors must be [{n}] strictly in (0, 1)")
            self._w = np.log((1.0 - priors) / priors)
        self.supports_per_override = all(
            d.supports_per_override for d in members)
        self.supports_vector_prior = all(
            d.supports_vector_prior for d in members)
        # convergence reports "some member produced a consistent
        # candidate", which by construction implies a syndrome match
        self.converged_implies_syndrome_match = True
        # VERDICT r4 item 9: members sharing one graph and differing
        # only in damping fuse into the lane_damping program — K member
        # lanes of ONE compiled decode with the ML pick on device —
        # instead of K sequential dispatches + host matmuls
        self._fused_gammas = self._try_fuse_plan()
        self._fused_cache: dict[int, object] = {}

    def _try_fuse_plan(self):
        """Per-member damping vector when the ensemble is fusable
        (homogeneous ``MinSumDecoder`` members on one graph differing
        only in ``damping``), else ``None`` (heterogeneous members keep
        the sequential loop)."""
        from .minsum import MinSumDecoder

        ms = self.members
        if len(ms) < 2 or not all(type(d) is MinSumDecoder for d in ms):
            return None
        d0 = ms[0]
        if np.ndim(d0.per) or np.ndim(d0.alpha) or np.ndim(d0.beta):
            return None
        for d in ms[1:]:
            if d.graph is not d0.graph and not (
                    d.graph.H is not None and d0.graph.H is not None
                    and np.array_equal(d.graph.H, d0.graph.H)):
                return None
            if (np.ndim(d.per) or d.per != d0.per
                    or d.max_iters != d0.max_iters or d.alpha != d0.alpha
                    or d.beta != d0.beta or d.dtype != d0.dtype
                    or d.check_every != d0.check_every):
                return None
        return np.asarray([d.damping for d in ms], np.float32)

    def _fused_fn(self, B: int):
        """One jitted program per batch width: K-member lane-damped
        decode + on-device syndrome-consistent ML pick.  Tie-breaking
        matches the sequential loop exactly: first member with the
        strictly smallest score wins; no consistent member keeps member
        0's output."""
        if B in self._fused_cache:
            return self._fused_cache[B]
        import jax
        import jax.numpy as jnp

        from .minsum import make_minsum_decode_fn

        d0 = self.members[0]
        K = len(self.members)
        raw = make_minsum_decode_fn(
            d0.graph, d0.per, d0.max_iters, alpha=d0.alpha, beta=d0.beta,
            dtype=d0.dtype, check_every=d0.check_every, lane_damping=True)
        w_d = jnp.asarray(self._w, jnp.float32)

        def fused(syn_t, L0, gam):
            err, conv, iters, _ = raw(syn_t, L0, gam)
            # HIGHEST: TF32 rounding of the log-prior weights could flip
            # a near-tie pick against the sequential loop
            score = jnp.dot(err.astype(jnp.float32), w_d,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
            score = jnp.where(conv, score, jnp.inf).reshape(K, B)
            pick = jnp.argmin(score, axis=0)  # first-min ties, like the loop
            any_ok = jnp.any(conv.reshape(K, B), axis=0)
            err3 = err.reshape(K, B, self.n).astype(jnp.int8)
            out = jnp.take_along_axis(err3, pick[None, :, None], axis=0)[0]
            best = jnp.take_along_axis(score, pick[None, :], axis=0)[0]
            return (out, any_ok, jnp.sum(iters.reshape(K, B), axis=0),
                    jnp.where(jnp.isinf(best), -1.0, best))

        fn = jax.jit(fused)
        self._fused_cache[B] = fn
        return fn

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        syn = np.asarray(syndromes).astype(np.uint8)
        B = syn.shape[0]
        if self._fused_gammas is not None:
            import jax.numpy as jnp

            from .priors import per_to_llr

            L0 = None
            if per is not None:
                L0 = jnp.asarray(per_to_llr(per, self.n), jnp.float32)
            K = len(self.members)
            syn_t = jnp.asarray(np.tile(syn, (K, 1)))
            gam = jnp.asarray(np.repeat(self._fused_gammas, B))
            out, any_ok, iters, best = self._fused_fn(B)(syn_t, L0, gam)
            return out, any_ok, iters.astype(jnp.int32), {"ml_score": best}
        best = np.full(B, np.inf)
        out = None
        iters_acc = np.zeros(B, np.int64)
        any_consistent = np.zeros(B, bool)
        for k, dec in enumerate(self.members):
            e, conv, iters, _ = dec._call_decode(syn, seed + k, per)
            e = np.asarray(e).astype(np.uint8)
            iters_acc += np.asarray(iters, np.int64)
            consistent = (((e @ self._H.T) & 1) == syn).all(axis=1)
            score = np.where(consistent, (e * self._w[None, :]).sum(axis=1),
                             np.inf)
            if out is None:
                out = e.copy()  # fallback: first member's output
            upd = score < best
            out[upd] = e[upd]
            best[upd] = score[upd]
            any_consistent |= consistent
        import jax.numpy as jnp

        return (jnp.asarray(out.astype(np.int8)),
                jnp.asarray(any_consistent),
                jnp.asarray(iters_acc, jnp.int32),
                {"ml_score": jnp.asarray(np.where(np.isinf(best), -1.0,
                                                  best))})

    def batch_decode(self, syndromes, *, seed: int = 0, per=None):
        syndromes = np.asarray(syndromes)
        if syndromes.ndim != 2 or syndromes.shape[1] != self.m:
            raise ValueError(
                f"expected syndromes of shape [B, {self.m}], got "
                f"{syndromes.shape}")
        err, conv, _, _ = self._call_decode(syndromes, seed, per)
        return np.asarray(err), np.asarray(conv)
