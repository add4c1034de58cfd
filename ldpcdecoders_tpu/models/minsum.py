"""Batched normalized/offset min-sum BP decoder (production throughput path).

The reference ships only probability-ratio sum-product BP; SURVEY.md §7.3
calls for an additional numerically-robust LLR-domain decoder for
production throughput.  Min-sum replaces the check node's tanh/ratio
products with a sign-parity + two-minimum reduction — no transcendentals,
no NaN guards — which maps onto plain elementwise vector code and loses only
~0.1-0.2 dB vs sum-product (recoverable with the normalization factor
alpha, Chen & Fossorier 2002).

Check-node exclusive minimum uses the classic two-min trick: for each
check, keep (min1, argmin1, min2); the leave-one-out min is min2 at the
argmin slot and min1 elsewhere.  Sign products use XOR parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.graph import TannerGraph
from ..ops.syndrome import make_syndrome_fn
from .base import Decoder
from .priors import per_to_llr

__all__ = ["MinSumDecoder", "make_minsum_decode_fn"]


def make_minsum_decode_fn(
    graph: TannerGraph,
    per: float,
    max_iters: int,
    *,
    alpha: float = 1.0,
    beta: float = 0.0,
    dtype=jnp.float32,
    edge_weights=None,
    damping: float = 0.0,
    check_every: int = 1,
    lane_damping: bool = False,
    vectorized_check: bool | None = None,
    layout: str = "var",
    track_best: bool = False,
):
    """Build a jittable ``syndromes [B,m] -> (err, converged, iters, llrs)``.

    ``damping`` in [0, 1) mixes each new variable->check message with the
    previous iteration's (``nu <- damping * nu_old + (1-damping) * nu_new``)
    — the standard stabilizer for loopy, trapping-set-heavy graphs such
    as circuit-level detector models, at zero extra memory passes.

    With ``lane_damping=True`` the damping factor becomes a PER-LANE
    decode-time argument: ``decode(syndromes, L0, gamma)`` with ``gamma``
    a ``[B]`` vector in [0, 1).  This is the device-fused ensemble
    primitive (models/staged.py): tiling one syndrome across K lanes
    with K damping values runs all ensemble members as ordinary batch
    lanes of a single compiled program — no per-member dispatch, no
    K-fold recompile (VERDICT r3 item 3).

    ``check_every`` runs the per-iteration syndrome-consistency test only
    every k-th iteration (always at the last).  On wide detector models
    the O(edges) syndrome gather costs as much as a message pass, and at
    deep iteration counts almost every check is a no-op; k=8 trims that
    overhead.  Semantics: a lane that becomes consistent between checks
    freezes at the next check (its reported ``iters`` is that check's
    iteration) — convergence claims are unchanged, iteration counts are
    rounded up to the check grid.

    ``edge_weights`` optionally applies trained per-edge message weights
    ``[max_iters, max_dv, n]`` (var-slot layout) in the variable update —
    the Nachmani-style weighted min-sum models/neural.py trains.

    ``layout`` selects the message residency (round-5 wide-DEM work):

      * ``"var"`` (default) — the original slot-major scheme: state is
        the var->check messages ``nu [B, max_dv, n]``; each iteration
        gathers them to check layout and the check outputs back.
      * ``"check"`` — state is the check->var side only: ``nu`` at a
        check slot is reconstructed as ``total[var] - mu`` (the
        exclusive-sum identity), so the check update needs NO gather
        and the remaining per-iteration gathers are [dc*m]-from-[n]
        (small source) plus the unavoidable [dv*n]-from-[dc*m].  On
        graphs where ``max_dc*m < max_dv*n`` (circuit-level DEMs:
        254k vs 380k on bb144) this also shrinks the loop-carried
        state ~33%.  Bit-identical outputs (same per-edge arithmetic
        and reduction orders; asserted in tests/test_minsum.py).
        Unsupported with edge_weights/per-iteration alpha.

    ``track_best`` keeps, per lane, the hard decision and LLRs of the
    iterate with the FEWEST syndrome mismatches seen at any check (the
    best-so-far trick of the reference's BP-OTS,
    /root/reference/src/decoders/bpots_decoder.jl:280-291, applied to
    min-sum).  Converged lanes are unchanged (mismatch 0 wins); a
    NON-converged lane returns its least-inconsistent iterate instead
    of wherever the oscillation happened to stop — measured round 5:
    every bb144 flagship failure was OSD fed a near-random final
    state (weight-100-370 corrections against weight-25-45 truths,
    failure_modes_r5.json), while trapped lanes routinely visit
    mismatch-1-3 iterates on the way.  Costs one [B, n] double-write
    per syndrome check.
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
    default_L0 = jnp.asarray(per_to_llr(per, n), dtype)
    # alpha/beta may be scalars or per-iteration [max_iters] arrays (the
    # neural min-sum decoder trains one pair per iteration — models/neural.py)
    per_iter_ab = np.ndim(alpha) or np.ndim(beta)
    if per_iter_ab:
        alphas = jnp.asarray(np.broadcast_to(alpha, (max_iters,)), dtype)
        betas = jnp.asarray(np.broadcast_to(beta, (max_iters,)), dtype)
        alpha = dtype(1.0)  # placeholders; body passes the per-iter values
        beta = dtype(0.0)
    else:
        alpha = dtype(alpha)
        beta = dtype(beta)
    if edge_weights is not None:
        edge_weights = jnp.asarray(edge_weights, dtype)
        if edge_weights.shape != (max_iters, max_dv, n):
            raise ValueError(
                f"edge_weights must be [{max_iters}, {max_dv}, {n}], "
                f"got {edge_weights.shape}"
            )
    if not 0.0 <= float(damping) < 1.0:
        raise ValueError(f"damping must be in [0, 1), got {damping}")
    if lane_damping and damping:
        raise ValueError("pass lane_damping gammas at decode time, not a "
                         "baked scalar damping")
    check_every = int(check_every)
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if layout not in ("var", "check"):
        raise ValueError(f"layout must be 'var' or 'check', got {layout!r}")
    if layout == "check" and (edge_weights is not None or per_iter_ab):
        raise ValueError("layout='check' supports the plain decode path "
                         "only (no edge_weights/per-iter alpha)")
    gam = dtype(damping)
    big = dtype(1e30)
    # var index per check slot — the same array the dense-free syndrome
    # gather uses; the check-layout decode gathers totals through it
    chk_varidx = (jnp.asarray(
        np.ascontiguousarray(graph.chk_vars.T).reshape(-1))
        if layout == "check" else None)

    # Two bit-identical check-update formulations, selected by degree:
    #   * unrolled two-min sweep — measured 1.5x faster than the
    #     argmin formulation on LOW-degree graphs (max_dc ~ 10: 1.86e10
    #     vs 1.23e10 edge-iters/s on the (1000,10,9) benchmark), where
    #     the per-slot [B, 1, m] steps stay few;
    #   * vectorized argmin/min reductions — for HIGH-degree graphs
    #     (circuit-level DEMs reach max_dc ~ 300, where the sweep emits
    #     ~600 tiny sequential ops: 53 s to compile and 1.4x slower on
    #     the bb144 DEM, measured round 4).  First-minimum tie-breaking
    #     is identical (jnp.argmin returns the first minimum), so the
    #     outputs are bit-for-bit the same; tests/test_minsum.py asserts.
    _vectorized_check = (max_dc > 16 if vectorized_check is None
                         else bool(vectorized_check))

    def check_update(nu_flat, syn_flip, alpha=alpha, beta=beta):
        """Var-side nu [B, dv*n] -> check-side mu [B, dc, m]."""
        B = nu_flat.shape[0]
        Ng = jnp.take(nu_flat, c2v, axis=1).reshape(B, max_dc, m)
        return check_core(Ng, syn_flip, alpha, beta)

    def check_core(Ng, syn_flip, alpha=alpha, beta=beta):
        """Check-slot messages [B, dc, m] -> mu [B, dc, m] (no gather)."""
        B = Ng.shape[0]
        masked = jnp.where(chk_mask, Ng, big)
        mag = jnp.abs(masked)
        neg = masked < dtype(0.0)
        syn = syn_flip[:, None, :]

        if _vectorized_check:
            # argmin-free two-min: ``excl = min2`` exactly at a UNIQUE
            # minimum slot, else ``min1``.  Bit-identical to the argmin
            # formulation (with ties, the argmin slot's "min2" is the
            # other tied copy == min1, so every slot gets min1 either
            # way), but avoids materializing the [B, max_dc, m] iota
            # ``arange == argmin`` comparison — measured 3.88 GB of s32
            # HLO temp per copy on the bb144 DEM at B=4096 (the round-4
            # OOM), and one full extra HBM pass per iteration.
            min1 = jnp.min(mag, axis=1)
            eq1 = mag == min1[:, None, :]
            unique = jnp.sum(eq1, axis=1, dtype=jnp.int32) == 1
            min2 = jnp.min(jnp.where(eq1, big, mag), axis=1)
            parity = (jnp.sum(neg, axis=1, dtype=jnp.int32) & 1).astype(
                bool)[:, None, :]
            excl = jnp.where(eq1 & unique[:, None, :],
                             min2[:, None, :], min1[:, None, :])
            flip = jnp.logical_xor(jnp.logical_xor(parity, neg), syn)
            mag_out = jnp.maximum(alpha * excl - beta, dtype(0.0))
            return jnp.where(flip, -mag_out, mag_out)

        min1 = mag[:, 0:1, :]
        idx1 = jnp.zeros((B, 1, m), jnp.int32)
        min2 = jnp.full_like(min1, big)
        parity = neg[:, 0:1, :]
        for k in range(1, max_dc):
            v = mag[:, k : k + 1, :]
            smaller = v < min1
            min2 = jnp.where(smaller, min1, jnp.minimum(min2, v))
            idx1 = jnp.where(smaller, k, idx1)
            min1 = jnp.where(smaller, v, min1)
            parity = jnp.logical_xor(parity, neg[:, k : k + 1, :])

        outs = []
        for k in range(max_dc):
            excl = jnp.where(idx1 == k, min2, min1)
            flip = jnp.logical_xor(
                jnp.logical_xor(parity, neg[:, k : k + 1, :]), syn
            )
            mag_out = jnp.maximum(alpha * excl - beta, dtype(0.0))
            outs.append(jnp.where(flip, -mag_out, mag_out))
        return jnp.concatenate(outs, axis=1)

    def var_update(mu, L0, W=None):
        """Check-side mu [B, dc, m] -> (nu [B, dv, n], llr [B, n]).

        ``W`` optionally weights each incoming message (Nachmani-style
        per-edge weights, [max_dv, n] in var-slot layout — see
        models/neural.py's per-edge training).
        """
        B = mu.shape[0]
        Mg = jnp.take(mu.reshape(B, max_dc * m), v2c, axis=1).reshape(B, max_dv, n)
        Mg = jnp.where(var_mask, Mg, dtype(0.0))
        if W is not None:
            Mg = Mg * W.astype(dtype)[None]
        total = L0 + jnp.sum(Mg, axis=1)
        nu = total[:, None, :] - Mg
        return nu, total

    def decode(syndromes, L0=None, gamma=None):
        if lane_damping:
            if gamma is None:
                raise ValueError("lane_damping decoders take a [B] gamma")
        elif gamma is not None:
            raise ValueError("gamma requires lane_damping=True")
        if L0 is None:
            L0 = default_L0
        L0 = jnp.asarray(L0, dtype)
        syndromes = jnp.asarray(syndromes)
        B = syndromes.shape[0]
        syn_f = syndromes.astype(jnp.float32)
        syn_flip = syndromes.astype(bool)
        gamma_b = None
        if lane_damping:
            # [B] = one damping factor per lane; [B, n] = per-variable
            # "memory strengths" (disordered-memory BP a la Relay-BP,
            # arXiv:2506.01779: randomized, possibly NEGATIVE, per-
            # variable factors break trapping-set symmetries that any
            # uniform gamma preserves)
            gamma_b = jnp.asarray(gamma, dtype)
            gamma_b = (gamma_b.reshape(B, 1, 1) if gamma_b.ndim == 1
                       else gamma_b.reshape(B, 1, n))

        # L0 may be a scalar, [n], or per-lane [B, n] (mixed channels /
        # per-shot soft information); normalize to [B, n] once
        L0 = jnp.broadcast_to(L0, (B, n)).astype(dtype)
        state0 = (
            jnp.broadcast_to(L0[:, None, :], (B, max_dv, n)),  # nu (var->check)
            jnp.zeros((B, n), jnp.float32),  # err
            L0,  # llrs
            jnp.zeros((B,), bool),
            jnp.int32(0),
            jnp.zeros((B,), jnp.int32),
        )
        bigi = jnp.int32(1 << 30)
        if track_best:
            state0 = state0 + (
                jnp.full((B,), bigi, jnp.int32),  # best mismatch count
                jnp.zeros((B, n), jnp.float32),   # best err
                jnp.broadcast_to(L0, (B, n)).astype(jnp.float32),
            )

        def mis_of(e):
            return jnp.sum(syndrome_from(e) != syn_f, axis=-1).astype(
                jnp.int32)

        def cond(st):
            done, it = st[3], st[4]
            return (it < max_iters) & ~jnp.all(done)

        def body(st):
            nu, err, llrs, done, it, iters = st[:6]
            if per_iter_ab:
                mu = check_update(
                    nu.reshape(B, max_dv * n), syn_flip,
                    alpha=alphas[it], beta=betas[it],
                )
            else:
                mu = check_update(nu.reshape(B, max_dv * n), syn_flip)
            if edge_weights is not None:
                nu_n, total = var_update(mu, L0, W=edge_weights[it])
            else:
                nu_n, total = var_update(mu, L0)
            if lane_damping:
                g = gamma_b  # [B, 1, 1], closed over from decode
                nu_n = g * nu + (dtype(1.0) - g) * nu_n
            elif damping:
                nu_n = gam * nu + (dtype(1.0) - gam) * nu_n
            errn = (total < 0).astype(jnp.float32)
            active = ~done
            # freeze only the [B, n] outputs; unfrozen [B, E] messages on
            # done lanes cannot influence any output (saves a memory pass)
            err = jnp.where(active[:, None], errn, err)
            llrs = jnp.where(active[:, None], total, llrs)
            if check_every == 1:
                mis = mis_of(err)
            else:
                is_check = (jnp.mod(it + 1, check_every) == 0) | (
                    it + 1 >= max_iters)
                mis = jax.lax.cond(
                    is_check, mis_of,
                    lambda e: jnp.full((B,), bigi, jnp.int32), err)
            ok = mis == 0
            iters = jnp.where(ok & active, it + 1, iters)
            out = (nu_n, err, llrs, done | ok, it + 1, iters)
            if track_best:
                bmis, berr, bllr = st[6:]
                better = active & (mis < bmis)
                bmis = jnp.where(better, mis, bmis)
                berr = jnp.where(better[:, None], err, berr)
                bllr = jnp.where(better[:, None], llrs, bllr)
                out = out + (bmis, berr, bllr)
            return out

        fin = jax.lax.while_loop(cond, body, state0)
        err, llrs, done, it, iters = fin[1], fin[2], fin[3], fin[4], fin[5]
        iters = jnp.where(done, iters, it)
        if track_best:
            # converged lanes froze at mismatch 0 (== their best); the
            # rest report their least-inconsistent iterate
            err, llrs = fin[7], fin[8]
        return err.astype(jnp.int8), done, iters, llrs

    def decode_check(syndromes, L0=None, gamma=None):
        """Check-resident variant: state is the check-slot messages;
        ``nu = total[var] - mu`` reconstructs the var->check side, so
        the check update runs gather-free.  Bit-identical to
        :func:`decode` (same per-edge arithmetic, same reduction
        orders)."""
        if lane_damping:
            if gamma is None:
                raise ValueError("lane_damping decoders take a [B] gamma")
        elif gamma is not None:
            raise ValueError("gamma requires lane_damping=True")
        if L0 is None:
            L0 = default_L0
        L0 = jnp.asarray(L0, dtype)
        syndromes = jnp.asarray(syndromes)
        B = syndromes.shape[0]
        syn_f = syndromes.astype(jnp.float32)
        syn_flip = syndromes.astype(bool)
        gamma_c = None
        if lane_damping:
            gamma_b = jnp.asarray(gamma, dtype)
            if gamma_b.ndim == 1:
                gamma_c = gamma_b.reshape(B, 1, 1)
            else:
                # per-variable memory strengths: constant across
                # iterations, so hoist the edge expansion out of the loop
                gamma_c = jnp.take(gamma_b.reshape(B, n), chk_varidx,
                                   axis=1).reshape(B, max_dc, m)

        L0 = jnp.broadcast_to(L0, (B, n)).astype(dtype)
        nu0 = jnp.take(L0, chk_varidx, axis=1).reshape(B, max_dc, m)
        state0 = (
            nu0,  # nu in CHECK layout [B, max_dc, m]
            jnp.zeros((B, n), jnp.float32),  # err
            L0,  # llrs
            jnp.zeros((B,), bool),
            jnp.int32(0),
            jnp.zeros((B,), jnp.int32),
        )
        bigi = jnp.int32(1 << 30)
        if track_best:
            state0 = state0 + (
                jnp.full((B,), bigi, jnp.int32),
                jnp.zeros((B, n), jnp.float32),
                jnp.broadcast_to(L0, (B, n)).astype(jnp.float32),
            )

        def mis_of(e):
            return jnp.sum(syndrome_from(e) != syn_f, axis=-1).astype(
                jnp.int32)

        def cond(st):
            done, it = st[3], st[4]
            return (it < max_iters) & ~jnp.all(done)

        def body(st):
            nu, err, llrs, done, it, iters = st[:6]
            mu = check_core(nu, syn_flip)
            Mg = jnp.take(mu.reshape(B, max_dc * m), v2c,
                          axis=1).reshape(B, max_dv, n)
            Mg = jnp.where(var_mask, Mg, dtype(0.0))
            total = L0 + jnp.sum(Mg, axis=1)
            nu_n = jnp.take(total, chk_varidx, axis=1).reshape(
                B, max_dc, m) - mu
            if lane_damping:
                nu_n = gamma_c * nu + (dtype(1.0) - gamma_c) * nu_n
            elif damping:
                nu_n = gam * nu + (dtype(1.0) - gam) * nu_n
            errn = (total < 0).astype(jnp.float32)
            active = ~done
            err = jnp.where(active[:, None], errn, err)
            llrs = jnp.where(active[:, None], total, llrs)
            if check_every == 1:
                mis = mis_of(err)
            else:
                is_check = (jnp.mod(it + 1, check_every) == 0) | (
                    it + 1 >= max_iters)
                mis = jax.lax.cond(
                    is_check, mis_of,
                    lambda e: jnp.full((B,), bigi, jnp.int32), err)
            ok = mis == 0
            iters = jnp.where(ok & active, it + 1, iters)
            out = (nu_n, err, llrs, done | ok, it + 1, iters)
            if track_best:
                bmis, berr, bllr = st[6:]
                better = active & (mis < bmis)
                bmis = jnp.where(better, mis, bmis)
                berr = jnp.where(better[:, None], err, berr)
                bllr = jnp.where(better[:, None], llrs, bllr)
                out = out + (bmis, berr, bllr)
            return out

        fin = jax.lax.while_loop(cond, body, state0)
        err, llrs, done, it, iters = fin[1], fin[2], fin[3], fin[4], fin[5]
        iters = jnp.where(done, iters, it)
        if track_best:
            err, llrs = fin[7], fin[8]
        return err.astype(jnp.int8), done, iters, llrs

    return decode_check if layout == "check" else decode


class MinSumDecoder(Decoder):
    """Normalized/offset min-sum decoder (LLR domain, production path).

    Args:
      H: ``[m, n]`` parity-check matrix.
      per: physical error rate (sets the channel LLR).
      max_iters: maximum iterations.
      alpha: normalization factor (1.0 = plain min-sum; ~0.8 typically
        recovers most of the sum-product gap).
      beta: offset subtracted from the magnitude before clamping at 0.
      damping: message-damping factor in [0, 1) — mixes in the previous
        iteration's variable->check messages; measurably lifts
        convergence on degenerate circuit-level detector graphs.
      check_every: run the syndrome-consistency test every k-th
        iteration instead of every iteration (see
        :func:`make_minsum_decode_fn`) — a throughput knob for wide
        detector models at deep iteration counts.
      dtype: message dtype, jnp.float32 (default) or jnp.bfloat16 (half
        the message bytes).
      layout: message residency, "var" (default) or "check" — see
        :func:`make_minsum_decode_fn`; decode-equivalent, not bitwise.

    Example:

    >>> import numpy as np
    >>> from ldpcdecoders_tpu import MinSumDecoder, repetition_code
    >>> dec = MinSumDecoder(repetition_code(3), 0.05, 10)
    >>> err, converged = dec.decode(np.array([1, 0]))
    >>> err.astype(int).tolist(), converged
    ([1, 0, 0], True)
    """

    def __init__(
        self,
        H,
        per: float,
        max_iters: int,
        *,
        alpha: float = 1.0,
        beta: float = 0.0,
        dtype=jnp.float32,
        damping: float = 0.0,
        check_every: int = 1,
        layout: str = "var",
    ):
        self.graph = H if isinstance(H, TannerGraph) else TannerGraph.from_pcm(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = per if np.ndim(per) else float(per)
        self.max_iters = int(max_iters)
        self.alpha = alpha if np.ndim(alpha) else float(alpha)
        self.beta = beta if np.ndim(beta) else float(beta)
        self.damping = float(damping)
        self.check_every = int(check_every)
        self.layout = str(layout)
        self.dtype = dtype
        self._decode_fn = jax.jit(
            make_minsum_decode_fn(
                self.graph,
                self.per,
                self.max_iters,
                alpha=self.alpha,
                beta=self.beta,
                dtype=dtype,
                damping=self.damping,
                check_every=self.check_every,
                layout=self.layout,
            )
        )

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        L0 = None
        if per is not None:
            L0 = jnp.asarray(per_to_llr(per, self.n), jnp.float32)
        err, converged, iters, llrs = self._decode_fn(jnp.asarray(syndromes), L0)
        return err, converged, iters, {"llrs": llrs}
