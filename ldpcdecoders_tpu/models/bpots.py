"""Batched BP decoder with Ordered-Trapping-Set (OTS) biasing.

Batched re-design of the reference's LLR-domain BP-OTS
(/root/reference/src/decoders/bpots_decoder.jl:226-340, Chytas et al.
style):

  * var->check messages: leave-one-out sums computed as total-minus-own
    over a padded var-major layout (the reference's O(deg^2) skip-loops,
    bpots_decoder.jl:164-176, collapse to one masked sum);
  * check->var messages: clamped tanh products via exclusive cumulative
    products (tanh can be exactly 0, so no total/own division), syndrome
    sign, atanh, +/-100 clamp (bpots_decoder.jl:182-211);
  * oscillation tracking, best-(mismatch, weight) solution tracking with
    immediate convergence on mismatch==0 (bpots_decoder.jl:256-291);
  * every T iterations with nonzero mismatch: reset the working prior to
    the depolarizing-channel LLR, bias the max-oscillation node j1
    (ties -> smaller |llr|, then first index) and the global min-|llr|
    node j2 with -C (bpots_decoder.jl:294-336) — implemented as masked
    argmin reductions with the reference's exact tie order.

Everything is lane-local, so the batch axis shards embarrassingly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.graph import TannerGraph
from ..ops.exclusive import exclusive_prods
from ..ops.syndrome import make_syndrome_fn
from .base import Decoder
from .priors import per_to_depolarizing_llr

__all__ = ["BPOTSDecoder", "make_bpots_decode_fn", "select_bias_nodes"]

from ..ops.clamps import TANH_CLAMP as _MAX_TANH, MSG_CLAMP as _MAX_MSG


def select_bias_nodes(osc, absllr):
    """OTS bias-node selection with the reference's exact tie order.

    j1 = argmax oscillation count, ties broken by smaller ``|llr|``, then
    first index (bpots_decoder.jl:300-321); j2 = global argmin ``|llr|``,
    first index on ties (bpots_decoder.jl:323-334; j2 may equal j1).
    Batched: ``osc [B, n]`` int, ``absllr [B, n]``; returns
    ``(j1 [B], j2 [B], has_osc [B])`` — biasing only applies when the max
    oscillation count is > 0 (the reference's ``max_osc > 0`` guard).
    """
    max_osc = jnp.max(osc, axis=-1)
    has_osc = max_osc > 0
    cand = osc == max_osc[:, None]
    inf = jnp.asarray(jnp.inf, absllr.dtype)
    j1 = jnp.argmin(jnp.where(cand, absllr, inf), axis=-1)
    j2 = jnp.argmin(absllr, axis=-1)
    return j1, j2, has_osc


def make_bpots_decode_fn(
    graph: TannerGraph, per: float, max_iters: int, T: int = 9, C: float = 2.0,
    dtype=jnp.float32, trace: bool = False,
):
    """Build a jittable ``syndromes [B, m] -> (best_dec, converged, iters, llrs)``.

    With ``trace=True`` the returned function instead runs a fixed
    ``max_iters``-step ``lax.scan`` (no early exit; finished lanes stay
    frozen exactly as in the production ``while_loop``) and returns
    ``(outputs, trace_dict)`` where ``trace_dict`` stacks per-iteration
    decisions, pre-bias oscillation counters, syndrome mismatch counts,
    best-(mismatch, weight) tracking state, beliefs, and the bias nodes
    (j1, j2, applied) — the instrumentation used by the bitwise golden-
    parity tests (use ``dtype=jnp.float64`` under ``jax.enable_x64``).
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
    # depolarizing-channel LLR prior (bpots_decoder.jl:231); scalar or [n]
    default_pi = jnp.asarray(per_to_depolarizing_llr(per, n), dtype)
    C = dtype(C)

    def decode(syndromes, pi_val=None):
        if pi_val is None:
            pi_val = default_pi
        pi_val = jnp.asarray(pi_val, dtype)
        syndromes = jnp.asarray(syndromes)
        B = syndromes.shape[0]
        syn_f = syndromes.astype(jnp.float32)
        syn_bool = syndromes.astype(bool)

        state0 = dict(
            Mg=jnp.zeros((B, max_dv, n), dtype),  # check->var msgs, var-side
            Omega=jnp.broadcast_to(pi_val, (B, n)).astype(dtype),
            osc=jnp.zeros((B, n), jnp.int32),
            prior_dec=jnp.zeros((B, n), jnp.int32),
            best_dec=jnp.zeros((B, n), jnp.int32),
            best_mis=jnp.full((B,), m, jnp.int32),
            best_w=jnp.full((B,), n, jnp.int32),
            llrs=jnp.zeros((B, n), dtype),
            done=jnp.zeros((B,), bool),
            it=jnp.int32(0),
            iters=jnp.zeros((B,), jnp.int32),
        )

        def cond(s):
            return (s["it"] < max_iters) & ~jnp.all(s["done"])

        def body(s):
            it = s["it"]
            active = ~s["done"]

            # var -> check: nu = Omega + (sum of incoming mu) - own mu
            total = s["Omega"] + jnp.sum(s["Mg"], axis=1)
            nu = total[:, None, :] - s["Mg"]  # [B, dv, n]

            # check -> var: exclusive product of clamped tanh
            Ng = jnp.take(nu.reshape(B, max_dv * n), c2v, axis=1).reshape(B, max_dc, m)
            t = jnp.clip(jnp.tanh(dtype(0.5) * Ng), -_MAX_TANH, _MAX_TANH)
            t = jnp.where(chk_mask, t, dtype(1.0))
            fwd, bwd = exclusive_prods(t, axis=1)
            prod = fwd * bwd
            prod = jnp.where(syn_bool[:, None, :], -prod, prod)
            prod = jnp.clip(prod, -_MAX_TANH, _MAX_TANH)
            mu = jnp.clip(dtype(2.0) * jnp.arctanh(prod), -_MAX_MSG, _MAX_MSG)

            # gather back to the var side
            Mg_new = jnp.take(mu.reshape(B, max_dc * m), v2c, axis=1).reshape(B, max_dv, n)
            Mg_new = jnp.where(var_mask, Mg_new, dtype(0.0))

            # beliefs and decisions
            llrs = s["Omega"] + jnp.sum(Mg_new, axis=1)
            dec = (llrs < 0).astype(jnp.int32)

            # oscillation tracking (from the second iteration on)
            osc = s["osc"] + jnp.where(it >= 1, dec ^ s["prior_dec"], 0)

            # syndrome mismatch + weight
            syn_hat = syndrome_from(dec.astype(jnp.float32))
            mis = jnp.sum(syn_hat != syn_f, axis=-1).astype(jnp.int32)
            weight = jnp.sum(dec, axis=-1).astype(jnp.int32)

            # best-(mismatch, weight) tracking
            better = (mis < s["best_mis"]) | ((mis == s["best_mis"]) & (weight < s["best_w"]))
            upd = active & better
            best_dec = jnp.where(upd[:, None], dec, s["best_dec"])
            best_mis = jnp.where(upd, mis, s["best_mis"])
            best_w = jnp.where(upd, weight, s["best_w"])

            newly = active & (mis == 0)
            iters = jnp.where(newly, it + 1, s["iters"])
            done = s["done"] | newly

            # OTS biasing every T iterations with nonzero mismatch.  The
            # iteration counter is a batch-wide scalar, so the selection
            # work (two argmin reductions + two one-hots) is lax.cond-
            # gated: T-1 of every T iterations skip it entirely.
            def do_bias(operand):
                osc, llrs, Omega_prev, active, newly, mis = operand
                bias_lane = active & ~newly & (mis > 0)
                absllr = jnp.abs(llrs)
                j1, j2, has_osc = select_bias_nodes(osc, absllr)
                oh1 = jax.nn.one_hot(j1, n, dtype=bool)
                oh2 = jax.nn.one_hot(j2, n, dtype=bool)
                apply_b = (bias_lane & has_osc)[:, None]
                Omega_biased = jnp.where((oh1 | oh2) & apply_b, -C, pi_val)
                Omega = jnp.where(bias_lane[:, None], Omega_biased, Omega_prev)
                osc_post = jnp.where(oh1 & apply_b, 0, osc)
                # int32 regardless of x64 mode, matching the other branch
                return (
                    Omega,
                    osc_post,
                    j1.astype(jnp.int32),
                    j2.astype(jnp.int32),
                    bias_lane & has_osc,
                )

            def no_bias(operand):
                osc, llrs, Omega_prev, active, newly, mis = operand
                B = osc.shape[0]
                zj = jnp.zeros((B,), jnp.int32)
                return Omega_prev, osc, zj, zj, jnp.zeros((B,), bool)

            Omega, osc_post, j1, j2, biased = jax.lax.cond(
                (it + 1) % T == 0,
                do_bias,
                no_bias,
                (osc, llrs, s["Omega"], active, newly, mis),
            )

            record = dict(
                dec=dec,
                osc=osc,  # pre-bias counters (post-update)
                mis=mis,
                weight=weight,
                best_mis=best_mis,
                best_w=best_w,
                llrs=llrs,
                j1=j1,
                j2=j2,
                biased=biased,
                active=active,
            )

            # freeze finished lanes
            am = active[:, None]
            # [B, E] messages are deliberately left unfrozen on done lanes
            # (cannot influence outputs; saves a memory pass per iteration)
            new_s = dict(
                Mg=Mg_new,
                Omega=Omega,
                osc=jnp.where(am, osc_post, s["osc"]),
                prior_dec=jnp.where(am, dec, s["prior_dec"]),
                best_dec=best_dec,
                best_mis=best_mis,
                best_w=best_w,
                llrs=jnp.where(am, llrs, s["llrs"]),
                done=done,
                it=it + 1,
                iters=iters,
            )
            return new_s, record

        if trace:
            s, records = jax.lax.scan(
                lambda st, _: body(st), state0, None, length=max_iters
            )
            iters = jnp.where(s["done"], s["iters"], s["it"])
            outputs = (s["best_dec"].astype(jnp.int8), s["done"], iters, s["llrs"])
            return outputs, records

        s = jax.lax.while_loop(cond, lambda st: body(st)[0], state0)
        iters = jnp.where(s["done"], s["iters"], s["it"])
        return s["best_dec"].astype(jnp.int8), s["done"], iters, s["llrs"]

    return decode


class BPOTSDecoder(Decoder):
    """BP with Ordered-Trapping-Set biasing to escape trapping sets.

    Args:
      H: ``[m, n]`` parity-check matrix.
      per: physical error rate (depolarizing prior).
      max_iters: maximum BP iterations.
      T: biasing period (default 9, matching bpots_decoder.jl:90).
      C: bias constant (default 2.0).
      dtype: message dtype (float32 default; jnp.bfloat16 for throughput,
        jnp.float64 under ``jax.enable_x64`` for golden-trace work).

    Returns the best decision found ranked by (syndrome mismatch count,
    error weight); ``converged`` means a zero-mismatch solution was found.

    Example — decode on a 4-cycle (a classic trapping-set graph):

    >>> import numpy as np
    >>> from ldpcdecoders_tpu import BPOTSDecoder
    >>> from ldpcdecoders_tpu.codes import cycle_matrix
    >>> dec = BPOTSDecoder(cycle_matrix(4), 0.05, 50, T=3, C=2.0)
    >>> err, converged = dec.decode(np.array([1, 1, 0, 0]))
    >>> err.astype(int).tolist(), converged
    ([0, 1, 0, 0], True)
    """

    def __init__(
        self,
        H,
        per: float,
        max_iters: int,
        *,
        T: int = 9,
        C: float = 2.0,
        dtype=jnp.float32,
    ):
        self.graph = H if isinstance(H, TannerGraph) else TannerGraph.from_pcm(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = per if np.ndim(per) else float(per)
        self.max_iters = int(max_iters)
        self.T = int(T)
        self.C = float(C)
        self.dtype = dtype
        self._decode_fn = jax.jit(
            make_bpots_decode_fn(
                self.graph, self.per, self.max_iters, self.T, self.C, dtype=dtype
            )
        )

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        pi = None
        if per is not None:
            pi = jnp.asarray(per_to_depolarizing_llr(per, self.n), self.dtype)
        err, converged, iters, llrs = self._decode_fn(jnp.asarray(syndromes), pi)
        return err, converged, iters, {"llrs": llrs}
