"""Batched BP + Ordered-Statistics-Decoding (OSD) decoder.

Batched re-design of the reference's BP-OSD
(/root/reference/src/decoders/belief_propagation_osd.jl:49-209):

  * inner BP is the batched flagship decoder (models/bp.py), whose soft
    outputs (log probabilities) rank column reliability;
  * per-lane column permutation + bit-packing happen on device; the GF(2)
    elimination runs as fixed-trip masked loops over uint32-packed rows
    (ops/gf2.py), vmapped over the lane batch;
  * OSD-0 runs **only on the lanes whose BP output is syndrome-
    inconsistent** — host orchestration gathers failing lanes into a
    power-of-two bucket, decodes them, and scatters back.  This is the
    batched analog of the reference's early-return fast path
    (belief_propagation_osd.jl:66-74) and keeps the expensive elimination
    off the >99% of lanes where BP converges;
  * OSD-w (w>0) runs on every lane, matching the reference's semantics
    (the 2^w sweep may return a lower-weight solution even when BP
    converged).

``converged`` reports *BP* convergence (reference parity); the returned
error estimate is always syndrome-consistent for OSD-0, and for OSD-w
whenever H's rows span the syndrome.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.graph import TannerGraph
from ..ops.gf2 import gf2_osd0, gf2_osdw, osdw_sweep
from ..ops.pallas_gf2 import fits_block, gf2_eliminate_pallas, gf2_osd0_pallas
from .base import Decoder
from .bp import make_bp_decode_fn
from .priors import next_pow2, per_to_llr

__all__ = ["BeliefPropagationOSDDecoder", "make_fused_bposd_fn"]


def _make_inner(graph: TannerGraph, per: float, max_iters: int, inner,
                damping: float = 0.0):
    """Resolve the OSD's inner soft-output decoder.

    Returns ``(decode_fn, prior_fn)`` where ``decode_fn(syndromes, prior)
    -> (err, converged, iters, soft)`` and ``soft`` ranks column
    reliability — BP's log probability ratios and the min-sum family's
    LLRs are the same quantity (log(p0/p1)), so the reference's
    reliability sort (belief_propagation_osd.jl:53-55) applies to either.
    ``prior_fn(per)`` builds the per-override argument in the inner
    decoder's native prior domain (probability ratio for BP, LLR for
    min-sum).

    ``inner`` may be ``"sumproduct"`` (default, reference semantics),
    ``"minsum"``, or a constructed min-sum-family :class:`Decoder` on the
    same code — e.g. a trained :class:`~..models.neural.NeuralMinSumDecoder`,
    which turns this into neural-BP+OSD.
    """
    if inner is None or inner == "sumproduct":
        if damping:
            raise ValueError(
                "damping is a min-sum knob; use inner='minsum' (or pass a "
                "damped MinSumDecoder instance)")
        return make_bp_decode_fn(graph, per, max_iters), _prior_fn_for(graph, inner)
    if inner == "minsum":
        from .minsum import make_minsum_decode_fn

        return (make_minsum_decode_fn(graph, per, max_iters,
                                      damping=damping),
                _prior_fn_for(graph, inner))
    fn = getattr(inner, "_decode_fn", None)
    inner_graph = getattr(inner, "graph", None)
    if fn is None or inner_graph is None:
        raise TypeError(
            "inner must be 'sumproduct', 'minsum', or a min-sum-family "
            f"Decoder instance (MinSumDecoder / NeuralMinSumDecoder), got {inner!r}"
        )
    if (inner_graph.m, inner_graph.n) != (graph.m, graph.n):
        raise ValueError(
            f"inner decoder is built on an [{inner_graph.m}, {inner_graph.n}] "
            f"code; this OSD wraps [{graph.m}, {graph.n}]"
        )
    return fn, _prior_fn_for(graph, inner)


def _prior_fn_for(graph: TannerGraph, inner):
    """Per-override prior builder in the inner decoder's native domain."""
    if inner is None or inner == "sumproduct":
        from .bp import _as_ratio

        return lambda p: _as_ratio(p, graph.n, jnp.float32)
    return lambda p: jnp.asarray(per_to_llr(p, graph.n), jnp.float32)


def _gf2_rank(H: np.ndarray) -> int:
    """Rank of a 0/1 matrix over GF(2) (bit-packed elimination)."""
    H = np.asarray(H, dtype=np.uint8)
    m, n = H.shape
    W = (n + 63) // 64
    pad = W * 64 - n
    bits = np.pad(H, [(0, 0), (0, pad)]).reshape(m, W, 64).astype(np.uint64)
    rows = (bits << np.arange(64, dtype=np.uint64)).sum(axis=2, dtype=np.uint64)
    rank = 0
    for j in range(n):
        w, b = divmod(j, 64)
        col = (rows[:, w] >> np.uint64(b)) & np.uint64(1)
        avail = np.flatnonzero(col[rank:]) + rank
        if avail.size == 0:
            continue
        k = avail[0]
        rows[[rank, k]] = rows[[k, rank]]
        elim = np.flatnonzero(
            ((rows[:, w] >> np.uint64(b)) & np.uint64(1)).astype(bool)
        )
        elim = elim[elim != rank]
        rows[elim] ^= rows[rank]
        rank += 1
        if rank == m:
            break
    return rank


def make_osd_fns(
    graph: TannerGraph,
    osd_order: int,
    *,
    osd_method: str = "exhaustive",
    kernel: bool | None = None,
):
    """Build jitted batched OSD-0 / OSD-w post-processors.

    Each takes ``(syndromes [B,m], bp_err [B,n], log_probabs [B,n])`` in
    *unsorted* column order and returns the ``[B, n]`` corrected error.

    The Gauss–Jordan elimination runs in the Pallas kernel
    (ops/pallas_gf2.py) on a CUDA device when one lane's packed matrix
    fits its block (``kernel=None``, the default), and in the XLA
    ``while_loop`` form (ops/gf2.py) otherwise; both give identical
    outputs.  ``kernel=False`` forces the XLA form and ``kernel=True``
    the kernel on every platform (reference comparisons and tests).

    ``osd_method="combination_sweep"`` replaces the exhaustive 2^w
    candidate sweep with OSD-CS (ops/gf2.py::osd_cs_sweep): all single
    flips over the non-pivot set plus pair flips within the first
    ``osd_order`` columns — far deeper search at near-flat cost.
    """
    H_cols = jnp.asarray(graph.require_H().T.astype(np.uint32))  # [n, m] for column gather
    n, m = graph.n, graph.m
    W = (n + 31) // 32
    # zero row at index n: padded perm slots gather an all-zero column
    H_cols_z = jnp.concatenate([H_cols, jnp.zeros((1, m), jnp.uint32)], axis=0)
    _shifts = jnp.left_shift(
        jnp.uint32(1), jnp.arange(32, dtype=jnp.uint32)
    )[:, None]

    def sort_and_pack(syndrome, bp_err, logp):
        probs = jnp.exp(logp.astype(jnp.float32))
        reliability = jnp.maximum(probs, 1.0 - probs)
        perm = jnp.argsort(-reliability, stable=True)
        # pack the reliability-sorted columns wordwise (scan over W words
        # of 32 columns) instead of materializing the [n, m] permuted H
        # per lane — the naive take+pack peaks at O(B*n*m) u32, which
        # exhausts HBM for large codes (observed: n=2400, B=1024 -> 23 GB)
        permp = jnp.concatenate(
            [perm, jnp.full((W * 32 - n,), n, perm.dtype)]
        ) if W * 32 != n else perm

        def word(_, idx):
            cols = jnp.take(H_cols_z, idx, axis=0)  # [32, m]
            return None, jnp.sum(cols * _shifts, axis=0, dtype=jnp.uint32)

        _, words = jax.lax.scan(word, None, permp.reshape(W, 32))  # [W, m]
        Hp = words.T  # [m, W] packed rows of H[:, perm]
        bp_sorted = jnp.take(bp_err.astype(jnp.uint32), perm)
        return perm, Hp, bp_sorted

    def unsort(perm, corr_sorted):
        out = jnp.zeros((n,), jnp.uint32)
        return out.at[perm].set(corr_sorted)

    def osd0_lane(syndrome, bp_err, logp):
        perm, Hp, bp_sorted = sort_and_pack(syndrome, bp_err, logp)
        syn_u = syndrome.astype(jnp.uint32)
        resid = syn_u ^ (
            jnp.sum(H_cols.T * bp_err.astype(jnp.uint32)[None, :], axis=1)
            & jnp.uint32(1)
        )
        corr = gf2_osd0(Hp, bp_sorted, resid, n)
        return unsort(perm, corr)

    if osd_method not in ("exhaustive", "combination_sweep"):
        raise ValueError(
            f"osd_method must be 'exhaustive' or 'combination_sweep', got {osd_method!r}"
        )
    if osd_method == "combination_sweep":
        from ..ops.gf2 import gf2_osd_cs, osd_cs_sweep

        sweep_full = lambda Hp, be, syn: gf2_osd_cs(Hp, be, syn, osd_order, n)  # noqa: E731
        sweep_rref = lambda ht, sv, pv, rv, be: osd_cs_sweep(  # noqa: E731
            ht, sv, pv, rv, be, osd_order, n
        )
    else:
        sweep_full = lambda Hp, be, syn: gf2_osdw(Hp, be, syn, osd_order, n)  # noqa: E731
        sweep_rref = lambda ht, sv, pv, rv, be: osdw_sweep(  # noqa: E731
            ht, sv, pv, rv, be, osd_order, n
        )

    def osdw_lane(syndrome, bp_err, logp):
        perm, Hp, bp_sorted = sort_and_pack(syndrome, bp_err, logp)
        corr = sweep_full(Hp, bp_sorted, syndrome.astype(jnp.uint32))
        return unsort(perm, corr)

    def osdw_batch_pallas(syndromes, bp_errs, logps):
        perm, Hp, bp_sorted = jax.vmap(sort_and_pack)(syndromes, bp_errs, logps)
        Ht2, s2, piv = gf2_eliminate_pallas(
            jnp.transpose(Hp, (0, 2, 1)), syndromes.astype(jnp.uint32), n
        )
        r = jnp.sum((piv != n).astype(jnp.int32), axis=1)
        corr = jax.vmap(sweep_rref)(Ht2, s2, piv, r, bp_sorted)
        return jax.vmap(unsort)(perm, corr)

    def osd0_batch_pallas(syndromes, bp_errs, logps):
        perm, Hp, bp_sorted = jax.vmap(sort_and_pack)(syndromes, bp_errs, logps)
        # residual via one matmul (row sums are small ints: exact in f32
        # and in TF32, whose 10-bit mantissa holds the 0/1 operands)
        hb = jnp.dot(
            bp_errs.astype(jnp.float32),
            H_cols.astype(jnp.float32),
            preferred_element_type=jnp.float32,
        )  # [B, m]
        resid = syndromes.astype(jnp.uint32) ^ (hb.astype(jnp.uint32) & jnp.uint32(1))
        corr = gf2_osd0_pallas(jnp.transpose(Hp, (0, 2, 1)), resid, bp_sorted, n)
        return jax.vmap(unsort)(perm, corr)

    osd0_xla, osdw_xla = jax.vmap(osd0_lane), jax.vmap(osdw_lane)
    if kernel is None:
        if not fits_block(n, m):
            return osd0_xla, osdw_xla
        # the kernel is Triton code: CUDA lowers it, other platforms take
        # the XLA form of the same elimination
        return (
            lambda *a: jax.lax.platform_dependent(
                *a, cuda=osd0_batch_pallas, default=osd0_xla),
            lambda *a: jax.lax.platform_dependent(
                *a, cuda=osdw_batch_pallas, default=osdw_xla),
        )
    if kernel:
        return osd0_batch_pallas, osdw_batch_pallas
    return osd0_xla, osdw_xla


def make_fused_bposd_fn(
    graph: TannerGraph,
    per: float,
    max_iters: int,
    osd_order: int,
    *,
    osd_scope: str = "all",
    inner=None,
    osd_method: str = "exhaustive",
    damping: float = 0.0,
    kernel: bool | None = None,
):
    """Build ONE jittable program: BP + ``lax.cond``-gated OSD post-processing.

    The compacting path in :class:`BeliefPropagationOSDDecoder` reads the
    converged mask on the host to gather failing lanes — a device->host
    sync that serializes pipelined serving.  Here the whole decode is a
    single XLA program: for OSD-0 the elimination branch only executes
    when *some* lane failed BP (``lax.cond`` on ``all(converged)``), so
    the common all-converged batch costs exactly one BP program and
    pipelines like plain BP.  For osd_order > 0 the sweep runs on every
    lane (reference semantics, belief_propagation_osd.jl:184-206) so the
    fusion is unconditional.

    Trade-off vs the compacting path: when a *few* lanes fail, the fused
    OSD-0 branch eliminates the full batch instead of a small bucket.
    Prefer fused for latency-bound / async serving at low physical error
    rates; prefer the default compacting path for throughput at noise
    levels where failures are routine.
    """
    bp_fn, _ = _make_inner(graph, per, max_iters, inner, damping=damping)
    osd0_batch, osdw_batch = make_osd_fns(
        graph, osd_order, osd_method=osd_method, kernel=kernel
    )

    if osd_order > 0 and osd_scope == "all":

        def fused_w(syndromes, ratio=None):
            bp_err, converged, iters, logp = bp_fn(syndromes, ratio)
            corr = osdw_batch(syndromes, bp_err, logp)
            return corr.astype(jnp.int8), converged, iters, logp

        return fused_w

    # cond-gated form: OSD-0 always, OSD-w under osd_scope="failed"
    post = osd0_batch if osd_order == 0 else osdw_batch

    def fused_gated(syndromes, ratio=None):
        bp_err, converged, iters, logp = bp_fn(syndromes, ratio)

        def run_osd(_):
            corr = post(syndromes, bp_err, logp).astype(jnp.int8)
            return jnp.where(converged[:, None], bp_err, corr)

        errs = jax.lax.cond(
            jnp.all(converged), lambda _: bp_err, run_osd, operand=None
        )
        return errs, converged, iters, logp

    return fused_gated


class BeliefPropagationOSDDecoder(Decoder):
    """BP with OSD post-processing; output is always syndrome-consistent.

    Args:
      H: ``[m, n]`` parity-check matrix.
      per: physical error rate.
      max_iters: maximum BP iterations.
      osd_order: OSD order w (default 0); the sweep scales as 2^w.
      fused: compile BP + OSD into ONE device program with the OSD-0
        elimination gated behind ``lax.cond(all(converged))`` instead of
        host-side failing-lane compaction.  No device->host sync, so
        :meth:`~Decoder.batch_decode_async` pipelines like plain BP —
        use for low-noise serving.  When a few lanes fail, the fused
        branch eliminates the whole batch, so keep the default
        (compacting) path for high-noise throughput.
      osd_scope: ``"all"`` (default, reference semantics): with
        osd_order > 0 the 2^w sweep runs on *every* lane — it may
        return a lower-weight solution even where BP converged
        (belief_propagation_osd.jl:184-206).  ``"failed"`` (deliberate
        deviation, opt-in): route OSD-w through the same failing-lane
        compaction / cond gating as OSD-0, keeping BP's output on
        converged lanes — near-OSD-0 throughput when BP mostly
        converges, at the cost of the weight-minimization refinement
        on converged lanes.
      osd_method: ``"exhaustive"`` (default — the reference's 2^w sweep,
        belief_propagation_osd.jl:184-206) or ``"combination_sweep"``
        (OSD-CS, Roffe et al. 2020): with osd_order = lambda, search the
        base completion, every single non-pivot flip, and all pair flips
        within the first lambda most-reliable non-pivot columns —
        ``1 + (n-r) + lambda*(lambda-1)/2`` candidates, so lambda=60
        searches deeper than exhaustive w=20 would at about the cost of
        exhaustive w=4.  No rank clamp applies (out-of-range flips are
        masked in the sweep).
      inner: the soft-output decoder whose LLRs rank the OSD column
        reliabilities.  ``"sumproduct"`` (default — reference
        semantics, belief_propagation_osd.jl:49-61), ``"minsum"``, or a
        constructed min-sum-family decoder on the same code — passing a
        trained :class:`~ldpcdecoders_tpu.NeuralMinSumDecoder` gives
        neural-BP+OSD, the strongest decoder family here for quantum
        LDPC codes (benchmarks/neural_bicycle.py).

    Example:

    >>> import numpy as np
    >>> from ldpcdecoders_tpu import BeliefPropagationOSDDecoder, repetition_code
    >>> dec = BeliefPropagationOSDDecoder(repetition_code(3), 0.05, 10)
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
        osd_order: int = 0,
        fused: bool = False,
        osd_scope: str = "all",
        inner=None,
        osd_method: str = "exhaustive",
        osd_impl: str = "device",
        damping: float = 0.0,
        osd_triples: int = 0,
    ):
        if osd_scope not in ("all", "failed"):
            raise ValueError("osd_scope must be 'all' or 'failed'")
        if osd_impl not in ("device", "host"):
            raise ValueError("osd_impl must be 'device' or 'host'")
        if osd_method not in ("exhaustive", "combination_sweep"):
            raise ValueError(
                "osd_method must be 'exhaustive' or 'combination_sweep', "
                f"got {osd_method!r}"
            )
        self.graph = H if isinstance(H, TannerGraph) else TannerGraph.from_pcm(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = float(per)
        self.max_iters = int(max_iters)
        if osd_order < 0:
            raise ValueError("osd_order must be >= 0")
        if osd_order > 0 and osd_method == "combination_sweep":
            # pair indices past the information set are masked inside the
            # sweep, so lam needs no rank clamp — only a static bound on n
            self.graph.require_H()
            osd_order = min(osd_order, self.n)
        elif osd_order > 0:  # the rank computation is only needed for the clamp
            max_order = self.n - _gf2_rank(self.graph.require_H())
            if osd_order > max_order:
                # reference warns and clamps (belief_propagation_osd.jl:174-177)
                import warnings

                warnings.warn(
                    f"osd_order {osd_order} exceeds information-set size "
                    f"{max_order}; clamping.", stacklevel=2
                )
                osd_order = int(max_order)
        else:
            self.graph.require_H()  # OSD always needs dense rows
        self.osd_order = int(osd_order)
        # whether the device OSD elimination compiles the Pallas kernel
        # on a CUDA device (ops/pallas_gf2.py::fits_block)
        self.osd_kernel = fits_block(self.n, self.m)
        self.fused = bool(fused)
        self.osd_scope = osd_scope
        self.inner = inner
        self.osd_method = osd_method
        self.osd_impl = osd_impl
        self.damping = float(damping)
        if osd_triples and not (osd_impl == "host"
                                and osd_method == "combination_sweep"):
            raise ValueError(
                "osd_triples (order-3 combination sweep) is a host "
                "combination_sweep extension: set osd_impl='host', "
                "osd_method='combination_sweep'")
        self.osd_triples = int(osd_triples)
        self._Hcols = None
        if osd_impl == "host":
            # the threaded C++ column-reduction eliminator
            # (native/gf2_osd.cpp): golden-identical to the device OSD-0
            # given the same column order, and the only working path for
            # detector models too wide for the device elimination (the
            # 864 x 31,648 bb144 circuit DEM).  BP
            # stays on device; failing lanes round-trip to host, so the
            # program is untraceable (no fused mode).
            from ..native import gf2_pack_cols, native_available

            if self.osd_order != 0 and self.osd_method != "combination_sweep":
                raise ValueError(
                    "osd_impl='host' supports osd_order=0 (exhaustive) or "
                    "any order with osd_method='combination_sweep'")
            if self.fused:
                raise ValueError(
                    "osd_impl='host' is a host round-trip; fused=True "
                    "cannot trace it")
            if not native_available():
                raise RuntimeError(
                    "osd_impl='host' needs the native library (g++); "
                    "build failed or unavailable on this system")
            self._Hcols = gf2_pack_cols(self.graph.require_H())
        if self.fused:
            self._fused_fn = jax.jit(
                make_fused_bposd_fn(
                    self.graph,
                    self.per,
                    self.max_iters,
                    self.osd_order,
                    osd_scope=self.osd_scope,
                    inner=inner,
                    osd_method=self.osd_method,
                    damping=self.damping,
                )
            )
            self._prior_fn = _prior_fn_for(self.graph, inner)
        else:
            inner_fn, self._prior_fn = _make_inner(
                self.graph, self.per, self.max_iters, inner,
                damping=self.damping,
            )
            self._bp_fn = jax.jit(inner_fn)
            osd0, osdw = make_osd_fns(
                self.graph,
                self.osd_order,
                osd_method=self.osd_method,
            )
            self._osd0_batch, self._osdw_batch = jax.jit(osd0), jax.jit(osdw)

    def _host_osd0(self, syn_np, bp_np, logp_np):
        """Native OSD on a compacted lane subset (original-order I/O):
        OSD-0 column reduction, or the OSD-CS combination sweep when
        ``osd_method='combination_sweep'`` with ``osd_order`` as the
        pair depth.  The per-lane column order replicates
        sort_and_pack: f32 reliability max(p, 1-p), stable descending
        argsort; both paths are golden-tested bit-identical to the
        device kernels."""
        from ..native import gf2_osd0_host, gf2_osd_cs_host

        with np.errstate(over="ignore"):
            # large LLRs overflow exp to inf exactly as the device path's
            # f32 exp does; inf reliabilities tie and break by index the
            # same way, so ordering parity is preserved
            probs = np.exp(logp_np.astype(np.float32))
            rel = np.maximum(probs, 1.0 - probs)
        order = np.argsort(-rel, axis=1, kind="stable").astype(np.int32)
        if self.osd_method == "combination_sweep":
            out, _ = gf2_osd_cs_host(self._Hcols, self.m, self.osd_order,
                                     order, bp_np.astype(np.uint8),
                                     syn_np.astype(np.uint8),
                                     lam3=self.osd_triples)
        else:
            out, _ = gf2_osd0_host(self._Hcols, self.m, order,
                                   bp_np.astype(np.uint8),
                                   syn_np.astype(np.uint8))
        return out.astype(np.int8)

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        syn = jnp.asarray(syndromes)
        ratio = None
        if per is not None:
            ratio = self._prior_fn(per)
        if self.fused:
            errs, converged, iters, logp = self._fused_fn(syn, ratio)
            return errs, converged, iters, {"log_probabs": logp}
        bp_err, converged, iters, logp = self._bp_fn(syn, ratio)

        # host impl dispatches BEFORE the device OSD-w branch: the whole
        # point of osd_impl='host' (+ combination_sweep at order > 0) is
        # detector models too wide for the device elimination
        if self.osd_order > 0 and self.osd_scope == "all" \
                and self.osd_impl != "host":
            corr = self._osdw_batch(syn, bp_err, logp)
            return corr.astype(jnp.int8), converged, iters, {"log_probabs": logp}

        # OSD-0 (and OSD-w under osd_scope="failed"): only lanes whose BP
        # output misses the syndrome need work.
        # BP's converged flag IS that test (its loop exits a lane exactly
        # when (H @ err) % 2 == syndrome), so no residual recompute needed.
        need = np.flatnonzero(~np.asarray(converged))
        if self.osd_impl == "host":
            if self.osd_scope == "all":
                need = np.arange(syn.shape[0])
            if need.size == 0:
                return bp_err, converged, iters, {"log_probabs": logp}
            out = np.asarray(bp_err).copy()
            out[need] = self._host_osd0(
                np.asarray(syn)[need], out[need], np.asarray(logp)[need])
            return out, converged, iters, {"log_probabs": logp}
        if need.size == 0:
            return bp_err, converged, iters, {"log_probabs": logp}

        bucket = next_pow2(need.size)
        idx = np.concatenate([need, np.repeat(need[:1], bucket - need.size)])
        post = self._osd0_batch if self.osd_order == 0 else self._osdw_batch
        corr_sub = post(syn[idx], bp_err[idx], logp[idx])
        out = np.asarray(bp_err).copy()
        out[need] = np.asarray(corr_sub[: need.size]).astype(np.int8)
        return out, converged, iters, {"log_probabs": logp}
