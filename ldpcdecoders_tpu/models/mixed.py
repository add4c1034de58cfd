"""Combined erasure + bit-flip channel decoder (peel, then prior-BP).

The two canonical LDPC channels compose in real hardware: a fraction of
bits arrive *erased* (known location, unknown value — photon loss,
atom loss, heralded leakage) while the rest see ordinary bit-flips.
The reference package handles only the flip channel; this decoder is an
addition layered on two pieces that already exist here:

1. **Parallel leaf peeling** (models/peeling.py): on lanes whose
   syndrome is explained entirely inside the erasure, peeling resolves
   every erased bit in O(peeling-depth) fixed-shape rounds — typically
   5-15 rounds of one O(edges) pass each, far cheaper than a full BP
   run.  In the erasure-dominated regime (p_flip << p_erase) most
   lanes finish here.
2. **Per-lane channel priors** (models/priors.py, [B, n] ``per``):
   lanes peeling cannot finish (a stopping set, or nonzero residual
   syndrome from real flips) fall through to belief propagation with
   the mixed prior — erased bits carry no channel information
   (p = 0.5: LLR 0 / probability-ratio 1), non-erased bits carry the
   flip prior.  On the binary erasure channel BP with LLR-0 priors
   *is* peeling, so the fallback strictly generalizes stage 1; it just
   costs full BP iterations.

The BP stage is gated behind ``lax.cond`` exactly like the fused
BP+OSD path: a batch whose every lane peels clean never pays for BP,
and there is no device->host sync between the stages — the whole
decode is one XLA program.

No reference analog (the reference decodes flip channels only); the
per-stage semantics are validated against exhaustive-ML and
erasure-free BP oracles in tests/test_mixed_channel.py.

API note: like ``ErasurePeelingDecoder``, decoding needs the erasure
mask alongside the syndrome, so this class does not subclass
``Decoder`` — ``batch_decode(syndromes, erasures)``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.graph import TannerGraph
from ..ops.syndrome import make_syndrome_fn
from .bp import make_bp_decode_fn
from .minsum import make_minsum_decode_fn
from .peeling import make_peel_fn
from .priors import validate_per

__all__ = ["MixedChannelDecoder", "make_mixed_decode_fn"]

_ALGORITHMS = ("minsum", "sumproduct")
_STRATEGIES = ("peel+bp", "bp")


def make_mixed_decode_fn(
    graph: TannerGraph,
    p_flip: float,
    max_iters: int,
    *,
    algorithm: str = "minsum",
    strategy: str = "peel+bp",
    alpha: float = 1.0,
    beta: float = 0.0,
    dtype=jnp.float32,
    max_rounds: int | None = None,
    osd_order: int | None = None,
):
    """Build ``(syndromes [B, m], erasures [B, n], prior [B, n]) ->
    (err i8, ok, peel_rounds, bp_iters)``.

    ``prior`` is in the BP algorithm's native domain (LLR for min-sum,
    probability ratio for sum-product) with erased positions already
    neutralized; the ``MixedChannelDecoder`` wrapper computes it from
    flip probabilities.  ``peel_rounds`` is 0 under ``strategy='bp'``;
    ``bp_iters`` is 0 for a batch that peeled clean.

    With ``osd_order`` set (needs a dense H), lanes BP cannot close get
    the OSD completion on BP's final soft output — cond-gated, so it
    costs nothing while every lane converges.  In the no-flip limit
    this recovers exact stopping-set completion (any syndrome-consistent
    assignment inside the erasure is ML on the erasure channel).
    """
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"algorithm must be one of {_ALGORITHMS}, got {algorithm!r}")
    if strategy not in _STRATEGIES:
        raise ValueError(f"strategy must be one of {_STRATEGIES}, got {strategy!r}")
    n = graph.n
    if algorithm == "minsum":
        bp_decode = make_minsum_decode_fn(
            graph, p_flip, max_iters, alpha=alpha, beta=beta, dtype=dtype
        )
    else:
        bp_decode = make_bp_decode_fn(graph, p_flip, max_iters, dtype=dtype)
    peel = make_peel_fn(graph, max_rounds) if strategy == "peel+bp" else None
    osd_post = None
    if osd_order is not None:
        from .bposd import make_osd_fns

        osd0_batch, osdw_batch = make_osd_fns(graph, int(osd_order))
        osd_post = osd0_batch if int(osd_order) == 0 else osdw_batch
        syndrome_from = make_syndrome_fn(graph)

    @functools.partial(jax.jit)
    def decode(syndromes, erasures, prior):
        syndromes = jnp.asarray(syndromes)
        erasures = jnp.asarray(erasures).astype(bool)
        B = syndromes.shape[0]
        prior = jnp.broadcast_to(jnp.asarray(prior, dtype), (B, n))

        def run_bp():
            err_b, ok_b, iters, soft = bp_decode(syndromes, prior)
            err_b = err_b.astype(jnp.int8)
            if osd_post is not None:
                # min-sum soft output is the LLR log(p0/p1); sum-product's
                # is log(1/total) with total the posterior ratio p1/p0 —
                # the same quantity, so one OSD reliability sort serves both
                def with_osd():
                    corr = osd_post(
                        syndromes, err_b, soft.astype(jnp.float32)
                    ).astype(jnp.int8)
                    merged = jnp.where(ok_b[:, None], err_b, corr)
                    okn = jnp.all(
                        syndrome_from(merged.astype(jnp.float32))
                        == syndromes.astype(jnp.float32),
                        axis=1,
                    )
                    return merged, okn

                err_b, ok_b = jax.lax.cond(
                    jnp.all(ok_b), lambda: (err_b, ok_b), with_osd
                )
            return err_b, ok_b, jnp.max(iters)

        if strategy == "bp":
            err, ok, it = run_bp()
            return err, ok, jnp.zeros(B, jnp.int32), it

        err_p, eps_left, s_res, depth = peel(syndromes, erasures)
        # a lane is done iff peeling consumed its whole erasure AND the
        # residual syndrome closed — any real flip leaves s_res != 0
        ok_p = (~jnp.any(eps_left, axis=1)) & jnp.all(s_res == 0, axis=1)

        err_b, ok_b, bp_iters = jax.lax.cond(
            jnp.all(ok_p),
            lambda: (
                jnp.zeros((B, n), jnp.int8),
                jnp.zeros(B, bool),
                jnp.int32(0),
            ),
            run_bp,
        )
        err = jnp.where(ok_p[:, None], err_p.astype(jnp.int8), err_b)
        ok = ok_p | ok_b
        return err, ok, depth, bp_iters

    return decode


class MixedChannelDecoder:
    """Decoder for the mixed erasure + bit-flip channel.

    Peels erasures first (cheap: O(peeling-depth) parallel rounds),
    then runs belief propagation with per-lane mixed priors on any lane
    the peeling could not finish — all inside one compiled program with
    the BP stage ``lax.cond``-gated, so erasure-only batches never pay
    for BP.

    Args:
      H: parity-check matrix (dense 0/1, scipy.sparse, or
        ``TannerGraph`` — dense-free ``from_edges`` graphs work).
      p_flip: bit-flip probability of non-erased bits (scalar or [n]).
      max_iters: BP iteration cap for the fallback stage.
      algorithm: ``'minsum'`` (default; ``alpha``/``beta``/``dtype``
        apply) or ``'sumproduct'``.
      strategy: ``'peel+bp'`` (default) or ``'bp'`` (prior-BP only,
        the baseline the peel stage accelerates).
      max_rounds: cap on peeling rounds (default n).
      osd_order: if set (needs a dense H), OSD-completes lanes BP
        cannot close (cond-gated; 0 = OSD-0).  Guarantees syndrome-
        consistent output whenever the system is solvable — in the
        no-flip limit this matches ``ErasurePeelingDecoder``'s exact
        GF(2) stopping-set completion.

    Example:

    >>> import numpy as np
    >>> from ldpcdecoders_tpu import MixedChannelDecoder, parity_check_matrix
    >>> H = parity_check_matrix(240, 6, 3, rng=0)
    >>> dec = MixedChannelDecoder(H, 0.01, 60)
    >>> rng = np.random.default_rng(1)
    >>> eps = rng.random(240) < 0.10          # erased positions
    >>> e = np.where(eps, rng.random(240) < 0.5, rng.random(240) < 0.01)
    >>> syn = (H @ e) % 2
    >>> err, ok = dec.decode(syn, eps)
    >>> bool(ok)
    True
    """

    def __init__(
        self,
        H,
        p_flip: float,
        max_iters: int,
        *,
        algorithm: str = "minsum",
        strategy: str = "peel+bp",
        alpha: float = 1.0,
        beta: float = 0.0,
        dtype=jnp.float32,
        max_rounds: int | None = None,
        osd_order: int | None = None,
    ):
        if isinstance(H, TannerGraph):
            self.graph = H
        elif hasattr(H, "tocoo"):
            coo = H.tocoo()
            self.graph = TannerGraph.from_edges(coo.row, coo.col, *H.shape)
        else:
            self.graph = TannerGraph.from_pcm(np.asarray(H))
        self.m, self.n = self.graph.m, self.graph.n
        self.p_flip = p_flip if np.ndim(p_flip) else float(p_flip)
        self.max_iters = int(max_iters)
        self.algorithm = algorithm
        self.strategy = strategy
        self.osd_order = osd_order
        self._decode_fn = make_mixed_decode_fn(
            self.graph, self.p_flip, self.max_iters,
            algorithm=algorithm, strategy=strategy,
            alpha=alpha, beta=beta, dtype=dtype, max_rounds=max_rounds,
            osd_order=osd_order,
        )

    def _native_prior(self, erasures: np.ndarray, per) -> np.ndarray:
        """Flip probabilities -> per-lane prior in the BP-native domain,
        with erased positions neutralized (LLR 0 / ratio 1)."""
        p = validate_per(self.p_flip if per is None else per, self.n)
        p = np.broadcast_to(p, erasures.shape).astype(np.float64)
        if self.algorithm == "minsum":
            native = np.where(erasures, 0.0, np.log((1.0 - p) / p))
        else:
            native = np.where(erasures, 1.0, p / (1.0 - p))
        return native.astype(np.float32)  # decode() casts to the BP dtype

    def batch_decode(self, syndromes, erasures, *, per=None):
        """Decode ``[B, m]`` syndromes with ``[B, n]`` erasure masks.

        ``per`` optionally overrides the flip probability per call
        (scalar, [n], or [B, n]) — one compiled program serves every
        noise point of a sweep.  Returns ``(errors [B, n] int8,
        ok [B] bool)``.
        """
        err, ok, _, _ = self.batch_decode_detailed(syndromes, erasures, per=per)
        return err, ok

    def batch_decode_detailed(self, syndromes, erasures, *, per=None):
        """Like ``batch_decode`` plus ``(peel_rounds [B], bp_iters)``."""
        syndromes = np.asarray(syndromes)
        erasures = np.asarray(erasures)
        if syndromes.ndim != 2 or syndromes.shape[1] != self.m:
            raise ValueError(
                f"expected syndromes of shape [B, {self.m}], got {syndromes.shape}"
            )
        if erasures.shape != (syndromes.shape[0], self.n):
            raise ValueError(
                f"expected erasures of shape [B={syndromes.shape[0]}, {self.n}], "
                f"got {erasures.shape}"
            )
        prior = self._native_prior(erasures.astype(bool), per)
        err, ok, rounds, bp_iters = self._decode_fn(syndromes, erasures, prior)
        return np.asarray(err), np.asarray(ok), np.asarray(rounds), int(bp_iters)

    def decode(self, syndrome, erasure, *, per=None):
        """Single-syndrome convenience; returns ``(error [n] int8, ok)``."""
        err, ok = self.batch_decode(
            np.asarray(syndrome)[None], np.asarray(erasure)[None], per=per
        )
        return err[0], bool(ok[0])
