"""Decoder base class: the public API surface of the framework.

Mirrors the reference's compatibility contract (SURVEY.md §2.6,
/root/reference/src/decoders/abstract_decoder.jl) with one deliberate
re-design: decoding is *batch-first*.  The reference's ``batchdecode!`` is a
sequential loop over syndrome columns
(/root/reference/src/decoders/abstract_decoder.jl:35-39); here a batch is a
leading array axis decoded in lock-step by one jitted XLA program, and the
single-syndrome ``decode`` is the batch-of-one special case.

All decoders return a uniform int8 error estimate (the reference returns a
different dtype per decoder — Float64/Bool/Int64 — which SURVEY.md §2.6
flags as a quirk, not a feature).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..cache import ensure_default_cache

__all__ = ["Decoder", "DecodeStats", "decode", "batchdecode"]


@dataclasses.dataclass(frozen=True)
class DecodeStats:
    """Structured per-batch observability (SURVEY.md §5 'metrics' plan)."""

    batch_size: int
    converged_fraction: float
    mean_iters: float
    max_iters_used: int

    @staticmethod
    def from_arrays(converged: np.ndarray, iters: np.ndarray) -> "DecodeStats":
        return DecodeStats(
            batch_size=int(converged.shape[0]),
            converged_fraction=float(np.mean(converged)),
            mean_iters=float(np.mean(iters)),
            max_iters_used=int(np.max(iters)) if iters.size else 0,
        )


class Decoder:
    """Abstract batched syndrome decoder.

    Concrete decoders implement ``_decode_batch(syndromes, seed) ->
    (errors, converged, iters, aux)`` over device arrays; this base class
    provides the host-facing ``decode`` / ``batch_decode`` API.
    """

    #: number of parity checks (rows of H)
    m: int
    #: number of variable nodes (columns of H)
    n: int
    #: whether converged=True guarantees the estimate reproduces the
    #: syndrome (True for all decoders except bit-flip, whose reference
    #: semantics also report convergence when no flip is worthwhile)
    converged_implies_syndrome_match: bool = True
    #: whether batch_decode(per=...) can override the channel prior
    #: without recompiling (False: bit-flip)
    supports_per_override: bool = True
    #: whether a per-bit [n] prior vector is accepted (False: bit-flip,
    #: int8-quantized)
    supports_vector_prior: bool = True

    def _decode_batch(self, syndromes, seed: int):
        raise NotImplementedError

    def _call_decode(self, syndromes, seed, per):
        # first-use hook: enable the persistent XLA compile cache;
        # idempotent bool-guarded no-op after the first call
        ensure_default_cache()
        if per is None:
            return self._decode_batch(syndromes, seed)
        if np.ndim(per) == 2 and np.shape(per)[0] != np.shape(syndromes)[0]:
            raise ValueError(
                f"per-lane prior batch ({np.shape(per)[0]}) must match the "
                f"syndrome batch ({np.shape(syndromes)[0]})"
            )
        if not self.supports_per_override:
            raise ValueError(
                f"{type(self).__name__} does not support per-call channel "
                "prior overrides"
            )
        return self._decode_batch(syndromes, seed, per=per)

    # -- public API -------------------------------------------------------

    def decode(self, syndrome, *, seed: int = 0, per=None):
        """Decode one syndrome; returns ``(error[n] int8, converged bool)``."""
        syndrome = np.asarray(syndrome)
        errors, converged = self.batch_decode(syndrome[None, :], seed=seed, per=per)
        return errors[0], bool(converged[0])

    def batch_decode(self, syndromes, *, seed: int = 0, per=None):
        """Decode a batch; ``syndromes`` is ``[B, m]`` (batch-first).

        ``per`` optionally overrides the constructor's physical error rate
        *without recompiling* (the channel prior is a traced argument) —
        FER sweeps reuse one compiled program across noise points.

        Returns ``(errors [B, n] int8, converged [B] bool)``.
        """
        syndromes = np.asarray(syndromes)
        if syndromes.ndim != 2 or syndromes.shape[1] != self.m:
            raise ValueError(
                f"expected syndromes of shape [B, {self.m}], got {syndromes.shape}"
            )
        errors, converged, _, _ = self._call_decode(syndromes, seed, per)
        return np.asarray(errors), np.asarray(converged)

    def batch_decode_async(self, syndromes, *, seed: int = 0, per=None):
        """Dispatch a batch decode WITHOUT host synchronization.

        Returns ``(errors, converged)`` as device arrays immediately;
        reading them (``np.asarray``/item access) blocks.  Queue several
        batches before reading to overlap dispatch latency with device
        compute (bench.py's 'pipelined' metric).  Decoders with host-side
        orchestration (OSD-0's failing-lane compaction, BucketedDecoder
        chunking) synchronize internally and gain nothing.
        """
        if not hasattr(syndromes, "ndim"):
            # lists/tuples are accepted like batch_decode; device arrays are
            # deliberately NOT np.asarray'd — that would block on transfer
            syndromes = np.asarray(syndromes)
        if syndromes.ndim != 2 or syndromes.shape[1] != self.m:
            raise ValueError(
                f"expected syndromes of shape [B, {self.m}], got {syndromes.shape}"
            )
        errors, converged, _, _ = self._call_decode(syndromes, seed, per)
        return errors, converged

    def batch_decode_detailed_async(self, syndromes, *, seed: int = 0, per=None):
        """Dispatch a detailed batch decode WITHOUT host synchronization.

        Returns ``(errors, converged, iters, aux)`` as device arrays
        immediately (reading them blocks) — the async analog of
        :meth:`batch_decode_detailed`, used by the FER sweep harness to
        overlap host-side noise sampling and verification of one batch
        with the device decode of the next.  Argument validation errors
        (shape, unsupported ``per`` override) still raise eagerly.
        """
        if not hasattr(syndromes, "ndim"):
            syndromes = np.asarray(syndromes)
        if syndromes.ndim != 2 or syndromes.shape[1] != self.m:
            raise ValueError(
                f"expected syndromes of shape [B, {self.m}], got {syndromes.shape}"
            )
        return self._call_decode(syndromes, seed, per)

    def batch_decode_detailed(self, syndromes, *, seed: int = 0, per=None):
        """Like :meth:`batch_decode` but also returns iteration counts,
        decoder-specific auxiliary output, and :class:`DecodeStats`."""
        syndromes = np.asarray(syndromes)
        errors, converged, iters, aux = self._call_decode(syndromes, seed, per)
        errors = np.asarray(errors)
        converged = np.asarray(converged)
        iters = np.asarray(iters)
        return errors, converged, iters, aux, DecodeStats.from_arrays(converged, iters)


def decode(decoder: Decoder, syndrome, **kw):
    """Free-function form of ``decoder.decode`` (reference ``decode!``)."""
    return decoder.decode(syndrome, **kw)


def batchdecode(decoder: Decoder, syndromes, **kw):
    """Free-function form of ``decoder.batch_decode`` (reference
    ``batchdecode!``), batch-first."""
    return decoder.batch_decode(syndromes, **kw)


def decode_soft(decoder: Decoder, llrs, *, seed: int = 0):
    """Codeword-domain soft-input decoding from received channel LLRs.

    The classical-FEC entry point (BPSK/AWGN etc.): given per-bit
    received LLRs ``[B, n]`` (positive = bit 0 more likely), take the
    hard decision, decode its syndrome with **per-lane priors** derived
    from the LLR magnitudes (``p_wrong = 1/(1+e^{|llr|})``), and flip
    the estimated error pattern back out.  Requires a decoder that
    accepts ``[B, n]`` priors (BP / min-sum / layered min-sum).

    The reference is syndrome-only; this wrapper adds the received-word
    use-case on top of the same machinery.

    Returns ``(codeword [B, n] int8, converged [B] bool)``.
    """
    from ..ops.syndrome import make_syndrome_fn

    llrs = np.asarray(llrs, dtype=np.float64)
    if llrs.ndim != 2 or llrs.shape[1] != decoder.n:
        raise ValueError(f"expected llrs of shape [B, {decoder.n}], got {llrs.shape}")
    hard = (llrs < 0).astype(np.int8)
    syn_fn = getattr(decoder, "_soft_syndrome_fn", None)
    if syn_fn is None:  # build once; re-used across streaming calls
        syn_fn = make_syndrome_fn(decoder.graph)
        decoder._soft_syndrome_fn = syn_fn
    syn = np.asarray(syn_fn(hard.astype(np.float32))).astype(np.int8)
    # probability the hard decision is wrong; floor away from 0 so the
    # prior stays finite for saturated LLRs
    p_wrong = np.clip(1.0 / (1.0 + np.exp(np.abs(llrs))), 1e-12, 0.5)
    err, converged = decoder.batch_decode(syn, seed=seed, per=p_wrong)
    return (hard ^ err.astype(np.int8)).astype(np.int8), converged
