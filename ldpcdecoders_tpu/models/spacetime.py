"""Multi-round decoding under measurement noise (phenomenological model).

The reference's decoders assume each syndrome bit is measured perfectly
(/root/reference/src/decoders/belief_propagation.jl:121-188 takes one
exact ``syndrome``).  :class:`SpaceTimeDecoder` drops that assumption:
it decodes ``R`` consecutive noisy measurement rounds jointly over the
space-time detector graph built by ``codes/spacetime.py`` — one sparse
parity-check matrix whose variables are every round's fresh data errors
and every round's readout errors, so the whole thing runs through the
existing batched decoders (BP, min-sum, BP+OSD, ...) as-is, in one
compiled program per batch of shots.

:class:`SpaceTimeDecoder` is a full :class:`~..models.base.Decoder`:
its "syndrome" is the ``[B, R*m]`` detector record and its error
estimate the ``[B, n]`` cumulative data correction, so the uniform
``decode``/``batchdecode`` free functions, ``DecodeStats``, async
dispatch, and the FER-sweep harness all drive it like any single-shot
decoder (the reference's one-contract ``decode!`` discipline,
/root/reference/src/decoders/abstract_decoder.jl:31-48, carried to the
multi-round setting).

Shape notes: the space-time matrix for ``R`` rounds of an ``[m, n]``
block has ``R*m`` checks and ``R*n + (R-1)*m`` variables — still one
static-shape Tanner graph, so the batch axis stays the only axis XLA
parallelizes over and FER sweeps reuse one executable across noise
points (the prior is a traced argument).  ``_decode_batch`` is
jit-traceable end to end (given a traceable inner decoder, e.g.
``bposd`` with ``fused=True``), which is what lets the evaluation
harness fuse sampling + decoding + verification into one device program.
"""

from __future__ import annotations

import numpy as np

from ..codes.spacetime import detectors_of, spacetime_pcm, spacetime_prior
from ..config import DecoderConfig
from .base import Decoder

__all__ = ["SpaceTimeDecoder"]


def _is_traced(*xs) -> bool:
    import jax

    return any(isinstance(x, jax.core.Tracer) for x in xs)


class SpaceTimeDecoder(Decoder):
    """Joint decoder for ``R`` noisy syndrome-measurement rounds.

    Args:
      H: ``[m, n]`` stabilizer block (dense or scipy.sparse 0/1).
      rounds: number of measurement rounds ``R >= 1``.  The last round
        is assumed noiseless (``perfect_last=True``; the standard closed
        decoding problem — ``rounds=1`` is then exactly single-shot
        decoding on ``H``).
      per: per-round fresh data-error probability (scalar or ``[n]``).
      max_iters: BP iteration cap of the inner decoder.
      meas_error_rate: readout-flip probability per syndrome bit and
        round (scalar or ``[m]``); defaults to ``per`` — the usual
        ``p == q`` phenomenological convention.
      decoder: inner decoder kind (any prior-capable `DecoderConfig`
        kind: bp, bposd, minsum, layered_minsum, bpots, ...).  Default
        "bposd" for syndrome-consistent output.
      perfect_last: see above; ``False`` leaves the final round noisy
        (open boundary for sliding-window use).
      **knobs: extra DecoderConfig fields (osd_order, ...).

    Decoder contract: ``m`` is the *detector record* length ``R *
    block_m`` (what ``batch_decode`` consumes), ``n`` the data block
    size (what it returns); the underlying stabilizer block's shape is
    ``(block_m, block_n)``.  The primary entry points take either the
    raw multi-round syndrome history (``decode_history``) or a
    precomputed detector record (``batch_decode``); both return the
    estimated *cumulative* data error — the correction to apply after
    round ``R``.
    """

    def __init__(self, H, rounds: int, per, max_iters: int, *,
                 meas_error_rate=None, decoder: str = "bposd",
                 perfect_last: bool = True, _inner=None, **knobs):
        import scipy.sparse as sp

        Hs = sp.csr_matrix(H).astype(np.uint8)
        self.block_m, self.block_n = Hs.shape
        self.rounds = int(rounds)
        self.perfect_last = bool(perfect_last)
        q = per if meas_error_rate is None else meas_error_rate
        self._q_default = q  # kept for rounds=1 prior overrides: the
        # perfect-last single-round prior has no measurement columns to
        # slice the default q back out of (see _prior_vec)
        self._prior = spacetime_prior(self.block_n, self.block_m,
                                      self.rounds, per, q,
                                      perfect_last=self.perfect_last)
        self.A = spacetime_pcm(Hs, self.rounds, perfect_last=self.perfect_last)
        self.n_meas_rounds = self.rounds - 1 if self.perfect_last else self.rounds
        # Decoder contract: m = input record length, n = output length
        self.m = self.rounds * self.block_m
        self.n = self.block_n
        self.n_cols = self.A.shape[1]  # inner variable count
        if _inner is not None:
            # pre-built inner on the SAME column layout as self.A —
            # the QC-layered fast path (for_bicycle) injects here
            if (_inner.m, _inner.n) != self.A.shape:
                raise ValueError(
                    f"injected inner is [{_inner.m}, {_inner.n}]; the "
                    f"space-time model is {self.A.shape}")
            self.inner = _inner
        else:
            cfg = DecoderConfig(kind=decoder, per=float(self._prior.mean()),
                                max_iters=max_iters, **knobs)
            # rounds == 1 && perfect_last: A == H exactly — skip the
            # sparse detour so the inner is bit-identical to single-shot
            self.inner = cfg.build(
                Hs if (self.rounds == 1 and self.perfect_last) else self.A)
        if not (self.inner.supports_per_override
                and self.inner.supports_vector_prior):
            raise ValueError(
                f"decoder kind '{decoder}' cannot honor the mixed "
                "data/measurement prior vector; use a prior-capable kind "
                "(bp, bposd, minsum, layered_minsum, bpots)"
            )
        self.converged_implies_syndrome_match = (
            self.inner.converged_implies_syndrome_match)

    @classmethod
    def for_bicycle(cls, code, block: str, rounds: int, per,
                    max_iters: int, *, meas_error_rate=None,
                    schedule: str = "layered",
                    alpha: float | None = None, perfect_last: bool = True,
                    verify_lift: bool = True, **knobs):
        """Space-time decoder for a bivariate-bicycle block with the
        QC decoder as its inner (VERDICT r4 item 5).

        The space-time matrix of a group-circulant code is itself
        group-circulant: row-block ``r`` holds the stabilizer block at
        data round ``r`` and identity monomials at measurement rounds
        ``r-1``/``r`` (benchmarks/results/qc_spacetime_bb144_r4.json
        measured the bb144 R=6 lift hosting EXACTLY, with the layered
        schedule converging 100% of lanes in 60 iterations where
        flooding leaves 0.5% to OSD).  This constructor builds that
        lift as ``QCMinSumDecoder.from_group_terms`` and injects it as
        the inner, with the mixed data/measurement prior
        (``meas_error_rate != per``) carried per column as a vector
        prior.

        Args:
          code: registry name ("bb72", "bb144", ...) or an
            ``(l, m, a_terms, b_terms)`` tuple (codes/bicycle.py).
          block: 'x' (``Hx = [A | B]``) or 'z' (inverse monomials).
          schedule: 'layered' (default — the measured win) or
            'flooding'; alpha/knobs forward to the QC decoder.
          verify_lift: assert the QC lift equals ``spacetime_pcm``
            element-wise before returning (cheap; skip only in tight
            construction loops).
        """
        from ..codes.bicycle import BICYCLE_CODES
        from ..codes.qc import qc_group_lift_edges
        from .qc_minsum import QCMinSumDecoder

        if isinstance(code, str):
            if code not in BICYCLE_CODES:
                raise ValueError(
                    f"unknown BB code '{code}' "
                    f"(choose from {sorted(BICYCLE_CODES)})")
            info = BICYCLE_CODES[code]
            l, m = info["l"], info["m"]
            a_terms, b_terms = info["a_terms"], info["b_terms"]
        else:
            l, m, a_terms, b_terms = code
        l, m = int(l), int(m)

        def fwd(ts):
            return [(int(a) % l, int(b) % m) for a, b in ts]

        def inv(ts):
            return [((l - int(a)) % l, (m - int(b)) % m) for a, b in ts]

        if block == "x":
            blocks = (fwd(a_terms), fwd(b_terms))
        elif block == "z":
            blocks = (inv(b_terms), inv(a_terms))
        else:
            raise ValueError(f"block must be 'x' or 'z', got {block!r}")

        R = int(rounds)
        if R < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        n_meas_rounds = R - 1 if perfect_last else R
        nb = 2 * R + n_meas_rounds
        terms = []
        for r in range(R):
            for j, ts in enumerate(blocks):
                for a, b in ts:
                    terms.append((r, 2 * r + j, a, b))
            if r < n_meas_rounds:  # u_{r+1} flips this round's record
                terms.append((r, 2 * R + r, 0, 0))
            if r >= 1:  # u_r flips it too (XOR-difference detectors)
                terms.append((r, 2 * R + r - 1, 0, 0))

        # the single-round block itself, for the outer wrapper's
        # bookkeeping (A, priors, observables projection)
        r0, c0, mH, nH = qc_group_lift_edges(
            [(0, j, a, b) for j, ts in enumerate(blocks) for a, b in ts],
            1, 2, l, m)
        H = np.zeros((mH, nH), np.uint8)
        H[r0, c0] = 1

        q = per if meas_error_rate is None else meas_error_rate
        from ..codes.spacetime import spacetime_prior

        prior_mean = float(spacetime_prior(
            nH, mH, R, per, q, perfect_last=perfect_last).mean())
        inner = QCMinSumDecoder.from_group_terms(
            terms, R, nb, (l, m), prior_mean, max_iters,
            schedule=schedule, alpha=alpha, **knobs)
        self = cls(H, R, per, max_iters, meas_error_rate=meas_error_rate,
                   perfect_last=perfect_last, _inner=inner)
        if verify_lift:
            import scipy.sparse as sp

            rows, cols, mA, nA = qc_group_lift_edges(terms, R, nb, l, m)
            A_qc = sp.coo_matrix(
                (np.ones(len(rows), np.uint8), (rows, cols)),
                shape=(mA, nA)).tocsr()
            if (A_qc != self.A).nnz != 0:
                raise AssertionError(
                    "QC space-time lift does not match spacetime_pcm — "
                    "term construction bug")
        return self

    def _prior_vec(self, per, q):
        """Full inner prior vector for (possibly overridden) rates.

        Works on concrete values (NumPy, f64 — the golden path) and on
        traced scalars/vectors (jnp, f32 — used when a jitted evaluation
        step passes the noise rate as a traced argument so one compiled
        program serves a whole sweep)."""
        if per is None and q is None:
            return self._prior
        p = self._prior[: self.block_n] if per is None else per
        if q is not None:
            qq = q
        elif self.n_meas_rounds > 0:
            qq = self._prior[self.rounds * self.block_n:
                             self.rounds * self.block_n + self.block_m]
        else:
            # rounds=1 with perfect_last has zero measurement columns, so
            # the stored prior can't be sliced for q — fall back to the
            # constructor's default (it is unused downstream anyway)
            qq = self._q_default
        if _is_traced(p, qq):
            import jax.numpy as jnp

            data = jnp.broadcast_to(jnp.asarray(p, jnp.float32),
                                    (self.block_n,))
            meas = jnp.broadcast_to(jnp.asarray(qq, jnp.float32),
                                    (self.block_m,))
            return jnp.concatenate(
                [jnp.tile(data, self.rounds),
                 jnp.tile(meas, self.n_meas_rounds)])
        return spacetime_prior(self.block_n, self.block_m, self.rounds,
                               p, qq, perfect_last=self.perfect_last)

    # -- Decoder contract ---------------------------------------------------

    def _decode_batch(self, detectors, seed: int = 0, per=None, q=None):
        """Traceable core: detector records ``[B, R*m]`` -> cumulative
        data-error estimate ``[B, n]``.

        ``per`` may be the data-error rate (scalar or ``[block_n]``; the
        measurement rate defaults to the constructor's) or the FULL
        ``[n_cols]`` inner prior vector (advanced use — e.g. the sweep
        harness folding per and q into one traced argument)."""
        import jax.numpy as jnp

        if per is not None and np.ndim(per) >= 1 and (
                np.shape(per)[-1] == self.n_cols != self.block_n):
            prior = per  # full inner prior vector, passed through
        elif per is None and q is None:
            prior = self._prior
        else:
            prior = self._prior_vec(per, q)
        x, conv, iters, aux = self.inner._decode_batch(detectors, seed,
                                                       per=prior)
        if self.rounds == 1 and self.perfect_last:
            data = jnp.asarray(x)[:, None, :]
            meas = jnp.zeros((data.shape[0], 0, self.block_m), jnp.int8)
            cum = jnp.asarray(x).astype(jnp.int8)
        else:
            x = jnp.asarray(x)
            B = x.shape[0]
            data = x[:, : self.rounds * self.block_n].reshape(
                B, self.rounds, self.block_n)
            meas = x[:, self.rounds * self.block_n:].reshape(
                B, self.n_meas_rounds, self.block_m)
            cum = (jnp.sum(data.astype(jnp.int32), axis=1) % 2).astype(jnp.int8)
        return cum, conv, iters, {"data_rounds": data, "meas": meas,
                                  "inner": aux}

    def _call_decode(self, syndromes, seed, per, q=None):
        from ..cache import ensure_default_cache

        ensure_default_cache()
        if per is None and q is None:
            return self._decode_batch(syndromes, seed)
        return self._decode_batch(syndromes, seed, per=per, q=q)

    # -- public API (q-aware wrappers over the Decoder surface) -------------

    def batch_decode(self, detectors, *, seed: int = 0, per=None, q=None):
        """Decode detector records ``[B, R*m]`` (see ``detectors_of``).

        ``per`` / ``q`` optionally override the data / measurement error
        rates (traced — one compiled program serves a whole sweep).

        Returns ``(errors [B, n] int8, converged [B] bool)`` where
        ``errors`` is the estimated cumulative data error after the last
        round (XOR of every round's fresh-error estimate).
        """
        detectors = np.asarray(detectors)
        self._check_shape(detectors)
        err, conv, _, _ = self._call_decode(detectors, seed, per, q)
        return np.asarray(err), np.asarray(conv)

    def batch_decode_detailed(self, detectors, *, seed: int = 0, per=None,
                              q=None):
        """Like :meth:`batch_decode`, also returning iteration counts,
        the per-round split (``aux["data_rounds"]`` ``[B, R, n]``,
        ``aux["meas"]`` ``[B, R_noisy, m]``), and
        :class:`~.base.DecodeStats`."""
        from .base import DecodeStats

        detectors = np.asarray(detectors)
        self._check_shape(detectors)
        err, conv, iters, aux = self._call_decode(detectors, seed, per, q)
        err, conv, iters = np.asarray(err), np.asarray(conv), np.asarray(iters)
        return err, conv, iters, aux, DecodeStats.from_arrays(conv, iters)

    def _check_shape(self, detectors):
        if detectors.ndim != 2 or detectors.shape[1] != self.m:
            raise ValueError(
                f"expected detectors of shape [B, {self.m}] "
                f"(rounds={self.rounds} x m={self.block_m}), "
                f"got {detectors.shape}"
            )

    def decode_history(self, syndromes, *, seed: int = 0, per=None, q=None):
        """Decode raw measured syndrome histories ``[B, R, m]`` (or a
        single ``[R, m]`` shot): forms the XOR-difference detector record
        and calls :meth:`batch_decode`."""
        s = np.asarray(syndromes)
        single = s.ndim == 2
        d = detectors_of(s)
        err, conv = self.batch_decode(d[None] if single else d, seed=seed,
                                      per=per, q=q)
        return (err[0], bool(conv[0])) if single else (err, conv)
