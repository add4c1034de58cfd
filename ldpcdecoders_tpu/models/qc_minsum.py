"""Quasi-cyclic / group-circulant min-sum decoder.

``QCMinSumDecoder`` decodes codes with circulant block structure through
the generic edge-list decoders (models/minsum.py, models/layered.py,
models/bp.py) on the lifted Tanner graph.  What it adds is the
construction from circulant data:

  * ``QCMinSumDecoder(base, Z, ...)`` — 1-D quasi-cyclic base matrix
    (codes/qc.py); the lifted graph orders each check's neighbors by
    ascending variable index, matching the generic decoder's slot order.
  * ``QCMinSumDecoder.from_group_terms(terms, mb, nb, group, ...)`` —
    2-D group-circulant edge terms over ``Z_l x Z_m``
    (codes/qc.py::qc_group_lift_edges).
  * ``QCMinSumDecoder.for_bicycle(code, block, ...)`` — one stabilizer
    block (Hx or Hz) of a bivariate bicycle quantum code
    (codes/bicycle.py); transposed blocks use inverse monomials.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.graph import TannerGraph
from ..codes.qc import qc_group_lift_edges, qc_lift_edges
from .base import Decoder
from .minsum import make_minsum_decode_fn
from .priors import per_to_llr

__all__ = ["QCMinSumDecoder"]


class QCMinSumDecoder(Decoder):
    """Normalized/offset min-sum decoder for group-circulant LDPC codes.

    Args:
      base: ``[mb, nb]`` QC base matrix (-1 = zero block, else circulant
        shift in ``[0, Z)``); see codes/qc.py.
      Z: lift (circulant) size.
      per: physical error rate (sets the scalar channel LLR).
      max_iters: maximum BP iterations (full sweeps for 'layered').
      alpha, beta: min-sum normalization / offset.  alpha=None resolves
        to the schedule default: 1.0 flooding, 0.8 layered (the layered
        schedule amplifies min-sum's magnitude overestimate — see
        models/layered.py for the measurement).
      schedule: 'flooding' (default) or 'layered' (a greedy
        conflict-free partition of the lifted graph's checks,
        models/layered.py; min-sum only).
      algorithm: 'minsum' (default) or 'sumproduct' (flooding only).
      dtype: message precision — jnp.float32 (default) or jnp.bfloat16.

    Example:

    >>> import numpy as np
    >>> from ldpcdecoders_tpu import QCMinSumDecoder, random_qc_base_matrix
    >>> base = random_qc_base_matrix(8, 4, 2, 16, rng=0)
    >>> dec = QCMinSumDecoder(base, 16, 0.05, 20)
    >>> syn = np.zeros(dec.m, np.int8)
    >>> err, converged = dec.decode(syn)
    >>> int(err.sum()), converged
    (0, True)
    """

    def __init__(
        self,
        base,
        Z: int,
        per: float,
        max_iters: int,
        *,
        alpha: float | None = None,
        beta: float = 0.0,
        schedule: str = "flooding",
        algorithm: str = "minsum",
        dtype=jnp.float32,
    ):
        base = np.asarray(base, dtype=np.int64)
        rows, cols, m, n = qc_lift_edges(base, Z)
        mb, nb = base.shape
        bi, bj = np.nonzero(base >= 0)
        terms = [(int(i), int(j), int(base[i, j]), 0) for i, j in zip(bi, bj)]
        self.base = base
        self._setup(
            terms, mb, nb, (int(Z), 1), rows, cols, per, max_iters,
            alpha=alpha, beta=beta, schedule=schedule,
            algorithm=algorithm, dtype=dtype,
        )

    @classmethod
    def from_group_terms(
        cls,
        terms,
        mb: int,
        nb: int,
        group: tuple[int, int],
        per: float,
        max_iters: int,
        *,
        alpha: float | None = None,
        beta: float = 0.0,
        schedule: str = "flooding",
        algorithm: str = "minsum",
        dtype=jnp.float32,
    ) -> "QCMinSumDecoder":
        """Build from 2-D group-circulant edge terms over ``Z_l x Z_m``.

        ``terms`` is a list of ``(i, j, a, b)``: the monomial ``x^a y^b``
        in block ``(i, j)`` (multiple terms per block allowed).  See
        codes/qc.py::qc_group_lift_edges for the lifting convention.
        """
        gl, gm = (int(x) for x in group)
        terms = [tuple(int(x) for x in t) for t in terms]
        rows, cols, m, n = qc_group_lift_edges(terms, mb, nb, gl, gm)
        self = cls.__new__(cls)
        self.base = None
        self._setup(
            terms, int(mb), int(nb), (gl, gm), rows, cols, per, max_iters,
            alpha=alpha, beta=beta, schedule=schedule,
            algorithm=algorithm, dtype=dtype,
        )
        return self

    @classmethod
    def for_bicycle(cls, code, block: str, per: float, max_iters: int, **kwargs) -> "QCMinSumDecoder":
        """Decoder for one stabilizer block of a bivariate bicycle code.

        Args:
          code: a registry name ("bb144", ...) or ``(l, m, a_terms,
            b_terms)`` tuple (codes/bicycle.py conventions).
          block: 'x' for ``Hx = [A | B]`` or 'z' for ``Hz = [B^T | A^T]``
            (transposed monomial blocks become inverse monomials).
          **kwargs: forwarded to :meth:`from_group_terms`.

        Example:

        >>> from ldpcdecoders_tpu import QCMinSumDecoder
        >>> dec = QCMinSumDecoder.for_bicycle("bb72", "x", 0.01, 30)
        >>> dec.m, dec.n
        (36, 72)
        """
        if isinstance(code, str):
            from ..codes.bicycle import BICYCLE_CODES

            if code not in BICYCLE_CODES:
                raise ValueError(
                    f"unknown BB code '{code}' (choose from {sorted(BICYCLE_CODES)})"
                )
            info = BICYCLE_CODES[code]
            l, m, a_terms, b_terms = info["l"], info["m"], info["a_terms"], info["b_terms"]
        else:
            l, m, a_terms, b_terms = code
        l, m = int(l), int(m)

        def fwd(ts):
            return [(int(a) % l, int(b) % m) for a, b in ts]

        def inv(ts):
            return [((l - int(a)) % l, (m - int(b)) % m) for a, b in ts]

        if block == "x":  # Hx = [A | B]
            blocks = (fwd(a_terms), fwd(b_terms))
        elif block == "z":  # Hz = [B^T | A^T]; transpose of x^a y^b is its inverse
            blocks = (inv(b_terms), inv(a_terms))
        else:
            raise ValueError(f"block must be 'x' or 'z', got {block!r}")
        terms = [(0, j, a, b) for j, ts in enumerate(blocks) for a, b in ts]
        return cls.from_group_terms(terms, 1, 2, (l, m), per, max_iters, **kwargs)

    def _setup(
        self, terms, mb, nb, group, rows, cols, per, max_iters,
        *, alpha, beta, schedule, algorithm, dtype,
    ):
        gl, gm = group
        Z = gl * gm
        m, n = mb * Z, nb * Z
        H = None
        if m * n <= 4_000_000:  # attach dense H only at debug-tool sizes
            H = np.zeros((m, n), np.uint8)
            H[rows, cols] = 1
        self.graph = TannerGraph.from_edges(rows, cols, m, n, H=H)
        self.terms = terms
        self.group = (gl, gm)
        self.Z = Z
        self.m, self.n = m, n
        self.per = float(per)
        self.max_iters = int(max_iters)
        if schedule not in ("flooding", "layered"):
            raise ValueError(
                f"unknown schedule {schedule!r} (want 'flooding' or 'layered')"
            )
        self.schedule = schedule
        if algorithm not in ("minsum", "sumproduct"):
            raise ValueError(
                f"unknown algorithm {algorithm!r} (want 'minsum' or 'sumproduct')"
            )
        self.algorithm = algorithm
        self.alpha = float(alpha) if alpha is not None else (
            0.8 if schedule == "layered" and algorithm == "minsum" else 1.0
        )
        self.beta = float(beta)
        if jnp.dtype(dtype) not in (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16)):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = jnp.dtype(dtype).type  # scalar type: callable like jnp.float32
        if algorithm == "sumproduct":
            if schedule == "layered":
                raise ValueError(
                    "layered sum-product is not implemented (the layered "
                    "schedule is min-sum only)"
                )
            from .bp import make_bp_decode_fn

            fn = make_bp_decode_fn(self.graph, self.per, self.max_iters)
        elif schedule == "layered":
            from .layered import make_layered_minsum_fn

            fn = make_layered_minsum_fn(
                self.graph, self.per, self.max_iters,
                alpha=self.alpha, beta=self.beta, dtype=self.dtype,
            )
        else:
            fn = make_minsum_decode_fn(
                self.graph, self.per, self.max_iters,
                alpha=self.alpha, beta=self.beta, dtype=self.dtype,
            )
        self._decode_fn = jax.jit(fn)

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        arg = None
        if per is not None:
            if self.algorithm == "sumproduct":
                # bp decode takes the channel probability ratio p/(1-p);
                # per_to_ratio handles scalar/[n]/[B, n] uniformly
                from .priors import per_to_ratio

                arg = jnp.asarray(per_to_ratio(per, self.n), jnp.float32)
            else:
                arg = jnp.asarray(per_to_llr(per, self.n), jnp.float32)
        err, converged, iters, soft = self._decode_fn(jnp.asarray(syndromes), arg)
        key = "log_probabs" if self.algorithm == "sumproduct" else "llrs"
        return err, converged, iters, {key: soft}
