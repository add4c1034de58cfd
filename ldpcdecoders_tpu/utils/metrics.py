"""Decoding-quality metrics matching the reference test oracles.

The reference measures (a) exact-recovery logical error rate
(test_bp_decoder.jl:19-43) and (b) syndrome-match rate
(test_bpots.jl:41-55).  Both are first-class here, plus converged-fraction
and Wilson confidence intervals for FER sweeps.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "exact_recovery_ler",
    "syndrome_match_rate",
    "wilson_interval",
    "gf2_rowspan_reducer",
    "gf2_kernel_basis",
    "css_logical_operators",
    "logical_failure_rate",
]


def exact_recovery_ler(guesses: np.ndarray, true_errors: np.ndarray) -> float:
    """Fraction of lanes whose estimate differs from the injected error."""
    exact = (np.asarray(guesses).astype(bool) == np.asarray(true_errors).astype(bool)).all(axis=1)
    return float(1.0 - exact.mean())


def syndrome_match_rate(H: np.ndarray, guesses: np.ndarray, syndromes: np.ndarray) -> float:
    """Fraction of lanes whose estimate reproduces its input syndrome."""
    synhat = (np.asarray(guesses).astype(np.int64) @ np.asarray(H).astype(np.int64).T) % 2
    return float((synhat == np.asarray(syndromes)).all(axis=1).mean())


def gf2_rowspan_reducer(H):
    """Build a ``vectors [B, n] -> in_span [B] bool`` membership test for
    the GF(2) row span of ``H`` (host-side, bit-packed RREF).

    The quantum use: for a CSS code, a decoding residual
    ``r = e_true XOR e_hat`` with ``H_check @ r == 0`` is a *harmless
    stabilizer* exactly when ``r`` lies in the row span of the opposite
    block's parity-check matrix — exact-recovery LER over-counts
    failures on degenerate codes.  Accepts dense arrays or scipy.sparse.
    """
    if hasattr(H, "toarray"):
        H = H.toarray()
    H = (np.asarray(H) != 0).astype(np.uint8)
    m, n = H.shape
    W = (n + 63) // 64
    pad = W * 64 - n

    def pack(M):
        bits = np.pad(M, [(0, 0), (0, pad)]).reshape(len(M), W, 64).astype(np.uint64)
        return (bits << np.arange(64, dtype=np.uint64)).sum(axis=2, dtype=np.uint64)

    rows = pack(H)
    # row-echelon basis: one row per pivot column; eliminating the pivot
    # from every row (including the donor) leaves the remaining rows free
    # of all previous pivots
    basis, pivots = [], []
    for j in range(n):
        w, b = divmod(j, 64)
        hit = ((rows[:, w] >> np.uint64(b)) & np.uint64(1)).astype(bool)
        idx = np.flatnonzero(hit)
        if idx.size == 0:
            continue
        cand = rows[idx[0]].copy()
        rows[hit] ^= cand
        basis.append(cand)
        pivots.append(j)
        if len(basis) == m:
            break
    basis = np.array(basis, dtype=np.uint64) if basis else np.zeros((0, W), np.uint64)
    pivots = np.asarray(pivots, dtype=np.int64)

    def in_span(vectors) -> np.ndarray:
        V = (np.asarray(vectors) != 0).astype(np.uint8)
        if V.ndim == 1:
            V = V[None, :]
        X = pack(V)
        for k in range(len(basis)):
            w, b = divmod(int(pivots[k]), 64)
            hit = ((X[:, w] >> np.uint64(b)) & np.uint64(1)).astype(bool)
            X[hit] ^= basis[k]
        return ~np.any(X, axis=1)

    return in_span


def gf2_kernel_basis(H) -> np.ndarray:
    """Basis of the GF(2) null space of ``H`` as a ``[k, n]`` 0/1 array.

    For a CSS block this is the space of undetectable errors; quotienting
    by the opposite block's row span (see :func:`gf2_rowspan_reducer`)
    yields the logical operators.  Host-side dense RREF — intended for
    small/moderate codes.
    """
    if hasattr(H, "toarray"):
        H = H.toarray()
    A = (np.asarray(H) != 0).astype(np.uint8).copy()
    m, n = A.shape
    pivots = []
    r = 0
    for j in range(n):
        if r == m:
            break
        rows_with = np.flatnonzero(A[r:, j]) + r
        if rows_with.size == 0:
            continue
        k = rows_with[0]
        A[[r, k]] = A[[k, r]]
        elim = np.flatnonzero(A[:, j])
        elim = elim[elim != r]
        A[elim] ^= A[r]
        pivots.append(j)
        r += 1
    free = [j for j in range(n) if j not in set(pivots)]
    basis = np.zeros((len(free), n), np.uint8)
    for i, j in enumerate(free):
        basis[i, j] = 1
        # pivot variable values follow from the RREF rows
        for rr, pj in enumerate(pivots):
            if A[rr, j]:
                basis[i, pj] = 1
    return basis


def css_logical_operators(H_detect, H_stab) -> np.ndarray:
    """Logical-operator representatives turning rowspan membership into
    two small matmuls — the *device-friendly* form of
    :func:`gf2_rowspan_reducer`.

    For a CSS block pair, a residual ``r`` (e.g. a Z-error residual,
    detected by ``H_detect = Hx``) is a harmless stabilizer iff it lies
    in ``rowspan(H_stab = Hz)``.  Because the symplectic pairing between
    logical classes is non-degenerate, that membership is equivalent to::

        H_detect @ r == 0  (mod 2)   and   L @ r == 0  (mod 2)

    where ``L`` — returned here as a ``[k, n]`` 0/1 array — is a basis
    of ``ker(H_stab)`` modulo ``rowspan(H_detect)`` (representatives of
    the *opposite*-type logical operators).  Both products are exact f32
    matmuls on the device, so the evaluation harness verifies degeneracy
    on-device with no host round trip (unlike the bit-packed host RREF
    reducer).  ``k`` equals the code's logical-qubit count.
    """
    if hasattr(H_detect, "toarray"):
        H_detect = H_detect.toarray()
    H_detect = (np.asarray(H_detect) != 0).astype(np.uint8)
    n = H_detect.shape[1]
    W = (n + 63) // 64
    pad = W * 64 - n

    def pack(M):
        M = np.asarray(M, np.uint8)
        bits = np.pad(M, [(0, 0), (0, pad)]).reshape(len(M), W, 64).astype(
            np.uint64)
        return (bits << np.arange(64, dtype=np.uint64)).sum(
            axis=2, dtype=np.uint64)

    # incremental packed RREF basis seeded with rowspan(H_detect); a
    # kernel vector of H_stab that doesn't reduce to zero against it is a
    # new logical representative (and joins the basis so later candidates
    # stay independent of it)
    basis: list[np.ndarray] = []
    pivots: list[int] = []

    def reduce_row(row):
        for b_row, pj in zip(basis, pivots):
            w, bit = divmod(pj, 64)
            if (row[w] >> np.uint64(bit)) & np.uint64(1):
                row = row ^ b_row
        return row

    def add_row(row):
        row = reduce_row(row)
        nz = np.flatnonzero(row)
        if nz.size == 0:
            return False
        w = int(nz[0])
        # pivot = lowest set bit of the first nonzero word
        bit = (int(row[w]) & -int(row[w])).bit_length() - 1
        basis.append(row)
        pivots.append(w * 64 + bit)
        return True

    for r in pack(H_detect):
        add_row(r)

    logicals = []
    for kvec in gf2_kernel_basis(H_stab):
        row = pack(kvec[None])[0]
        if add_row(row):
            logicals.append(kvec)
    return (np.asarray(logicals, np.uint8) if logicals
            else np.zeros((0, n), np.uint8))


def logical_failure_rate(H_stab, true_errors, guesses) -> float:
    """Degeneracy-aware logical error rate for one CSS block.

    A lane fails logically when the residual ``e_true XOR e_hat`` is NOT
    a stabilizer, i.e. not in the row span of ``H_stab`` (the opposite
    basis' parity-check matrix).  Strictly <= the exact-recovery LER.
    """
    residual = np.asarray(true_errors).astype(np.uint8) ^ np.asarray(guesses).astype(
        np.uint8
    )
    return float(1.0 - gf2_rowspan_reducer(H_stab)(residual).mean())


def wilson_interval(failures: int, trials: int, z: float = 1.96) -> tuple[float, float]:
    """Wilson score interval for a failure-rate estimate.

    Example:
      >>> lo, hi = wilson_interval(5, 100)
      >>> bool(lo < 0.05 < hi)
      True
    """
    if trials == 0:
        return (0.0, 1.0)
    p = failures / trials
    denom = 1.0 + z * z / trials
    center = (p + z * z / (2 * trials)) / denom
    half = z * math.sqrt(p * (1 - p) / trials + z * z / (4 * trials * trials)) / denom
    return (max(0.0, center - half), min(1.0, center + half))
