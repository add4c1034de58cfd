"""Error-pattern sampling and syndrome generation.

The reference samples iid bit-flip errors host-side (`rand(n) .< per`,
test_bp_decoder.jl:8) — we provide the same host-side NumPy path plus a
device-side JAX path for generating benchmark workloads without
host->device transfers.
"""

from __future__ import annotations

import weakref

import numpy as np

__all__ = [
    "sample_errors",
    "syndromes_of",
    "syndromes_from_edges",
    "sample_errors_device",
    "sample_mixed_channel",
    "verify_decodes",
]

# id(H) -> (weakref-or-callable, packed rows); evicted when H is collected.
# FER sweeps call syndromes_of thousands of times with the same H object —
# packing it once amortizes to nothing.
_pack_cache: dict = {}


def _packed_of(H: np.ndarray):
    """Cached uint64 bit-packing of a dense 0/1 matrix (native), or None."""
    from ..native import pack_gf2_rows

    key = id(H)
    ent = _pack_cache.get(key)
    if ent is not None and ent[0]() is H:
        return ent[1]
    packed = pack_gf2_rows(H)
    if packed is None:
        return None
    try:
        ref = weakref.ref(H, lambda _: _pack_cache.pop(key, None))
    except TypeError:  # some ndarray subclasses reject weakrefs
        ref = (lambda obj: (lambda: obj))(H)
    _pack_cache[key] = (ref, packed)
    return packed


def sample_errors(rng, batch: int, n: int, per: float) -> np.ndarray:
    """Sample ``[batch, n]`` iid Bernoulli(per) error patterns (host)."""
    if isinstance(rng, (int, np.integer)) or rng is None:
        rng = np.random.default_rng(rng)
    return rng.random((batch, n)) < per


def syndromes_of(H, errors: np.ndarray) -> np.ndarray:
    """``[B, m]`` syndromes of a 0/1 error batch (host, exact GF(2)).

    Accepts dense arrays or scipy.sparse matrices; sparse H is used
    directly (no densification), so million-qubit from_edges-scale codes
    stay within memory.

    Dense H routes through the threaded bit-packed C++ kernel
    (``native/gf2_host.cpp``) when the toolchain is available, else a
    float32 BLAS matmul (exact: per-check overlap counts are far below
    2^24); the int64 path these replace was ~120x slower than the device
    decode it was feeding and host-bound every FER sweep.
    """
    errors = np.asarray(errors)
    if hasattr(H, "tocsr"):
        e = errors.astype(np.int64)
        return np.asarray(e @ H.tocsr().astype(np.int64).T) % 2
    H = np.asarray(H)
    Hp = _packed_of(H)
    if Hp is not None:
        from ..native import gf2_syndromes_packed, pack_gf2_rows

        Ep = pack_gf2_rows(errors)
        out = gf2_syndromes_packed(Hp, Ep, H.shape[0])
        if out is not None:
            return out
    # BLAS fallback: 0/1 products, sums bounded by the check degree
    s = errors.astype(np.float32) @ H.T.astype(np.float32)
    return (s.astype(np.int64)) % 2


def verify_decodes(H, errors: np.ndarray, guesses: np.ndarray, syndromes=None):
    """Fused host-side decode verification.

    Returns ``(exact [B] bool, smatch [B] bool)``: bitwise recovery of the
    injected errors, and syndrome consistency of the guesses — computed as
    ``H @ (E xor G) == 0``, which equals ``syndromes_of(H, G) ==
    syndromes_of(H, E)`` without materializing either syndrome.  Dense H
    uses the native early-exit kernel; the fallback recomputes syndromes.

    ``syndromes`` (the injected-error syndromes) is only needed by the
    fallback path; pass it when already computed to avoid one extra pass.
    """
    errors = np.asarray(errors).astype(np.uint8)
    guesses = np.asarray(guesses).astype(np.uint8)
    if not hasattr(H, "tocsr"):
        H = np.asarray(H)
        Hp = _packed_of(H)
        if Hp is not None:
            from ..native import gf2_verify_packed, pack_gf2_rows

            out = gf2_verify_packed(
                Hp, pack_gf2_rows(errors), pack_gf2_rows(guesses)
            )
            if out is not None:
                return out
    exact = (guesses == errors).all(axis=1)
    if syndromes is None:
        syndromes = syndromes_of(H, errors)
    smatch = (syndromes_of(H, guesses) == np.asarray(syndromes)).all(axis=1)
    return exact, smatch


def syndromes_from_edges(errors: np.ndarray, rows, cols, m: int) -> np.ndarray:
    """``[B, m]`` syndromes from a COO edge list (host, O(active edges)).

    For codes held only as edge lists (``TannerGraph.from_edges`` scale),
    this runs one masked ``bincount`` per lane — O(E) working memory, no
    dense ``[B, E]`` intermediates (a fused-key variant allocated several
    ``batch * E`` int64 arrays: ~6 GB at million-qubit HGP scale).
    """
    errors = np.asarray(errors, dtype=bool)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    B = errors.shape[0]
    out = np.empty((B, m), np.uint8)
    for b in range(B):
        counts = np.bincount(rows[errors[b, cols]], minlength=m)
        out[b] = (counts & 1).astype(np.uint8)
    return out


def sample_errors_device(key, batch: int, n: int, per: float):
    """Device-side error sampling with a JAX PRNG key."""
    import jax

    return jax.random.bernoulli(key, per, (batch, n))


def sample_mixed_channel(rng, batch: int, n: int, p_flip: float, p_erase: float):
    """Sample the mixed erasure + bit-flip channel (host).

    Returns ``(erasures [batch, n] bool, errors [batch, n] bool)``:
    each bit is independently erased with probability ``p_erase``
    (erased bits take a uniform random value — the decoder knows the
    location, not the value); non-erased bits flip with ``p_flip``.
    """
    if isinstance(rng, (int, np.integer)) or rng is None:
        rng = np.random.default_rng(rng)
    erasures = rng.random((batch, n)) < p_erase
    errors = np.where(
        erasures,
        rng.random((batch, n)) < 0.5,
        rng.random((batch, n)) < p_flip,
    )
    return erasures, errors
