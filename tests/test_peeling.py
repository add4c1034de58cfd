"""Erasure-channel peeling decoder: parallel leaf peeling + GF(2) completion."""

import numpy as np
import pytest

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.models.peeling import ErasurePeelingDecoder


@pytest.fixture(scope="module")
def code():
    H = lt.parity_check_matrix(120, 6, 3, rng=0)
    return H, ErasurePeelingDecoder(H)


def _channel(H, B, eps_rate, seed):
    rng = np.random.default_rng(seed)
    n = H.shape[1]
    eps = rng.random((B, n)) < eps_rate
    e = eps & (rng.random((B, n)) < 0.5)  # erased values uniform
    syn = (e @ H.T) % 2
    return eps, e, syn


def test_peeling_exact_below_threshold(code):
    H, dec = code
    eps, e, syn = _channel(H, 64, 0.15, 1)
    err, ok = dec.batch_decode(syn, eps)
    assert ok.all()
    assert np.array_equal(err, e.astype(np.int8))  # unique solution regime
    assert not (err.astype(bool) & ~eps).any()  # support inside the erasure
    assert err.dtype == np.int8


def test_gf2_completion_solves_stopping_sets(code):
    H, dec = code
    eps, e, syn = _channel(H, 64, 0.5, 2)
    err, ok = dec.batch_decode(syn, eps)
    assert ok.all()  # a consistent solution always exists here
    s2 = (err.astype(np.int64) @ H.T) % 2
    assert (s2 == syn).all()
    assert not (err.astype(bool) & ~eps).any()
    # pure peeling stalls on the same instances
    dec_f = ErasurePeelingDecoder(H, on_stuck="fail")
    _, ok_f = dec_f.batch_decode(syn, eps)
    assert ok_f.mean() < ok.mean()


def test_inconsistent_syndrome_not_converged(code):
    H, dec = code
    # a syndrome touching checks with NO erased neighbors cannot be solved
    eps = np.zeros((4, H.shape[1]), bool)
    syn = np.zeros((4, H.shape[0]), np.int8)
    syn[:, 0] = 1
    err, ok = dec.batch_decode(syn, eps)
    assert not ok.any()


def test_single_decode_matches_lane0(code):
    H, dec = code
    eps, e, syn = _channel(H, 3, 0.2, 3)
    err_b, ok_b = dec.batch_decode(syn, eps)
    err_1, ok_1 = dec.decode(syn[0], eps[0])
    assert np.array_equal(err_1, err_b[0]) and ok_1 == bool(ok_b[0])


def test_peeling_validation_and_sparse(code):
    H, dec = code
    with pytest.raises(ValueError, match="syndromes of shape"):
        dec.batch_decode(np.zeros((2, 3), np.int8), np.zeros((2, 120), bool))
    with pytest.raises(ValueError, match="erasures of shape"):
        dec.batch_decode(np.zeros((2, 60), np.int8), np.zeros((2, 7), bool))
    with pytest.raises(ValueError, match="on_stuck"):
        ErasurePeelingDecoder(H, on_stuck="explode")
    # scipy.sparse input goes through from_edges; gf2 completion then
    # requires a dense H, so it must refuse with guidance
    sp = pytest.importorskip("scipy.sparse")
    with pytest.raises(ValueError, match="dense H"):
        ErasurePeelingDecoder(sp.csr_matrix(H), on_stuck="gf2")
    dec_s = ErasurePeelingDecoder(sp.csr_matrix(H), on_stuck="fail")
    eps, e, syn = _channel(H, 16, 0.1, 4)
    err, ok = dec_s.batch_decode(syn, eps)
    assert ok.mean() > 0.9
    assert np.array_equal(err[ok], e[ok].astype(np.int8))


def test_thresholds_bracket_theory():
    """The decoder transitions where coding theory says it must: the
    (3,6)-regular BEC peeling threshold is eps*=0.4294 and the ML
    threshold 0.4882 (capacity at rate 1/2 is 0.5).  Artifact with
    tight brackets at n=2400: benchmarks/results/erasure_threshold_r2.json."""
    H = lt.parity_check_matrix(600, 6, 3, rng=0)
    ml = ErasurePeelingDecoder(H)
    pl = ErasurePeelingDecoder(H, on_stuck="fail")
    rng = np.random.default_rng(0)
    B, n = 256, 600

    def run(rate):
        eps = rng.random((B, n)) < rate
        e = eps & (rng.random((B, n)) < 0.5)
        syn = ((e @ H.T) % 2).astype(np.int8)
        _, okp = pl.batch_decode(syn, eps)
        errm, _ = ml.batch_decode(syn, eps)
        return okp.mean(), (errm == e).all(axis=1).mean()

    peel_lo, ml_lo = run(0.34)
    assert peel_lo > 0.95 and ml_lo > 0.95  # well below both thresholds
    peel_hi, ml_mid = run(0.48)
    assert peel_hi < 0.1  # past the peeling threshold (0.4294)
    assert ml_mid > 0.3  # ML still partially succeeds near its 0.4882
    _, ml_hi = run(0.54)
    assert ml_hi < 0.2  # past the ML threshold


def test_peel_depth_is_per_lane():
    """A lane with no erasures reports depth 0 even when another lane in
    the batch needs several rounds (depths are per-lane, not batch-max)."""
    import jax.numpy as jnp

    from ldpcdecoders_tpu.models.peeling import make_peel_fn
    from ldpcdecoders_tpu.codes.graph import TannerGraph

    H = lt.repetition_code(8)  # chain: peeling resolves ends-inward
    g = TannerGraph.from_pcm(H)
    peel = make_peel_fn(g)
    n = H.shape[1]
    eps = np.zeros((2, n), bool)
    eps[1, 2:6] = True  # a 4-bit interior run: needs 2 rounds
    e = np.zeros((2, n), np.int8)
    syn = ((e @ H.T) % 2).astype(np.int8)
    _, left, _, depth = peel(jnp.asarray(syn), jnp.asarray(eps))
    assert not np.asarray(left).any()
    assert np.asarray(depth).tolist() == [0, 2]
