"""BP decoder tests: exact golden parity + the reference's statistical oracles
(/root/reference/test/test_bp_decoder.jl)."""

import numpy as np
import pytest

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.golden import bp_decode as golden_bp


@pytest.fixture(scope="module")
def medium_code():
    # scaled-down analog of the reference's (1000, 10, 9) benchmark code;
    # keeps CPU test time low while preserving degree structure
    H = lt.parity_check_matrix(240, 8, 4, rng=11)
    return H


def test_bp_matches_golden_exactly(medium_code):
    """The batched JAX BP must reproduce the NumPy golden (which transcribes
    the reference's probability-ratio semantics) bit-for-bit in f32."""
    H = medium_code
    rng = np.random.default_rng(2)
    per = 0.02
    B = 16
    errs = rng.random((B, H.shape[1])) < per
    syns = (errs @ H.T) % 2

    dec = lt.BeliefPropagationDecoder(H, per, 25)
    err, conv = dec.batch_decode(syns)

    for b in range(B):
        ge, gc, _, _ = golden_bp(H, syns[b], per, 25, dtype=np.float32)
        assert np.array_equal(err[b], ge.astype(np.int8)), f"lane {b} mismatch"
        assert bool(conv[b]) == gc, f"lane {b} convergence mismatch"


def test_bp_single_decode_recovers_error(medium_code):
    H = medium_code
    rng = np.random.default_rng(3)
    err_true = rng.random(H.shape[1]) < 0.01
    syn = (H @ err_true) % 2
    dec = lt.BeliefPropagationDecoder(H, 0.01, 100)
    guess, success = dec.decode(syn)
    assert success
    assert np.array_equal(guess.astype(bool), err_true)


def test_bp_batch_ler_threshold(medium_code):
    """Reference oracle: batch logical-error rate < 0.005 at per=0.01 over
    100 trials (test_bp_decoder.jl:49); we fix the RNG for determinism."""
    H = medium_code
    rng = np.random.default_rng(4)
    per = 0.01
    trials = 200
    errs = rng.random((trials, H.shape[1])) < per
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationDecoder(H, per, 100)
    guesses, conv = dec.batch_decode(syns)
    exact = (guesses.astype(bool) == errs).all(axis=1)
    ler = 1.0 - exact.mean()
    assert ler < 0.02, f"LER {ler} too high"


def test_bp_zero_syndrome_gives_zero_error(medium_code):
    H = medium_code
    dec = lt.BeliefPropagationDecoder(H, 0.01, 10)
    guess, success = dec.decode(np.zeros(H.shape[0], dtype=np.uint8))
    assert success
    assert not guess.any()


def test_bp_detailed_stats(medium_code):
    H = medium_code
    rng = np.random.default_rng(5)
    errs = rng.random((8, H.shape[1])) < 0.01
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationDecoder(H, 0.01, 50)
    err, conv, iters, aux, stats = dec.batch_decode_detailed(syns)
    assert stats.batch_size == 8
    assert 0.0 <= stats.converged_fraction <= 1.0
    assert aux["log_probabs"].shape == (8, H.shape[1])
    assert (iters[conv] >= 1).all()


def test_bp_irregular_graph_toric():
    """BP on an irregular-degree quantum code graph (toric d=3): syndrome
    consistency for converged lanes."""
    H = lt.toric_code_x(3)
    rng = np.random.default_rng(6)
    errs = rng.random((32, H.shape[1])) < 0.03
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationDecoder(H, 0.03, 50)
    guesses, conv = dec.batch_decode(syns)
    synhat = (guesses.astype(int) @ H.T) % 2
    for b in np.flatnonzero(conv):
        assert np.array_equal(synhat[b], syns[b])


def test_bp_batch_matches_sequential(medium_code):
    """Batch decode must equal per-syndrome decode (the reference's batch
    path is literally a sequential loop; ours must be observationally
    identical)."""
    H = medium_code
    rng = np.random.default_rng(7)
    errs = rng.random((6, H.shape[1])) < 0.02
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationDecoder(H, 0.02, 30)
    b_err, b_conv = dec.batch_decode(syns)
    for i in range(6):
        s_err, s_conv = dec.decode(syns[i])
        assert np.array_equal(b_err[i], s_err)
        assert bool(b_conv[i]) == s_conv


def test_bp_batch_decode_async_matches_sync(medium_code):
    """The device-resident async path returns identical results to the
    synchronous API (it is the same program minus the host transfer)."""
    H = medium_code
    rng = np.random.default_rng(8)
    errs = rng.random((5, H.shape[1])) < 0.02
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationDecoder(H, 0.02, 30)
    e_sync, c_sync = dec.batch_decode(syns)
    # queue several dispatches before reading any result
    handles = [dec.batch_decode_async(syns) for _ in range(3)]
    for e_dev, c_dev in handles:
        assert np.array_equal(e_sync, np.asarray(e_dev))
        assert np.array_equal(c_sync, np.asarray(c_dev))
    import pytest

    with pytest.raises(ValueError):
        dec.batch_decode_async(np.zeros((2, 7), np.uint8))
    # plain nested lists are accepted, matching batch_decode
    e_list, c_list = dec.batch_decode_async(syns.tolist())
    assert np.array_equal(e_sync, np.asarray(e_list))
    assert np.array_equal(c_sync, np.asarray(c_list))


def test_bp_bfloat16_passes_reference_oracle(medium_code):
    """The bf16 speed mode (half the message bytes of f32) must still satisfy the reference's statistical
    contract: full recovery at per=0.01 (test_bp_decoder.jl:46-49)."""
    import jax.numpy as jnp

    H = medium_code
    rng = np.random.default_rng(77)
    errs = rng.random((64, H.shape[1])) < 0.01
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationDecoder(H, 0.01, 100, dtype=jnp.bfloat16)
    g, c = dec.batch_decode(syns)
    assert c.all()
    assert (g.astype(bool) == errs).all()
