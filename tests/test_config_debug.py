"""DecoderConfig + debug-validation tests, and the reference's own
statistical oracle on its exact (1000, 10, 9) benchmark configuration."""

import numpy as np
import pytest

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.config import DecoderConfig
from ldpcdecoders_tpu.utils import validate_inputs, check_decode_invariants


def test_config_roundtrip_and_build():
    H = lt.parity_check_matrix(120, 6, 3, rng=1)
    for kind in ("bp", "bposd", "bitflip", "bpots", "minsum", "minsum_int8", "layered_minsum"):
        cfg = DecoderConfig(kind=kind, per=0.02, max_iters=20)
        cfg2 = DecoderConfig.from_json(cfg.to_json())
        assert cfg == cfg2
        dec = cfg2.build(H)
        err, ok = dec.decode(np.zeros(H.shape[0], dtype=np.uint8))
        assert err.shape == (H.shape[1],)


def test_config_rejects_unknown_kind():
    with pytest.raises(ValueError):
        DecoderConfig(kind="magic")


def test_validate_inputs_rejects_nonbinary():
    H = lt.parity_check_matrix(120, 6, 3, rng=2)
    dec = lt.BeliefPropagationDecoder(H, 0.01, 10)
    with pytest.raises(ValueError):
        validate_inputs(dec, np.full((2, H.shape[0]), 3))
    with pytest.raises(ValueError):
        validate_inputs(dec, np.zeros((2, 7)))
    validate_inputs(dec, np.zeros((2, H.shape[0]), dtype=np.uint8))


def test_decode_invariants_pass_for_all_decoders():
    H = lt.parity_check_matrix(120, 6, 3, rng=3)
    rng = np.random.default_rng(4)
    errs = rng.random((16, H.shape[1])) < 0.03
    syns = (errs @ H.T) % 2
    for kind in ("bp", "bposd", "bitflip", "bpots", "minsum", "minsum_int8"):
        dec = DecoderConfig(kind=kind, per=0.03, max_iters=30).build(H)
        e, c, it, aux, _ = dec.batch_decode_detailed(syns)
        check_decode_invariants(dec, syns, e, c, aux)


def test_reference_exact_config_bp_ler():
    """The reference's own CI oracle on its own config: (1000,10,9) code,
    per=0.01, max_iters=100, 100-trial batch LER < 0.005
    (test_bp_decoder.jl:49; we fix the RNG so this is deterministic)."""
    H = lt.parity_check_matrix(1000, 10, 9, rng=42)
    rng = np.random.default_rng(0)
    trials = 100
    errs = rng.random((trials, 1000)) < 0.01
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationDecoder(H, 0.01, 100)
    guesses, conv = dec.batch_decode(syns)
    exact = (guesses.astype(bool) == errs).all(axis=1)
    ler = 1.0 - exact.mean()
    assert ler < 0.005, f"LER {ler} vs reference threshold 0.005"


def test_reference_exact_config_bp_ler_1000_trials():
    """The reference's second, tighter oracle on the same config: LER over
    1000 decodes < 0.001 (test_bp_decoder.jl:51 — sequential there; batch
    decoding here is tested equivalent in tests/test_bp.py)."""
    H = lt.parity_check_matrix(1000, 10, 9, rng=42)
    rng = np.random.default_rng(2)
    trials = 1000
    errs = rng.random((trials, 1000)) < 0.01
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationDecoder(H, 0.01, 100)
    guesses, conv = dec.batch_decode(syns)
    exact = (guesses.astype(bool) == errs).all(axis=1)
    ler = 1.0 - exact.mean()
    assert ler < 0.001, f"LER {ler} vs reference threshold 0.001"


def test_reference_exact_config_bposd_consistency():
    """Reference oracle: BP+OSD output is syndrome-consistent even at
    per=0.2 on the (1000,10,9) code (test_bposd_decoder.jl:37-47)."""
    H = lt.parity_check_matrix(1000, 10, 9, rng=42)
    rng = np.random.default_rng(1)
    errs = rng.random((4, 1000)) < 0.2
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationOSDDecoder(H, 0.2, 100)
    guesses, conv = dec.batch_decode(syns)
    synhat = (guesses.astype(int) @ H.T) % 2
    assert (synhat == syns).all()


def test_config_forwards_use_pallas_to_bposd():
    """The config has no use_pallas knob: the bposd decoder it builds
    chooses the GF(2) elimination kernel from the code's shape."""
    import ldpcdecoders_tpu as lt
    from ldpcdecoders_tpu.config import DecoderConfig

    H = lt.parity_check_matrix(48, 6, 3, rng=3)
    with pytest.raises(TypeError, match="use_pallas"):
        DecoderConfig(kind="bposd", use_pallas=True)
    dec = DecoderConfig(kind="bposd").build(H)
    assert dec.osd_kernel is True
