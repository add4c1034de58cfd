"""Space-time (multi-round, noisy-measurement) decoding tests.

The reference has no measurement-error support (all decoders take one
perfect syndrome), so the oracles here are structural identities plus
coding-theory expectations:
  * construction invariants of the detector matrix;
  * rounds=1 == single-shot decoding, bit for bit;
  * converged lanes reproduce their detector record exactly (hence the
    final-round syndrome);
  * phenomenological decoding beats measurement-blind decoding, and a
    larger-distance code beats a smaller one below threshold.
"""

import numpy as np
import pytest

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.codes.spacetime import (
    detectors_of,
    spacetime_pcm,
    spacetime_prior,
)
from ldpcdecoders_tpu.harness import spacetime_logical_sweep
from ldpcdecoders_tpu.models.spacetime import SpaceTimeDecoder
from ldpcdecoders_tpu.utils.noise import sample_errors, syndromes_of


def _history(H, b, rounds, per, q, rng):
    """Simulate b shots of `rounds` noisy measurement rounds; the last
    round is read out perfectly.  Returns (syndromes [b,R,m], final
    cumulative error [b,n])."""
    m, n = H.shape
    e = sample_errors(rng, b * rounds, n, per).reshape(b, rounds, n)
    cum = (np.cumsum(e, axis=1) & 1).astype(np.uint8)
    syn = np.stack([syndromes_of(H, cum[:, r]) for r in range(rounds)], axis=1)
    u = sample_errors(rng, b * rounds, m, q).reshape(b, rounds, m)
    u[:, -1] = 0
    return (syn ^ u.astype(np.uint8)).astype(np.uint8), cum[:, -1]


def test_spacetime_pcm_shape_and_blocks():
    H = lt.toric_code_x(3)
    m, n = H.shape
    R = 4
    A = spacetime_pcm(H, R)
    assert A.shape == (R * m, R * n + (R - 1) * m)
    Ad = np.asarray(A.todense())
    # row block r: H at data block r, I at u_r (r<R) and u_{r-1} (r>1)
    for r in range(1, R + 1):
        rows = slice((r - 1) * m, r * m)
        assert np.array_equal(Ad[rows, (r - 1) * n: r * n], np.asarray(H) & 1)
        if r < R:
            np.testing.assert_array_equal(
                Ad[rows, R * n + (r - 1) * m: R * n + r * m], np.eye(m))
        if r > 1:
            np.testing.assert_array_equal(
                Ad[rows, R * n + (r - 2) * m: R * n + (r - 1) * m], np.eye(m))
    # open boundary adds the u_R block
    Ao = spacetime_pcm(H, R, perfect_last=False)
    assert Ao.shape == (R * m, R * n + R * m)


def test_spacetime_prior_layout():
    p = spacetime_prior(4, 2, 3, 0.01, 0.05)
    assert p.shape == (3 * 4 + 2 * 2,)
    assert np.all(p[:12] == 0.01) and np.all(p[12:] == 0.05)
    # vector per-qubit / per-check rates tile per round
    pv = spacetime_prior(2, 1, 2, [0.1, 0.2], [0.3])
    np.testing.assert_allclose(pv, [0.1, 0.2, 0.1, 0.2, 0.3])


def test_detectors_of_is_xor_difference():
    rng = np.random.default_rng(0)
    s = (rng.random((5, 4, 7)) < 0.5).astype(np.uint8)
    d = detectors_of(s).reshape(5, 4, 7)
    np.testing.assert_array_equal(d[:, 0], s[:, 0])
    for r in range(1, 4):
        np.testing.assert_array_equal(d[:, r], s[:, r] ^ s[:, r - 1])
    # single shot [R, m]
    d1 = detectors_of(s[0])
    np.testing.assert_array_equal(d1, detectors_of(s)[0])


def test_rounds_one_equals_single_shot():
    """R=1 with a perfect last round IS the reference decoding problem."""
    H = lt.parity_check_matrix(48, 6, 3, rng=5)
    rng = np.random.default_rng(1)
    errs = sample_errors(rng, 32, 48, 0.02)
    syn = syndromes_of(H, errs)
    st = SpaceTimeDecoder(H, 1, 0.02, max_iters=30, decoder="bposd")
    plain = lt.BeliefPropagationOSDDecoder(H, 0.02, 30)
    e1, c1 = st.batch_decode(syn, seed=3)
    e2, c2 = plain.batch_decode(syn, seed=3, per=np.full(48, 0.02))
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))


def test_rounds_one_partial_prior_override():
    """rounds=1 has zero measurement columns; a per-only override must
    not try to slice a default q back out of the stored prior
    (regression: opaque broadcast ValueError)."""
    H = lt.parity_check_matrix(48, 6, 3, rng=5)
    rng = np.random.default_rng(2)
    syn = syndromes_of(H, sample_errors(rng, 8, 48, 0.03))
    st = SpaceTimeDecoder(H, 1, 0.02, max_iters=30, decoder="bposd")
    e1, c1 = st.batch_decode(syn, seed=3, per=0.03)  # q left default
    plain = lt.BeliefPropagationOSDDecoder(H, 0.03, 30)
    e2, c2 = plain.batch_decode(syn, seed=3, per=np.full(48, 0.03))
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))


def test_converged_lanes_reproduce_detectors():
    """A converged space-time solution satisfies A x = d, so the
    cumulative estimate reproduces the final (perfect) syndrome."""
    H = lt.toric_code_x(4)
    rng = np.random.default_rng(7)
    R, per, q = 3, 0.015, 0.015
    syn, e_final = _history(H, 64, R, per, q, rng)
    dec = SpaceTimeDecoder(H, R, per, max_iters=60, decoder="bposd")
    e_hat, conv, iters, aux, stats = dec.batch_decode_detailed(
        detectors_of(syn))
    # `conv` is the BP flag; OSD completion makes EVERY lane detector-
    # consistent, and A x = d telescopes to H @ cum(x) == s_R
    assert conv.mean() > 0.7
    assert stats.batch_size == 64 and stats.converged_fraction == conv.mean()
    final_syn_hat = syndromes_of(H, np.asarray(e_hat))
    np.testing.assert_array_equal(final_syn_hat, syn[:, -1])
    assert np.asarray(aux["data_rounds"]).shape == (64, R, H.shape[1])
    assert np.asarray(aux["meas"]).shape == (64, R - 1, H.shape[0])


def test_decode_history_matches_batch_decode():
    H = lt.toric_code_x(3)
    rng = np.random.default_rng(9)
    syn, _ = _history(H, 8, 3, 0.01, 0.01, rng)
    dec = SpaceTimeDecoder(H, 3, 0.01, max_iters=40)
    e1, c1 = dec.decode_history(syn, seed=2)
    e2, c2 = dec.batch_decode(detectors_of(syn), seed=2)
    np.testing.assert_array_equal(e1, e2)
    np.testing.assert_array_equal(c1, c2)
    # single-shot convenience
    e3, c3 = dec.decode_history(syn[0], seed=2)
    assert e3.shape == (H.shape[1],)
    assert isinstance(c3, bool)


def test_measurement_errors_attributed_to_measurement_columns():
    """With data errors off, flipped readouts must be explained by the
    measurement-error columns: the cumulative data estimate is empty."""
    H = lt.toric_code_x(4)
    m, n = H.shape
    rng = np.random.default_rng(11)
    R = 4
    syn = np.zeros((32, R, m), np.uint8)
    u = sample_errors(rng, 32 * R, m, 0.03).reshape(32, R, m)
    u[:, -1] = 0
    syn ^= u.astype(np.uint8)
    dec = SpaceTimeDecoder(H, R, 1e-4, max_iters=60, meas_error_rate=0.03)
    e_hat, conv = dec.batch_decode(detectors_of(syn))
    assert conv.mean() > 0.95
    # measurement-only histories decode to (almost always) no data error
    assert (np.asarray(e_hat).sum(axis=1) == 0).mean() > 0.9


def test_spacetime_beats_measurement_blind_decoding():
    """Joint space-time decoding should fail logically far less often
    than naively decoding the last noisy round as if it were perfect."""
    Hx, Hz = lt.toric_code_x(3), lt.toric_code_z(3)
    from ldpcdecoders_tpu.utils.metrics import gf2_rowspan_reducer

    span = gf2_rowspan_reducer(Hz)
    rng = np.random.default_rng(13)
    R, per = 5, 0.02
    B = 256
    syn, e_final = _history(Hx, B, R, per, per, rng)
    st = SpaceTimeDecoder(Hx, R, per, max_iters=60, decoder="bposd")
    e_st, _ = st.batch_decode(detectors_of(syn))
    blind = lt.BeliefPropagationOSDDecoder(Hx, per, 60)
    # the blind decoder sees the *noisy* penultimate round (a real-time
    # decoder cannot wait for the perfect closure round)
    e_bl, _ = blind.batch_decode(syn[:, -2])
    fail_st = int((~span(e_final ^ np.asarray(e_st, np.uint8))).sum())
    fail_bl = int((~span(e_final ^ np.asarray(e_bl, np.uint8))).sum())
    assert fail_st < fail_bl / 2, (fail_st, fail_bl)


@pytest.mark.slow
def test_spacetime_sweep_measurement_noise_ordering():
    """More readout noise strictly hurts; q=0 approaches the perfect-
    measurement rate.  (Distance ordering is NOT asserted: plain BP+OSD
    on the toric code is degeneracy-limited and inverts d=3/d=5 even at
    R=1 with perfect measurements — verified against css_logical_sweep —
    so it would test the inner decoder's known weakness, not the
    space-time construction.)"""
    common = dict(rounds=3, trials_per_point=1024, max_iters=50,
                  batch=256, seed=0)
    rates = {}
    for q in (0.0, 0.01, 0.04):
        res = spacetime_logical_sweep(
            lt.toric_code_x(3), lt.toric_code_z(3), [0.01],
            meas_error_rate=q, **common)
        rates[q] = res[0.01]["any_logical_rate"]
        assert res[0.01]["trials"] == 1024
        assert res[0.01]["rounds"] == 3
    assert rates[0.0] <= rates[0.01] <= rates[0.04], rates
    assert rates[0.04] > rates[0.0], rates


def test_sweep_smoke_and_schema():
    res = spacetime_logical_sweep(
        lt.toric_code_x(3), lt.toric_code_z(3), [0.005, 0.02],
        rounds=2, trials_per_point=64, max_iters=30, batch=64, seed=1)
    for per in (0.005, 0.02):
        pt = res[per]
        assert pt["trials"] == 64
        assert 0.0 <= pt["any_logical_rate"] <= 1.0
        assert pt["any_logical_ci95"][0] <= pt["any_logical_rate"] <= pt["any_logical_ci95"][1]
        assert pt["meas_error_rate"] == per
    # monotone in per (loose: just not wildly inverted at these two points)
    assert res[0.005]["any_logical_rate"] <= res[0.02]["any_logical_rate"] + 0.05


def test_bad_shapes_raise():
    H = lt.toric_code_x(3)
    dec = SpaceTimeDecoder(H, 3, 0.01, max_iters=10)
    with pytest.raises(ValueError, match="detectors"):
        dec.batch_decode(np.zeros((4, 5), np.uint8))
    with pytest.raises(ValueError, match="rounds"):
        spacetime_pcm(H, 0)
    with pytest.raises(ValueError, match="prior-capable|cannot honor"):
        SpaceTimeDecoder(H, 2, 0.01, max_iters=10, decoder="bitflip")


# ---------------------------------------------------------------- windowed


def test_sliding_window_final_syndrome_identity():
    """The committed window equations telescope: the streaming estimate
    reproduces the final perfect syndrome exactly, like a full decode."""
    from ldpcdecoders_tpu.models.window import SlidingWindowDecoder

    H = lt.toric_code_x(3)
    rng = np.random.default_rng(21)
    R, per = 9, 0.01
    syn, e_final = _history(H, 48, R, per, per, rng)
    dec = SlidingWindowDecoder(H, per, max_iters=50, window=3, commit=1)
    E, info = dec.decode_stream(syn, seed=5)
    np.testing.assert_array_equal(
        syndromes_of(H, np.asarray(E)), syn[:, -1])
    assert info["rounds"] == R
    assert info["windows"] == (R - 3) // 1 + 1
    assert 0.0 <= info["converged"] <= 1.0


def test_sliding_window_accuracy_near_full_decode():
    """Windowed decoding should logically fail at most ~2x the oracle
    full-history decode on the same shots (it sees strictly less
    context), and far less than measurement-blind decoding."""
    from ldpcdecoders_tpu.models.window import SlidingWindowDecoder
    from ldpcdecoders_tpu.utils.metrics import gf2_rowspan_reducer

    Hx, Hz = lt.toric_code_x(3), lt.toric_code_z(3)
    span = gf2_rowspan_reducer(Hz)
    rng = np.random.default_rng(23)
    R, per, B = 9, 0.015, 256
    syn, e_final = _history(Hx, B, R, per, per, rng)
    win = SlidingWindowDecoder(Hx, per, max_iters=50, window=4, commit=2)
    E_w, _ = win.decode_stream(syn, seed=1)
    full = SpaceTimeDecoder(Hx, R, per, max_iters=50)
    E_f, _ = full.decode_history(syn, seed=1)
    fail_w = int((~span(e_final ^ np.asarray(E_w, np.uint8))).sum())
    fail_f = int((~span(e_final ^ np.asarray(E_f, np.uint8))).sum())
    assert fail_w <= max(2 * fail_f, fail_f + 8), (fail_w, fail_f)


def test_sliding_window_short_stream_is_one_closed_decode():
    """A stream no longer than the window routes to the closed decoder
    directly — identical to SpaceTimeDecoder on the same history."""
    from ldpcdecoders_tpu.models.window import SlidingWindowDecoder

    H = lt.toric_code_x(3)
    rng = np.random.default_rng(29)
    syn, _ = _history(H, 16, 3, 0.01, 0.01, rng)
    win = SlidingWindowDecoder(H, 0.01, max_iters=40, window=4, commit=2)
    E_w, info = win.decode_stream(syn, seed=7)
    full = SpaceTimeDecoder(H, 3, 0.01, max_iters=40)
    E_f, _ = full.decode_history(syn, seed=7)
    np.testing.assert_array_equal(np.asarray(E_w), np.asarray(E_f))
    assert info["windows"] == 1


def test_sliding_window_validation():
    from ldpcdecoders_tpu.models.window import SlidingWindowDecoder

    H = lt.toric_code_x(3)
    with pytest.raises(ValueError, match="window"):
        SlidingWindowDecoder(H, 0.01, 10, window=1)
    with pytest.raises(ValueError, match="commit"):
        SlidingWindowDecoder(H, 0.01, 10, window=3, commit=3)
    dec = SlidingWindowDecoder(H, 0.01, 10, window=3, commit=1)
    with pytest.raises(ValueError, match="syndromes"):
        dec.decode_stream(np.zeros((4, 5), np.uint8))


# ------------------------------------------------------- unified surface


def test_spacetime_is_a_decoder():
    """SpaceTimeDecoder honors the full Decoder contract (VERDICT r2 #4):
    free functions, DecodeStats, async dispatch, single decode."""
    from ldpcdecoders_tpu.models.base import DecodeStats

    H = lt.toric_code_x(3)
    dec = SpaceTimeDecoder(H, 2, 0.01, max_iters=30)
    assert isinstance(dec, lt.Decoder)
    assert dec.m == 2 * H.shape[0] and dec.n == H.shape[1]
    assert dec.block_m == H.shape[0] and dec.block_n == H.shape[1]
    rng = np.random.default_rng(11)
    syn, _ = _history(H, 8, 2, 0.01, 0.01, rng)
    det = detectors_of(syn)
    # free functions (reference decode!/batchdecode! contract)
    e_b, c_b = lt.batchdecode(dec, det, seed=5)
    e_1, c_1 = lt.decode(dec, det[0], seed=5)
    np.testing.assert_array_equal(e_1, e_b[0])
    assert bool(c_1) == bool(c_b[0])
    # async dispatch returns device arrays, reads match sync
    e_a, c_a = dec.batch_decode_async(det, seed=5)
    np.testing.assert_array_equal(np.asarray(e_a), e_b)
    # detailed path carries DecodeStats
    *_, stats = dec.batch_decode_detailed(det, seed=5)
    assert isinstance(stats, DecodeStats) and stats.batch_size == 8


def test_detector_is_a_decoder():
    from ldpcdecoders_tpu.models.detector import DetectorGraphDecoder, load_dem
    from ldpcdecoders_tpu.models.base import DecodeStats

    A, priors, O = load_dem(
        "error(0.05) D0 L0\nerror(0.05) D0 D1\nerror(0.05) D1 D2\n"
        "error(0.05) D2 L0\n")
    dec = DetectorGraphDecoder(A, priors, 20, observables=O)
    assert isinstance(dec, lt.Decoder)
    assert dec.m == dec.D == 3 and dec.n == dec.N == 4
    det = np.array([[1, 0, 0], [0, 1, 1]], np.uint8)
    e_b, c_b = lt.batchdecode(dec, det, seed=2)
    e_1, c_1 = lt.decode(dec, det[0], seed=2)
    np.testing.assert_array_equal(e_1, e_b[0])
    *_, stats = dec.batch_decode_detailed(det, seed=2)
    assert isinstance(stats, DecodeStats) and stats.batch_size == 2


def test_wrapper_config_kinds_roundtrip_and_build():
    """DecoderConfig kinds 'spacetime'/'window'/'detector' JSON
    round-trip and build working decoders."""
    from ldpcdecoders_tpu import DecoderConfig

    H = lt.toric_code_x(3)
    cfg = DecoderConfig(kind="spacetime", per=0.01, max_iters=25, rounds=2,
                        meas_error_rate=0.02, inner_kind="bposd")
    assert DecoderConfig.from_json(cfg.to_json()) == cfg
    dec = cfg.build(H)
    assert isinstance(dec, SpaceTimeDecoder) and dec.rounds == 2
    rng = np.random.default_rng(3)
    syn, _ = _history(H, 4, 2, 0.01, 0.02, rng)
    errs, conv = dec.batch_decode(detectors_of(syn))
    assert errs.shape == (4, H.shape[1])

    wcfg = DecoderConfig(kind="window", per=0.01, max_iters=25, window=3,
                         commit=1)
    assert DecoderConfig.from_json(wcfg.to_json()) == wcfg
    from ldpcdecoders_tpu.models.window import SlidingWindowDecoder
    assert isinstance(wcfg.build(H), SlidingWindowDecoder)

    from ldpcdecoders_tpu.models.detector import DetectorGraphDecoder
    dcfg = DecoderConfig(kind="detector", max_iters=20)
    A = np.eye(3, dtype=np.uint8)
    ddec = dcfg.build((A, [0.1, 0.1, 0.1]))
    assert isinstance(ddec, DetectorGraphDecoder)
    with pytest.raises(ValueError, match="detector"):
        dcfg.build(A)  # not a tuple and no dem_path
    with pytest.raises(ValueError, match="wrapper"):
        DecoderConfig(kind="spacetime", inner_kind="window")


def test_spacetime_decode_batch_traces_under_jit():
    """The whole _decode_batch (with a fused inner) compiles as ONE XLA
    program — what lets the evaluation harness fuse sampling + decode +
    verification on device."""
    import jax

    H = lt.toric_code_x(3)
    R = 2
    dec = SpaceTimeDecoder(H, R, 0.01, max_iters=20, decoder="bposd",
                           fused=True)
    rng = np.random.default_rng(17)
    syn, _ = _history(H, 8, R, 0.01, 0.01, rng)
    det = detectors_of(syn).astype(np.uint8)

    @jax.jit
    def step(d, per):
        e, conv, iters, _ = dec._decode_batch(d, 3, per=per, q=per)
        return e, conv

    e_j, c_j = step(det, 0.01)
    e_e, c_e = dec.batch_decode(det, seed=3, per=0.01, q=0.01)
    np.testing.assert_array_equal(np.asarray(e_j), np.asarray(e_e))
    np.testing.assert_array_equal(np.asarray(c_j), np.asarray(c_e))


def test_fersweep_drives_detector_decoder():
    """FERSweep treats a DetectorGraphDecoder like any Decoder: H = the
    detector matrix, errors = mechanisms (VERDICT r2 #4 'FERSweep
    integration')."""
    from ldpcdecoders_tpu.harness import FERSweep
    from ldpcdecoders_tpu.models.detector import DetectorGraphDecoder, load_dem

    A, priors, O = load_dem(
        "error(0.05) D0 L0\nerror(0.05) D0 D1\nerror(0.05) D1 D2\n"
        "error(0.05) D2 L0\n")
    Ad = np.asarray(A.todense())
    sweep = FERSweep(
        Ad,
        lambda per: DetectorGraphDecoder(Ad, np.full(4, per), 20,
                                         observables=O),
        [0.03], batch=64, seed=7)
    out = sweep.run(trials_per_point=128)
    assert out[0.03]["trials"] == 128
    assert out[0.03]["syndrome_match_rate"] == 1.0  # OSD consistency


# ------------------------------------------------- device-resident sweep


def test_device_step_counts_match_host_verification():
    """One _make_spacetime_pair_step batch, recomputed on host: sampling
    via the same keys, decode via the public API, degeneracy via the
    bit-packed rowspan reducer — counts must agree exactly."""
    import jax
    from ldpcdecoders_tpu.harness import (
        _make_spacetime_pair_step,
        _spacetime_sample,
    )
    from ldpcdecoders_tpu.models.spacetime import SpaceTimeDecoder
    from ldpcdecoders_tpu.utils.metrics import (
        css_logical_operators,
        gf2_rowspan_reducer,
    )

    Hx, Hz = lt.toric_code_x(3), lt.toric_code_z(3)
    R, per, q, b = 3, 0.02, 0.02, 32
    dec_x = SpaceTimeDecoder(Hx, R, per, 40, decoder="bposd", fused=True)
    dec_z = SpaceTimeDecoder(Hz, R, per, 40, decoder="bposd", fused=True)
    Lx = css_logical_operators(Hx, Hz)
    Lz = css_logical_operators(Hz, Hx)
    step = _make_spacetime_pair_step(dec_x, dec_z, Hx, Hz, Lx, Lz, b)
    noise_seed, decode_seed = 12345, 777
    counts = np.asarray(step(noise_seed, decode_seed, per, q))

    # host recomputation on the identical jax.random streams
    kx, kz = jax.random.split(jax.random.PRNGKey(noise_seed))
    import jax.numpy as jnp

    def host_block(key, dec, H, span, ds):
        cum, det = _spacetime_sample(
            key, jnp.asarray(np.asarray(H), jnp.float32), per, q, b, R)
        e_hat, conv = dec.batch_decode(np.asarray(det), seed=ds,
                                       per=per, q=q)
        resid = np.asarray(cum).astype(np.uint8) ^ e_hat.astype(np.uint8)
        return ~span(resid), conv

    z_span = gf2_rowspan_reducer(Hz)
    x_span = gf2_rowspan_reducer(Hx)
    zfail, zconv = host_block(kx, dec_x, Hx, z_span, decode_seed)
    xfail, xconv = host_block(kz, dec_z, Hz, x_span, decode_seed + 1)
    assert counts[0] == zfail.sum()
    assert counts[1] == xfail.sum()
    assert counts[2] == (zfail | xfail).sum()
    assert counts[3] == zconv.sum()
    assert counts[4] == xconv.sum()


def test_device_and_host_sweeps_agree_statistically():
    """jax.random vs NumPy noise streams: same physics, different bits —
    rates must land inside each other's 95% Wilson intervals."""
    Hx, Hz = lt.toric_code_x(3), lt.toric_code_z(3)
    kw = dict(rounds=2, trials_per_point=768, max_iters=40, batch=256,
              seed=3)
    dev = spacetime_logical_sweep(Hx, Hz, [0.03], on_device=True, **kw)
    host = spacetime_logical_sweep(Hx, Hz, [0.03], on_device=False, **kw)
    d, h = dev[0.03], host[0.03]
    assert d["device_sampled"] and not h["device_sampled"]
    assert d["trials"] == h["trials"] == 768
    lo, hi = h["any_logical_ci95"]
    assert lo - 0.02 <= d["any_logical_rate"] <= hi + 0.02, (d, h)


def test_device_sweep_is_reproducible_and_time_bounded():
    Hx, Hz = lt.toric_code_x(3), lt.toric_code_z(3)
    kw = dict(rounds=2, trials_per_point=128, max_iters=30, batch=64, seed=9)
    a = spacetime_logical_sweep(Hx, Hz, [0.02], **kw)
    b = spacetime_logical_sweep(Hx, Hz, [0.02], **kw)
    assert a[0.02]["any_logical_rate"] == b[0.02]["any_logical_rate"]
    assert a[0.02]["z_logical_rate"] == b[0.02]["z_logical_rate"]
    # max_seconds=0 stops before any batch at the SECOND point
    c = spacetime_logical_sweep(Hx, Hz, [0.02, 0.03], max_seconds=0.0, **kw)
    assert len(c) <= 1


def test_css_sweep_delegates_to_device_pipeline():
    from ldpcdecoders_tpu.harness import css_logical_sweep

    Hx, Hz = lt.toric_code_x(3), lt.toric_code_z(3)
    out = css_logical_sweep(Hx, Hz, [0.02], trials_per_point=128, batch=64,
                            seed=4, max_iters=30)
    pt = out[0.02]
    assert pt["device_sampled"]
    assert "throughput_pairs_per_s" in pt and "rounds" not in pt
    assert pt["trials"] == 128
    # non-prior-capable kinds keep the host CSSDecoder path
    out2 = css_logical_sweep(Hx, Hz, [0.02], trials_per_point=64, batch=64,
                             seed=4, max_iters=30, decoder="bitflip")
    assert out2[0.02]["trials"] == 64


def test_window_device_stream_matches_host_stream():
    """The device-chained streaming loop and the eager host fallback
    are the same math — bit-identical corrections."""
    from ldpcdecoders_tpu.models.window import SlidingWindowDecoder

    H = lt.toric_code_x(3)
    rng = np.random.default_rng(31)
    syn, _ = _history(H, 16, 7, 0.015, 0.015, rng)
    det = detectors_of(syn).reshape(16, 7, H.shape[0])
    win = SlidingWindowDecoder(H, 0.015, max_iters=40, window=3, commit=1)
    E_d, info_d = win.decode_detector_stream(det, seed=3)
    E_h, info_h = win._decode_stream_host(det.astype(np.uint8), 3)
    np.testing.assert_array_equal(E_d, E_h)
    assert info_d["windows"] == info_h["windows"]
    assert abs(info_d["converged"] - info_h["converged"]) < 1e-6


def test_qc_layered_inner_hosts_bicycle_spacetime():
    """VERDICT r4 item 5: SpaceTimeDecoder.for_bicycle builds the QC
    space-time lift (verified element-wise against spacetime_pcm by the
    constructor), carries the mixed per/q prior per column, and decodes
    detector records syndrome-consistently."""
    R, per, q = 3, 0.01, 0.015
    dec = SpaceTimeDecoder.for_bicycle(
        "bb72", "x", R, per, 60, meas_error_rate=q,
        schedule="layered")
    # the injected inner spans the full space-time model
    assert (dec.inner.m, dec.inner.n) == dec.A.shape
    assert dec.block_n == 72 and dec.m == R * dec.block_m

    rng = np.random.default_rng(5)
    B = 48
    x = (rng.random((B, dec.n_cols)) < dec._prior[None, :]).astype(np.uint8)
    det = (x @ dec.A.T.toarray() % 2).astype(np.uint8)
    err, conv, iters, aux, stats = dec.batch_decode_detailed(det)
    assert conv.mean() > 0.9  # layered QC inner converges like r4 measured
    # converged lanes reproduce the detector record through the model
    full = np.concatenate(
        [np.asarray(aux["data_rounds"]).reshape(B, -1),
         np.asarray(aux["meas"]).reshape(B, -1)], axis=1)
    rec = (full.astype(np.uint8) @ dec.A.T.toarray() % 2).astype(np.uint8)
    np.testing.assert_array_equal(rec[conv], det[conv])

    # mixed prior really reaches the inner: decoding with q swapped in
    # as a per-call override reproduces the constructor-default decode
    err2, conv2 = dec.batch_decode(det, per=per, q=q)
    np.testing.assert_array_equal(err, err2)
    np.testing.assert_array_equal(conv, conv2)


def test_qc_layered_inner_rejects_bad_blocks():
    with pytest.raises(ValueError, match="block must be"):
        SpaceTimeDecoder.for_bicycle("bb72", "y", 2, 0.01, 10)
    with pytest.raises(ValueError, match="unknown BB code"):
        SpaceTimeDecoder.for_bicycle("bb999", "x", 2, 0.01, 10)
