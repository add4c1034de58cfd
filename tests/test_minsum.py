"""Min-sum production decoder tests."""

import numpy as np
import pytest

import ldpcdecoders_tpu as lt


@pytest.fixture(scope="module")
def code():
    return lt.parity_check_matrix(240, 8, 4, rng=29)


def test_minsum_single_recovery(code):
    H = code
    rng = np.random.default_rng(1)
    err_true = rng.random(H.shape[1]) < 0.01
    syn = (H @ err_true) % 2
    dec = lt.MinSumDecoder(H, 0.01, 100)
    guess, success = dec.decode(syn)
    assert success
    assert np.array_equal(guess.astype(bool), err_true)


def test_minsum_batch_ler(code):
    H = code
    rng = np.random.default_rng(2)
    trials = 200
    errs = rng.random((trials, H.shape[1])) < 0.01
    syns = (errs @ H.T) % 2
    dec = lt.MinSumDecoder(H, 0.01, 100)
    guesses, conv = dec.batch_decode(syns)
    exact = (guesses.astype(bool) == errs).all(axis=1)
    assert 1.0 - exact.mean() < 0.02


def test_minsum_normalized_variant(code):
    H = code
    rng = np.random.default_rng(3)
    errs = rng.random((32, H.shape[1])) < 0.02
    syns = (errs @ H.T) % 2
    dec = lt.MinSumDecoder(H, 0.02, 100, alpha=0.8)
    guesses, conv = dec.batch_decode(syns)
    synhat = (guesses.astype(int) @ H.T) % 2
    for b in np.flatnonzero(conv):
        assert np.array_equal(synhat[b], syns[b])


def test_minsum_zero_syndrome(code):
    dec = lt.MinSumDecoder(code, 0.01, 10)
    guess, success = dec.decode(np.zeros(code.shape[0], dtype=np.uint8))
    assert success and not guess.any()


def test_minsum_irregular_graph():
    H = lt.toric_code_x(3)
    rng = np.random.default_rng(4)
    errs = rng.random((16, H.shape[1])) < 0.02
    syns = (errs @ H.T) % 2
    dec = lt.MinSumDecoder(H, 0.02, 50)
    guesses, conv = dec.batch_decode(syns)
    synhat = (guesses.astype(int) @ H.T) % 2
    for b in np.flatnonzero(conv):
        assert np.array_equal(synhat[b], syns[b])


def test_damping_mechanics_and_validation():
    """Message damping: valid range enforced, damping=0 is the plain
    decoder bit for bit, and damped decoding stays syndrome-consistent
    on converged lanes."""
    H = lt.parity_check_matrix(240, 6, 3, rng=5)
    rng = np.random.default_rng(0)
    errs = rng.random((64, 240)) < 0.02
    syn = (errs @ H.T % 2).astype(np.uint8)
    base = lt.MinSumDecoder(H, 0.02, 40)
    damp0 = lt.MinSumDecoder(H, 0.02, 40, damping=0.0)
    e0, c0 = base.batch_decode(syn)
    e1, c1 = damp0.batch_decode(syn)
    np.testing.assert_array_equal(e0, e1)
    d = lt.MinSumDecoder(H, 0.02, 40, damping=0.4)
    ed, cd = d.batch_decode(syn)
    ok = (ed[cd].astype(np.uint8) @ H.T % 2 == syn[cd]).all()
    assert ok and cd.mean() > 0.9
    with pytest.raises(ValueError, match="damping"):
        lt.MinSumDecoder(H, 0.02, 10, damping=1.0)
    # config round-trip + build
    cfg = lt.DecoderConfig(kind="minsum", per=0.02, max_iters=20,
                           damping=0.3)
    assert lt.DecoderConfig.from_json(cfg.to_json()).damping == 0.3
    dec = cfg.build(H)
    assert dec.damping == 0.3


def test_bposd_damped_minsum_inner():
    """damping threads through bposd (fused and compacting) with
    inner='minsum'; sumproduct + damping is rejected."""
    H = lt.toric_code_x(3)
    syn = np.zeros((4, 9), np.uint8)
    syn[1, 2] = 1
    syn[1, 5] = 1
    fused = lt.BeliefPropagationOSDDecoder(H, 0.05, 30, inner="minsum",
                                           damping=0.3, fused=True)
    comp = lt.BeliefPropagationOSDDecoder(H, 0.05, 30, inner="minsum",
                                          damping=0.3)
    ef, cf = fused.batch_decode(syn)
    ec, cc = comp.batch_decode(syn)
    np.testing.assert_array_equal(ef, ec)
    assert (((ef.astype(np.uint8) @ H.T) & 1) == syn).all()
    with pytest.raises(ValueError, match="min-sum knob"):
        lt.BeliefPropagationOSDDecoder(H, 0.05, 30, damping=0.3)


def test_vectorized_check_update_bit_identical():
    """High-degree graphs auto-select the argmin-based check update
    (round 4: circuit-level DEMs reach max_dc ~ 300, where the unrolled
    two-min sweep emits ~600 sequential ops); both formulations must be
    bit-for-bit identical, including first-minimum tie-breaking."""
    from ldpcdecoders_tpu.codes.graph import TannerGraph
    from ldpcdecoders_tpu.models.minsum import make_minsum_decode_fn

    rng = np.random.default_rng(7)
    H = (rng.random((20, 160)) < 0.18).astype(np.uint8)
    H[0] |= 1  # one very heavy check
    H[:, H.sum(axis=0) == 0] = 1
    g = TannerGraph.from_pcm(H)
    assert g.max_dc > 16  # auto-selection would pick the vectorized form
    syn = rng.integers(0, 2, (24, 20)).astype(np.uint8)
    # ties are common with a quantized prior; exercise them deliberately
    for damping in (0.0, 0.4):
        fv = make_minsum_decode_fn(g, 0.03, 25, damping=damping,
                                   vectorized_check=True)
        fs = make_minsum_decode_fn(g, 0.03, 25, damping=damping,
                                   vectorized_check=False)
        ev, cv, iv, lv = fv(syn, None)
        es, cs, is_, ls = fs(syn, None)
        np.testing.assert_array_equal(np.asarray(ev), np.asarray(es))
        np.testing.assert_array_equal(np.asarray(cv), np.asarray(cs))
        np.testing.assert_array_equal(np.asarray(iv), np.asarray(is_))
        np.testing.assert_array_equal(np.asarray(lv), np.asarray(ls))


def test_check_every_semantics():
    """check_every=k: convergence claims unchanged, iters rounded up to
    the check grid, outputs still syndrome-consistent on converged lanes."""
    H = lt.parity_check_matrix(240, 6, 3, rng=5)
    rng = np.random.default_rng(1)
    errs = rng.random((64, 240)) < 0.02
    syn = (errs @ H.T % 2).astype(np.uint8)
    d1 = lt.MinSumDecoder(H, 0.02, 40, damping=0.2)
    d4 = lt.MinSumDecoder(H, 0.02, 40, damping=0.2, check_every=4)
    e1, c1 = d1.batch_decode(syn)
    e4, c4 = d4.batch_decode(syn)
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c4))
    ok = (e4[c4].astype(np.uint8) @ H.T % 2 == syn[c4]).all()
    assert ok
    with pytest.raises(ValueError, match="check_every"):
        lt.MinSumDecoder(H, 0.02, 10, check_every=0)


def test_lane_damping_matches_scalar():
    """lane_damping: a [B] gamma vector decodes each lane exactly as the
    scalar-damped decoder would — the device-ensemble primitive."""
    from ldpcdecoders_tpu.codes.graph import TannerGraph
    from ldpcdecoders_tpu.models.minsum import make_minsum_decode_fn

    H = lt.toric_code_x(3)
    g = TannerGraph.from_pcm(H)
    rng = np.random.default_rng(3)
    errs = rng.random((12, H.shape[1])) < 0.03
    syn = (errs @ H.T % 2).astype(np.uint8)
    gv = np.array([0.0, 0.3, 0.5] * 4, np.float32)
    fl = make_minsum_decode_fn(g, 0.03, 30, lane_damping=True)
    em, cm, im, lm = fl(syn, None, gv)
    for gval in (0.0, 0.3, 0.5):
        fs = make_minsum_decode_fn(g, 0.03, 30, damping=float(gval))
        es, cs, *_ = fs(syn, None)
        sel = gv == gval
        np.testing.assert_array_equal(np.asarray(em)[sel],
                                      np.asarray(es)[sel])
        np.testing.assert_array_equal(np.asarray(cm)[sel],
                                      np.asarray(cs)[sel])
    with pytest.raises(ValueError, match="gamma"):
        fl(syn, None)
    with pytest.raises(ValueError, match="lane_damping"):
        make_minsum_decode_fn(g, 0.03, 10, lane_damping=True,
                              damping=0.3)


def test_check_layout_equivalent():
    """layout='check' (check-resident messages, gather-free check
    update — the round-5 wide-DEM path) is the SAME per-edge arithmetic
    as the var layout, but the two are different XLA programs and f32
    reduction reassociation differs at the ~1e-6 level per iteration
    (measured: the gap grows chaotically on never-converging lanes).
    The honest contract is therefore decode-level equivalence, not
    bitwise identity: same corrections recovered in the convergent
    regime, syndrome-consistent converged lanes always, matching
    convergence behavior under every gamma form."""
    import jax.numpy as jnp

    from ldpcdecoders_tpu.codes.graph import TannerGraph
    from ldpcdecoders_tpu.models.minsum import make_minsum_decode_fn

    H = lt.parity_check_matrix(240, 6, 3, rng=5)
    g = TannerGraph.from_pcm(H)
    rng = np.random.default_rng(3)
    errs = (rng.random((64, 240)) < 0.015).astype(np.uint8)
    syn = (errs @ H.T % 2).astype(np.uint8)
    pr = np.full(240, 0.015)
    L0 = jnp.asarray(np.log((1 - pr) / pr), jnp.float32)

    def run(fn, *args):
        e, c, i, l = fn(*args)
        return (np.asarray(e), np.asarray(c), np.asarray(i),
                np.asarray(l, np.float64))

    for dtype in (jnp.float32, jnp.bfloat16):
        fv = make_minsum_decode_fn(g, 0.015, 40, dtype=dtype,
                                   check_every=4)
        fc = make_minsum_decode_fn(g, 0.015, 40, dtype=dtype,
                                   check_every=4, layout="check")
        ev, cv, iv, lv = run(fv, syn, L0)
        ec, cc, ic, lc = run(fc, syn, L0)
        assert cv.mean() > 0.95 and cc.mean() > 0.95
        # converged lanes are syndrome-consistent in both layouts
        for e, c in ((ev, cv), (ec, cc)):
            assert (((e[c].astype(np.uint8) @ H.T) & 1) == syn[c]).all()
        # in the convergent regime both recover the same corrections
        both = cv & cc
        agree = (ev[both] == ec[both]).all(axis=1).mean()
        assert agree > 0.98, f"converged-lane agreement {agree}"

    # lane_damping gamma forms ([B] and per-variable [B, n]) accepted
    # and behaviorally matched
    fv = make_minsum_decode_fn(g, 0.015, 40, lane_damping=True,
                               check_every=4)
    fc = make_minsum_decode_fn(g, 0.015, 40, lane_damping=True,
                               check_every=4, layout="check")
    gam1 = jnp.asarray(rng.uniform(0.0, 0.5, 64).astype(np.float32))
    gam2 = jnp.asarray(rng.uniform(-0.2, 0.5, (64, 240)).astype(np.float32))
    for gam in (gam1, gam2):
        ev, cv, _, _ = run(fv, syn, L0, gam)
        ec, cc, _, _ = run(fc, syn, L0, gam)
        assert abs(cv.mean() - cc.mean()) < 0.1
        both = cv & cc
        assert (ev[both] == ec[both]).all(axis=1).mean() > 0.95

    with pytest.raises(ValueError, match="layout"):
        make_minsum_decode_fn(g, 0.03, 10, layout="bogus")
    with pytest.raises(ValueError, match="plain decode path"):
        make_minsum_decode_fn(g, 0.03, 10, layout="check",
                              alpha=np.full(10, 0.8))


def test_track_best_returns_least_inconsistent_iterate():
    """track_best=True: converged lanes are bit-identical to the plain
    decode; non-converged lanes report an iterate whose syndrome
    mismatch is <= the plain decode's final state (the BP-OTS
    best-so-far trick, reference bpots_decoder.jl:280-291)."""
    from ldpcdecoders_tpu.codes.graph import TannerGraph
    from ldpcdecoders_tpu.models.minsum import make_minsum_decode_fn

    rng = np.random.default_rng(11)
    # loopy random graph at high noise: plenty of non-converged lanes
    H = (rng.random((30, 120)) < 0.2).astype(np.uint8)
    H[:, H.sum(axis=0) == 0] = 1
    g = TannerGraph.from_pcm(H)
    syn = rng.integers(0, 2, (48, 30)).astype(np.uint8)
    for layout in ("var", "check"):
        f0 = make_minsum_decode_fn(g, 0.05, 24, check_every=4,
                                   layout=layout)
        f1 = make_minsum_decode_fn(g, 0.05, 24, check_every=4,
                                   layout=layout, track_best=True)
        e0, c0, i0, l0 = (np.asarray(x) for x in f0(syn, None))
        e1, c1, i1, l1 = (np.asarray(x) for x in f1(syn, None))
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_array_equal(i0, i1)
        conv = c0
        np.testing.assert_array_equal(e0[conv], e1[conv])
        np.testing.assert_array_equal(l0[conv], l1[conv])
        assert (~conv).any(), "test needs non-converged lanes"
        mis0 = ((e0.astype(np.uint8) @ H.T % 2) != syn).sum(axis=1)
        mis1 = ((e1.astype(np.uint8) @ H.T % 2) != syn).sum(axis=1)
        assert (mis1[~conv] <= mis0[~conv]).all()
        assert mis1[~conv].sum() < mis0[~conv].sum()  # strictly better somewhere
