"""BP+OSD tests (reference oracle: test_bposd_decoder.jl) + exact parity of
the packed GF(2) elimination against the NumPy golden OSD."""

import numpy as np
import pytest

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.golden import osd_postprocess as golden_osd


@pytest.fixture(scope="module")
def code():
    return lt.parity_check_matrix(240, 8, 4, rng=17)


def test_bposd_single_recovery(code):
    H = code
    rng = np.random.default_rng(1)
    err_true = rng.random(H.shape[1]) < 0.01
    syn = (H @ err_true) % 2
    dec = lt.BeliefPropagationOSDDecoder(H, 0.01, 100)
    guess, success = dec.decode(syn)
    assert success
    assert np.array_equal(guess.astype(bool), err_true)


@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_bposd_high_order_recovery(code, order):
    # reference: orders 2:5 all recover (test_bposd_decoder.jl:19-34)
    H = code
    rng = np.random.default_rng(2)
    err_true = rng.random(H.shape[1]) < 0.01
    syn = (H @ err_true) % 2
    dec = lt.BeliefPropagationOSDDecoder(H, 0.01, 100, osd_order=order)
    guess, _ = dec.decode(syn)
    assert np.array_equal(guess.astype(bool), err_true), f"order={order}"


def test_bposd_large_error_rate_syndrome_consistency(code):
    """Reference oracle: at per=0.2, even when decoding is wrong, the output
    must be syndrome-consistent (test_bposd_decoder.jl:37-47)."""
    H = code
    rng = np.random.default_rng(3)
    B = 16
    errs = rng.random((B, H.shape[1])) < 0.2
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationOSDDecoder(H, 0.2, 100)
    guesses, conv = dec.batch_decode(syns)
    synhat = (guesses.astype(int) @ H.T) % 2
    assert (synhat == syns).all(), "OSD-0 must guarantee syndrome consistency"
    # BP itself should NOT have converged everywhere at per=0.2 — otherwise
    # this test exercises nothing
    assert not conv.all()


def test_bposd_batch_consistency(code):
    H = code
    rng = np.random.default_rng(4)
    B = 10
    errs = rng.random((B, H.shape[1])) < 0.01
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationOSDDecoder(H, 0.01, 100)
    guesses, conv = dec.batch_decode(syns)
    synhat = (guesses.astype(int) @ H.T) % 2
    assert (synhat == syns).all()


def test_osd0_matches_golden_exactly(code):
    """Feed identical BP soft outputs to the packed-JAX OSD-0 and the NumPy
    golden; outputs must agree bit-for-bit."""
    H = code
    rng = np.random.default_rng(5)
    B = 8
    errs = rng.random((B, H.shape[1])) < 0.15
    syns = (errs @ H.T) % 2
    # few-iteration BP so it does NOT converge -> OSD actually runs
    bp = lt.BeliefPropagationDecoder(H, 0.15, 4)
    bp_err, conv, iters, aux, _ = bp.batch_decode_detailed(syns)
    logp = np.asarray(aux["log_probabs"])
    dec = lt.BeliefPropagationOSDDecoder(H, 0.15, 4)
    guesses, _ = dec.batch_decode(syns)
    for b in range(B):
        g = golden_osd(H, syns[b], bp_err[b], logp[b], osd_order=0)
        assert np.array_equal(guesses[b].astype(bool), g), f"lane {b}"


@pytest.mark.parametrize("order", [1, 2, 3, 7, 10])
def test_osdw_matches_golden_exactly(order):
    H = lt.parity_check_matrix(60, 6, 3, rng=19)
    rng = np.random.default_rng(6)
    B = 6
    errs = rng.random((B, H.shape[1])) < 0.15
    syns = (errs @ H.T) % 2
    bp = lt.BeliefPropagationDecoder(H, 0.15, 3)
    bp_err, conv, iters, aux, _ = bp.batch_decode_detailed(syns)
    logp = np.asarray(aux["log_probabs"])
    dec = lt.BeliefPropagationOSDDecoder(H, 0.15, 3, osd_order=order)
    guesses, _ = dec.batch_decode(syns)
    for b in range(B):
        g = golden_osd(H, syns[b], bp_err[b], logp[b], osd_order=order)
        assert np.array_equal(guesses[b].astype(bool), g), f"lane {b} order {order}"


def test_osd_order_clamp_warning():
    H = lt.hamming_code(3)  # rank 3, n=7 -> max order 4
    with pytest.warns(UserWarning):
        dec = lt.BeliefPropagationOSDDecoder(H, 0.05, 10, osd_order=6)
    assert dec.osd_order == 4


def test_bposd_converged_flag_reflects_bp(code):
    """The converged flag reports BP convergence, not OSD success
    (belief_propagation_osd.jl:60)."""
    H = code
    rng = np.random.default_rng(7)
    errs = rng.random((4, H.shape[1])) < 0.2
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationOSDDecoder(H, 0.2, 2)
    guesses, conv = dec.batch_decode(syns)
    bp = lt.BeliefPropagationDecoder(H, 0.2, 2)
    _, bp_conv = bp.batch_decode(syns)
    assert np.array_equal(conv, bp_conv)


@pytest.mark.parametrize("per,order", [(0.01, 0), (0.2, 0), (0.2, 2)])
def test_fused_matches_compacting_path(code, per, order):
    """The single-program fused decoder (lax.cond-gated OSD, no host sync)
    must reproduce the default compacting path bit-for-bit — including at
    high noise where the OSD branch actually executes."""
    H = code
    rng = np.random.default_rng(11)
    B = 12
    errs = rng.random((B, H.shape[1])) < per
    syns = (errs @ H.T) % 2
    kw = dict(osd_order=order)
    ref = lt.BeliefPropagationOSDDecoder(H, per, 30, **kw)
    fus = lt.BeliefPropagationOSDDecoder(H, per, 30, fused=True, **kw)
    g1, c1 = ref.batch_decode(syns)
    g2, c2 = fus.batch_decode(syns)
    assert np.array_equal(c1, c2)
    assert np.array_equal(g1, g2)
    if per > 0.1 and order == 0:
        assert not c1.all()  # ensure the cond branch ran


@pytest.mark.parametrize("fused", [False, True])
def test_osd_scope_failed(code, fused):
    """osd_scope='failed' keeps BP output on converged lanes and applies
    the OSD-w correction only to failing lanes (documented deviation
    from the reference's every-lane sweep)."""
    H = code
    rng = np.random.default_rng(21)
    B = 12
    errs = rng.random((B, H.shape[1])) < 0.2
    syns = (errs @ H.T) % 2
    scoped = lt.BeliefPropagationOSDDecoder(
        H, 0.2, 20, osd_order=2, osd_scope="failed", fused=fused
    )
    g, conv = scoped.batch_decode(syns)
    assert not conv.all()  # the scoped branch must actually run
    # output is syndrome-consistent everywhere
    assert (((g.astype(int) @ H.T) % 2) == syns).all()
    # converged lanes carry BP's own output
    bp = lt.BeliefPropagationDecoder(H, 0.2, 20)
    bp_g, bp_conv = bp.batch_decode(syns)
    assert np.array_equal(conv, bp_conv)
    assert np.array_equal(g[conv], bp_g[conv])
    # failing lanes match the all-scope decoder on those same lanes
    full = lt.BeliefPropagationOSDDecoder(H, 0.2, 20, osd_order=2)
    f_g, _ = full.batch_decode(syns)
    assert np.array_equal(g[~conv], f_g[~conv])


def test_osd_scope_validation(code):
    with pytest.raises(ValueError, match="osd_scope"):
        lt.BeliefPropagationOSDDecoder(code, 0.1, 10, osd_scope="bogus")


@pytest.mark.parametrize("fused", [False, True])
def test_inner_minsum_syndrome_consistent(code, fused):
    """OSD over a min-sum inner decoder: output stays syndrome-consistent
    and the per-override path converts to the LLR prior domain."""
    H = code
    rng = np.random.default_rng(31)
    B = 16
    errs = rng.random((B, H.shape[1])) < 0.06
    syns = (errs @ H.T) % 2
    dec = lt.BeliefPropagationOSDDecoder(H, 0.06, 15, inner="minsum", fused=fused)
    g, conv = dec.batch_decode(syns)
    assert (((g.astype(int) @ H.T) % 2) == syns).all()
    g2, _ = dec.batch_decode(syns, per=0.1)
    assert (((g2.astype(int) @ H.T) % 2) == syns).all()


def test_inner_decoder_instance_and_validation(code):
    """A constructed min-sum-family decoder (the neural-BP+OSD path)
    plugs in as the OSD inner; graph mismatch and junk are rejected."""
    from ldpcdecoders_tpu.models.neural import NeuralMinSumDecoder

    H = code
    nd = NeuralMinSumDecoder(H, 0.06, 10)
    dec = lt.BeliefPropagationOSDDecoder(H, 0.06, 10, osd_order=1, inner=nd)
    rng = np.random.default_rng(32)
    errs = rng.random((8, H.shape[1])) < 0.06
    syns = (errs @ H.T) % 2
    g, _ = dec.batch_decode(syns)
    assert (((g.astype(int) @ H.T) % 2) == syns).all()
    other = lt.parity_check_matrix(60, 6, 3, rng=0)
    with pytest.raises(ValueError, match="inner decoder"):
        lt.BeliefPropagationOSDDecoder(other, 0.06, 10, inner=nd)
    with pytest.raises(TypeError, match="inner must be"):
        lt.BeliefPropagationOSDDecoder(H, 0.06, 10, inner="bogus")


def _brute_cs(H, syn, bp_err, lam):
    """NumPy oracle for the OSD-CS candidate set and tie order."""
    m, n = H.shape
    A = H.copy().astype(np.uint8)
    s = syn.copy().astype(np.uint8)
    pivcol = []
    used = np.zeros(m, bool)
    for j in range(n):
        cand = np.flatnonzero((A[:, j] == 1) & ~used)
        if cand.size == 0:
            continue
        k = cand[0]
        used[k] = True
        pivcol.append((k, j))
        elim = np.flatnonzero(A[:, j] == 1)
        elim = elim[elim != k]
        A[elim] ^= A[k]
        s[elim] ^= s[k]
        if used.all():
            break
    piv_rows = np.array([k for k, _ in pivcol], int)
    piv_cols = np.array([j for _, j in pivcol], int)
    nonpiv = np.array([j for j in range(n) if j not in set(piv_cols)], int)

    def complete(freebits):
        e = np.zeros(n, np.uint8)
        e[nonpiv] = freebits
        rhs = (s[piv_rows] + A[piv_rows][:, nonpiv] @ freebits) % 2
        e[piv_cols] = rhs
        return e

    base = bp_err[nonpiv].copy()
    cands = [base]
    for j in range(len(nonpiv)):
        f = base.copy()
        f[j] ^= 1
        cands.append(f)
    L = min(lam, len(nonpiv))
    for i in range(L):
        for j in range(i + 1, L):
            f = base.copy()
            f[i] ^= 1
            f[j] ^= 1
            cands.append(f)
    best = None
    for f in cands:
        e = complete(f.astype(np.uint8))
        w = int(e.sum())
        if best is None or w < best[0]:
            best = (w, e)
    return best[1]


def test_osd_cs_matches_bruteforce_candidate_search():
    """gf2_osd_cs returns the exact minimum-weight candidate (bit-for-bit
    including tie order) of the documented single+pair flip set."""
    import jax.numpy as jnp

    from ldpcdecoders_tpu.ops.gf2 import gf2_osd_cs, pack_bits

    rng = np.random.default_rng(7)
    m, n = 8, 14  # one shape -> one jit compile
    for trial in range(25):
        H = (rng.random((m, n)) < 0.4).astype(np.uint8)
        e_true = (rng.random(n) < 0.2).astype(np.uint8)
        syn = (H @ e_true) % 2
        bp_err = (rng.random(n) < 0.3).astype(np.uint8)
        lam = int(rng.integers(0, 7))
        Hp = np.asarray(pack_bits(jnp.asarray(H)))
        got = np.asarray(
            gf2_osd_cs(
                jnp.asarray(Hp),
                jnp.asarray(bp_err, jnp.uint32),
                jnp.asarray(syn, jnp.uint32),
                lam,
                n,
            )
        ).astype(np.uint8)
        want = _brute_cs(H, syn, bp_err, lam)
        assert np.array_equal(got, want), (trial, lam)


@pytest.mark.parametrize("fused", [False, True])
def test_osd_cs_decoder_consistent_and_no_worse(code, fused):
    """combination_sweep output is syndrome-consistent and never heavier
    than OSD-0 on the same lanes (the base completion is a candidate)."""
    H = code
    rng = np.random.default_rng(41)
    B = 12
    errs = rng.random((B, H.shape[1])) < 0.2
    syns = (errs @ H.T) % 2
    cs = lt.BeliefPropagationOSDDecoder(
        H, 0.2, 20, osd_order=12, osd_method="combination_sweep", fused=fused
    )
    g, conv = cs.batch_decode(syns)
    assert (((g.astype(int) @ H.T) % 2) == syns).all()
    osd0 = lt.BeliefPropagationOSDDecoder(H, 0.2, 20, osd_order=0, fused=fused)
    g0, _ = osd0.batch_decode(syns)
    assert (g.astype(int).sum(axis=1) <= g0.astype(int).sum(axis=1)).all()


def test_osd_method_validation(code):
    with pytest.raises(ValueError, match="osd_method"):
        lt.BeliefPropagationOSDDecoder(code, 0.1, 10, osd_method="bogus")


@pytest.mark.gpu
def test_osd_sweep_matches_cpu_on_gpu(gpu):
    """The OSD-w candidate sweep on the card equals the CPU's on the same
    eliminated systems (its 0/1 matmuls must be exact there too)."""
    import jax
    import jax.numpy as jnp

    from ldpcdecoders_tpu.ops.gf2 import gf2_eliminate, osdw_sweep, pack_bits

    H = lt.parity_check_matrix(1000, 10, 9, rng=42)
    m, n = H.shape
    rng = np.random.default_rng(3)
    B = 64
    perms = np.stack([rng.permutation(n) for _ in range(B)])
    Hb = H[:, perms].transpose(1, 0, 2).astype(np.uint32)
    x = (rng.random((B, n)) < 0.2).astype(np.uint32)
    syn = jnp.asarray((np.einsum("bmn,bn->bm", Hb, x) % 2).astype(np.uint32))
    Ht = jnp.transpose(jax.vmap(pack_bits)(jnp.asarray(Hb)), (0, 2, 1))
    elim = jax.jit(jax.vmap(lambda h, v: gf2_eliminate(h, v, n)))(Ht, syn)
    bp = jnp.asarray((rng.random((B, n)) < 0.2).astype(np.uint32))
    sweep = jax.jit(jax.vmap(lambda h, v, p, r, b: osdw_sweep(h, v, p, r, b, 4, n)))
    args = (*elim, bp)
    cpu = jax.devices("cpu")[0]
    on_gpu = np.asarray(sweep(*args))
    on_cpu = np.asarray(sweep(*(jax.device_put(a, cpu) for a in args)))
    assert np.array_equal(on_gpu, on_cpu)
